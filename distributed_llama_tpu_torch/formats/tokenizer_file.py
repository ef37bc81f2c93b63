"""`.t` tokenizer file format.

Layout:

  int32 magic = 0x567124
  int32 header_size                       # 8 + kv bytes
  (int32 key, int32 value) *              # TokHeaderKey pairs
  chat_template bytes (if announced)      # utf-8 jinja template
  chat_stop bytes (if announced)          # extra stop string
  per token: float32 score, uint32 len, len bytes

The legacy fixed header (magic 0x567123) is readable too.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import BinaryIO

MAGIC_KV = 0x567124
MAGIC_OLD = 0x567123


class TokHeaderKey(enum.IntEnum):
    VERSION = 0
    VOCAB_SIZE = 1
    MAX_TOKEN_LENGTH = 2
    BOS_ID = 3
    EOS_ID = 4
    PAD_ID = 5
    CHAT_EOS_ID = 6
    CHAT_TEMPLATE = 7
    CHAT_STOP = 8


@dataclasses.dataclass
class TokenizerData:
    vocab: list[bytes]
    scores: list[float]
    bos_id: int = -1
    eos_id: int = -1
    chat_eos_id: int = -1
    pad_id: int = -1
    chat_template: str | None = None
    chat_stop: str | None = None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def max_token_length(self) -> int:
        return max((len(t) for t in self.vocab), default=0)


def read_tokenizer_file(path: str) -> TokenizerData:
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
        chat_template_len = -1
        chat_stop_len = -1
        bos_id = eos_id = chat_eos_id = pad_id = -1
        if magic == MAGIC_OLD:
            vocab_size, _max_len, bos_id, eos_id, pad_id = struct.unpack("<IIiii", f.read(20))
        elif magic == MAGIC_KV:
            (header_size,) = struct.unpack("<i", f.read(4))
            n_ints = (header_size - 8) // 4
            raw = struct.unpack(f"<{n_ints}i", f.read(n_ints * 4))
            version = -1
            vocab_size = 0
            for i in range(0, n_ints, 2):
                key, value = raw[i], raw[i + 1]
                if key == TokHeaderKey.VERSION:
                    version = value
                elif key == TokHeaderKey.VOCAB_SIZE:
                    vocab_size = value
                elif key == TokHeaderKey.MAX_TOKEN_LENGTH:
                    pass  # recomputed from the vocab
                elif key == TokHeaderKey.BOS_ID:
                    bos_id = value
                elif key == TokHeaderKey.EOS_ID:
                    eos_id = value
                elif key == TokHeaderKey.CHAT_EOS_ID:
                    chat_eos_id = value
                elif key == TokHeaderKey.CHAT_TEMPLATE:
                    chat_template_len = value
                elif key == TokHeaderKey.CHAT_STOP:
                    chat_stop_len = value
                elif key == TokHeaderKey.PAD_ID:
                    pad_id = value
                else:
                    raise ValueError(f"invalid tokenizer header key: {key}")
            if version != 1:
                raise ValueError("old tokenizer version, please regenerate the tokenizer")
        else:
            raise ValueError(f"invalid tokenizer file magic: {magic & 0xFFFFFFFF:#x}")

        chat_template = None
        chat_stop = None
        if chat_template_len > 0:
            chat_template = f.read(chat_template_len).decode("utf-8")
        if chat_stop_len > 0:
            chat_stop = f.read(chat_stop_len).decode("utf-8")

        vocab: list[bytes] = []
        scores: list[float] = []
        for _ in range(vocab_size):
            score, length = struct.unpack("<fI", f.read(8))
            vocab.append(f.read(length))
            scores.append(score)

    return TokenizerData(
        vocab=vocab, scores=scores, bos_id=bos_id, eos_id=eos_id,
        chat_eos_id=chat_eos_id, pad_id=pad_id,
        chat_template=chat_template, chat_stop=chat_stop,
    )


def write_tokenizer_file(f: BinaryIO, data: TokenizerData) -> None:
    if data.bos_id < 0 or data.eos_id < 0:
        raise ValueError("tokenizer requires bos_id and eos_id")
    template_bytes = data.chat_template.encode("utf-8") if data.chat_template else None
    stop_bytes = data.chat_stop.encode("utf-8") if data.chat_stop else None

    pairs: list[tuple[int, int]] = [
        (TokHeaderKey.VERSION, 1),
        (TokHeaderKey.VOCAB_SIZE, data.vocab_size),
        (TokHeaderKey.MAX_TOKEN_LENGTH, data.max_token_length),
        (TokHeaderKey.BOS_ID, data.bos_id),
        (TokHeaderKey.EOS_ID, data.eos_id),
    ]
    if data.pad_id >= 0:
        pairs.append((TokHeaderKey.PAD_ID, data.pad_id))
    if data.chat_eos_id >= 0:
        pairs.append((TokHeaderKey.CHAT_EOS_ID, data.chat_eos_id))
    if template_bytes:
        pairs.append((TokHeaderKey.CHAT_TEMPLATE, len(template_bytes)))
    if stop_bytes:
        pairs.append((TokHeaderKey.CHAT_STOP, len(stop_bytes)))

    kv = b"".join(struct.pack("<ii", int(k), int(v)) for k, v in pairs)
    f.write(struct.pack("<i", MAGIC_KV))
    f.write(struct.pack("<i", 8 + len(kv)))
    f.write(kv)
    if template_bytes:
        f.write(template_bytes)
    if stop_bytes:
        f.write(stop_bytes)
    for token, score in zip(data.vocab, data.scores):
        if len(token) == 0:
            raise ValueError("empty token in vocab")
        f.write(struct.pack("<fI", score, len(token)))
        f.write(token)
