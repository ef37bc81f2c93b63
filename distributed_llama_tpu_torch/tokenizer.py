"""Tokenizer, host sampler, chat templates and the streaming stop detector.

The port's copy of the JAX package's tokenizer: SentencePiece-style BPE
encode (optional BOS, dummy-prefix space, UTF-8 codepoint split with byte
fallback at +3, then greedy highest-score pair merging), piece decoding,
the host ``Sampler`` in its counter mode, which replays the device
sampler's stream from fetched logits, the chat-template renderers and the
``EosDetector`` the API server streams through. ``Tokenizer.encode`` runs
the split and merge in the port's C++ host library (:mod:`native`);
``Tokenizer.encode_plain`` is the same algorithm in Python, its plain
version. The rest is host-side Python and numpy.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Sequence

import numpy as np

from distributed_llama_tpu_torch import native, prng, telemetry
from distributed_llama_tpu_torch.formats.tokenizer_file import TokenizerData, read_tokenizer_file

_RAW_BYTE_RE = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")


class Tokenizer:
    """Byte-level SentencePiece/BPE tokenizer over a `.t` vocabulary."""

    def __init__(self, data: TokenizerData):
        self.vocab: list[bytes] = data.vocab
        self.scores: list[float] = data.scores
        self.bos_id = data.bos_id
        self.eos_id = data.eos_id
        self.chat_eos_id = data.chat_eos_id
        self.chat_template = data.chat_template
        self.chat_stop = data.chat_stop
        # first-wins (lowest id) for duplicate pieces
        self._index: dict[bytes, int] = {}
        for i, tok in enumerate(self.vocab):
            self._index.setdefault(tok, i)
        # the native handle, made at the first encode (which builds the
        # host library if needed and raises if it cannot)
        self._native: native.NativeBpe | None = None

    @classmethod
    def from_file(cls, path: str, model_vocab_size: int | None = None) -> "Tokenizer":
        data = read_tokenizer_file(path)
        if model_vocab_size is not None and data.vocab_size != model_vocab_size:
            raise ValueError(
                f"tokenizer vocab size {data.vocab_size} != model vocab size {model_vocab_size}"
            )
        return cls(data)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str | bytes, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        """Token ids of ``text``: the split and merge in the host library."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if self._native is None:
            self._native = native.NativeBpe(self.vocab, self.scores)
        tokens = [self.bos_id] if add_bos else []
        # the dummy-prefix space token, which takes part in the merges
        space_id = self._index.get(b" ", -1) if text else -1
        tokens.extend(self._native.encode(text, first=space_id))
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def encode_plain(self, text: str | bytes, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        """:meth:`encode` in Python: its plain version (O(n^2) merges)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if add_bos:
            tokens.append(self.bos_id)
        if text:
            space_id = self._index.get(b" ")
            if space_id is not None:
                tokens.append(space_id)  # the dummy-prefix space

        i, n = 0, len(text)
        while i < n:
            j = i + 1
            # extend while continuation bytes, capped at 4 bytes total
            while j < n and (text[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            piece = text[i:j]
            tid = self._index.get(piece)
            if tid is not None:
                tokens.append(tid)
            else:
                # byte fallback: the first 3 vocab entries are <unk>, <s>, </s>
                tokens.extend(b + 3 for b in piece)
            i = j

        # greedy merge of the adjacent pair whose concatenation scores best
        while True:
            best_score, best_id, best_idx = -1e10, -1, -1
            for k in range(len(tokens) - 1):
                mid = self._index.get(self.vocab[tokens[k]] + self.vocab[tokens[k + 1]])
                if mid is not None and self.scores[mid] > best_score:
                    best_score, best_id, best_idx = self.scores[mid], mid, k
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [best_id]

        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        """Raw bytes of ``token`` after ``prev_token``: one leading space is
        stripped after BOS, and `<0xNN>` pieces become their byte."""
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            piece = piece[1:]
        m = _RAW_BYTE_RE.match(piece)
        if m:
            return bytes([int(m.group(1), 16)])
        return piece

    def decode(self, tokens: Sequence[int]) -> str:
        out = bytearray()
        prev = self.bos_id
        for t in tokens:
            if t == self.bos_id:
                prev = t
                continue
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")


def is_safe_piece(piece: bytes) -> bool:
    """False for empty pieces and lone ASCII control bytes (whitespace
    excepted) and DEL; lone bytes >= 0x80 are kept (UTF-8 fragments)."""
    if not piece:
        return False
    if len(piece) == 1:
        b = piece[0]
        if b < 0x20:
            return b in (0x09, 0x0A, 0x0B, 0x0C, 0x0D)
        return b != 0x7F
    return True


@dataclasses.dataclass
class Sampler:
    """Greedy / temperature / top-k / top-p sampling on host logits with
    the counter PRNG: each coin is keyed on ``(seed, pos)`` and the pick
    runs the device sampler's f32 arithmetic (``models.sampling``), so it
    replays a device-sampled stream token for token from fetched logits.
    ``pos`` is the absolute position of the consumed token. Every call
    counts toward ``dllama_host_sampler_fallback_total``: with the device
    sampler in place, host sampling IS the fallback path."""

    vocab_size: int
    temperature: float = 0.8
    topp: float = 0.9
    seed: int = 0
    topk: int = 0

    def __post_init__(self):
        self.set_seed(self.seed)
        # bound once per sampler: shared no-op singletons unless telemetry
        # was enabled first, so the per-token host path never touches the
        # registry
        self._tel = telemetry.SamplerInstruments()

    def set_seed(self, seed: int) -> None:
        self.seed = seed
        self._seed32 = prng.fold_seed(seed)

    def sample(self, logits: np.ndarray, pos: int) -> int:
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)[: self.vocab_size]
        if not np.isfinite(logits).all():
            # the one class the batch scheduler raises for a device-side
            # non-finite flag: the serving layer retires the request alike
            from distributed_llama_tpu_torch.engine import faults

            raise faults.NonFiniteLogits(
                f"host sampler got non-finite logits ({int((~np.isfinite(logits)).sum())} "
                f"of {logits.size} entries)"
            )
        self._tel.fallback.inc()
        if self.temperature == 0.0:
            self._tel.sampled.labels(method="greedy").inc()
            return int(np.argmax(logits))
        return self._sample_counter(logits, prng.coin_f32(self._seed32, pos, prng.DRAW_SAMPLE))

    def _sample_counter(self, logits: np.ndarray, coin: float) -> int:
        """The device sampler's arithmetic in f32: candidates by descending
        scaled logit (ties by lower id), kept prefix min(top-k, nucleus),
        inverse-CDF draw over the kept prefix."""
        n = logits.size
        scaled = (logits / np.float32(self.temperature)).astype(np.float32)
        e = np.exp(scaled - scaled.max(), dtype=np.float32)
        probs = (e / e.sum(dtype=np.float32)).astype(np.float32)
        coin = np.float32(coin)
        topp_act = 0.0 < self.topp < 1.0
        topk_act = 0 < self.topk < n
        if not (topp_act or topk_act):
            self._tel.sampled.labels(method="multinomial").inc()
            cdf = np.cumsum(probs, dtype=np.float32)
            r = coin * cdf[-1]
            return min(int(np.sum(cdf <= r)), n - 1)
        self._tel.sampled.labels(method="topp" if topp_act else "topk").inc()
        order = np.argsort(-scaled, kind="stable")
        vals = probs[order]
        cum = np.cumsum(vals, dtype=np.float32)
        n_nuc = int(np.sum(cum - vals < np.float32(self.topp))) if topp_act else n
        n_k = self.topk if topk_act else n
        n_keep = max(1, min(n_nuc, n_k, n))
        r = coin * cum[n_keep - 1]
        idx = min(int(np.sum(cum[:n_keep] <= r)), n_keep - 1)
        return int(order[idx])


# ---------------------------------------------------------------------------
# Chat templates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChatItem:
    role: str
    message: str


class ChatTemplateType:
    UNKNOWN = "unknown"
    LLAMA2 = "llama2"
    LLAMA3 = "llama3"
    ZEPHYR = "zephyr"
    CHATML = "chatml"


def detect_chat_template(template: str | None) -> str:
    """Substring-sniff the tokenizer's embedded jinja template."""
    if template is None:
        raise ValueError("the tokenizer does not include a chat template")
    if "[INST]" in template:
        return ChatTemplateType.LLAMA2
    if "<|start_header_id|>" in template:
        return ChatTemplateType.LLAMA3
    if "<|user|>" in template:
        return ChatTemplateType.ZEPHYR
    if "<|im_start|>" in template:
        return ChatTemplateType.CHATML
    raise ValueError("unsupported chat template")


class ChatTemplate:
    """Hardcoded renderers per detected template family."""

    def __init__(self, template_type: str, chat_template: str | None, eos: str):
        if template_type == ChatTemplateType.UNKNOWN:
            template_type = detect_chat_template(chat_template)
        self.type = template_type
        self.eos = eos

    def generate(self, items: Sequence[ChatItem], append_generation_prompt: bool = True) -> str:
        out: list[str] = []
        if self.type == ChatTemplateType.LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                out.append(f"[INST] <<SYS>>\n{items[0].message}\n<</SYS>>\n\n{items[1].message} [/INST]{self.eos}")
                i = 2
            for item in items[i:]:
                if item.role == "assistant":
                    out.append(f"{item.message}{self.eos}")
                elif item.role == "user":
                    out.append(f"[INST] {item.message} [/INST]{self.eos}")
        elif self.type == ChatTemplateType.LLAMA3:
            for item in items:
                out.append(f"<|start_header_id|>{item.role}<|end_header_id|>\n\n{item.message}{self.eos}")
            if append_generation_prompt:
                out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == ChatTemplateType.CHATML:
            for item in items:
                out.append(f"<|im_start|>{item.role}\n{item.message}<|im_end|>\n")
            if append_generation_prompt:
                out.append("<|im_start|>assistant\n")
        elif self.type == ChatTemplateType.ZEPHYR:
            for item in items:
                out.append(f"<|{item.role}|>\n{item.message}{self.eos}\n")
            if append_generation_prompt:
                out.append("<|assistant|>\n")
        else:
            raise ValueError(f"unsupported chat template type: {self.type}")
        return "".join(out)


def chat_stops(tokenizer: Tokenizer) -> list[str]:
    """Stop strings for chat mode: the chat EOS token's text plus the
    tokenizer's optional extra stop string."""
    stops = [tokenizer.vocab[tokenizer.chat_eos_id].decode("utf-8", errors="replace")]
    if tokenizer.chat_stop:
        stops.append(tokenizer.chat_stop)
    return stops


# ---------------------------------------------------------------------------
# Streaming EOS / stop-sequence detection
# ---------------------------------------------------------------------------


class EosDetectorResult:
    NOT_EOS = 0
    EOS = 1
    MAYBE_EOS = 2


class EosDetector:
    """Streaming multi-token stop-string matcher: when a prefix of a stop
    string is seen at the tail the result is MAYBE_EOS (hold the output), a
    full match is EOS, otherwise NOT_EOS and the buffered delta is safe to
    emit. ``padding_left`` lets a stop string begin up to N characters into
    the buffer, ``padding_right`` allows trailing characters after it."""

    def __init__(self, eos_ids: int | Iterable[int], stops: Sequence[str], padding_left: int = 0,
                 padding_right: int = 0):
        self.eos_ids = {eos_ids} if isinstance(eos_ids, int) else set(eos_ids)
        self.stops = [s.encode("utf-8") if isinstance(s, str) else s for s in stops]
        self.padding_left = padding_left
        self.padding_right = padding_right
        self.buffer = bytearray()
        self.eos_pos = -1

    def append(self, token_id: int, piece: bytes | str) -> int:
        if isinstance(piece, str):
            piece = piece.encode("utf-8")
        self.buffer += piece
        if token_id in self.eos_ids:
            self.eos_pos = len(self.buffer) - len(piece)
            return EosDetectorResult.EOS
        self.eos_pos = -1
        for stop in self.stops:
            stop_size = len(stop)
            if len(self.buffer) > stop_size + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = len(self.buffer) - lo
                if n == 0 or n > stop_size + self.padding_right:
                    continue
                n = min(n, stop_size)
                if self.buffer[lo : lo + n] == stop[:n]:
                    if n == stop_size:
                        self.eos_pos = lo
                        return EosDetectorResult.EOS
                    return EosDetectorResult.MAYBE_EOS
        return EosDetectorResult.NOT_EOS

    def get_delta(self) -> bytes | None:
        """Text safe to emit after the last :meth:`append`."""
        if self.eos_pos == -1:
            return bytes(self.buffer) if self.buffer else b""
        if self.eos_pos == 0:
            return None
        return bytes(self.buffer[: self.eos_pos])

    def flush_delta(self) -> bytes:
        """Drain buffered text on a non-EOS exit (a length limit): text held
        back as a possible stop-string prefix would otherwise be lost."""
        delta = self.get_delta() or b""
        self.clear()
        return delta

    def clear(self) -> None:
        self.buffer = bytearray()
