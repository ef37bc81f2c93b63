"""Tokenizer and host sampler.

The port's copy of the JAX package's tokenizer: SentencePiece-style BPE
encode (optional BOS, dummy-prefix space, UTF-8 codepoint split with byte
fallback at +3, then greedy highest-score pair merging), piece decoding,
and the host ``Sampler`` in its counter mode, which replays the device
sampler's stream from fetched logits. Host-side Python and numpy only.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np

from distributed_llama_tpu_torch import prng
from distributed_llama_tpu_torch.formats.tokenizer_file import TokenizerData, read_tokenizer_file

_RAW_BYTE_RE = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")


class Tokenizer:
    """Byte-level SentencePiece/BPE tokenizer over a `.t` vocabulary."""

    def __init__(self, data: TokenizerData):
        self.vocab: list[bytes] = data.vocab
        self.scores: list[float] = data.scores
        self.bos_id = data.bos_id
        self.eos_id = data.eos_id
        # first-wins (lowest id) for duplicate pieces
        self._index: dict[bytes, int] = {}
        for i, tok in enumerate(self.vocab):
            self._index.setdefault(tok, i)

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


class NonFiniteLogits(ValueError):
    """The host sampler refuses NaN/Inf logits instead of laundering them
    into a plausible in-vocab token."""


@dataclasses.dataclass
class Sampler:
    """Greedy / temperature / top-k / top-p sampling on host logits with
    the counter PRNG: each coin is keyed on ``(seed, pos)`` and the pick
    runs the device sampler's f32 arithmetic (``models.sampling``), so it
    replays a device-sampled stream token for token from fetched logits.
    ``pos`` is the absolute position of the consumed token."""

    vocab_size: int
    temperature: float = 0.8
    topp: float = 0.9
    seed: int = 0
    topk: int = 0

    def __post_init__(self):
        self.set_seed(self.seed)

    def set_seed(self, seed: int) -> None:
        self.seed = seed
        self._seed32 = prng.fold_seed(seed)

    def sample(self, logits: np.ndarray, pos: int) -> int:
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)[: self.vocab_size]
        if not np.isfinite(logits).all():
            raise NonFiniteLogits(
                f"host sampler got non-finite logits ({int((~np.isfinite(logits)).sum())} "
                f"of {logits.size} entries)"
            )
        if self.temperature == 0.0:
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
            cdf = np.cumsum(probs, dtype=np.float32)
            r = coin * cdf[-1]
            return min(int(np.sum(cdf <= r)), n - 1)
        order = np.argsort(-scaled, kind="stable")
        vals = probs[order]
        cum = np.cumsum(vals, dtype=np.float32)
        n_nuc = int(np.sum(cum - vals < np.float32(self.topp))) if topp_act else n
        n_k = self.topk if topk_act else n
        n_keep = max(1, min(n_nuc, n_k, n))
        r = coin * cum[n_keep - 1]
        idx = min(int(np.sum(cum[:n_keep] <= r)), n_keep - 1)
        return int(order[idx])
