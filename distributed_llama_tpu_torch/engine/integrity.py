"""Per-row logit fingerprints and finiteness flags of a batched decode chunk.

The port's copy of the device half of the JAX package's
``engine/integrity.py``: each step folds the row's logit argmax and sampled
token into an FNV-1a hash, and ANDs in whether the row's logits were all
finite (NaN logits pushed through a softmax can yield a perfectly in-vocab
token, so the scheduler checks the flag, not the token). The chunk's tokens,
fingerprints and flags travel to the host as one [n_steps + 2, B] int32
array. torch has no full uint32 arithmetic: the hash is held in int64 and
masked to 32 bits after every multiply (the product of a 32-bit value and
the 25-bit prime stays inside int64).
"""

from __future__ import annotations

import numpy as np
import torch

FP_BASIS = 2166136261
FP_PRIME = 16777619
_M32 = 0xFFFFFFFF


def fingerprint_init(b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row fold state of one chunk: (hash int64 [b], finite bool [b])."""
    return (torch.full((b,), FP_BASIS, dtype=torch.int64, device=device),
            torch.ones((b,), dtype=torch.bool, device=device))


def fingerprint_fold(h: torch.Tensor, ok: torch.Tensor, logits: torch.Tensor, tokens: torch.Tensor):
    """Fold one step (logits [B, vocab] f32, sampled tokens [B]) into the
    chunk's per-row state."""
    finite = torch.isfinite(logits.to(torch.float32).sum(dim=-1))
    arg = torch.argmax(logits, dim=-1).to(torch.int64)
    h = ((h * FP_PRIME) & _M32) ^ arg
    h = ((h * FP_PRIME) & _M32) ^ (tokens.to(torch.int64) & _M32)
    return h, ok & finite


def pack_chunk_outputs(tokens: torch.Tensor, h: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """[n_steps, B] tokens + fingerprint row + finite row -> [n_steps + 2, B]
    int32 (the fingerprint's bits reinterpreted as int32)."""
    fp = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return torch.cat([tokens.to(torch.int64), fp[None], ok.to(torch.int64)[None]]).to(torch.int32)


def split_chunk_outputs(arr: np.ndarray, n_steps: int):
    """Host inverse of :func:`pack_chunk_outputs`: (tokens [n_steps, B],
    fingerprints uint32 [B], finite bool [B])."""
    arr = np.asarray(arr)
    fp = (arr[n_steps].astype(np.int64) & _M32).astype(np.uint32)
    return arr[:n_steps], fp, arr[n_steps + 1] != 0
