"""Integrity primitives: chunk fingerprints, weight checksums, corruption.

The port's copy of the JAX package's ``engine/integrity.py``.

* **Logit fingerprints.** Each batched decode step folds the row's logit
  argmax and sampled token into an FNV-1a hash, and ANDs in whether the
  row's logits were all finite (NaN logits pushed through a softmax can
  yield a perfectly in-vocab token, so the scheduler checks the flag, not
  the token). The chunk's tokens, fingerprints and flags travel to the host
  as one [n_steps + 2, B] int32 array. torch has no full uint32 arithmetic:
  the hash is held in int64 and masked to 32 bits after every multiply (the
  product of a 32-bit value and the 25-bit prime stays inside int64). The
  host folds a stream's chunk fingerprints with :func:`fold_run_fingerprint`.
* **Weight checksums** (:func:`params_checksum`). An order-independent
  wrapping uint32 word sum per leaf (floats bit-cast, so a single flipped
  bit always moves the sum), folded through CRC-32 on the host: the JAX
  package's value for the same leaves. torch has no uint16/uint32
  arithmetic, so each word is zero-extended by masking its signed view, and
  a leaf is summed in slices, so no widened copy of a multi-GB Q40 pack is
  ever allocated.
* **Deterministic corruption** (:func:`corrupt_params`): the ``engine.sdc``
  fault's payload, a seeded weight slice scaled into finite-but-wrong values.
* **Reserved tenants**: the SDC canary bills its probes to
  :data:`CANARY_TENANT` and rollout certification to :data:`ROLLOUT_TENANT`;
  clients may not name either (the server refuses tenant names starting
  with ``_``).
"""

from __future__ import annotations

import dataclasses
import random
import zlib

import numpy as np
import torch

FP_BASIS = 2166136261
FP_PRIME = 16777619
_M32 = 0xFFFFFFFF

# the reserved internal tenant canary and shadow probes bill to: a direct
# lane claim, no admission permit, never a client identity
CANARY_TENANT = "_integrity"

# the reserved internal tenant rollout certification probes bill to (the
# same contract as the canary's)
ROLLOUT_TENANT = "_rollout"

RESERVED_TENANTS = (CANARY_TENANT, ROLLOUT_TENANT)


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


def fold_run_fingerprint(run: int, chunk_fp: int) -> int:
    """Host-side fold of one chunk's fingerprint into a stream-lifetime
    fingerprint (the same FNV-1a step); streams start from :data:`FP_BASIS`."""
    return ((int(run) * FP_PRIME) ^ int(chunk_fp)) & _M32


# ----------------------------------------------------------------------
# Weight checksums
# ----------------------------------------------------------------------

# elements per slice of a leaf's word sum: its int64 widening is 128 MiB
_SUM_SLICE = 1 << 24


def _leaves(tree, path: str = ""):
    """(path, tensor) pairs in the JAX package's tree order (dict keys
    sorted, lists in order, a QuantizedMatrix as its qs then its scales),
    paths spelled as ``jax.tree_util.keystr`` spells dict and list keys."""
    from distributed_llama_tpu_torch.ops.q40 import QuantizedMatrix

    if isinstance(tree, QuantizedMatrix):
        yield f"{path}.qs", tree.qs
        yield f"{path}.scales", tree.scales
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _words(flat: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A flat leaf as its same-width signed integer words and the mask that
    zero-extends them (bools count as bytes)."""
    if flat.dtype == torch.bool:
        return flat.view(torch.uint8), 0xFF
    size = flat.element_size()
    if size == 1:
        return flat.view(torch.uint8), 0xFF
    if size == 2:
        return flat.view(torch.int16), 0xFFFF
    return flat.view(torch.int32), _M32  # 8-byte words count as two 32-bit halves


def _leaf_word_sum(leaf: torch.Tensor) -> torch.Tensor:
    """Wrapping uint32 sum of a leaf's underlying words, as a device int64
    scalar in [0, 2**32): summed slice by slice, each slice widened to
    int64 and masked, the running total reduced mod 2**32 after each."""
    words, mask = _words(leaf.contiguous().reshape(-1))
    total = torch.zeros((), dtype=torch.int64, device=leaf.device)
    for lo in range(0, words.numel(), _SUM_SLICE):
        part = words[lo : lo + _SUM_SLICE].to(torch.int64)
        if mask != 0xFF:
            part &= mask
        total = (total + part.sum()) & _M32
    return total


def params_checksum(params) -> str:
    """Deterministic hex checksum of a whole params tree: per-leaf device
    word sums, one stacked fetch, CRC-32 fold on the host (the JAX
    package's ``params_checksum`` of the same leaves)."""
    sums = [_leaf_word_sum(leaf) for _, leaf in _leaves(params)]
    if not sums:
        return "00000000"
    vec = torch.stack(sums).cpu().numpy().astype(np.uint32)
    return f"{zlib.crc32(vec.tobytes()) & _M32:08x}"


class ChecksumMismatch(RuntimeError):
    """A rebuilt engine's weight checksum disagrees with its reference:
    the rebuild itself is corrupt and must not serve."""


# ----------------------------------------------------------------------
# Deterministic corruption (the engine.sdc fault's payload)
# ----------------------------------------------------------------------


def _with_leaf(tree, old: torch.Tensor, new: torch.Tensor):
    """``tree`` with the leaf that is ``old`` replaced by ``new``: the
    containers on the way are copied, every other leaf is shared."""
    from distributed_llama_tpu_torch.ops.q40 import QuantizedMatrix

    if tree is old:
        return new
    if isinstance(tree, QuantizedMatrix):
        return dataclasses.replace(tree, qs=_with_leaf(tree.qs, old, new), scales=_with_leaf(tree.scales, old, new))
    if isinstance(tree, dict):
        return {k: _with_leaf(v, old, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_leaf(v, old, new) for v in tree)
    return tree


def corrupt_params(params, seed: int = 0, scale: float = -1.7319, copy: bool = False):
    """Perturb one weight slice into finite-but-wrong values, in place, and
    return ``(params, description)``. The target is drawn from the seeded
    RNG over floating-point leaves, preferring normalization weights (they
    scale every token's residual stream, so the damage reaches any prompt),
    then non-embedding leaves, then anything float: the JAX package's
    choice over the same tree. The first ``min(256, size)`` elements become
    ``x * scale + 0.125`` computed in f32. ``copy`` corrupts a copy of the
    target leaf in a new tree instead (as the JAX package's functional
    update does): what an engine that shares its params with others (a
    pod's slices) must do, so the damage stays its own."""
    cand = [(path, leaf) for path, leaf in _leaves(params) if leaf.is_floating_point() and leaf.numel() > 0]
    if not cand:
        raise ValueError("no floating-point weight leaf to corrupt")
    norms = [c for c in cand if "rms" in c[0].lower() or "norm" in c[0].lower()]
    non_embed = [c for c in cand if "embed" not in c[0].lower()]
    pool = norms or non_embed or cand
    path, leaf = pool[random.Random(seed).randrange(len(pool))]
    if copy:
        fresh = leaf.clone()
        params, leaf = _with_leaf(params, leaf, fresh), fresh
    vec = leaf.view(-1)
    n = max(1, min(256, vec.shape[0]))
    with torch.no_grad():
        vec[:n] = (vec[:n].to(torch.float32) * scale + 0.125).to(leaf.dtype)
    return params, f"weight slice [{n}] of {path}"
