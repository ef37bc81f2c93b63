"""Online-softmax (flash-style) attention over the single-stream cache.

A chunk of key/value rows is scored at once and partials merge with the
(max, exp-sum, weighted-sum) algebra; chunks beyond the last live position
are never read. Plain PyTorch: the JAX package computes these in XLA, not
in a Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from distributed_llama_tpu_torch.ops import kv_cache as kvc

_NEG_INF = float("-inf")


def chunk_attention(
    q: torch.Tensor,  # [Tq, K, M, hd] f32 grouped queries
    k: torch.Tensor,  # [Tk, K, hd] cache dtype
    v: torch.Tensor,  # [Tk, K, hd]
    q_positions: torch.Tensor,  # [Tq]
    k_positions: torch.Tensor,  # [Tk]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked scores of one (q-chunk, kv-chunk) pair -> (m, l, o) partials:
    running max [Tq, K, M], exp-sum [Tq, K, M], weighted V sum
    [Tq, K, M, hd]. A fully masked row keeps m = -inf (the empty partial,
    which :func:`merge_partials` merges as an exact identity)."""
    hd = q.shape[-1]
    cdt = kvc.compute_dtype(k)
    scores = kvc.scores_einsum(q.to(cdt), k) / math.sqrt(hd)
    mask = (k_positions[None, :] <= q_positions[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = kvc.mix_einsum(p, v, cdt)
    return m, l, o


def merge_partials(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partials. An empty partial (m = -inf,
    l = 0, o = 0) merges as an exact identity: its factor is forced to 0
    and the other side's to exp(0) = 1, so the survivor passes through
    bit-unchanged."""
    m = torch.maximum(m1, m2)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    a1 = torch.where(torch.isfinite(m1), torch.exp(m1 - safe), 0.0)
    a2 = torch.where(torch.isfinite(m2), torch.exp(m2 - safe), 0.0)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def blocked_partials(
    qg: torch.Tensor,  # [T, K, M, hd] f32
    keys: torch.Tensor,  # [Sl, K, hd]
    values: torch.Tensor,
    pos: int,  # absolute position of query row 0 (rows are pos..pos+T-1)
    base: int,  # absolute position of local slot 0
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partials of T queries over a cache slice, reading only the chunks
    that hold live slots (up to pos+T-1). Positions are host ints, so the
    chunk bound needs no device read. Requires Sl % chunk == 0."""
    T, K, M, hd = qg.shape
    Sl = keys.shape[0]
    live = min(max(pos + T - base, 0), Sl)
    n_chunks = -(-live // chunk)
    dev = qg.device
    q_pos = pos + torch.arange(T, device=dev)
    m = torch.full((T, K, M), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((T, K, M), dtype=torch.float32, device=dev)
    o = torch.zeros((T, K, M, hd), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        start = i * chunk
        kc = kvc.slice_rows(keys, start, chunk)
        vc = kvc.slice_rows(values, start, chunk)
        k_pos = base + start + torch.arange(chunk, device=dev)
        m, l, o = merge_partials(m, l, o, *chunk_attention(qg, kc, vc, q_pos, k_pos))
    return m, l, o


def blocked_attention(
    qg: torch.Tensor,  # [T, K, M, hd] f32
    keys: torch.Tensor,  # [S, K, hd]
    values: torch.Tensor,
    pos: int,  # absolute position of query row 0
    chunk: int,
) -> torch.Tensor:
    """Causal attention of T query rows over the cache, blocked along the
    key axis: only chunks holding positions <= pos+T-1 are read. Returns
    [T, K, M, hd] f32. Requires S % chunk == 0."""
    m, l, o = blocked_partials(qg, keys, values, pos, 0, chunk)
    return o / torch.clamp_min(l, 1e-30)[..., None]
