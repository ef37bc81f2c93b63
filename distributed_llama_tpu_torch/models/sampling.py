"""Device sampling and the decode loop.

Sampling runs on the device beside the forward: temperature / top-k / top-p
filtering and the categorical draw, with coins from the counter PRNG
(:mod:`prng`) keyed on ``(request seed, consumed position)``. No sampler
state exists, so a stream is identical however its decode is chunked.

Candidate semantics (the JAX package's, which the host counter ``Sampler``
mirrors): candidates are ordered by descending temperature-scaled logit,
ties by lower token id; top-k keeps the first k; top-p keeps candidate i
while the mass strictly before it is < topp; the draw is inverse-CDF over
the kept prefix with one uniform coin. With both filters off the draw is
inverse-CDF in vocab order. All float math is f32; cumulative sums and
full-vocab reductions may associate differently from the JAX package's by
ulps, so a pick whose coin lands within an ulp of a crossing can differ.

Sampler settings are host scalars. The vocab-order draw and the full-sort
pick are computed for every sampled token and selected on the device; only
the partition search (bare top-p whose nucleus outgrows the fast candidate
window) is entered after a device read, and only when the settings allow it
(top-p on, top-k off): at most one read per sampled token, none for greedy
tokens or when top-k is on.
"""

from __future__ import annotations

import torch

from distributed_llama_tpu_torch import prng
from distributed_llama_tpu_torch.models import llama
from distributed_llama_tpu_torch.models.config import LlamaConfig

# width of the sorted-candidate fast path
TOPP_FAST_K = 128
# vocab floor for the partition-based bare-top-p fallback
TOPP_PARTITION_MIN_V = 4096

_M32 = 0xFFFFFFFF


def _keep_count(vals, cum, topp, topk):
    """Kept-prefix width over descending candidates [rows, K]: nucleus
    count (inclusive crossing) ∧ top-k, clipped to [1, K]."""
    K = vals.shape[-1]
    topp_act = (topp > 0.0) & (topp < 1.0)
    n_nuc = torch.where(topp_act, (cum - vals < topp[:, None]).sum(dim=-1), K)
    n_k = torch.where(topk > 0, torch.clamp_max(topk, K), K)
    return torch.clamp(torch.minimum(n_nuc, n_k), 1, K)


def _pick_sorted(vals, idxs, coin, topp, topk):
    """Inverse-CDF pick over descending candidates ``vals`` [B, K] with ids
    ``idxs``: the first candidate whose cumulative mass exceeds
    coin * kept_mass, clamped to the kept prefix."""
    K = vals.shape[-1]
    cum = torch.cumsum(vals, dim=-1)
    n_keep = _keep_count(vals, cum, topp, topk)
    total = torch.gather(cum, 1, (n_keep - 1)[:, None])[:, 0]
    r = coin * total
    ar = torch.arange(K, device=vals.device)
    below = ((ar[None, :] < n_keep[:, None]) & (cum <= r[:, None])).sum(dim=-1)
    pick = torch.minimum(below, n_keep - 1)
    return torch.gather(idxs, 1, pick[:, None])[:, 0]


def _desc_key(scaled: torch.Tensor) -> torch.Tensor:
    """A uint32 key (held in int64) monotone increasing in the f32 value:
    non-negative floats set the sign bit, negative ones flip every bit."""
    b = scaled.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where((b >> 31) == 1, (~b) & _M32, b | 0x80000000)


def _topp_partition_pick(probs, scaled, coin, topp):
    """Exact bare-top-p pick by threshold selection: two 32-step binary
    searches over the scaled logits' key space instead of a full-vocab
    sort (the JAX package's algorithm, step for step)."""
    keys = _desc_key(scaled)
    B = probs.shape[0]

    def mass_geq(v):
        return torch.where(keys >= v[:, None], probs, 0.0).sum(dim=-1)

    def bit_search(pred):
        v = torch.zeros(B, dtype=torch.int64, device=probs.device)
        for k in range(31, -1, -1):
            cand = v | (1 << k)
            v = torch.where(pred(cand), cand, v)
        return v

    def succ(v):
        return torch.where(v == _M32, v, v + 1)

    v_b = bit_search(lambda v: mass_geq(v) >= topp)
    above_b = mass_geq(succ(v_b))
    at_b = keys == v_b[:, None]
    tie_b = torch.where(at_b, probs, 0.0)
    tiecum_b = torch.cumsum(tie_b, dim=-1)
    tie_kept = at_b & (above_b[:, None] + (tiecum_b - tie_b) < topp[:, None])
    kept_tie_mass = torch.where(tie_kept, tiecum_b, 0.0).amax(dim=-1)
    total = above_b + kept_tie_mass
    strictly_above = keys > v_b[:, None]
    last_kept = torch.argmax(torch.where(tie_kept, tiecum_b, -1.0), dim=-1)

    r = coin * total
    v_p = bit_search(lambda v: mass_geq(v) > r)
    above_p = mass_geq(succ(v_p))
    at_p = keys == v_p[:, None]
    tiecum_p = torch.cumsum(torch.where(at_p, probs, 0.0), dim=-1)
    hit = at_p & (above_p[:, None] + tiecum_p > r[:, None])
    pick = torch.where(hit.any(dim=-1), torch.argmax(hit.to(torch.int8), dim=-1), last_kept)
    in_kept = torch.gather(strictly_above | tie_kept, 1, pick[:, None])[:, 0]
    return torch.where(in_kept, pick, last_kept)


def fused_pick(probs, scaled, coin, topp, topk, may_partition: bool = True):
    """The filtered categorical pick on probabilities [B, V] (f32); rows with
    both filters off draw inverse-CDF in vocab order. ``may_partition``
    False (the caller knows no row has top-p on and top-k off) skips the
    device read that decides whether the partition search runs."""
    B, V = probs.shape
    K = min(TOPP_FAST_K, V)
    topp_act = (topp > 0.0) & (topp < 1.0)
    topk_act = (topk > 0) & (topk < V)
    filt = topp_act | topk_act

    cdf = torch.cumsum(probs, dim=-1)
    r_m = coin * cdf[:, -1]
    idx_m = torch.clamp_max((cdf <= r_m[:, None]).sum(dim=-1), V - 1)

    # descending scaled logit, ties by lower id (a stable sort)
    order = torch.sort(scaled, dim=-1, descending=True, stable=True).indices

    def from_full():
        return _pick_sorted(torch.gather(probs, 1, order), order, coin, topp, topk)

    if K == V:
        tok_f = from_full()
    else:
        idxs = order[:, :K]
        vals = torch.gather(probs, 1, idxs)
        cum_k = torch.cumsum(vals, dim=-1)
        nucleus_unfit = topp_act & (cum_k[:, -1] < topp)
        wide_topk = topk_act & (topk > K)
        narrow_topk = topk_act & (topk <= K)
        if V >= TOPP_PARTITION_MIN_V:
            need_part = nucleus_unfit & ~topk_act
            need_sort = wide_topk & (nucleus_unfit | ~topp_act)
        else:
            need_part = None
            need_sort = (nucleus_unfit & ~narrow_topk) | (~topp_act & wide_topk)
        tok_f = torch.where(need_sort, from_full(), _pick_sorted(vals, idxs, coin, topp, topk))
        if need_part is not None and may_partition and bool(need_part.any()):
            tok_f = torch.where(need_part, _topp_partition_pick(probs, scaled, coin, topp), tok_f)
    return torch.where(filt, tok_f, idx_m)


def fused_sample_batched(logits, seeds, pos, temperature, topp, topk, draw: int = prng.DRAW_SAMPLE,
                         may_partition: bool = True):
    """Temperature/top-k/top-p sampling of logits [B, V] with one counter
    coin per row keyed ``(seeds[b], pos[b], draw)``; rows with temperature
    0 take the raw-logits argmax (first index on ties)."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    probs = llama.softmax(scaled, dim=-1)
    coin = prng.device_coin(seeds, pos, draw)
    tok = fused_pick(probs, scaled, coin, topp, topk, may_partition)
    return torch.where(temperature == 0.0, greedy, tok)


def sample_token(logits, seed32: int, pos: int, temperature: float, topp: float, topk: int = 0):
    """One token id (int64 scalar on the logits' device) from f32 logits
    [vocab]; ``seed32`` is the folded seed, ``pos`` the consumed position."""
    if temperature == 0.0:
        return torch.argmax(logits.to(torch.float32))
    dev = logits.device
    may_partition = 0.0 < topp < 1.0 and not 0 < topk < logits.shape[-1]

    def row(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)

    return fused_sample_batched(
        logits[None], row(seed32, torch.int64), row(pos, torch.int64),
        row(temperature, torch.float32), row(topp, torch.float32), row(topk, torch.int64),
        may_partition=may_partition,
    )[0]


def decode_scan(cfg: LlamaConfig, params, first_token, cache, pos: int, seed32: int, n_steps: int,
                temperature: float, topp: float, topk: int = 0, path: str = "int8"):
    """forward -> sample -> feed back, ``n_steps`` times. ``first_token`` is
    a host int or a device scalar (it never has to visit the host); step i
    consumes position pos+i. Returns (tokens [n_steps] on the device,
    cache)."""
    dev = params["embedding"].device
    token = torch.as_tensor(first_token, dtype=torch.int64, device=dev).reshape(1)
    out = []
    for i in range(n_steps):
        logits, cache = llama.forward_tokens(cfg, params, token, cache, pos + i, path)
        token = sample_token(logits[0], seed32, pos + i, temperature, topp, topk).reshape(1)
        out.append(token)
    return torch.cat(out), cache


def decode_chunk(cfg: LlamaConfig, params, first_token, cache, pos: int, n_steps: int,
                 temperature: float, topp: float, topk: int, seed32: int, path: str = "int8"):
    """One chunk of the streaming decode (the JAX package's argument order)."""
    return decode_scan(cfg, params, first_token, cache, pos, seed32, n_steps, temperature, topp, topk, path)
