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
from distributed_llama_tpu_torch.engine import integrity
from distributed_llama_tpu_torch.models import llama
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.platform import to_device

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
        return to_device([v], dev, dtype)

    return fused_sample_batched(
        logits[None], row(seed32, torch.int64), row(pos, torch.int64),
        row(temperature, torch.float32), row(topp, torch.float32), row(topk, torch.int64),
        may_partition=may_partition,
    )[0]


def decode_scan(cfg: LlamaConfig, params, first_token, cache, pos: int, seed32: int, n_steps: int,
                temperature: float, topp: float, topk: int = 0, path: str = "int8", forward=None):
    """forward -> sample -> feed back, ``n_steps`` times. ``first_token`` is
    a host int or a device scalar (it never has to visit the host); step i
    consumes position pos+i. ``forward(tokens, cache, pos) -> (logits,
    cache)`` stands in for the single-device forward over ``params``: the
    tensor-parallel backend passes its own, whose logits every rank holds
    byte-identical, so the one sample drawn here is the token each rank
    would draw from its own copy. Returns (tokens [n_steps] on the device,
    cache)."""
    if forward is None:
        def forward(tokens, c, p):
            return llama.forward_tokens(cfg, params, tokens, c, p, path)
    out = []
    token = first_token
    for i in range(n_steps):
        logits, cache = forward(_feed(token, params), cache, pos + i)
        token = sample_token(logits[0], seed32, pos + i, temperature, topp, topk).reshape(1)
        out.append(token)
    return torch.cat(out), cache


def _feed(token, params) -> torch.Tensor:
    """A token (host int or device scalar) as int64 [1] on the device of
    ``params`` (a rank list's first rank under tensor parallelism)."""
    dev = (params[0] if isinstance(params, list) else params)["embedding"].device
    return torch.as_tensor(token, dtype=torch.int64, device=dev).reshape(1)


def decode_chunk(cfg: LlamaConfig, params, first_token, cache, pos: int, n_steps: int,
                 temperature: float, topp: float, topk: int, seed32: int, path: str = "int8", forward=None):
    """One chunk of the streaming decode (the JAX package's argument order)."""
    return decode_scan(cfg, params, first_token, cache, pos, seed32, n_steps, temperature, topp, topk, path,
                       forward=forward)


def may_partition_rows(temperature, topp, topk, vocab_size: int) -> bool:
    """Whether any sampled row has top-p on and top-k off (host settings):
    only then may :func:`fused_pick` read the device for the partition
    search."""
    return any(t > 0.0 and 0.0 < p < 1.0 and not 0 < k < vocab_size
               for t, p, k in zip(temperature, topp, topk))


def batched_decode_scan(cfg: LlamaConfig, params, first_tokens, cache, pos, active, seeds, n_steps: int,
                        temperature, topp, topk, paged=None, path: str = "int8", may_partition: bool = True,
                        forward=None):
    """B rows step together, each weight matrix read once per step: per row
    the same forward -> sample -> feed-back chain as :func:`decode_scan`
    with the same position-keyed coins, so a row's stream equals the
    single-stream decode for its seed. ``pos``/``active`` are host
    sequences (positions of ``first_tokens``; inactive rows neither write
    nor advance); ``seeds``/``temperature``/``topp``/``topk`` are [B]
    device tensors. ``forward(tokens, cache, pos) -> (logits, cache)``
    stands in for the single-device batched step: the tensor-parallel
    backend passes its own, whose all-gathered full-vocab logits every rank
    holds, so the fingerprint and the sample below are what each rank would
    compute from its copy. Returns (tokens [n_steps, B], cache,
    fingerprints, finite flags) (engine/integrity.py)."""
    if forward is None:
        def forward(tokens, c, p):
            return llama.forward_step_batched(cfg, params, tokens, c, p, active, path, paged)
    dev = first_tokens.device
    B = first_tokens.shape[0]
    steps = [[p + i if a else p for p, a in zip(pos, active)] for i in range(n_steps)]
    coin_pos = to_device(steps, dev, torch.int64)
    h, ok = integrity.fingerprint_init(B, dev)
    tokens, out = first_tokens.to(torch.int64), []
    for i in range(n_steps):
        logits, cache = forward(tokens, cache, steps[i])
        tokens = fused_sample_batched(logits, seeds, coin_pos[i], temperature, topp, topk,
                                      may_partition=may_partition)
        h, ok = integrity.fingerprint_fold(h, ok, logits, tokens)
        out.append(tokens)
    return torch.stack(out), cache, h, ok


def decode_chunk_batched(cfg: LlamaConfig, params, first_tokens, cache, pos, active, n_steps: int,
                         temperature, topp, topk, seeds, path: str = "int8", may_partition: bool = True):
    """One chunk of the batched decode (the JAX package's argument order).
    Returns (the packed [n_steps + 2, B] int32 tokens + fingerprint +
    finite rows, cache); the slab is written in place."""
    tokens, cache, h, ok = batched_decode_scan(cfg, params, first_tokens, cache, pos, active, seeds, n_steps,
                                               temperature, topp, topk, path=path, may_partition=may_partition)
    return integrity.pack_chunk_outputs(tokens, h, ok), cache


def decode_chunk_batched_paged(cfg: LlamaConfig, params, first_tokens, cache, pos, active, pool, n_steps: int,
                               temperature, topp, topk, seeds, tables, matched, path: str = "int8",
                               may_partition: bool = True):
    """:func:`decode_chunk_batched` with the prefix read: row b's positions
    below matched[b] come from the (read-only) page pool through its page
    table (tables [B, n_table] and matched [B] on the device)."""
    tokens, cache, h, ok = batched_decode_scan(cfg, params, first_tokens, cache, pos, active, seeds, n_steps,
                                               temperature, topp, topk, paged=(pool, tables, matched),
                                               path=path, may_partition=may_partition)
    return integrity.pack_chunk_outputs(tokens, h, ok), cache


# ---------------------------------------------------------------------------
# Self-speculative decoding: the host drafts up to k tokens by prompt lookup
# (engine/speculative.py), one verify forward scores [prev, d_1..d_k] in one
# weight read, and the accept/reject below runs on the device, so only
# (n_emit, tokens) cross to the host per step.
# ---------------------------------------------------------------------------


def _filtered_dist(logits, temperature, topp, topk):
    """The renormalized filtered distribution p [R, V] the speculative
    accept/redraw draws from, for logits [R, V] with per-row settings [R]:
    the fused sampler's candidate semantics (descending scaled logit, ties
    by lower id; top-k and nucleus prefix) as a mask and a renormalization.
    Returns (p, greedy targets [R])."""
    logits = logits.to(torch.float32)
    greedy_targets = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    probs = llama.softmax(scaled, dim=-1)
    order = torch.sort(scaled, dim=-1, descending=True, stable=True).indices
    pv = torch.gather(probs, 1, order)
    n_keep = _keep_count(pv, torch.cumsum(pv, dim=-1), topp, topk)
    ranks = torch.empty_like(order).scatter_(1, order, torch.arange(order.shape[-1], device=order.device)
                                             .expand_as(order).contiguous())
    filt = torch.where(ranks < n_keep[:, None], probs, 0.0)
    return filt / filt.sum(dim=-1, keepdim=True), greedy_targets


def _cdf_pick(p, coin):
    """Vocab-order inverse-CDF draw from per-row distributions ``p`` [R, V]
    with coins [R] (mass scaled by the row total, so zeroed entries never
    draw)."""
    cdf = torch.cumsum(p, dim=-1)
    r = coin * cdf[:, -1]
    return torch.clamp_max((cdf <= r[:, None]).sum(dim=-1), p.shape[-1] - 1)


def spec_accept_rows(logits, draft, draft_len, seeds, pos, temperature, topp, topk, sampled: bool = True):
    """Accept/reject each row's draft against its verify logits.

    ``logits`` [B, T, V] f32 (T = k + 1): ``logits[b, i]`` is the next-token
    distribution after feed position i (stream position pos[b] + i);
    ``draft`` [B, k] (entries at or beyond ``draft_len[b]`` are padding);
    ``draft_len``, ``seeds``, ``pos``, ``temperature``, ``topp``, ``topk``
    [B] on the device. Returns (n_emit [B], tokens [B, T]): ``tokens[b,
    :n_emit[b]]`` are the accepted drafts and one correction or bonus token.

    Greedy rows (temperature 0) accept the longest prefix equal to the
    argmax targets, so every emitted token is plain decode's argmax at its
    position. Sampled rows run Leviathan rejection sampling with the
    point-mass draft: position i accepts with probability p_i(draft_i) on
    the coin keyed (seed, pos + i, DRAW_SPEC_ACCEPT), and a rejection
    redraws from p with the draft token removed on the DRAW_SPEC_REDRAW coin
    of the emit position. ``sampled`` False (the caller knows every row is
    greedy) skips the filtered distribution, which greedy rows never read.
    The per-row pass of the JAX package's ``_spec_accept_row``, batched over
    rows."""
    B, T, V = logits.shape
    k = T - 1
    dev = logits.device
    t_idx = torch.arange(T, device=dev)
    if sampled:
        rep = lambda v: v[:, None].expand(B, T).reshape(-1)  # noqa: E731
        p, greedy_targets = _filtered_dist(logits.reshape(B * T, V), rep(temperature), rep(topp), rep(topk))
        p, greedy_targets = p.reshape(B, T, V), greedy_targets.reshape(B, T)
    else:
        greedy_targets = torch.argmax(logits.to(torch.float32), dim=-1)
    greedy = temperature == 0.0
    draft = draft.to(torch.int64)
    in_draft = t_idx[None, :k] < draft_len[:, None]
    ok = draft == greedy_targets[:, :k]
    if sampled:
        steps = pos.to(torch.int64)[:, None] + t_idx[None, :]
        seeds_bt = seeds[:, None].expand(B, T)
        u = prng.device_coin(seeds_bt, steps, prng.DRAW_SPEC_ACCEPT)
        redraw = prng.device_coin(seeds_bt, steps, prng.DRAW_SPEC_REDRAW)
        p_draft = torch.gather(p[:, :k], 2, draft[..., None])[..., 0]
        ok = torch.where(greedy[:, None], ok, u[:, :k] < p_draft)
    n_acc = torch.cumprod((ok & in_draft).to(torch.int64), dim=1).sum(dim=1)
    corr = torch.gather(greedy_targets, 1, n_acc[:, None])[:, 0]
    if sampled:
        q = torch.where(torch.arange(V, device=dev)[None, None, :] == draft[..., None], 0.0, p[:, :k])
        resid = _cdf_pick(q.reshape(B * k, V), redraw[:, :k].reshape(-1)).reshape(B, k)
        full = _cdf_pick(p.reshape(B * T, V), redraw.reshape(-1)).reshape(B, T)
        resid = torch.cat([resid, torch.zeros((B, 1), dtype=resid.dtype, device=dev)], dim=1)
        rejected = n_acc < draft_len
        corr_sampled = torch.where(rejected, torch.gather(resid, 1, n_acc[:, None])[:, 0],
                                   torch.gather(full, 1, n_acc[:, None])[:, 0])
        corr = torch.where(greedy, corr, corr_sampled)
    draft_padded = torch.cat([draft, torch.zeros((B, 1), dtype=draft.dtype, device=dev)], dim=1)
    tokens = torch.where(t_idx[None, :] < n_acc[:, None], draft_padded, 0)
    tokens = torch.where(t_idx[None, :] == n_acc[:, None], corr[:, None], tokens)
    return n_acc + 1, tokens


def spec_verify_step(cfg: LlamaConfig, params, feed, cache, pos: int, draft_len: int, temperature: float,
                     topp: float, topk: int, seed32: int, path: str = "int8"):
    """One single-stream speculative step: the verify forward (T = len(feed)
    tokens from host position ``pos``) and the on-device accept/reject.
    Returns (out int64 [T+1] = [n_emit, tokens...] on the device, cache).
    Cache slots past the accepted prefix hold rejected drafts' K/V: stale
    but unreachable, since the next step writes them before any query can
    see them."""
    dev = params["embedding"].device
    # per_position: each window row attends as a T=1 decode step at its
    # position, so a greedy speculative stream is the plain decode stream
    logits, cache = llama.forward_tokens(cfg, params, feed, cache, pos, path, per_position=True)
    row = lambda v, dt: to_device([v], dev, dt)  # noqa: E731
    n_emit, tokens = spec_accept_rows(
        logits[None], feed[None, 1:], row(draft_len, torch.int64), row(seed32, torch.int64),
        row(pos, torch.int64), row(temperature, torch.float32), row(topp, torch.float32),
        row(topk, torch.int64), sampled=temperature != 0.0)
    return torch.cat([n_emit, tokens[0]]), cache


def spec_verify_chunk_batched(cfg: LlamaConfig, params, feed, cache, pos, active, draft_len, temperature, topp,
                              topk, seeds, paged=None, path: str = "int8", sampled: bool = True):
    """One batched speculative step: every row's verify window (feed int
    [B, T] on the device) rides one weight read
    (:func:`llama.forward_verify_batched`) and the per-row accept/reject
    runs on the device. ``pos``/``active`` are host sequences; the rest are
    [B] device tensors; ``paged`` = (pool, tables, matched) reads each
    row's matched prefix from the page pool. Returns (out [B, T+1] with
    ``out[b] = [n_emit_b, tokens_b...]``, cache): rows advance a variable
    number of positions, which the caller applies once it has the result.
    Inactive rows compute garbage into dropped cache slots."""
    logits, cache = llama.forward_verify_batched(cfg, params, feed, cache, pos, active, path, paged)
    dev = feed.device
    n_emit, tokens = spec_accept_rows(logits, feed[:, 1:], draft_len, seeds,
                                      to_device([int(p) for p in pos], dev, torch.int64), temperature, topp, topk,
                                      sampled=sampled)
    return torch.cat([n_emit[:, None], tokens], dim=1), cache
