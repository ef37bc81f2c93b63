"""Online-softmax (flash-style) attention: the single-stream cache, the
batched slab, and the prefix cache's paged reads.

A chunk of key/value rows is scored at once and partials merge with the
(max, exp-sum, weighted-sum) algebra; chunks beyond the last live position
are never read. The single-stream and prefill paths are plain PyTorch (the
JAX package computes them in XLA). The batched decode and verify paths go
through K2, the hand-written fused paged-attention kernel
(``csrc/paged_attention.cu``, replacing the Pallas ``_fused_paged_attention``):
its wrappers :func:`fused_paged_decode_attention` and
:func:`fused_paged_verify_attention` launch it for CUDA tensors (two
kernels: the chunk partials into a workspace, then their fold in chunk
order) and count each call in :data:`launches`, by cache kind (bf16/f32 halves, or int8
halves with per-slot scales); for CPU tensors they compute its plain
version, the segmented chunk scan (:func:`_segmented_batched_scan`).

On the card every batched step takes the kernel, paged or not (a row with
matched 0 reads only its slab row), so no step reads the device to bound
its chunk loop. The plain version reads pos and matched on the host.
With telemetry on, each call counts in
``dllama_kernel_path_total{kernel="paged_attention"}``: ``k2`` / ``k2_i8``
on the card, ``plain`` on the CPU; the batched steps' einsum branch
(``models/llama.py``, caches of S <= 512 or S % 512 != 0) counts
``einsum``.
"""

from __future__ import annotations

import math

import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.ops import kv_cache as kvc

_NEG_INF = float("-inf")

# kernel name -> launches since the last reset_launches(); the wrapper adds
# one where it launches the CUDA kernel and nowhere else
launches: dict[str, int] = {"paged_attention": 0, "paged_attention_i8": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    paged=None,  # (pool_k, pool_v, table [n_table], matched: int)
) -> torch.Tensor:
    """Causal attention of T query rows over the cache, blocked along the
    key axis: only chunks holding positions <= pos+T-1 are read. Returns
    [T, K, M, hd] f32. Requires S % chunk == 0.

    ``paged``: a slab row's prefill whose positions below ``matched`` live
    in the page pool. ONE loop covers every chunk with a per-position
    pool-or-slab select, on purpose: the JAX package found that splitting
    it into pool / mixed / slab loops perturbs the merge by ulps under
    XLA's per-loop codegen, and a prefix hit must equal the cold prefill.
    Requires chunk % page == 0."""
    if paged is None:
        m, l, o = blocked_partials(qg, keys, values, pos, 0, chunk)
        return o / torch.clamp_min(l, 1e-30)[..., None]
    pool_k, pool_v, table, matched = paged
    T, K, M, hd = qg.shape
    S = keys.shape[0]
    ppc = chunk // kvc.pool_page_size(pool_k)
    n_chunks = -(-min(pos + T, S) // chunk)
    dev = qg.device
    q_pos = pos + torch.arange(T, device=dev)
    m = torch.full((T, K, M), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((T, K, M), dtype=torch.float32, device=dev)
    o = torch.zeros((T, K, M, hd), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        k_pos = i * chunk + torch.arange(chunk, device=dev)
        sel = k_pos < matched
        kc = kvc.select_kv(sel, kvc.pool_chunk_row(pool_k, table, i, ppc), kvc.slice_rows(keys, i * chunk, chunk))
        vc = kvc.select_kv(sel, kvc.pool_chunk_row(pool_v, table, i, ppc), kvc.slice_rows(values, i * chunk, chunk))
        m, l, o = merge_partials(m, l, o, *chunk_attention(qg, kc, vc, q_pos, k_pos))
    return o / torch.clamp_min(l, 1e-30)[..., None]


# ---------------------------------------------------------------------------
# Batched decode / verify over the slab, with the paged prefix read
# ---------------------------------------------------------------------------


def _host_ints(t) -> list[int]:
    return [int(v) for v in (t.tolist() if isinstance(t, torch.Tensor) else t)]


def paged_segments(matched: list[int], chunk: int, n_chunks: int) -> tuple[int, int]:
    """Segment bounds of a paged chunk scan: chunks [0, a) lie below every
    row's matched length (pool-only reads), chunks [a, b) mix pool and slab
    per position, chunks [b, n_chunks) lie past every row's matched length
    (slab-only)."""
    a = min(min(matched) // chunk, n_chunks)
    b = min(max(-(-max(matched) // chunk), a), n_chunks)
    return a, b


def _segmented_batched_scan(partial, keys, values, paged, chunk: int, n_chunks: int, init, rows: int):
    """Run ``partial(kc, vc, start, carry)`` over every chunk, reading each
    from the slab (``paged`` None) or through the pool-only / mixed /
    slab-only segment split with per-position selects in the mixed span.
    Shared by decode and verify; it is K2's plain version."""

    def slab_chunk(i):
        return (kvc.slice_rows_batched(keys, i * chunk, chunk, rows=rows),
                kvc.slice_rows_batched(values, i * chunk, chunk, rows=rows))

    carry = init
    if paged is None:
        for i in range(n_chunks):
            carry = partial(*slab_chunk(i), i * chunk, carry)
        return carry
    pool_k, pool_v, tables, matched = paged
    ppc = chunk // kvc.pool_page_size(pool_k)
    matched_h = _host_ints(matched)
    a, b = paged_segments(matched_h, chunk, n_chunks)
    for i in range(a):
        carry = partial(kvc.pool_chunk(pool_k, tables, i, ppc), kvc.pool_chunk(pool_v, tables, i, ppc),
                        i * chunk, carry)
    matched_t = torch.as_tensor(matched_h, device=keys.device)
    for i in range(a, b):
        kc_s, vc_s = slab_chunk(i)
        sel = (i * chunk + torch.arange(chunk, device=keys.device))[None, :] < matched_t[:, None]
        carry = partial(kvc.select_kv(sel, kvc.pool_chunk(pool_k, tables, i, ppc), kc_s),
                        kvc.select_kv(sel, kvc.pool_chunk(pool_v, tables, i, ppc), vc_s), i * chunk, carry)
    for i in range(b, n_chunks):
        carry = partial(*slab_chunk(i), i * chunk, carry)
    return carry


def _softmax_partial(scores, mask):
    """Masked chunk scores -> (m, p, l): the per-chunk online-softmax step
    shared by decode and verify (m = -inf for a fully masked chunk)."""
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - safe_m[..., None]), 0.0)
    return m, p, p.sum(dim=-1)


def _decode_chunk(qg, pos, chunk: int, cdt):
    """The per-chunk partial (m, l, o) of the batched decode scan (qg
    [B,K,M,hd], row b's query at pos[b])."""
    hd = qg.shape[-1]
    q = qg.to(cdt)

    def part(kc, vc, start):
        k_pos = start + torch.arange(chunk, device=qg.device)
        scores = kvc.scores_einsum_batched(q, kc) / math.sqrt(hd)
        mask = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
        ms, p, ls = _softmax_partial(scores, mask)
        return ms, ls, kvc.mix_einsum_batched(p, vc, cdt)

    return part


def _verify_chunk(qg, pos, chunk: int, cdt):
    """The per-chunk partial (m, l, o) of the batched verify scan (qg
    [B,T,K,M,hd], row b's query t at pos[b]+t)."""
    T, hd = qg.shape[1], qg.shape[-1]
    q = qg.to(cdt)
    q_pos = pos[:, None] + torch.arange(T, device=qg.device)[None, :]

    def part(kc, vc, start):
        k_pos = start + torch.arange(chunk, device=qg.device)
        scores = kvc.scores_einsum_verify(q, kc) / math.sqrt(hd)
        mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
        ms, p, ls = _softmax_partial(scores, mask)
        return ms, ls, kvc.mix_einsum_verify(p, vc, cdt)

    return part


def _plain_chunks(qg, keys, pos, chunk: int):
    """(chunk partial function, live chunk count, pos as int64) of K2's
    plain version; the count reads max(pos) on the host."""
    verify = qg.dim() == 5
    T = qg.shape[1] if verify else 1
    pos = pos.to(device=qg.device, dtype=torch.int64)
    n_chunks = -(-min(max(_host_ints(pos)) + T, keys.shape[1]) // chunk)
    part = (_verify_chunk if verify else _decode_chunk)(qg, pos, chunk, kvc.compute_dtype(keys))
    return part, n_chunks, pos


def paged_attention_plain(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """K2's plain version: the segmented chunk scan over every row's slab
    row (and pool pages), decode for qg [B,K,M,hd], verify for qg
    [B,T,K,M,hd]. Reads max(pos) and matched on the host."""
    part, n_chunks, _ = _plain_chunks(qg, keys, pos, chunk)
    lead = qg.shape[:-1]
    init = (torch.full(lead, _NEG_INF, dtype=torch.float32, device=qg.device),
            torch.zeros(lead, dtype=torch.float32, device=qg.device),
            torch.zeros(qg.shape, dtype=torch.float32, device=qg.device))

    def partial(kc, vc, start, carry):
        return merge_partials(*carry, *part(kc, vc, start))

    m, l, o = _segmented_batched_scan(partial, keys, values, paged, chunk, n_chunks, init, rows=qg.shape[0])
    return o / torch.clamp_min(l, 1e-30)[..., None]


# K2 runs as two passes: the chunk partials into a workspace f32
# [B, K, S/chunk, T*M, hd + 2] holding (m, l, o[hd]) per query (query index
# t*M + m), then their fold in chunk order. Their plain versions below
# compose to paged_attention_plain bit for bit.


def _partial_to_ws(m, l, o, verify: bool) -> torch.Tensor:
    """One chunk's (m, l, o) in the query layout -> [B, K, T*M, hd + 2]."""
    x = torch.cat((m[..., None], l[..., None], o), dim=-1)
    if verify:  # [B, T, K, M, hd+2] -> [B, K, T*M, hd+2]
        B, T, K, M, w = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(B, K, T * M, w)
    return x


def _ws_to_partial(x: torch.Tensor, T: int, verify: bool):
    """Inverse of :func:`_partial_to_ws`, each part contiguous in the
    layout the scan's carry has."""
    if verify:
        B, K, TM, w = x.shape
        x = x.reshape(B, K, T, TM // T, w).permute(0, 2, 1, 3, 4)
    return x[..., 0].contiguous(), x[..., 1].contiguous(), x[..., 2:].contiguous()


def paged_attention_partials_plain(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """K2's first pass, plainly: every chunk's online-softmax partial, the
    chunks past every row's live bound (and fully masked ones) holding the
    empty partial (m = -inf, l = 0, o = 0). Returns the workspace f32
    [B, K, S/chunk, T*M, hd + 2]."""
    verify = qg.dim() == 5
    B, hd = qg.shape[0], qg.shape[-1]
    T = qg.shape[1] if verify else 1
    K, M = qg.shape[-3], qg.shape[-2]
    part, n_chunks, _ = _plain_chunks(qg, keys, pos, chunk)
    ws = torch.zeros((B, K, keys.shape[1] // chunk, T * M, hd + 2), dtype=torch.float32, device=qg.device)
    ws[..., 0] = _NEG_INF
    chunks: list = []
    _segmented_batched_scan(lambda kc, vc, start, carry: chunks.append(part(kc, vc, start)),
                            keys, values, paged, chunk, n_chunks, None, rows=B)
    for i, (m, l, o) in enumerate(chunks):
        ws[:, :, i] = _partial_to_ws(m, l, o, verify)
    return ws


def paged_attention_fold_plain(ws: torch.Tensor, q_shape) -> torch.Tensor:
    """K2's second pass, plainly: fold the workspace's chunk partials in
    chunk order with :func:`merge_partials`, then o / max(l, 1e-30), in the
    queries' shape ``q_shape`` ([B, K, M, hd] or [B, T, K, M, hd])."""
    verify = len(q_shape) == 5
    T = q_shape[1] if verify else 1
    dev = ws.device
    carry = (torch.full(tuple(q_shape[:-1]), _NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros(tuple(q_shape[:-1]), dtype=torch.float32, device=dev),
             torch.zeros(tuple(q_shape), dtype=torch.float32, device=dev))
    for i in range(ws.shape[2]):
        carry = merge_partials(*carry, *_ws_to_partial(ws[:, :, i], T, verify))
    m, l, o = carry
    return o / torch.clamp_min(l, 1e-30)[..., None]


def _fused_paged_eligible(keys, values, paged, chunk: int) -> bool:
    """Gate of K2: slab and pool halves share one quantization class (all
    int8 with scales, or none), chunks are whole pages and the slab blocks
    evenly. Mixed classes raise: no operand set of the kernel fits them."""
    quant = isinstance(keys, kvc.QuantizedKV)
    halves = (values,) if paged is None else (values, paged[0], paged[1])
    if any(isinstance(h, kvc.QuantizedKV) is not quant for h in halves):
        raise ValueError("paged_attention: keys, values and the pool halves mix int8 and float caches")
    page = chunk if paged is None else kvc.pool_page_size(paged[0])
    return chunk % page == 0 and keys.shape[1] % chunk == 0


# K2 serves head sizes that are multiples of 16 up to this (the JAX kernel
# takes any; ROADMAP.md records the difference)
K2_MAX_HEAD_SIZE = 256


def check_head_size(hd: int) -> None:
    """Raise ValueError for a head size K2 does not serve, before any launch."""
    if hd % 16 or not 16 <= hd <= K2_MAX_HEAD_SIZE:
        raise ValueError(f"paged_attention: head size {hd} is not served: K2 takes head sizes that are "
                         f"multiples of 16 from 16 to {K2_MAX_HEAD_SIZE}")


def _check_half(name: str, h, rows: int | None, n: int, K: int, hd: int, dev, dtype) -> None:
    """A K2 operand half: contiguous on ``dev``, [rows, n, K, hd] of
    ``dtype`` (rows None: any count, a pool; a quantized half holds int8
    data and [rows, n, K, 1] f32 scales)."""
    parts = ((h.data, torch.int8, hd), (h.scales, torch.float32, 1)) if isinstance(h, kvc.QuantizedKV) \
        else ((h, dtype, hd),)
    for t, dt, last in parts:
        if not (t.device == dev and t.dtype == dt and t.is_contiguous() and t.dim() == 4
                and tuple(t.shape[1:]) == (n, K, last) and (rows is None or t.shape[0] >= rows)):
            raise ValueError(f"paged_attention: {name} must be a contiguous {dt} tensor "
                             f"[{'P' if rows is None else f'>= {rows}'}, {n}, {K}, {last}] on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _ptrs(h) -> tuple[int, int]:
    """(data pointer, scales pointer or 0) of a K2 operand half."""
    if h is None:
        return 0, 0
    if isinstance(h, kvc.QuantizedKV):
        return h.data.data_ptr(), h.scales.data_ptr()
    return h.data_ptr(), 0


def _k2_operands(qg, keys, values, pos, chunk: int, paged):
    """Check K2's operands on the card and lay them out for its C entry
    points: (pointer arguments, int arguments, out, workspace, the tensors
    the pointers point into). Raises on what the kernel does not take."""
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    eligible = _fused_paged_eligible(keys, values, paged, chunk)
    verify = qg.dim() == 5
    B, hd = qg.shape[0], qg.shape[-1]
    T = qg.shape[1] if verify else 1
    K, M = qg.shape[-3], qg.shape[-2]
    S = keys.shape[1]
    if not eligible:
        raise ValueError(f"paged_attention: chunk {chunk} must be whole pages and divide S {S}")
    check_head_size(hd)
    quant = isinstance(keys, kvc.QuantizedKV)
    dtype = keys.dtype
    if not quant and dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_attention: cache dtype {dtype} (bf16, f32, or int8 with scales)")
    for name, t in (("keys", keys), ("values", values)):
        _check_half(name, t, B, S, K, hd, dev, dtype)
    q = qg.to(torch.float32).contiguous()
    pos32 = pos.to(device=dev, dtype=torch.int32).contiguous()
    if paged is None:  # matched 0: the kernel reads neither the pool nor the table
        pool_k = pool_v = None
        page, tables, matched = chunk, torch.zeros((B, 1), dtype=torch.int32, device=dev), torch.zeros_like(pos32)
        n_table = 1
    else:
        pool_k, pool_v, tables, matched = paged
        page = kvc.pool_page_size(pool_k)
        for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
            _check_half(name, t, None, page, K, hd, dev, dtype)
        tables = tables.to(device=dev, dtype=torch.int32).contiguous()
        matched = matched.to(device=dev, dtype=torch.int32).contiguous()
        n_table = tables.shape[1]
        if tables.shape[0] != B or n_table < chunk // page:
            raise ValueError(f"paged_attention: tables shape {tuple(tables.shape)} for {B} rows")
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    ws = torch.empty((B, K, S // chunk, T * M, hd + 2), dtype=torch.float32, device=dev)
    (sk, sks), (sv, svs), (pk, pks), (pv, pvs) = map(_ptrs, (keys, values, pool_k, pool_v))
    ptrs = (q.data_ptr(), sk, sv, pk, pv, sks, svs, pks, pvs, tables.data_ptr(), pos32.data_ptr(),
            matched.data_ptr(), out.data_ptr(), ws.data_ptr())
    ints = (B, T, K, M, hd, S, page, n_table, chunk, 2 if quant else int(dtype == torch.bfloat16))
    return ptrs, ints, out, ws, (q, pos32, tables, matched)


def _k2_call(dev, symbol: str, *args) -> None:
    from distributed_llama_tpu_torch.ops import cuda_build

    err = cuda_build.function("paged_attention", symbol)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


def _fused_paged_attention(qg, keys, values, pos, chunk: int, paged) -> torch.Tensor:
    """Launch K2 for CUDA tensors (or raise); compute its plain version for
    CPU tensors. ``paged`` None reads only the slab (matched 0). Float
    halves launch the bf16/f32 form (counted as ``paged_attention``), int8
    halves the int8 form (``paged_attention_i8``). One call is one count,
    though it runs two kernels (the chunk partials into a workspace, then
    their fold); the wrapper allocates the workspace."""
    check_head_size(qg.shape[-1])
    if qg.device.type == "cpu":
        _fused_paged_eligible(keys, values, paged, chunk)
        telemetry.note_kernel_path("paged_attention", "plain")
        return paged_attention_plain(qg, keys, values, pos, chunk, paged)
    ptrs, ints, out, _ws, _keep = _k2_operands(qg, keys, values, pos, chunk, paged)
    _k2_call(qg.device, "paged_attention", *ptrs, *ints)
    i8 = isinstance(keys, kvc.QuantizedKV)
    launches["paged_attention_i8" if i8 else "paged_attention"] += 1
    telemetry.note_kernel_path("paged_attention", "k2_i8" if i8 else "k2")
    return out


def paged_attention_partials(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """K2's first pass alone on the card (to hold it against
    :func:`paged_attention_partials_plain`; not counted in ``launches``):
    returns the workspace f32 [B, K, S/chunk, T*M, hd + 2]."""
    ptrs, ints, _out, ws, _keep = _k2_operands(qg, keys, values, pos, chunk, paged)
    _k2_call(qg.device, "paged_attention_partials", *ptrs, *ints)
    return ws


def paged_attention_fold(ws: torch.Tensor, q_shape) -> torch.Tensor:
    """K2's second pass alone on the card (to hold it against
    :func:`paged_attention_fold_plain`; not counted in ``launches``)."""
    verify = len(q_shape) == 5
    B, K, n_chunks, TM, w = ws.shape
    T = q_shape[1] if verify else 1
    check_head_size(q_shape[-1])
    if not (ws.device.type == "cuda" and ws.dtype == torch.float32 and ws.is_contiguous()
            and tuple(q_shape[:1]) + tuple(q_shape[-3:-1]) == (B, K, TM // T) and w == q_shape[-1] + 2):
        raise ValueError(f"paged_attention_fold: workspace {tuple(ws.shape)} for queries {tuple(q_shape)}")
    out = torch.empty(tuple(q_shape), dtype=torch.float32, device=ws.device)
    _k2_call(ws.device, "paged_attention_merge", ws.data_ptr(), out.data_ptr(), B, T, K, TM // T, w - 2,
             n_chunks * 512, 512)
    return out


def fused_paged_decode_attention(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """K2 on a decode step: qg [B, K, M, hd] f32 (row b's query at pos[b]),
    slab halves [B_max, S, K, hd], ``paged`` = (pool_k, pool_v, tables
    [B, n_table], matched [B]) or None. Returns [B, K, M, hd] f32."""
    return _fused_paged_attention(qg, keys, values, pos, chunk, paged)


def fused_paged_verify_attention(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """K2 on a verify window: qg [B, T, K, M, hd] f32, row b's query t at
    pos[b]+t; otherwise as :func:`fused_paged_decode_attention`. Returns
    [B, T, K, M, hd] f32."""
    return _fused_paged_attention(qg, keys, values, pos, chunk, paged)


def batched_decode_attention(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """Blocked causal attention of B single-token queries, each over its own
    slab row masked by its own position (inactive rows pass pos 0); with
    ``paged``, row b's positions below matched[b] come from the page pool
    through its table. Only the first B slab rows are read. Requires
    S % chunk == 0 and chunk % page == 0. Returns [B, K, M, hd] f32."""
    return fused_paged_decode_attention(qg, keys, values, pos, chunk, paged)


def batched_verify_attention(qg, keys, values, pos, chunk: int, paged=None) -> torch.Tensor:
    """:func:`batched_decode_attention` for T-token verify windows
    (speculative decode): qg [B, T, K, M, hd]. Returns [B, T, K, M, hd] f32."""
    return fused_paged_verify_attention(qg, keys, values, pos, chunk, paged)
