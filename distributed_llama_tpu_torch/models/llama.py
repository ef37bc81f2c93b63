"""Llama-family transformer forward over one stream (Llama, Mixtral, Grok-1).

The layer loop is unrolled over a list of per-layer parameter dicts; each
layer's KV cache leaf is written in place. Numerical conventions follow the
JAX package: rmsnorm eps 1e-5 added to the mean square, scores scaled by
1/sqrt(head_size), SwiGLU silu(w1 x) * (w3 x) then w2, all matmuls with f32
accumulation. Q40 weights route to the hand-written kernels through
:func:`ops.q40.q40_matmul` / :func:`ops.q40.rmsnorm_q40_matmul`: four
launches per layer (qkv, wo, gate_up, down) and one for ``wcls``. A MoE
layer's FFN is :func:`models.moe.moe_block_tp`: 2 + 2k launches per layer for
one row (the k selected experts), 2 + 2E for several. Grok-1 scales the
embedding and the logits and norms the attention output. Under
tensor parallelism (:func:`forward_tokens_tp`) the same functions run per
rank, with wo and down (a MoE layer: its partial expert sums) summed over
the ranks by ``ops.collectives``.

Positions are host ints throughout, so no step reads back from the device
to decide a shape or a chunk bound.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.formats.model_file import ArchType, HiddenAct
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.models.rope import apply_rope
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.ops.q40 import (
    QuantizedMatrix,
    _true_f32_matmul,
    q40_matmul,
    rmsnorm_q40_matmul,
    rmsnorm_ref,
)
from distributed_llama_tpu_torch.platform import to_device

Params = dict[str, Any]

# key-axis chunk of the blocked attention: caches whose seq_len is a
# multiple of it use the online-softmax path; smaller/odd caches keep the
# full-S masked softmax. T > 8 keeps the full-S path below
# ATT_BLOCK_PREFILL_S (the JAX package's branch rule, kept so both packages
# take the same branch).
ATT_CHUNK = 512
ATT_BLOCK_PREFILL_S = 4096


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_ref(x, weight, eps)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """exp(x - max) / sum, with a true division (the JAX formula)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _activation(x: torch.Tensor, act: HiddenAct) -> torch.Tensor:
    if act == HiddenAct.GELU:
        return torch.nn.functional.gelu(x, approximate="tanh")
    return x * torch.sigmoid(x)


def _matmul(x: torch.Tensor, w, path: str = "int8") -> torch.Tensor:
    """x [T, n] @ w [n, d] with f32 accumulation. ``w`` is a plain tensor
    (bf16/f32; bf16 products are exact in f32) or a Q40 QuantizedMatrix."""
    if isinstance(w, QuantizedMatrix):
        return q40_matmul(x, w, path)
    return _true_f32_matmul(x.to(torch.float32), w.to(torch.float32))


def _norm_matmul(x: torch.Tensor, weight: torch.Tensor, w, path: str = "int8") -> torch.Tensor:
    """rmsnorm(x, weight) @ w."""
    if isinstance(w, QuantizedMatrix):
        return rmsnorm_q40_matmul(x, weight, w, path=path)
    return _matmul(rmsnorm(x, weight).to(w.dtype), w, path)


def project_qkv(cfg: LlamaConfig, lp: Params, x: torch.Tensor, rope_rows: torch.Tensor, path: str = "int8"):
    """Norm + QKV projection + rope: [T, dim] -> (q [T, H, hd], k [T, K, hd],
    v [T, K, hd])."""
    T = x.shape[0]
    hd = cfg.head_size
    if "qkv" in lp:
        fused = _norm_matmul(x, lp["rms_att"], lp["qkv"], path)
        d_q = lp["wo"].shape[-2]
        d_kv = (fused.shape[-1] - d_q) // 2
        q, k, v = fused[:, :d_q], fused[:, d_q : d_q + d_kv], fused[:, d_q + d_kv :]
    else:
        xc = rmsnorm(x, lp["rms_att"]).to(lp["q"].dtype)
        q, k, v = (_matmul(xc, lp[n], path) for n in ("q", "k", "v"))
    H, K = q.shape[-1] // hd, k.shape[-1] // hd
    q = apply_rope(q.reshape(T, H, hd), rope_rows, cfg)
    k = apply_rope(k.reshape(T, K, hd), rope_rows, cfg)
    return q, k, v.reshape(T, K, hd)


def embed(cfg: LlamaConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows in f32 (Grok-1 scales them by 78.38367176906169)."""
    x = params["embedding"][tokens].to(torch.float32)
    if cfg.arch == ArchType.GROK1:
        x = x * 78.38367176906169
    return x


def attention(cfg: LlamaConfig, x: torch.Tensor, lp: Params, cache_l: torch.Tensor, pos: int,
              rope_rows: torch.Tensor, path: str = "int8", paged=None, per_position: bool = False):
    """Causal GQA attention for T tokens at positions pos..pos+T-1 over the
    fused [2, S, K, hd] leaf (written in place). Returns (mix [T, H*hd],
    cache_l). ``paged`` = (pool_k, pool_v, table, matched: int): positions
    below ``matched`` are read from the page pool through ``table`` (the
    blocked scan's per-position select, or a virtual row for the full-S
    branch), the same bytes a row holding copies of the pages would give.
    ``per_position`` attends each query row on its own, exactly as a T=1
    decode step at that position does (a speculative verify window)."""
    T = x.shape[0]
    q, k, v = project_qkv(cfg, lp, x, rope_rows, path)
    H, K = q.shape[1], k.shape[1]
    cache_l = kvc.fused_update_rows(cache_l, k, v, pos)
    keys, values = cache_l[0], cache_l[1]
    qg = q.reshape(T, K, H // K, cfg.head_size).to(kvc.compute_dtype(keys))
    if per_position and T > 1:
        # the einsums' summation order may depend on their row count (T*M
        # query rows here, M in a decode step), so one row at a time is the
        # only shape that computes what decode computes
        rows = [_attend(qg[t : t + 1], keys, values, pos + t, paged) for t in range(T)]
        return torch.cat(rows), cache_l
    return _attend(qg, keys, values, pos, paged), cache_l


def _attend(qg: torch.Tensor, keys, values, pos: int, paged) -> torch.Tensor:
    """Grouped queries qg [T, K, M, hd] (cache compute dtype) at positions
    pos..pos+T-1 against the cache halves [S, K, hd]: mix [T, K*M*hd] f32."""
    T, hd = qg.shape[0], qg.shape[-1]
    S = keys.shape[0]
    cdt = kvc.compute_dtype(keys)
    use_blocked = S % ATT_CHUNK == 0 and S > ATT_CHUNK and (T <= 8 or S >= ATT_BLOCK_PREFILL_S)
    if paged is not None and not (use_blocked and ATT_CHUNK % kvc.pool_page_size(paged[0]) == 0):
        pool_k, pool_v, table, matched = paged
        keys = kvc.virtual_row(keys, pool_k, table, matched)
        values = kvc.virtual_row(values, pool_v, table, matched)
        paged = None
    if use_blocked:
        from distributed_llama_tpu_torch.ops.attention import blocked_attention

        att = blocked_attention(qg.to(torch.float32), keys, values, pos, ATT_CHUNK, paged=paged)
        return att.to(torch.float32).reshape(T, -1)
    scores = kvc.scores_einsum(qg, keys) / math.sqrt(hd)
    t_idx = pos + torch.arange(T, device=qg.device)[:, None]
    s_idx = torch.arange(S, device=qg.device)[None, :]
    scores = torch.where((s_idx <= t_idx)[:, None, None, :], scores, float("-inf"))
    return kvc.mix_einsum(softmax(scores, dim=-1), values, cdt).reshape(T, -1)


def ffn_hidden(cfg: LlamaConfig, x: torch.Tensor, lp: Params, path: str = "int8") -> torch.Tensor:
    """The SwiGLU FFN up to the down projection's input h."""
    if "gate_up" in lp:
        fused = _norm_matmul(x, lp["rms_ffn"], lp["gate_up"], path)
        hidden = fused.shape[-1] // 2
        return _activation(fused[:, :hidden], cfg.hidden_act) * fused[:, hidden:]
    xn = rmsnorm(x, lp["rms_ffn"]).to(lp["gate"].dtype)
    return _activation(_matmul(xn, lp["gate"], path), cfg.hidden_act) * _matmul(xn, lp["up"], path)


def block_tail(cfg: LlamaConfig, x: torch.Tensor, att: torch.Tensor, lp: Params, path: str = "int8",
               n_real: int | None = None) -> torch.Tensor:
    """wo projection, residual, then the FFN or MoE half with its residual:
    :func:`block_tail_tp` on one rank. ``n_real``: the real rows of a
    bucket-padded prefill, which only the capacity-bucketed MoE path
    reads."""
    return block_tail_tp(cfg, [x], [att], [lp], path, n_real=n_real)[0]


def block_forward(cfg, x, lp, cache_l, pos: int, rope_rows, path: str = "int8", paged=None,
                  per_position: bool = False, n_real: int | None = None):
    att, cache_l = attention(cfg, x, lp, cache_l, pos, rope_rows, path, paged=paged, per_position=per_position)
    return block_tail(cfg, x, att, lp, path, n_real=n_real), cache_l


def final_logits(cfg: LlamaConfig, params: Params, x: torch.Tensor, path: str = "int8") -> torch.Tensor:
    """Final rmsnorm + logits head (Grok-1 scales the logits by
    0.5773502691896257)."""
    logits = _norm_matmul(x, params["rms_final"], params["wcls"], path)
    if cfg.arch == ArchType.GROK1:
        logits = logits * 0.5773502691896257
    return logits


def forward_tokens(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, cache: list, pos: int,
                   path: str = "int8", paged=None, per_position: bool = False, n_real: int | None = None):
    """Run T tokens (int [T] on the params' device) from absolute position
    ``pos``. ``cache`` is the per-layer list of fused leaves (or slab-row
    views), updated in place. ``paged`` = (pool, table, matched): this
    row's positions below ``matched`` live in the per-layer ``(keys,
    values)`` pool halves, read through ``table``. ``per_position``: the
    attention of every query row is that of a T=1 step (see
    :func:`attention`). ``n_real``: the real (non-pad) token count of a
    bucket-padded prompt, for the capacity-bucketed MoE prefill; None = all
    rows real. Returns (logits f32 [T, vocab], cache)."""
    T = tokens.shape[0]
    x = embed(cfg, params, tokens)
    rope_rows = params["rope_table"][pos : pos + T]
    for l, lp in enumerate(params["layers"]):
        paged_l = None
        if paged is not None:
            pool, table, matched = paged
            paged_l = (pool[l][0], pool[l][1], table, matched)
        x, cache[l] = block_forward(cfg, x, lp, cache[l], pos, rope_rows, path, paged=paged_l,
                                    per_position=per_position, n_real=n_real)
    return final_logits(cfg, params, x, path), cache


# ---------------------------------------------------------------------------
# Tensor parallelism: ``params`` and ``caches`` are per-rank lists (each rank
# holds its output shards of qkv/gate_up, its input shards of wo/down, its
# kv heads of the cache and, when the vocab divides, its vocab shard of
# wcls). The ranks step in lockstep through each layer; the two all-reduces
# per layer (after wo and after down) go through the ops.collectives seam
# and leave every rank's residual stream byte-identical.
# ---------------------------------------------------------------------------


def block_tail_tp(cfg: LlamaConfig, xs: list, atts: list, lps: list, path: str = "int8",
                  impl: str = "psum", n_real: int | None = None) -> list:
    """wo + all-reduce, the residual per rank (Grok-1 norms the sum with
    ``rms_ffn`` first), then the FFN up to h per rank, down + all-reduce,
    the residual per rank; or a MoE layer's experts
    (:func:`models.moe.moe_block_tp`), whose partial sums are all-reduced.
    One rank (lists of one) is :func:`block_tail`: its all-reduces are the
    identity."""
    from distributed_llama_tpu_torch.ops import collectives

    outs = collectives.matmul_all_reduce([a.to(lp["wo"].dtype) for a, lp in zip(atts, lps)],
                                         [lp["wo"] for lp in lps], impl, path)
    if cfg.arch == ArchType.GROK1:
        xs = [x + rmsnorm(o.to(x.dtype), lp["rms_ffn"]) for x, o, lp in zip(xs, outs, lps)]
    else:
        xs = [x + o.to(x.dtype) for x, o in zip(xs, outs)]
    if cfg.is_moe:
        from distributed_llama_tpu_torch.models import moe

        return moe.moe_block_tp(cfg, xs, lps, n_real=n_real, path=path, impl=impl)
    hs = [ffn_hidden(cfg, x, lp, path).to(lp["down"].dtype) for x, lp in zip(xs, lps)]
    outs = collectives.matmul_all_reduce(hs, [lp["down"] for lp in lps], impl, path)
    return [x + o.to(x.dtype) for x, o in zip(xs, outs)]


def forward_hidden_tp(cfg: LlamaConfig, params: list, tokens: torch.Tensor, caches: list, pos: int,
                      path: str = "int8", impl: str = "psum", n_real: int | None = None) -> tuple[list, list]:
    """The layer loop under tensor parallelism: T tokens from ``pos``
    through every layer, attention per rank on its own heads and cache.
    ``n_real`` as in :func:`forward_tokens`. Returns (each rank's final
    residual stream [T, dim], caches)."""
    T = tokens.shape[0]
    xs = [embed(cfg, p, tokens.to(p["embedding"].device)) for p in params]
    ropes = [p["rope_table"][pos : pos + T] for p in params]
    for l in range(cfg.n_layers):
        lps = [p["layers"][l] for p in params]
        atts = []
        for r, lp in enumerate(lps):
            att, caches[r][l] = attention(cfg, xs[r], lp, caches[r][l], pos, ropes[r], path)
            atts.append(att)
        xs = block_tail_tp(cfg, xs, atts, lps, path, impl, n_real=n_real)
    return xs, caches


def forward_tokens_tp(cfg: LlamaConfig, params: list, tokens: torch.Tensor, caches: list, pos: int,
                      path: str = "int8", impl: str = "psum", n_real: int | None = None):
    """:func:`forward_tokens` over per-rank params and caches. Final logits
    per rank; a vocab-sharded wcls gives each rank a slice, and the
    all-gather is a ``torch.cat`` in rank order onto rank 0's device.
    Returns (logits f32 [T, vocab], caches)."""
    xs, caches = forward_hidden_tp(cfg, params, tokens, caches, pos, path, impl, n_real=n_real)
    logits = [final_logits(cfg, p, x, path) for p, x in zip(params, xs)]
    if logits[0].shape[-1] == cfg.vocab_size:  # wcls replicated: every rank holds the full logits
        return logits[0], caches
    dev = logits[0].device
    return torch.cat([lg.to(dev) for lg in logits], dim=-1), caches


def attention_batched(cfg: LlamaConfig, x: torch.Tensor, lp: Params, cache_l: torch.Tensor,
                      pos: torch.Tensor, rope_rows: torch.Tensor, write, path: str = "int8",
                      paged=None):
    """One decode step of B independent rows over the slab leaf
    [2, B_max, S, K, hd]: ``write`` = (rows, slots) places each writing
    row's K/V (:func:`ops.kv_cache.write_index`; inactive rows write
    nothing), and row b attends over its own slab row masked by ``pos[b]``
    (inactive rows pass 0). ``paged`` = (pool_k, pool_v, tables [B, n_table],
    matched [B]). Returns (mix [B, H*hd], cache_l)."""
    B = x.shape[0]
    S = cache_l.shape[2]
    hd = cfg.head_size
    q, k, v = project_qkv(cfg, lp, x, rope_rows, path)
    H, K = q.shape[1], k.shape[1]
    kvc.fused_update_row_batched(cache_l, k, v, write)
    keys, values = cache_l[0], cache_l[1]
    cdt = kvc.compute_dtype(keys)
    qg = q.reshape(B, K, H // K, hd).to(cdt)
    if S % ATT_CHUNK == 0 and S > ATT_CHUNK:
        from distributed_llama_tpu_torch.ops.attention import batched_decode_attention

        if paged is None or ATT_CHUNK % kvc.pool_page_size(paged[0]) == 0:
            att = batched_decode_attention(qg.to(torch.float32), keys, values, pos, ATT_CHUNK, paged=paged)
        else:
            keys_b, values_b = (_virtual_rows(h, paged, i, B) for i, h in enumerate((keys, values)))
            att = batched_decode_attention(qg.to(torch.float32), keys_b.contiguous(), values_b.contiguous(),
                                           pos, ATT_CHUNK)
        return att.reshape(B, H * hd), cache_l
    telemetry.note_kernel_path("paged_attention", "einsum")
    keys_r, values_r, pos_r = _einsum_rows(keys, values, pos, paged)
    return _attend_rows_einsum(qg, keys_r, values_r, pos_r, cdt).reshape(B, H * hd), cache_l


def _virtual_rows(half, paged, which: int, rows: int):
    """Rows [0, rows) of a slab half with each row's positions below
    matched[b] taken from the pool (``which`` 0 = keys, 1 = values)."""
    pool, tables, matched = paged[which], paged[2], paged[3]
    return kvc.virtual_rows_batched(half[:rows], pool, tables[:rows], matched[:rows])


def _einsum_rows(keys, values, pos: torch.Tensor, paged):
    """The einsum branch's operands over EVERY slab row: (keys, values,
    read positions), the B stepping rows first and the slab's other rows
    after them at position 0 (and matched 0), so that the einsums and the
    softmax's row reductions always run at the slab's row count."""
    rows = keys.shape[0]
    pad = rows - pos.shape[0]
    pos = torch.nn.functional.pad(pos, (0, pad))
    if paged is None:
        return keys, values, pos
    tables = torch.nn.functional.pad(paged[2], (0, 0, 0, pad))
    matched = torch.nn.functional.pad(paged[3], (0, pad))
    full = (paged[0], paged[1], tables, matched)
    return _virtual_rows(keys, full, 0, rows), _virtual_rows(values, full, 1, rows), pos


def _attend_rows_einsum(qg: torch.Tensor, keys, values, pos: torch.Tensor, cdt) -> torch.Tensor:
    """Full-S masked softmax attention of B single queries qg [B, K, M, hd]
    (row b at pos[b], over its own row of ``keys``/``values``, which hold
    R >= B rows, the first B of them these rows'), computed at R rows
    whatever B is: the einsums' and reductions' summation order may depend
    on the row count, and at one shape a decode step at any row count and
    each position of a verify window give a row the same bits. Returns
    [B, K, M, hd] f32."""
    B, hd = qg.shape[0], qg.shape[-1]
    R, S = pos.shape[0], keys.shape[1]
    qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, R - B))
    scores = kvc.scores_einsum_batched(qg, keys) / math.sqrt(hd)
    mask = torch.arange(S, device=qg.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None, None, :], scores, float("-inf"))
    return kvc.mix_einsum_batched(softmax(scores, dim=-1), values, cdt)[:B]


def forward_step_batched(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, cache: list, pos,
                         active, path: str = "int8", paged=None):
    """One batched decode step: B tokens (one per row, int [B] on the
    device) at the host positions ``pos`` through the whole model, each
    weight matrix read once for all rows. ``active`` (host bools) masks
    rows that write no K/V and read from position 0. ``paged`` = (pool,
    tables, matched) with device tables/matched. Returns (logits f32
    [B, vocab], cache)."""
    S = cfg.seq_len
    dev = tokens.device
    pos, active = [int(p) for p in pos], [bool(a) for a in active]
    idx = to_device([[p if a else 0 for p, a in zip(pos, active)], [min(max(p, 0), S - 1) for p in pos]],
                    dev, torch.int64)
    read_pos, rope_rows = idx[0], params["rope_table"][idx[1]]
    write = kvc.write_index([p if a else S for p, a in zip(pos, active)], S, dev)
    x = embed(cfg, params, tokens)
    for l, lp in enumerate(params["layers"]):
        paged_l = None
        if paged is not None:
            pool, tables, matched = paged
            paged_l = (pool[l][0], pool[l][1], tables, matched)
        att, cache[l] = attention_batched(cfg, x, lp, cache[l], read_pos, rope_rows, write, path, paged=paged_l)
        x = block_tail(cfg, x, att, lp, path)
    return final_logits(cfg, params, x, path), cache


def attention_verify_batched(cfg: LlamaConfig, x: torch.Tensor, lp: Params, cache_l, pos: torch.Tensor,
                             rope_rows: torch.Tensor, write, path: str = "int8", paged=None):
    """One speculative-verify attention step of B independent T-token
    windows (x [B, T, dim]): row b's query t sits at ``pos[b] + t`` (device
    read positions, inactive rows 0), its K/V land per ``write``
    (:func:`ops.kv_cache.verify_write_index`: inactive rows and slots at or
    beyond S write nothing) in one indexed copy per layer, and it attends
    its own slab row causally. Returns (mix [B, T, H*hd], cache_l)."""
    B, T = x.shape[0], x.shape[1]
    S = cache_l.shape[2]
    hd = cfg.head_size
    # projections and rope are per token: one matmul per matrix for all B*T
    q, k, v = project_qkv(cfg, lp, x.reshape(B * T, -1), rope_rows.reshape((B * T,) + rope_rows.shape[2:]), path)
    H, K = q.shape[1], k.shape[1]
    k, v = k.reshape(B, T, K, hd), v.reshape(B, T, K, hd)
    kvc.fused_update_verify_batched(cache_l, k, v, write)
    keys, values = cache_l[0], cache_l[1]
    cdt = kvc.compute_dtype(keys)
    qg = q.reshape(B, T, K, H // K, hd).to(cdt)
    if S % ATT_CHUNK == 0 and S > ATT_CHUNK:
        from distributed_llama_tpu_torch.ops.attention import batched_verify_attention

        if paged is None or ATT_CHUNK % kvc.pool_page_size(paged[0]) == 0:
            att = batched_verify_attention(qg.to(torch.float32), keys, values, pos, ATT_CHUNK, paged=paged)
        else:
            keys_b, values_b = (_virtual_rows(h, paged, i, B) for i, h in enumerate((keys, values)))
            att = batched_verify_attention(qg.to(torch.float32), keys_b.contiguous(), values_b.contiguous(),
                                           pos, ATT_CHUNK)
        return att.reshape(B, T, H * hd), cache_l
    # window position t is scored and mixed as one decode step at pos + t
    # (the shape attention_batched uses), never as T*M-row einsums, so a
    # verify row computes what a decode step computes
    telemetry.note_kernel_path("paged_attention", "einsum")
    keys_r, values_r, pos_r = _einsum_rows(keys, values, pos, paged)
    att = torch.stack([_attend_rows_einsum(qg[:, t], keys_r, values_r, pos_r + t, cdt) for t in range(T)], dim=1)
    return att.reshape(B, T, H * hd), cache_l


def forward_verify_batched(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, cache: list, pos, active,
                           path: str = "int8", paged=None):
    """The speculative-decode verify forward: every row's T-token window
    (tokens int [B, T] on the device: the previous token and up to T-1
    drafts) at host positions ``pos`` in one weight read. ``logits[b, t]``
    is the next-token distribution after ``tokens[b, :t+1]``; the T == 1
    case is :func:`forward_step_batched`. ``active`` (host bools) masks rows
    that write no K/V and read from position 0. Returns (logits f32
    [B, T, vocab], cache)."""
    S = cfg.seq_len
    B, T = tokens.shape
    dev = tokens.device
    pos, active = [int(p) for p in pos], [bool(a) for a in active]
    read_pos = to_device([p if a else 0 for p, a in zip(pos, active)], dev, torch.int64)
    rope_rows = params["rope_table"][to_device([[min(max(p + t, 0), S - 1) for t in range(T)] for p in pos],
                                               dev, torch.int64)]
    write = kvc.verify_write_index(pos, active, T, S, dev)
    x = embed(cfg, params, tokens.reshape(-1)).reshape(B, T, -1)
    for l, lp in enumerate(params["layers"]):
        paged_l = None
        if paged is not None:
            pool, tables, matched = paged
            paged_l = (pool[l][0], pool[l][1], tables, matched)
        att, cache[l] = attention_verify_batched(cfg, x, lp, cache[l], read_pos, rope_rows, write, path,
                                                 paged=paged_l)
        x = block_tail(cfg, x.reshape(B * T, -1), att.reshape(B * T, -1), lp, path).reshape(B, T, -1)
    logits = final_logits(cfg, params, x.reshape(B * T, -1), path)
    return logits.reshape(B, T, -1), cache


def init_batch_cache(cfg: LlamaConfig, b_max: int, dtype, device) -> list:
    """Slab KV cache for ``b_max`` rows: per-layer fused [2, b_max, S, K, hd]
    leaves (``"i8"``: int8 data and [2, b_max, S, K, 1] f32 scales);
    ``leaf[0]``/``leaf[1]`` are the (keys, values) halves."""
    shape = (b_max, cfg.seq_len, cfg.n_kv_heads, cfg.head_size)
    return [kvc.init_fused(shape, dtype, device) for _ in range(cfg.n_layers)]


def init_page_pool(cfg: LlamaConfig, n_pages: int, page: int, dtype, device) -> list:
    """Prefix-cache page pool: per-layer ``(keys, values)`` halves of
    [n_pages, page, K, hd] (int8 with scales for ``"i8"``). Its memory is
    n_pages x :func:`page_pool_bytes`."""
    return [
        tuple(kvc.init_page_pool_half(n_pages, page, cfg.n_kv_heads, cfg.head_size, dtype, device)
              for _ in range(2))
        for _ in range(cfg.n_layers)
    ]


def page_pool_bytes(cfg: LlamaConfig, page: int, dtype) -> int:
    """KV bytes one pool page holds across all layers and both halves
    (int8 data plus f32 scales for ``"i8"``)."""
    kl, hd = cfg.n_kv_heads, cfg.head_size
    if kvc.is_quantized_cache_dtype(dtype):
        per_half = page * kl * hd + page * kl * 4
    else:
        per_half = page * kl * hd * torch.empty(0, dtype=dtype).element_size()
    return 2 * cfg.n_layers * per_half


def init_cache(cfg: LlamaConfig, dtype, device) -> list:
    """Per-layer fused [2, S, K, hd] cache leaves (the JAX package's
    ``layered=True`` layout, the only one ported; ``"i8"`` builds int8
    leaves with per-(slot, head) scales)."""
    shape = (cfg.seq_len, cfg.n_kv_heads, cfg.head_size)
    return [kvc.init_fused(shape, dtype, device) for _ in range(cfg.n_layers)]
