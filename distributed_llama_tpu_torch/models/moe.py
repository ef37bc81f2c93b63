"""Mixture-of-experts FFN (Mixtral, Grok-1) on one device or over the
tensor-parallel ranks.

The port of the JAX package's ``models/moe.py`` without its expert-parallel
branch: router matmul -> softmax -> top-k -> renormalized weights ->
per-expert SwiGLU -> weighted sum of the expert outputs.

* The router runs in f32: its logits are one plain f32 matrix product
  (``_true_f32_matmul`` turns TF32 off for every call), the softmax the
  JAX formula. The k largest probabilities are taken with a stable
  descending sort, so on equal values the lower expert id comes first, as
  ``jax.lax.top_k`` returns them.
* One row (a decode step, or a batch of one) runs only the k selected
  experts, summed in top-k order from a zero f32 accumulator. The JAX
  package selects them on the device with ``lax.switch``; here the k ids
  are read to the host (one read per MoE layer per decoded token, counted
  in :data:`host_reads`) to pick which expert's weights the matmul reads.
* More rows run every expert and mix them by the mostly-zero [T, E] weight
  matrix, serially in bank order; with ``cfg.moe_capacity_factor`` > 0 and
  at least :data:`MOE_BUCKETED_MIN_T` rows, Q40 experts instead compute
  only their routed rows, gathered into fixed-capacity buckets.
* Expert weights are per-expert ``{"gate_up", "down"}`` Q40 leaves (the
  ``experts`` list, through the Q40 kernels) or stacked ``moe_gate`` /
  ``moe_up`` / ``moe_down`` banks [E, d_in, d_out] of f32 or bf16.

The top-k path sums experts in top-k order and the all-experts path in
bank order, so a prefill row and the same row decoded alone agree to
tolerance, not bit for bit (as in the JAX package).

One function serves one device and the tensor-parallel ranks:
:func:`moe_block_tp` takes per-rank lists, and one rank is lists of one
(its all-reduce is the identity). Under tensor parallelism every rank
holds a hidden slice of every expert and runs the same three paths on it;
the partial expert sums are all-reduced once per layer through
``ops.collectives``. Every rank's router input is the same all-reduced
residual, byte for byte, so the routing is computed once per layer, from
rank 0's, and serves every rank: the top-k path still reads its k ids to
the host once per layer.
"""

from __future__ import annotations

import math

import torch

from distributed_llama_tpu_torch.formats.model_file import ArchType
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.models.llama import _activation, _matmul, rmsnorm, softmax
from distributed_llama_tpu_torch.ops.q40 import _true_f32_matmul

# device -> host reads since the last reset_host_reads(): the top-k path
# reads the selected expert ids once per MoE layer per single-row forward
host_reads: dict[str, int] = {"expert_ids": 0}

# below this many rows the serial all-E path is used instead of the
# bucketed one: the capacity estimate is noisy at small T and the expert
# weight reads dominate anyway
MOE_BUCKETED_MIN_T = 32


def reset_host_reads() -> None:
    host_reads["expert_ids"] = 0


def router_probs(cfg: LlamaConfig, xn: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """[T, E] softmax router probabilities, in f32."""
    return softmax(_true_f32_matmul(xn.to(torch.float32), router.to(torch.float32)), dim=-1)


def router_topk(cfg: LlamaConfig, xn: torch.Tensor, router: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing: ([T, k] renormalized weights, [T, k] expert ids), the
    k largest probabilities in descending order, lower id first on ties."""
    probs = router_probs(cfg, xn, router)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_active_experts
    top_vals, top_idx = vals[:, :k], idx[:, :k]
    return top_vals / top_vals.sum(dim=-1, keepdim=True), top_idx


def router_weights(cfg: LlamaConfig, xn: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """[T, E] mixing weights: the top-k renormalized, zero elsewhere."""
    top_vals, top_idx = router_topk(cfg, xn, router)
    return torch.zeros((xn.shape[0], cfg.n_experts), dtype=torch.float32, device=xn.device).scatter_(
        1, top_idx, top_vals)


def _expert_weights(lp, e: int):
    """Weights of expert ``e``: fused ``gate_up`` + ``down`` Q40 leaves, or
    ``gate``/``up``/``down`` slices of the stacked banks."""
    if "experts" in lp:
        return lp["experts"][e]
    return {"gate": lp["moe_gate"][e], "up": lp["moe_up"][e], "down": lp["moe_down"][e]}


def _expert_ffn(cfg: LlamaConfig, xn: torch.Tensor, ew, path: str = "int8") -> torch.Tensor:
    """One expert's SwiGLU on normed input [T, D] -> [T, D] f32, before its
    routing weight."""
    if "gate_up" in ew:
        fused = _matmul(xn.to(ew["gate_up"].dtype), ew["gate_up"], path)
        hidden = fused.shape[-1] // 2
        h = _activation(fused[:, :hidden], cfg.hidden_act) * fused[:, hidden:]
    else:
        xc = xn.to(ew["gate"].dtype)
        h = _activation(_matmul(xc, ew["gate"], path), cfg.hidden_act) * _matmul(xc, ew["up"], path)
    return _matmul(h.to(ew["down"].dtype), ew["down"], path)


def _route_topk(cfg: LlamaConfig, xn: torch.Tensor, router: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """One row's routing: ([1, k] renormalized weights on the device, the k
    expert ids read to the host)."""
    top_vals, top_idx = router_topk(cfg, xn, router)  # [1, k]
    ids = top_idx[0].tolist()
    host_reads["expert_ids"] += 1
    return top_vals, ids


def _mix_topk(cfg: LlamaConfig, xn: torch.Tensor, lp, top_vals: torch.Tensor, ids: list[int],
              path: str = "int8") -> torch.Tensor:
    """The k chosen experts on one row, summed in top-k order."""
    out = torch.zeros(xn.shape, dtype=torch.float32, device=xn.device)
    for i, e in enumerate(ids):
        out = out + top_vals[0, i] * _expert_ffn(cfg, xn, _expert_weights(lp, e), path)
    return out


def bucket_capacity(factor: float, n_tokens: int, k: int, n_buckets: int) -> int:
    """Per-expert bucket rows. factor <= 0 = exact: n_tokens rows (a token
    routes to an expert at most once). factor > 0: ceil(factor*T*k/E)
    rounded up to a multiple of 4, at most n_tokens; overflow rows drop."""
    if factor <= 0:
        return n_tokens
    return min(n_tokens, max(4, -(-math.ceil(factor * n_tokens * k / n_buckets) // 4) * 4))


def bucket_rank(top_idx: torch.Tensor, n_buckets: int):
    """Rank every (token, choice) within its target expert. top_idx: [T, k]
    expert ids, where id ``n_buckets`` is the pad sink: it counts towards
    no expert, and its rank is read from the last expert's column (the
    JAX package's clamped gather). Returns (flat_e [T*k], rank [T*k],
    t_ids [T*k])."""
    T, k = top_idx.shape
    N = T * k
    flat_e = top_idx.reshape(N)
    onehot = (flat_e[:, None] == torch.arange(n_buckets, device=flat_e.device)).to(torch.int64)  # [N, E]
    before = torch.cumsum(onehot, dim=0) - onehot
    rank = before[torch.arange(N, device=flat_e.device), flat_e.clamp(max=n_buckets - 1)]
    t_ids = torch.arange(T, device=flat_e.device).repeat_interleave(k)
    return flat_e, rank, t_ids


def bucket_scatter(x: torch.Tensor, flat_e: torch.Tensor, rank: torch.Tensor, t_ids: torch.Tensor,
                   n_buckets: int, C: int) -> torch.Tensor:
    """Each expert's routed rows in fixed [n_buckets, C, D] buckets. Rows
    ranked past C land in a spill row C and sink rows (expert id
    ``n_buckets``) in a sink bucket; both are trimmed, so they land
    nowhere (the JAX package's ``mode="drop"``)."""
    D = x.shape[-1]
    slot = torch.where(rank < C, rank, C)
    buf = torch.zeros((n_buckets + 1, C + 1, D), dtype=x.dtype, device=x.device)
    buf[flat_e.clamp(max=n_buckets), slot] = x[t_ids]
    return buf[:n_buckets, :C]


def bucket_combine(outs: torch.Tensor, top_idx: torch.Tensor, rank: torch.Tensor, top_vals: torch.Tensor,
                   C: int) -> torch.Tensor:
    """Expert outputs [n_buckets, C, D] back in token order, weighted by
    the renormalized top-k weights; dropped choices contribute zero. Sink
    ids read the last expert (the JAX package's clamped gather). Returns
    [T, D] f32."""
    T, k = top_idx.shape
    rank = rank.reshape(T, k)
    valid = (rank < C).to(torch.float32)
    gathered = outs[top_idx.clamp(max=outs.shape[0] - 1), rank.clamp(max=C - 1)]  # [T, k, D]
    return ((top_vals * valid)[:, :, None] * gathered).sum(dim=1)


def _bucketed(cfg: LlamaConfig, xn: torch.Tensor, lp) -> bool:
    """Whether several rows take the capacity-bucketed path: Q40 experts, a
    capacity factor, and at least MOE_BUCKETED_MIN_T rows."""
    return "experts" in lp and cfg.moe_capacity_factor > 0 and xn.shape[0] >= MOE_BUCKETED_MIN_T


def _mix_dense(cfg: LlamaConfig, xn: torch.Tensor, lp, weights: torch.Tensor, path: str = "int8") -> torch.Tensor:
    """Every expert on every row, added in bank order, each weighted by its
    column of the [T, E] routing weights (an unselected expert adds exact
    zeros)."""
    out = torch.zeros(xn.shape, dtype=torch.float32, device=xn.device)
    for e in range(cfg.n_experts):
        out = out + weights[:, e : e + 1] * _expert_ffn(cfg, xn, _expert_weights(lp, e), path)
    return out


def _route_buckets(cfg: LlamaConfig, xn: torch.Tensor, router: torch.Tensor, n_real: int | None = None):
    """The bucketed path's routing: rank every (token, choice) within its
    expert and gather each expert's rows into a [C, D] bucket. Rows from
    ``n_real`` on are bucket padding: they route to the sink E, so capacity
    is spent on real tokens only. Returns (top_vals, top_idx, rank, C,
    buckets [E, C, D])."""
    T = xn.shape[0]
    E, k = cfg.n_experts, cfg.n_active_experts
    top_vals, top_idx = router_topk(cfg, xn, router)  # [T, k]
    if n_real is not None:
        valid = torch.arange(T, device=xn.device) < n_real
        top_idx = torch.where(valid[:, None], top_idx, torch.full_like(top_idx, E))
    C = bucket_capacity(cfg.moe_capacity_factor, T, k, E)
    flat_e, rank, t_ids = bucket_rank(top_idx, E)
    return top_vals, top_idx, rank, C, bucket_scatter(xn, flat_e, rank, t_ids, E, C)


def _mix_buckets(cfg: LlamaConfig, lp, route, path: str = "int8") -> torch.Tensor:
    """One FFN per expert over its bucket, combined back in token order with
    the renormalized weights."""
    top_vals, top_idx, rank, C, buckets = route
    outs = torch.stack([_expert_ffn(cfg, buckets[e], _expert_weights(lp, e), path)
                        for e in range(cfg.n_experts)])
    return bucket_combine(outs, top_idx, rank, top_vals, C)


def moe_ffn_tp(cfg: LlamaConfig, xns: list, lps: list, n_real: int | None = None, path: str = "int8",
               impl: str = "psum") -> list:
    """Expert-mixed SwiGLU of each rank's normed rows xns[r] [T, dim]: the
    routing once, from rank 0's rows (every rank's are the same bytes); one
    row takes the top-k path, more rows the all-experts one (or the
    bucketed one, see :func:`_bucketed`), each rank's experts on its hidden
    slice; then one all-reduce of the partial expert sums. Returns each
    rank's [T, dim] f32 sum."""
    from distributed_llama_tpu_torch.ops import collectives

    xn, router = xns[0], lps[0]["router"]
    if xn.shape[0] == 1:
        top_vals, ids = _route_topk(cfg, xn, router)
        outs = [_mix_topk(cfg, x, lp, top_vals, ids, path) for x, lp in zip(xns, lps)]
    elif _bucketed(cfg, xn, lps[0]):
        route = _route_buckets(cfg, xn, router, n_real)
        outs = [_mix_buckets(cfg, lp, route, path) for lp in lps]
    else:
        weights = router_weights(cfg, xn, router)
        outs = [_mix_dense(cfg, x, lp, weights, path) for x, lp in zip(xns, lps)]
    return collectives.all_reduce(outs, impl)


def moe_block_tp(cfg: LlamaConfig, xs: list, lps: list, n_real: int | None = None, path: str = "int8",
                 impl: str = "psum") -> list:
    """The FFN half of a MoE block on each rank, after the attention
    residual: Mixtral norms with ``rms_ffn`` before the experts; Grok-1
    with ``rms_moe``, and norms the all-reduced expert sum with
    ``rms_ffn2`` (outside the reduction) before the residual add."""
    if cfg.arch == ArchType.GROK1:
        xns = [rmsnorm(x, lp["rms_moe"]) for x, lp in zip(xs, lps)]
        outs = moe_ffn_tp(cfg, xns, lps, n_real=n_real, path=path, impl=impl)
        return [x + rmsnorm(o.to(x.dtype), lp["rms_ffn2"]) for x, o, lp in zip(xs, outs, lps)]
    xns = [rmsnorm(x, lp["rms_ffn"]) for x, lp in zip(xs, lps)]
    outs = moe_ffn_tp(cfg, xns, lps, n_real=n_real, path=path, impl=impl)
    return [x + o.to(x.dtype) for x, o in zip(xs, outs)]
