"""Expert parallelism: ``ep`` ranks that each own ``n_experts/ep`` WHOLE
experts, all on one card (``--ep``; with ``--tp`` on a ``tp x ep`` layout).

The port of the JAX package's ``parallel/expert_parallel.py``. Two compute
paths, chosen per forward by its row count (:func:`ep_moe_ffn`):

* **Dispatch** (T % ep == 0, T > 1: every prefill, whose rows the engine
  pads to a power of two): home rank i takes rows [i*T/ep, (i+1)*T/ep),
  ranks every (token, choice) within its target expert and scatters the
  rows into fixed [E, Ce, D] capacity buckets (the bucket algebra of
  :mod:`models.moe`); the two ``all_to_all`` exchanges are index moves
  between the ranks' bucket tensors (owner j takes every home's rows for
  its experts, then every home takes its rows' outputs back), each owner
  runs one FFN per local expert over its [ep*Ce, D] rows, and the
  ``all_gather`` of the homes' combined rows is a concatenation in rank
  order. ``Ce`` follows ``cfg.moe_capacity_factor`` (0: drop-free, exact)
  behind the per-home ``MOE_BUCKETED_MIN_T`` guard.
* **Dense-local** (decode, and row counts the ranks do not divide): every
  rank runs its local experts on all rows, weighted by its columns of the
  [T, E] routing weights, and the ranks' partial sums are all-reduced
  through :func:`ops.collectives.all_reduce` under the engine's
  ``--allreduce`` arm (K4 under ``ring``). A decoded token therefore reads
  every expert's weights, E/k times the expert bytes of the top-k path:
  the JAX package's design for ranks that run in parallel on their own
  chips.

Where the JAX package maps a rank to a chip, the port computes once what
every ep rank computes identically: the attention, the dense weights and
the routing (one routing serves every tp rank too: their rows are the same
bytes). Only the experts' FFNs run per (tp rank, ep rank). Each rank's
experts are its slice of the per-expert Q40 leaves ``engine/weights.py``
loads (a list, no stacked copy that a kernel would slice), or views of the
stacked f32/bf16 banks; under ``tp`` > 1 each is that tp rank's hidden
slice. The KV cache is the tp backend's: one per tp rank, shared by the ep
ranks (the JAX package replicates it over ep).

Worker mode (``hosts``, :mod:`parallel.hosts`) spreads the ``tp x ep``
ranks over processes in the JAX mesh's order: a process holds every ep
rank of a run of tp ranks (the expert exchanges stay in the process, the
tp sums go through the group), or a run of one tp rank's ep ranks, whose
experts alone it reads (the expert exchanges and the combine run over that
tp rank's processes, and at tp > 1 the tp sums over the processes holding
the same ep run: each axis its own group,
:meth:`parallel.hosts.HostGroup.axis_groups`). Then every process computes the attention, the
dense weights and the routing itself (the same bytes on every process);
a dispatch forward routes only its home ranks' rows, and the two
``all_to_all`` exchanges and the ``all_gather`` cross the processes
through :mod:`ops.collectives` (:func:`~ops.collectives.all_to_all`,
:func:`~ops.collectives.rank_gather`: over the IPC staging, card to card,
on the GPU); the dense-local combine is the all-reduce seam over the
group (K4 across the processes under ``ring``).
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_llama_tpu_torch.models import llama, moe
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops import collectives
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.parallel import sharding
from distributed_llama_tpu_torch.parallel.tensor_parallel import (
    TransferProbeMixin,
    check_allreduce,
    rank_params,
    validate_tp,
)
from distributed_llama_tpu_torch.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class EpRanks:
    """The ep ranks a process runs: ``ranks``, a run of the ``n`` global
    ones (all of them in one process), whose experts are the process's
    expert list in order; ``group`` carries the expert exchanges and the
    dense-local combine where the run is part of the axis (over the
    processes of this process's tp rank)."""

    n: int
    ranks: range
    group: object = None


def validate_ep(cfg: LlamaConfig, ep: int) -> None:
    """The JAX package's refusals: a dense model, and an ``ep`` that does
    not divide the expert count."""
    if not cfg.is_moe:
        raise ValueError("--ep requires a mixture-of-experts model")
    if cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")


def _n_local_experts(cfg: LlamaConfig, ep: int) -> int:
    return cfg.n_experts // ep


def local_expert_weights(lp, rank: int, e: int, n_local: int):
    """Weights of local expert ``e`` of ep rank ``rank`` in layer params
    ``lp``: global expert ``rank * n_local + e``, its per-expert Q40 leaves
    or views of the stacked banks (never a copy)."""
    return moe._expert_weights(lp, rank * n_local + e)


def rank_expert_leaves(lp, ep: int) -> list:
    """Each ep rank's experts of layer params ``lp``: a list per rank of its
    local experts' weights, in local order. The counterpart of the JAX
    package's ``stack_expert_leaves``, which stacks the per-expert Q40
    leaves on a leading axis that a PartitionSpec shards over ``ep``: here
    a rank's experts stay the list entries the loader made, so no kernel
    operand is sliced out of a stacked copy."""
    n_local = len(lp["experts"]) // ep if "experts" in lp else lp["moe_gate"].shape[0] // ep
    return [[local_expert_weights(lp, j, e, n_local) for e in range(n_local)] for j in range(ep)]


def ep_param_rules(quantized: bool, shard_vocab: bool) -> tuple[sharding.RuleTable, sharding.RuleTable]:
    """The counterpart of the JAX package's ``ep_param_specs``: the rule
    tables of the EP layout, (the tp cut of every leaf: the TP MoE table,
    attention and dense weights replicated over ep; the ep cut: whole
    experts, :func:`sharding.ep_rules`)."""
    layout = "q40" if quantized else "layered"
    return sharding.param_rules(layout, shard_vocab, moe=True), sharding.ep_rules(layout)


def ep_moe_ffn(cfg: LlamaConfig, xns: list, lps: list, ep, path: str = "int8", impl: str = "psum") -> list:
    """Expert-parallel MoE FFN of each tp rank's normed rows xns[t] [T, D]
    (the same bytes on every tp rank) over ``ep`` ranks of whole experts
    (an int, or worker mode's :class:`EpRanks`: this process's run of them,
    whose experts ``lps`` hold). Returns each tp rank's [T, D] f32,
    complete over the expert partition (every ep exchange happens here);
    under tp > 1 still a hidden-slice partial, which the caller all-reduces
    over the tp ranks."""
    lay = ep if isinstance(ep, EpRanks) else EpRanks(ep, range(ep))
    T = xns[0].shape[0]
    if T % lay.n == 0 and T >= lay.n and T > 1:
        return _ep_dispatch(cfg, xns, lps, lay, path)
    return _ep_dense_local(cfg, xns, lps, lay, path, impl)


def _ep_dense_local(cfg: LlamaConfig, xns: list, lps: list, lay: EpRanks, path: str, impl: str) -> list:
    """Decode and tiny batches: every ep rank runs its local experts on all
    rows, weighted by its slice of the [T, E] router weights (computed
    once, by every process), and one all-reduce over the ep ranks combines
    them (over ``lay.group``'s processes in worker mode)."""
    El = _n_local_experts(cfg, lay.n)
    weights = moe.router_weights(cfg, xns[0], lps[0]["router"])  # [T, E]
    outs = []
    for xn, lp in zip(xns, lps):
        parts = []
        for jl, j in enumerate(lay.ranks):
            out = torch.zeros(xn.shape, dtype=torch.float32, device=xn.device)
            for e in range(El):
                g = j * El + e
                out = out + weights[:, g : g + 1] * moe._expert_ffn(cfg, xn, local_expert_weights(lp, jl, e, El),
                                                                     path)
            parts.append(out)
        outs.append(collectives.all_reduce(parts, impl, lay.group)[0])
    return outs


def _ep_dispatch(cfg: LlamaConfig, xns: list, lps: list, lay: EpRanks, path: str) -> list:
    """Prefill: sort-compacted capacity buckets per home rank, the two
    all_to_all exchanges (:func:`ops.collectives.all_to_all`), one FFN per
    owner's local expert over its [ep*Ce, D] rows, the combine on the home
    rank and the all_gather of the homes' rows in rank order
    (:func:`ops.collectives.rank_gather`). The routing and the send buckets
    of this process's home ranks are built once and serve every tp rank."""
    T, D = xns[0].shape
    ep = lay.n
    E, k = cfg.n_experts, cfg.n_active_experts
    El = _n_local_experts(cfg, ep)
    Tl = T // ep
    # the dense path guards lossy capacity bucketing behind
    # MOE_BUCKETED_MIN_T; so does each home rank: below it the buckets are
    # the drop-free worst case (Ce = Tl, exact)
    factor = cfg.moe_capacity_factor if Tl >= moe.MOE_BUCKETED_MIN_T else 0.0
    Ce = moe.bucket_capacity(factor, Tl, k, E)
    routes, sends = [], []
    for i in lay.ranks:
        x_local = xns[0][i * Tl : (i + 1) * Tl]
        top_vals, top_idx = moe.router_topk(cfg, x_local, lps[0]["router"])
        flat_e, rank, t_ids = moe.bucket_rank(top_idx, E)
        routes.append((top_vals, top_idx, rank))
        # [E, Ce, D] viewed as [ep owners, El, Ce, D]
        sends.append(moe.bucket_scatter(x_local, flat_e, rank, t_ids, E, Ce).reshape(ep, El, Ce, D))
    # all_to_all #1: owner j receives recv_j[s] = what home s sent for j's experts
    recvs = [torch.stack(r) for r in collectives.all_to_all(sends, ep, lay.group)]  # [ep, El, Ce, D]
    outs = []
    for lp in lps:
        banks = [torch.stack([moe._expert_ffn(cfg, recv[:, e].reshape(ep * Ce, D),
                                              local_expert_weights(lp, jl, e, El), path)
                              for e in range(El)]).reshape(El, ep, Ce, D)
                 for jl, recv in enumerate(recvs)]
        # all_to_all #2: home i receives owner j's outputs for its rows, in
        # global expert order (owner, local) = j*El + e
        backs = collectives.all_to_all([b.transpose(0, 1) for b in banks], ep, lay.group)
        combined = [moe.bucket_combine(torch.stack(back).reshape(E, Ce, D), top_idx, rank, top_vals, Ce)
                    for back, (top_vals, top_idx, rank) in zip(backs, routes)]
        outs.append(torch.cat(collectives.rank_gather(combined, lay.group)))  # the all_gather, in rank order
    return outs


class ExpertParallelMoE:
    """One expert-parallel MoE FFN layer over ``ep`` ranks on ``device``:
    the harness around :func:`ep_moe_ffn` that the JAX package's tests and
    micro-benchmark use (the engine path is :class:`ExpertParallelForward`)."""

    def __init__(self, cfg: LlamaConfig, ep: int, device="cuda", allreduce: str = "psum"):
        if cfg.n_experts % ep:
            raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")
        check_allreduce(allreduce)
        self.cfg = cfg
        self.ep = ep
        self.device = resolve_device(device)
        self.allreduce = allreduce

    def __call__(self, xn, router, gate, up, down, path: str = "int8") -> torch.Tensor:
        """xn [T, D]; banks [E, D, H] / [E, H, D]. Returns [T, D] f32."""
        def dev(a):
            return torch.as_tensor(a).to(self.device)

        lp = {"router": dev(router), "moe_gate": dev(gate), "moe_up": dev(up), "moe_down": dev(down)}
        return ep_moe_ffn(self.cfg, [dev(xn)], [lp], self.ep, path=path, impl=self.allreduce)[0]


class ExpertParallelForward(TransferProbeMixin):
    """The expert-parallel backend of :class:`engine.InferenceEngine`:
    ``tp`` ranks of attention and dense weights (the tensor-parallel
    layout, replicated over ep) and ``tp x ep`` ranks of experts, all on
    the card ``device`` names. Params and caches are the tp backend's
    (``engine.weights.load_params(tp=..., ep=...)``, :meth:`init_cache`);
    a single-stream backend, like the JAX package's: no batched decode.
    In worker mode (``hosts``) they hold this process's tp ranks
    :attr:`ranks`, each with the experts of its ep ranks :attr:`ep_ranks`
    (:attr:`local_experts`)."""

    def __init__(self, cfg: LlamaConfig, ep: int, tp: int = 1, device="cuda", quantized: bool = False,
                 allreduce: str = "psum", devices=None, hosts=None):
        validate_ep(cfg, ep)
        if tp > 1:
            validate_tp(cfg, tp, quantized=quantized)
        check_allreduce(allreduce)
        self.cfg = cfg
        self.ep = ep
        self.tp = tp
        self.allreduce = allreduce
        self._place_ranks(ep, hosts, device, devices, allreduce)
        self.ep_ranks = self.inner_ranks
        self.lay = EpRanks(ep, self.ep_ranks, self.inner_group)
        self._init_probe()

    @property
    def local_experts(self) -> range:
        """The experts this process's ep ranks own, in order (all of them
        in one process)."""
        El = _n_local_experts(self.cfg, self.ep)
        return range(self.ep_ranks.start * El, self.ep_ranks.stop * El)

    @property
    def mesh_shape(self) -> dict:
        """Ranks along each named axis (``dllama_mesh_devices``)."""
        return {"tp": self.tp, "ep": self.ep}

    def forward(self, params, tokens: torch.Tensor, caches: list, pos: int, path: str = "int8",
                n_real: int | None = None):
        """Logits f32 [T, vocab] of T tokens from ``pos``; the per-tp-rank
        caches are written in place. ``n_real`` is not read: the JAX
        package's expert-parallel forward takes no pad count."""
        with self._dispatch_lock:
            return llama.forward_tokens_tp(self.cfg, rank_params(params), tokens, caches, pos, path,
                                           self.allreduce, ep=self.lay, group=self.tp_group)

    def init_cache(self, dtype=torch.bfloat16) -> list:
        """Per-tp-rank, per-layer fused [2, S, K/tp, hd] leaves (int8 with
        scales for "i8"): one per tp rank, read by every ep rank."""
        cfg = self.cfg
        leaf = [2, cfg.seq_len, cfg.n_kv_heads, cfg.head_size]
        leaf[sharding.CACHE_KV_HEAD_AXIS] //= self.tp
        return [[kvc.init_fused(tuple(leaf[1:]), dtype, self.devices[0]) for _ in range(cfg.n_layers)]
                for _ in self.ranks]

    def transfer_probe(self, n_tokens: int = 32):
        """(fn, args) replaying one decode step's collective sequence per
        token, ``n_tokens`` times: per layer one all-reduce over the ep
        ranks of a [1, dim] f32 expert-partition partial (on every tp
        rank), plus the two tp all-reduces when tp > 1, each through the
        forward's seam and arm (across the processes where an axis spans
        them)."""
        cfg, dev = self.cfg, self.devices[0]
        xs = [[torch.ones((1, cfg.dim), dtype=torch.float32, device=dev) for _ in self.ep_ranks]
              for _ in self.ranks]
        zs = [torch.ones((1, cfg.dim), dtype=torch.float32, device=dev) for _ in self.ranks]

        def fn(xs, zs):
            for _ in range(n_tokens):
                for _ in range(cfg.n_layers):
                    xs = [[x * (1.0 / self.ep) for x in collectives.all_reduce(row, self.allreduce, self.lay.group)]
                          for row in xs]
                    if self.tp > 1:
                        for _ in range(2):
                            zs = [z * (1.0 / self.tp)
                                  for z in collectives.all_reduce(zs, self.allreduce, self.tp_group)]
            return xs, zs

        return fn, (xs, zs)

    def transfer_bytes_per_token(self) -> int:
        """The probed sequence per token: one [1, dim] f32 ep all-reduce per
        layer, plus the two [1, dim] tp all-reduces when tp > 1."""
        per_layer = self.cfg.dim * 4
        if self.tp > 1:
            per_layer += 2 * self.cfg.dim * 4
        return self.cfg.n_layers * per_layer
