"""Tensor parallelism: ``tp`` ranks in lockstep, all on one card.

The layout is the JAX package's (and the reference's slicing): q/k/v and
gate/up are output-sharded, wo and down input-sharded, each rank runs
``n_heads/tp`` attention heads over its ``n_kv_heads/tp`` cache heads, and
wcls is vocab-sharded when the vocab divides. The two all-reduces per layer
(after wo and after down) go through :mod:`ops.collectives`, whose ``ring``
arm is the hand-written K4 (and K5, the int8 matmul fused into it). A MoE
layer (Mixtral, Grok-1) replicates its router and gives every rank a hidden
slice of every expert; the routing is computed once per layer from the
byte-identical residual, each rank runs the chosen experts on its slice,
and the partial expert sums are all-reduced once (K4 under ``ring``: no
expert matmul is fused into the ring).

Where the JAX package maps one shard to one chip of a mesh, the port keeps
each rank as its own set of allocations (weight shards, KV cache,
activations) on the one card that ``device`` names; the replicated leaves
(embedding, norms, rope table) are one tensor that every rank reads. Ranks
on several cards in one process need peer access or events between
devices, which no machine this port runs on yet offers to test, so asking
for them raises. Worker mode (``hosts``, :mod:`parallel.hosts`) spreads
the ranks over processes instead, each holding a contiguous run of them on
its own card (or all on one card): ``forward``, ``init_cache`` and the
decode chunks run this process's ranks, and the per-layer sums, the MoE
expert sum and the logits' all-gather go through :mod:`ops.collectives`
with the group. Every process issues the same collectives in the same
order: the forward, and the transfer probe at the engine's cadence, which
is a function of the token stream every process shares. The batched half
is not ported over processes and refuses them.

The batched half serves :class:`engine.batch.BatchScheduler`: per-rank
slab halves [B, S, K/tp, hd] (:meth:`TensorParallelForward.init_batch_cache`)
and page-pool halves [P, page, K/tp, hd] (:meth:`~TensorParallelForward.init_page_pool`),
a row's prefill written back in place (``slab_forward[_paged]``), the
publish of a row's pages (each rank moves its own kv-head slice), and the
batched decode chunks, whose fingerprint folds the all-gathered logits.
Page tables and matched lengths are one tensor every rank reads. Every
issue goes through the backend's dispatch lock, so the slices of a pod
(:mod:`parallel.pod`), which share one backend, issue one at a time.
"""

from __future__ import annotations

import time

import torch

from distributed_llama_tpu_torch import lockcheck, prng, telemetry
from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.models import llama, sampling
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops import collectives
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.parallel import sharding
from distributed_llama_tpu_torch.platform import resolve_device
from distributed_llama_tpu_torch.quants import QK


def validate_tp(cfg: LlamaConfig, tp: int, quantized: bool = False) -> None:
    """The sharding-divisibility constraint: tp a power of two dividing the
    heads, kv heads and hidden dim (a MoE model's expert hidden dim too);
    for q40 the input-dim shards must land on quant-block boundaries (dim
    and hidden_dim divisible by tp*32)."""
    if tp < 1 or tp & (tp - 1):
        raise ValueError(f"tp must be a power of two, got {tp}")
    for name, value in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads), ("hidden_dim", cfg.hidden_dim)):
        if value % tp:
            raise ValueError(f"tp={tp} must divide {name}={value}")
    if quantized:
        for name, value in (("dim", cfg.dim), ("hidden_dim", cfg.hidden_dim)):
            if value % (tp * QK):
                raise ValueError(f"q40 tp={tp} needs {name}={value} divisible by {tp * QK}")


WORKER_BATCH_NOT_PORTED = ("the batched half over worker-mode processes is not ported "
                           "(ROADMAP.md Queue 1: serving in worker mode)")


def rank_devices(tp: int, device="cuda", devices=None, host_id: int | None = None) -> list[torch.device]:
    """The device of every rank: ``tp`` times ``device``, or ``devices``
    when they all name one device; ranks on several devices raise
    NotImplementedError. ``host_id``: worker mode's host, whose "cuda" is
    its own card (:func:`platform.resolve_device`)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len({str(d) for d in devices}) > 1:
            raise NotImplementedError(collectives.SEVERAL_CARDS)
        if len(devices) != tp:
            raise ValueError(f"{len(devices)} devices for tp={tp}")
        device = devices[0]
    return [resolve_device(device, host_id)] * tp


def check_allreduce(allreduce: str) -> None:
    if allreduce not in collectives.IMPLS:
        raise ValueError(f"unknown all-reduce {allreduce!r}; expected one of {collectives.IMPLS}")


def rank_params(params) -> list:
    """Per-tp-rank params: the list ``load_params(tp > 1)`` returns, or the
    one dict of ``tp`` = 1 as a list of one."""
    return params if isinstance(params, list) else [params]


class TransferProbeMixin:
    """What the parallel backends share: the dispatch lock every issue goes
    through, the single-stream decode over the backend's ``forward``, and
    the transfer share of the engine's stats, measured by replaying the
    backend's collective sequence (:meth:`transfer_probe`)."""

    # worker mode's process group (:class:`parallel.hosts.HostGroup`), where
    # the backend's ranks span processes
    hosts = None

    def decode_chunk(self, params, first_token, caches: list, pos: int, n_steps: int, temperature: float,
                     topp: float, topk: int, seed32: int, path: str = "int8"):
        """``n_steps`` forward -> sample steps, sampled on counter coins
        keyed (seed, position) from the logits every rank holds. Returns
        (tokens [n_steps] on the device, caches)."""
        return sampling.decode_chunk(self.cfg, rank_params(params), first_token, caches, pos, n_steps, temperature,
                                     topp, topk, seed32, path,
                                     forward=lambda t, c, p: self.forward(params, t, c, p, path))

    def decode_loop(self, params, first_token, caches: list, pos: int, n_steps: int, temperature: float,
                    topp: float, seed: int = 0, topk: int = 0, path: str = "int8"):
        """:meth:`decode_chunk` with the request seed folded here."""
        return self.decode_chunk(params, first_token, caches, pos, n_steps, temperature, topp, topk,
                                 prng.fold_seed(seed), path)

    def _init_probe(self) -> None:
        # serializes the issue of every call over this backend: the
        # schedulers of a pod's slices, or the independent streams of a
        # server without batch decode, share it (their launches and the
        # kernels' launch counts never interleave)
        self._dispatch_lock = lockcheck.make_lock("TransferProbeMixin._dispatch_lock")
        # bound once: the tp.transfer site fires inside the transfer probe
        self._faults = faults.active_plan()

    def _place_ranks(self, inner: int, hosts, device, devices, allreduce: str) -> None:
        """Worker mode's placement of a ``tp`` x ``inner`` backend (the
        sequence- and expert-parallel ones): :attr:`ranks`, this process's
        tp ranks (whose weights it reads), :attr:`inner_ranks`, its ranks
        of the inner axis, and each axis's group over the processes of that
        mesh axis, None where the axis stays in this process
        (:func:`parallel.hosts.axis_runs`, :meth:`parallel.hosts.HostGroup.axis_groups`,
        made by every process here); then the IPC staging on the card,
        made by every process here before any probe or forward: the inner
        axis's for its exchanges under every arm, and the tp axis's for K4
        across processes under ``ring``."""
        from distributed_llama_tpu_torch.ops import collectives

        self.hosts = hosts if collectives.spans_hosts(hosts) else None
        if self.hosts is None:
            self.ranks, self.inner_ranks = range(self.tp), range(inner)
            self.inner_group = self.tp_group = None
        else:
            self.ranks, self.inner_ranks = self.hosts.axis_runs(self.tp, inner)
            self.inner_group, self.tp_group = self.hosts.axis_groups(self.tp, inner)
        self.devices = rank_devices(len(self.ranks) * len(self.inner_ranks), device, devices,
                                    None if self.hosts is None else self.hosts.host_id)
        dev = self.devices[0]
        if dev.type == "cuda" and self.inner_group is not None:
            collectives.open_ipc_ring(self.inner_group, len(self.inner_ranks), dev, self.cfg.dim * 4)
        if dev.type == "cuda" and self.tp_group is not None and allreduce == "ring":
            collectives.open_ipc_ring(self.tp_group, len(self.ranks), dev, self.cfg.dim * 4)

    def _sync(self) -> None:
        if self.devices[0].type == "cuda":
            torch.cuda.synchronize(self.devices[0])

    def _collective_tel(self) -> telemetry.CollectiveInstruments:
        """The transfer probe's instruments, bound at the first probe (the
        JAX mixin's bind-once hook): null ones unless telemetry was enabled
        before it."""
        tel = getattr(self, "_collective_tel_bundle", None)
        if tel is None:
            tel = telemetry.CollectiveInstruments()
            self._collective_tel_bundle = tel
        return tel

    def _fire_transfer_fault(self) -> None:
        """The ``tp.transfer`` site. Across processes a host that left the
        probe alone would leave its peers' collectives unpaired, so every
        host learns whether any host's site fired, and all raise or none."""
        if self.hosts is None:
            self._faults.fire("tp.transfer")
            return
        fault = None
        try:
            self._faults.fire("tp.transfer")
        except Exception as e:
            fault = e
        fired = self.hosts.all_gather(torch.tensor([fault is not None], dtype=torch.int64))
        if fault is not None:
            raise fault
        hosts = [h for h, f in enumerate(fired) if f.item()]
        if hosts:
            raise RuntimeError(f"transfer probe: the tp.transfer fault fired on host(s) {hosts}; every host "
                               "leaves the probe")

    def measure_transfer_ms(self, n_tokens: int = 32) -> float:
        """Per-token collective time, replayed back to back between two
        synchronizes after one warm-up replay (an upper bound of what the
        forward spends in them). A failing probe raises; the ``tp.transfer``
        site fires first (a flaky interconnect). The timed replay is a
        ``transfer_probe`` span; with telemetry on each probe counts one
        run, observes the per-token seconds and adds the bytes it stands for
        (:meth:`transfer_bytes_per_token` x ``n_tokens``). In worker mode
        the hosts agree first: a fault on any host raises on every host
        before any of them issues the probe's collectives."""
        self._fire_transfer_fault()
        tel = self._collective_tel()
        fn, args = self.transfer_probe(n_tokens)
        with self._dispatch_lock:
            fn(*args)
            self._sync()
            with tel.span("transfer_probe", tokens=n_tokens):
                start = time.perf_counter()
                fn(*args)
                self._sync()
                per_token_ms = (time.perf_counter() - start) * 1e3 / n_tokens
        if tel.enabled:
            tel.probe_runs.inc()
            tel.allreduce_latency.observe(per_token_ms / 1000.0)
            tel.allreduce_bytes.inc(self.transfer_bytes_per_token() * n_tokens)
        return per_token_ms


class TensorParallelForward(TransferProbeMixin):
    """The tensor-parallel backend of :class:`engine.InferenceEngine`:
    forward, decode chunks, per-rank caches, the batched half and the
    transfer probe. Params and caches are per-rank lists
    (``engine.weights.load_params(tp=...)``, :meth:`init_cache`); in worker
    mode (``hosts``) they hold this process's ranks, :attr:`ranks`."""

    # the fewest rows a batched dispatch covers: 1, since no slab axis is
    # cut across devices here (the JAX pod raises it to its slab's rows
    # when it shards their batch axis over its data axis)
    decode_bucket_floor = 1

    def __init__(self, cfg: LlamaConfig, tp: int, device="cuda", quantized: bool = False,
                 allreduce: str = "psum", devices=None, hosts=None):
        validate_tp(cfg, tp, quantized=quantized)
        check_allreduce(allreduce)
        self.cfg = cfg
        self.tp = tp
        self.quantized = quantized
        self.allreduce = allreduce
        self.hosts = hosts if collectives.spans_hosts(hosts) else None
        # the global ranks this process runs: all of them, or its host's run
        self.ranks = range(tp) if self.hosts is None else self.hosts.local_ranks(tp)
        self.devices = rank_devices(len(self.ranks), device, devices,
                                    None if self.hosts is None else self.hosts.host_id)
        self.shard_vocab = cfg.vocab_size % tp == 0
        if self.hosts is not None and allreduce == "ring" and self.devices[0].type == "cuda":
            # K4 across processes: its buffers (a token row per slot to
            # start) and events, made by every process here, before any
            # probe or forward issues a collective
            collectives.open_ipc_ring(self.hosts, len(self.ranks), self.devices[0], cfg.dim * 4)
        self._init_probe()

    @property
    def mesh_shape(self) -> dict:
        """Ranks along each named axis (``dllama_mesh_devices``)."""
        return {"tp": self.tp}

    def forward(self, params: list, tokens: torch.Tensor, caches: list, pos: int, path: str = "int8",
                n_real: int | None = None, paged=None):
        """Logits f32 [T, vocab] (the all-gathered logits every rank holds)
        of T tokens from ``pos``; the per-rank caches are written in place.
        ``n_real``: the real rows of a bucket-padded prompt (the
        capacity-bucketed MoE prefill's pad mask); ``paged`` = (per-rank
        pools, table, matched)."""
        with self._dispatch_lock:
            return llama.forward_tokens_tp(self.cfg, params, tokens, caches, pos, path, self.allreduce,
                                           n_real=n_real, paged=paged, group=self.hosts)

    def init_cache(self, dtype=torch.bfloat16) -> list:
        """Per-rank, per-layer fused [2, S, K/tp, hd] cache leaves (int8
        with scales for "i8"), each rank's on its device."""
        cfg = self.cfg
        leaf = [2, cfg.seq_len, cfg.n_kv_heads, cfg.head_size]
        leaf[sharding.CACHE_KV_HEAD_AXIS] //= self.tp
        return [[kvc.init_fused(tuple(leaf[1:]), dtype, dev) for _ in range(cfg.n_layers)] for dev in self.devices]

    # ------------------------------------------------------------------
    # The batched half (engine.batch.BatchScheduler over the ranks)
    # ------------------------------------------------------------------

    def _refuse_hosts(self) -> None:
        if self.hosts is not None:
            raise NotImplementedError(WORKER_BATCH_NOT_PORTED)

    def init_batch_cache(self, b_max: int, dtype=torch.bfloat16) -> list:
        """Per-rank slabs: per-layer fused [2, b_max, S, K/tp, hd] leaves
        (int8 with [2, b_max, S, K/tp, 1] scales for "i8")."""
        self._refuse_hosts()
        cfg = self.cfg
        shape = (b_max, cfg.seq_len, cfg.n_kv_heads // self.tp, cfg.head_size)
        return [[kvc.init_fused(shape, dtype, dev) for _ in range(cfg.n_layers)] for dev in self.devices]

    def init_page_pool(self, n_pages: int, page: int, dtype=torch.bfloat16) -> list:
        """Per-rank page pools: per-layer ``(keys, values)`` halves of
        [n_pages, page, K/tp, hd] (int8 with scales for "i8")."""
        self._refuse_hosts()
        cfg = self.cfg
        kl = cfg.n_kv_heads // self.tp
        return [[tuple(kvc.init_page_pool_half(n_pages, page, kl, cfg.head_size, dtype, dev) for _ in range(2))
                 for _ in range(cfg.n_layers)] for dev in self.devices]

    def slab_forward(self, params: list, tokens: torch.Tensor, slab: list, row: int, pos: int, n_real: int,
                     path: str = "int8", paged=None):
        """Prefill ``tokens`` into slab row ``row`` of every rank (each
        rank's row of its slab is a view, written in place). ``paged`` =
        (per-rank pools, table, matched). Returns (logits f32 [T, vocab],
        slab)."""
        rows = [[kvc.slab_row(leaf, row) for leaf in rank] for rank in slab]
        logits, _ = self.forward(params, tokens, rows, pos, path, n_real=n_real, paged=paged)
        return logits, slab

    def slab_forward_paged(self, params: list, tokens: torch.Tensor, slab: list, pool: list, row: int, pos: int,
                           n_real: int, table, matched: int, path: str = "int8"):
        """:meth:`slab_forward` with the row's positions below ``matched``
        read from every rank's pool half through the shared ``table``."""
        return self.slab_forward(params, tokens, slab, row, pos, n_real, path, paged=(pool, table, matched))

    def publish_pages(self, slab: list, pool: list, page_ids, src_page, row: int) -> list:
        """Copy slab row ``row``'s page slots ``src_page`` into pool pages
        ``page_ids`` on every rank, in place (each rank moves its own
        kv-head slice). Returns the pool."""
        with self._dispatch_lock:
            for rank_slab, rank_pool in zip(slab, pool):
                for leaf, (pk, pv) in zip(rank_slab, rank_pool):
                    page = kvc.pool_page_size(pk)
                    kvc.publish_row_pages(pk, leaf[0], row, src_page, page_ids, page)
                    kvc.publish_row_pages(pv, leaf[1], row, src_page, page_ids, page)
        return pool

    def batched_decode_chunk(self, params: list, first_tokens, slab: list, pos, active, n_steps: int, temperature,
                             topp, topk, seeds, path: str = "int8", may_partition: bool = True, paged=None):
        """One chunk of the batched decode over the ranks: B rows step
        together with per-row positions, seeds and sampler settings
        (:func:`sampling.batched_decode_scan` over
        :func:`llama.forward_step_batched_tp`). Returns (the packed
        [n_steps + 2, B] tokens + fingerprint + finite rows, slab)."""

        def forward(tokens, caches, p):
            return llama.forward_step_batched_tp(self.cfg, params, tokens, caches, p, active, path, self.allreduce,
                                                 paged=paged)

        with self._dispatch_lock:
            tokens, slab, h, ok = sampling.batched_decode_scan(
                self.cfg, params, first_tokens, slab, pos, active, seeds, n_steps, temperature, topp, topk,
                may_partition=may_partition, forward=forward)
            return integrity.pack_chunk_outputs(tokens, h, ok), slab

    def batched_decode_chunk_paged(self, params: list, first_tokens, slab: list, pool: list, pos, active,
                                   n_steps: int, temperature, topp, topk, seeds, tables, matched,
                                   path: str = "int8", may_partition: bool = True):
        """:meth:`batched_decode_chunk` with row b's positions below
        ``matched[b]`` read from every rank's pool half through its page
        table (``tables`` [B, n_table] and ``matched`` [B] on the device)."""
        return self.batched_decode_chunk(params, first_tokens, slab, pos, active, n_steps, temperature, topp, topk,
                                         seeds, path, may_partition, paged=(pool, tables, matched))

    def transfer_probe(self, n_tokens: int = 32):
        """(fn, args) replaying one decode step's collective sequence per
        token, ``n_tokens`` times: two all-reduces of a [1, dim] f32
        activation per layer through the same seam and arm as the forward,
        and the vocab all-gather when wcls is sharded (across the processes
        in worker mode, so every process must probe at the same point)."""
        cfg, tp = self.cfg, self.tp
        xs = [torch.ones((1, cfg.dim), dtype=torch.float32, device=d) for d in self.devices]
        lgs = [torch.ones((1, cfg.vocab_size // tp), dtype=torch.float32, device=d) for d in self.devices]
        inv = 1.0 / tp  # keeps the replayed sums finite

        def fn(xs, lgs):
            for _ in range(n_tokens):
                for _ in range(2 * cfg.n_layers):
                    xs = [x * inv for x in collectives.all_reduce(xs, self.allreduce, self.hosts)]
                if self.shard_vocab:
                    collectives.all_gather(lgs, self.hosts)
            return xs

        return fn, (xs, lgs)

    def transfer_bytes_per_token(self) -> int:
        """Payload bytes of the probed sequence per token: two [1, dim] f32
        all-reduces per layer, plus the vocab all-gather when sharded."""
        n = 2 * self.cfg.n_layers * self.cfg.dim * 4
        if self.shard_vocab:
            n += self.cfg.vocab_size * 4
        return n
