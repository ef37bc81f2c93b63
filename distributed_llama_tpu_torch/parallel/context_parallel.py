"""Sequence parallelism: ``sp`` ranks that each hold a slice of the KV
cache's sequence, all on one card (``--sp``; with ``--tp`` on a ``tp x sp``
layout). Rank i owns cache slots [i*S/sp, (i+1)*S/sp).

The port of the JAX package's ``parallel/context_parallel.py``:

* :func:`ring_attention`: causal blockwise attention of a prompt cut into
  sp position chunks. The ring's ``ppermute`` is a rotation of the
  per-rank list: at step s rank i merges chunk (i - s) % sp into its
  online-softmax partials, in the JAX package's order.
* :func:`sp_sharded_attention`: T query rows against the sequence-cut
  cache. Each rank computes (max, exp-sum, weighted sum) partials over its
  slice (blocked with a dynamic bound when the slice is a multiple of
  :data:`SP_ATT_CHUNK`), and the JAX package's ``pmax`` and two ``psum``\\ s
  become a max and two sums over the ranks in rank order (plain ops under
  every ``--allreduce`` arm: ``pmax`` has no kernel counterpart and the
  partials are [T, K, M(, hd)] per layer). T = 1 is the decode step
  (:func:`sp_decode_attention`), T > 1 the chunked prefill.

:class:`SequenceParallelForward` routes a forward as the JAX backend does:
one token takes the decode step; a prompt at position 0 that fills at least
1/RING_PREFILL_FRACTION of the context takes one ring pass over the prompt
padded to seq_len (rank i runs positions [i*S/sp, (i+1)*S/sp) through the
whole network: its token chunk is its cache slice); anything else runs in
ceil(T/32) fixed-width chunks against the live cache.

Where the JAX package maps a rank to a chip and weights are replicated, the
port keeps one weights tree per tp rank (the tensor-parallel layout), read
by every sp rank, and computes once per tp rank what every sp rank
computes identically: a chunk's and a decode step's embedding,
projections, FFN and logits. Only the ring pass's token chunks, each
rank's cache slice and its attention partials are per rank.

Worker mode (``hosts``, :mod:`parallel.hosts`) spreads the ``tp x sp``
ranks over processes in the JAX mesh's order: a process holds every sp
rank of a run of tp ranks (the sp exchanges stay in the process, the tp
sums and the logits' gather go through the group), or a run of one tp
rank's sp ranks (the sp exchanges run over that tp rank's processes, and
at tp > 1 the tp sums and the logits' gather over the processes holding
the same sp run: each axis its own group, :meth:`parallel.hosts.HostGroup.axis_groups`).
Then each process computes the per-tp-rank parts of its tp ranks itself
(every process computes the same bytes from the same inputs), writes
only its own cache slices, and the sp exchanges cross the processes
through :mod:`ops.collectives`: the ring's rotation of K/V chunks
(:func:`~ops.collectives.ring_rotate`, card to card), the gather of the
ranks' partials before the max and two sums (:func:`~ops.collectives.rank_gather`:
every process merges every rank's partials in rank order, so all hold the
one-process bytes), and the gather of the ring pass's logits rows.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from distributed_llama_tpu_torch.models import llama
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops import collectives
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.ops.attention import blocked_partials, chunk_attention, merge_partials
from distributed_llama_tpu_torch.parallel import sharding
from distributed_llama_tpu_torch.parallel.tensor_parallel import (
    TransferProbeMixin,
    check_allreduce,
    rank_params,
    validate_tp,
)
from distributed_llama_tpu_torch.platform import to_device

# key-axis chunk of the blocked local-slice scan: slices that are a multiple
# of it (and longer) read only the chunks up to the live position, so a
# decode step's cost follows the live context, not the allocated S/sp slice
SP_ATT_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class SpRanks:
    """The sp ranks a process runs: ``ranks``, a run of the ``n`` global
    ones (all of them in one process); ``group`` carries the sp exchanges
    where the run is part of the axis, ``tp_group`` the tp collectives
    where this process holds part of the tp axis, each over its own mesh
    axis's processes (:meth:`parallel.hosts.HostGroup.axis_groups`)."""

    n: int
    ranks: range
    group: object = None
    tp_group: object = None


def ring_attention(qs: list, ks: list, vs: list, offsets: list | None = None, ranks: range | None = None,
                   group=None) -> list:
    """Causal blockwise attention with the sequence cut over the ranks:
    rank i's queries ``qs[i]`` [Tq, H, hd] sit at positions
    ``offsets[i]`` + 0..Tq-1 (default i*Tq), its key and value chunk
    ``ks[i]``/``vs[i]`` [Tk, K, hd] (cache dtype) at i*Tk + 0..Tk-1. At
    step s rank i holds chunk (i - s) % n: after every step each rank's
    held chunk moves one rank on, the JAX ring's ``ppermute``
    (:func:`ops.collectives.ring_rotate`: a rotation of the list in one
    process; with ``group`` spanning processes, ``qs``/``ks``/``vs`` are
    the ``ranks`` run this process holds, and a (K, V) pair crosses to the
    next process card to card). A chunk wholly in a rank's future is the
    empty partial, which merges as an exact identity. Returns each of the
    entries' ranks' output [Tq, H, hd] f32."""
    spans = collectives.spans_hosts(group)
    ranks = range(len(qs)) if ranks is None else ranks
    n = len(qs) * (group.num_hosts if spans else 1)
    # contiguous chunks in both forms: a received chunk is a contiguous
    # copy, and the attention must see one layout wherever a chunk came from
    held = [torch.stack((k, v)) if spans else (k.contiguous(), v.contiguous()) for k, v in zip(ks, vs)]
    state = []
    for j, (i, q) in enumerate(zip(ranks, qs)):
        Tq, H, hd = q.shape
        K = ks[0].shape[1]
        dev = q.device
        qg = q.reshape(Tq, K, H // K, hd).to(torch.float32)
        base = i * Tq if offsets is None else offsets[j]
        m = torch.full((Tq, K, H // K), float("-inf"), dtype=torch.float32, device=dev)
        state.append([qg, base + torch.arange(Tq, device=dev), m, torch.zeros_like(m),
                      torch.zeros((Tq, K, H // K, hd), dtype=torch.float32, device=dev)])
    for s in range(n):
        for i, st, (kc, vc) in zip(ranks, state, held):
            src = (i - s) % n
            Tk = kc.shape[0]
            k_pos = src * Tk + torch.arange(Tk, device=kc.device)
            st[2:] = merge_partials(*st[2:], *chunk_attention(st[0], kc, vc, st[1], k_pos))
        if s < n - 1:
            held = collectives.ring_rotate(held, group)
    return [(o / torch.clamp_min(l, 1e-30)[..., None]).reshape(qg.shape[0], -1, qg.shape[-1])
            for qg, _, _, l, o in state]


def _slice_partials(qg: torch.Tensor, keys, values, pos: int, base: int):
    """One rank's online-softmax partials of the query rows qg [T, K, M, hd]
    at positions pos..pos+T-1 over its cache slice (slot 0 at absolute
    ``base``): blocked with the dynamic bound when the slice is a multiple
    of SP_ATT_CHUNK, one masked pass otherwise."""
    Sl = keys.shape[0]
    T = qg.shape[0]
    if Sl % SP_ATT_CHUNK == 0 and Sl > SP_ATT_CHUNK:
        m, l, o = blocked_partials(qg, keys, values, pos, base, SP_ATT_CHUNK)
        # the cross-rank max needs a finite max everywhere (a rank with no
        # live slot reports -inf); the merge is invariant to the reference
        # max, so clamp as chunk_attention's safe max does (the JAX order)
        return torch.where(torch.isfinite(m), m, 0.0), l, o
    dev = qg.device
    return chunk_attention(qg, keys, values, pos + torch.arange(T, device=dev), base + torch.arange(Sl, device=dev))


def _gather_partials(parts: list, group) -> list:
    """Every sp rank's (max, exp-sum, output) partials in rank order from
    this process's ranks' ``parts``: each rank's three packed as bytes into
    one tensor, :func:`ops.collectives.rank_gather`, unpacked. The
    partials are [T, K, M(, hd)] per layer: small, one exchange each."""
    if not collectives.spans_hosts(group):
        return parts
    metas = [(t.dtype, t.shape, t.numel() * t.element_size()) for t in parts[0]]
    packed = [torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in part]) for part in parts]
    out = []
    for buf in collectives.rank_gather(packed, group):
        part, at = [], 0
        for dtype, shape, nbytes in metas:
            part.append(buf[at : at + nbytes].view(dtype).reshape(shape))
            at += nbytes
        out.append(tuple(part))
    return out


def sp_sharded_attention(q: torch.Tensor, k_slices: list, v_slices: list, pos: int, ranks: range | None = None,
                         group=None) -> torch.Tensor:
    """Attention of the query rows q [Tq, H, hd] at positions pos..pos+Tq-1
    over a sequence-cut cache: rank i's slice ``k_slices[i]``/``v_slices[i]``
    [Sl, K, hd] holds slots i*Sl..(i+1)*Sl-1 (with ``group`` spanning
    processes the slices are this process's ``ranks``). Each rank's
    partials, every rank's gathered in rank order, then the JAX package's
    pmax and two psums as a max and two sums over the ranks in rank order.
    Returns [Tq, H, hd] f32."""
    Sl, K, hd = k_slices[0].shape
    Tq, H = q.shape[0], q.shape[1]
    ranks = range(len(k_slices)) if ranks is None else ranks
    qg = q.reshape(Tq, K, H // K, hd).to(torch.float32)
    parts = _gather_partials([_slice_partials(qg, k, v, pos, i * Sl) for i, k, v in zip(ranks, k_slices, v_slices)],
                             group)
    g_m = parts[0][0]
    for m, _, _ in parts[1:]:
        g_m = torch.maximum(g_m, m)
    g_l = g_o = None
    for m, l, o in parts:
        scale = torch.exp(m - g_m)
        g_l = l * scale if g_l is None else g_l + l * scale
        g_o = o * scale[..., None] if g_o is None else g_o + o * scale[..., None]
    return (g_o / torch.clamp_min(g_l, 1e-30)[..., None]).reshape(Tq, H, hd)


def sp_decode_attention(q: torch.Tensor, k_slices: list, v_slices: list, pos: int, ranks: range | None = None,
                        group=None) -> torch.Tensor:
    """One-token attention over a sequence-cut cache: the Tq = 1 case of
    :func:`sp_sharded_attention`, q [H, hd] at ``pos``. Returns [H, hd]."""
    return sp_sharded_attention(q[None], k_slices, v_slices, pos, ranks, group)[0]


class SequenceParallelForward(TransferProbeMixin):
    """The sequence-parallel backend of :class:`engine.InferenceEngine`:
    ``tp x sp`` ranks on the card ``device`` names. Params are the tp
    backend's (one tree per tp rank, read by every sp rank); caches are
    ``caches[t][i][l]``, tp rank t's sp slice i of layer l, a fused
    [2, S/sp, K/tp, hd] leaf (:meth:`init_cache`). A single-stream backend,
    like the JAX package's: no batched decode. In worker mode (``hosts``)
    params and caches hold this process's ranks only: tp ranks
    :attr:`ranks` and sp ranks :attr:`sp_ranks`."""

    # a prompt at position 0 whose length times this reaches seq_len takes
    # the ring pass; shorter prompts and every prompt past position 0 take
    # the chunked path
    RING_PREFILL_FRACTION = 4

    def __init__(self, cfg: LlamaConfig, sp: int, tp: int = 1, device="cuda", quantized: bool = False,
                 allreduce: str = "psum", devices=None, hosts=None):
        if cfg.seq_len % sp:
            raise ValueError(f"sp={sp} must divide seq_len={cfg.seq_len}")
        if tp > 1:
            validate_tp(cfg, tp, quantized=quantized)
        check_allreduce(allreduce)
        self.cfg = cfg
        self.sp = sp
        self.tp = tp
        self.allreduce = allreduce
        self._place_ranks(sp, hosts, device, devices, allreduce)
        self.sp_ranks = self.inner_ranks
        self.lay = SpRanks(sp, self.sp_ranks, self.inner_group, self.tp_group)
        # the engine must not bucket-pad prompts for this backend: it pads
        # the ring pass to seq_len and cuts the rest into fixed-width chunks
        self.prefers_exact_mid_prefill = True
        # the chunked path's width: one chunk forward takes up to this many
        # tokens (a shorter tail is padded to it)
        self.mid_prefill_chunk = 32
        # forwards issued by the latest forward() ON THIS THREAD: the engine
        # pays the transfer share once per dispatch. Thread-local: a server
        # without batch decode runs its lanes' streams on their request
        # threads, and one lane's chunk count must not reach another's stats
        self._dispatch_local = threading.local()
        self._init_probe()

    @property
    def mesh_shape(self) -> dict:
        """Ranks along each named axis (``dllama_mesh_devices``)."""
        return {"tp": self.tp, "sp": self.sp}

    @property
    def last_forward_dispatches(self) -> int:
        """Forwards issued by the calling thread's latest :meth:`forward`
        (1 for a thread that never called it)."""
        return getattr(self._dispatch_local, "n", 1)

    def init_cache(self, dtype=torch.bfloat16) -> list:
        """``caches[t][i][l]``: tp rank t's sequence slice i of layer l, a
        fused [2, S/sp, K/tp, hd] leaf (int8 with [2, S/sp, K/tp, 1] scales
        for "i8")."""
        cfg = self.cfg
        leaf = [2, cfg.seq_len, cfg.n_kv_heads, cfg.head_size]
        leaf[sharding.CACHE_SEQ_AXIS] //= self.sp
        leaf[sharding.CACHE_KV_HEAD_AXIS] //= self.tp
        dev = self.devices[0]
        return [[[kvc.init_fused(tuple(leaf[1:]), dtype, dev) for _ in range(cfg.n_layers)] for _ in self.sp_ranks]
                for _ in self.ranks]

    def forward(self, params, tokens: torch.Tensor, caches: list, pos: int, path: str = "int8",
                n_real: int | None = None):
        """Logits f32 of T tokens from ``pos`` ([seq_len, vocab] after a ring
        pass, whose rows past T are pad rows; [T, vocab] otherwise); the
        cache slices are written in place. T == 1 is the decode step; T at
        position 0 with T * RING_PREFILL_FRACTION >= seq_len one ring pass
        over the prompt padded to seq_len; every other T runs
        ceil(T / mid_prefill_chunk) chunk forwards, each padded to the
        chunk width (pad rows write cache slots past pos + T, which the
        engine's rollback contract keeps unreachable). ``n_real`` is not
        read (the JAX backend takes none)."""
        cfg, ranks = self.cfg, rank_params(params)
        T = tokens.shape[0]
        self._dispatch_local.n = 1
        with self._dispatch_lock:
            if T == 1:
                return _sp_decode_step(cfg, ranks, tokens, caches, pos, path, self.allreduce, self.lay), caches
            S = cfg.seq_len
            if pos != 0 or T * self.RING_PREFILL_FRACTION < S:
                CH = self.mid_prefill_chunk
                rows = []
                p = pos
                for i in range(0, T, CH):
                    chunk = tokens[i : i + CH]
                    c = chunk.shape[0]
                    if c < CH:
                        chunk = torch.nn.functional.pad(chunk, (0, CH - c))
                    rows.append(_sp_chunk_forward(cfg, ranks, chunk, caches, p, path, self.allreduce, self.lay)[:c])
                    p += c
                self._dispatch_local.n = -(-T // CH)
                return torch.cat(rows), caches
            if T != S:
                tokens = torch.nn.functional.pad(tokens, (0, S - T))
            return _sp_prefill(cfg, ranks, tokens, caches, path, self.allreduce, self.lay), caches

    def transfer_probe(self, n_tokens: int = 32):
        """(fn, args) replaying one decode step's merge sequence per token,
        ``n_tokens`` times: per layer and tp rank, the max and two sums over
        the sp ranks of the [1, K/tp, M] max and exp-sum partials and the
        [1, K/tp, M, hd] output partial (gathered across the processes
        first where the sp ranks span them, as the forward gathers them),
        plus the two [1, dim] tp all-reduces through the forward's seam and
        arm when tp > 1."""
        cfg, dev = self.cfg, self.devices[0]
        K = cfg.n_kv_heads // self.tp
        M = max(1, (cfg.n_heads // self.tp) // max(K, 1))
        n_sp = len(self.sp_ranks)

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=dev)

        ms = [[ones(1, K, M) for _ in range(n_sp)] for _ in self.ranks]
        os_ = [[ones(1, K, M, cfg.head_size) for _ in range(n_sp)] for _ in self.ranks]
        zs = [ones(1, cfg.dim) for _ in self.ranks]

        def fn(ms, os_, zs):
            for _ in range(n_tokens):
                for _ in range(cfg.n_layers):
                    for t in range(len(ms)):
                        parts = _gather_partials([(m, m * 0.5, o) for m, o in zip(ms[t], os_[t])], self.lay.group)
                        g_m, g_l, g_o = parts[0]
                        for m, l, o in parts[1:]:
                            g_m, g_l, g_o = torch.maximum(g_m, m), g_l + l, g_o + o
                        ms[t] = [g_m + g_l * 1e-9] * n_sp
                        os_[t] = [g_o * (1.0 / self.sp)] * n_sp
                    if self.tp > 1:
                        for _ in range(2):
                            zs = [z * (1.0 / self.tp)
                                  for z in collectives.all_reduce(zs, self.allreduce, self.tp_group)]
            return ms, os_, zs

        return fn, (ms, os_, zs)

    def transfer_bytes_per_token(self) -> int:
        """The probed sequence per token: per layer the [1, K, M] max and
        exp-sum partials and the [1, K, M, hd] output partial (f32, K and M
        per tp rank), plus the two [1, dim] tp all-reduces when tp > 1."""
        cfg = self.cfg
        K = cfg.n_kv_heads // self.tp
        M = max(1, (cfg.n_heads // self.tp) // max(K, 1))
        per_layer = (2 * K * M + K * M * cfg.head_size) * 4
        if self.tp > 1:
            per_layer += 2 * cfg.dim * 4
        return cfg.n_layers * per_layer


def _sp_prefill(cfg: LlamaConfig, ranks: list, tokens: torch.Tensor, caches: list, path: str, impl: str,
                lay: SpRanks):
    """The ring pass over ``tokens`` [seq_len]: sp rank i runs positions
    [i*Sl, (i+1)*Sl) through every layer (its chunk is its whole cache
    slice: stored in the cache's dtype, quantized for int8, while the ring
    attends the cache-dtype rows, or the unquantized rows of an int8
    cache), the tp ranks' projections and FFN per sp rank as under tensor
    parallelism. ``lay``: the sp ranks this process runs and the groups.
    Returns the logits of every position [seq_len, vocab], the sp ranks'
    rows gathered in rank order."""
    Sl = tokens.shape[0] // lay.n
    xs = [[llama.embed(cfg, p, tokens[i * Sl : (i + 1) * Sl]) for p in ranks] for i in lay.ranks]
    ropes = [p["rope_table"][: lay.n * Sl] for p in ranks]
    for l in range(cfg.n_layers):
        lps = [p["layers"][l] for p in ranks]
        atts = [[None] * len(ranks) for _ in lay.ranks]
        for t, lp in enumerate(lps):
            qs, ks, vs = [], [], []
            for j, i in enumerate(lay.ranks):
                q, k, v = llama.project_qkv(cfg, lp, xs[j][t], ropes[t][i * Sl : (i + 1) * Sl], path)
                leaf = caches[t][j][l]
                if not isinstance(leaf, kvc.QuantizedKV):
                    k, v = k.to(leaf.dtype), v.to(leaf.dtype)
                kvc.fused_update_rows(leaf, k, v, 0)
                qs.append(q.to(torch.float32))
                ks.append(k)
                vs.append(v)
            for j, att in enumerate(ring_attention(qs, ks, vs, ranks=lay.ranks, group=lay.group)):
                atts[j][t] = att.reshape(Sl, -1)
        xs = [llama.block_tail_tp(cfg, x, att, lps, path, impl, group=lay.tp_group) for x, att in zip(xs, atts)]
    logits = [llama.gather_logits_tp(cfg, ranks, x, path, lay.tp_group) for x in xs]
    return torch.cat(collectives.rank_gather(logits, lay.group))


def _sp_rows_forward(cfg: LlamaConfig, ranks: list, tokens: torch.Tensor, caches: list, pos: int, path: str,
                     impl: str, lay: SpRanks, write):
    """C tokens at positions pos..pos+C-1 against the live sequence-cut
    cache: the embedding, projections, FFN and logits once per tp rank;
    per sp rank of this process ``write(leaf, i, k, v)`` stores the rows
    it owns into its slice, then the attention merges every rank's
    partials. The rope rows are gathered at clip(position, 0, S-1): a
    padded chunk near the context limit keeps every real row's own rope
    row, where a slice would shift them. Returns logits [C, vocab]."""
    C = tokens.shape[0]
    S = cfg.seq_len
    dev = tokens.device
    rope_idx = to_device([min(max(pos + j, 0), S - 1) for j in range(C)], dev, torch.int64)
    xs = [llama.embed(cfg, p, tokens) for p in ranks]
    ropes = [p["rope_table"][rope_idx] for p in ranks]
    for l in range(cfg.n_layers):
        lps = [p["layers"][l] for p in ranks]
        atts = []
        for t, lp in enumerate(lps):
            q, k, v = llama.project_qkv(cfg, lp, xs[t], ropes[t], path)
            slices = [caches[t][j][l] for j in range(len(lay.ranks))]
            for i, leaf in zip(lay.ranks, slices):
                write(leaf, i, k, v)
            att = sp_sharded_attention(q.to(torch.float32), [s[0] for s in slices], [s[1] for s in slices], pos,
                                       lay.ranks, lay.group)
            atts.append(att.reshape(C, -1))
        xs = llama.block_tail_tp(cfg, xs, atts, lps, path, impl, group=lay.tp_group)
    return llama.gather_logits_tp(cfg, ranks, xs, path, lay.tp_group)


def _sp_chunk_forward(cfg: LlamaConfig, ranks: list, tokens: torch.Tensor, caches: list, pos: int, path: str,
                      impl: str, lay: SpRanks):
    """A chunk of C tokens at pos..pos+C-1 (a chat or API delta, or a short
    first prompt): each sp rank scatters the rows it owns into its slice
    (rows of another rank, and pad rows past seq_len, are dropped), then
    the C queries attend every slice."""
    def write(leaf, i, k, v):
        Sl = leaf.shape[1]
        kvc.scatter_rows(leaf, [pos + j - i * Sl for j in range(k.shape[0])], k, v)

    return _sp_rows_forward(cfg, ranks, tokens, caches, pos, path, impl, lay, write)


def _sp_decode_step(cfg: LlamaConfig, ranks: list, tokens: torch.Tensor, caches: list, pos: int, path: str,
                    impl: str, lay: SpRanks):
    """One decode step at ``pos``: the new row is written on the owning sp
    rank only, then the query attends every slice."""
    def write(leaf, i, k, v):
        Sl = leaf.shape[1]
        kvc.select_row_update(leaf, k, v, min(max(pos - i * Sl, 0), Sl - 1), i * Sl <= pos < (i + 1) * Sl)

    return _sp_rows_forward(cfg, ranks, tokens, caches, pos, path, impl, lay, write)
