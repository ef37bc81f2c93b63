"""The all-reduce seam of tensor parallelism, and the two kernels behind its
``ring`` arm.

Every tensor-parallel layer sums the ranks' partial outputs twice, after
wo and after down (``models.llama.block_tail_tp``). A rank's tensors are a
list entry here: :func:`all_reduce` takes one tensor per rank and returns
one per rank, every one holding the same bytes (replicated sampling relies
on that). The arm is the caller's ``impl``, the values of the JAX package's
``DLT_ALLREDUCE``:

* ``psum``     the plain sum in rank order (the JAX package leaves psum to
               XLA, outside any Pallas kernel);
* ``ring_xla`` the plain unidirectional schedule: n chunks, chunk c summed
               over ranks c, c+1, ..., c+n-1;
* ``ring``     K4, ``csrc/ring_all_reduce.cu``: the bidirectional ring's
               function, 2n chunks, even chunks summed clockwise and odd
               chunks counter-clockwise (:func:`ring_fold_order`).

:func:`matmul_all_reduce` is the wo/down seam: under ``ring``, where
:func:`fused_ring_eligible` holds, K5 (``csrc/fused_matmul_ring.cu``)
computes each rank's int8 matmul tile and sums the ranks in K4's order
without writing any rank's product to device memory; otherwise each rank
runs its matmul and :func:`all_reduce` follows.

Worker mode (:mod:`parallel.hosts`) spreads the ranks over processes: the
seam then takes the process group of the axis it sums or exchanges over
(the whole group, or an :class:`parallel.hosts.AxisGroup` of the
processes on one mesh axis, whose host ids, rank indices, store keys and
IPC ring are its own), ``xs`` holds this process's ranks only
(a contiguous run of the group's ranks, host-major), and every arm gives
the bytes the one-process run of that arm gives. ``psum`` and
``ring_xla`` gather the partials in global rank order through the group
(a host copy each way, the library data move XLA's psum is in the JAX
package) and fold them as above; ``ring`` is K4 across processes over
staging buffers the processes map into each other (:class:`IpcRing`),
or on the CPU the same gather and K4's plain version. K5 is one launch
reading every rank's weight shard, which one process cannot do across
processes, so :func:`fused_ring_eligible` is False there and the ``ring``
arm runs each rank's K1 and then K4 (K5's own contract says that is the
same bytes).

The sequence- and expert-parallel backends exchange more than sums across
processes; :func:`exchange` is the one move under all of them: every
process stages its tensors and takes the slot ranges it needs from every
process. On the card it runs over K4's IPC staging (:meth:`IpcRing.exchange`:
a stage, a host barrier, device-to-device copies out of the peers' mapped
slots, a barrier), so nothing passes through host memory, under every
``--allreduce`` arm; on the CPU it is the group's gather through the
host. Its forms, each the one-process list operation when ``group`` does
not span processes and the same bytes in the same order when it does:
:func:`ring_rotate` (the ring pass's ``ppermute``), :func:`rank_gather`
(the attention partials before the ``pmax``/``psum`` merge, and the
``all_gather`` of rows) and :func:`all_to_all` (the expert dispatch's two
exchanges).

Each kernel wrapper launches its kernel for CUDA tensors or raises, counts
the launch in :data:`launches`, and computes the kernel's plain version for
CPU tensors. There is no fallback between arms: a failed IPC open, event or
launch raises. With telemetry on, each sum counts in
``dllama_kernel_path_total{kernel="all_reduce"}`` by the path that ran:
``k4_ring`` / ``k5_fused`` / ``psum`` / ``plain``.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.ops import q40

IMPLS = ("psum", "ring_xla", "ring")
MAX_RANKS = 8  # the kernels' pointer tables
COL_TILE = 64  # K1's output columns per CTA: a K5 chunk is whole tiles

SEVERAL_CARDS = ("tensor-parallel ranks on several cards are not ported yet "
                 "(ROADMAP.md Queue 1: ranks on several cards, with peer access or events between devices)")

# kernel name -> launches since the last reset_launches(); a wrapper adds one
# where it launches its CUDA kernel and nowhere else
# (ring_all_reduce_ipc: K4 across processes, worker mode)
launches: dict[str, int] = {"ring_all_reduce": 0, "fused_matmul_ring": 0, "ring_all_reduce_ipc": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def ring_fold_order(n: int, k: int) -> list[int]:
    """The ranks, in summation order, of chunk ``k`` of the bidirectional
    ring's 2n chunks: the JAX kernel's reduce-scatter carries chunk 2c
    clockwise from rank c (its partial picks up rank c+1, then c+2, ...) and
    chunk 2c+1 counter-clockwise (c, c-1, ...), each as a left fold."""
    c = k // 2
    step = 1 if k % 2 == 0 else -1
    return [(c + step * i) % n for i in range(n)]


def _fold(xs: list, n_chunks: int, order) -> torch.Tensor:
    """The last axis, zero-padded to a multiple of ``n_chunks`` and cut into
    that many chunks; chunk k is the left fold of the ranks ``order(k)`` in
    f32, then the padding is trimmed. One tensor of the inputs' shape."""
    n, shape = len(xs), xs[0].shape
    d = shape[-1]
    stacked = torch.stack([x.reshape(-1, d) for x in xs])  # [n, R, d]
    pad = (-d) % n_chunks
    if pad:
        stacked = torch.nn.functional.pad(stacked, (0, pad))
    R, w = stacked.shape[1], stacked.shape[2] // n_chunks
    stacked = stacked.reshape(n, R, n_chunks, w)
    ranks = torch.tensor([order(k) for k in range(n_chunks)], device=stacked.device).t()  # [i, k]
    ks = torch.arange(n_chunks, device=stacked.device)
    acc = stacked[ranks[0], :, ks]  # [n_chunks, R, w]
    for i in range(1, n):
        acc = acc + stacked[ranks[i], :, ks]
    return acc.permute(1, 0, 2).reshape(R, n_chunks * w)[:, :d].reshape(shape)


def psum(xs: list) -> list:
    """The plain sum in rank order, one copy per rank."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return [acc] * len(xs)


def ring_xla(xs: list) -> list:
    """The plain unidirectional ring schedule of the JAX package's
    ``ring_all_reduce_xla``: n chunks, chunk c the left fold over ranks c,
    c+1, ..., c+n-1."""
    n = len(xs)
    return [_fold(xs, n, lambda k: [(k + i) % n for i in range(n)])] * n


def ring_all_reduce_plain(xs: list) -> list:
    """K4's plain version: the last axis zero-padded to a multiple of 2n,
    2n chunks, chunk k the left fold over :func:`ring_fold_order`, trimmed."""
    n = len(xs)
    return [_fold(xs, 2 * n, lambda k: ring_fold_order(n, k))] * n


def _ptrs(ts: list):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _check_ranks(name: str, ts: list, dtype: torch.dtype, shape: tuple) -> torch.device:
    """One rank's operand per entry: all of ``dtype`` and ``shape``, all on
    one device (ranks on several cards raise NotImplementedError)."""
    dev = ts[0].device
    for r, t in enumerate(ts):
        if t.device != dev:
            raise NotImplementedError(SEVERAL_CARDS)
        q40._check(f"{name}[{r}]", t, dtype, shape, dev)
    if len(ts) > MAX_RANKS:
        raise ValueError(f"{name}: {len(ts)} ranks, at most {MAX_RANKS}")
    return dev


def ring_all_reduce(xs: list) -> list:
    """Wrapper of K4 (``csrc/ring_all_reduce.cu``): f32 [..., d] per rank in,
    the all-reduced sum per rank out (:func:`ring_all_reduce_plain`'s bytes
    on every rank). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    xs = [x.contiguous() for x in xs]
    dev = _check_ranks("xs", xs, torch.float32, tuple(xs[0].shape))
    if dev.type == "cpu":
        telemetry.note_kernel_path("all_reduce", "plain")
        return ring_all_reduce_plain(xs)
    if dev.type != "cuda":
        raise ValueError(f"ring_all_reduce: unsupported device {dev}")
    from distributed_llama_tpu_torch.ops import cuda_build

    n, d = len(xs), xs[0].shape[-1]
    outs = [torch.empty_like(x) for x in xs]
    fn = cuda_build.function("ring_all_reduce")
    q40._check_launch(fn(_ptrs(xs), _ptrs(outs), n, xs[0].numel() // d, d,
                         torch.cuda.current_stream(dev).cuda_stream), "ring_all_reduce")
    launches["ring_all_reduce"] += 1
    telemetry.note_kernel_path("all_reduce", "k4_ring")
    return outs


def spans_hosts(group) -> bool:
    """Whether ``group`` (a :class:`parallel.hosts.HostGroup` or None)
    spreads the ranks over several processes."""
    return group is not None and group.num_hosts > 1


def all_reduce(xs: list, impl: str = "psum", group=None) -> list:
    """THE all-reduce seam: the sum over ranks of ``xs`` (one tensor per
    rank), the same bytes on every rank. One rank is the identity; a ring
    arm with a payload narrower than the rank count takes psum (the
    deterministic shape rule of the JAX seam). With a ``group`` spanning
    processes, ``xs`` are this process's ranks and the sum runs over the
    group's global ranks (the module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown all-reduce {impl!r}; expected one of {IMPLS}")
    hosts = spans_hosts(group)
    n = len(xs) * (group.num_hosts if hosts else 1)
    if n <= 1:
        return list(xs)
    if impl != "psum" and xs[0].shape[-1] < n:
        impl = "psum"
    if hosts:
        return _all_reduce_hosts(xs, impl, group)
    if impl == "ring":
        return ring_all_reduce(xs)
    if impl == "ring_xla":
        telemetry.note_kernel_path("all_reduce", "plain")
        return ring_xla(xs)
    telemetry.note_kernel_path("all_reduce", "psum")
    return psum(xs)


def _all_reduce_hosts(xs: list, impl: str, group) -> list:
    """:func:`all_reduce` over processes: K4 across them for ``ring`` on the
    card, else every rank's partial gathered in global rank order, folded
    by the arm's plain function on this process's device, and this
    process's ranks' outputs kept."""
    if impl == "ring" and xs[0].device.type == "cuda":
        return ring_all_reduce_ipc(xs, group)
    every = group.gather_ranks(xs)
    fold = {"psum": psum, "ring_xla": ring_xla, "ring": ring_all_reduce_plain}[impl]
    telemetry.note_kernel_path("all_reduce", "psum" if impl == "psum" else "plain")
    first = group.local_ranks(len(every)).start
    return fold(every)[first : first + len(xs)]


def all_gather(xs: list, group=None) -> torch.Tensor:
    """The ranks' last-axis slices joined in global rank order, the one
    tensor every process holds (on ``xs[0]``'s device): a ``torch.cat`` of
    this process's ranks, or of every process's through ``group``."""
    if spans_hosts(group):
        xs = group.gather_ranks(xs)
    dev = xs[0].device
    return torch.cat([x.to(dev) for x in xs], dim=-1)


# ---------------------------------------------------------------------------
# K4 across processes (worker mode): one staging buffer per process, mapped
# by its peers, and two interprocess events (csrc/ring_all_reduce.cu)
# ---------------------------------------------------------------------------

IPC_HANDLE_BYTES = 64  # cudaIpcMemHandle_t and cudaIpcEventHandle_t
SLOT_ALIGN = 256  # each rank's slot starts on a 256-byte boundary (cudaMalloc's)


def _ipc(symbol: str):
    from distributed_llama_tpu_torch.ops import cuda_build

    return cuda_build.function("ring_all_reduce", symbol)


class IpcRing:
    """This process's side of K4 across the processes of ``group`` (the
    whole worker group or one mesh axis's): a staging buffer with a slot
    per local rank (sized for the largest payload seen so far, grown by
    every process of the group at the same call), its peers' buffers
    mapped once per size, and this process's "ready" and "done"
    interprocess events with its peers' opened. Handles travel through the
    group's store keys; slots, peers and barriers are the group's, so a
    process on two axes holds two independent rings. Built by every
    process of the group together (:func:`open_ipc_ring`), closed by
    :meth:`parallel.hosts.HostGroup.destroy`."""

    def __init__(self, group, m: int, device: torch.device):
        self.group, self.m, self.device = group, m, device
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.peers = [h for h in range(group.num_hosts) if h != group.host_id]
        self.slot_bytes, self.own, self.mapped, self._generation = 0, None, {}, 0
        self.events, self.peer_events = {}, {}
        for name in ("ready", "done"):
            ev, handle = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
            q40._check_launch(_ipc("ring_ipc_event_create")(self.index, ctypes.byref(ev), handle),
                              "ring_ipc_event_create")
            self.events[name] = ev
            group.store_set(f"ring_ipc/event/{name}/{group.host_id}", handle.raw)
        for name in ("ready", "done"):
            opened = []
            for h in self.peers:
                ev = ctypes.c_void_p()
                q40._check_launch(_ipc("ring_ipc_event_open")(
                    self.index, group.store_get(f"ring_ipc/event/{name}/{h}"), ctypes.byref(ev)),
                    "ring_ipc_event_open")
                opened.append(ev)
            self.peer_events[name] = (ctypes.c_void_p * len(opened))(*opened)

    def _grow(self, slot_bytes: int) -> None:
        """Every process of the group at once: drop the old buffers once no
        launch reads them, then allocate, export and map buffers of
        ``slot_bytes`` slots."""
        if self.own is not None:
            self._close_buffers()
        slot_bytes = -(-slot_bytes // SLOT_ALIGN) * SLOT_ALIGN
        own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        q40._check_launch(_ipc("ring_ipc_alloc")(self.index, self.m * slot_bytes, ctypes.byref(own), handle),
                          "ring_ipc_alloc")
        self.own, self.slot_bytes = own, slot_bytes
        g = self.group
        g.store_set(f"ring_ipc/buffer/{self._generation}/{g.host_id}", handle.raw)
        for h in self.peers:
            ptr = ctypes.c_void_p()
            q40._check_launch(_ipc("ring_ipc_open")(
                self.index, g.store_get(f"ring_ipc/buffer/{self._generation}/{h}"), ctypes.byref(ptr)),
                "ring_ipc_open")
            self.mapped[h] = ptr
        self._generation += 1

    def _close_buffers(self) -> None:
        """Unmap the peers' buffers and free this process's: after this
        process's queued work is done and every peer has passed the same
        point (a barrier before any handle is closed, and one before any
        buffer is freed)."""
        torch.cuda.synchronize(self.device)
        self.group.barrier()
        for ptr in self.mapped.values():
            q40._check_launch(_ipc("ring_ipc_close")(self.index, ptr), "ring_ipc_close")
        self.mapped = {}
        self.group.barrier()
        q40._check_launch(_ipc("ring_ipc_free")(self.index, self.own), "ring_ipc_free")
        self.own, self.slot_bytes = None, 0

    def close(self) -> None:
        """Free every buffer and event (every process at once)."""
        if self.own is not None:
            self._close_buffers()
        for ev in [*self.peer_events.get("ready", ()), *self.peer_events.get("done", ()),
                   *self.events.values()]:
            q40._check_launch(_ipc("ring_ipc_event_destroy")(self.index, ev), "ring_ipc_event_destroy")
        self.events, self.peer_events = {}, {}

    def slot_pointers(self) -> list:
        """The group's n ranks' slots in its rank order: each process's m
        slots, own or mapped."""
        bases = {self.group.host_id: self.own.value, **{h: p.value for h, p in self.mapped.items()}}
        return [bases[h] + j * self.slot_bytes for h in range(self.group.num_hosts) for j in range(self.m)]

    def exchange(self, xs: list, picks: list) -> list:
        """Stage this process's tensors ``xs`` (at most ``m``, one shape and
        dtype), barrier, copy each pick (global slot, row or None; every
        pick of one kind) out of the owning process's slot, barrier. Slots
        of this process are returned as views of ``xs``; every other pick is
        a new tensor holding the staged bytes."""
        x0 = xs[0]
        nbytes = x0.numel() * x0.element_size()
        if len(xs) > self.m:
            raise ValueError(f"exchange: {len(xs)} tensors, {self.m} slots")
        if len({row is None for _, row in picks}) > 1:
            raise ValueError("exchange: whole slots and rows in one call")
        if nbytes > self.slot_bytes:
            self._grow(nbytes)
        g, m = self.group, len(xs)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        q40._check_launch(_ipc("ring_ipc_stage")(
            self.index, _ptrs(xs), m, self.own, self.slot_bytes, nbytes, self.peer_events["done"],
            len(self.peers), self.events["ready"], stream), "ring_ipc_stage")
        g.barrier()  # every peer's "ready" record is issued
        bases = {h: p.value for h, p in self.mapped.items()}
        row_bytes = nbytes // x0.shape[0] if x0.dim() else nbytes
        outs, srcs, dsts, size = [], [], [], nbytes
        for slot, row in picks:
            h, j = divmod(slot, m)
            if h == g.host_id:
                outs.append(xs[j] if row is None else xs[j][row])
                continue
            out = torch.empty(x0.shape if row is None else x0.shape[1:], dtype=x0.dtype, device=self.device)
            srcs.append(bases[h] + j * self.slot_bytes + (0 if row is None else row * row_bytes))
            dsts.append(out.data_ptr())
            outs.append(out)
            size = nbytes if row is None else row_bytes
        q40._check_launch(_ipc("ring_ipc_fetch")(
            self.index, (ctypes.c_void_p * max(1, len(srcs)))(*srcs), (ctypes.c_void_p * max(1, len(dsts)))(*dsts),
            len(srcs), size, self.peer_events["ready"], len(self.peers), self.events["done"], stream),
            "ring_ipc_fetch")
        g.barrier()  # every peer's "done" record is issued before any stages again
        return outs

    def all_reduce(self, xs: list) -> list:
        """One cross-process K4 call over this process's partials ``xs``
        (f32 [..., d], one per local rank): stage, barrier, reduce,
        barrier. Returns this process's outputs."""
        nbytes = xs[0].numel() * 4
        if nbytes > self.slot_bytes:
            self._grow(nbytes)
        g, d = self.group, xs[0].shape[-1]
        n = self.m * g.num_hosts
        stream = torch.cuda.current_stream(self.device).cuda_stream
        q40._check_launch(_ipc("ring_ipc_stage")(
            self.index, _ptrs(xs), self.m, self.own, self.slot_bytes, nbytes, self.peer_events["done"],
            len(self.peers), self.events["ready"], stream), "ring_ipc_stage")
        g.barrier()  # every peer's "ready" record is issued
        outs = [torch.empty_like(x) for x in xs]
        ins = (ctypes.c_void_p * n)(*self.slot_pointers())
        q40._check_launch(_ipc("ring_ipc_reduce")(
            self.index, ins, _ptrs(outs), self.m, n, xs[0].numel() // d, d, self.peer_events["ready"],
            len(self.peers), self.events["done"], stream), "ring_all_reduce_ipc")
        g.barrier()  # every peer's "done" record is issued before any stages again
        return outs


def open_ipc_ring(group, m: int, device: torch.device, slot_bytes: int = 0) -> IpcRing:
    """``group``'s :class:`IpcRing` for ``m`` local ranks on ``device``, made
    at the first call and its slots grown to at least ``slot_bytes``: every
    process calls this together. A failed allocation, IPC open or event
    raises."""
    if group.ipc is None:
        group.ipc = IpcRing(group, m, device)
    if slot_bytes > group.ipc.slot_bytes:
        group.ipc._grow(slot_bytes)
    return group.ipc


def ring_all_reduce_ipc(xs: list, group) -> list:
    """Wrapper of K4 across processes: this process's ranks' f32 [..., d]
    partials in, their all-reduced sums out, the bytes the one-process K4
    launch over all the global ranks gives (every process folds every chunk
    in :func:`ring_fold_order`). CUDA tensors only: on the CPU the seam
    gathers and takes :func:`ring_all_reduce_plain`."""
    xs = [x.contiguous() for x in xs]
    dev = _check_ranks("xs", xs, torch.float32, tuple(xs[0].shape))
    if dev.type != "cuda":
        raise ValueError(f"ring_all_reduce_ipc: unsupported device {dev}")
    if len(xs) * group.num_hosts > MAX_RANKS:
        raise ValueError(f"xs: {len(xs) * group.num_hosts} ranks, at most {MAX_RANKS}")
    outs = open_ipc_ring(group, len(xs), dev).all_reduce(xs)
    launches["ring_all_reduce_ipc"] += 1
    telemetry.note_kernel_path("all_reduce", "k4_ring")
    return outs


# ---------------------------------------------------------------------------
# The sequence- and expert-parallel exchanges (worker mode: the ranks of an
# axis spread over the group's processes, each holding a contiguous run)
# ---------------------------------------------------------------------------


def exchange(xs: list, group, picks: list) -> list:
    """Every process stages its tensors ``xs`` (the same count, shape and
    dtype on every process) and gets back, per ``(slot, row)`` of
    ``picks``, global slot ``slot``'s tensor (host h's ``xs[j]`` is slot
    h * len(xs) + j), or with ``row`` its entry ``row`` along the first
    axis. The bytes move unchanged. On the card through the IPC staging
    (:meth:`IpcRing.exchange`: device to device, no host copy; a failed
    open, event or copy raises), on the CPU through the group's gather."""
    xs = [x.contiguous() for x in xs]
    dev = xs[0].device
    if dev.type == "cuda":
        return open_ipc_ring(group, len(xs), dev).exchange(xs, picks)
    if dev.type != "cpu":
        raise ValueError(f"exchange: unsupported device {dev}")
    every = group.gather_ranks(xs)
    return [every[slot] if row is None else every[slot][row] for slot, row in picks]


def ring_rotate(xs: list, group=None) -> list:
    """One step of the ring pass's ``ppermute`` (rank j sends to rank j+1,
    rank n-1 to rank 0) over ``xs``, the ranks' entries in rank order (this
    process's run of them with a ``group`` spanning processes): afterwards
    rank i holds what rank i-1 held. One process: a rotation of the list.
    Across processes the run's first entry is the previous host's last,
    moved by :func:`exchange` (a chunk of the ring pass is S/sp rows of K
    and V, 32 MiB per layer at 7B width and sp 2: card to card)."""
    if not spans_hosts(group):
        return [xs[-1]] + list(xs[:-1])
    prev = (group.host_id - 1) % group.num_hosts
    return exchange([xs[-1]], group, [(prev, None)]) + list(xs[:-1])


def rank_gather(xs: list, group=None) -> list:
    """Every rank's entry in global rank order from ``xs``, this process's
    run of the ranks (all of them in one process, where this is the list
    itself): the gather under the sequence-parallel merge's ``pmax`` and
    ``psum``\\ s and under the expert dispatch's ``all_gather``, through
    :func:`exchange`."""
    if not spans_hosts(group):
        return list(xs)
    return exchange(xs, group, [(s, None) for s in range(len(xs) * group.num_hosts)])


def all_to_all(xs: list, n: int, group=None) -> list:
    """The ``all_to_all`` of ``n`` ranks: ``xs`` holds this process's ranks'
    tensors (all ``n`` in one process), each indexed on its first axis by
    the destination rank; returns for each of this process's ranks r the
    list over source ranks s of ``x_s[r]``. One process: index moves;
    across processes through :func:`exchange`."""
    if not spans_hosts(group):
        return [[xs[s][r] for s in range(n)] for r in range(n)]
    first = group.host_id * len(xs)
    picks = [(s, r) for r in range(first, first + len(xs)) for s in range(n)]
    got = exchange(xs, group, picks)
    return [got[k * n : (k + 1) * n] for k in range(len(xs))]


# ---------------------------------------------------------------------------
# K5: the int8 Q40 matmul fused into K4 (csrc/fused_matmul_ring.cu)
# ---------------------------------------------------------------------------


def fused_matmul_ring_plain(xqs: list, sxs: list, corrs: list, qss: list, scaless: list) -> list:
    """K5's plain version: per rank y_r = K1(xq_r, sx_r, qs_r, scales_r) -
    8 corr_r (K1's plain version), then K4's plain version over the y_r."""
    ys = [q40.q40_int8_plain(xq, sx, qs, sc) - 8.0 * corr
          for xq, sx, qs, sc, corr in zip(xqs, sxs, qss, scaless, corrs)]
    return ring_all_reduce_plain(ys)


def fused_matmul_ring(xqs: list, sxs: list, corrs: list, qss: list, scaless: list) -> list:
    """Wrapper of K5: per rank the Q80 activations (xq int8 [T, n_pad], sx
    f32 [T, n_pad/32]), the bias correction corr f32 [T, d_pad]
    (:func:`ops.q40.bias_correction`) and the Q40 pack (qs, scales); out
    f32 [T, d_pad] per rank, equal to K1, then ``- 8 corr``, then K4. T <= 8
    and d_pad a multiple of 2n x 64. CPU tensors take the plain version;
    CUDA tensors launch the kernel as clusters of n CTAs or raise (a refused
    cluster launch included)."""
    n = len(xqs)
    T, n_pad = xqs[0].shape
    d_pad = qss[0].shape[1]
    dev = _check_ranks("xq", xqs, torch.int8, (T, n_pad))
    for name, ts, dt, shape in (("sx", sxs, torch.float32, (T, n_pad // 32)),
                                ("corr", corrs, torch.float32, (T, d_pad)),
                                ("qs", qss, torch.uint8, (n_pad // 2, d_pad)),
                                ("scales", scaless, torch.float32, (n_pad // 32, d_pad))):
        if _check_ranks(name, ts, dt, shape) != dev:
            raise NotImplementedError(SEVERAL_CARDS)
    if T > 8 or n_pad % 64 or d_pad % (2 * n * COL_TILE):
        raise ValueError(f"fused_matmul_ring: T {T} > 8, n_pad {n_pad} or d_pad {d_pad} not tiled for {n} ranks")
    if dev.type == "cpu":
        telemetry.note_kernel_path("all_reduce", "plain")
        return fused_matmul_ring_plain(xqs, sxs, corrs, qss, scaless)
    if dev.type != "cuda":
        raise ValueError(f"fused_matmul_ring: unsupported device {dev}")
    from distributed_llama_tpu_torch.ops import cuda_build

    outs = [torch.empty((T, d_pad), dtype=torch.float32, device=dev) for _ in range(n)]
    fn = cuda_build.function("fused_matmul_ring")
    q40._check_launch(fn(_ptrs(xqs), _ptrs(sxs), _ptrs(qss), _ptrs(scaless), _ptrs(corrs), _ptrs(outs),
                         n, T, n_pad, d_pad, torch.cuda.current_stream(dev).cuda_stream), "fused_matmul_ring")
    launches["fused_matmul_ring"] += 1
    telemetry.note_kernel_path("all_reduce", "k5_fused")
    return outs


def k5_cluster_dims(n: int) -> tuple[int, int, int]:
    """The thread-block cluster shape K5 launches with for ``n`` ranks (one
    CTA per rank of a column tile), as its C library reports it."""
    from distributed_llama_tpu_torch.ops import cuda_build

    dims = (ctypes.c_int * 3)()
    q40._check_launch(cuda_build.function("fused_matmul_ring", "fused_matmul_ring_cluster")(n, dims),
                      "fused_matmul_ring_cluster")
    return tuple(dims)


def fused_ring_eligible(xs: list, ws: list, path: str = "int8", group=None) -> bool:
    """Where K5 serves the ``ring`` arm: every rank's weight a kernel-tiled
    Q40 pack of one shape on the int8 path, T <= 8 (K1's largest token
    tile), and the output width unpadded and a multiple of 2n x 64, so that
    each of the 2n ring chunks is whole 64-column K1 tiles and the chunks
    are those of K4 over the trimmed output. The JAX gate also bounds the
    operands by the TPU's VMEM (``_fused_ring_eligible``); the card streams
    the weights from HBM, and that bound would turn away a 7B down shard
    (11.3 MB of nibbles at tp=2) for nothing: it picks which arm serves,
    not what is computed. Ranks spread over processes (``group``) are
    never eligible: K5 is one launch over every rank's shard."""
    if spans_hosts(group):
        return False
    n, w0 = len(xs), ws[0]
    return (path == "int8" and n <= MAX_RANKS and xs[0].dim() == 2 and xs[0].shape[0] <= 8
            and all(isinstance(w, q40.QuantizedMatrix) and q40.kernel_eligible(w)
                    and w.qs.shape == w0.qs.shape for w in ws)
            and w0.d == w0.d_padded and w0.d_padded % (2 * n * COL_TILE) == 0)


def fused_matmul_ring_all_reduce(xs: list, qms: list) -> list:
    """sum over ranks of x_r @ dequant(qm_r) through K5: each rank's Q80
    quantize and bias correction (the same ops as the unfused int8 path),
    then one launch for the matmuls and the ring."""
    preps = [q40.quantize_for(x, qm) for x, qm in zip(xs, qms)]
    corrs = [q40.bias_correction(xq, sx, qm) for (xq, sx), qm in zip(preps, qms)]
    return fused_matmul_ring([p[0] for p in preps], [p[1] for p in preps], corrs,
                             [qm.qs for qm in qms], [qm.scales for qm in qms])


def matmul_all_reduce(xs: list, ws: list, impl: str = "psum", path: str = "int8", group=None) -> list:
    """THE matmul + all-reduce seam: sum over ranks of ``xs[r] @ ws[r]``,
    the same bytes on every rank. Under ``ring``, K5 where
    :func:`fused_ring_eligible` holds; otherwise each rank's matmul
    (``models.llama._matmul``), then :func:`all_reduce` under ``impl``
    (over ``group``'s processes where it spans several)."""
    from distributed_llama_tpu_torch.models.llama import _matmul

    if impl == "ring" and len(xs) > 1 and fused_ring_eligible(xs, ws, path, group):
        return fused_matmul_ring_all_reduce(xs, ws)
    return all_reduce([_matmul(x, w, path) for x, w in zip(xs, ws)], impl, group)
