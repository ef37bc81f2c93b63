"""Worker mode's process group: the ranks (tensor-parallel, and with them
sequence- or expert-parallel) spread over several processes ("hosts"),
every process running the same program.

The port's counterpart of ``jax.distributed.initialize`` as the JAX CLI's
worker mode calls it. Host 0 serves a ``TCPStore`` at the coordinator's
``host:port``; every host joins it, and a ``gloo`` process group over it
carries the host-side collectives: barriers, all-gathers of CPU tensors in
host order, a broadcast of a few ints from host 0. NCCL is not used: it
refuses two ranks on one card, which is how worker mode runs on a machine
with one GPU. Both the store and the group wait at most ``timeout_s``, so
a dead peer raises instead of hanging the others.

Global rank order is host-major: with ``tp`` ranks over ``num_hosts``
processes, host h holds ranks [h tp/H, (h+1) tp/H) (:meth:`HostGroup.local_ranks`),
reads only their shards of the `.m` file, and runs them as the one-process
backend runs its ranks; the all-reduces and the logits' all-gather go
through :mod:`ops.collectives` with the group. The composite layouts
(``--tp`` x ``--sp``, ``--tp`` x ``--ep``) place their ranks as the JAX
package's mesh does over ``jax.devices()`` in process order
(:func:`rank_placement`): the flat index t * inner + i, host-major. A
host then holds either whole rows (every inner rank of a run of tp ranks:
the inner axis stays in the process, the tp axis spans every process) or
an equal part of one row (a run of one tp rank's inner ranks: the inner
axis spans the processes of that tp rank, the tp axis the processes
holding the same inner run). Each collective runs over the processes of
its own mesh axis, as the JAX mesh's named axes do: :func:`axis_members`
names them, and :meth:`HostGroup.axis_groups` gives each axis that spans
processes its own gloo group and IPC ring (an :class:`AxisGroup`, or the
whole group where the axis spans every process). On the card, ``"cuda"``
resolves to ``cuda:{host_id % device_count}`` (:func:`platform.resolve_device`):
every process on one card, or one card per process.

    python -m distributed_llama_tpu_torch.apps.cli worker --model m.m --tokenizer t.t \\
        --prompt hi --tp 2 --coordinator 127.0.0.1:29500 --num-hosts 2 --host-id 0
    (and the same with --host-id 1, in another process)
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0


def parse_coordinator(address: str) -> tuple[str, int]:
    """``host:port`` -> (host, port)."""
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator {address!r}: expected host:port")
    return host, int(port)


def local_ranks(tp: int, num_hosts: int, host_id: int) -> range:
    """The global tp ranks host ``host_id`` holds: a contiguous run of
    tp / num_hosts, host-major (:func:`rank_placement` of tensor
    parallelism alone)."""
    return axis_runs(tp, 1, num_hosts, host_id)[0]


def rank_placement(tp: int, inner: int, num_hosts: int, host_id: int) -> list[tuple[int, int]]:
    """The (tp rank, inner rank) pairs host ``host_id`` holds on a ``tp`` x
    ``inner`` layout (inner: the sp or ep axis; 1 for tensor parallelism
    alone), in global order. The JAX package builds its mesh with
    ``mesh_utils.create_device_mesh((tp, inner), jax.devices()[:tp*inner])``,
    which lays the devices out row-major, and ``jax.devices()`` lists each
    process's devices in process order: device (t, i) is the (t*inner +
    i)-th, and host h holds the h-th contiguous run of tp*inner/H of them.
    The run must be whole rows or an equal part of one (for ranks that are
    powers of two it always is); a run across a row's end raises."""
    n = tp * inner
    if n % num_hosts:
        named = f"--tp {tp}" if inner == 1 else f"--tp {tp} x {inner} = {n} ranks"
        raise ValueError(f"{named} must be a multiple of --num-hosts {num_hosts}")
    m = n // num_hosts
    if m % inner and inner % m:
        raise ValueError(f"--tp {tp} x {inner} over --num-hosts {num_hosts}: a process's {m} ranks would cross "
                         f"a tp rank's {inner}; each process holds whole rows or an equal part of one")
    return [divmod(g, inner) for g in range(host_id * m, (host_id + 1) * m)]


def axis_runs(tp: int, inner: int, num_hosts: int, host_id: int) -> tuple[range, range]:
    """Host ``host_id``'s ranks of a ``tp`` x ``inner`` layout (inner: the
    sp or ep axis) as (its tp ranks, its inner ranks), two runs whose
    product is :func:`rank_placement`'s pairs:
    whole rows (every inner rank of a run of tp ranks) or a run of one tp
    rank's inner ranks."""
    pairs = rank_placement(tp, inner, num_hosts, host_id)
    m = len(pairs)
    if m % inner == 0:
        return range(pairs[0][0], pairs[0][0] + m // inner), range(inner)
    return range(pairs[0][0], pairs[0][0] + 1), range(pairs[0][1], pairs[0][1] + m)


def axis_members(tp: int, inner: int, num_hosts: int, host_id: int) -> tuple[list, list]:
    """The processes each collective of host ``host_id`` runs over, in the
    mesh's order, as (the inner axis's: the processes holding this host's
    tp ranks, the tp axis's: the processes holding its inner ranks). A host
    of whole rows keeps the inner axis to itself and shares the tp axis
    with every process; a host of part of a row shares the inner axis with
    the q = inner / (its inner ranks) processes of its tp rank and the tp
    axis with the processes at its place in every other row."""
    _, inners = axis_runs(tp, inner, num_hosts, host_id)
    if len(inners) == inner:
        return [host_id], list(range(num_hosts))
    q = inner // len(inners)
    first = host_id - host_id % q
    return list(range(first, first + q)), list(range(host_id % q, num_hosts, q))


class _Members:
    """The host-side collectives over a set of processes (``_pg``: the
    torch.distributed group, None for the world's), indices relative to
    the set: ``num_hosts`` processes, this one ``host_id``. Store keys go
    under the set's ``_prefix``; ``ipc`` holds the set's cross-process K4
    buffers and events (:class:`ops.collectives.IpcRing`) once the first
    exchange or ``ring`` all-reduce on the card has made them."""

    num_hosts: int
    host_id: int
    _pg = None
    _prefix = ""

    def local_ranks(self, tp: int) -> range:
        return local_ranks(tp, self.num_hosts, self.host_id)

    def barrier(self) -> None:
        dist.barrier(group=self._pg)

    def all_gather(self, t: torch.Tensor) -> list:
        """Every host's CPU tensor ``t`` (one shape and dtype on all), in
        host order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.num_hosts)]
        dist.all_gather(out, t, group=self._pg)
        return out

    def gather_ranks(self, xs: list) -> list:
        """Every global rank's tensor in global rank order, from each
        process's ranks ``xs`` (one shape and dtype on all): their bytes
        staged to the host, all-gathered and copied to ``xs[0]``'s device
        unchanged."""
        x0 = xs[0]
        local = torch.stack([x.contiguous() for x in xs]).cpu()
        raw = local.reshape(-1).view(torch.uint8)
        out = []
        for part in self.all_gather(raw):
            out.extend(part.view(x0.dtype).reshape(local.shape).to(x0.device).unbind(0))
        return out

    def store_set(self, key: str, value: bytes) -> None:
        self._store.set(self._prefix + key, value)

    def store_get(self, key: str) -> bytes:
        """The value another host set under ``key`` (waits for it, at most
        the group's timeout)."""
        return self._store.get(self._prefix + key)

    def _close_ipc(self) -> None:
        """Close this set's IPC ring, every member together (its barriers),
        or, without one, pass a barrier of the set."""
        if self.ipc is not None:
            self.ipc.close()
            self.ipc = None
        else:
            self.barrier()


class AxisGroup(_Members):
    """One mesh axis's processes that include this one (``members``: world
    host ids in the mesh's order), a view of :class:`HostGroup` with a gloo
    group and an IPC ring of its own (:meth:`HostGroup.axis_groups`)."""

    def __init__(self, world: "HostGroup", members: list, pg, prefix: str):
        self.members = members
        self.num_hosts, self.host_id = len(members), members.index(world.host_id)
        self._store, self._pg, self._prefix = world._store, pg, prefix
        self.ipc = None


class HostGroup(_Members):
    """One process's membership of the worker-mode group (see the module
    docstring). :meth:`destroy` closes its IPC rings, those of its axis
    groups first."""

    def __init__(self, coordinator: str, num_hosts: int, host_id: int, timeout_s: float = DEFAULT_TIMEOUT_S):
        if num_hosts < 1 or not 0 <= host_id < num_hosts:
            raise ValueError(f"--host-id {host_id} outside --num-hosts {num_hosts}")
        if dist.is_initialized():
            raise RuntimeError("a torch.distributed process group already exists in this process")
        host, port = parse_coordinator(coordinator)
        self._timeout = datetime.timedelta(seconds=timeout_s)
        self.num_hosts, self.host_id = num_hosts, host_id
        self._store = dist.TCPStore(host, port, num_hosts, host_id == 0, timeout=self._timeout)
        dist.init_process_group("gloo", store=self._store, rank=host_id, world_size=num_hosts, timeout=self._timeout)
        self.ipc = None
        # this process's axis groups in the order they were made (every
        # process makes them in one order), and the calls that made them
        self.views: list[AxisGroup] = []
        self._axis_calls = 0
        self._open = True

    def __enter__(self) -> "HostGroup":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.destroy()
        elif self._open:
            # leaving on an error: no barrier, which a peer stuck elsewhere
            # would only time out; the card's IPC resources go with the process
            self._open = False
            dist.destroy_process_group()

    def axis_runs(self, tp: int, inner: int) -> tuple[range, range]:
        return axis_runs(tp, inner, self.num_hosts, self.host_id)

    def axis_groups(self, tp: int, inner: int) -> tuple:
        """(the inner axis's group, the tp axis's group) of this process on
        a ``tp`` x ``inner`` layout (:func:`axis_members`): None where the
        axis stays in this process, this group where it spans every
        process, else an :class:`AxisGroup`. Every process calls this
        together: each makes every sub-group of the inner axis, then of
        the tp axis, in one order, members or not (``new_group`` is a
        collective of the whole group)."""
        self._axis_calls += 1
        every = [axis_members(tp, inner, self.num_hosts, h) for h in range(self.num_hosts)]
        out = []
        for k, name in ((0, "inner"), (1, "tp")):
            mine = every[self.host_id][k]
            if len(mine) == 1:
                out.append(None)
            elif len(mine) == self.num_hosts:
                out.append(self)
            else:
                pgs = {part: dist.new_group(list(part), timeout=self._timeout, backend="gloo")
                       for part in sorted({tuple(members[k]) for members in every})}
                view = AxisGroup(self, mine, pgs[tuple(mine)], f"axis/{self._axis_calls}/{name}/{mine[0]}/")
                self.views.append(view)
                out.append(view)
        return tuple(out)

    def broadcast_ints(self, values: list) -> list:
        """Host 0's ``values`` (ints), on every host."""
        t = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(t, src=0)
        return [int(v) for v in t.tolist()]

    def destroy(self) -> None:
        """Leave the group: each axis group's IPC ring closed by its
        members together (a barrier before any handle is closed), in the
        order the groups were made (the inner axis, then tp) on every
        process, then the whole group's, then the process group.
        Idempotent."""
        if not self._open:
            return
        self._open = False
        for view in self.views:
            view._close_ipc()
        self.views = []
        self._close_ipc()
        dist.destroy_process_group()
