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
(:func:`rank_placement`): the flat index t * inner + i, host-major, so an
inner axis narrower than a host's share stays inside one process and the
tp axis spans the processes. On the card, ``"cuda"``
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
    return axis_runs(tp, 1, num_hosts, host_id, "tp")[0]


def rank_placement(tp: int, inner: int, num_hosts: int, host_id: int) -> list[tuple[int, int]]:
    """The (tp rank, inner rank) pairs host ``host_id`` holds on a ``tp`` x
    ``inner`` layout (inner: the sp or ep axis; 1 for tensor parallelism
    alone), in global order. The JAX package builds its mesh with
    ``mesh_utils.create_device_mesh((tp, inner), jax.devices()[:tp*inner])``,
    which lays the devices out row-major, and ``jax.devices()`` lists each
    process's devices in process order: device (t, i) is the (t*inner +
    i)-th, and host h holds the h-th contiguous run of tp*inner/H of them."""
    n = tp * inner
    if n % num_hosts:
        named = f"--tp {tp}" if inner == 1 else f"--tp {tp} x {inner} = {n} ranks"
        raise ValueError(f"{named} must be a multiple of --num-hosts {num_hosts}")
    m = n // num_hosts
    return [divmod(g, inner) for g in range(host_id * m, (host_id + 1) * m)]


def axis_runs(tp: int, inner: int, num_hosts: int, host_id: int, axis: str) -> tuple[range, range]:
    """Host ``host_id``'s ranks of a ``tp`` x ``inner`` layout (``axis``:
    the inner axis's flag name, "sp" or "ep") as (its tp ranks, its inner
    ranks), two runs whose product is :func:`rank_placement`'s pairs.
    Either the host holds whole rows (every inner rank of a run of tp
    ranks: the inner axis's exchanges stay in the process and the tp
    collectives span the processes) or, at ``tp`` = 1, a run of the inner
    ranks (the inner exchanges span the processes). A run of one tp rank's
    inner ranks at ``tp`` > 1 would need each axis's collectives over a
    subset of the processes: NotImplementedError."""
    pairs = rank_placement(tp, inner, num_hosts, host_id)
    m = len(pairs)
    if m % inner == 0:
        return range(pairs[0][0], pairs[0][0] + m // inner), range(inner)
    if tp == 1 and inner % m == 0:
        return range(1), range(pairs[0][1], pairs[0][1] + m)
    raise NotImplementedError(
        f"--tp {tp} --{axis} {inner} over --num-hosts {num_hosts}: each process would hold part of one tp rank's "
        f"{axis} ranks at tp > 1, whose exchanges span a subset of the processes; not ported "
        f"(ROADMAP.md Queue 1: --{axis} ranks of a tp rank over several processes)")


class HostGroup:
    """One process's membership of the worker-mode group (see the module
    docstring). ``ipc`` holds the cross-process K4's buffers and events
    (:class:`ops.collectives.IpcRing`) once the first ``ring`` all-reduce on
    the card has made them; :meth:`destroy` closes them."""

    def __init__(self, coordinator: str, num_hosts: int, host_id: int, timeout_s: float = DEFAULT_TIMEOUT_S):
        if num_hosts < 1 or not 0 <= host_id < num_hosts:
            raise ValueError(f"--host-id {host_id} outside --num-hosts {num_hosts}")
        if dist.is_initialized():
            raise RuntimeError("a torch.distributed process group already exists in this process")
        host, port = parse_coordinator(coordinator)
        timeout = datetime.timedelta(seconds=timeout_s)
        self.num_hosts, self.host_id = num_hosts, host_id
        self._store = dist.TCPStore(host, port, num_hosts, host_id == 0, timeout=timeout)
        dist.init_process_group("gloo", store=self._store, rank=host_id, world_size=num_hosts, timeout=timeout)
        self.ipc = None
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

    def local_ranks(self, tp: int) -> range:
        return local_ranks(tp, self.num_hosts, self.host_id)

    def axis_runs(self, tp: int, inner: int, axis: str) -> tuple[range, range]:
        return axis_runs(tp, inner, self.num_hosts, self.host_id, axis)

    def barrier(self) -> None:
        dist.barrier()

    def all_gather(self, t: torch.Tensor) -> list:
        """Every host's CPU tensor ``t`` (one shape and dtype on all), in
        host order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.num_hosts)]
        dist.all_gather(out, t)
        return out

    def broadcast_ints(self, values: list) -> list:
        """Host 0's ``values`` (ints), on every host."""
        t = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(t, src=0)
        return [int(v) for v in t.tolist()]

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
        self._store.set(key, value)

    def store_get(self, key: str) -> bytes:
        """The value another host set under ``key`` (waits for it, at most
        the group's timeout)."""
        return self._store.get(key)

    def destroy(self) -> None:
        """Leave the group: a barrier before any IPC handle is closed (the
        cross-process K4's buffers and events, closed by every host
        together), then the process group. Idempotent."""
        if not self._open:
            return
        self._open = False
        if self.ipc is not None:
            self.ipc.close()
            self.ipc = None
        else:
            self.barrier()
        dist.destroy_process_group()
