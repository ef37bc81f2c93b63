"""Device selection for the port's entry points (the card unless the
caller asks for the CPU, and no silent fallback either way), and the
host<->device copies that must not wait for the stream."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = "cuda", host_id: int | None = None) -> torch.device:
    """``"cuda"`` (the default) needs a visible CUDA device and raises
    without one; ``"cpu"`` runs the kernels' plain PyTorch versions. In
    worker mode (``host_id`` set) an unnumbered ``"cuda"`` is
    ``cuda:{host_id % device_count}``: every process on the one card, or a
    card per process, and that card becomes the process's current one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and host_id is not None:
        if dev.index is None:
            dev = torch.device("cuda", host_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def to_device(array, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (numpy, list or CPU tensor) on ``device``. On the card
    the copy is issued non-blocking: a blocking host-to-device copy makes
    PyTorch synchronise the stream, which would stall the host behind every
    queued kernel."""
    t = torch.as_tensor(array, dtype=dtype)
    return t if device.type == "cpu" else t.to(device, non_blocking=True)


class HostFetch:
    """A device tensor's copy to the host, started when it is made.

    On the card the copy goes to a pinned buffer with ``non_blocking=True``
    and a CUDA event is recorded behind it, so :meth:`wait` waits for this
    tensor's copy only and not for work queued after it (a plain ``.cpu()``
    is a blocking copy queued behind everything issued so far). On the CPU
    the values are simply kept."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.detach()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
