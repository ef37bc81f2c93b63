"""Device selection for the port's entry points: the card unless the
caller asks for the CPU, and no silent fallback either way."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``"cuda"`` (the default) needs a visible CUDA device and raises
    without one; ``"cpu"`` runs the kernels' plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
