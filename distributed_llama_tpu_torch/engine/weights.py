"""Load `.m` weights into the params dict the model functions consume.

Matrices are stored in x@W orientation ([d_in, d_out]); layers stay a list
of per-layer dicts. With ``dtype="q40"`` the attention/FFN/wcls matrices stay
packed 4-bit (:class:`ops.q40.QuantizedMatrix`), q|k|v and gate|up fused as
one matmul each (the file's row-major blocks concatenate exactly), and the
repack runs with torch ops on the target device. Embeddings and norm
weights stay f32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distributed_llama_tpu_torch.formats.model_file import ArchType, ModelFileReader
from distributed_llama_tpu_torch.models.config import LlamaConfig, config_from_spec
from distributed_llama_tpu_torch.models.rope import build_rope_table
from distributed_llama_tpu_torch.ops.q40 import QuantizedMatrix, pack_q40_raw, quantize_q40_tpu
from distributed_llama_tpu_torch.platform import resolve_device
from distributed_llama_tpu_torch.quants import FloatType

Params = dict[str, Any]

QUANTIZED_DTYPE = "q40"  # keep matmul weights 4-bit on the device


def check_supported(cfg: LlamaConfig) -> None:
    """The port runs dense Llama-architecture models so far."""
    if cfg.is_moe or cfg.arch != ArchType.LLAMA:
        raise NotImplementedError(
            f"{cfg.arch.name} with {cfg.n_experts} experts: only dense Llama models are ported"
        )


def load_params(reader: ModelFileReader, cfg: LlamaConfig | None = None, dtype=QUANTIZED_DTYPE,
                device="cuda") -> Params:
    """Build the params dict on ``device`` (the card unless "cpu" is
    asked for). ``dtype`` is "q40", torch.bfloat16 or torch.float32 for the
    matmul weights."""
    device = resolve_device(device)
    cfg = cfg or config_from_spec(reader.spec)
    check_supported(cfg)
    quantized = dtype == QUANTIZED_DTYPE

    def f32(name: str) -> torch.Tensor:
        return torch.from_numpy(reader.tensor(name)).to(device)

    def plain(name: str) -> torch.Tensor:
        w = np.ascontiguousarray(reader.tensor(name).T)  # file [d_out, d_in] -> [d_in, d_out]
        return torch.from_numpy(w).to(device=device, dtype=dtype)

    def packed(names: list[str]) -> QuantizedMatrix:
        """Matrices sharing an input dim as ONE packed matmul, their output
        dims concatenated."""
        entries = [reader.entries[n] for n in names]
        d_out = sum(e.shape[0] for e in entries)
        if all(e.float_type == FloatType.Q40 for e in entries):
            raw = np.concatenate([reader.raw(n) for n in names])
            return pack_q40_raw(raw, (d_out, entries[0].shape[1]), device)
        w = np.concatenate([reader.tensor(n).T for n in names], axis=1)
        return quantize_q40_tpu(w, device)

    layers = []
    for l in range(cfg.n_layers):
        p = f"layers.{l}."
        if quantized:
            lp = {
                "qkv": packed([p + "q", p + "k", p + "v"]),
                "wo": packed([p + "wo"]),
                "gate_up": packed([p + "gate", p + "up"]),
                "down": packed([p + "down"]),
            }
        else:
            lp = {n: plain(p + n) for n in ("q", "k", "v", "wo", "gate", "down", "up")}
        lp["rms_att"] = f32(p + "rms_att")
        lp["rms_ffn"] = f32(p + "rms_ffn")
        layers.append(lp)
    return {
        "embedding": f32("embedding"),
        "layers": layers,
        "rms_final": f32("rms_final"),
        "wcls": packed(["wcls"]) if quantized else plain("wcls"),
        "rope_table": torch.from_numpy(build_rope_table(cfg)).to(device),
    }


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including the bfloat16 numpy dtype torch cannot
    read directly (moved through its 16-bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Params, device="cuda") -> Params:
    """The port's params on ``device`` (the card unless "cpu" is asked for)
    from the JAX package's ``load_params`` tree with every leaf as numpy and
    each ``QuantizedMatrix`` flattened by the caller into ``{"qs", "scales",
    "n", "d"}`` — so both packages compute the same function from the same
    bytes, and this package imports nothing of the JAX one."""
    device = resolve_device(device)

    def conv(v):
        if isinstance(v, dict) and set(v) == {"qs", "scales", "n", "d"}:
            return QuantizedMatrix(
                _tensor(v["qs"], device), _tensor(v["scales"], device),
                n_logical=int(v["n"]), d_logical=int(v["d"]),
            )
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return _tensor(np.asarray(v), device)

    return conv(tree)
