"""Hugging Face safetensors checkpoint -> `.m` (llama / mistral / mixtral / grok-1).

The port's copy of the JAX package's ``converter/hf.py``: the same tensor
plans in `.m` layout order, the same Q/K permute from the HF neox pair
layout to the interleaved rope layout, the same header (rope scaling from
``config.json``), so both converters write the same bytes.

Grok-1 follows the hpcai-tech/grok-1 transformers port's naming
(attn.*_proj, moe_block.gate, moe_block.experts.{e}.{linear,linear_v,
linear_1}, pre/post attn/moe norms) and keeps the neox Q/K layout: its
header leaves the rope type unset, which resolves to falcon/neox rope.

The safetensors format is read here without the ``safetensors`` package: an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw little-endian bytes, mapped with
``np.memmap``. The dtypes taken are the ones the JAX converter's numpy
reader takes; BF16 (and the float8 types) raise ``TypeError`` naming the
dtype, as numpy does for it there.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from distributed_llama_tpu_torch.formats.model_file import (
    ArchType,
    HiddenAct,
    ModelFileWriter,
    ModelSpec,
    RopeType,
)
from distributed_llama_tpu_torch.quants import FloatType

ARCH_BY_MODEL_TYPE = {
    "llama": ArchType.LLAMA,
    "mistral": ArchType.LLAMA,
    "mixtral": ArchType.MIXTRAL,
    "grok-1": ArchType.GROK1,
}

HIDDEN_ACT = {"gelu": HiddenAct.GELU, "silu": HiddenAct.SILU}

# safetensors dtype -> numpy dtype (little-endian, as the format stores it)
SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
    "BOOL": "?",
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in SAFETENSORS_DTYPES.items()}


def permute_qk(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF neox rope layout -> interleaved pair layout. ``w``: [n_heads*head, dim]."""
    d = w.shape[0]
    return w.reshape(n_heads, 2, d // n_heads // 2, *w.shape[1:]).swapaxes(1, 2).reshape(w.shape)


def unpermute_qk(w: np.ndarray, n_heads: int) -> np.ndarray:
    """The inverse of :func:`permute_qk`: interleaved pairs -> HF neox layout."""
    d = w.shape[0]
    return w.reshape(n_heads, d // n_heads // 2, 2, *w.shape[1:]).swapaxes(1, 2).reshape(w.shape)


def spec_from_hf_config(config: dict, float_type: FloatType) -> ModelSpec:
    arch = ARCH_BY_MODEL_TYPE.get(config["model_type"])
    if arch is None:
        raise ValueError(f"unsupported model type: {config['model_type']}")
    n_experts = int(config.get("num_local_experts") or config.get("num_experts") or 0)
    n_active = int(config.get("num_active_local_experts") or config.get("num_experts_per_tok") or 0)
    # grok-1 configs may omit hidden_act (its experts are always gelu)
    act = config.get("hidden_act") or ("gelu" if arch == ArchType.GROK1 else None)
    if act is None:
        raise ValueError("config.json is missing hidden_act")
    spec = ModelSpec(
        arch_type=arch,
        dim=config["hidden_size"],
        hidden_dim=config["intermediate_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        vocab_size=config["vocab_size"],
        seq_len=config["max_position_embeddings"],
        n_experts=n_experts,
        n_active_experts=n_active,
        hidden_act=HIDDEN_ACT[act],
        rope_theta=float(config.get("rope_theta") or 10000.0),
        weights_float_type=float_type,
    )
    if arch == ArchType.GROK1:
        # no Q/K permute for grok: the header rope stays unset and resolves
        # to falcon/neox
        return spec
    # Q/K are permuted into the interleaved-pair layout, so every other
    # converted model's rope is LLAMA, written explicitly
    spec.rope_type = RopeType.LLAMA
    scaling = config.get("rope_scaling")
    if scaling is not None:
        if scaling.get("rope_type") not in ("llama3",):
            raise ValueError(f"unsupported rope scaling type: {scaling.get('rope_type')}")
        # the header stores int32 values, truncated
        spec.rope_type = RopeType.LLAMA3_1
        spec.rope_scaling_factor = int(scaling["factor"])
        spec.rope_scaling_low_freq_factor = int(scaling["low_freq_factor"])
        spec.rope_scaling_high_freq_factor = int(scaling["high_freq_factor"])
        spec.rope_scaling_orig_max_seq_len = int(scaling["original_max_position_embeddings"])
    return spec


# ---------------------------------------------------------------------------
# The safetensors format
# ---------------------------------------------------------------------------


def read_safetensors_header(path: str) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the byte offset where the
    data starts)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsFile:
    """One safetensors file, its tensors mapped lazily from the disk."""

    def __init__(self, path: str):
        self.path = path
        self.header, self._data_start = read_safetensors_header(path)
        self._map = None

    def keys(self) -> list[str]:
        return list(self.header)

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor as a numpy array over the mapped bytes (read-only)."""
        info = self.header[name]
        dtype = info["dtype"]
        if dtype not in SAFETENSORS_DTYPES:
            raise TypeError(f"data type {dtype!r} (bfloat16 and the float8 types are not numpy types) of tensor "
                            f"{name!r} is not read")
        lo, hi = info["data_offsets"]
        if self._map is None:
            self._map = np.memmap(self.path, dtype=np.uint8, mode="r")
        buf = self._map[self._data_start + lo : self._data_start + hi]
        return buf.view(np.dtype(SAFETENSORS_DTYPES[dtype])).reshape(info["shape"])


def write_safetensors(path: str, tensors: dict, metadata: dict | None = None) -> None:
    """Write ``tensors`` (name -> numpy array of a dtype the format names)
    as one safetensors file, in the given order."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    arrays = []
    for name, a in tensors.items():
        a = np.asarray(a)
        a = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<"))
        if a.dtype not in _DTYPE_NAMES:
            raise TypeError(f"tensor {name!r}: dtype {a.dtype} has no safetensors name here")
        header[name] = {"dtype": _DTYPE_NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        arrays.append(a)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in arrays:
            a.tofile(f)


class _LazySafetensors:
    """Multi-file lazy tensor lookup that keeps one file open at a time
    (checkpoints are usually ordered, so misses are rare)."""

    def __init__(self, files: list[str]):
        self.files = files
        self._index: dict[str, int] = {}
        self._open_idx: int | None = None
        self._open: SafetensorsFile | None = None

    def _load(self, idx: int):
        if self._open_idx == idx:
            return
        self._open = SafetensorsFile(self.files[idx])
        self._open_idx = idx
        for key in self._open.keys():
            self._index[key] = idx

    def get(self, name: str) -> np.ndarray:
        if self._open is None:
            self._load(0)
        while name not in self._index:
            nxt = (self._open_idx or 0) + 1
            if nxt >= len(self.files):
                # full scan fallback
                for i in range(len(self.files)):
                    self._load(i)
                if name not in self._index:
                    raise KeyError(f"tensor {name} not found in checkpoint")
                break
            self._load(nxt)
        self._load(self._index[name])
        return self._open.get_tensor(name)


# ---------------------------------------------------------------------------
# Tensor plans
# ---------------------------------------------------------------------------


def grok1_tensor_plan(spec: ModelSpec) -> list[tuple[str, str, bool]]:
    """[(m_name, hf_name, permute)] for the hpcai-tech/grok-1 transformers
    port: attn.* projections (no permute: neox rope), the moe_block router
    and linear (gate) / linear_v (up) / linear_1 (down) experts, and grok's
    four per-layer norms mapped to rms_att / rms_ffn (post-attn) / rms_moe
    (pre-moe) / rms_ffn2 (post-moe)."""
    plan: list[tuple[str, str, bool]] = [("embedding", "model.embed_tokens.weight", False)]
    for l in range(spec.n_layers):
        hp = f"model.layers.{l}."
        mp = f"layers.{l}."
        plan += [
            (mp + "q", hp + "attn.q_proj.weight", False),
            (mp + "k", hp + "attn.k_proj.weight", False),
            (mp + "v", hp + "attn.v_proj.weight", False),
            (mp + "wo", hp + "attn.o_proj.weight", False),
            (mp + "moe_router", hp + "moe_block.gate.weight", False),
        ]
        for e in range(spec.n_experts):
            ep = hp + f"moe_block.experts.{e}."
            plan += [
                (mp + f"experts.{e}.up", ep + "linear_v.weight", False),
                (mp + f"experts.{e}.gate", ep + "linear.weight", False),
                (mp + f"experts.{e}.down", ep + "linear_1.weight", False),
            ]
        plan += [
            (mp + "rms_att", hp + "pre_attn_norm.weight", False),
            (mp + "rms_ffn", hp + "post_attn_norm.weight", False),
            (mp + "rms_moe", hp + "pre_moe_norm.weight", False),
            (mp + "rms_ffn2", hp + "post_moe_norm.weight", False),
        ]
    plan += [("rms_final", "model.norm.weight", False), ("wcls", "lm_head.weight", False)]
    return plan


def hf_tensor_plan(spec: ModelSpec) -> list[tuple[str, str, bool]]:
    """[(m_name, hf_name, permute)] in `.m` layout order."""
    if spec.arch_type == ArchType.GROK1:
        return grok1_tensor_plan(spec)
    plan: list[tuple[str, str, bool]] = [("embedding", "model.embed_tokens.weight", False)]
    for l in range(spec.n_layers):
        hp = f"model.layers.{l}."
        mp = f"layers.{l}."
        plan += [
            (mp + "q", hp + "self_attn.q_proj.weight", True),
            (mp + "k", hp + "self_attn.k_proj.weight", True),
            (mp + "v", hp + "self_attn.v_proj.weight", False),
            (mp + "wo", hp + "self_attn.o_proj.weight", False),
        ]
        if spec.n_experts > 0:
            plan.append((mp + "moe_router", hp + "block_sparse_moe.gate.weight", False))
            for e in range(spec.n_experts):
                ep = hp + f"block_sparse_moe.experts.{e}."
                plan += [
                    (mp + f"experts.{e}.up", ep + "w3.weight", False),
                    (mp + f"experts.{e}.gate", ep + "w1.weight", False),
                    (mp + f"experts.{e}.down", ep + "w2.weight", False),
                ]
        else:
            plan += [
                (mp + "gate", hp + "mlp.gate_proj.weight", False),
                (mp + "down", hp + "mlp.down_proj.weight", False),
                (mp + "up", hp + "mlp.up_proj.weight", False),
            ]
        plan += [
            (mp + "rms_att", hp + "input_layernorm.weight", False),
            (mp + "rms_ffn", hp + "post_attention_layernorm.weight", False),
        ]
    plan += [("rms_final", "model.norm.weight", False), ("wcls", "lm_head.weight", False)]
    return plan


def convert_hf(source_dir: str, float_type: FloatType, output_path: str, progress=print) -> ModelSpec:
    """``source_dir`` (config.json and every *.safetensors file in it) ->
    the `.m` file ``output_path`` with matmul weights of ``float_type``."""
    with open(os.path.join(source_dir, "config.json")) as f:
        config = json.load(f)
    spec = spec_from_hf_config(config, float_type)

    files = sorted(
        os.path.join(source_dir, f)
        for f in os.listdir(source_dir)
        if f.endswith(".safetensors") and not f.startswith(".")
    )
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {source_dir}")
    src = _LazySafetensors(files)

    tied = config.get("tie_word_embeddings", False)
    with open(output_path, "wb") as out:
        writer = ModelFileWriter(out, spec)
        for m_name, hf_name, permute in hf_tensor_plan(spec):
            if m_name == "wcls" and tied:
                tensor = src.get("model.embed_tokens.weight")
            else:
                tensor = src.get(hf_name)
            if permute:
                heads = spec.n_heads if m_name.endswith(".q") else spec.n_kv_heads
                tensor = permute_qk(tensor, heads)
            progress(f"🔶 writing {m_name} {tuple(tensor.shape)}")
            writer.write_tensor(np.asarray(tensor, dtype=np.float32), m_name)
        writer.finish()
    return spec


def main(argv=None) -> None:
    import argparse

    from distributed_llama_tpu_torch.quants import parse_float_type

    p = argparse.ArgumentParser(prog="dllama-torch-convert-hf")
    p.add_argument("source", help="folder with config.json + *.safetensors")
    p.add_argument("float_type", help="f32 | f16 | q40 | q80")
    p.add_argument("name", help="output model name")
    args = p.parse_args(argv)
    out = f"dllama_model_{args.name}_{args.float_type}.m"
    convert_hf(args.source, parse_float_type(args.float_type), out)
    print(f"✅ {out} created successfully")


if __name__ == "__main__":
    main()
