"""Meta ``consolidated.*.pth`` checkpoint -> `.m` (the official Llama 1/2/3 format).

The port's copy of the JAX package's ``converter/pth.py``: shards are
concatenated on axis 1 for the embedding, wo and w2 and on axis 0 for every
other matrix, the work goes in chunks of tensors to bound peak RAM, and
``hidden_dim`` is the first shard's w1 rows times the shard count. Shards
are read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from distributed_llama_tpu_torch.formats.model_file import (
    ArchType,
    HiddenAct,
    ModelFileWriter,
    ModelSpec,
)
from distributed_llama_tpu_torch.quants import FloatType

LAYER_CHUNK_SIZE = 48

# axis-1 concat (the tensor is sharded on its second dim in the checkpoint)
_AXIS1_SUFFIXES = ("tok_embeddings.weight", "attention.wo.weight", "feed_forward.w2.weight")


def _meta_layer_names(n_layers: int) -> list[str]:
    names = ["tok_embeddings.weight"]
    for l in range(n_layers):
        names += [
            f"layers.{l}.attention.wq.weight",
            f"layers.{l}.attention.wk.weight",
            f"layers.{l}.attention.wv.weight",
            f"layers.{l}.attention.wo.weight",
            f"layers.{l}.feed_forward.w1.weight",
            f"layers.{l}.feed_forward.w2.weight",
            f"layers.{l}.feed_forward.w3.weight",
            f"layers.{l}.attention_norm.weight",
            f"layers.{l}.ffn_norm.weight",
        ]
    names += ["norm.weight", "output.weight"]
    return names


_META_TO_M = {
    "tok_embeddings.weight": "embedding",
    "attention.wq.weight": "q",
    "attention.wk.weight": "k",
    "attention.wv.weight": "v",
    "attention.wo.weight": "wo",
    "feed_forward.w1.weight": "gate",
    "feed_forward.w2.weight": "down",
    "feed_forward.w3.weight": "up",
    "attention_norm.weight": "rms_att",
    "ffn_norm.weight": "rms_ffn",
    "norm.weight": "rms_final",
    "output.weight": "wcls",
}


def _m_name(meta_name: str) -> str:
    if meta_name.startswith("layers."):
        _, l, rest = meta_name.split(".", 2)
        return f"layers.{l}.{_META_TO_M[rest]}"
    return _META_TO_M[meta_name]


def convert_meta_pth(model_dir: str, float_type: FloatType, output_path: str, progress=print) -> ModelSpec:
    """``model_dir`` (params.json + consolidated.*.pth) -> the `.m` file
    ``output_path`` with matmul weights of ``float_type``."""
    with open(os.path.join(model_dir, "params.json")) as f:
        params = json.load(f)
    if params.get("vocab_size", -1) < 1:
        raise ValueError("vocab_size is invalid, please update params.json")
    if params.get("max_seq_len") is None:
        raise ValueError("max_seq_len is required, please update params.json")

    shard_paths = sorted(Path(model_dir).glob("consolidated.*.pth"))
    if not shard_paths:
        raise FileNotFoundError(f"no consolidated.*.pth in {model_dir}")

    first = torch.load(shard_paths[0], map_location="cpu", weights_only=True)
    hidden_dim = first["layers.0.feed_forward.w1.weight"].shape[0] * len(shard_paths)
    del first

    spec = ModelSpec(
        arch_type=ArchType.LLAMA,
        dim=params["dim"],
        hidden_dim=hidden_dim,
        n_layers=params["n_layers"],
        n_heads=params["n_heads"],
        n_kv_heads=params.get("n_kv_heads") or params["n_heads"],
        vocab_size=params["vocab_size"],
        seq_len=params["max_seq_len"],
        hidden_act=HiddenAct.SILU,
        rope_theta=float(params.get("rope_theta", 10000.0)),
        weights_float_type=float_type,
    )

    names = _meta_layer_names(spec.n_layers)
    with open(output_path, "wb") as out:
        writer = ModelFileWriter(out, spec)
        n_chunks = math.ceil(len(names) / LAYER_CHUNK_SIZE)
        for ci in range(n_chunks):
            chunk = names[ci * LAYER_CHUNK_SIZE : (ci + 1) * LAYER_CHUNK_SIZE]
            gathered: dict[str, list] = {n: [] for n in chunk}
            progress(f"💿 chunk {ci + 1}/{n_chunks}")
            for sp in shard_paths:
                shard = torch.load(sp, map_location="cpu", weights_only=True)
                for n in chunk:
                    if n in shard:
                        gathered[n].append(shard[n])
                del shard
            for n in chunk:
                tensors = gathered[n]
                if len(tensors) == 1 or tensors[0].ndim == 1:
                    merged = tensors[0]
                else:
                    axis = 1 if n.endswith(_AXIS1_SUFFIXES) else 0
                    merged = torch.cat(tensors, dim=axis)
                progress(f"🔶 writing {_m_name(n)} {tuple(merged.shape)}")
                writer.write_tensor(np.asarray(merged.to(torch.float32).numpy()), _m_name(n))
        writer.finish()
    return spec


def main(argv=None) -> None:
    import argparse

    from distributed_llama_tpu_torch.quants import parse_float_type

    p = argparse.ArgumentParser(prog="dllama-torch-convert-pth")
    p.add_argument("model_dir")
    p.add_argument("float_type")
    args = p.parse_args(argv)
    name = os.path.basename(os.path.normpath(args.model_dir)).lower()
    out = f"dllama_model_{name}_{args.float_type}.m"
    convert_meta_pth(args.model_dir, parse_float_type(args.float_type), out)
    print(f"✅ {out} created successfully")


if __name__ == "__main__":
    main()
