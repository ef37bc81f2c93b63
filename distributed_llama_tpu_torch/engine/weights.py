"""Load `.m` weights into the params dict the model functions consume.

Matrices are stored in x@W orientation ([d_in, d_out]); layers stay a list
of per-layer dicts. With ``dtype="q40"`` the attention/FFN/wcls matrices stay
packed 4-bit (:class:`ops.q40.QuantizedMatrix`), q|k|v and gate|up fused as
one matmul each (the file's row-major blocks concatenate exactly), and the
repack runs with torch ops on the target device. Embeddings and norm
weights stay f32.

MoE layers (Mixtral, Grok-1) hold a ``router`` [dim, E] and, for q40, an
``experts`` list of per-expert ``{"gate_up", "down"}`` Q40 leaves, else
stacked ``moe_up``/``moe_gate``/``moe_down`` banks [E, d_in, d_out] of the
weight dtype. The router is read in f32 and stored in the weight dtype
(bf16 under q40), as the JAX package stores it; it is multiplied in f32.
Grok-1 layers add the ``rms_moe`` and ``rms_ffn2`` norms. Under tensor
parallelism the router is replicated and every rank holds a hidden slice
of every expert (:mod:`parallel.sharding`'s MoE table).
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


def load_params(reader: ModelFileReader, cfg: LlamaConfig | None = None, dtype=QUANTIZED_DTYPE,
                device="cuda", tp: int = 1):
    """Build the params dict on ``device`` (the card unless "cpu" is
    asked for). ``dtype`` is "q40", torch.bfloat16 or torch.float32 for the
    matmul weights. ``tp`` > 1 returns one params dict per rank, each
    matmul leaf built from that rank's own byte ranges of the file as the
    rule table (:mod:`parallel.sharding`) cuts it: output shards are row
    ranges of each source matrix (a fused qkv shard is [q_s | k_s | v_s]),
    input shards quant-block-aligned column ranges, and wcls is
    vocab-sharded when the vocab divides. The replicated leaves are one
    tensor shared by every rank."""
    from distributed_llama_tpu_torch.parallel import sharding
    from distributed_llama_tpu_torch.parallel.tensor_parallel import validate_tp

    device = resolve_device(device)
    cfg = cfg or config_from_spec(reader.spec)
    quantized = dtype == QUANTIZED_DTYPE
    validate_tp(cfg, tp, quantized=quantized)
    table = sharding.param_rules("q40" if quantized else "layered", shard_vocab=cfg.vocab_size % tp == 0,
                                 moe=cfg.is_moe)

    def f32(name: str) -> torch.Tensor:
        return torch.from_numpy(reader.tensor(name)).to(device)

    def matmul_leaf(path: str, names: list[str], s: int, bank: bool = False):
        """Rank s's leaf ``path`` of the file matrices ``names`` (several
        share an input dim and pack as ONE matmul, their output dims
        concatenated), in x@W orientation: a QuantizedMatrix for q40, else
        a [d_in, d_out] tensor of ``dtype``. ``bank``: one expert's matrix
        of the stacked bank ``path``, cut as the bank's matmul dims are."""
        entries = [reader.entries[n] for n in names]
        cut = table.cut(path)
        if bank and cut is not None:
            cut -= sharding.BANK_OUT - sharding.OUT  # the bank's leading expert axis
        if cut == sharding.IN:
            (name,), (e,) = names, entries
            d_out, d_in = e.shape
            lo, hi = d_in * s // tp, d_in * (s + 1) // tp
            if quantized and e.float_type == FloatType.Q40:
                return pack_q40_raw(reader.raw_row_blocks(name, lo, hi).reshape(-1), (d_out, hi - lo), device)
            w = reader.tensor_cols(name, lo, hi).T
        else:  # an output shard, or the whole matrix where the table replicates it
            parts, s = (1, 0) if cut is None else (tp, s)
            bounds = [(e.shape[0] * s // parts, e.shape[0] * (s + 1) // parts) for e in entries]
            if quantized and all(e.float_type == FloatType.Q40 for e in entries):
                raw = np.concatenate([reader.raw_rows(n, lo, hi) for n, (lo, hi) in zip(names, bounds)])
                return pack_q40_raw(raw, (sum(hi - lo for lo, hi in bounds), entries[0].shape[1]), device)
            w = np.concatenate([reader.tensor_rows(n, lo, hi).T for n, (lo, hi) in zip(names, bounds)], axis=1)
        if quantized:
            return quantize_q40_tpu(np.ascontiguousarray(w), device)
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=device, dtype=dtype)

    shared = {"embedding": f32("embedding"), "rms_final": f32("rms_final"),
              "rope_table": torch.from_numpy(build_rope_table(cfg)).to(device)}
    norm_names = ("rms_att", "rms_ffn") + (("rms_moe", "rms_ffn2") if cfg.arch == ArchType.GROK1 else ())
    norms = [{n: f32(f"layers.{l}.{n}") for n in norm_names} for l in range(cfg.n_layers)]
    fused = {"qkv": ("q", "k", "v"), "wo": ("wo",)}
    if not cfg.is_moe:
        fused.update({"gate_up": ("gate", "up"), "down": ("down",)})
    if not quantized:
        fused = {n: (n,) for n in ("q", "k", "v", "wo") + (() if cfg.is_moe else ("gate", "down", "up"))}

    def router(l: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(reader.tensor(f"layers.{l}.moe_router").T)).to(
            device=device, dtype=torch.bfloat16 if quantized else dtype)

    # the replicated routers: one tensor per layer that every rank reads
    routers = [router(l) for l in range(cfg.n_layers)] if cfg.is_moe else []

    def moe_leaves(l: int, s: int) -> Params:
        """Layer l's router and rank s's slice of every expert."""
        experts = [f"layers.{l}.experts.{e}." for e in range(cfg.n_experts)]
        leaves = {"router": routers[l]}
        if quantized:
            leaves["experts"] = [
                {"gate_up": matmul_leaf(f"layers/{l}/experts/{e}/gate_up", [ep + "gate", ep + "up"], s),
                 "down": matmul_leaf(f"layers/{l}/experts/{e}/down", [ep + "down"], s)}
                for e, ep in enumerate(experts)]
        else:
            for leaf in ("up", "gate", "down"):
                leaves[f"moe_{leaf}"] = torch.stack(
                    [matmul_leaf(f"layers/{l}/moe_{leaf}", [ep + leaf], s, bank=True) for ep in experts])
        return leaves

    wcls_full = matmul_leaf("wcls", ["wcls"], 0) if table.cut("wcls") is None else None
    ranks = []
    for s in range(tp):
        layers = [{**{leaf: matmul_leaf(f"layers/{l}/{leaf}", [f"layers.{l}.{n}" for n in srcs], s)
                      for leaf, srcs in fused.items()}, **norms[l], **(moe_leaves(l, s) if cfg.is_moe else {})}
                  for l in range(cfg.n_layers)]
        wcls = wcls_full if wcls_full is not None else matmul_leaf("wcls", ["wcls"], s)
        ranks.append({**shared, "layers": layers, "wcls": wcls})
    return ranks if tp > 1 else ranks[0]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including the bfloat16 numpy dtype torch cannot
    read directly (moved through its 16-bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree, device="cuda", tp: int = 1):
    """The port's params on ``device`` (the card unless "cpu" is asked for)
    from the JAX package's ``load_params`` tree with every leaf as numpy and
    each ``QuantizedMatrix`` flattened by the caller into ``{"qs", "scales",
    "n", "d"}`` — so both packages compute the same function from the same
    bytes, and this package imports nothing of the JAX one. With ``tp`` > 1,
    ``tree`` is a list of one such tree per rank, each leaf the rank's shard
    of the JAX TP engine's placed array (its device's block along the mesh
    axis, or the whole array where it is replicated), and the result is the
    per-rank params list :func:`load_params` builds for that ``tp``."""
    device = resolve_device(device)
    if tp > 1:
        if len(tree) != tp:
            raise ValueError(f"{len(tree)} rank trees for tp={tp}")
        return [params_from_jax(t, device) for t in tree]

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
