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
of every expert (:mod:`parallel.sharding`'s MoE table). Under expert
parallelism each tp rank's list of experts is the ep ranks' whole experts
in rank order (rank j's the contiguous run [j*E/ep, (j+1)*E/ep)), so the
same load serves it; under sequence parallelism the params are the tensor
parallel ones, read by every sp rank.

In worker mode each process reads only what its ranks need
(:func:`read_share` states it, and ``reader.bytes_read`` counts it): its
tp ranks' shards (``ranks``) and, under ``--ep`` with the ep axis across
the processes, only its ep ranks' experts (``experts``). Its sp ranks
share their tp rank's tree, so a ``--sp`` process at tp = 1 reads the
whole file, as a JAX process of that mesh does.
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


# the matrices the tensor-parallel rule table cuts over tp (each rank reads
# 1/tp of their bytes); wcls too where the vocab divides, the rest whole
TP_CUT = ("q", "k", "v", "wo", "gate", "up", "down")


def read_share(reader: ModelFileReader, cfg: LlamaConfig, tp: int = 1, ranks=None, experts=None) -> int:
    """The `.m` bytes a :func:`load_params` of ``ranks`` (default all tp
    ranks) and ``experts`` (default all) reads, as the sum of the file
    entries it needs: each entry the rule table leaves whole once (the
    embedding, the norms, the routers; wcls where the vocab does not
    divide), each entry it cuts over tp (:data:`TP_CUT`, wcls where the
    vocab divides) times len(ranks)/tp, and of the experts' entries only
    those of ``experts``."""
    n_local = tp if ranks is None else len(ranks)
    total = 0
    for name, e in reader.entries.items():
        parts = name.split(".")
        if experts is not None and len(parts) > 3 and parts[2] == "experts" and int(parts[3]) not in experts:
            continue
        cut = tp > 1 and (parts[-1] in TP_CUT or (name == "wcls" and cfg.vocab_size % tp == 0))
        total += e.nbytes * n_local // tp if cut else e.nbytes
    return total


def load_params(reader: ModelFileReader, cfg: LlamaConfig | None = None, dtype=QUANTIZED_DTYPE,
                device="cuda", tp: int = 1, ep: int = 1, ranks=None, experts=None):
    """Build the params dict on ``device`` (the card unless "cpu" is
    asked for). ``dtype`` is "q40", torch.bfloat16 or torch.float32 for the
    matmul weights. ``tp`` > 1 returns one params dict per rank, each
    matmul leaf built from that rank's own byte ranges of the file as the
    rule table (:mod:`parallel.sharding`) cuts it: output shards are row
    ranges of each source matrix (a fused qkv shard is [q_s | k_s | v_s]),
    input shards quant-block-aligned column ranges, and wcls is
    vocab-sharded when the vocab divides. The replicated leaves are one
    tensor shared by every rank. ``ep`` > 1 (a MoE model whose expert count
    it divides) gives each ep rank whole experts, each still cut over tp:
    the tp ranks' expert lists and banks in expert order are exactly that
    (:func:`parallel.expert_parallel.rank_expert_leaves` takes rank j's
    run without a copy). ``ranks``: the global tp ranks this process holds
    (worker mode, :mod:`parallel.hosts`); only their byte ranges are read,
    each rank built exactly as the one-process load builds it, and the
    result is their list, in that order. ``experts``: the run of experts
    this process's ep ranks own (worker mode under ``--ep``); only their
    entries are read, and each rank's expert list (or bank) holds them
    alone, in order. The bytes read are :func:`read_share`'s."""
    from distributed_llama_tpu_torch.parallel import sharding
    from distributed_llama_tpu_torch.parallel.tensor_parallel import validate_tp

    device = resolve_device(device)
    cfg = cfg or config_from_spec(reader.spec)
    quantized = dtype == QUANTIZED_DTYPE
    validate_tp(cfg, tp, quantized=quantized)
    if ep > 1:
        from distributed_llama_tpu_torch.parallel.expert_parallel import validate_ep

        validate_ep(cfg, ep)
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
        """Layer l's router and rank s's slice of every expert (of
        ``experts``)."""
        names = [(e, f"layers.{l}.experts.{e}.") for e in (range(cfg.n_experts) if experts is None else experts)]
        leaves = {"router": routers[l]}
        if quantized:
            leaves["experts"] = [
                {"gate_up": matmul_leaf(f"layers/{l}/experts/{e}/gate_up", [ep + "gate", ep + "up"], s),
                 "down": matmul_leaf(f"layers/{l}/experts/{e}/down", [ep + "down"], s)}
                for e, ep in names]
        else:
            for leaf in ("up", "gate", "down"):
                leaves[f"moe_{leaf}"] = torch.stack(
                    [matmul_leaf(f"layers/{l}/moe_{leaf}", [ep + leaf], s, bank=True) for _, ep in names])
        return leaves

    wcls_full = matmul_leaf("wcls", ["wcls"], 0) if table.cut("wcls") is None else None
    built = []
    for s in range(tp) if ranks is None else ranks:
        if not 0 <= s < tp:
            raise ValueError(f"rank {s} outside tp={tp}")
        layers = [{**{leaf: matmul_leaf(f"layers/{l}/{leaf}", [f"layers.{l}.{n}" for n in srcs], s)
                      for leaf, srcs in fused.items()}, **norms[l], **(moe_leaves(l, s) if cfg.is_moe else {})}
                  for l in range(cfg.n_layers)]
        wcls = wcls_full if wcls_full is not None else matmul_leaf("wcls", ["wcls"], s)
        built.append({**shared, "layers": layers, "wcls": wcls})
    return built if tp > 1 or ranks is not None else built[0]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including the bfloat16 numpy dtype torch cannot
    read directly (moved through its 16-bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree, device="cuda", tp: int = 1, ep: int = 1):
    """The port's params on ``device`` (the card unless "cpu" is asked for)
    from the JAX package's ``load_params`` tree with every leaf as numpy and
    each ``QuantizedMatrix`` flattened by the caller into ``{"qs", "scales",
    "n", "d"}`` — so both packages compute the same function from the same
    bytes, and this package imports nothing of the JAX one. With ``tp`` > 1,
    ``tree`` is a list of one such tree per rank, each leaf the rank's shard
    of the JAX TP engine's placed array (its device's block along the mesh
    axis, or the whole array where it is replicated), and the result is the
    per-rank params list :func:`load_params` builds for that ``tp``. With
    ``ep`` > 1, ``tree`` is one tree per device of a JAX
    ``ExpertParallelForward``'s (tp, ep) mesh, device (t, j) at t*ep + j:
    each holds tp shard t of the dense leaves and ep rank j's whole experts
    (``experts_gate_up``/``experts_down`` flattened QuantizedMatrix dicts
    with a leading local-expert axis, or ``moe_*`` bank blocks); the ranks'
    experts are laid end to end in expert order, as :func:`load_params`
    builds them for ``tp`` and ``ep``."""
    device = resolve_device(device)
    if ep > 1:
        if len(tree) != tp * ep:
            raise ValueError(f"{len(tree)} device trees for tp={tp} x ep={ep}")
        ranks = [_join_expert_blocks(tree[t * ep : (t + 1) * ep]) for t in range(tp)]
        return params_from_jax(ranks if tp > 1 else ranks[0], device, tp)
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


def _join_expert_blocks(blocks: list):
    """One tp rank's tree from its ep devices' trees: the first device's
    dense leaves, and every layer's experts joined in rank order (each
    stacked q40 block split into per-expert leaves, the f32/bf16 bank blocks
    concatenated)."""
    def split(m: dict) -> list:
        # logical dims from the packed ones: the EP packs carry no padding
        qs, scales = np.asarray(m["qs"]), np.asarray(m["scales"])
        return [{"qs": q, "scales": sc, "n": qs.shape[-2] * 2, "d": qs.shape[-1]} for q, sc in zip(qs, scales)]

    out = dict(blocks[0], layers=[])
    for l, lp in enumerate(blocks[0]["layers"]):
        lp = dict(lp)
        ranks = [b["layers"][l] for b in blocks]
        if "experts_gate_up" in lp:
            del lp["experts_gate_up"], lp["experts_down"]
            lp["experts"] = [{"gate_up": g, "down": d} for r in ranks
                             for g, d in zip(split(r["experts_gate_up"]), split(r["experts_down"]))]
        for name in ("moe_up", "moe_gate", "moe_down"):
            if name in lp:
                lp[name] = np.concatenate([np.asarray(r[name]) for r in ranks])
        out["layers"].append(lp)
    return out
