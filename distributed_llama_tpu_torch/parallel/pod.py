"""One-process pod serving: ``data`` replica slices over one shared params
tree, each slice ``model`` tensor-parallel ranks.

The port's copy of the JAX package's ``parallel/pod.py``. A replica pool of
``--tp`` engines holds one full weight tree per replica; a pod holds ONE
per-rank params tree that every slice's engine reads, so N replicas cost
one tree of card memory instead of N. Each slice is still its own failure
domain: its own :class:`~distributed_llama_tpu_torch.engine.batch.
BatchScheduler` (slab, page pool, lanes) behind the replica pool, with the
same health ladder, placement, failover replay and restart supervision. A
dead slice is rebuilt from the group (:meth:`PodGroup.slice_engine`: a new
engine, scheduler and lanes over the same params object), so a rebuild
never reloads weights and its checksum gate reads the same bytes.

Where the JAX package lays the pod out as a ('data', 'model') mesh of
``data x model`` chips, the port places every rank of every slice on the
one card that ``device`` names, as ``--tp`` does: the slices share the
backend (:class:`PodForward`, a :class:`~distributed_llama_tpu_torch.
parallel.tensor_parallel.TensorParallelForward` over the ``model`` ranks)
and its dispatch lock, so their launches issue one at a time. Each slice
keeps its own slab, so no slab axis is cut across slices and the row
bucket floor stays 1. A pod over several cards raises
NotImplementedError (ROADMAP.md Queue 1: ranks on several cards).
"""

from __future__ import annotations

import re

import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops import collectives
from distributed_llama_tpu_torch.parallel.tensor_parallel import TensorParallelForward

DATA_AXIS = "data"
MODEL_AXIS = "model"


def parse_pod(spec: str) -> tuple[int, int]:
    """``--pod DATAxMODEL`` (e.g. ``2x2``) -> (data, model)."""
    m = re.fullmatch(r"(\d+)\s*[xX*]\s*(\d+)", str(spec).strip())
    if not m:
        raise ValueError(f"--pod wants DATAxMODEL (e.g. 2x2), got {spec!r}")
    data, model = int(m.group(1)), int(m.group(2))
    if data < 1 or model < 1:
        raise ValueError(f"--pod axes must be >= 1, got {data}x{model}")
    return data, model


class PodForward(TensorParallelForward):
    """The tensor-parallel backend every slice of a pod shares: ``model``
    ranks on one card, with the pod's ``data`` extent recorded for the
    mesh gauges. ``devices`` naming several cards raises
    NotImplementedError."""

    def __init__(self, cfg: LlamaConfig, data: int, model: int, device="cuda", quantized: bool = False,
                 allreduce: str = "psum", devices=None):
        if devices is not None and len({str(torch.device(d)) for d in devices}) > 1:
            raise NotImplementedError("a pod over several cards is not ported yet: " + collectives.SEVERAL_CARDS)
        if devices is not None:
            device, devices = devices[0], None
        self.data = data
        super().__init__(cfg, model, device=device, quantized=quantized, allreduce=allreduce, devices=devices)

    @property
    def mesh_shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.tp}


def _unique_tensors(params):
    """Every tensor of a params tree once (a replicated leaf that the ranks
    share is one tensor)."""
    from distributed_llama_tpu_torch.engine.integrity import _leaves

    seen: dict = {}
    for _, t in _leaves(params):
        seen.setdefault(id(t), t)
    return list(seen.values())


def tree_weight_bytes(params) -> int:
    """Resident bytes of a params tree (a QuantizedMatrix counts its packed
    nibbles and scales; a leaf the ranks share counts once). For a pod this
    is the ONE shared tree; a replica pool of N engines holds N trees of
    this size."""
    return sum(t.numel() * t.element_size() for t in _unique_tensors(params))


def max_device_weight_bytes(params_trees) -> int:
    """Weight bytes on the most-loaded device across one or more params
    trees, each distinct storage counted once: a replica pool shows its N
    trees stacked on the card, a pod one tree."""
    per_device: dict = {}
    seen: set = set()
    for params in params_trees:
        for t in _unique_tensors(params):
            key = (t.device, t.untyped_storage().data_ptr())
            if key in seen:
                continue
            seen.add(key)
            per_device[t.device] = per_device.get(t.device, 0) + t.untyped_storage().nbytes()
    return max(per_device.values(), default=0)


class PodGroup:
    """One pod's shared substrate: the backend, the ONE per-rank params tree,
    and the engine factory that the serving layer's replica builds (and
    rebuilds, after a slice dies) draw slices from. Every engine this hands
    out shares ``backend`` and ``params``; slab, page pool, caches,
    scheduler and lanes stay per engine, the failure domain the replica
    pool supervises."""

    def __init__(self, cfg: LlamaConfig, backend: PodForward, params: list, cache_dtype=torch.bfloat16, spec=None,
                 dtype="q40", q40_path: str = "int8"):
        self.cfg = cfg
        self.backend = backend
        self.params = params
        self.cache_dtype = cache_dtype
        self.spec = spec
        self.dtype = dtype  # the load dtype, so sibling() loads alike
        self.q40_path = q40_path
        self.data = backend.data
        self.model = backend.tp
        self.weight_bytes = tree_weight_bytes(params)
        self._note_telemetry()

    @staticmethod
    def _load(reader, cfg: LlamaConfig, dtype, model: int, device) -> list:
        """The per-rank params of ``model`` ranks (a list even for one)."""
        from distributed_llama_tpu_torch.engine import weights as weights_lib

        params = weights_lib.load_params(reader, cfg, dtype=dtype, device=device, tp=model)
        return params if model > 1 else [params]

    @classmethod
    def build(cls, model_path: str, data: int, model: int, dtype="q40", max_seq_len: int | None = None,
              cache_dtype=None, device="cuda", q40_path: str = "int8", allreduce: str = "psum", devices=None,
              **cfg_overrides) -> "PodGroup":
        """Load the model ONCE, each rank's shards from its own byte ranges
        of the file (as ``--tp`` loads them), for every slice of the pod;
        a replica pool of N engines loads N copies."""
        from distributed_llama_tpu_torch.engine import weights as weights_lib
        from distributed_llama_tpu_torch.formats.model_file import ModelFileReader
        from distributed_llama_tpu_torch.models.config import config_from_spec

        quantized = dtype == weights_lib.QUANTIZED_DTYPE
        reader = ModelFileReader(model_path)
        spec = reader.spec.clamp_seq_len(max_seq_len)
        cfg = config_from_spec(spec, **cfg_overrides)
        if cache_dtype is None:
            cache_dtype = torch.bfloat16 if quantized else dtype
        backend = PodForward(cfg, data, model, device=device, quantized=quantized, allreduce=allreduce,
                             devices=devices)
        params = cls._load(reader, cfg, dtype, model, backend.devices[0])
        reader.close()
        return cls(cfg, backend, params, cache_dtype=cache_dtype, spec=spec, dtype=dtype, q40_path=q40_path)

    def sibling(self, model_path: str) -> "PodGroup":
        """A second group over the SAME backend with another weight file
        placed as a second params tree: the pod's blue-green rollout.
        Slices cut over through the sibling's :meth:`slice_engine`, and the
        old tree is freed when the serving layer drops the old group (the
        old version's factory) at the rollout's end. The file must match
        the serving configuration."""
        return self.loader()(model_path)

    def loader(self):
        """``path -> PodGroup``: :meth:`sibling` as a function that holds
        the backend and the load settings but not this group's params, so
        the serving layer's path loader never keeps a retired tree."""
        cfg, backend, model = self.cfg, self.backend, self.model
        kw = dict(cache_dtype=self.cache_dtype, spec=self.spec, dtype=self.dtype, q40_path=self.q40_path)

        def load(model_path: str) -> "PodGroup":
            from distributed_llama_tpu_torch.formats.model_file import ModelFileReader

            reader = ModelFileReader(model_path)
            params = PodGroup._load(reader, cfg, kw["dtype"], model, backend.devices[0])
            reader.close()
            return PodGroup(cfg, backend, params, **kw)

        return load

    def slice_engine(self):
        """A fresh slice engine over the shared backend and params: what a
        replica build (or rebuild) costs under the pod, never a weight
        reload."""
        from distributed_llama_tpu_torch.engine.engine import InferenceEngine

        return InferenceEngine.from_backend(self.cfg, self.backend, self.params, cache_dtype=self.cache_dtype,
                                            spec=self.spec, q40_path=self.q40_path)

    def __call__(self):
        """The zero-argument engine factory surface of ``ApiState``."""
        return self.slice_engine()

    def resident_weight_bytes_per_replica(self) -> int:
        """The one shared tree's bytes attributed across the ``data``
        slices (a replica pool's figure is the whole tree per replica)."""
        return self.weight_bytes // max(1, self.data)

    def _note_telemetry(self) -> None:
        tel = telemetry.MeshInstruments()
        if tel.enabled:
            tel.mesh_devices.labels(axis=DATA_AXIS).set(self.data)
            tel.mesh_devices.labels(axis=MODEL_AXIS).set(self.model)
            tel.resident_weight_bytes.labels(group="pod").set(self.weight_bytes)
            tel.resident_weight_bytes.labels(group="per_replica").set(self.resident_weight_bytes_per_replica())
