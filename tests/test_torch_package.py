"""Import and placement rules of the PyTorch port.

The port imports torch and never jax, and nothing of the JAX package; its
entry points run on the card unless the caller asks for the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_llama_tpu_torch
from distributed_llama_tpu_torch import platform
from distributed_llama_tpu_torch.apps import cli
from distributed_llama_tpu_torch.engine import InferenceEngine, weights
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.formats import synthetic
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader
from distributed_llama_tpu_torch.server import api as server_api

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(Path(distributed_llama_tpu_torch.__file__).parent.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# imported nowhere in the port (the card machine has neither safetensors
# nor transformers; the converters read the safetensors format themselves)
FORBIDDEN = ("jax", "jaxlib", "distributed_llama_tpu", "safetensors", "transformers")
# imported only inside the function that needs it, as in the JAX package
LAZY_ONLY = ("sentencepiece",)


def _imported_modules(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body if top_level_only else ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"
    for mod in _imported_modules(path, top_level_only=True):
        assert mod.split(".")[0] not in LAZY_ONLY, f"{path.name} imports {mod} when it is imported"


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("quants", "formats/model_file", "formats/tokenizer_file", "tokenizer",
                "models/config", "ops/q40", "models/rope", "ops/kv_cache", "ops/attention",
                "models/llama", "engine/weights", "prng", "models/sampling", "engine/engine",
                "apps/cli", "engine/integrity", "engine/prefix_cache", "engine/batch", "server/api",
                "engine/speculative", "ops/collectives", "parallel/__init__", "parallel/sharding",
                "parallel/tensor_parallel", "stats", "telemetry/__init__", "telemetry/registry",
                "telemetry/tracer", "telemetry/spans", "telemetry/trace", "telemetry/dump", "loadgen/__init__",
                "loadgen/__main__", "loadgen/workload", "loadgen/runner", "loadgen/report", "loadgen/selfhost",
                "retry", "engine/faults", "server/admission", "engine/spill", "server/replicas",
                "telemetry/flight", "lockcheck", "converter/__init__", "converter/hf", "converter/tokenizers",
                "converter/pth", "converter/launch", "native", "analysis/__init__", "analysis/__main__",
                "analysis/config", "analysis/engine", "analysis/rules/__init__"):
        assert f"distributed_llama_tpu_torch/{mod}.py" in names
    for src in ("q40_int8.cu", "q40_int8_tile.cuh", "q40_dequant.cu", "paged_attention.cu", "ring_all_reduce.cu",
                "fused_matmul_ring.cu"):
        assert (ROOT / "distributed_llama_tpu_torch" / "csrc" / src).is_file()
    for src in ("bpe_native.cpp", "q40_native.cpp"):
        assert (ROOT / "distributed_llama_tpu_torch" / "csrc" / "host" / src).is_file()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pkg")
    spec = synthetic.tiny_spec(dim=64, hidden_dim=128, vocab_size=512, seq_len=32)
    model = synthetic.write_synthetic_model(str(d / "m.m"), spec)
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file

    with open(d / "t.t", "wb") as f:
        write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=512))
    return model, str(d / "t.t")


def test_entry_points_default_to_the_card(no_cuda, tiny_files):
    model, tok = tiny_files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, dtype="q40")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load_params(ModelFileReader(model), dtype="q40")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.params_from_jax({"embedding": np.zeros((4, 8), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--model", model, "--tokenizer", tok, "--prompt", "hi"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_api.main(["--model", model, "--tokenizer", tok, "--port", "0"])
    args = server_api.build_parser().parse_args(["generate", "--model", model, "--tokenizer", tok])
    assert (args.device, args.parallel, args.batch_decode, args.prefix_cache) == ("cuda", 2, True, True)


def test_cpu_only_when_asked(no_cuda, tiny_files):
    model, tok = tiny_files
    engine = InferenceEngine(model, dtype="q40", device="cpu")
    assert engine.device.type == "cpu"
    assert engine.params["embedding"].device.type == "cpu"
    params = weights.params_from_jax({"embedding": np.zeros((4, 8), np.float32)}, device="cpu")
    assert params["embedding"].device.type == "cpu"
    out = cli.main(["generate", "--model", model, "--tokenizer", tok, "--prompt", "hi",
                    "--device", "cpu", "--steps", "6", "--temperature", "0"])
    assert all(0 <= t < 512 for t in out["tokens"])
    sched = BatchScheduler(engine, n_rows=2, prefix_cache=True, page_size=8)
    assert sched._slab[0].device.type == "cpu" and sched._pool[0][0].device.type == "cpu"
