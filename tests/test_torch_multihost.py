"""The port's worker mode held against its one-process tensor parallelism
and the JAX package's: two processes, each a host of the group
(:mod:`distributed_llama_tpu_torch.parallel.hosts`, gloo on the CPU), run
the CLI's ``worker`` mode at ``--tp 2`` on the JAX multi-host test's tiny
spec (``tests/test_multihost.py``: dim 128, hidden 256, 2 layers, 4 heads,
vocab 128, random weights of seed 9), Q40 and f32 files.

* Both processes print the same token ids; they equal the port's
  one-process ``--tp 2`` run of the same flags (``psum`` and ``ring``) and
  the JAX ``TensorParallelForward(tp=2)`` on the 8-device CPU mesh, driven
  as the JAX test's worker script drives it; each process reads under 0.8
  of the weight bytes.
* The all-reduce seam over two processes (one rank each at tp 2, two at tp
  4) gives every arm's one-process bytes bit for bit, and the all-gather
  the one-process concatenation.
* A tiny Mixtral's expert ids and tokens equal the one-process ``--tp 2``.
* Without ``--seed``, host 0's seed is every host's: sampled streams agree.
* A transfer-probe fault on one host raises on both, well inside the
  group's timeout (no host issues a collective alone).

The two processes start once for the module (``tests/torch_multihost_worker.py``,
every job in a group of its own), with one torch thread each, and are
killed if they outlive ``WORKER_TIMEOUT_S``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import weights as jweights
from distributed_llama_tpu.formats.model_file import ModelFileReader as JaxReader
from distributed_llama_tpu.models.config import config_from_spec as jconfig_from_spec
from distributed_llama_tpu.parallel.tensor_parallel import TensorParallelForward as JaxTP

from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader as TorchReader
from distributed_llama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer_file
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import moe as tmoe
from distributed_llama_tpu_torch.ops import collectives as coll
from distributed_llama_tpu_torch.ops import q40 as tq
from distributed_llama_tpu_torch.parallel import hosts as thosts
from distributed_llama_tpu_torch.platform import resolve_device
from distributed_llama_tpu_torch.quants import FloatType
from distributed_llama_tpu_torch.tokenizer import Tokenizer
from tests.model_utils import random_tensors, tiny_spec, write_model_file
from tests.torch_multihost_worker import seam_partials

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_multihost_worker.py"
WORKER_TIMEOUT_S = 150
SPEC = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=4, vocab_size=128, seq_len=32)
PROMPT = "hello world, hello"
STEPS = 16
SEAM_SHAPES = {2: [(1, 64), (3, 100), (2, 5)], 4: [(1, 64), (3, 100)]}
ARMS = [("q40", "psum"), ("q40", "ring"), ("f32", "psum"), ("f32", "ring")]
CLOCK_SEEDS = [1234, 98765]  # each host's stand-in for its wall-clock seed
FAULT_LEAVE_S = 20.0  # a third of the group's timeout: leaving on a fault did not wait it out


def tokenizer_data(vocab_size: int = SPEC["vocab_size"]) -> TokenizerData:
    """A 128-piece vocab (the spec's): single letters, a few merges and
    fillers, no byte fallback (the prompts use only its letters)."""
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([c]) for c in b" abcdefghijklmnopqrstuvwxyz,."]
    scores = [0.0] * 3 + [-1.0] * 29
    for i, piece in enumerate((b"he", b"ll", b"hell", b"hello", b" hello", b"wo", b"wor", b"worl", b"world",
                               b" world")):
        vocab.append(piece)
        scores.append(-2.0 - i)
    for i in range(vocab_size - len(vocab)):
        vocab.append(f" t{i}".encode())
        scores.append(-100.0 - i)
    return TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2, chat_eos_id=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    out = {"tok": str(d / "tok.t")}
    with open(out["tok"], "wb") as f:
        write_tokenizer_file(f, tokenizer_data())
    for name, wt in (("q40", FloatType.Q40), ("f32", FloatType.F32)):
        spec = tiny_spec(**SPEC, weights_float_type=wt)
        out[name] = str(d / f"mh_{name}.m")
        write_model_file(out[name], spec, random_tensors(spec, seed=9))
    out["mixtral"] = str(d / "mixtral.m")
    tsyn.write_synthetic_model(out["mixtral"], tsyn.tiny_spec(
        arch_type=tsyn.ArchType.MIXTRAL, n_experts=4, n_active_experts=2, **SPEC,
        weights_float_type=FloatType.Q40), seed=4)
    return out


def _flags(files, dtype: str, allreduce: str, model: str | None = None, seed=("--seed", "3"),
           temperature: str = "0") -> list:
    return ["--model", files[model or dtype], "--tokenizer", files["tok"], "--prompt", PROMPT, "--steps", str(STEPS),
            "--device", "cpu", "--dtype", dtype, "--temperature", temperature, *seed, "--tp", "2",
            "--allreduce", allreduce, "--decode-chunk", "4"]


def _worker_argv(flags: list) -> list:
    # the worker adds --coordinator (picked as the job starts) and --host-id
    return ["worker", *flags, "--num-hosts", "2"]


JOBS = {}  # job name -> index in the workers' job list


@pytest.fixture(scope="module")
def workers(files, tmp_path_factory):
    """Every job's result on each host: {name: [host 0's, host 1's]}."""
    jobs = []

    def add(name, job):
        JOBS[name] = len(jobs)
        jobs.append(job)

    for tp in SEAM_SHAPES:
        add(f"seam{tp}", {"kind": "seam", "num_hosts": 2, "tp": tp, "shapes": SEAM_SHAPES[tp], "seed": tp})
    for dtype, allreduce in ARMS:
        add(f"{dtype}/{allreduce}", {"kind": "cli", "argv": _worker_argv(_flags(files, dtype, allreduce))})
    add("mixtral", {"kind": "cli", "record_ids": True,
                    "argv": _worker_argv(_flags(files, "q40", "ring", model="mixtral"))})
    add("sampled", {"kind": "cli", "clock_seeds": CLOCK_SEEDS,
                    "argv": _worker_argv(_flags(files, "q40", "psum", seed=(), temperature="0.8"))})
    # last: a fault leaves its group on an error, without the closing barrier
    add("probe_fault", {"kind": "cli", "fault": {"host": 1, "spec": "tp.transfer:kind=raise,count=1"},
                        "argv": _worker_argv(_flags(files, "q40", "ring"))})
    path = tmp_path_factory.mktemp("torch_multihost_jobs") / "jobs.json"
    path.write_text(json.dumps(jobs))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # each host's output to a file: a full pipe would stall a host mid-job
    logs = [(path.with_suffix(f".{h}.out"), path.with_suffix(f".{h}.err")) for h in (0, 1)]
    procs = []
    for h, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen([sys.executable, str(WORKER), str(path), str(h)], env=env, cwd=str(REPO),
                                          stdout=fo, stderr=fe))
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for h, (p, (out, err)) in enumerate(zip(procs, logs)):
        out, err = out.read_text(), err.read_text()
        assert p.returncode == 0, f"host {h} failed:\n{err[-4000:]}"
        lines = [json.loads(ln[len("RESULT "):]) for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == len(jobs), out[-2000:]
        results.append(lines)
    return {name: [results[0][i], results[1][i]] for name, i in JOBS.items()}


def _one_process(flags: list, capsys) -> dict:
    res = tcli.main(["generate", *flags])
    capsys.readouterr()
    return res


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,allreduce", ARMS)
def test_worker_streams_equal_each_other_and_one_process(workers, files, dtype, allreduce, capsys):
    h0, h1 = workers[f"{dtype}/{allreduce}"]
    assert h0["tokens"] == h1["tokens"] and len(h0["tokens"]) > 4
    assert h0["tokens"] == _one_process(_flags(files, dtype, allreduce), capsys)["tokens"]


@pytest.fixture(scope="module")
def jax_tokens(files):
    """The JAX TP engine's greedy tokens on each file, driven as the JAX
    multi-host test's worker script drives it (forward of the prompt,
    argmax, then ``decode_loop``), on the port's tokens of the prompt."""
    prompt = Tokenizer.from_file(files["tok"], SPEC["vocab_size"]).encode(PROMPT, add_bos=True)
    out = {}
    for name in ("q40", "f32"):
        reader = JaxReader(files[name])
        cfg = jconfig_from_spec(reader.spec)
        quantized = name == "q40"
        engine = JaxTP(cfg, 2, quantized=quantized, layered=True)
        params = jweights.load_params(reader, cfg, dtype="q40" if quantized else jnp.float32, tp=2, mesh=engine.mesh)
        reader.close()
        params = engine.shard_params(params)
        cache = engine.init_cache(jnp.bfloat16 if quantized else jnp.float32)
        logits, cache = engine.forward(params, np.asarray(prompt, np.int32), cache, np.int32(0))
        first = int(np.argmax(np.asarray(logits[-1])))
        tokens, _ = engine.decode_loop(params, np.int32(first), cache, np.int32(len(prompt)),
                                       STEPS - len(prompt), 0.0, 0.9, seed=0)
        out[name] = [first] + np.asarray(tokens).tolist()
    return out


@pytest.mark.parametrize("dtype", ["q40", "f32"])
def test_worker_streams_equal_jax_tp(workers, jax_tokens, dtype):
    for allreduce in ("psum", "ring"):
        got = workers[f"{dtype}/{allreduce}"][0]["tokens"]
        assert got == jax_tokens[dtype][: len(got)] and len(got) > 4


@pytest.mark.parametrize("dtype", ["q40", "f32"])
def test_each_worker_reads_under_its_share(workers, files, dtype):
    """Each process reads its rank's shards and the replicated leaves:
    under 0.8 of the weight bytes, the same on both hosts, and exactly what
    a ``ranks=[h]`` load reads in this process."""
    reader = TorchReader(files[dtype])
    total = sum(e.nbytes for e in reader.entries.values())
    cfg = tconfig.config_from_spec(reader.spec)
    tweights.load_params(reader, cfg, dtype="q40" if dtype == "q40" else torch.float32, device="cpu", tp=2,
                         ranks=[1])
    for h in workers[f"{dtype}/psum"]:
        assert h["bytes_read"] < 0.8 * total
        assert h["bytes_read"] == reader.bytes_read


# ---------------------------------------------------------------------------
# The seam over processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", sorted(SEAM_SHAPES))
def test_seam_over_processes_is_one_process_bit_for_bit(workers, tp):
    for i, partials in enumerate(seam_partials(tp, SEAM_SHAPES[tp], tp)):
        xs = [torch.from_numpy(p) for p in partials]
        gathered = coll.all_gather(xs)
        for h, res in enumerate(workers[f"seam{tp}"]):
            mine = range(h * tp // 2, (h + 1) * tp // 2)
            for impl in coll.IMPLS:
                want = coll.all_reduce(xs, impl)
                got = [torch.tensor(b, dtype=torch.int32).view(torch.float32) for b in res[f"{impl}/{i}"]]
                assert len(got) == len(mine)
                for r, g in zip(mine, got):
                    assert torch.equal(g.view(torch.int32), want[r].contiguous().view(torch.int32).reshape(-1)), \
                        (impl, i, h, r)
            got = torch.tensor(res[f"gather/{i}"], dtype=torch.int32)
            assert torch.equal(got, gathered.contiguous().view(torch.int32).reshape(-1))


# ---------------------------------------------------------------------------
# Mixtral, the sampling seed
# ---------------------------------------------------------------------------


def test_mixtral_worker_ids_and_tokens_equal_one_process(workers, files, capsys, monkeypatch):
    ids, orig = [], tmoe.router_topk

    def spy(cfg, xn, router):
        vals, idx = orig(cfg, xn, router)
        ids.append(idx.tolist())
        return vals, idx

    monkeypatch.setattr(tmoe, "router_topk", spy)
    want = _one_process(_flags(files, "q40", "ring", model="mixtral"), capsys)
    h0, h1 = workers["mixtral"]
    assert h0["ids"] == h1["ids"] == ids and len(ids) >= SPEC["n_layers"]
    assert h0["tokens"] == h1["tokens"] == want["tokens"]


def test_sampled_workers_share_host0_seed(workers, files, capsys):
    """At temperature 0.8 without --seed each host draws its own clock seed
    (here two different stand-ins); host 0's is broadcast, so both use it
    and sample the same stream, which host 1's own seed would not give."""
    h0, h1 = workers["sampled"]
    assert h0["seed"] == h1["seed"] == CLOCK_SEEDS[0]
    assert h0["tokens"] == h1["tokens"] and len(h0["tokens"]) > 4
    own = [_one_process(_flags(files, "q40", "psum", seed=("--seed", str(s)), temperature="0.8"), capsys)["tokens"]
           for s in CLOCK_SEEDS]
    assert h0["tokens"] == own[0] and own[1] != own[0]


def test_probe_fault_on_one_host_raises_on_both(workers):
    """The tp.transfer site fires on host 1 alone, in the probe at engine
    build: host 1 raises the injected fault, host 0 learns of it before
    either issues the probe's collectives and raises too; neither waits
    out the group's timeout."""
    h0, h1 = workers["probe_fault"]
    assert h1["error"] is not None and h1["error"].startswith("InjectedFault")
    assert h0["error"] is not None and "fired on host(s) [1]" in h0["error"]
    assert h0["seconds"] < FAULT_LEAVE_S and h1["seconds"] < FAULT_LEAVE_S


# ---------------------------------------------------------------------------
# In-process: the sharded load, the group's arithmetic, refusals, parity flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,ranks", [(2, [1]), (4, [2, 3])])
def test_rank_load_equals_one_process_ranks_byte_for_byte(files, tp, ranks):
    def leaves(tree, prefix=""):
        if isinstance(tree, tq.QuantizedMatrix):
            yield prefix + ".qs", tree.qs
            yield prefix + ".scales", tree.scales
        elif isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, x in enumerate(tree):
                yield from leaves(x, f"{prefix}/{i}")
        else:
            yield prefix, tree

    full_reader, part_reader = TorchReader(files["q40"]), TorchReader(files["q40"])
    cfg = tconfig.config_from_spec(full_reader.spec)
    full = tweights.load_params(full_reader, cfg, device="cpu", tp=tp)
    part = tweights.load_params(part_reader, cfg, device="cpu", tp=tp, ranks=ranks)
    assert len(part) == len(ranks)
    for r, got in zip(ranks, part):
        a, b = dict(leaves(full[r])), dict(leaves(got))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert part_reader.bytes_read < full_reader.bytes_read
    with pytest.raises(ValueError, match="outside tp"):
        tweights.load_params(TorchReader(files["q40"]), cfg, device="cpu", tp=2, ranks=[2])


def test_group_arithmetic_and_refusals(files):
    assert thosts.local_ranks(4, 2, 1) == range(2, 4) and thosts.local_ranks(2, 2, 0) == range(0, 1)
    with pytest.raises(ValueError, match="multiple of --num-hosts"):
        thosts.local_ranks(2, 4, 0)
    assert thosts.parse_coordinator("127.0.0.1:29500") == ("127.0.0.1", 29500)
    with pytest.raises(ValueError, match="host:port"):
        thosts.parse_coordinator("localhost")
    with pytest.raises(ValueError, match="outside --num-hosts"):
        thosts.HostGroup("127.0.0.1:1", 2, 2)
    assert resolve_device("cpu", host_id=1) == torch.device("cpu")

    class Spanning:  # what the seam reads of a group spanning two processes
        num_hosts = 2

    xs = [torch.zeros(1, 128)] * 2
    assert not coll.fused_ring_eligible(xs, [None, None], group=Spanning())
    assert coll.spans_hosts(Spanning()) and not coll.spans_hosts(None)
    # --tp not a multiple of --num-hosts refuses before any rendezvous
    argv = ["worker", "--model", files["q40"], "--tokenizer", files["tok"], "--prompt", "hi", "--device", "cpu",
            "--tp", "2", "--coordinator", "127.0.0.1:1", "--num-hosts", "4", "--host-id", "0"]
    with pytest.raises(ValueError, match="multiple of --num-hosts"):
        tcli.main(argv)


def test_parity_flags_accepted_and_kv_storage_refused(files, capsys):
    base = ["generate", "--model", files["f32"], "--tokenizer", files["tok"], "--prompt", PROMPT, "--steps", "8",
            "--device", "cpu", "--dtype", "f32", "--temperature", "0", "--seed", "1"]
    plain = tcli.main(base)
    flagged = tcli.main(base + ["--nthreads", "4", "--buffer-float-type", "q80", "--weights-float-type", "q40",
                                "--kv-cache-storage", "ram"])
    assert plain["tokens"] == flagged["tokens"]
    capsys.readouterr()
    with pytest.raises(SystemExit, match="--kv-cache-storage disc is not supported"):
        tcli.main(base + ["--kv-cache-storage", "disc"])
