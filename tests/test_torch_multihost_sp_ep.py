"""The port's ``--sp`` and ``--ep`` in worker mode held against its
one-process backends and the JAX package's, on the JAX multi-host test's
tiny spec (``tests/test_multihost.py``: dim 128, hidden 256, 2 layers, 4
heads, vocab 128, seq_len 32; Q40 weights of seed 9, a 4-expert Mixtral of
seed 4). Two processes, each a host of the group (gloo on the CPU).

* The rank placement of every composite layout equals the JAX mesh's
  device order, read from ``mesh_utils.create_device_mesh`` on the 8 CPU
  devices, at 2 and 4 hosts, and so do the processes of each named axis
  (pure functions: no processes).
* Each exchange over two processes (the ring rotation, the gather under
  the decode merge and the all_gather, the all_to_all, ring attention and
  the merge built on them), at 2 and 4 ranks, gives the one-process bytes
  bit for bit.
* ``worker --sp 2`` (its ring pass, a chunked delta, greedy decode),
  ``--tp 2 --sp 2``, ``--ep 2`` and ``--tp 2 --ep 2``: both processes' ids
  equal each other and the one-process run of the same flags bit for bit
  (under ``--ep`` the router's expert ids first), and so do the logits'
  hashes; the CLI's ``worker --sp 2`` and ``--ep 2`` print the one-process
  tokens. The greedy ids equal the JAX ``SequenceParallelForward(sp=2)`` /
  ``ExpertParallelForward(ep=2)`` engine's up to a divergence where the
  JAX top-2 logit gap lies under Q40_TOL.
* Each process reads exactly :func:`engine.weights.read_share`'s bytes:
  under ``--ep 2`` the shared leaves and its own experts, none of the
  other process's.
* A transfer-probe fault on one host raises on both, well inside the
  group's timeout.

The processes start once for the module (``tests/torch_multihost_worker.py``)
with one torch thread each, and are killed if they outlive
``WORKER_TIMEOUT_S``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.experimental import mesh_utils

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine

from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader as TorchReader
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import moe as tmoe
from distributed_llama_tpu_torch.parallel import hosts as thosts
from distributed_llama_tpu_torch.quants import FloatType
from tests.model_utils import random_tensors, tiny_spec, write_model_file
from tests.test_torch_multihost import tokenizer_data
from tests.torch_multihost_worker import drive, exchange_inputs, exchange_outputs

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_multihost_worker.py"
WORKER_TIMEOUT_S = 150
SPEC = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=4, vocab_size=128, seq_len=32)
# the repo's cross-package q40 tolerance, of max |logit| (ROADMAP.md Queue 3):
# the two packages' Q80/bf16 roundings move q40 logits by up to this much,
# so a JAX greedy token is compared only where its top-2 gap exceeds it
Q40_TOL = 2.5e-2
FAULT_LEAVE_S = 20.0  # a third of the group's timeout: leaving on a fault did not wait it out
# 10 ids: 10 * RING_PREFILL_FRACTION >= seq_len 32, one ring pass at sp 2;
# the delta runs as one 32-wide chunk forward; 8 greedy tokens after it
SP_PROMPT = [1, 5, 9, 13, 2, 7, 30, 63, 17, 40]
SP_DELTA = [3, 11, 29, 8, 50, 21, 6]
# 8 rows (the dispatch path at ep 2), a 3-token delta padded to 4 rows
# (the dispatch path again), then dense-local decode steps
EP_PROMPT = [1, 5, 9, 13, 2, 7, 30, 63]
EP_DELTA = [3, 11, 29]
STEPS = 8
CLI_PROMPT = "hello world, hello world, hello"
EXCHANGE_RANKS = (2, 4)
# name -> (file, flags, prompt, delta); the one-process run takes the same flags
ARMS = {
    "sp2": ("q40", ["--sp", "2", "--allreduce", "ring"], SP_PROMPT, SP_DELTA),
    "tp2sp2": ("q40", ["--tp", "2", "--sp", "2", "--allreduce", "psum"], SP_PROMPT, SP_DELTA),
    "ep2": ("mixtral", ["--ep", "2", "--allreduce", "ring"], EP_PROMPT, EP_DELTA),
    "tp2ep2": ("mixtral", ["--tp", "2", "--ep", "2", "--allreduce", "ring"], EP_PROMPT, EP_DELTA),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost_sp_ep")
    out = {"tok": str(d / "tok.t")}
    with open(out["tok"], "wb") as f:
        write_tokenizer_file(f, tokenizer_data())
    spec = tiny_spec(**SPEC, weights_float_type=FloatType.Q40)
    out["q40"] = str(d / "mh_q40.m")
    write_model_file(out["q40"], spec, random_tensors(spec, seed=9))
    out["mixtral"] = str(d / "mixtral.m")
    tsyn.write_synthetic_model(out["mixtral"], tsyn.tiny_spec(
        arch_type=tsyn.ArchType.MIXTRAL, n_experts=4, n_active_experts=2, **SPEC,
        weights_float_type=FloatType.Q40), seed=4)
    return out


def _argv(files, arm: str, mode: str = "generate", prompt: str = "x") -> list:
    model, flags, _, _ = ARMS[arm]
    return [mode, "--model", files[model], "--tokenizer", files["tok"], "--prompt", prompt, "--device", "cpu",
            "--dtype", "q40", "--temperature", "0", "--seed", "3", "--decode-chunk", "4", *flags]


JOBS = {}  # job name -> index in the workers' job list


@pytest.fixture(scope="module")
def workers(files, tmp_path_factory):
    """Every job's result on each host: {name: [host 0's, host 1's]}."""
    jobs = []

    def add(name, job):
        JOBS[name] = len(jobs)
        jobs.append(job)

    for n in EXCHANGE_RANKS:
        add(f"exchange{n}", {"kind": "exchange", "n": n, "seed": 10 + n})
    for arm, (model, _, prompt, delta) in ARMS.items():
        add(arm, {"kind": "engine", "argv": _argv(files, arm, "worker"), "prompt": prompt, "delta": delta,
                  "steps": STEPS, "record_ids": model == "mixtral"})
    for arm in ("sp2", "ep2"):
        add(f"cli/{arm}", {"kind": "cli", "argv": _argv(files, arm, "worker", CLI_PROMPT)
                           + ["--steps", "16", "--num-hosts", "2"]})
    # last: a fault leaves its group on an error, without the closing barrier
    add("probe_fault", {"kind": "cli", "fault": {"host": 1, "spec": "tp.transfer:kind=raise,count=1"},
                        "argv": _argv(files, "sp2", "worker", CLI_PROMPT) + ["--steps", "16", "--num-hosts", "2"]})
    path = tmp_path_factory.mktemp("torch_multihost_sp_ep_jobs") / "jobs.json"
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


@pytest.fixture(scope="module")
def one_process(files):
    """Each arm's one-process run of the same flags (``generate``'s engine),
    driven as the workers' engine jobs drive theirs, with the router's
    (rows, ids) per call."""
    out = {}
    for arm, (model, _, prompt, delta) in ARMS.items():
        ids, orig = [], tmoe.router_topk

        def spy(cfg, xn, router):
            vals, idx = orig(cfg, xn, router)
            ids.append([xn.shape[0], idx.tolist()])
            return vals, idx

        tmoe.router_topk = spy
        try:
            engine = tcli.make_engine(tcli.build_parser().parse_args(_argv(files, arm)))[0]
            out[arm] = {**drive(engine, prompt, delta, STEPS), "ids": ids}
        finally:
            tmoe.router_topk = orig
    return out


# ---------------------------------------------------------------------------
# The placement (no processes)
# ---------------------------------------------------------------------------


def _layouts():
    """Every (tp, inner, axis) the validators accept on the tiny spec with
    tp * inner <= 8 (the CPU mesh's devices): tp a power of two dividing
    the heads, sp dividing seq_len 32, ep dividing 4 experts."""
    out = []
    for tp in (1, 2, 4):
        out += [(tp, sp, "sp") for sp in (2, 4, 8) if tp * sp <= 8]
        out += [(tp, ep, "ep") for ep in (2, 4) if tp * ep <= 8]
    return out


@pytest.mark.parametrize("tp,inner,axis", _layouts())
def test_placement_is_the_jax_mesh_device_order(tp, inner, axis):
    """Device (t, i) of the JAX mesh over ``jax.devices()[:tp*inner]``,
    with the devices dealt to the hosts in process order (contiguous runs,
    as ``jax.devices()`` lists each process's devices), is the pair the
    port's placement gives that host, and the processes of each named axis
    (those holding the host's tp ranks on the inner axis, its inner ranks
    on the tp axis) are :func:`axis_members`'s; a rank count that is not a
    multiple of the hosts raises with the port's wording."""
    n = tp * inner
    mesh = mesh_utils.create_device_mesh((tp, inner), devices=jax.devices()[:n])
    index = {d.id: g for g, d in enumerate(jax.devices()[:n])}
    for num_hosts in (2, 4):
        if n % num_hosts:
            with pytest.raises(ValueError, match="must be a multiple of --num-hosts"):
                thosts.rank_placement(tp, inner, num_hosts, 0)
            continue
        m = n // num_hosts

        def host(t, i):
            return index[mesh[t, i].id] // m

        for h in range(num_hosts):
            want = sorted((t, i) for t in range(tp) for i in range(inner) if host(t, i) == h)
            got = thosts.rank_placement(tp, inner, num_hosts, h)
            assert got == want, (tp, inner, num_hosts, h)
            tps, inners = thosts.axis_runs(tp, inner, num_hosts, h)
            assert [(t, i) for t in tps for i in inners] == got
            axis_procs = (sorted({host(t, i) for t in tps for i in range(inner)}),
                          sorted({host(t, i) for t in range(tp) for i in inners}))
            assert thosts.axis_members(tp, inner, num_hosts, h) == axis_procs, (tp, inner, num_hosts, h)


# ---------------------------------------------------------------------------
# The exchanges over two processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", EXCHANGE_RANKS)
def test_exchanges_over_processes_are_one_process_bit_for_bit(workers, n):
    want = exchange_outputs(exchange_inputs(n, 10 + n), range(n), None)
    m = n // 2
    for h, res in enumerate(workers[f"exchange{n}"]):
        assert set(res) == set(want)
        for name, ts in want.items():
            local = ts if name in ("gather", "merge") else ts[h * m : (h + 1) * m]
            got = res[name]
            assert len(got) == len(local), (name, h)
            for g, w in zip(got, local):
                assert g == w.contiguous().view(torch.uint8).reshape(-1).tolist(), (name, h)


# ---------------------------------------------------------------------------
# The engines: ids, hashes, dispatches, reads
# ---------------------------------------------------------------------------


def _host_ids(ids: list, h: int, ep: int, m: int) -> list:
    """The router calls of host ``h``, which holds ep ranks [h m, (h+1) m),
    out of the one-process run's calls: a dispatch forward routes each
    home rank's rows in its own call (ep calls in home order per layer);
    the host routes only its homes'. Single-row calls (decode) are every
    host's."""
    out, run = [], 0
    for rows, idx in ids:
        if rows > 1:
            if h * m <= run % ep < (h + 1) * m:
                out.append([rows, idx])
            run += 1
        else:
            out.append([rows, idx])
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_worker_engines_equal_each_other_and_one_process(workers, one_process, files, arm):
    """Expert ids first (per host, the calls its ranks make), then the
    logits' hash, the ids, the ring pass's single dispatch and the chunked
    delta's, all equal to the one-process run of the same flags."""
    want = one_process[arm]
    h0, h1 = workers[arm]
    if ARMS[arm][0] == "mixtral":
        ep_spans = "--tp" not in ARMS[arm][1]
        for h, res in enumerate((h0, h1)):
            expect = _host_ids(want["ids"], h, 2, 1) if ep_spans else want["ids"]
            assert res["ids"] == expect and len(expect) > SPEC["n_layers"], (arm, h)
    assert h0["logits_sha256"] == h1["logits_sha256"] == want["logits_sha256"]
    assert h0["tokens"] == h1["tokens"] == want["tokens"] and len(want["tokens"]) == STEPS + 1
    assert h0["dispatches"] == h1["dispatches"] == want["dispatches"]
    if arm.endswith("sp2"):
        assert want["dispatches"] == [1, 1]  # one ring pass, one 32-wide chunk


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_process_reads_its_stated_share(workers, files, arm):
    """``reader.bytes_read`` of each process is :func:`read_share` of its
    tp ranks and experts: the whole file at --sp 2 (tp = 1), half of every
    tp-cut matrix at --tp 2, and under --ep 2 the shared leaves with only
    its own two experts' entries, which the test sums itself."""
    model, flags, _, _ = ARMS[arm]
    reader = TorchReader(files[model])
    cfg = tconfig.config_from_spec(reader.spec)
    tp = 2 if "--tp" in flags else 1
    for h, res in enumerate(workers[arm]):
        if arm == "ep2":
            mine = {2 * h, 2 * h + 1}
            want = sum(e.nbytes for name, e in reader.entries.items()
                       if ".experts." not in name or int(name.split(".")[3]) in mine)
            assert res["bytes_read"] == want == tweights.read_share(reader, cfg, experts=range(2 * h, 2 * h + 2))
        else:
            want = tweights.read_share(reader, cfg, tp, ranks=range(h, h + 1) if tp > 1 else None)
            assert res["bytes_read"] == want
    total = sum(e.nbytes for e in reader.entries.values())
    assert tweights.read_share(reader, cfg) == total
    full = TorchReader(files[model])
    tweights.load_params(full, cfg, device="cpu")
    assert full.bytes_read == total


def _jax_stream(path: str, prompt: list, delta: list, **layout) -> tuple[list, np.ndarray]:
    """The JAX engine's greedy ids after ``prompt`` and ``delta`` (the first
    from the delta's last row), and its top-2 logit gap of max |logit| at
    each, teacher-forced along its own ids."""
    engine = JaxEngine(path, dtype="q40", **layout)
    engine.reset()
    engine.prefill(prompt)
    rows = engine.forward(delta)
    first = int(np.argmax(rows[-1]))
    pos = engine.pos
    toks = [first] + [int(t) for t in engine.generate_on_device(first, STEPS, 0.0)]
    engine.rollback(pos)
    logits = np.concatenate([rows[-1:], engine.forward(toks[:-1])])
    top2 = -np.sort(-logits, axis=-1)[:, :2]
    return toks, (top2[:, 0] - top2[:, 1]) / np.abs(logits).max(axis=-1)


@pytest.mark.parametrize("arm,layout", [("sp2", {"sp": 2}), ("ep2", {"ep": 2})])
def test_worker_ids_equal_jax_where_its_gap_exceeds_the_tolerance(workers, files, arm, layout):
    model, _, prompt, delta = ARMS[arm]
    want, gaps = _jax_stream(files[model], prompt, delta, **layout)
    got = workers[arm][0]["tokens"]
    at = next((j for j in range(len(want)) if got[j] != want[j]), None)
    assert at is None or gaps[at] < Q40_TOL, (arm, at, got, want, gaps)
    assert len(got) == len(want)


@pytest.mark.parametrize("arm", ["sp2", "ep2"])
def test_cli_worker_prints_the_one_process_tokens(workers, files, capsys, arm):
    res = tcli.main(_argv(files, arm, "generate", CLI_PROMPT) + ["--steps", "16"])
    capsys.readouterr()
    h0, h1 = workers[f"cli/{arm}"]
    assert h0["tokens"] == h1["tokens"] == res["tokens"] and len(res["tokens"]) > 4


def test_probe_fault_on_one_host_raises_on_both(workers):
    """The tp.transfer site fires on host 1 alone, in the SP backend's probe
    at engine build: host 1 raises the injected fault, host 0 learns of it
    before either issues the probe's exchanges and raises too."""
    h0, h1 = workers["probe_fault"]
    assert h1["error"] is not None and h1["error"].startswith("InjectedFault")
    assert h0["error"] is not None and "fired on host(s) [1]" in h0["error"]
    assert h0["seconds"] < FAULT_LEAVE_S and h1["seconds"] < FAULT_LEAVE_S


def test_refusals_keep_their_messages(files):
    """What stays refused: --sp with --ep and a rank count that is not a
    multiple of the hosts (before any rendezvous: the placement). A layout
    whose tp rank's sp ranks span processes at tp > 1 is placed: host 0 of
    --tp 2 --sp 2 over 4 holds (0, 0), shares sp with host 1 and tp with
    host 2."""
    assert thosts.axis_runs(2, 2, 4, 0) == (range(0, 1), range(0, 1))
    assert thosts.axis_members(2, 2, 4, 0) == ([0, 1], [0, 2])
    with pytest.raises(ValueError, match="must be a multiple of --num-hosts"):
        tcli.main(_argv(files, "sp2", "worker") + ["--coordinator", "127.0.0.1:1", "--num-hosts", "4",
                                                   "--host-id", "0"])
    from distributed_llama_tpu_torch.engine import InferenceEngine

    with pytest.raises(ValueError, match="--ep and --sp do not compose"):
        InferenceEngine(files["mixtral"], device="cpu", ep=2, sp=2)
