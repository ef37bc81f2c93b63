"""The port's worker layouts where one tp rank's sp or ep ranks spread over
several processes at tp > 1, held against its one-process backends and
the JAX package's, on the JAX multi-host test's tiny spec (as in
``tests/test_torch_multihost_sp_ep.py``: dim 128, hidden 256, 2 layers, 4
heads, vocab 128, seq_len 32; Q40 weights of seed 9, a 4-expert Mixtral of
seed 4). Four processes, each a host of the group (gloo on the CPU).

* Each host's axis groups are the JAX mesh's named axes: ``--tp 2 --sp 2``
  runs its sp exchanges over hosts {0, 1} and {2, 3} and its tp sums over
  {0, 2} and {1, 3}. Over those groups the ring rotation, the gathers,
  the all_to_all, ring attention, the decode merge and the all-reduce seam
  under every arm give the one-process bytes bit for bit.
* ``worker --tp 2 --sp 2`` (psum and ring), ``--tp 2 --sp 4`` (two sp
  ranks per process), ``--tp 2 --ep 2`` (ring) and ``--tp 2 --ep 4``
  (psum): every host's ids and logits hash equal the one-process run of
  the same flags bit for bit (under ``--ep`` the router's expert ids
  first), and each host reads :func:`engine.weights.read_share`'s bytes of
  its tp rank and experts. The CLI's ``worker --tp 2 --sp 2`` prints the
  one-process tokens. The ``--tp 2 --sp 2`` and ``--tp 2 --ep 2`` ids equal
  the JAX engine's on the 8-device CPU mesh up to a divergence where the
  JAX top-2 logit gap lies under Q40_TOL.

The four processes start once for the module (``tests/torch_multihost_worker.py``)
with one torch thread each, and are killed if they outlive
``WORKER_TIMEOUT_S``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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
from tests.test_torch_multihost_sp_ep import (
    CLI_PROMPT,
    EP_DELTA,
    EP_PROMPT,
    Q40_TOL,
    SP_DELTA,
    SP_PROMPT,
    SPEC,
    STEPS,
    _jax_stream,
)
from tests.torch_multihost_worker import axis_partials, axis_sums, drive, exchange_inputs, exchange_outputs

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_multihost_worker.py"
WORKER_TIMEOUT_S = 150
HOSTS = 4
AXIS_SHAPES = [(1, 64), (3, 100), (2, 5)]
# (tp, inner) of the axes jobs: one rank per process, two inner ranks per
# process, whole rows (the tp axis spans every process, the inner axis none)
# and tp 1 (the inner axis spans every process)
AXIS_LAYOUTS = [(2, 2), (2, 4), (4, 2), (1, 4)]
# name -> (file, flags, prompt, delta); the one-process run takes the same flags
ARMS = {
    "tp2sp2_psum": ("q40", ["--tp", "2", "--sp", "2", "--allreduce", "psum"], SP_PROMPT, SP_DELTA),
    "tp2sp2_ring": ("q40", ["--tp", "2", "--sp", "2", "--allreduce", "ring"], SP_PROMPT, SP_DELTA),
    "tp2sp4": ("q40", ["--tp", "2", "--sp", "4", "--allreduce", "ring"], SP_PROMPT, SP_DELTA),
    "tp2ep2_ring": ("mixtral", ["--tp", "2", "--ep", "2", "--allreduce", "ring"], EP_PROMPT, EP_DELTA),
    "tp2ep4_psum": ("mixtral", ["--tp", "2", "--ep", "4", "--allreduce", "psum"], EP_PROMPT, EP_DELTA),
}


def _layout(arm: str) -> tuple[int, int, str]:
    flags = ARMS[arm][1]
    axis = "sp" if "--sp" in flags else "ep"
    return int(flags[flags.index("--tp") + 1]), int(flags[flags.index(f"--{axis}") + 1]), axis


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost_subgroups")
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
    """Every job's result on each host: {name: [host 0's, ..., host 3's]}."""
    jobs = []

    def add(name, job):
        JOBS[name] = len(jobs)
        jobs.append({"num_hosts": HOSTS, **job})

    for tp, inner in AXIS_LAYOUTS:
        add(f"axes/{tp}x{inner}", {"kind": "axes", "tp": tp, "inner": inner, "shapes": AXIS_SHAPES,
                                   "seed": 40 + 10 * tp + inner})
    for arm, (model, _, prompt, delta) in ARMS.items():
        add(arm, {"kind": "engine", "argv": _argv(files, arm, "worker"), "prompt": prompt, "delta": delta,
                  "steps": STEPS, "record_ids": model == "mixtral"})
    add("cli", {"kind": "cli", "argv": _argv(files, "tp2sp2_ring", "worker", CLI_PROMPT)
                + ["--steps", "16", "--num-hosts", str(HOSTS)]})
    path = tmp_path_factory.mktemp("torch_multihost_subgroups_jobs") / "jobs.json"
    path.write_text(json.dumps(jobs))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # each host's output to a file: a full pipe would stall a host mid-job
    logs = [(path.with_suffix(f".{h}.out"), path.with_suffix(f".{h}.err")) for h in range(HOSTS)]
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
    return {name: [results[h][i] for h in range(HOSTS)] for name, i in JOBS.items()}


@pytest.fixture(scope="module")
def one_process(files):
    """Each arm's one-process run of the same flags (``generate``'s engine),
    driven as the workers' engine jobs drive theirs, with the router's
    (rows, ids) per call."""
    out = {}
    for arm, (_, _, prompt, delta) in ARMS.items():
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
# The axis groups and the collectives over them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,inner", AXIS_LAYOUTS)
def test_axis_groups_are_the_mesh_axes(workers, tp, inner):
    """Each host's groups hold :func:`axis_members`'s processes: a group
    per axis where it spans part of the processes, the whole group where
    it spans all of them, none where it stays in the process."""
    for h, res in enumerate(workers[f"axes/{tp}x{inner}"]):
        want = thosts.axis_members(tp, inner, HOSTS, h)
        assert res["members"] == [None if len(m) == 1 else m for m in want], (h, res["members"])
    if (tp, inner) == (2, 2):
        assert thosts.axis_members(2, 2, HOSTS, 1) == ([0, 1], [1, 3])


@pytest.mark.parametrize("tp,inner", AXIS_LAYOUTS)
def test_collectives_over_axis_groups_are_one_process_bit_for_bit(workers, tp, inner):
    """The inner axis's exchanges (rotation, gathers, all_to_all, ring
    attention, decode merge) and each axis's all-reduce seam under every
    arm and all-gather, over each host's groups, equal the one-process ops
    over the same ranks' inputs."""
    seed = 40 + 10 * tp + inner
    parts = axis_partials(tp, inner, AXIS_SHAPES, seed)
    for h, res in enumerate(workers[f"axes/{tp}x{inner}"]):
        tps, inners = thosts.axis_runs(tp, inner, HOSTS, h)
        want = exchange_outputs(exchange_inputs(inner, seed + tps.start), range(inner), None)
        assert set(res["exchange"]) == set(want)
        for name, ts in want.items():
            local = ts if name in ("gather", "merge") else [ts[i] for i in inners]
            got = res["exchange"][name]
            assert got == [t.contiguous().view(torch.uint8).reshape(-1).tolist() for t in local], (name, h)
        for key, ranks, n, start in (("tp", tps, tp, inners.start), ("inner", inners, inner, tps.start)):
            full = axis_sums(parts[(key, start)], range(n), None)
            assert set(res[key]) == set(full)
            for name, bits in full.items():
                assert res[key][name] == (bits if name.startswith("gather") else [bits[r] for r in ranks]), \
                    (key, name, h)


def test_refusal_of_a_run_across_a_row():
    """A host's run must be whole rows or an equal part of one: 2 x 3
    ranks over 3 hosts would give a host the end of one row and the start
    of the next; it raises before any rendezvous."""
    with pytest.raises(ValueError, match="whole rows or an equal part of one"):
        thosts.rank_placement(2, 3, 3, 0)
    assert thosts.axis_runs(2, 3, 2, 1) == (range(1, 2), range(3))


# ---------------------------------------------------------------------------
# The engines: ids, hashes, dispatches, reads
# ---------------------------------------------------------------------------


def _host_router_calls(ids: list, inners: range, ep: int) -> list:
    """The router calls of a host holding ep ranks ``inners``, out of the
    one-process run's: a dispatch forward routes each home rank's rows in
    its own call (ep calls in home order per layer), the host only its
    homes'; single-row calls (decode) are every host's."""
    out, run = [], 0
    for rows, idx in ids:
        if rows > 1:
            if run % ep in inners:
                out.append([rows, idx])
            run += 1
        else:
            out.append([rows, idx])
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_worker_engines_equal_one_process(workers, one_process, arm):
    """Expert ids first (per host, the calls its ranks make), then every
    host's logits hash, ids and dispatches, all equal to the one-process
    run of the same flags."""
    want = one_process[arm]
    tp, inner, axis = _layout(arm)
    runs = workers[arm]
    if axis == "ep":
        for h, res in enumerate(runs):
            inners = thosts.axis_runs(tp, inner, HOSTS, h)[1]
            expect = _host_router_calls(want["ids"], inners, inner)
            assert res["ids"] == expect and len(expect) > SPEC["n_layers"], (arm, h)
    for h, res in enumerate(runs):
        assert res["logits_sha256"] == want["logits_sha256"], (arm, h)
        assert res["tokens"] == want["tokens"] and len(want["tokens"]) == STEPS + 1, (arm, h)
        assert res["dispatches"] == want["dispatches"], (arm, h)
    if axis == "sp":
        assert want["dispatches"] == [1, 1]  # one ring pass, one 32-wide chunk


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_process_reads_its_tp_rank_and_experts(workers, files, arm):
    """``reader.bytes_read`` of each process is :func:`read_share` of its
    one tp rank (under ``--ep`` and its ep ranks' experts): the processes
    of a tp rank each read its shard, and under ``--ep`` only their own
    experts' entries (some bytes of the file's expert entries)."""
    model = ARMS[arm][0]
    tp, inner, axis = _layout(arm)
    reader = TorchReader(files[model])
    cfg = tconfig.config_from_spec(reader.spec)
    for h, res in enumerate(workers[arm]):
        tps, inners = thosts.axis_runs(tp, inner, HOSTS, h)
        assert len(tps) == 1 and len(inners) < inner
        experts = None
        if axis == "ep":
            El = cfg.n_experts // inner
            experts = range(inners.start * El, inners.stop * El)
            mine = sum(e.nbytes for name, e in reader.entries.items()
                       if ".experts." in name and int(name.split(".")[3]) in experts)
            assert mine > 0
        want = tweights.read_share(reader, cfg, tp, ranks=tps, experts=experts)
        assert res["bytes_read"] == want, (arm, h)


def test_cli_worker_prints_the_one_process_tokens(workers, files, capsys):
    res = tcli.main(_argv(files, "tp2sp2_ring", "generate", CLI_PROMPT) + ["--steps", "16"])
    capsys.readouterr()
    got = [h["tokens"] for h in workers["cli"]]
    assert all(g == res["tokens"] for g in got) and len(res["tokens"]) > 4


@pytest.mark.parametrize("arm,layout", [("tp2sp2_psum", {"tp": 2, "sp": 2}), ("tp2ep2_ring", {"tp": 2, "ep": 2})])
def test_worker_ids_equal_jax_where_its_gap_exceeds_the_tolerance(workers, files, arm, layout):
    model, _, prompt, delta = ARMS[arm]
    want, gaps = _jax_stream(files[model], prompt, delta, **layout)
    got = workers[arm][0]["tokens"]
    at = next((j for j in range(len(want)) if got[j] != want[j]), None)
    assert at is None or gaps[at] < Q40_TOL, (arm, at, got, want, gaps)
    assert len(got) == len(want)
