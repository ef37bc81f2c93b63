"""The port's `dllama-analyze` (``distributed_llama_tpu_torch/analysis``)
held against the JAX package's, and the repairs its gate asked for.

* The gate: ``python -m distributed_llama_tpu_torch.analysis
  distributed_llama_tpu_torch/`` exits 0 with the port's empty baseline;
  its lock ranks are pyproject's ``[tool.dllama.analysis.locks]`` table.
* Parity: on every fixture pair under ``tests/analysis_fixtures/`` (read as
  data) the port's analyzer and the JAX analyzer report the same (rule id,
  line, column) findings, all rules at once; ``--list-rules`` gives the
  same ids.
* The repairs in the port's code: the dispatch retry counter is written
  only under the scheduler lock and counts exactly beside a concurrent
  fetch retry (LCK-004); a spilled page uploads only under the lock
  (LCK-001); the fetch helper thread hands an interpreter exit to its
  waiter and ends with it (EXC-001); ``prefill_chunk=0`` stays 0
  (FLS-001); the two per-row fault sites fire under their own names
  (FLT-001). Every noqa in the port is one of a known set.
"""

from __future__ import annotations

import threading
from pathlib import Path

import pytest
import torch

from distributed_llama_tpu.analysis import AnalysisConfig as JaxConfig
from distributed_llama_tpu.analysis import all_rules as jax_rules
from distributed_llama_tpu.analysis import analyze as jax_analyze
from distributed_llama_tpu.analysis import rule_ids as jax_rule_ids
from distributed_llama_tpu.analysis.__main__ import main as jax_main

from distributed_llama_tpu_torch import analysis, retry
from distributed_llama_tpu_torch import telemetry as ttel
from distributed_llama_tpu_torch.analysis.__main__ import main as port_main
from distributed_llama_tpu_torch.analysis.config import _parse_toml_section
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import faults
from distributed_llama_tpu_torch.engine import batch as tbatch
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.engine.spill import HostArena
from distributed_llama_tpu_torch.formats import synthetic as tsyn

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_llama_tpu_torch"
FIXTURES = ROOT / "tests" / "analysis_fixtures"

# (fixture dir, extra files, config fields): the JAX package's own cases
# (tests/test_analysis.py CASES)
FIXTURE_CASES = {
    "don_001": ((), {}),
    "lck_001": ((), {}),
    "lck_002": ((), {}),
    "lck_003": ((), {"lock_ranks": (("Sched._cond", 20), ("Pool._cond", 40))}),
    "lck_004": ((), {"lock_attrs": ("_lock",)}),
    "fls_001": ((), {}),
    "gen_002": ((), {}),
    "exc_001": ((), {}),
    "clk_001": ((), {}),
    "tel_001": ((), {"observability_doc": "doc.md"}),
    "flt_001": (("registry.py",), {"fault_registry": "registry.py"}),
    "trc_001": (("registry.py",), {"span_registry": "registry.py", "observability_doc": "doc.md"}),
}

# every suppression in the port: (file, rule) -> the reason's site. The
# JAX package carries the same noqa at the same site except where marked
# "port", whose invariant a test below holds.
NOQAS = {
    ("apps/cli.py", "CLK-001"): "the default sampling seed",
    ("engine/batch.py", "LCK-002"): "the bounded dispatch retry",
    ("engine/batch.py", "LCK-004"): "port: the dispatch retry counter",
    ("engine/batch.py", "LCK-001"): "port: the spilled-page upload",
    ("server/fleet.py", "LCK-001"): "_run_locked and _tick_locked under a non-blocking _ops",
}


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_port_gate_is_clean_with_an_empty_baseline(capsys):
    # the gate without its baseline: clean on its own
    assert port_main([str(PORT), "--no-baseline"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith("OK: 0 finding(s)")
    cfg = analysis.load_config()
    assert Path(cfg.root) == ROOT
    baseline = Path(cfg.rel_to_root(cfg.baseline))
    assert baseline.parent == PORT / "analysis"
    assert [ln for ln in baseline.read_text().splitlines() if ln.strip() and not ln.startswith("#")] == []


def test_port_config_reads_the_pyproject_lock_table_and_its_own_keys():
    cfg = analysis.load_config()
    locks = _parse_toml_section((ROOT / "pyproject.toml").read_text(), "tool.dllama.analysis.locks")
    assert dict(cfg.lock_ranks) == {k: int(v) for k, v in locks.items()}
    assert cfg.fault_registry == "distributed_llama_tpu_torch/engine/faults.py"
    assert cfg.span_registry == "distributed_llama_tpu_torch/telemetry/spans.py"
    assert cfg.observability_doc == "docs/OBSERVABILITY.md"
    assert cfg.blocking_calls == ("retry_call",)
    assert all(e.startswith("distributed_llama_tpu_torch/server/api.py::") for e in cfg.clock_allow)
    assert "_cond" in cfg.lock_attrs and "_ops" in cfg.lock_attrs


def test_every_noqa_in_the_port_is_known():
    found = set()
    for path in PORT.rglob("*.py"):
        if "analysis" in path.relative_to(PORT).parts:
            continue
        for line in path.read_text().splitlines():
            if "# dllama: noqa[" in line:
                rule = line.split("# dllama: noqa[", 1)[1].split("]", 1)[0]
                found.add((path.relative_to(PORT).as_posix(), rule))
    assert found == set(NOQAS)


# ---------------------------------------------------------------------------
# Parity with the JAX analyzer
# ---------------------------------------------------------------------------


def _findings(analyze_fn, rules, config_cls, sub: str, name: str):
    extra, kw = FIXTURE_CASES[sub]
    files = [str(FIXTURES / sub / n) for n in (name, *extra)]
    cfg = config_cls(root=str(FIXTURES / sub), baseline="", **kw)
    found, _ = analyze_fn(files, cfg, rules=rules())
    return sorted((f.rule, f.path, f.line, f.col) for f in found)


@pytest.mark.parametrize("name", ["bad.py", "good.py"])
@pytest.mark.parametrize("sub", sorted(FIXTURE_CASES))
def test_fixture_findings_equal_jax(sub, name):
    ours = _findings(analysis.analyze, analysis.all_rules, analysis.AnalysisConfig, sub, name)
    theirs = _findings(jax_analyze, jax_rules, JaxConfig, sub, name)
    assert ours == theirs
    if name == "bad.py":
        assert any(r == sub.upper().replace("_", "-") for r, *_ in ours)


def test_list_rules_equal_jax(capsys):
    assert port_main(["--list-rules"]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["--list-rules"]) == 0
    theirs = capsys.readouterr().out
    ids = [ln.split()[0] for ln in ours.splitlines()]
    assert ids == [ln.split()[0] for ln in theirs.splitlines()]
    assert ids == list(analysis.rule_ids()) == list(jax_rule_ids())
    assert len(ids) == 12


# ---------------------------------------------------------------------------
# The repairs
# ---------------------------------------------------------------------------

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=96)
PROMPTS = [[1, 5, 9, 2, 7, 3, 11, 4, 6, 8], [1, 7, 7, 3, 9], [1, 2, 3, 4, 5, 6], [1, 9, 8, 7]]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_analysis") / "model.m"
    tsyn.write_synthetic_model(str(path), tsyn.tiny_spec(**SPEC), seed=4)
    ttel.reset()
    ttel.enable()  # the engine binds its instruments once
    try:
        yield TorchEngine(str(path), dtype=torch.float32, device="cpu")
    finally:
        ttel.disable()
        ttel.reset()


@pytest.fixture(autouse=True)
def _no_plan():
    faults.clear()
    yield
    faults.clear()


def _decode(stream, prompt, n=6):
    stream.reset()
    first = stream.prefill_device(prompt, 0.0, 0.9, 3)
    got = []

    def on_token(prev, tok):
        got.append(tok)
        return len(got) < n

    stream.stream_decode(first, on_token, 0.0, 0.9, seed=3, limit=stream.pos + n, first_prev=prompt[-1])
    return got


def _four_rows(sched):
    outs, errs = [None] * 4, [None] * 4
    streams = [sched.new_stream() for _ in range(4)]

    def one(i):
        try:
            outs[i] = _decode(streams[i], PROMPTS[i])
        except Exception as e:
            errs[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return outs, errs


def test_dispatch_retries_count_exactly_beside_a_fetch_retry(engine, monkeypatch):
    """LCK-004: a dispatch whose ``batch.dispatch`` site fails twice and a
    fetch retry on another thread: every retry counts once, in the
    scheduler's total and in ``dllama_batch_retries_total``; the dispatch
    path's ``on_retry`` runs on the dispatching thread with the scheduler
    lock held (the invariant its noqa states)."""
    clean, errs = _four_rows(BatchScheduler(engine, n_rows=4, chunk=2))
    assert errs == [None] * 4
    held = []
    real = retry.retry_call

    def watched(fn, policy, *, on_retry=None, **kw):
        def wrapped(attempt, e):
            held.append((threading.get_ident(), sched._cond._is_owned()))
            on_retry(attempt, e)
        return real(fn, policy, on_retry=None if on_retry is None else wrapped, **kw)

    monkeypatch.setattr(tbatch.retry, "retry_call", watched)
    faults.install(faults.parse("batch.dispatch:kind=raise,after=1,count=2;batch.fetch:kind=raise,count=1"))
    sched = BatchScheduler(engine, n_rows=4, chunk=2, retry_backoff_s=0.02)
    faults.clear()
    before = sched.engine._tel.dispatch_retries, sched.engine._tel.fetch_retries

    def value(c):
        return c._value

    b0 = [value(c) for c in before]
    outs, errs = _four_rows(sched)
    sched.close()
    assert errs == [None] * 4 and outs == clean
    assert sched.retries_total == 3
    assert [value(c) - v for c, v in zip(before, b0)] == [2, 1]
    # two dispatch retries under the lock, one fetch retry without it
    assert sorted(owned for _, owned in held) == [False, True, True]


def test_spilled_page_uploads_only_under_the_lock(engine, monkeypatch):
    """LCK-001: ``_upload_page_locked`` runs only inside
    ``_reload_spilled_locked``'s frame, the scheduler lock held, and the
    reloaded stream equals the cold one."""
    sched = BatchScheduler(engine, n_rows=1, chunk=4, prefix_cache=True, kv_pages=6, page_size=4,
                           spill_arena=HostArena(32 << 20))
    owned = []
    real = sched._upload_page_locked

    def watched(pid, arrays):
        owned.append(sched._cond._is_owned())
        return real(pid, arrays)

    monkeypatch.setattr(sched, "_upload_page_locked", watched)
    s = sched.new_stream()
    prompt = PROMPTS[0]
    cold = _decode(s, prompt)
    for k in range(3):  # churn: evicts and spills the prompt's pages
        _decode(s, [100 + 10 * k + j for j in range(10)])
    s.reset()
    assert sched._prefix.walk(prompt) == []
    warm = _decode(s, prompt)
    sched.close()
    assert warm == cold and len(owned) >= 2 and all(owned)


class _Exit(BaseException):
    """An interpreter-exit stand-in (not an Exception)."""


def test_fetch_helper_hands_an_exit_on_and_ends_with_it(engine, monkeypatch):
    """EXC-001: with the watchdog on, a fetch wait that raises an
    interpreter exit raises it on the waiting thread and ends the helper
    thread with it, also when the watchdog retired the waiter first; an
    ordinary error only reaches the waiter."""
    sched = BatchScheduler(engine, n_rows=1, chunk=4, stall_timeout_s=60.0)
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda a: seen.append(a.exc_type))
    try:
        with sched._cond:
            sched._fetching, sched._fetch_gen = True, 7

        def boom():
            raise _Exit()

        with pytest.raises(_Exit):
            sched._wait_fetch(boom, 7)
        with pytest.raises(ValueError):
            sched._wait_fetch(lambda: (_ for _ in ()).throw(ValueError("x")), 7)
        go = threading.Event()

        def late():
            go.wait(5)
            raise _Exit()

        with sched._cond:
            sched._fetching = False  # the watchdog retired this fetch
        assert sched._wait_fetch(late, 7) is tbatch._RETIRED
        go.set()
        for t in [t for t in threading.enumerate() if t.name == "dllama-batch-fetch"]:
            t.join(5)
    finally:
        sched.close()
    assert seen == [_Exit, _Exit]


def test_prefill_chunk_zero_and_none_are_one_piece(engine):
    """FLS-001: ``prefill_chunk`` 0 (one monolithic dispatch) is kept and
    None means the same, written as the JAX package's fixed form."""
    for value in (0, None):
        sched = BatchScheduler(engine, n_rows=1, chunk=4, prefill_chunk=value)
        assert sched.prefill_chunk == 0
        sched.close()
    sched = BatchScheduler(engine, n_rows=1, chunk=4, prefill_chunk=3)
    assert sched.prefill_chunk == 3
    sched.close()
    src = (PORT / "engine" / "batch.py").read_text()
    assert "prefill_chunk or 0" not in src


@pytest.mark.parametrize("site,row", [("engine.paged_attn", 0), ("engine.fused_step", 1)])
def test_row_sites_fire_under_their_own_names(engine, site, row):
    """FLT-001: the two per-row sites are named at their fire() calls; each
    still retires only its row, the others stream their fault-free
    tokens."""
    kw = dict(n_rows=4, chunk=2, prefix_cache=True, page_size=4)
    clean, _ = _four_rows(BatchScheduler(engine, **kw))
    faults.install(faults.parse(f"{site}:kind=raise,row={row},count=1"))
    sched = BatchScheduler(engine, **kw)
    faults.clear()
    outs, errs = _four_rows(sched)
    sched.close()
    assert [type(e).__name__ if e else None for e in errs] == ["RowQuarantined" if i == row else None
                                                               for i in range(4)]
    assert all(outs[i] == clean[i] for i in range(4) if i != row)
    assert sched.quarantined_total == 1
