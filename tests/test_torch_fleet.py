"""The port's fleet operations (blue-green rollout and elasticity) held
against the JAX package's.

* The JAX package's cases (tests/test_fleet.py) on the port: the pool's
  fleet primitives and the rollout orchestrator and fleet controller over
  fake replicas (no engines; exact), then over HTTP on the port's server (a
  tiny synthetic f32 model, dim 64, 2 layers, seq_len 192, a ChatML
  tokenizer; 2-3 replicas of 2 lanes): a live rollout under streaming
  traffic with zero failed requests and streams equal to an un-upgraded
  run's text exactly, a ``server.rollout kind=corrupt`` build tripping the
  checksum gate into a full rollback, a drain mid-rollout, and real-build
  elasticity with exact admission capacity.
* The engines a rollback and a retire release are freed (weak references).
* One scripted sequence through the JAX server and the port's on the same
  model (canary ticks, ``engine.sdc`` on replica 1, a corrupt rollout, a
  grow then a shrink): equal health walks, canary and checksum verdicts,
  rollout and scale decisions, and equal deltas of the integrity, failover,
  rollout and fleet series (tolerance: none; counters and states only).
* The loadgen's rollout gate against the JAX package's, and the self-hosted
  load generator with ``--rollout-weights same``, the canary and shadow
  votes.
"""

import gc
import json
import threading
import time
import types
import weakref

import jax.numpy as jnp
import pytest
import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.engine import InferenceEngine, faults, integrity
from distributed_llama_tpu_torch.server import fleet
from distributed_llama_tpu_torch.server.admission import FairAdmission
from distributed_llama_tpu_torch.telemetry import flight

from tests.test_torch_integrity import Sse
from tests.test_torch_replicas import fake_pool, files, get_json, make_replica_state, one_long_prompt, post_raw, \
    serve_state  # noqa: F401 (files is a fixture)

SLOW = "batch.fetch:kind=delay,delay_ms=25,count=-1"


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    faults.clear()
    yield
    faults.clear()


def post_admin(url, body: dict, timeout=180):
    """POST /admin/rollout -> (status, parsed JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/admin/rollout", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def register_same(state, files, version="v1"):
    """Register ``version`` over the boot file: identical bytes under a new
    version id, so streams stay comparable across the upgrade."""
    model = files[0]
    state.register_weights_version(version, lambda: InferenceEngine(model, dtype=torch.float32, device="cpu"))


class FakeFleetState:
    """The orchestrator's and controller's ApiState surface without HTTP: a
    pool, a versioned-factory registry and a deterministic probe."""

    def __init__(self, pool, versions=(), probe=None):
        self.pool = pool
        self.draining = False
        self._versions = set(versions)
        self.completed = []
        self._probe = probe or (lambda rep: ("tokens", "fingerprint"))

    def has_weights_version(self, version):
        return version in self._versions

    def _canary_probe(self, rep, messages=None, tenant=None):
        # certification bills the reserved rollout tenant, never a client's
        assert tenant == integrity.ROLLOUT_TENANT
        return self._probe(rep)

    def on_rollout_complete(self, old, new):
        self.completed.append((old, new))


# ----------------------------------------------------------------------
# Pool fleet primitives (fake replicas)
# ----------------------------------------------------------------------


class TestPoolFleetPrimitives:
    def test_slot_version_pin_overrides_pool_default(self):
        pool = fake_pool()
        assert pool.weights_version == "v0" and pool.target_version(0) == "v0"
        pool.set_slot_version(0, "v1")
        assert pool.target_version(0) == "v1" and pool.target_version(1) == "v0"
        pool._slot_versions.clear()
        assert pool.target_version(0) == "v0"
        pool.close()

    def test_cordon_excludes_from_placement_but_not_claims(self):
        pool = fake_pool()
        pool.set_cordon(0, True)
        for _ in range(3):
            slot = pool.place([{"role": "user", "content": "x"}])
            assert slot in pool.replicas[1].slots
            slot.busy = False
        assert pool.claim_slot(0) is not None  # certification probes need them
        pool.close()

    def test_drain_replica_caps_then_succeeds(self):
        pool = fake_pool()
        pool.replicas[0].slots[0].busy = True
        assert pool.drain_replica(0, timeout_s=0.05) is False
        assert pool.replicas[0].cordoned  # the cordon stays on at the cap
        pool.replicas[0].slots[0].busy = False
        assert pool.drain_replica(0, timeout_s=1.0) is True
        pool.close()

    def test_grow_and_retire_keep_admission_exact(self):
        adm = FairAdmission(2, queue_limit=8)
        pool = fake_pool(n_replicas=1, lanes=2, admission=adm)
        assert pool.grow_replica() == 1
        assert len(pool.replicas) == 2 and adm.n_slots == 4
        assert pool.replicas[1].weights_version == "v0"
        assert pool.retire_replica(drain_timeout_s=1.0) is True
        assert len(pool.replicas) == 1 and adm.n_slots == 2
        assert pool.retire_replica(drain_timeout_s=1.0) is False  # the last replica stays
        assert adm.n_slots == 2
        pool.close()

    def test_certify_replica_per_version_golden(self):
        pool = fake_pool()
        pool.replicas[1].weights_version = "v1"
        assert pool.certify_replica(0, ("a", 1)) is True
        assert pool.certify_replica(1, ("b", 2)) is True
        assert pool._canary_goldens == {"v0": ("a", 1), "v1": ("b", 2)}
        assert pool.certify_replica(0, ("a", 1)) is True
        assert pool.certify_replica(1, ("a", 1)) is False
        assert pool.sdc_mismatches_total == 1
        pool.retire_version("v1")
        assert set(pool._canary_goldens) == {"v0"}
        pool.close()


# ----------------------------------------------------------------------
# The orchestrator over a fake pool
# ----------------------------------------------------------------------


class TestRolloutOrchestrator:
    def test_preconditions_raise_typed_conflicts(self):
        pool = fake_pool(supervise=True)
        fstate = FakeFleetState(pool, versions=("v1",))
        orch = fleet.RolloutOrchestrator(fstate)
        with pytest.raises(fleet.RolloutConflict, match="already serves"):
            orch.run("v0")
        with pytest.raises(fleet.RolloutConflict, match="unknown"):
            orch.run("v9")
        lock = threading.Lock()
        held = fleet.RolloutOrchestrator(fstate, ops_lock=lock)
        with lock:
            with pytest.raises(fleet.RolloutConflict, match="in progress"):
                held.run("v1")
        pool.close()
        unsup = fake_pool(supervise=False)
        with pytest.raises(fleet.RolloutConflict, match="supervised"):
            fleet.RolloutOrchestrator(FakeFleetState(unsup, versions=("v1",))).run("v1")
        unsup.close()

    def test_happy_path_moves_all_and_flips_version(self):
        pool = fake_pool(supervise=True)
        fstate = FakeFleetState(pool, versions=("v1",))
        result = fleet.RolloutOrchestrator(fstate).run("v1")
        assert result["status"] == "complete" and result["moved"] == 2
        assert pool.weights_version == "v1"
        assert [r.weights_version for r in pool.replicas] == ["v1", "v1"]
        assert not pool._slot_versions and pool.rollout_status() == {"active": False}
        assert pool.rollout_moves_total == 2 and pool.rollout_aborts_total == 0
        assert set(pool._canary_goldens) == {"v1"} and fstate.completed == [("v0", "v1")]
        assert not any(r.cordoned for r in pool.replicas)
        pool.close()

    def test_second_replica_golden_mismatch_rolls_back(self):
        pool = fake_pool(supervise=True)
        fstate = FakeFleetState(pool, versions=("v1",), probe=lambda rep: ("fp", rep.idx))
        with pytest.raises(fleet.RolloutAborted, match="MISMATCH"):
            fleet.RolloutOrchestrator(fstate).run("v1")
        assert pool.weights_version == "v0"
        assert [r.weights_version for r in pool.replicas] == ["v0", "v0"]
        assert pool.rollout_aborts_total == 1 and pool.rollout_moves_total == 1
        assert "v1" not in pool._canary_goldens
        assert not pool._slot_versions and not any(r.cordoned for r in pool.replicas)
        assert fstate.completed == []
        pool.close()

    def test_injected_certification_fault_rolls_back(self):
        faults.install(faults.parse("server.rollout:kind=raise,row=1,count=1"))
        pool = fake_pool(supervise=True)
        fstate = FakeFleetState(pool, versions=("v1",))
        with pytest.raises(fleet.RolloutAborted):
            fleet.RolloutOrchestrator(fstate).run("v1")
        assert [r.weights_version for r in pool.replicas] == ["v0", "v0"]
        assert pool.rollout_aborts_total == 1 and pool.rollout_status() == {"active": False}
        result = fleet.RolloutOrchestrator(fstate).run("v1")  # the fault is spent
        assert result["status"] == "complete" and pool.weights_version == "v1"
        pool.close()


# ----------------------------------------------------------------------
# The fleet controller over a fake pool and a real FairAdmission
# ----------------------------------------------------------------------


class TestFleetController:
    def _setup(self, **kw):
        adm = FairAdmission(2, queue_limit=16)
        pool = fake_pool(n_replicas=1, lanes=2, admission=adm)
        fstate = FakeFleetState(pool)
        for k, v in dict(min_replicas=1, max_replicas=3, queue_high=2, up_ticks=2, down_ticks=2).items():
            kw.setdefault(k, v)
        return pool, adm, fleet.FleetController(fstate, **kw)

    @staticmethod
    def _push(adm, n=2):
        # rejected demand is pressure: a full bounded queue 429s instead of
        # growing
        adm.rejected_total["load"] = adm.rejected_total.get("load", 0) + n

    def test_grow_needs_consecutive_pressure_ticks(self):
        pool, adm, ctl = self._setup()
        self._push(adm)
        assert ctl.tick() is None  # streak 1 of 2
        self._push(adm)
        assert ctl.tick() == "up"
        assert len(pool.replicas) == 2 and adm.n_slots == 4 and ctl.scale_events == {"up": 1, "down": 0}
        pool.close()

    def test_interrupted_pressure_resets_the_streak(self):
        pool, adm, ctl = self._setup(down_ticks=5)
        self._push(adm)
        assert ctl.tick() is None
        assert ctl.tick() is None  # an idle tick resets the up streak
        self._push(adm)
        assert ctl.tick() is None
        assert len(pool.replicas) == 1
        pool.close()

    def test_sustained_idle_shrinks_to_min_and_stops(self):
        pool, adm, ctl = self._setup()
        for _ in range(2):
            self._push(adm)
            ctl.tick()
        self._push(adm)
        assert ctl.tick() is None
        self._push(adm)
        assert ctl.tick() == "up"
        assert len(pool.replicas) == 3 and adm.n_slots == 6
        assert ctl.tick() is None
        assert ctl.tick() == "down"
        assert len(pool.replicas) == 2 and adm.n_slots == 4
        assert ctl.tick() is None
        assert ctl.tick() == "down"
        assert len(pool.replicas) == 1 and adm.n_slots == 2
        for _ in range(4):
            assert ctl.tick() is None
        assert len(pool.replicas) == 1 and ctl.scale_events == {"up": 2, "down": 2}
        pool.close()

    def test_controller_defers_to_an_active_rollout(self):
        pool, adm, ctl = self._setup(up_ticks=1)
        with pool._cond:
            pool.rollout = {"active": True, "from": "v0", "to": "v1", "moved": 0, "total": 1}
        self._push(adm)
        assert ctl.tick() is None
        assert len(pool.replicas) == 1 and ctl._up_streak == 0
        pool.close()


# ----------------------------------------------------------------------
# Over HTTP on the port's server
# ----------------------------------------------------------------------


def streamed_baseline(files):
    """An un-upgraded server's answer to a long-running prompt."""
    clean = make_replica_state(files)
    url, server = serve_state(clean)
    try:
        return one_long_prompt(url)
    finally:
        server.shutdown()
        clean.close()


class TestRolloutServing:
    def test_acceptance_live_rollout_zero_failures_bit_identical(self, files):
        """A 2-replica pool upgraded while two streams decode: zero failed
        requests, the straddling streams equal the un-upgraded run's text,
        both replicas certified against the new version's golden, only the
        new version's anchors left, and /readyz reports it."""
        prompt, baseline = streamed_baseline(files)
        faults.install(faults.parse(SLOW))
        state = make_replica_state(files, sdc_canary_tokens=4)
        register_same(state, files)
        url, server = serve_state(state)
        try:
            for reserved in integrity.RESERVED_TENANTS:
                status, _ = post_raw(url, {"messages": [{"role": "user", "content": "x"}], "tenant": reserved})
                assert status == 400, reserved
            body = {"messages": [{"role": "user", "content": prompt}], "max_tokens": 96}
            s1, s2 = Sse(url, body), Sse(url, body)
            first1, first2 = s1.read_first_delta(), s2.read_first_delta()
            res = {}
            t = threading.Thread(target=lambda: res.update(r=post_admin(url, {"version": "v1"})))
            t.start()
            got1 = first1 + s1.read_rest()
            got2 = first2 + s2.read_rest()
            t.join(timeout=180)
            assert not t.is_alive()
            status, resp = res["r"]
            assert status == 200, resp
            assert resp["status"] == "complete" and resp["moved"] == 2
            assert got1 == baseline and got2 == baseline
            assert s1.error_type is None and s2.error_type is None
            pool = state.pool
            assert pool.weights_version == "v1"
            assert [r.weights_version for r in pool.replicas] == ["v1", "v1"]
            assert [r.integrity for r in pool.replicas] == ["ok", "ok"]
            assert set(pool.weights_reference) == {"v1"} and set(pool._canary_goldens) == {"v1"}
            assert pool.rollout_moves_total == 2 and pool.rollout_aborts_total == 0 and not pool._slot_versions
            status, after = post_raw(url, body)
            assert status == 200 and after["choices"][0]["message"]["content"] == baseline
            code, ready = get_json(url, "/readyz")
            assert code == 200 and ready["weights_version"] == "v1" and ready["rollout"] == {"active": False}
            for entry in ready["replicas"]:
                assert entry["weights_version"] == "v1" and entry["cordoned"] is False
                assert isinstance(entry["generation"], int)
            status, resp = post_admin(url, {"version": "v1"})
            assert status == 409 and resp["error"]["type"] == "rollout_conflict"
        finally:
            server.shutdown()
            state.close()

    def test_corrupt_rebuild_trips_checksum_gate_and_rolls_back(self, files):
        """``server.rollout kind=corrupt`` on replica 1: the rollout aborts
        typed, every replica is back on v0, the failed version leaves no
        golden, the canary certifies both replicas against v0's cleanly, and
        the moved-then-rolled-back engine and the corrupt build are freed
        (the corrupt build before the rollback builds again)."""
        faults.install(faults.parse("server.rollout:kind=corrupt,row=1,count=1"))
        state = make_replica_state(files, sdc_canary_tokens=4)
        register_same(state, files)
        pool = state.pool
        built = []
        alive_at_rollback = []
        build = pool.build_replica

        def tracked(idx):
            if len(built) == 2:  # the rollback's build: the corrupt one is freed already
                alive_at_rollback.append(built[1]() is not None)
            out = build(idx)
            built.append(weakref.ref(out[0]))
            return out

        pool.build_replica = tracked
        url, server = serve_state(state)
        try:
            prompt, baseline = one_long_prompt(url)
            status, resp = post_admin(url, {"version": "v1"})
            assert status == 500 and resp["error"]["type"] == "rollout_aborted"
            assert resp["rollout"] == {"active": False}
            assert pool.weights_version == "v0"
            assert [r.weights_version for r in pool.replicas] == ["v0", "v0"]
            assert pool.rollout_aborts_total == 1 and pool.rollout_moves_total == 1
            assert "v1" not in pool.weights_reference and "v1" not in pool._canary_goldens
            mismatches = pool.sdc_mismatches_total
            assert mismatches == 1  # the checksum gate, counted once
            assert pool.canary_tick() == 2 and pool.sdc_mismatches_total == mismatches
            status, after = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 96})
            assert status == 200 and after["choices"][0]["message"]["content"] == baseline
            # three builds: replica 0 on v1, replica 1's corrupt v1 build, and
            # replica 0's rollback; only the last is still referenced
            assert alive_at_rollback == [False]
            gc.collect()
            assert len(built) == 3
            assert [r() is None for r in built] == [True, True, False]
            assert built[2]() is pool.replicas[0].engine
        finally:
            server.shutdown()
            state.close()

    def test_server_drain_mid_rollout_aborts_clean_permits_home(self, files):
        """A drain lands while replica 2 of 3 is mid-cutover (a
        ``server.rollout kind=delay`` holds the window): the rollout aborts
        typed without rollback rebuilds, the streaming request ends equal to
        the baseline, and every admission permit comes home."""
        prompt, baseline = streamed_baseline(files)
        faults.install(faults.parse(SLOW + ";server.rollout:kind=delay,row=1,delay_ms=1500,count=1"))
        state = make_replica_state(files, replicas=3, sdc_canary_tokens=4)
        register_same(state, files)
        url, server = serve_state(state)
        try:
            s = Sse(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 96})
            first = s.read_first_delta()
            aborts = []

            def run():
                try:
                    state.rollout.run("v1")
                except fleet.RolloutAborted as e:
                    aborts.append(e)

            t = threading.Thread(target=run)
            t.start()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and state.pool.rollout_status().get("moved", 0) < 1:
                time.sleep(0.01)
            assert state.pool.rollout_status().get("moved", 0) >= 1
            state.begin_drain()
            t.join(timeout=120)
            assert not t.is_alive() and len(aborts) == 1
            got = first + s.read_rest()
            assert got == baseline and s.error_type is None
            assert state.admission.drain_wait(10.0)
            pool = state.pool
            assert pool.rollout_status() == {"active": False} and pool.rollout_aborts_total == 1
            assert pool.weights_version == "v0"
            versions = {r.weights_version for r in pool.replicas}
            assert versions <= {"v0", "v1"} and "v0" in versions
        finally:
            server.shutdown()
            state.close()


class TestFleetElasticityServing:
    def test_scale_up_serves_then_scale_down_returns_capacity(self, files):
        """Pressure grows a third replica through the factory and the
        checksum gate, it serves real traffic, idle shrinks back (its engine
        freed), and admission capacity is exact throughout."""
        state = make_replica_state(files)
        url, server = serve_state(state)
        try:
            ctl = fleet.FleetController(state, min_replicas=2, max_replicas=3, queue_high=1, up_ticks=2,
                                        down_ticks=2, drain_timeout_s=5.0)
            adm = state.admission
            assert adm.n_slots == 4

            def push(n=2):
                adm.rejected_total["load"] = adm.rejected_total.get("load", 0) + n

            push()
            assert ctl.tick() is None
            push()
            assert ctl.tick() == "up"
            pool = state.pool
            assert len(pool.replicas) == 3 and adm.n_slots == 6
            assert pool.replicas[2].weights_version == pool.weights_version
            grown = weakref.ref(pool.replicas[2].engine)
            for r in pool.replicas[:2]:  # the request must land on the grown replica
                for s in r.slots:
                    s.busy = True
            try:
                status, body = post_raw(url, {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 8})
            finally:
                for r in pool.replicas[:2]:
                    for s in r.slots:
                        s.busy = False
            assert status == 200 and body["usage"]["completion_tokens"] > 0
            assert len(get_json(url, "/readyz")[1]["replicas"]) == 3
            assert ctl.tick() is None
            assert ctl.tick() == "down"
            assert len(pool.replicas) == 2 and adm.n_slots == 4
            assert ctl.scale_events == {"up": 1, "down": 1}
            for _ in range(3):
                assert ctl.tick() is None
            assert len(pool.replicas) == 2
            gc.collect()
            assert grown() is None  # the retired replica's engine is freed
        finally:
            server.shutdown()
            state.close()


# ----------------------------------------------------------------------
# One scripted sequence through the JAX server and the port's
# ----------------------------------------------------------------------

PARITY_PLAN = "engine.sdc:kind=corrupt,row=1,count=0;server.rollout:kind=corrupt,row=1,count=1"
PARITY_SERIES = (
    "dllama_sdc_checks_total", 'dllama_sdc_mismatches_total{check="canary"}',
    'dllama_sdc_mismatches_total{check="checksum"}', "dllama_replica_failovers_total",
    "dllama_replica_restarts_total", "dllama_rollout_replicas_moved_total", "dllama_rollout_aborts_total",
    'dllama_fleet_scale_events_total{direction="up"}', 'dllama_fleet_scale_events_total{direction="down"}',
    "dllama_canary_latency_seconds_count", 'dllama_faults_injected_total{site="engine.sdc"}',
    'dllama_faults_injected_total{site="server.rollout"}',
)
PARITY_GAUGES = ('dllama_weights_version{version="v0"}', 'dllama_replica_state{replica="0"}',
                 'dllama_replica_state{replica="1"}', 'dllama_replica_state{replica="2"}')
# the flight-recorder fields that carry a decision (times, sequence numbers
# and checksums are left out)
FLIGHT_KEYS = ("kind", "frm", "to", "verdict", "fails", "version", "phase", "direction", "replicas", "drained",
               "site", "corrupt", "victims")


def _script(pkg, files):
    """The scripted sequence on one package's server; returns (decisions,
    metric deltas, gauges, flight rings)."""
    model, tok = files
    if pkg == "jax":
        from distributed_llama_tpu import retry as r_
        from distributed_llama_tpu import telemetry as tel
        from distributed_llama_tpu.engine import InferenceEngine as Engine
        from distributed_llama_tpu.engine import faults as fl
        from distributed_llama_tpu.loadgen.report import parse_prometheus
        from distributed_llama_tpu.server import fleet as fm
        from distributed_llama_tpu.server.api import ApiState
        from distributed_llama_tpu.telemetry import flight as fr
        from distributed_llama_tpu.tokenizer import Sampler, Tokenizer

        def engine():
            return Engine(model, dtype=jnp.float32)
    else:
        from distributed_llama_tpu_torch import retry as r_
        from distributed_llama_tpu_torch import telemetry as tel
        from distributed_llama_tpu_torch.engine import faults as fl
        from distributed_llama_tpu_torch.loadgen.report import parse_prometheus
        from distributed_llama_tpu_torch.server import fleet as fm
        from distributed_llama_tpu_torch.server.api import ApiState
        from distributed_llama_tpu_torch.telemetry import flight as fr
        from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer

        def engine():
            return InferenceEngine(model, dtype=torch.float32, device="cpu")
    tel.reset()
    tel.enable()
    fr.RECORDER.clear()
    plan = fl.parse(PARITY_PLAN)
    fl.install(plan)
    try:
        args = types.SimpleNamespace(temperature=0.0, topp=0.9, topk=0, seed=1, chat_template=None, parallel=2,
                                     replicas=2, batch_decode=True, decode="device", decode_chunk=4,
                                     replica_restart_backoff_s=0.05, sdc_canary_tokens=4)
        state = ApiState(engine(), Tokenizer.from_file(tok), Sampler(vocab_size=512, temperature=0.0, topp=0.9,
                                                                      seed=1), args, engine_factory=engine)
        pool = state.pool
        pool.restart_policy = r_.BackoffPolicy(attempts=r_.UNBOUNDED, base_s=0.05)
        state.register_weights_version("v1", engine)
        before = parse_prometheus(tel.prometheus_text())
        log = []

        def note(what, value=None):
            log.append((what, value, pool.states(), [r.integrity for r in pool.replicas],
                        [r.weights_version for r in pool.replicas], pool.failovers_total, pool.sdc_mismatches_total))

        for _ in range(2):
            note("tick", pool.canary_tick())
        plan.rules[0].count = 1  # engine.sdc arms on replica 1's next dispatch
        for _ in range(6):
            note("tick", pool.canary_tick())
            if pool.failovers_total:
                break
        assert pool.wait_state(1, "healthy", timeout_s=60)
        note("restarted", pool.replicas[1].restarts)
        note("tick", pool.canary_tick())
        try:
            state.rollout.run("v1")
            note("rollout", "complete")
        except fm.RolloutAborted:
            note("rollout", "aborted")
        note("rollout ledger", (pool.rollout_moves_total, pool.rollout_aborts_total, sorted(pool.weights_reference)))
        ctl = fm.FleetController(state, min_replicas=2, max_replicas=3, queue_high=1, up_ticks=2, down_ticks=2,
                                 drain_timeout_s=5.0)
        adm = state.admission
        for _ in range(2):
            adm.rejected_total["load"] = adm.rejected_total.get("load", 0) + 2
            note("fleet", (ctl.tick(), adm.n_slots))
        note("tick", pool.canary_tick())
        for _ in range(2):
            note("fleet", (ctl.tick(), adm.n_slots))
        after = parse_prometheus(tel.prometheus_text())
        rings = {k: [{f: e[f] for f in FLIGHT_KEYS if f in e} for e in ring]
                 for k, ring in fr.RECORDER.snapshot()["replicas"].items()}
        pool.close()
        return (log, {k: after.get(k, 0.0) - before.get(k, 0.0) for k in PARITY_SERIES},
                {k: after.get(k) for k in PARITY_GAUGES}, rings)
    finally:
        fl.clear()
        tel.disable()
        tel.reset()


def test_pool_decisions_and_metric_deltas_match_jax(files, monkeypatch):
    """Canary ticks on a clean pool, ``engine.sdc`` corrupting replica 1
    (suspect, then dead as corrupt, then rebuilt behind the checksum and
    re-certified), a rollout whose second move trips the checksum gate
    (rolled back), then a grow and a shrink: the JAX server and the port's
    take the same decisions in the same order, record the same flight
    events per replica and move the same series by the same amounts."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    want = _script("jax", files)
    got = _script("torch", files)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    log = got[0]
    assert ("rollout", "aborted") == log[[x[0] for x in log].index("rollout")][:2]
    assert got[1]["dllama_replica_failovers_total"] == 1 and got[1]["dllama_rollout_aborts_total"] == 1
    assert got[1]['dllama_fleet_scale_events_total{direction="up"}'] == 1
    assert got[1]['dllama_fleet_scale_events_total{direction="down"}'] == 1


# ----------------------------------------------------------------------
# The load generator: the rollout gate and the self-host
# ----------------------------------------------------------------------


def test_check_rollout_equals_jax():
    from distributed_llama_tpu.loadgen import report as jrep
    from distributed_llama_tpu.loadgen import runner as jrun

    from distributed_llama_tpu_torch.loadgen import report as trep
    from distributed_llama_tpu_torch.loadgen import runner as trun

    def results(mod, outcomes):
        return [mod.RequestResult(index=i, tenant="t", at_s=0.0, body_key="k", prefix_id=0, outcome=o,
                                  status=200 if o == "completed" else 500)
                for i, o in enumerate(outcomes)]

    for rollout in ({"status": 200, "response": {"status": "complete"}}, {"status": 500, "response": {"x": 1}},
                    {"status": None, "error": "URLError: refused"}):
        for outcomes in (["completed", "rejected_429"], ["completed", "error"]):
            assert trep.check_rollout(rollout, results(trun, outcomes)) == jrep.check_rollout(
                rollout, results(jrun, outcomes))


@pytest.mark.parametrize("extra,gate", [
    (["--rollout-weights", "same"], "rollout"),
    (["--canary-interval-s", "0.2", "--shadow-rate", "1.0", "--expect-zero", "dllama_sdc_mismatches_total",
      "--expect-delta", "dllama_sdc_checks_total:1"], "expected_zero"),
], ids=["rollout", "canary"])
def test_cli_selfhost_rollout_and_canary(tmp_path, extra, gate):
    """``--self-host --device cpu --replicas 2``, 24 requests at 10 rps: a
    mid-window rollout to identical weights (every request completes,
    greedy consistency holds across it, both replicas moved), then the
    canary and shadow votes under load, at least one check and no mismatch
    counted (how many checks land in the window depends on the host's
    load)."""
    from distributed_llama_tpu_torch.loadgen import __main__ as tmain

    out = tmp_path / "report.json"
    try:
        code = tmain.main(["--self-host", "--device", "cpu", "--replicas", "2", "--requests", "24", "--rate", "10",
                           "--warmup", "1", "--parallel", "2", "--admission-queue", "32", "--assert", *extra,
                           "--out", str(out)])
    finally:
        telemetry.disable()
        telemetry.reset()
    assert code == 0
    report = json.loads(out.read_text())
    assert report["checks"][gate]["ok"]
    assert report["aggregate"]["counts"]["completed"] == 24
    if gate == "rollout":
        assert report["checks"]["rollout"]["response"]["moved"] == 2
        assert report["server"]["dllama_rollout_replicas_moved_total"] == 2


# ----------------------------------------------------------------------
# The lock witness over the canary and the fleet operations
# ----------------------------------------------------------------------


def test_canary_and_fleet_ops_run_clean_under_witness(monkeypatch, files):  # noqa: F811
    """``DLT_LOCK_CHECK=1`` set before the server is built (the ledger
    records without raising): canary ticks through an ``engine.sdc``
    corruption to a corrupt death and its restart, a shadow vote, a rollout
    while a stream decodes, and a grow and a shrink record no inversion
    between the fleet lock, the pool's and the schedulers' conditions."""
    from distributed_llama_tpu_torch import lockcheck

    monkeypatch.setenv("DLT_LOCK_CHECK", "1")
    lockcheck.configure(mode="warn")  # ranks: the declared hierarchy
    lockcheck.reset()
    saved = flight.RECORDER
    try:
        flight.RECORDER = flight.FlightRecorder()
        plan = faults.install(faults.parse("engine.sdc:kind=corrupt,row=1,count=0;" + SLOW))
        state = make_replica_state(files, sdc_canary_tokens=4)
        register_same(state, files)
        assert "_WitnessLock" in repr(state._fleet_lock)
        pool = state.pool
        url, server = serve_state(state)
        try:
            assert pool.canary_tick() == 2
            plan.rules[0].count = 1
            for _ in range(6):
                pool.canary_tick()
                if pool.failovers_total:
                    break
            assert pool.failovers_total == 1 and pool.wait_state(1, "healthy", timeout_s=60)
            assert pool.shadow_vote(state._canary_probe, [{"role": "user", "content": "hi"}]) is True
            s = Sse(url, {"messages": [{"role": "user", "content": "tell me a story"}], "max_tokens": 48})
            assert s.read_first_delta() is not None
            assert state.rollout.run("v1")["moved"] == 2
            s.read_rest()
            assert s.error_type is None
            ctl = fleet.FleetController(state, min_replicas=2, max_replicas=3, queue_high=1, up_ticks=1,
                                        down_ticks=1)
            state.admission.rejected_total["load"] = 2
            assert ctl.tick() == "up"
            assert ctl.tick() == "down"
        finally:
            server.shutdown()
            state.close()
        assert lockcheck.violations() == [], lockcheck.violations()
    finally:
        flight.RECORDER = saved
        faults.clear()
        lockcheck.configure()
        lockcheck.reset()
