"""The port's supervised replica pool held against the JAX package's.

* Pure host decisions, port against JAX on the same inputs (seeded
  scripts over fake replicas, no engines): ``route_score``, the lane
  ``place``/``_pick_slot_locked`` picks (chat affinity, shared-index depth,
  load, suspect fallback) and the health walk (round trips past and under
  the suspect threshold, stalls, losses, generation echoes) with its
  counters. Exact.
* The JAX package's pool cases (tests/test_replicas.py ``TestPoolPlacement``,
  ``TestPoolHealth``, ``TestPoolPreemptionFanout``,
  ``TestPlacementBounceAccounting``, ``TestReadyzSchema``), on the port.
* Failover on the port's server over HTTP (one synthetic f32 model, dim 64,
  hd 16, seq_len 192, a ChatML tokenizer; 2 replicas x 2 lanes; every
  fetch delayed 25 ms so the crash lands mid-decode): a ``replica.crash``
  on replica 0 after 16 dispatch hits; the 4 streams equal an unfaulted
  run's text exactly (a duplicated or lost SSE delta would break the
  equality), the failover and replay counters equal the victim count, the
  dead replica walks dead -> healthy, its rebuild passes the weight
  checksum, and it serves again. With telemetry on the same crash yields
  one trace tree per victim with a ``replay`` sibling attempt, and the
  flight recorder holds the fault fire, the failover (with the victims'
  trace ids) and the death dump.
* The flight recorder's ring cases (tests/test_tracing.py
  ``TestFlightRecorder``), on the port.
"""

import gc
import http.client
import json
import random
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request
import weakref

import pytest
import torch

from distributed_llama_tpu import retry as jretry
from distributed_llama_tpu.server import replicas as jreps

from distributed_llama_tpu_torch import retry, telemetry
from distributed_llama_tpu_torch.engine import InferenceEngine, faults
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.server import api as tapi
from distributed_llama_tpu_torch.server.admission import FairAdmission
from distributed_llama_tpu_torch.server.replicas import (
    DEAD,
    HEALTHY,
    SUSPECT,
    NoPlaceableReplica,
    Replica,
    ReplicaPool,
)
from distributed_llama_tpu_torch.telemetry import flight
from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=192)
CHATML = "{% for m in messages %}<|im_start|>{{m.role}}...{% endfor %}"
# every batched fetch on both replicas sleeps, so the crash lands while all
# four streams are mid-decode; a delay corrupts nothing
SLOW = "batch.fetch:kind=delay,delay_ms=25,count=-1"
CRASH = f"replica.crash:kind=raise,row=0,after=16,count=1;{SLOW}"


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    faults.clear()
    yield
    faults.clear()


# ----------------------------------------------------------------------
# Fake replicas (no engines)
# ----------------------------------------------------------------------


class FakeCache:
    def __init__(self, match=0, items=()):
        self._match = match
        self.items = list(items)

    def match_len(self, messages):
        return self._match


def fake_slot(match=0, items=()):
    return types.SimpleNamespace(busy=False, tenant=None, cache=FakeCache(match, items))


def fake_pool(n_replicas=2, lanes=2, admission=None, supervise=False, module=None, **kw):
    """A pool of fake replicas (lanes with fake chat caches), the port's or
    (``module``) the JAX package's."""
    m = module
    built = []

    def build(idx):
        built.append(idx)
        return None, None, [fake_slot() for _ in range(lanes)]

    replica_cls, pool_cls = (Replica, ReplicaPool) if m is None else (m.Replica, m.ReplicaPool)
    policy = (retry if m is None else jretry).BackoffPolicy(attempts=3, base_s=0.0)
    pool = pool_cls(build, [replica_cls(i, None, None, [fake_slot() for _ in range(lanes)])
                            for i in range(n_replicas)],
                    admission=admission, supervise=supervise, restart_policy=policy, restart_seed=0, **kw)
    pool._built = built
    return pool


class FakeIndex:
    def __init__(self, depths):
        self.depths = depths

    def match(self, tokens):
        return dict(self.depths)

    def drop_owner(self, owner):
        self.depths.pop(owner, None)


# ----------------------------------------------------------------------
# Host decisions against the JAX package's
# ----------------------------------------------------------------------


def test_route_score_matches_jax():
    for depth in range(0, 12):
        for active in range(0, 6):
            assert ReplicaPool.route_score(depth, active) == jreps.ReplicaPool.route_score(depth, active)
    assert ReplicaPool.ROUTE_LOAD_DISCOUNT == jreps.ReplicaPool.ROUTE_LOAD_DISCOUNT


@pytest.mark.parametrize("seed", range(6))
def test_placement_picks_match_jax(seed):
    """Seeded scenes of 3 replicas x 3 lanes: random busy lanes, chat-cache
    matches and items, shared-index depths and suspect/dead states; both
    pools place lanes until nothing is free and pick the same (replica,
    lane) every time, with the same shared-hit counts."""
    rng = random.Random(seed)
    for _ in range(20):
        scene = [[(rng.random() < 0.3, rng.choice((0, 0, 0, 1, 2)), rng.random() < 0.5) for _ in range(3)]
                 for _ in range(3)]
        states = [rng.choice((HEALTHY, HEALTHY, SUSPECT, DEAD)) for _ in range(3)]
        depths = {i: rng.randrange(4) for i in range(3) if rng.random() < 0.6}
        picks = []
        for module in (None, jreps):
            pool = fake_pool(n_replicas=3, lanes=3, module=module, shared_index=FakeIndex(dict(depths)))
            pool.place_timeout_s = 0.0
            for r, (rep, lanes) in enumerate(zip(pool.replicas, scene)):
                rep.state = states[r]
                for slot, (busy, match, items) in zip(rep.slots, lanes):
                    slot.busy = busy
                    slot.cache = FakeCache(match, ["x"] if items else [])
            got = []
            while True:
                try:
                    slot = pool.place([{"role": "user", "content": "x"}], route_tokens=[1])
                except faults.ReplicaLost:
                    break
                except jreps.NoPlaceableReplica:
                    break
                got.append(next((r.idx, r.slots.index(slot)) for r in pool.replicas if slot in r.slots))
            picks.append((got, pool.shared_hits_total))
        assert picks[0] == picks[1]


@pytest.mark.parametrize("seed", range(4))
def test_health_walk_matches_jax(seed):
    """Seeded event scripts (round trips either side of the threshold,
    stalls, losses, stale generations) over 2 unsupervised replicas: the
    states, suspects, failovers, victims and admission capacity stay equal."""
    from distributed_llama_tpu.server.admission import FairAdmission as JaxAdmission

    rng = random.Random(seed)
    events = [(rng.randrange(2), rng.choice((0, 0, 0, 1)), rng.choice(("roundtrip", "roundtrip", "stall", "lost")),
               rng.choice((0.5, 2.5)), rng.randrange(3)) for _ in range(30)]
    runs = []
    for module, adm in ((None, FairAdmission(4)), (jreps, JaxAdmission(4))):
        pool = fake_pool(module=module, admission=adm, suspect_roundtrip_s=1.0)
        trail = []
        for idx, gen, event, value, busy in events:
            for i, s in enumerate(pool.replicas[idx].slots):
                s.busy = i < busy
            pool._on_event(idx, gen, event, value)
            trail.append((pool.states(), pool.suspects_total, pool.failovers_total, pool.last_failover_victims,
                          adm.n_slots))
        runs.append(trail)
    assert runs[0] == runs[1]


# ----------------------------------------------------------------------
# The JAX package's pool cases, on the port
# ----------------------------------------------------------------------


class TestPoolPlacement:
    def test_least_loaded_wins_without_affinity(self):
        pool = fake_pool()
        pool.replicas[0].slots[0].busy = True
        slot = pool.place([{"role": "user", "content": "x"}])
        assert slot in pool.replicas[1].slots and slot.busy

    def test_affinity_beats_load(self):
        pool = fake_pool()
        pool.replicas[0].slots[0].busy = True
        pool.replicas[0].slots[1].cache = FakeCache(match=3, items=["x"])
        assert pool.place([{"role": "user", "content": "x"}]) is pool.replicas[0].slots[1]

    def test_depth_discounted_routing_beats_pure_rankings(self):
        depths = {0: 8, 1: 6}
        pool = fake_pool(n_replicas=3, lanes=5, shared_index=FakeIndex(depths))
        for s in pool.replicas[0].slots[:4]:
            s.busy = True
        pool.replicas[1].slots[0].busy = True
        assert max(range(3), key=lambda i: depths.get(i, 0)) == 0
        assert min(range(3), key=lambda i: pool.replicas[i].active()) == 2
        assert pool.place([], route_tokens=[1, 2, 3]) in pool.replicas[1].slots
        depths.clear()
        assert pool.place([], route_tokens=[1, 2, 3]) in pool.replicas[2].slots

    def test_suspect_is_fallback_dead_never_places(self):
        pool = fake_pool()
        with pool._cond:
            pool._set_state_locked(pool.replicas[0], SUSPECT)
        assert pool.place([]) in pool.replicas[1].slots
        for s in pool.replicas[1].slots:
            s.busy = True
        assert pool.place([]) in pool.replicas[0].slots
        with pool._cond:
            pool._set_state_locked(pool.replicas[0], DEAD)
        for s in pool.replicas[0].slots:
            s.busy = False
        pool.place_timeout_s = 0.05
        with pytest.raises(NoPlaceableReplica):
            pool.place([])

    def test_place_deadline_is_504_not_replica_lost(self):
        pool = fake_pool()
        for r in pool.replicas:
            for s in r.slots:
                s.busy = True
        with pytest.raises(faults.DeadlineExceeded):
            pool.place([], deadline=time.monotonic() - 0.01)

    def test_release_wakes_a_placement_waiter(self):
        pool = fake_pool(n_replicas=1, lanes=1)
        held = pool.place([])
        got = []
        t = threading.Thread(target=lambda: got.append(pool.place([])), daemon=True)
        t.start()
        time.sleep(0.05)
        pool.release(held)
        t.join(timeout=5)
        assert not t.is_alive() and got and got[0].busy


class TestPoolHealth:
    def test_roundtrip_walks_suspect_and_back(self):
        pool = fake_pool(suspect_roundtrip_s=1.0)
        rep = pool.replicas[0]
        pool._on_event(0, rep.generation, "roundtrip", 2.5)
        assert rep.state == SUSPECT and pool.suspects_total == 1
        pool._on_event(0, rep.generation, "roundtrip", 0.1)
        assert rep.state == HEALTHY

    def test_stall_marks_suspect_lost_marks_dead_and_resizes(self):
        adm = FairAdmission(4)
        pool = fake_pool(admission=adm)
        rep = pool.replicas[0]
        pool._on_event(0, rep.generation, "stall", 1.0)
        assert rep.state == SUSPECT
        rep.slots[0].busy = True
        pool._on_event(0, rep.generation, "lost", 1.0)
        assert rep.state == DEAD and pool.failovers_total == 1 and pool.last_failover_victims == 1
        assert adm.n_slots == 2

    def test_supervised_loss_restarts_and_restores_capacity(self):
        adm = FairAdmission(4)
        pool = fake_pool(admission=adm, supervise=True)
        rep = pool.replicas[0]
        old_slots = rep.slots
        pool._on_event(0, rep.generation, "lost", 0.0)
        assert pool.wait_state(0, HEALTHY, timeout_s=10)
        assert pool._built == [0]
        assert rep.generation == 1 and rep.restarts == 1 and pool.restarts_total == 1
        assert rep.slots is not old_slots and len(rep.slots) == 2
        assert adm.n_slots == 4

    def test_generation_guard_drops_echoes_from_replaced_scheduler(self):
        pool = fake_pool(supervise=True)
        rep = pool.replicas[0]
        pool._on_event(0, rep.generation, "lost", 0.0)
        assert pool.wait_state(0, HEALTHY, timeout_s=10)
        pool._on_event(0, 0, "lost", 0.0)
        assert rep.state == HEALTHY and pool.failovers_total == 1

    def test_closed_pool_does_not_restart(self):
        pool = fake_pool(supervise=True)
        pool.close()
        pool._on_event(0, pool.replicas[0].generation, "lost", 0.0)
        time.sleep(0.1)
        assert pool._built == [] and pool.replicas[0].state == DEAD

    def test_resize_supports_zero_capacity_and_regrowth(self):
        adm = FairAdmission(2)
        adm.acquire("a")
        adm.resize(-2)
        assert adm.n_slots == 0 and adm.free_slots() == -1
        adm.release()
        assert adm.free_slots() == 0
        adm.resize(2)
        assert adm.free_slots() == 2
        with pytest.raises(ValueError):
            adm.resize(-3)

    def test_malformed_expect_delta_is_a_violation_not_a_crash(self):
        from distributed_llama_tpu_torch.loadgen.report import check_expected_deltas

        chk = check_expected_deltas({"server": {"x": 1.0}}, ["x:one", "x:1"])
        assert not chk["ok"] and any("malformed" in v for v in chk["violations"])
        assert chk["expected"] == {"x": 1.0}

    def test_replica_metrics_have_enabled_mode_coverage(self):
        telemetry.reset()
        telemetry.enable()
        try:
            pool = fake_pool(supervise=False)
            pool._on_event(0, 0, "lost", 0.0)
            text = telemetry.prometheus_text()
            assert 'dllama_replica_state{replica="0"} 2' in text
            assert 'dllama_replica_state{replica="1"} 0' in text
            assert "dllama_replica_failovers_total 1" in text
        finally:
            telemetry.disable()
            telemetry.reset()

    def test_rebuild_checksum_mismatch_is_refused(self):
        """A rebuild whose weights miss the load-time checksum never
        re-enters placement: the attempt fails, is counted, and the pool
        retries with a good build."""
        good = types.SimpleNamespace(params={"w": torch.arange(8, dtype=torch.float32)})
        bad = types.SimpleNamespace(params={"w": torch.arange(8, dtype=torch.float32) + 1})
        from distributed_llama_tpu_torch.engine import integrity

        builds = [bad, good]
        pool = ReplicaPool(lambda idx: (builds.pop(0), None, [fake_slot()]), [Replica(0, None, None, [fake_slot()])],
                           supervise=True, restart_policy=retry.BackoffPolicy(attempts=3, base_s=0.0),
                           restart_seed=0)
        pool.register_version(pool.weights_version, integrity.params_checksum(good.params))
        pool._on_event(0, 0, "lost", 0.0)
        assert pool.wait_state(0, HEALTHY, timeout_s=10)
        assert pool.sdc_checks_total == 2 and pool.sdc_mismatches_total == 1
        assert pool.replicas[0].engine is good


# ----------------------------------------------------------------------
# The port's server: replicas over HTTP
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_replicas")
    tsyn.write_synthetic_model(str(d / "m.m"), tsyn.tiny_spec(**SPEC), seed=0)
    data = tsyn.synthetic_tokenizer_data(vocab_size=SPEC["vocab_size"])
    data.chat_template = CHATML
    with open(d / "t.t", "wb") as f:
        write_tokenizer_file(f, data)
    return str(d / "m.m"), str(d / "t.t")


def make_replica_state(files, *, replicas=2, parallel=2, **extra):
    """A replica-enabled ApiState over one tiny model file: every replica
    (and every restart) loads the same weights, which is what makes a
    failover replay equal the original stream."""
    model, tok = files
    args = types.SimpleNamespace(temperature=0.0, topp=0.9, topk=0, seed=1, chat_template=None, parallel=parallel,
                                 replicas=replicas, batch_decode=True, decode="device", decode_chunk=4,
                                 replica_restart_backoff_s=0.05, **extra)

    def factory():
        return InferenceEngine(model, dtype=torch.float32, device="cpu")

    state = tapi.ApiState(factory(), Tokenizer.from_file(tok),
                          Sampler(vocab_size=SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1), args,
                          engine_factory=factory)
    state.pool.restart_policy = retry.BackoffPolicy(attempts=retry.UNBOUNDED, base_s=0.05)
    return state


def serve_state(state):
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), tapi.make_handler(state))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}", server


def post_raw(url, body, timeout=120):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_json(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class SseStream:
    """An SSE completion read as it arrives."""

    def __init__(self, url, body):
        p = urllib.parse.urlsplit(url)
        self.conn = http.client.HTTPConnection(p.hostname, p.port, timeout=120)
        self.conn.request("POST", "/v1/chat/completions", json.dumps({**body, "stream": True}),
                          {"Content-Type": "application/json"})
        self.resp = self.conn.getresponse()
        assert self.resp.status == 200
        self.error_type = None

    def read_all(self) -> str:
        parts = []
        for raw in self.resp:
            line = raw.strip()
            if not line.startswith(b"data: "):
                continue
            if line[6:] == b"[DONE]":
                break
            evt = json.loads(line[6:])
            if "error" in evt:
                self.error_type = evt["error"]["type"]
                break
            parts.append((evt["choices"][0].get("delta") or {}).get("content", ""))
        self.conn.close()
        return "".join(parts)


def one_long_prompt(url, min_tokens=24):
    for cand in ("tell me a very long story", "hello world hello world", "alpha bravo charlie delta echo",
                 "the quick brown fox jumps", "one two three four five six"):
        status, body = post_raw(url, {"messages": [{"role": "user", "content": cand}], "max_tokens": 96})
        assert status == 200
        if body["usage"]["completion_tokens"] >= min_tokens:
            return cand, body["choices"][0]["message"]["content"]
    raise AssertionError("no candidate prompt streams long enough")


def crash_run(files, prompt):
    """4 concurrent SSE streams of ``prompt`` over 2 replicas x 2 lanes with
    replica 0 crashing mid-decode; returns (state, url, server, texts,
    request ids, a weak reference to replica 0's first engine)."""
    faults.install(faults.parse(CRASH))
    state = make_replica_state(files)
    engine0 = weakref.ref(state.pool.replicas[0].engine)
    url, server = serve_state(state)
    streams = [SseStream(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 96})
               for _ in range(4)]
    rids = [s.resp.getheader("X-Request-Id") for s in streams]
    texts = [s.read_all() for s in streams]
    assert all(s.error_type is None for s in streams), [s.error_type for s in streams]
    return state, url, server, texts, rids, engine0


@pytest.fixture(scope="module")
def baseline(files):
    """An unfaulted replica server's answer to a long-running prompt (96
    tokens) and to the same prompt at 8 tokens."""
    state = make_replica_state(files)
    url, server = serve_state(state)
    try:
        prompt, text = one_long_prompt(url)
        status, b8 = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 8})
        assert status == 200
        return prompt, text, b8["choices"][0]["message"]["content"]
    finally:
        server.shutdown()
        state.close()


class TestReplicaFailover:
    def test_crash_mid_decode_replays_bit_identical_and_restarts(self, files, baseline):
        prompt, text, text8 = baseline
        state, url, server, texts, _, engine0 = crash_run(files, prompt)
        try:
            assert texts == [text] * 4
            pool = state.pool
            assert pool.failovers_total == 1 and pool.last_failover_victims == 2
            assert pool.replayed_total == pool.last_failover_victims
            assert pool.wait_state(0, HEALTHY, timeout_s=60)
            # the dead replica's engine (its weights) and scheduler (slab,
            # pool) are freed: nothing of the server still references them
            gc.collect()
            assert engine0() is None
            assert pool.restarts_total == 1 and state.admission.n_slots == 4
            assert pool.sdc_checks_total == 1 and pool.sdc_mismatches_total == 0  # the rebuild's checksum
            for s in pool.replicas[1].slots:  # placement must choose the restarted replica
                s.busy = True
            try:
                status, body = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 8})
                assert status == 200 and body["choices"][0]["message"]["content"] == text8
            finally:
                for s in pool.replicas[1].slots:
                    s.busy = False
        finally:
            server.shutdown()
            state.close()

    def test_crash_yields_one_tree_with_replay_sibling(self, files, baseline):
        """With telemetry on, each victim's trace is one tree whose second
        attempt is tagged replayed (its time in the ``replay`` stage), the
        healthy streams have one attempt, and the flight recorder holds the
        injection, the failover naming the victims' trace ids, and the
        replica-death dump."""
        telemetry.reset()
        telemetry.enable()
        flight.RECORDER.clear()
        try:
            state, url, server, texts, rids, _ = crash_run(files, baseline[0])
            try:
                assert texts == [baseline[1]] * 4
                trees = {rid: get_json(url, f"/debug/trace/{rid}")[1] for rid in rids}
                victims = [t for t in trees.values() if len(t["attempts"]) == 2]
                healthy = [t for t in trees.values() if len(t["attempts"]) == 1]
                assert len(victims) == 2 and len(healthy) == 2
                for t in victims:
                    first, replay = t["attempts"]
                    assert first["replayed"] is False and replay["replayed"] is True
                    assert first["replica"] == 0 and replay["replica"] in (0, 1)
                    assert replay["start_us"] > first["start_us"]
                    assert t["stages"].get("replay", 0) > 0
                for t in healthy:
                    assert t["attempts"][0]["replayed"] is False and "replay" not in t["stages"]
                status, snap = get_json(url, "/debug/flight")
                assert status == 200
                events = [e for ring in snap["replicas"].values() for e in ring]
                assert any(e["kind"] == "fault_fire" and e["site"] == "replica.crash" for e in events)
                fos = [e for e in events if e["kind"] == "failover"]
                assert len(fos) == 1
                assert set(fos[0]["victim_trace_ids"]) == {t["request_id"] for t in victims}
                dumps = [d for d in snap["dumps"] if d["reason"] == "replica_death"]
                assert len(dumps) == 1 and dumps[0]["replica"] == 0
                assert any(e["kind"] == "fault_fire" and e["site"] == "replica.crash" for e in dumps[0]["events"])
                text = telemetry.prometheus_text()
                assert "dllama_replica_failovers_total 1" in text and "dllama_replayed_requests_total 2" in text
                assert state.pool.wait_state(0, HEALTHY, timeout_s=60)
            finally:
                server.shutdown()
                state.close()
        finally:
            telemetry.disable()
            telemetry.reset()


class TestPoolPreemptionFanout:
    def test_evicts_the_globally_lowest_priority_victim(self, files):
        state = make_replica_state(files)
        r0 = state.pool.replicas[0].slots[0].stream
        r1 = state.pool.replicas[1].slots[0].stream
        r0.priority, r1.priority = 3, 1
        try:
            assert state.pool.preempt_below(5)
            assert isinstance(r1._fetch_error, faults.RowPreempted) and r0._fetch_error is None
            assert state.pool.preempt_below(5)
            assert isinstance(r0._fetch_error, faults.RowPreempted)
        finally:
            r0.priority = r1.priority = None
            state.close()


class TestPlacementBounceAccounting:
    def test_placement_bounce_requeues_without_counting_replays(self, files):
        assert issubclass(NoPlaceableReplica, faults.ReplicaLost)
        state = make_replica_state(files, replicas=1)

        def bounce(messages, deadline=None, route_tokens=None):
            raise NoPlaceableReplica("every replica down")

        state.pool.place = bounce
        with pytest.raises(faults.ReplicaLost):
            state.complete({"messages": [{"role": "user", "content": "x"}], "max_tokens": 2}, lambda s: None)
        assert state.pool.replayed_total == 0
        assert state.admission.free_slots() == state.admission.n_slots
        state.close()


class TestReadyzSchema:
    def test_readyz_json_body_and_drain_contract(self, files):
        state = make_replica_state(files)
        url, server = serve_state(state)
        try:
            status, body = get_json(url, "/readyz")
            assert status == 200 and body["status"] == "ready" and body["draining"] is False
            assert body["queue_depth"] == 0 and body["free_slots"] == 4
            assert [r["replica"] for r in body["replicas"]] == [0, 1]
            assert all(r["state"] == "healthy" and r["slots"] == 2 and r["active_rows"] == 0 and r["restarts"] == 0
                       and r["cache"]["pages"] == 0 for r in body["replicas"])
            state.pool.supervise = False  # a fast restart must not race the read
            state.pool.mark_dead(1, "test")
            status, body = get_json(url, "/readyz")
            assert status == 200 and body["replicas"][1]["state"] == "dead" and body["free_slots"] == 2
            state.begin_drain()
            status, body = get_json(url, "/readyz")
            assert status == 503 and body["status"] == "draining" and body["draining"] is True
        finally:
            server.shutdown()
            state.close()


# ----------------------------------------------------------------------
# Flight recorder rings (tests/test_tracing.py TestFlightRecorder)
# ----------------------------------------------------------------------


class TestFlightRecorder:
    def test_rings_are_per_replica_and_bounded(self):
        rec = flight.FlightRecorder(capacity=8)
        for i in range(20):
            rec.record(0, "state", frm=0, to=1, i=i)
        rec.record(1, "failover", victims=2)
        snap = rec.snapshot()
        assert len(snap["replicas"]["0"]) == 8 and snap["replicas"]["0"][-1]["i"] == 19
        assert snap["replicas"]["1"][0]["kind"] == "failover"
        assert snap["recorded_total"] == 21 and snap["replicas"]["1"][0]["seq"] == 21

    def test_dump_snapshots_ring_and_is_bounded(self, tmp_path):
        rec = flight.FlightRecorder(max_dumps=2, dump_dir=str(tmp_path))
        rec.record(0, "replica_lost", cause="crash", victims=2)
        d = rec.dump(0, "replica_death", victim_trace_ids=["a", "b"])
        assert d["reason"] == "replica_death" and d["victim_trace_ids"] == ["a", "b"]
        assert [e["kind"] for e in d["events"]] == ["replica_lost"]
        for _ in range(3):
            rec.dump(0, "watchdog_stall")
        assert len(rec.dumps()) == 2
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(list(tmp_path.glob("dllama-flight-r0-*.json"))) < 4:
            time.sleep(0.01)
        art = json.loads(sorted(tmp_path.glob("dllama-flight-r0-*.json"))[0].read_text())
        assert art["reason"] == "replica_death"

    def test_fault_observer_records_site(self):
        flight.install_fault_observer()
        flight.RECORDER.clear()
        faults.install(faults.parse("batch.row:kind=raise,row=3,count=1"))
        with pytest.raises(faults.InjectedFault):
            faults.active_plan().fire("batch.row", row=3)
        fires = [e for ring in flight.RECORDER.snapshot()["replicas"].values() for e in ring
                 if e["kind"] == "fault_fire"]
        assert len(fires) == 1 and fires[0]["site"] == "batch.row" and fires[0]["fault_kind"] == "raise"
        assert fires[0]["replica"] == 3

    def test_untargeted_fire_lands_in_unscoped_ring(self):
        flight.install_fault_observer()
        faults.install(faults.parse("engine.forward:kind=raise,count=1"))
        with pytest.raises(faults.InjectedFault):
            faults.active_plan().fire("engine.forward")
        assert str(flight.UNSCOPED) in flight.RECORDER.snapshot()["replicas"]
