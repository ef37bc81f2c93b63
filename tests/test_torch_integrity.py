"""The port's SDC canary, shadow votes and corrupt-replica failover, held
against the JAX package's.

* The JAX package's ``TestCanary`` cases (tests/test_integrity.py), on the
  port's server over HTTP: a tiny synthetic f32 model (dim 64, 2 layers,
  seq_len 320, a ChatML tokenizer), replicas of 2-3 lanes. Exact: a golden is
  set once and matched bit for bit (tokens and logit fingerprint); a
  corrupted replica's mismatches walk it suspect then dead as corrupt; a
  victim that streamed deltas ends with ``replica_corrupt`` and is never
  replayed, one that streamed none replays; rebuilds pass the weight
  checksum; a probe never holds an admission permit; clients cannot bill the
  reserved tenants.
* The canary's fingerprint folds exactly the chunks behind the decoded
  tokens, and a probe that shares its batched steps with a long decoding row
  reproduces the golden bit for bit.
* Parity with the JAX probe (tolerance: none): the same pinned prompt on the
  same f32 model decodes the same canary tokens in both packages.
  Fingerprints are compared only within a package.
"""

import threading
import time

import jax.numpy as jnp
import pytest

from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.server import api as tapi
from distributed_llama_tpu_torch.server.replicas import HEALTHY, SUSPECT

from tests.test_torch_replicas import CHATML, SseStream, make_replica_state, post_raw, serve_state

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=320)
SLOW = "batch.fetch:kind=delay,delay_ms=25,count=-1"


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    faults.clear()
    yield
    faults.clear()


def write_files(d, seq_len=SPEC["seq_len"], seed=0):
    """A tiny synthetic f32 model and a ChatML tokenizer under ``d``."""
    spec = dict(SPEC, seq_len=seq_len)
    tsyn.write_synthetic_model(str(d / "m.m"), tsyn.tiny_spec(**spec), seed=seed)
    data = tsyn.synthetic_tokenizer_data(vocab_size=spec["vocab_size"])
    data.chat_template = CHATML
    with open(d / "t.t", "wb") as f:
        write_tokenizer_file(f, data)
    return str(d / "m.m"), str(d / "t.t")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(tmp_path_factory.mktemp("torch_integrity"))


class Sse(SseStream):
    """An SSE completion read in two parts: its first content delta, then
    the rest."""

    def _events(self):
        import json

        if not hasattr(self, "_it"):
            self._it = iter(self.resp)
        for raw in self._it:
            line = raw.strip()
            if not line.startswith(b"data: "):
                continue
            if line[6:] == b"[DONE]":
                return
            yield json.loads(line[6:])

    def _content(self, evt):
        if "error" in evt:
            self.error_type = evt["error"]["type"]
            return None
        return (evt["choices"][0].get("delta") or {}).get("content", "")

    def read_first_delta(self) -> str:
        for evt in self._events():
            text = self._content(evt)
            if text is None or text:
                return text or ""
        return ""

    def read_rest(self) -> str:
        parts = []
        for evt in self._events():
            text = self._content(evt)
            if text is None:
                break
            parts.append(text)
        self.conn.close()
        return "".join(parts)


def tick_until(pool, pred, max_ticks=20):
    """Manual canary ticks until ``pred()`` holds; returns the tick count."""
    for i in range(1, max_ticks + 1):
        pool.canary_tick()
        if pred():
            return i
    raise AssertionError(f"not detected within {max_ticks} canary ticks")


def long_prompt(url, min_tokens=24):
    for cand in ("tell me a very long story", "alpha bravo charlie delta echo", "hello world hello world",
                 "the quick brown fox jumps", "one two three four five six"):
        status, body = post_raw(url, {"messages": [{"role": "user", "content": cand}], "max_tokens": 96})
        assert status == 200
        if body["usage"]["completion_tokens"] >= min_tokens:
            return cand
    raise AssertionError("no candidate prompt streams long enough")


# ----------------------------------------------------------------------
# The JAX package's TestCanary cases, on the port
# ----------------------------------------------------------------------


class TestCanary:
    def test_canary_records_golden_certifies_and_reports(self, files):
        from tests.test_torch_replicas import get_json

        state = make_replica_state(files)
        url, server = serve_state(state)
        try:
            pool = state.pool
            assert pool.canary_probe is not None  # armed at ApiState build
            assert pool.weights_reference.get(pool.weights_version)
            assert pool.canary_tick() == 2  # both replicas conclusive
            assert pool.canary_tick() == 2  # and again, against the golden
            assert pool.sdc_checks_total >= 4 and pool.sdc_mismatches_total == 0
            assert [r.integrity for r in pool.replicas] == ["ok", "ok"]
            status, body = get_json(url, "/readyz")
            assert status == 200
            for rep in body["replicas"]:
                assert rep["integrity"] == "ok"
                assert isinstance(rep["last_canary_age_s"], float) and rep["last_canary_age_s"] >= 0.0
        finally:
            server.shutdown()
            state.close()

    def test_corruption_detected_victim_fails_over_restart_verified(self, files):
        """Weight corruption lands on replica 0 while two victims stream from
        it: the canary detects it within the threshold's ticks and walks the
        replica suspect -> dead as corrupt; no victim completes with wrong
        content (mid-stream victims end ``replica_corrupt``, none replays);
        the survivor serves clean traffic; the rebuild passes the checksum
        and the canary re-certifies it against the same golden."""
        clean = make_replica_state(files, parallel=3)
        url, server = serve_state(clean)
        try:
            prompt = long_prompt(url)
            _, b224 = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 224})
            baseline = b224["choices"][0]["message"]["content"]
            _, b8 = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 8})
            baseline8 = b8["choices"][0]["message"]["content"]
        finally:
            server.shutdown()
            clean.close()

        faults.install(faults.parse(SLOW.replace("delay_ms=25", "delay_ms=80")))
        state = make_replica_state(files, parallel=3, sdc_canary_tokens=4)
        url, server = serve_state(state)
        try:
            pool = state.pool
            reference = pool.weights_reference[pool.weights_version]
            assert pool.canary_tick() == 2  # golden recorded, both ok
            for s in pool.replicas[1].slots:  # this phase's traffic lands on replica 0
                s.busy = True
            body = {"messages": [{"role": "user", "content": prompt}], "max_tokens": 224}
            streams = [Sse(url, dict(body)) for _ in range(2)]
            firsts = [s.read_first_delta() for s in streams]
            assert all(firsts)  # both victims are mid-stream
            for s in pool.replicas[1].slots:
                s.busy = False
            rep0 = pool.replicas[0]
            rep0.engine.params, desc = integrity.corrupt_params(rep0.engine.params, seed=1)
            # the failover ledger is the latch (a fast rebuild can make the
            # dead state transient)
            ticks = tick_until(pool, lambda: pool.failovers_total >= 1, max_ticks=6)
            assert ticks <= pool.canary_fail_threshold + 1, (ticks, desc)
            assert pool.sdc_mismatches_total >= pool.canary_fail_threshold and pool.failovers_total == 1
            texts = [f + s.read_rest() for f, s in zip(firsts, streams)]
            for s, text in zip(streams, texts):
                if s.error_type is None:
                    assert text == baseline  # every delta was sent before the corruption
                else:
                    assert s.error_type == "replica_corrupt"
            assert any(s.error_type == "replica_corrupt" for s in streams)
            assert pool.replayed_total == 0  # no sent-delta victim replayed
            status, after = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 8})
            assert status == 200 and after["choices"][0]["message"]["content"] == baseline8
            assert pool.wait_state(0, HEALTHY, timeout_s=60)
            assert pool.restarts_total == 1
            assert pool.weights_reference[pool.weights_version] == reference
            assert integrity.params_checksum(pool.replicas[0].engine.params) == reference
            assert pool.replicas[0].integrity == "unverified"
            tick_until(pool, lambda: pool.replicas[0].integrity == "ok", max_ticks=4)
            assert pool.replicas[0].state == HEALTHY
        finally:
            server.shutdown()
            state.close()

    def test_corrupt_rebuild_is_rejected_then_clean_rebuild_enters(self, files):
        """A rebuild whose weights were corrupted is refused (one
        ``check=checksum`` mismatch); the loop retries until a clean build
        matches the reference."""
        state = make_replica_state(files)
        pool = state.pool
        orig_build = pool.build_replica
        corrupted_once = []

        def sabotaging_build(idx):
            engine, sched, slots = orig_build(idx)
            if not corrupted_once:
                corrupted_once.append(1)
                engine.params, _ = integrity.corrupt_params(engine.params)
            return engine, sched, slots

        pool.build_replica = sabotaging_build
        before = pool.sdc_mismatches_total
        pool.mark_dead(0, "test")
        try:
            assert pool.wait_state(0, HEALTHY, timeout_s=60)
            assert corrupted_once and pool.sdc_mismatches_total == before + 1 and pool.restarts_total == 1
            assert integrity.params_checksum(pool.replicas[0].engine.params) == pool.weights_reference[
                pool.weights_version]
        finally:
            state.close()

    def test_shadow_vote_divergence_suspects_both_canary_resolves(self, files):
        state = make_replica_state(files)
        pool = state.pool
        msgs = [{"role": "user", "content": "hello shadow"}]
        try:
            assert pool.shadow_vote(state._canary_probe, msgs) is True
            assert pool.sdc_mismatches_total == 0
            pool.replicas[1].engine.params, _ = integrity.corrupt_params(pool.replicas[1].engine.params, seed=2)
            assert pool.shadow_vote(state._canary_probe, msgs) is False
            assert pool.sdc_mismatches_total == 1
            assert {r.state for r in pool.replicas} == {SUSPECT}
            tick_until(pool, lambda: pool.failovers_total >= 1, max_ticks=6)
            assert pool.replicas[0].state == HEALTHY and pool.replicas[0].integrity == "ok"
            assert pool.wait_state(1, HEALTHY, timeout_s=60)
            assert pool.replicas[1].restarts == 1
        finally:
            state.close()

    def test_mid_stream_corrupt_loss_is_typed_not_spliced(self, files):
        """A corrupt loss mid-stream is not replayed (a plain ReplicaLost
        would be): the stream ends ``replica_corrupt`` and the replay count
        stays still though a healthy replica was free."""
        faults.install(faults.parse(SLOW))
        state = make_replica_state(files)
        url, server = serve_state(state)
        try:
            stream = Sse(url, {"messages": [{"role": "user", "content": "tell me a story"}], "max_tokens": 64})
            assert stream.read_first_delta()
            victim = next(r for r in state.pool.replicas if r.active() > 0)
            victim.scheduler.mark_lost("sdc canary mismatch (test)", corrupt=True)
            stream.read_rest()
            assert stream.error_type == "replica_corrupt"
            assert state.pool.replayed_total == 0
        finally:
            server.shutdown()
            state.close()

    def test_corrupt_loss_before_any_delta_replays_cleanly(self, files):
        """A ReplicaCorrupt victim that streamed nothing replays like any
        replica loss, and the replay is counted."""
        state = make_replica_state(files, replicas=1)
        orig_place = state.pool.place
        bounced = []

        def place_corrupt_once(messages, deadline=None, route_tokens=None):
            if not bounced:
                bounced.append(1)
                raise faults.ReplicaCorrupt("replica 0 lost: sdc (test)")
            return orig_place(messages, deadline, route_tokens=route_tokens)

        state.pool.place = place_corrupt_once
        try:
            out = state.complete({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}, lambda s: None)
            assert out["choices"][0]["message"]["content"] is not None
            assert bounced and state.pool.replayed_total == 1
        finally:
            state.close()

    def test_canary_does_not_block_drain(self, files):
        """A probe holds no admission permit: a drain completes while a
        canary is mid-probe, and the probe unwinds cleanly after."""
        faults.install(faults.parse("batch.fetch:kind=delay,delay_ms=150,count=-1"))
        state = make_replica_state(files, replicas=1)
        pool = state.pool
        done: list[int] = []
        t = threading.Thread(target=lambda: done.append(pool.canary_tick()), daemon=True)
        t.start()
        time.sleep(0.1)
        state.begin_drain()
        sw = time.monotonic()
        assert state.admission.drain_wait(5.0) is True
        assert time.monotonic() - sw < 2.0  # did not wait out the canary
        t.join(timeout=60)
        assert not t.is_alive() and done
        assert all(not s.busy for s in pool.all_slots())
        assert state.admission.free_slots() == state.admission.n_slots
        state.close()

    def test_client_cannot_use_reserved_tenant(self, files):
        state = make_replica_state(files, replicas=1)
        try:
            for reserved in integrity.RESERVED_TENANTS:
                with pytest.raises(tapi.BadRequest, match="reserved"):
                    state._parse({"messages": [{"role": "user", "content": "x"}], "tenant": reserved})
        finally:
            state.close()


# ----------------------------------------------------------------------
# The probe's fingerprint, under traffic
# ----------------------------------------------------------------------


def test_probe_fingerprint_folds_the_decoded_tokens_chunks(files):
    """The probe folds exactly ceil((n - 1) / chunk) chunk fingerprints (the
    fused first token has none), so the result does not depend on chunks
    the pipeline ran ahead; and a probe sharing every batched step with a
    long decoding row on the other lane equals the idle probe bit for bit."""
    for n in (1, 4, 5, 9, 12):
        state = make_replica_state(files, replicas=1, sdc_canary_tokens=n)
        try:
            rep = state.pool.replicas[0]
            seen = []
            orig = type(rep.slots[0].stream).run_fingerprint

            def spy(stream, n_tokens=None, orig=orig):
                seen.append((n_tokens, list(stream._chunk_fps)))
                return orig(stream, n_tokens)

            type(rep.slots[0].stream).run_fingerprint = spy
            try:
                toks, fp = state._canary_probe(rep)
            finally:
                type(rep.slots[0].stream).run_fingerprint = orig
            (n_tokens, fps), = seen
            assert len(toks) == n and n_tokens == n - 1
            chunk = rep.scheduler.chunk
            want = integrity.FP_BASIS
            for c in fps[: -(-(n - 1) // chunk)]:
                want = integrity.fold_run_fingerprint(want, c)
            assert fp == want
        finally:
            state.close()

    faults.install(faults.parse(SLOW))
    state = make_replica_state(files, replicas=1, sdc_canary_tokens=12)
    url, server = serve_state(state)
    try:
        rep = state.pool.replicas[0]
        idle = state._canary_probe(rep)
        stream = Sse(url, {"messages": [{"role": "user", "content": "tell me a very long story"}],
                           "max_tokens": 200})
        assert stream.read_first_delta() is not None
        busy = state._canary_probe(rep)  # every step shared with the long row
        stream.read_rest()
        assert stream.error_type is None
        assert busy == idle
    finally:
        server.shutdown()
        state.close()


def test_canary_tokens_equal_the_jax_probe(files, tmp_path):
    """The pinned canary prompt on the same f32 model, one replica each:
    the JAX probe's tokens and the port's are equal (tolerance: none; the
    fingerprints are each package's own and are not compared)."""
    import types

    from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
    from distributed_llama_tpu.server.api import ApiState as JaxApiState
    from distributed_llama_tpu.tokenizer import Sampler as JaxSampler
    from distributed_llama_tpu.tokenizer import Tokenizer as JaxTokenizer

    model, tok = files
    got = []
    for msgs in (None, [{"role": "user", "content": "hello shadow"}]):
        args = types.SimpleNamespace(temperature=0.0, topp=0.9, topk=0, seed=1, chat_template=None, parallel=2,
                                     replicas=1, batch_decode=True, decode="device", decode_chunk=4,
                                     sdc_canary_tokens=12)
        jstate = JaxApiState(JaxEngine(model, dtype=jnp.float32), JaxTokenizer.from_file(tok),
                             JaxSampler(vocab_size=SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1), args)
        tstate = make_replica_state(files, replicas=1, sdc_canary_tokens=12)
        try:
            want = jstate._canary_probe(jstate.pool.replicas[0], msgs)
            mine = tstate._canary_probe(tstate.pool.replicas[0], msgs)
        finally:
            jstate.pool.close()
            tstate.close()
        assert want is not None and mine is not None
        assert len(mine[0]) == 12 and mine[0] == want[0]
        got.append(mine)
    assert got[0] != got[1]  # the shadow path's messages replace the pinned prompt
