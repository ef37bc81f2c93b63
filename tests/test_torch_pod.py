"""The port's one-process pod (``parallel/pod.py``): each case of the JAX
package's ``tests/test_pod.py`` on the port, and the two packages' pods
computing from the same bytes.

* Mechanics: ``parse_pod``; a pod over several cards raises
  NotImplementedError (the JAX pod's "needs enough devices" check: the
  port places every rank of every slice on one card); ``--pod`` does not
  compose with ``--tp``.
* The shared substrate: every slice engine reads the SAME params object
  and backend (one weight tree for N replicas), the rebuild checksum holds,
  the resident-bytes accounting divides the tree by the data extent, slices
  share the backend's dispatch lock, and the mesh gauges carry the JAX
  names.
* Parity: a 2x2 pod's greedy stream equals two independent 1x2 groups'
  (each with its own params), its chunked decode equals its one-dispatch
  loop, and it equals a ``--tp 2`` engine's; a JAX ``PodGroup``'s placed
  params, carried across rank by rank, are the port's pod params byte for
  byte, and both pods decode the same greedy stream.
* Serving: a ``replica.crash`` on slice 0 mid-decode over HTTP, the
  victims replayed byte-identically on slice 1, the slice rebuilt over
  the same params object, and serving again.

Models: f32 synthetic files (the tiny spec at seq_len 96 for the engine
cases, ``tests/test_torch_replicas.py``'s dim-64 file for the server).
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops.q40 import QuantizedMatrix as JaxQM
from distributed_llama_tpu.parallel.pod import PodGroup as JaxPodGroup

from distributed_llama_tpu_torch import retry, telemetry
from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import InferenceEngine, faults
from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.parallel import pod as pod_lib
from distributed_llama_tpu_torch.parallel.pod import PodForward, PodGroup, parse_pod, tree_weight_bytes
from distributed_llama_tpu_torch.server import api as tapi
from distributed_llama_tpu_torch.server.replicas import HEALTHY
from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer

from tests.test_torch_replicas import SLOW, SPEC as SERVER_SPEC, SseStream, files, one_long_prompt, post_raw, \
    serve_state  # noqa: F401  (files: the server's model fixture)
from tests.test_torch_tensor_parallel import _leaves

PROMPT = [1, 2, 3, 4, 5]


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_pod") / "m.m")
    tsyn.write_synthetic_model(path, tsyn.tiny_spec(seq_len=96), seed=7)
    return path


def build(path, data=2, model=2):
    return PodGroup.build(path, data, model, dtype=torch.float32, device="cpu")


class TestPodMechanics:
    def test_parse_pod(self):
        assert parse_pod("2x2") == (2, 2)
        assert parse_pod("4X1") == (4, 1)
        assert parse_pod("1*8") == (1, 8)
        for bad in ("2x", "0x2"):
            with pytest.raises(ValueError):
                parse_pod(bad)

    def test_pod_over_several_cards_raises(self, model_path):
        with pytest.raises(NotImplementedError, match="several cards"):
            PodGroup.build(model_path, 2, 2, dtype=torch.float32, devices=["cpu", "cuda:1"])
        one = PodForward(build(model_path).cfg, 2, 2, devices=["cpu", "cpu"])
        assert one.devices == [torch.device("cpu")] * 2

    def test_pod_rejects_composition_with_tp(self, model_path):
        args = tcli.build_parser().parse_args(["generate", "--model", model_path, "--tokenizer", "x", "--pod",
                                               "2x2", "--tp", "2", "--device", "cpu", "--dtype", "f32"])
        with pytest.raises(SystemExit):
            tcli.make_pod_group(args)


class TestPodSharedSubstrate:
    def test_one_params_tree_across_slices_and_rebuilds(self, model_path):
        group = build(model_path)
        e1, e2 = group.slice_engine(), group()
        assert e1.params is group.params and e2.params is group.params  # the SAME tensors, not N copies
        assert e1.tp_backend is e2.tp_backend is group.backend
        assert e1.weights_checksum() == e2.weights_checksum()  # the rebuild gate holds trivially
        assert group.weight_bytes == tree_weight_bytes(group.params) > 0
        assert group.resident_weight_bytes_per_replica() == group.weight_bytes // 2
        # the replicated leaves are one tensor that both ranks read
        assert group.params[0]["embedding"] is group.params[1]["embedding"]
        assert pod_lib.max_device_weight_bytes([group.params, group.params]) == group.weight_bytes

    def test_slices_share_the_backend(self, model_path):
        """The port's form of "slices share compiled programs": both slices
        issue through the one backend (and its dispatch lock) and decode
        the same tokens from the same prompt."""
        group = build(model_path)
        e1, e2 = group.slice_engine(), group.slice_engine()
        lock = group.backend._dispatch_lock
        s1, s2 = e1.default_stream, e2.new_stream()
        s1.prefill([1, 2, 3])
        t1 = s1.generate_on_device(4, 6, temperature=0.0)
        s2.prefill([1, 2, 3])
        t2 = s2.generate_on_device(4, 6, temperature=0.0)
        assert e2.tp_backend._dispatch_lock is lock
        np.testing.assert_array_equal(t1, t2)

    def test_mesh_telemetry_gauges(self, model_path):
        telemetry.reset()
        telemetry.enable()
        try:
            group = build(model_path)
            group.slice_engine()
            text = telemetry.prometheus_text()
            assert 'dllama_mesh_devices{axis="data"} 2' in text
            assert 'dllama_mesh_devices{axis="model"} 2' in text
            assert 'dllama_resident_weight_bytes{group="pod"}' in text
            assert (f'dllama_resident_weight_bytes{{group="per_replica"}} '
                    f"{group.resident_weight_bytes_per_replica()}" in text)
        finally:
            telemetry.disable()
            telemetry.reset()


def _greedy(engine, steps=16):
    s = engine.default_stream
    s.reset()
    s.prefill(PROMPT)
    return np.asarray(s.engine.generate_on_device(6, steps, temperature=0.0))


class TestPodParity:
    def test_pod_matches_n_independent_engines(self, model_path):
        """A 2x2 pod against two 1x2 groups each holding its own tree."""
        want = _greedy(build(model_path).slice_engine())
        lone = [build(model_path, 1, 2) for _ in range(2)]
        assert lone[0].params is not lone[1].params
        for g in lone:
            np.testing.assert_array_equal(_greedy(g.slice_engine()), want)

    def test_pod_chunked_decode_matches_loop(self, model_path):
        group = build(model_path)
        want = _greedy(group.slice_engine())
        s = group.slice_engine().default_stream
        s.prefill(PROMPT)
        got = list(s.generate_chunks(6, temperature=0.0, chunk=5, limit=s.pos + 16))
        np.testing.assert_array_equal(np.asarray(got[:16]), want)

    def test_pod_matches_tp_replica_pool_backend(self, model_path):
        """Pod slices against the ``--tp 2`` engine a replica pool runs."""
        want = _greedy(InferenceEngine(model_path, dtype=torch.float32, device="cpu", tp=2))
        np.testing.assert_array_equal(_greedy(build(model_path).slice_engine()), want)

    def test_jax_pod_params_carried_equal_and_decode_alike(self, model_path):
        """A JAX ``PodGroup``'s placed params, cut rank by rank from data
        slice 0 of its mesh, are the port's pod params byte for byte; a port
        pod over the carried tree decodes the JAX pod's greedy stream."""
        jgroup = JaxPodGroup.build(model_path, 2, 2, dtype=jnp.float32)
        slice0 = list(jgroup.backend.mesh.devices[0])

        def block(arr, dev):
            return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)

        def cut(v, dev):
            if isinstance(v, JaxQM):
                return {"qs": block(v.qs, dev), "scales": block(v.scales, dev), "n": v.n, "d": v.d}
            if isinstance(v, dict):
                return {k: cut(x, dev) for k, x in v.items()}
            if isinstance(v, list):
                return [cut(x, dev) for x in v]
            return block(v, dev)

        carried = tweights.params_from_jax([cut(jgroup.params, d) for d in slice0], "cpu", tp=2)
        own = build(model_path)
        for c_rank, o_rank in zip(carried, own.params):
            c, o = dict(_leaves(c_rank)), dict(_leaves(o_rank))
            assert list(c) == list(o)
            for name in o:
                assert c[name].dtype == o[name].dtype and torch.equal(c[name], o[name]), name
        port = PodGroup(own.cfg, PodForward(own.cfg, 2, 2, device="cpu"), carried, cache_dtype=torch.float32,
                        dtype=torch.float32)
        js = jgroup.slice_engine().default_stream
        js.prefill(PROMPT)
        want = np.asarray(js.engine.generate_on_device(6, 16, temperature=0.0))
        np.testing.assert_array_equal(_greedy(port.slice_engine()), want)


def make_pod_state(files, data=2, model=2, parallel=2):
    """A pod-backed ApiState: the replicas are the slices of ONE group (the
    engine factory), so a rebuild hands out a fresh slice over the same
    params."""
    path, tok = files
    group = PodGroup.build(path, data, model, dtype=torch.float32, device="cpu")
    args = types.SimpleNamespace(temperature=0.0, topp=0.9, topk=0, seed=1, chat_template=None, parallel=parallel,
                                 replicas=data, batch_decode=True, decode="device", decode_chunk=4,
                                 replica_restart_backoff_s=0.05)
    state = tapi.ApiState(group.slice_engine(), Tokenizer.from_file(tok),
                          Sampler(vocab_size=SERVER_SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1), args,
                          engine_factory=group)
    state.pool.restart_policy = retry.BackoffPolicy(attempts=retry.UNBOUNDED, base_s=0.05)
    return state, group


class TestPodSliceFailover:
    def test_slice_kill_mid_decode_replays_bit_identical_and_rebuilds(self, files):
        """4 streams across 2 slices, slice 0 killed mid-decode: the
        victims replay byte-identically on slice 1, the slice is rebuilt
        from the shared substrate (the same params object) and serves
        again."""
        clean, _ = make_pod_state(files)
        assert len(clean.pool.replicas) == 2
        url, server = serve_state(clean)
        try:
            prompt, baseline = one_long_prompt(url)
            _, b8 = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 8})
            baseline8 = b8["choices"][0]["message"]["content"]
        finally:
            server.shutdown()
            clean.close()

        faults.install(faults.parse(f"replica.crash:kind=raise,row=0,after=16,count=1;{SLOW}"))
        state, group = make_pod_state(files)
        url, server = serve_state(state)
        try:
            streams = [SseStream(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 96})
                       for _ in range(4)]
            texts = [s.read_all() for s in streams]
            assert all(s.error_type is None for s in streams), [s.error_type for s in streams]
            assert texts == [baseline] * 4
            pool = state.pool
            assert pool.failovers_total == 1 and pool.last_failover_victims == 2
            assert pool.replayed_total == pool.last_failover_victims
            assert pool.wait_state(0, HEALTHY, timeout_s=60)
            assert pool.restarts_total == 1
            assert pool.replicas[0].engine.params is group.params  # no weight reload
            for s in pool.replicas[1].slots:
                s.busy = True
            try:
                status, body = post_raw(url, {"messages": [{"role": "user", "content": prompt}], "max_tokens": 8})
                assert status == 200 and body["choices"][0]["message"]["content"] == baseline8
            finally:
                for s in pool.replicas[1].slots:
                    s.busy = False
        finally:
            server.shutdown()
            state.close()


def _argv(files, *extra):
    path, tok = files
    return ["generate", "--model", path, "--tokenizer", tok, "--device", "cpu", "--dtype", "f32", "--temperature",
            "0", "--seed", "3", *extra]


def test_cli_pod_slice_prints_what_tp_prints(files, capsys):
    """``--pod 2x2`` in the CLI runs one slice of a fresh group: the same
    text and tokens as ``--tp 2``."""
    runs, texts = [], []
    for extra in (["--tp", "2"], ["--pod", "2x2"]):
        runs.append(tcli.main(_argv(files, "--prompt", "hello world hello", "--steps", "20", "--decode-chunk", "4",
                                    *extra)))
        texts.append(capsys.readouterr().out.split("Generated tokens:")[0])
    assert runs[0]["tokens"] == runs[1]["tokens"] and texts[0] == texts[1]


def test_server_pod_replicas_and_rollout_frees_the_old_tree(files, tmp_path):
    """The server's ``--pod``: one replica per data slice (another
    ``--replicas`` count is ignored with a warning; an explicit 1 serves
    the consolidated pod), and a rollout to a weight file places a second
    tree over the same backend; at its end the old version's group, and
    with it the old tree, is gone."""
    import gc
    import shutil
    import weakref

    base = _argv(files, "--pod", "2x2", "--parallel", "2", "--port", "0", "--host", "127.0.0.1",
                 "--replica-restart-backoff-s", "0.05")
    for extra, n in ((["--replicas", "3"], 2), (["--replicas", "1"], 1)):
        server, state = tapi.make_server(tapi.build_parser().parse_args(base + extra))
        try:
            assert len(state.pool.replicas) == n
            backend = state.engine.tp_backend
            assert all(r.engine.params is state.engine.params for r in state.pool.replicas)
            if n != 2:
                continue
            old_leaf = weakref.ref(state.engine.params[0]["layers"][0]["rms_att"])
            path2 = str(tmp_path / "m2.m")
            shutil.copy(files[0], path2)
            state.register_weights_path("v1", path2)
            assert state.rollout.run("v1")["status"] == "complete"
            new = state.pool.replicas[0].engine
            assert new.tp_backend is backend and all(r.engine.params is new.params for r in state.pool.replicas)
            gc.collect()
            assert old_leaf() is None  # the old tree went with the old group
        finally:
            server.server_close()
            state.close()


def test_fleet_grows_and_retires_pod_slices(files):
    """The fleet's grow builds a third slice over the pod's one tree (the
    factory is the group), its checksum gate passes on the same bytes, and
    retire drops it again; the pod's tree stays."""
    state, group = make_pod_state(files)
    try:
        pool = state.pool
        assert pool.grow_replica() == 2
        assert pool.replicas[2].engine.params is group.params and state.admission.n_slots == 6
        assert pool.sdc_mismatches_total == 0
        assert pool.retire_replica(drain_timeout_s=5.0)
        assert len(pool.replicas) == 2 and state.admission.n_slots == 4
        assert all(r.engine.params is group.params for r in pool.replicas)
    finally:
        state.close()
