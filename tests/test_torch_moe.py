"""The port's mixture-of-experts slice (Mixtral, Grok-1) held against the
JAX package on the same numpy-seeded inputs.

* The router, the bucket algebra and the three expert paths (top-k, serial
  all-experts, capacity-bucketed) function by function: f32 weights at
  1e-5 relative; Q40 experts (widths past the kernel eligibility rule)
  through K1's plain version against the JAX package's interpret-mode
  Pallas kernel.
* Whole models on the synthetic files that ``tests/test_moe.py``'s
  ``mixtral_spec``/``grok_spec`` describe: prefill logits, greedy streams,
  the batch scheduler, the CLI and the `.m` readers.

Routing flips. The expert choice depends on the router's f32 logits, so
an ulp apart between the packages swaps two experts wherever their
probabilities nearly tie, and that moves the output far past any
tolerance. The whole-model checks therefore compare the chosen expert ids
first, report the smallest gap between the k-th and (k+1)-th probability
over every routed row and layer, and hold logits to their tolerance only
with that gap above ROUTE_MARGIN (the seeds below are ones where it is).
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.engine import weights as jweights
from distributed_llama_tpu.engine.batch import BatchScheduler as JaxScheduler
from distributed_llama_tpu.formats import synthetic as jsyn
from distributed_llama_tpu.formats.model_file import ModelFileReader as JaxReader
from distributed_llama_tpu.models import config as jconfig
from distributed_llama_tpu.models import llama as jllama
from distributed_llama_tpu.models import moe as jmoe
from distributed_llama_tpu.ops import q40 as jq
from distributed_llama_tpu.quants import FloatType as JaxFloatType

from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.model_file import ArchType, HiddenAct
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader as TorchReader
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import llama as tllama
from distributed_llama_tpu_torch.models import moe as tmoe
from distributed_llama_tpu_torch.ops import q40 as tq
from distributed_llama_tpu_torch.quants import FloatType

from tests.reference_impl import NumpyLlama
from tests.test_moe import grok_spec, mixtral_spec
from tests.test_torch_model import _flatten_jax, _leaves

ARCHS = {"mixtral": mixtral_spec, "grok": grok_spec}
ROUTE_MARGIN = 1e-5  # the smallest k-th vs (k+1)-th probability gap the logit checks accept
# Q40 logits, of max |logit|: the repo's cross-package q40 tolerance
# (tests/test_torch_model.py reads up to 2.5e-2 on a dense model)
Q40_LOGIT_TOL = 2.5e-2
PROMPT = [1, 5, 9, 13, 2, 7, 30]


def _jax_spec(arch, **over):
    return ARCHS[arch](**over)


def _write(tmp_path_factory, name, spec, seed):
    path = tmp_path_factory.mktemp("torch_moe") / f"{name}.m"
    jsyn.write_synthetic_model(str(path), spec, seed=seed)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """arch -> {"f32": path, "q40": path}: the tiny Mixtral and Grok-1
    models of tests/test_moe.py (dim 32, hidden 64, 4 experts, 2 active),
    seq_len 64, with f32 and with Q40 weights."""
    out = {}
    for arch, seed in (("mixtral", 0), ("grok", 6)):
        out[arch] = {wt: _write(tmp_path_factory, f"{arch}_{wt}", _jax_spec(
            arch, seq_len=64, weights_float_type=JaxFloatType.Q40 if wt == "q40" else JaxFloatType.F32), seed)
            for wt in ("f32", "q40")}
    return out


# ---------------------------------------------------------------------------
# routing records
# ---------------------------------------------------------------------------


class Routes:
    """Expert ids and top-k margins of every router call, in call order."""

    def __init__(self):
        self.ids: list[np.ndarray] = []
        self.margins: list[np.ndarray] = []

    def min_margin(self) -> float:
        return float(min(m.min() for m in self.margins))


@contextlib.contextmanager
def recording(monkeypatch, module, to_np):
    """Record ``module.router_topk``'s ids and each row's margin (k-th
    minus (k+1)-th probability) while the block runs."""
    routes, orig = Routes(), module.router_topk

    def spy(cfg, xn, router):
        vals, idx = orig(cfg, xn, router)
        probs = -np.sort(-to_np(module.router_probs(cfg, xn, router)), axis=-1)
        k = cfg.n_active_experts
        routes.ids.append(to_np(idx))
        routes.margins.append(probs[:, k - 1] - probs[:, k])
        return vals, idx

    monkeypatch.setattr(module, "router_topk", spy)
    try:
        yield routes
    finally:
        monkeypatch.setattr(module, "router_topk", orig)


def _torch_np(t):
    return t.detach().cpu().numpy()


def assert_same_routes(got: Routes, want: Routes, rows: int):
    """The same expert ids (the first ``rows`` rows of each call), with
    every margin above ROUTE_MARGIN: the precondition of a logit check."""
    assert len(got.ids) == len(want.ids)
    for g, w in zip(got.ids, want.ids):
        np.testing.assert_array_equal(g[:rows], w[:rows])
    margin = min(float(m[:rows].min()) for m in got.margins)
    print(f"smallest top-k routing margin: {margin:.3e}")
    assert margin > ROUTE_MARGIN, f"routing margin {margin:.3e}: pick another seed"


# ---------------------------------------------------------------------------
# activation and router
# ---------------------------------------------------------------------------


def test_gelu_matches_jax():
    x = (np.random.RandomState(0).randn(4096) * 4).astype(np.float32)
    want = np.asarray(jllama._activation(jnp.asarray(x), jllama.HiddenAct.GELU))
    got = tllama._activation(torch.from_numpy(x), HiddenAct.GELU).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    silu = np.asarray(jllama._activation(jnp.asarray(x), jllama.HiddenAct.SILU))
    np.testing.assert_allclose(tllama._activation(torch.from_numpy(x), HiddenAct.SILU).numpy(), silu,
                               rtol=2e-6, atol=2e-6)


def _cfgs(arch="mixtral", **over):
    spec = _jax_spec(arch, **over)
    jcfg = jconfig.config_from_spec(spec)
    tspec = tsyn.tiny_spec(**{f: getattr(spec, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "n_experts",
        "n_active_experts", "rope_theta")}, arch_type=ArchType(int(spec.arch_type)),
        hidden_act=HiddenAct(int(spec.hidden_act)))
    return jcfg, tconfig.config_from_spec(tspec)


@pytest.mark.parametrize("T,k", [(1, 2), (9, 2), (9, 1), (40, 3)])
def test_router_matches_jax(T, k):
    jcfg, tcfg = _cfgs(n_experts=8, n_active_experts=k, dim=64)
    rng = np.random.RandomState(T + k)
    xn = rng.randn(T, 64).astype(np.float32)
    router = (rng.randn(64, 8) / 8).astype(np.float32)
    jx, jr, tx, tr = jnp.asarray(xn), jnp.asarray(router), torch.from_numpy(xn), torch.from_numpy(router)
    np.testing.assert_allclose(tmoe.router_probs(tcfg, tx, tr).numpy(), np.asarray(jmoe.router_probs(jcfg, jx, jr)),
                               rtol=0, atol=1e-6)
    jv, ji = jmoe.router_topk(jcfg, jx, jr)
    tv, ti = tmoe.router_topk(tcfg, tx, tr)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmoe.router_weights(tcfg, tx, tr).numpy(), np.asarray(jmoe.router_weights(jcfg, jx, jr)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("tied", ["pair", "all"])
def test_router_ties_take_the_lower_id_first(tied):
    """Equal probabilities: the ids are jax.lax.top_k's (lower id first)."""
    jcfg, tcfg = _cfgs(n_experts=6, n_active_experts=3, dim=16)
    rng = np.random.RandomState(3)
    xn = rng.randn(5, 16).astype(np.float32)
    router = rng.randn(16, 6).astype(np.float32)
    if tied == "pair":  # experts 4 and 1 identical, both well above the rest
        router[:, 1] = router[:, 4] = 0.0
        router[:, [0, 2, 3, 5]] -= 5 * np.abs(xn).max()
        xn = np.abs(xn)
    else:
        router[:] = 0.0
    jv, ji = jmoe.router_topk(jcfg, jnp.asarray(xn), jnp.asarray(router))
    tv, ti = tmoe.router_topk(tcfg, torch.from_numpy(xn), torch.from_numpy(router))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[:, :2].tolist() == [[1, 4]] * 5 if tied == "pair" else ti.tolist() == [[0, 1, 2]] * 5
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# bucket algebra: exact
# ---------------------------------------------------------------------------


def test_bucket_capacity_matches_jax():
    for factor in (0.0, -1.0, 0.5, 1.0, 1.25, 2.0, 3.0, 1e9):
        for T in (1, 7, 32, 33, 64, 100, 512):
            for k, E in ((1, 4), (2, 8), (2, 4), (3, 16)):
                assert tmoe.bucket_capacity(factor, T, k, E) == jmoe.bucket_capacity(factor, T, k, E)


@pytest.mark.parametrize("T,k,E,factor,n_real", [
    (8, 2, 4, 0.0, None),  # exact buckets
    (8, 2, 4, 0.0, 5),  # pad rows to the sink
    (40, 2, 8, 1.0, None),  # capacity drops
    (64, 2, 4, 1.0, 33),  # drops and sinks
    (48, 3, 6, 2.0, 48),
])
def test_bucket_algebra_matches_jax_exactly(T, k, E, factor, n_real):
    rng = np.random.RandomState(T * 7 + E)
    skew = rng.dirichlet(np.ones(E) * 0.5)  # uneven routing, so buckets overflow
    top_idx = np.stack([rng.choice(E, size=k, replace=False, p=skew) for _ in range(T)]).astype(np.int32)
    if n_real is not None:
        top_idx[n_real:] = E
    D = 6
    x = rng.randn(T, D).astype(np.float32)
    vals = rng.rand(T, k).astype(np.float32)
    C = jmoe.bucket_capacity(factor, T, k, E)
    jf, jrank, jt = jmoe.bucket_rank(jnp.asarray(top_idx), E)
    tf, trank, tt = tmoe.bucket_rank(torch.from_numpy(top_idx).long(), E)
    for a, b in ((tf, jf), (trank, jrank), (tt, jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool((trank >= C).any()) == (factor == 1.0)  # factor 1.0 drops rows here, the others none
    jb = np.asarray(jmoe.bucket_scatter(jnp.asarray(x), jf, jrank, jt, E, C))
    tb = tmoe.bucket_scatter(torch.from_numpy(x), tf, trank, tt, E, C).numpy()
    np.testing.assert_array_equal(tb, jb)
    outs = rng.randn(E, C, D).astype(np.float32)

    def combine(v):
        jo = np.asarray(jmoe.bucket_combine(jnp.asarray(outs), jnp.asarray(top_idx), jrank, jnp.asarray(v), C))
        to = tmoe.bucket_combine(torch.from_numpy(outs), torch.from_numpy(top_idx).long(), trank,
                                 torch.from_numpy(v), C).numpy()
        return to, jo

    # the combine gathers the same rows with the same weights; its sum of k
    # weighted rows is rounded in the order XLA picks (it fuses multiply-
    # adds), so random weights agree to an ulp, and power-of-two weights,
    # whose products are exact, bit for bit
    to, jo = combine(vals)
    np.testing.assert_allclose(to, jo, rtol=0, atol=2e-7 * np.abs(jo).max())
    to, jo = combine((2.0 ** -rng.randint(0, 4, (T, k))).astype(np.float32))
    np.testing.assert_array_equal(to, jo)


# ---------------------------------------------------------------------------
# the three expert paths, function by function
# ---------------------------------------------------------------------------


def _layer(kind, dim, hidden, E, seed):
    """One MoE layer's params in both packages: ``kind`` "f32" (stacked
    banks) or "q40" (per-expert fused gate|up + down Q40 leaves)."""
    rng = np.random.RandomState(seed)
    router = (rng.randn(dim, E) / np.sqrt(dim)).astype(np.float32)
    gate, up = (rng.randn(E, dim, hidden) / np.sqrt(dim)).astype(np.float32), (
        rng.randn(E, dim, hidden) / np.sqrt(dim)).astype(np.float32)
    down = (rng.randn(E, hidden, dim) / np.sqrt(hidden)).astype(np.float32)
    jlp = {"router": jnp.asarray(router)}
    tlp = {"router": torch.from_numpy(router)}
    if kind == "f32":
        for name, w in (("moe_gate", gate), ("moe_up", up), ("moe_down", down)):
            jlp[name], tlp[name] = jnp.asarray(w), torch.from_numpy(w)
        return jlp, tlp
    jlp["experts"], tlp["experts"] = [], []
    for e in range(E):
        gu = np.concatenate([gate[e], up[e]], axis=1)
        jlp["experts"].append({"gate_up": jq.quantize_q40_tpu(gu), "down": jq.quantize_q40_tpu(down[e])})
        tlp["experts"].append({"gate_up": tq.quantize_q40_tpu(gu), "down": tq.quantize_q40_tpu(down[e])})
    return jlp, tlp


PATHS = {
    "topk": (lambda m, cfg, xn, lp: m._moe_topk(cfg, xn, lp)),
    "dense": (lambda m, cfg, xn, lp: m._moe_dense(cfg, xn, lp)),
    "bucketed": (lambda m, cfg, xn, lp: m._moe_dense_bucketed(cfg, xn, lp, n_real=37)),
}


@pytest.mark.parametrize("kind", ["f32", "q40"])
@pytest.mark.parametrize("path", list(PATHS))
def test_expert_paths_match_jax(kind, path):
    """f32 banks, and Q40 experts (dim 512, hidden 512: every expert
    matmul kernel-eligible, so the port runs K1's plain version and the JAX
    package its Pallas kernel in interpret mode), at 1e-5 of max |out|.
    The JAX side runs eagerly: its jitted Q80 quantize of bf16 activations
    rounds some blocks one step away from its eager one (and the port's),
    which moves a Q40 expert chain by ~5e-3 of max |out|. The bucketed path
    runs 48 rows, 11 of them padding, at capacity factor 1.0, so some rows
    drop."""
    dim, hidden, E = (64, 96, 4) if kind == "f32" else (512, 512, 4)
    T = 1 if path == "topk" else 48
    over = dict(dim=dim, hidden_dim=hidden, n_experts=E, n_active_experts=2, n_heads=4, n_kv_heads=4)
    jcfg, tcfg = _cfgs("grok" if path == "dense" else "mixtral", **over)
    if path == "bucketed":  # elsewhere 0: the dense path over Q40 experts is the serial one
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=1.0)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=1.0)
    jlp, tlp = _layer(kind, dim, hidden, E, seed=len(path) + dim)
    xn = np.random.RandomState(T).randn(T, dim).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(PATHS[path](jmoe, jcfg, jnp.asarray(xn), jlp))
    got = PATHS[path](tmoe, tcfg, torch.from_numpy(xn), tlp).numpy()
    assert got.shape == want.shape == (T, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_moe_ffn_dispatches_on_rows(monkeypatch):
    """One row takes the top-k path (one host read of its expert ids),
    more rows the all-experts path, as in the JAX package."""
    _, tcfg = _cfgs(dim=64, hidden_dim=96)
    _, tlp = _layer("f32", 64, 96, 4, seed=1)
    seen = []
    monkeypatch.setattr(tmoe, "_moe_dense", lambda *a, **kw: seen.append("dense") or torch.zeros(3, 64))
    tmoe.reset_host_reads()
    tmoe.moe_ffn(tcfg, torch.randn(1, 64), tlp)
    assert tmoe.host_reads["expert_ids"] == 1 and not seen
    tmoe.moe_ffn(tcfg, torch.randn(3, 64), tlp)
    assert seen == ["dense"] and tmoe.host_reads["expert_ids"] == 1


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _engines(files, arch, wt, **kw):
    path = files[arch][wt]
    jdt, tdt = ("q40", "q40") if wt == "q40" else (jnp.float32, torch.float32)
    return JaxEngine(path, dtype=jdt, **kw), TorchEngine(path, dtype=tdt, device="cpu", **kw)


@pytest.mark.parametrize("wt", ["f32", "q40"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_logits_and_routes_match_jax(monkeypatch, files, arch, wt):
    je, te = _engines(files, arch, wt)
    with recording(monkeypatch, jmoe, np.asarray) as jroutes, jax.disable_jit():
        want = je.forward(PROMPT)
    with recording(monkeypatch, tmoe, _torch_np) as troutes:
        got = te.forward(PROMPT)
    assert_same_routes(troutes, jroutes, rows=len(PROMPT))
    assert got.shape == want.shape == (len(PROMPT), te.cfg.vocab_size)
    tol = 1e-5 if wt == "f32" else Q40_LOGIT_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_numpy_oracle(files, arch):
    """A second reference: the numpy oracle of tests/test_moe.py, token by
    token from position 0 (the top-k path), at that file's tolerances."""
    seed = {"mixtral": 0, "grok": 6}[arch]
    spec = _jax_spec(arch, seq_len=64)
    oracle = NumpyLlama(spec, jsyn.random_tensors(spec, seed=seed))
    te = TorchEngine(files[arch]["f32"], dtype=torch.float32, device="cpu")
    rtol, atol = (3e-4, 3e-4) if arch == "mixtral" else (1e-3, 5e-3)
    for pos, tok in enumerate(PROMPT):
        np.testing.assert_allclose(te.decode_step(tok), oracle.forward(tok, pos), rtol=rtol, atol=atol)


def _stream(engine, prompt, temperature, seed=7, steps=12, chunk=4, spec_draft=0):
    engine.reset()
    out = []
    first = engine.prefill_device(prompt, temperature, 0.9, seed=seed)
    engine.stream_decode(first, lambda p, t: out.append(t) or True, temperature, 0.9, seed=seed, chunk=chunk,
                         limit=len(prompt) + steps, first_prev=prompt[-1], spec_draft=spec_draft,
                         prompt_tokens=prompt)
    return out


@pytest.mark.parametrize("wt", ["f32", "q40"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_streams_match_jax(monkeypatch, files, arch, wt):
    """Greedy streams identical (and on f32 weights a sampled one), each
    decode step's routing margin above ROUTE_MARGIN."""
    je, te = _engines(files, arch, wt)
    want = _stream(je, PROMPT, 0.0)
    with recording(monkeypatch, tmoe, _torch_np) as troutes:
        got = _stream(te, PROMPT, 0.0)
    assert troutes.min_margin() > ROUTE_MARGIN, troutes.min_margin()
    assert len(want) == 13 and got == want
    if wt == "f32":
        assert _stream(te, PROMPT, 0.9, seed=11) == _stream(je, PROMPT, 0.9, seed=11)


def test_expert_host_reads_per_token(files):
    """Each single-row forward reads its expert ids once per MoE layer; a
    prefill reads none."""
    te = TorchEngine(files["mixtral"]["q40"], dtype="q40", device="cpu")
    tmoe.reset_host_reads()
    te.prefill(PROMPT)
    assert tmoe.host_reads["expert_ids"] == 0
    te.decode_step(3)
    assert tmoe.host_reads["expert_ids"] == te.cfg.n_layers


def test_q40_kernel_widths_prefill_matches_jax(monkeypatch, tmp_path):
    """A Mixtral whose every matmul is kernel-eligible (dim 512, hidden
    512): the port through K1's plain version, the JAX package through its
    Pallas kernel in interpret mode."""
    spec = mixtral_spec(dim=512, hidden_dim=512, n_heads=8, n_kv_heads=4, vocab_size=512, seq_len=64,
                        weights_float_type=JaxFloatType.Q40)
    path = str(tmp_path / "wide.m")
    jsyn.write_synthetic_model(path, spec, seed=2)
    je, te = JaxEngine(path, dtype="q40"), TorchEngine(path, dtype="q40", device="cpu")
    with recording(monkeypatch, tmoe, _torch_np) as troutes:
        got = te.forward(PROMPT[:5])
    assert troutes.min_margin() > ROUTE_MARGIN
    want = je.forward(PROMPT[:5])
    np.testing.assert_allclose(got, want, rtol=0, atol=Q40_LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("factor", [2.0, 1e9])
def test_bucketed_prefill_matches_jax(files, factor):
    """``--moe-capacity``: a 40-token prompt pads to a 64-row bucket, whose
    24 pad rows route to the sink (n_real threads through the forward), on
    the Q40 experts. 1e9 clamps to drop-free buckets, where the bucketed
    path equals the serial one."""
    je, te = _engines(files, "mixtral", "q40", moe_capacity_factor=factor)
    assert te.cfg.moe_capacity_factor == factor
    prompt = [int(t) for t in np.random.RandomState(4).randint(3, 60, 40)]
    want, got = je.forward(prompt), te.forward(prompt)
    np.testing.assert_allclose(got, want, rtol=0, atol=Q40_LOGIT_TOL * np.abs(want).max())
    if factor > 1e6:
        serial = TorchEngine(files["mixtral"]["q40"], dtype="q40", device="cpu").forward(prompt)
        np.testing.assert_allclose(got, serial, rtol=0, atol=1e-5 * np.abs(serial).max())


# ---------------------------------------------------------------------------
# batch scheduler, CLI, speculative gate, tensor parallelism
# ---------------------------------------------------------------------------


SCHED = dict(n_rows=3, chunk=4, prefix_cache=True, page_size=16, prefill_chunk=16)


def _request(stream, prompt, temp, seed, n=8):
    stream.reset()
    first = stream.prefill_device(prompt, temp, 0.9, seed)
    got = []
    stream.stream_decode(first, lambda p, t: got.append(t) or len(got) < n, temp, 0.9, seed=seed,
                         limit=stream.pos + n, first_prev=prompt[-1])
    return got


def _sched_round(sched):
    """A cold greedy request, then three co-batched ones (its prefix hit, a
    sampled miss, a longer hit) on threads."""
    prompt = [int(t) for t in np.random.RandomState(0).randint(3, 60, 20)]
    streams = [sched.new_stream() for _ in range(3)]
    out = {"cold": _request(streams[0], prompt, 0.0, 7)}
    jobs = [(0, prompt, 0.0, 7), (1, prompt[:9], 0.8, 3), (2, prompt + [5, 6], 0.0, 11)]

    def run(row, p, temp, seed):
        out[row] = _request(streams[row], p, temp, seed)

    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_batch_scheduler_streams_match_jax(monkeypatch, files):
    """The port's BatchScheduler over the tiny Mixtral (f32): streams equal
    to the JAX scheduler's. Rows step together through the all-experts
    path; a lone row takes the top-k path."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    je, te = _engines(files, "mixtral", "f32")
    want = _sched_round(JaxScheduler(je, **SCHED))
    sched = BatchScheduler(te, **SCHED)
    got = _sched_round(sched)
    assert got == want
    assert sched._prefix.hits >= 2 and sched.decode_forwards > 0


def test_cli_moe_capacity_and_spec_warning(files, tmp_path, capsys, monkeypatch):
    """The CLI on the CPU: ``--moe-capacity 2.0`` with a prompt of >= 32
    tokens runs the bucketed prefill; ``--spec-draft 3`` on a MoE model
    prints its one warning and decodes the plain greedy stream."""
    tok = str(tmp_path / "t.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=300))
    spec = mixtral_spec(vocab_size=300, seq_len=96, weights_float_type=JaxFloatType.Q40)
    model = str(tmp_path / "m.m")
    jsyn.write_synthetic_model(model, spec, seed=1)
    base = ["generate", "--model", model, "--tokenizer", tok, "--device", "cpu", "--temperature", "0",
            "--seed", "1", "--decode-chunk", "4"]
    calls = []
    orig = tmoe._moe_dense_bucketed
    monkeypatch.setattr(tmoe, "_moe_dense_bucketed", lambda *a, **kw: calls.append(a[1].shape[0]) or orig(*a, **kw))
    long = tcli.main([*base, "--prompt", "the quick brown fox jumps over a lazy dog", "--steps", "60", "--moe-capacity", "2.0"])
    assert len(long["prompt_tokens"]) >= 32 and calls and calls[0] >= 32
    assert all(0 <= t < 300 for t in long["tokens"]) and long["tokens"]
    plain = tcli.main([*base, "--prompt", "hello world", "--steps", "24"])
    capsys.readouterr()
    spec_run = tcli.main([*base, "--prompt", "hello world", "--steps", "24", "--spec-draft", "3"])
    out = capsys.readouterr().out
    assert "--spec-draft ignored: MoE verify windows have no decode parity contract" in out
    assert spec_run["tokens"] == plain["tokens"]


def test_grok_prompt_has_no_bos(files, tmp_path):
    tok = str(tmp_path / "t.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=300))
    model = str(tmp_path / "g.m")
    jsyn.write_synthetic_model(model, grok_spec(vocab_size=300, seq_len=48), seed=6)
    res = tcli.main(["generate", "--model", model, "--tokenizer", tok, "--device", "cpu", "--prompt", "hello",
                     "--steps", "12", "--temperature", "0", "--dtype", "f32"])
    assert res["prompt_tokens"][0] != 1


def test_moe_under_tp_raises_before_loading(files, monkeypatch):
    loaded = []
    monkeypatch.setattr(TorchReader, "tensor", lambda *a, **kw: loaded.append(a) or None)
    for wt in ("q40", "f32"):
        with pytest.raises(NotImplementedError, match="MoE under --tp"):
            TorchEngine(files["mixtral"][wt], dtype="q40" if wt == "q40" else torch.float32, device="cpu", tp=2)
    args = tcli.build_parser().parse_args(["generate", "--model", files["grok"]["q40"], "--tokenizer", "unused",
                                           "--device", "cpu", "--tp", "2"])
    with pytest.raises(NotImplementedError, match="MoE under --tp"):
        tcli.make_engine(args)
    assert not loaded


@pytest.mark.parametrize("dtype", ["q40", "bf16", "f32"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_jax_carry_expert_leaves(files, arch, dtype):
    """The JAX package's load_params tree carried across equals the port's
    own load: router, expert leaves (per-expert Q40 or stacked banks) and
    Grok's extra norms, dtype for dtype and byte for byte."""
    path = files[arch]["q40"]
    jdt, tdt = {"q40": ("q40", "q40"), "bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jreader = JaxReader(path)
    jtree = jweights.load_params(jreader, jconfig.config_from_spec(jreader.spec), dtype=jdt)
    carried = dict(_leaves(tweights.params_from_jax(_flatten_jax(jtree), "cpu")))
    own = dict(_leaves(tweights.load_params(TorchReader(path), dtype=tdt, device="cpu")))
    assert list(carried) == list(own)
    assert any("/experts/" in k or "/moe_up" in k for k in own) and any("/router" in k for k in own)
    assert any("/rms_ffn2" in k for k in own) == (arch == "grok")
    for name in own:
        assert own[name].dtype == carried[name].dtype, name
        assert torch.equal(own[name], carried[name]), name


@pytest.mark.parametrize("wt", ["f32", "q40"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_file_readers_agree(files, arch, wt):
    """Both packages' `.m` readers give the same tensor names, shapes,
    offsets and bytes: the expert order up, gate, down and Grok's rms_moe /
    rms_ffn2 sit where the JAX package reads them."""
    jr, tr = JaxReader(files[arch][wt]), TorchReader(files[arch][wt])
    assert list(jr.entries) == list(tr.entries)
    names = list(tr.entries)
    assert names[5:9] == ["layers.0.moe_router", "layers.0.experts.0.up", "layers.0.experts.0.gate",
                          "layers.0.experts.0.down"]
    assert ("layers.0.rms_moe" in names and "layers.0.rms_ffn2" in names) == (arch == "grok")
    for name, e in tr.entries.items():
        j = jr.entries[name]
        assert (e.shape, e.offset, e.nbytes, int(e.float_type)) == (tuple(j.shape), j.offset, j.nbytes,
                                                                   int(j.float_type)), name
        np.testing.assert_array_equal(tr.raw(name), jr.raw(name))
        np.testing.assert_array_equal(tr.tensor(name), jr.tensor(name))


def test_synthetic_full_width_specs():
    """The chip's configurations at their published widths, and what a
    random-Q40 file at each holds (router, norms, experts)."""
    mx, gk = tsyn.mixtral_8x7b_spec(8), tsyn.grok1_spec(2)
    assert (mx.dim, mx.hidden_dim, mx.n_heads, mx.n_kv_heads, mx.head_size, mx.n_experts, mx.n_active_experts,
            mx.vocab_size, mx.rope_theta) == (4096, 14336, 32, 8, 128, 8, 2, 32000, 1e6)
    assert (gk.dim, gk.hidden_dim, gk.n_heads, gk.n_kv_heads, gk.head_size, gk.n_experts, gk.n_active_experts,
            gk.vocab_size, gk.hidden_act) == (6144, 32768, 48, 8, 128, 8, 2, 131072, HiddenAct.GELU)
    cfg = tconfig.config_from_spec(mx)
    assert cfg.is_moe and cfg.arch == ArchType.MIXTRAL and cfg.kv_mul == 4
    assert tconfig.config_from_spec(gk).kv_mul == 6


def test_random_q40_moe_file_loads(tmp_path):
    """write_random_q40_model over a small MoE spec: routers and experts
    Q40, norms near 1, and the port loads and runs it."""
    spec = tsyn.tiny_spec(arch_type=ArchType.GROK1, n_experts=4, n_active_experts=2, hidden_act=HiddenAct.GELU,
                          dim=64, hidden_dim=128, weights_float_type=FloatType.Q40)
    path = str(tmp_path / "r.m")
    tsyn.write_random_q40_model(path, spec, seed=0)
    r = TorchReader(path)
    assert r.entries["layers.0.moe_router"].float_type == FloatType.Q40
    for n in ("rms_att", "rms_ffn", "rms_moe", "rms_ffn2"):
        assert abs(float(r.tensor(f"layers.1.{n}").mean()) - 1.0) < 0.1
    te = TorchEngine(path, dtype="q40", device="cpu")
    logits = te.forward([1, 2, 3])
    assert np.isfinite(logits).all() and logits.shape == (3, spec.vocab_size)
