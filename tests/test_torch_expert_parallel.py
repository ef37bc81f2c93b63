"""Expert parallelism (``--ep``) in the port held against the JAX package's on
the 8-device CPU mesh, which runs ``tests/test_expert_parallel.py``'s
programs (its ``all_to_all`` dispatch and combine, its psum over ``ep``).

Inputs are made with numpy from seeds at that file's sizes: the one-layer
harness at E = 4 experts, 2 active, T = 8 tokens, D = 32, H = 64 (and E = 8;
T = 64 for the capacity-bucketed case), and its 4-expert Mixtral file (dim
32, hidden 64, 2 layers, vocab 64, seq_len 24), written with f32 and with
Q40 weights, and widened to dim 128 for ``tp x ep``. Tolerances, each
stated where it is used:

* the harness: 2e-4 absolute and relative (the JAX tests' bound), and the
  bucket ranks of every home rank equal to the JAX package's, exactly;
* f32 engines: logits within 1e-4 of max |logit| of the JAX EP engine's
  (the TP tests' f32 bound), greedy streams equal token for token;
* q40: expert ids of every router call equal the port's ``ep`` = 1 ids
  (which ``tests/test_torch_moe.py`` holds to the JAX package's) with
  every top-k margin above 1e-5, then logits within 2.5e-2 of max |logit|
  of the JAX EP engine's (the repo's cross-package q40 tolerance) and the
  greedy stream equal to its;
* the int8 cache: logits within 1e-3 of max |logit| of the JAX EP int8
  engine's (the rows quantize alike but for last-ulp differences of the
  f32 projections, readings ~1e-6) and the greedy stream equal to its.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.models import moe as jmoe
from distributed_llama_tpu.parallel import sharding as jsharding
from distributed_llama_tpu.parallel.expert_parallel import ExpertParallelMoE as JaxEPMoE

from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.model_file import ArchType, HiddenAct
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader as TorchReader
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import moe as tmoe
from distributed_llama_tpu_torch.ops import collectives as coll
from distributed_llama_tpu_torch.parallel import expert_parallel as tep
from distributed_llama_tpu_torch.quants import FloatType

from tests.test_expert_parallel import _moe_setup
from tests.test_torch_tensor_parallel import _leaves, _rank_trees
from tests.torch_probe_telemetry import assert_probe_telemetry_matches_jax

HARNESS_TOL = 2e-4
F32_TOL = 1e-4  # of max |logit|
Q40_TOL = 2.5e-2  # of max |logit|
I8_TOL = 1e-3  # of max |logit|
ROUTE_MARGIN = 1e-5
MIXTRAL = dict(arch_type=ArchType.MIXTRAL, n_experts=4, n_active_experts=2, hidden_act=HiddenAct.SILU)
WIDE = dict(dim=128, hidden_dim=256, n_heads=8, n_kv_heads=4, vocab_size=128, seq_len=32)
PROMPT = [1, 5, 9, 13, 2, 7, 30, 63]  # the JAX engine tests' prompt: 8 rows, the dispatch path
_DTYPES = {"f32": (jnp.float32, torch.float32), "q40": ("q40", "q40")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ep")
    out = {}
    for name, over, ft in (("f32", {}, FloatType.F32), ("q40", {}, FloatType.Q40), ("wide", WIDE, FloatType.F32),
                           ("wide_q40", WIDE, FloatType.Q40), ("dense", {"arch_type": ArchType.LLAMA}, FloatType.F32)):
        out[name] = str(d / f"{name}.m")
        spec = tsyn.tiny_spec(**{**MIXTRAL, **over, "weights_float_type": ft})
        if name == "dense":
            spec = tsyn.tiny_spec(weights_float_type=ft)
        tsyn.write_synthetic_model(out[name], spec, seed=0)
    return out


@pytest.fixture(scope="module")
def engines(files):
    """(JAX engine, port engine) per (model, ep, tp, cache dtype), built
    once; the port's sums take K4's arm (its plain version on the CPU)."""
    made = {}

    def get(model, ep, tp=1, cache=None):
        key = (model, ep, tp, cache)
        if key not in made:
            jdt, tdt = _DTYPES["q40" if model.endswith("q40") else "f32"]
            made[key] = (JaxEngine(files[model], dtype=jdt, ep=ep, tp=tp, cache_dtype=cache),
                         TorchEngine(files[model], dtype=tdt, device="cpu", ep=ep, tp=tp, cache_dtype=cache,
                                     allreduce="ring"))
        return made[key]

    return get


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@contextlib.contextmanager
def bucket_ranks(monkeypatch):
    """Every (top_idx, bucket rank) pair the port's dispatch computes."""
    seen, orig = [], tmoe.bucket_rank

    def spy(top_idx, n):
        out = orig(top_idx, n)
        seen.append((top_idx.numpy().copy(), out[1].numpy().copy()))
        return out

    monkeypatch.setattr(tmoe, "bucket_rank", spy)
    try:
        yield seen
    finally:
        monkeypatch.setattr(tmoe, "bucket_rank", orig)


def _jax_ranks(cfg, xn, router, ep):
    """The JAX package's bucket ranks of each home rank's token slice."""
    Tl = xn.shape[0] // ep
    out = []
    for i in range(ep):
        _, top_idx = jmoe.router_topk(cfg, jnp.asarray(xn[i * Tl : (i + 1) * Tl]), jnp.asarray(router))
        out.append((np.asarray(top_idx), np.asarray(jmoe.bucket_rank(top_idx, cfg.n_experts)[1])))
    return out


@pytest.mark.parametrize("ep,E,T,capacity,skew", [(2, 4, 8, 0.0, 0.0), (4, 4, 8, 0.0, 0.0), (4, 8, 8, 0.0, 0.0),
                                                   (4, 4, 6, 0.0, 0.0), (2, 4, 1, 0.0, 0.0), (2, 8, 64, 2.0, 3.0)])
def test_ep_moe_ffn_matches_jax(monkeypatch, ep, E, T, capacity, skew):
    """The one-layer harness against the JAX ``ExpertParallelMoE``: the
    dispatch path (T % ep == 0) drop-free, dense-local (T = 6 at ep 4, and
    one row), and at capacity 2.0 with 32 rows per home rank and a router
    skewed towards expert 0, where overloaded buckets drop rows. The bucket
    ranks of every home rank equal the JAX package's exactly."""
    cfg, xn, router, gate, up, down = _moe_setup(E=E, T=T, seed=E + T, capacity=capacity)
    router[:, 0] += skew * np.abs(xn).mean(axis=0) * np.sign(xn.mean(axis=0))
    tcfg = tconfig.config_from_spec(tsyn.tiny_spec(**{**MIXTRAL, "dim": 32, "hidden_dim": 64, "n_experts": E,
                                                      "vocab_size": 64, "seq_len": 32}),
                                    moe_capacity_factor=capacity)
    want = np.asarray(JaxEPMoE(cfg, ep)(xn, router, gate, up, down))
    with bucket_ranks(monkeypatch) as seen:
        got = tep.ExpertParallelMoE(tcfg, ep, device="cpu", allreduce="ring")(xn, router, gate, up, down).numpy()
    np.testing.assert_allclose(got, want, rtol=HARNESS_TOL, atol=HARNESS_TOL)
    dispatch = T % ep == 0 and T > 1
    assert len(seen) == (ep if dispatch else 0)
    if dispatch:
        for (t_idx, t_rank), (j_idx, j_rank) in zip(seen, _jax_ranks(cfg, xn, router, ep), strict=True):
            np.testing.assert_array_equal(t_idx, j_idx)
            np.testing.assert_array_equal(t_rank, j_rank)
        if capacity:
            Ce = tmoe.bucket_capacity(capacity, T // ep, cfg.n_active_experts, E)
            assert Ce < T // ep and max(int(r.max()) for _, r in seen) >= Ce  # rows dropped
    assert np.isfinite(got).all()


def test_params_carried_from_jax_equal_own_load(engines, files):
    """A JAX ``ExpertParallelForward``'s placed params, carried across device
    by device (``params_from_jax(..., ep=)``), are the port's own load for
    that tp and ep byte for byte: q40 at tp 2 x ep 2 (per-expert packs from
    the stacked blocks), f32 at ep 2 (the bank blocks joined)."""
    for model, tp, ep in (("wide_q40", 2, 2), ("f32", 1, 2)):
        je, _ = engines(model, ep, tp)
        carried = tweights.params_from_jax(_rank_trees(je), "cpu", tp=tp, ep=ep)
        own = tweights.load_params(TorchReader(files[model]), dtype=_DTYPES["q40" if "q40" in model else "f32"][1],
                                   device="cpu", tp=tp, ep=ep)
        for c_rank, o_rank in zip(*(x if tp > 1 else [x] for x in (carried, own)), strict=True):
            c, o = dict(_leaves(c_rank)), dict(_leaves(o_rank))
            assert list(c) == list(o) and any("/experts/" in k or "/moe_up" in k for k in o)
            for name in o:
                assert c[name].dtype == o[name].dtype and torch.equal(c[name], o[name]), name
        layer = (own if tp == 1 else own[0])["layers"][0]
        ranks = tep.rank_expert_leaves(layer, ep)
        assert len(ranks) == ep and all(len(r) == 4 // ep for r in ranks)
        first = ranks[1][0]["gate_up"].qs if "experts" in layer else ranks[1][0]["gate"]
        want = layer["experts"][4 // ep]["gate_up"].qs if "experts" in layer else layer["moe_gate"][4 // ep]
        assert first.data_ptr() == want.data_ptr()  # a rank's experts are the loaded leaves, not copies


def test_rule_tables_match_jax_ep_layouts(files):
    """Every leaf of an EP rank tree has one rule in each table: its ep cut
    is the axis the JAX ``ep``/``ep_q40`` layouts shard over ``ep`` (a q40
    expert's list index for the stacked axis), its tp cut the TP MoE
    table's."""
    cfg = tconfig.config_from_spec(TorchReader(files["wide_q40"]).spec)
    for quantized, dtype in ((True, "q40"), (False, torch.float32)):
        tp_table, ep_table = tep.ep_param_rules(quantized, shard_vocab=True)
        jtable = jsharding.param_rules(cfg, "ep_q40" if quantized else "ep", True)
        rank0 = tweights.load_params(TorchReader(files["wide_q40"]), dtype=dtype, device="cpu", tp=2, ep=2)[0]
        paths = sorted({p.rsplit(".", 1)[0].lstrip("/") for p, _ in _leaves(rank0)})
        assert any("experts/" in p or "moe_" in p for p in paths)
        for path in paths:
            jpath = path
            if "/experts/" in path:
                layer, _, _, leaf = path.split("/", 1)[1].split("/")
                jpath = f"layers/{layer}/experts_{leaf}"
            jspec = tuple(jtable.spec(jpath, {"model": "tp", "expert": "ep"}))
            assert ep_table.cut(path) == (0 if "ep" in jspec else None), path
            tp_cut = tp_table.cut(path)
            if "/experts/" in path:  # the stacked leaf's tp axis, less its leading expert axis
                assert tp_cut == jspec.index("tp") - 1, path
            else:
                assert tp_cut == (jspec.index("tp") if "tp" in jspec else None), path


@pytest.mark.parametrize("model,ep,tp", [("f32", 2, 1), ("f32", 4, 1), ("wide", 2, 2)])
def test_f32_engine_prefill_and_decode_match_jax(engines, model, ep, tp):
    """Prefill (the dispatch path) and a decode step (dense-local, the ep
    combine through K4's arm) against the JAX EP engine, then a greedy
    stream in decode chunks of 4, token for token."""
    je, te = engines(model, ep, tp)
    out = []
    for engine in (je, te):
        engine.reset()
        logits = [engine.prefill(PROMPT), engine.decode_step(3)]
        engine.reset()
        engine.prefill(PROMPT[:4])
        out.append((logits, list(engine.generate_chunks(7, temperature=0.0, chunk=4, limit=12))))
    for g, w in zip(out[1][0], out[0][0]):
        _close(g, w, F32_TOL)
    assert out[1][1] == out[0][1] and len(out[0][1]) == 8
    assert te.tp_backend.transfer_bytes_per_token() == je._tp_engine.transfer_bytes_per_token()
    assert te.tp_backend.mesh_shape == {"tp": tp, "ep": ep}


def test_transfer_probe_telemetry_matches_jax(engines):
    """The EP backend's probe is a ``transfer_probe`` span and feeds the
    three families as the JAX EP backend's does."""
    je, te = engines("f32", 2, 1)
    assert_probe_telemetry_matches_jax(je._tp_engine, te.tp_backend)


class Routes:
    """Expert ids and top-k margins of every router call, in call order."""

    def __init__(self):
        self.ids, self.margins = [], []


@contextlib.contextmanager
def recording(monkeypatch):
    routes, orig = Routes(), tmoe.router_topk

    def spy(cfg, xn, router):
        vals, idx = orig(cfg, xn, router)
        probs = -np.sort(-tmoe.router_probs(cfg, xn, router).numpy(), axis=-1)
        routes.ids.append(idx.numpy())
        routes.margins.append(probs[:, cfg.n_active_experts - 1] - probs[:, cfg.n_active_experts])
        return vals, idx

    monkeypatch.setattr(tmoe, "router_topk", spy)
    try:
        yield routes
    finally:
        monkeypatch.setattr(tmoe, "router_topk", orig)


@pytest.mark.parametrize("ep", [2, 4])
def test_q40_ids_then_logits_and_stream_match(monkeypatch, engines, files, ep):
    """q40: the expert ids of every layer of a prefill (the home ranks'
    calls joined) and 6 greedy decode steps equal the port's ep = 1 ids,
    every margin above ROUTE_MARGIN; then logits against the JAX EP
    engine's and its greedy stream, token for token."""
    je, te = engines("q40", ep)
    t1 = TorchEngine(files["q40"], dtype="q40", device="cpu")

    def run(engine, routes=None):
        engine.reset()
        logits = engine.prefill(PROMPT)
        return logits, [int(t) for t in engine.generate_on_device(int(np.argmax(logits)), 6, 0.0)]

    with recording(monkeypatch) as want_routes:
        run(t1)
    with recording(monkeypatch) as got_routes:
        got_logits, got = run(te)
    L = te.cfg.n_layers
    prefill_calls = [np.concatenate(got_routes.ids[l * ep : (l + 1) * ep]) for l in range(L)]
    got_ids = prefill_calls + got_routes.ids[L * ep :]
    assert len(got_ids) == len(want_routes.ids) == L * 7
    for g, w in zip(got_ids, want_routes.ids):
        np.testing.assert_array_equal(g, w)
    assert min(float(m.min()) for m in got_routes.margins) > ROUTE_MARGIN
    want_logits, want = run(je)
    _close(got_logits, want_logits, Q40_TOL)
    assert got == want and len(got) == 6


def test_i8_cache_matches_jax(engines):
    """``--cache-dtype i8`` at ep 2: every tp rank's cache is int8 rows with
    f32 scales; prefill and decode logits against the JAX EP int8 engine's,
    and its greedy stream."""
    je, te = engines("f32", 2, 1, "i8")
    out = []
    for engine in (je, te):
        engine.reset()
        logits = [engine.prefill(PROMPT[:6]), engine.decode_step(3)]
        out.append((logits, [int(t) for t in engine.generate_on_device(5, 6, 0.0)]))
    leaf = te.default_stream.cache[0][0]
    assert leaf.data.dtype == torch.int8 and leaf.scales.dtype == torch.float32
    assert tuple(leaf.data.shape) == (2, 24, 2, 8) and tuple(leaf.scales.shape) == (2, 24, 2, 1)
    for g, w in zip(out[1][0], out[0][0]):
        _close(g, w, I8_TOL)
    assert out[1][1] == out[0][1]


def test_ep_combine_takes_the_all_reduce_arm(engines, monkeypatch):
    """A decode step's experts run dense-local: one all-reduce of the ep
    ranks' partial sums per MoE layer, through ``collectives.all_reduce``
    under the engine's arm; a prefill dispatches and all-reduces nothing at
    tp 1. No expert-id host read on either (the top-k path is not taken)."""
    _, te = engines("f32", 2)
    calls, orig = [], coll.all_reduce
    monkeypatch.setattr(coll, "all_reduce",
                        lambda xs, impl="psum", group=None: calls.append((len(xs), impl)) or orig(xs, impl, group))
    te.reset()
    tmoe.reset_host_reads()
    te.prefill(PROMPT)
    n_prefill = len(calls)
    te.decode_step(3)
    assert tmoe.host_reads["expert_ids"] == 0
    # tp 1: every other all-reduce is of one rank (the identity)
    assert [c for c in calls[n_prefill:] if c[0] > 1] == [(2, "ring")] * te.cfg.n_layers
    assert all(n == 1 for n, _ in calls[:n_prefill])


def test_refusals(files):
    """The JAX package's messages: ``--ep`` on a dense model, an ep that
    does not divide the experts, and ``--ep`` with ``--sp``."""
    with pytest.raises(ValueError, match="--ep requires a mixture-of-experts model"):
        TorchEngine(files["dense"], dtype=torch.float32, device="cpu", ep=2)
    with pytest.raises(ValueError, match="ep=3 must divide n_experts=4"):
        TorchEngine(files["f32"], dtype=torch.float32, device="cpu", ep=3)
    with pytest.raises(ValueError, match="--ep and --sp do not compose"):
        TorchEngine(files["f32"], dtype=torch.float32, device="cpu", ep=2, sp=2)


def test_cli_generate_ep_prints_what_ep1_prints(tmp_path, capsys):
    """The CLI over a Mixtral file at the synthetic tokenizer's vocab (512),
    f32 weights: ``--tp 2 --ep 2 --allreduce ring`` prints what ``--ep 1``
    prints, greedy, on the CPU."""
    model, tok = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    tsyn.write_synthetic_model(model, tsyn.tiny_spec(**MIXTRAL, dim=64, n_heads=8, n_kv_heads=4, vocab_size=512),
                               seed=0)
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=512))
    base = ["generate", "--model", model, "--tokenizer", tok, "--prompt", "hello world", "--steps", "16",
            "--device", "cpu", "--temperature", "0", "--seed", "3", "--decode-chunk", "4", "--dtype", "f32"]
    runs, texts = [], []
    for extra in ([], ["--tp", "2", "--ep", "2", "--allreduce", "ring"]):
        runs.append(tcli.main(base + extra))
        texts.append(capsys.readouterr().out.split("Generated tokens:")[0])
    assert runs[0]["tokens"] == runs[1]["tokens"] and len(runs[0]["tokens"]) > 4
    assert texts[0] == texts[1]
