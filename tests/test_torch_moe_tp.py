"""Mixtral and Grok-1 under tensor parallelism in the port, held against the
JAX package's TP engine on the 8-device CPU mesh.

Models: the tiny Mixtral and Grok-1 of ``tests/test_moe.py`` widened to
dim 256, hidden 512, 8 heads, 4 kv heads, 4 experts (2 active), vocab 320,
seq_len 64, 2 layers, written once with f32 and with Q40 weights: the
narrowest widths whose Q40 shards land on quant blocks at tp = 4. Their
matmuls take the f32 fallback in both packages (the JAX TP engine's
interpret-mode kernels on the 8-device CPU mesh cost minutes under a
parallel test run); the kernels' plain versions under TP are held in
``tests/test_torch_tensor_parallel.py``, at the expert shapes in
``tests/test_torch_moe.py``, and the kernels themselves under MoE TP by
``chip_smoke.py`` phase 13c.

* Expert shards: every rank's router, per-expert gate|up and down packs
  (q40) or bank slices (f32) equal the JAX TP engine's placed shards, byte
  for byte, and the rule table cuts each leaf where the JAX table does.
* f32 weights: expert ids equal the JAX package's (recorded eagerly at
  tp = 1: its TP program is compiled), every routing margin above
  ROUTE_MARGIN, then prefill and decode logits within 1e-4 of max |logit|
  of the JAX TP engine's.
* q40 weights: expert ids of every layer and step equal the port's tp = 1
  ids (which ``tests/test_torch_moe.py`` holds to the JAX package's), then
  the greedy stream equals the JAX TP engine's (``generate_on_device``,
  one dispatch, in both), token for token.
* The capacity-bucketed prefill (``--moe-capacity``) under TP against the
  JAX TP engine's, and drop-free buckets against the serial path.
* One expert-id host read per MoE layer per decoded token at every tp.
* The CLI at ``--tp 2 --allreduce ring`` prints what ``--tp 1`` prints.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.formats import synthetic as jsyn
from distributed_llama_tpu.models import moe as jmoe
from distributed_llama_tpu.parallel import sharding as jsharding
from distributed_llama_tpu.quants import FloatType as JaxFloatType

from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader as TorchReader
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import llama as tllama
from distributed_llama_tpu_torch.models import moe as tmoe
from distributed_llama_tpu_torch.ops import collectives as coll
from distributed_llama_tpu_torch.parallel import sharding

from tests.test_moe import grok_spec, mixtral_spec
from tests.test_torch_tensor_parallel import _leaves, _rank_trees

WIDE = dict(dim=256, hidden_dim=512, n_heads=8, n_kv_heads=4, vocab_size=320, seq_len=64)
ARCHS = {"mixtral": (mixtral_spec, 0), "grok": (grok_spec, 6)}
PROMPT = [1, 5, 9, 13, 2, 7, 30, 11, 4]
ROUTE_MARGIN = 1e-5  # the smallest k-th vs (k+1)-th probability gap a comparison accepts
_F32_TOL = 1e-4  # f32 logits, of max |logit| (the dense TP tests' tight tolerance)
Q40_LOGIT_TOL = 2.5e-2  # q40 logits, of max |logit| (the repo's cross-package q40 tolerance)
_DTYPES = {"q40": ("q40", "q40"), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = {}
    d = tmp_path_factory.mktemp("torch_moe_tp")
    for arch, (spec_fn, seed) in ARCHS.items():
        for wt in ("f32", "q40"):
            path = str(d / f"{arch}_{wt}.m")
            ft = JaxFloatType.Q40 if wt == "q40" else JaxFloatType.F32
            jsyn.write_synthetic_model(path, spec_fn(**WIDE, weights_float_type=ft), seed=seed)
            out[arch, wt] = path
    return out


@pytest.fixture(scope="module")
def engines(files):
    """(JAX engine, port engine) per (arch, weights, tp), built once; the
    port's ranks sum with K4's arm (its plain version on the CPU)."""
    made = {}

    def get(arch, wt, tp, **kw):
        key = (arch, wt, tp, tuple(sorted(kw.items())))
        if key not in made:
            jdt, tdt = _DTYPES[wt]
            made[key] = (JaxEngine(files[arch, wt], dtype=jdt, tp=tp, **kw),
                         TorchEngine(files[arch, wt], dtype=tdt, device="cpu", tp=tp, allreduce="ring", **kw))
        return made[key]

    return get


class Routes:
    """Expert ids and top-k margins of every router call, in call order."""

    def __init__(self):
        self.ids, self.margins = [], []

    def min_margin(self) -> float:
        return float(min(m.min() for m in self.margins))


@contextlib.contextmanager
def recording(monkeypatch, module, to_np):
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


def _np(t):
    return t.detach().cpu().numpy()


def _same_ids(got: Routes, want: Routes):
    assert len(got.ids) == len(want.ids)
    for g, w in zip(got.ids, want.ids):
        np.testing.assert_array_equal(g, w)
    assert got.min_margin() > ROUTE_MARGIN, f"routing margin {got.min_margin():.3e}: pick another seed"


def _forward_steps(engine, steps=3):
    """Prefill logits, then ``steps`` greedy decode steps' logits."""
    engine.reset()
    out = [engine.prefill(PROMPT)]
    for _ in range(steps):
        out.append(engine.decode_step(int(np.argmax(out[-1]))))
    return out


@pytest.mark.parametrize("wt,tp", [("q40", 2), ("q40", 4), ("f32", 2)])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_expert_shards_equal_jax(engines, files, arch, wt, tp):
    """The JAX TP engine's placed shards, carried across rank by rank, are
    the port's own per-rank load byte for byte: the replicated router, each
    expert's gate|up (output-sharded) and down (input-sharded) pack, or the
    f32 bank slices, and Grok-1's extra norms."""
    je, _ = engines(arch, wt, tp)
    carried = tweights.params_from_jax(_rank_trees(je), "cpu", tp=tp)
    own = tweights.load_params(TorchReader(files[arch, wt]), dtype=_DTYPES[wt][1], device="cpu", tp=tp)
    for c_rank, o_rank in zip(carried, own):
        c, o = dict(_leaves(c_rank)), dict(_leaves(o_rank))
        assert list(c) == list(o)
        assert any("/experts/" in k or "/moe_up" in k for k in o) and any("/router" in k for k in o)
        assert any("/rms_ffn2" in k for k in o) == (arch == "grok")
        for name in o:
            assert c[name].dtype == o[name].dtype and torch.equal(c[name], o[name]), name
    assert all(r["layers"][0]["router"] is own[0]["layers"][0]["router"] for r in own)  # one replicated tensor


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rule_table_matches_jax_moe_layouts(files, arch):
    """Every leaf of a MoE rank tree has exactly one rule, cut along the
    dimension the JAX table shards it (for a bank, the index of its sharded
    axis); the dense table still names no router."""
    cfg = tconfig.config_from_spec(TorchReader(files[arch, "q40"]).spec)
    for layout, dtype in (("q40", "q40"), ("layered", torch.float32)):
        table = sharding.param_rules(layout, shard_vocab=True, moe=True)
        jtable = jsharding.param_rules(cfg, layout, True)
        rank0 = tweights.load_params(TorchReader(files[arch, "q40"]), dtype=dtype, device="cpu", tp=2)[0]
        paths = sorted({p.rsplit(".", 1)[0].lstrip("/") for p, _ in _leaves(rank0)})
        assert any(p.endswith("router") for p in paths)
        for path in paths:
            jspec = tuple(jtable.spec(path, {"model": "tp"}))
            cut = table.cut(path)
            assert cut == (jspec.index("tp") if "tp" in jspec else None), path
    with pytest.raises(sharding.UnmatchedLeafError):
        sharding.param_rules("q40", shard_vocab=False).cut("layers/0/router")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_f32_routes_then_logits_match_jax(monkeypatch, engines, arch, tp):
    """f32 weights: the port's TP expert ids equal the JAX package's (its
    tp = 1 engine run eagerly), then every logit row of a prefill and three
    greedy decode steps within 1e-4 of max |logit| of the JAX TP engine's."""
    je1, _ = engines(arch, "f32", 1)
    je, te = engines(arch, "f32", tp)
    with recording(monkeypatch, jmoe, np.asarray) as jroutes, jax.disable_jit():
        _forward_steps(je1)
    with recording(monkeypatch, tmoe, _np) as troutes:
        got = _forward_steps(te)
    _same_ids(troutes, jroutes)
    for g, w in zip(got, _forward_steps(je)):
        np.testing.assert_allclose(g, w, rtol=0, atol=_F32_TOL * np.abs(w).max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_q40_routes_then_greedy_stream_match_jax(monkeypatch, engines, arch, tp):
    """q40 weights: the port's TP expert ids equal its tp = 1 ids on every
    router call of a prefill and 8 greedy steps, then the greedy stream
    (one ``generate_on_device`` dispatch) equals the JAX TP engine's token
    for token; logits within the q40 tolerance."""
    _, te1 = engines(arch, "q40", 1)
    je, te = engines(arch, "q40", tp)

    def run(engine):
        engine.reset()
        logits = engine.prefill(PROMPT)
        return logits, np.asarray(engine.generate_on_device(int(np.argmax(logits)), 8, 0.0)).tolist()

    with recording(monkeypatch, tmoe, _np) as t1routes:
        _, want1 = run(te1)
    with recording(monkeypatch, tmoe, _np) as troutes:
        got_logits, got = run(te)
    _same_ids(troutes, t1routes)
    assert got == want1
    want_logits, want = run(je)
    assert got == want and len(got) == 8
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=Q40_LOGIT_TOL * np.abs(want_logits).max())


@pytest.mark.parametrize("factor", [2.0, 1e9])
def test_bucketed_prefill_under_tp_matches_jax(files, engines, factor):
    """``--moe-capacity`` at tp = 2: a 40-token prompt pads to a 64-row
    bucket whose pad rows route to the sink; the capacity-bucketed Q40
    prefill against the JAX TP engine's (2.0), and drop-free buckets (1e9)
    against the port's serial all-experts path under TP."""
    te = TorchEngine(files["mixtral", "q40"], dtype="q40", device="cpu", tp=2, allreduce="ring",
                     moe_capacity_factor=factor)
    prompt = [int(t) for t in np.random.RandomState(4).randint(3, 60, 40)]
    calls = []
    orig = tmoe._mix_buckets
    tmoe._mix_buckets = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        got = te.forward(prompt)
    finally:
        tmoe._mix_buckets = orig
    assert len(calls) == 2 * te.cfg.n_layers  # every rank of every layer
    if factor > 1e6:
        _, serial = engines("mixtral", "q40", 2)
        serial.reset()
        np.testing.assert_allclose(got, serial.forward(prompt), rtol=0, atol=1e-5 * np.abs(got).max())
    else:
        want = JaxEngine(files["mixtral", "q40"], dtype="q40", tp=2, moe_capacity_factor=factor).forward(prompt)
        np.testing.assert_allclose(got, want, rtol=0, atol=Q40_LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_one_expert_id_read_per_layer_per_token(engines, tp):
    """A prefill reads no expert ids; each decoded token reads them once per
    MoE layer, however many ranks serve it (one routing serves all)."""
    _, te = engines("mixtral", "q40", tp)
    te.reset()
    tmoe.reset_host_reads()
    first = int(np.argmax(te.prefill(PROMPT)))
    assert tmoe.host_reads["expert_ids"] == 0
    te.generate_on_device(first, 5)
    assert tmoe.host_reads["expert_ids"] == 5 * te.cfg.n_layers


def test_ranks_stay_identical_and_arms_agree(engines):
    """Every rank's residual stream is byte-identical after a MoE prefill
    under each all-reduce arm, and the arms' logits agree with psum's
    within the f32 tolerance."""
    _, te = engines("grok", "f32", 2)
    want = None
    for impl in coll.IMPLS:
        caches = te.tp_backend.init_cache(te.cache_dtype)
        xs, _ = tllama.forward_hidden_tp(te.cfg, te.params, torch.tensor(PROMPT), caches, 0, "int8", impl)
        assert all(torch.equal(x, xs[0]) for x in xs[1:]), impl
        te.tp_backend.allreduce = impl
        te.reset()
        got = te.prefill(PROMPT)
        want = got if want is None else want
        np.testing.assert_allclose(got, want, rtol=0, atol=_F32_TOL * np.abs(want).max(), err_msg=impl)
    te.tp_backend.allreduce = "ring"


def test_cli_moe_tp_prints_what_tp1_prints(files, tmp_path, capsys):
    """The CLI over the Mixtral file with f32 weights: ``--tp 2 --allreduce
    ring`` and ``--tp 4`` print what ``--tp 1`` prints, greedy (q40 logits
    move by up to 0.6% of max |logit| between tp = 1 and tp > 1 on this
    model, enough to swap near-tied tokens)."""
    tok = str(tmp_path / "t.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=WIDE["vocab_size"]))
    base = ["generate", "--model", files["mixtral", "q40"], "--tokenizer", tok, "--prompt", "hello world hello",
            "--steps", "20", "--device", "cpu", "--temperature", "0", "--seed", "3", "--decode-chunk", "4",
            "--dtype", "f32"]
    texts, runs = [], []
    for extra in ([], ["--tp", "2", "--allreduce", "ring"], ["--tp", "4"]):
        runs.append(tcli.main(base + extra))
        texts.append(capsys.readouterr().out.split("Generated tokens:")[0])
    assert runs[0]["tokens"] == runs[1]["tokens"] == runs[2]["tokens"] and len(runs[0]["tokens"]) > 4
    assert texts[0] == texts[1] == texts[2]

