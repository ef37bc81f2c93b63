"""The port's batched serving over tensor-parallel ranks held against the
JAX package's ``TensorParallelForward`` batched half and its
``BatchScheduler`` under ``tp`` on the 8-device CPU mesh.

Model: the synthetic Q40 file of ``tests/test_torch_tensor_parallel.py``
(dim 512, hidden 1024, 2 layers, 8 heads, 4 kv heads, vocab 512, seq_len
64), loaded by both packages with f32 weights (and with q40 for one cross
check), so tp = 4 leaves one kv head per rank. Inputs come from a numpy
seed. Tolerances: f32 logits and cache bytes within 1e-4 of their max
|value| (the TP engine tests' tight tolerance; readings are ulps), q40
logits within 2.5e-2 of max |logit| with the greedy token compared where
the JAX top-2 gap exceeds it; tokens, ids and copied pool pages exactly.

* The backend's batched half, per rank: ``slab_forward`` and its paged
  form (logits, every rank's slab row), ``batched_decode_chunk`` and its
  paged form (tokens of greedy and sampled rows, an inactive bucket row,
  every rank's slab), and ``publish_pages`` (each rank's pool pages byte
  for byte the JAX pool's kv-head shards from the same slab bytes).
* The sampled pick: the port's full-vocab candidate order gives the tokens
  the JAX package's sharded top-k composition gives, ties included.
* The scheduler: streams equal to the JAX TP scheduler's (prefix hits, a
  sampled miss, chunked prefill) at tp = 2; the int8 cache under TP;
  the JAX ``TestTensorParallelPool`` cases; MoE batched rows (expert ids,
  then tokens); the two modes disabled under TP with the JAX messages; row
  faults, retries and preemption per row (on the port alone: the JAX TP
  scheduler's programs cost minutes under a parallel run); ``tp.transfer``.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.engine import faults as jfaults
from distributed_llama_tpu.engine.batch import BatchScheduler as JaxScheduler
from distributed_llama_tpu.engine.integrity import split_chunk_outputs
from distributed_llama_tpu.models import sampling as jsampling

from distributed_llama_tpu_torch import prng
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import faults
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.engine.spill import HostArena
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.models import moe as tmoe
from distributed_llama_tpu_torch.models import sampling
from distributed_llama_tpu_torch.ops import kv_cache as kvc

from tests.test_torch_moe_tp import WIDE, recording
from tests.test_torch_tensor_parallel import SPEC

_F32_TOL = 1e-4  # of max |value|: f32 logits and cache rows
_Q40_TOL = 2.5e-2  # of max |logit|: the repo's cross-package q40 tolerance
PAGE = 8
RNG = np.random.RandomState(14)
PROMPTS = [[int(t) for t in RNG.randint(3, 500, n)] for n in (10, 12, 20)]
SCHED = dict(n_rows=3, chunk=4, prefix_cache=True, page_size=PAGE, prefill_chunk=16)


@pytest.fixture(autouse=True)
def _clear_fault_plans():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_tp_batch") / "model.m"
    tsyn.write_synthetic_model(str(path), tsyn.tiny_spec(**SPEC, weights_float_type=tsyn.FloatType.Q40), seed=3)
    return str(path)


@pytest.fixture(scope="module")
def engines(model_path):
    """(JAX engine, port engine) per (weights, tp, cache dtype), built once."""
    made = {}

    def get(wt: str, tp: int, cache: str | None = None):
        if (wt, tp, cache) not in made:
            jdt, tdt = ("q40", "q40") if wt == "q40" else (jnp.float32, torch.float32)
            made[wt, tp, cache] = (JaxEngine(model_path, dtype=jdt, tp=tp, cache_dtype=cache),
                                   TorchEngine(model_path, dtype=tdt, device="cpu", tp=tp, cache_dtype=cache))
        return made[wt, tp, cache]

    return get


def _close(got, want, tol=_F32_TOL, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _rank_half(jhalf, r: int, tp: int) -> np.ndarray:
    """Rank r's kv-head shard of a JAX global cache half [..., K, hd]."""
    a = np.asarray(jhalf)
    kl = a.shape[-2] // tp
    return a[..., r * kl:(r + 1) * kl, :]


def _same_slab(tslab, jslab, tp, exact=False):
    for r in range(tp):
        for l, (leaf, (jk, jv)) in enumerate(zip(tslab[r], jslab)):
            for i, jh in enumerate((jk, jv)):
                got, want = leaf[i].numpy(), _rank_half(jh, r, tp)
                if exact:
                    assert np.array_equal(got, want), (r, l, i)
                else:
                    _close(got, want, msg=f"rank {r} layer {l} half {i}")


def _padded(prompt):
    bucket = max(8, 1 << (len(prompt) - 1).bit_length())
    out = np.zeros(bucket, np.int64)
    out[: len(prompt)] = prompt
    return out


# rows 0/1 greedy and sampled, row 2 greedy top-k, row 3 an inactive bucket row
TEMPS, TOPPS, TOPKS, SEEDS = [0.0, 0.8, 0.7, 1.0], [0.9, 0.9, 1.0, 0.9], [0, 0, 5, 0], [7, 3, 11, 0]
ACTIVE = [True, True, True, False]


def _settings():
    """The rows' sampler settings as the port's [B] tensors and the JAX
    backend's arrays."""
    seeds32 = [prng.fold_seed(s) for s in SEEDS]
    torch_kw = dict(temperature=torch.tensor(TEMPS, dtype=torch.float32), topp=torch.tensor(TOPPS),
                    topk=torch.tensor(TOPKS, dtype=torch.int64), seeds=torch.tensor(seeds32, dtype=torch.int64))
    jax_kw = (jnp.asarray(TEMPS, jnp.float32), jnp.asarray(TOPPS, jnp.float32), jnp.asarray(TOPKS, jnp.int32),
              jnp.asarray(np.array(seeds32, np.uint32)))
    return torch_kw, jax_kw


@pytest.mark.parametrize("tp", [2, 4])
def test_backend_batched_half_matches_jax(engines, tp):
    """slab_forward rows, a batched chunk, the publish, the paged prefill
    and the paged chunk of the port's backend against the JAX TP backend's
    on the same inputs."""
    je, te = engines("f32", tp)
    jb, tb = je._tp_engine, te.tp_backend
    B, n_steps = 4, 3
    jslab, tslab = jb.init_batch_cache(B, jnp.float32), tb.init_batch_cache(B, torch.float32)
    assert [tuple(leaf.shape) for leaf in tslab[0]] == [(2, B, SPEC["seq_len"], SPEC["n_kv_heads"] // tp, 64)] * 2
    firsts = []
    for row, prompt in enumerate(PROMPTS):
        toks = _padded(prompt)
        jl, jslab = jb.slab_forward(je.params, toks, jslab, row, 0, len(prompt))
        tl, tslab = tb.slab_forward(te.params, torch.from_numpy(toks), tslab, row, 0, len(prompt))
        _close(tl[: len(prompt)].numpy(), np.asarray(jl)[: len(prompt)], msg=f"row {row} prefill logits")
        firsts.append(int(np.argmax(np.asarray(jl)[len(prompt) - 1])))
    _same_slab(tslab, jslab, tp)

    pos = [len(p) for p in PROMPTS] + [0]
    first = firsts + [0]
    tkw, jkw = _settings()
    jout, jslab = jb.batched_decode_chunk(je.params, jnp.asarray(first, jnp.int32), jslab,
                                          jnp.asarray(pos, jnp.int32), jnp.asarray(ACTIVE), n_steps, *jkw)
    tout, tslab = tb.batched_decode_chunk(te.params, torch.tensor(first), tslab, pos, ACTIVE, n_steps, **tkw)
    jt, _, jfin = split_chunk_outputs(np.asarray(jout), n_steps)
    tt, _, tfin = split_chunk_outputs(tout.numpy(), n_steps)
    assert np.array_equal(tt[:, :3], jt[:, :3]) and tfin[:3].all() and jfin[:3].all()
    _same_slab(tslab, jslab, tp)

    # publish row 2's two full pages from the SAME slab bytes: each rank's
    # pool pages equal the JAX pool's kv-head shards byte for byte
    for r in range(tp):
        for leaf, (jk, jv) in zip(tslab[r], jslab):
            leaf[0].copy_(torch.from_numpy(_rank_half(jk, r, tp).copy()))
            leaf[1].copy_(torch.from_numpy(_rank_half(jv, r, tp).copy()))
    P = 6
    jpool, tpool = jb.init_page_pool(P, PAGE, jnp.float32), tb.init_page_pool(P, PAGE, torch.float32)
    ids, src = [3, 1], [0, 1]
    jpool = jb.publish_pages(jslab, jpool, np.array(ids, np.int32), np.array(src, np.int32), 2)
    tpool = tb.publish_pages(tslab, tpool, ids, src, 2)
    for r in range(tp):
        for (tk, tv), (jk, jv) in zip(tpool[r], jpool):
            assert np.array_equal(tk.numpy(), _rank_half(jk, r, tp))
            assert np.array_equal(tv.numpy(), _rank_half(jv, r, tp))

    # row 3 prefills the same 20-token prompt over the two published pages
    prompt = PROMPTS[2]
    n_table = SPEC["seq_len"] // PAGE
    table = np.zeros(n_table, np.int32)
    table[:2] = ids
    suffix = _padded(prompt[2 * PAGE:])
    n_suf = len(prompt) - 2 * PAGE
    jl, jslab = jb.slab_forward_paged(je.params, suffix, jslab, jpool, 3, 2 * PAGE, n_suf, table, 2 * PAGE)
    tl, tslab = tb.slab_forward_paged(te.params, torch.from_numpy(suffix), tslab, tpool, 3, 2 * PAGE, n_suf,
                                      torch.from_numpy(table), 2 * PAGE)
    _close(tl[:n_suf].numpy(), np.asarray(jl)[:n_suf], msg="paged prefill logits")
    pos = [p + n_steps for p in pos[:3]] + [len(prompt)]
    first = [int(t) for t in tt[-1, :3]] + [int(np.argmax(np.asarray(jl)[n_suf - 1]))]
    active = [True] * 4
    tables = np.zeros((4, n_table), np.int32)
    tables[3] = table
    matched = np.array([0, 0, 0, 2 * PAGE], np.int32)
    jout, jslab = jb.batched_decode_chunk_paged(
        je.params, jnp.asarray(first, jnp.int32), jslab, jpool, jnp.asarray(pos, jnp.int32), jnp.asarray(active),
        n_steps, *jkw, jnp.asarray(tables), jnp.asarray(matched))
    tout, tslab = tb.batched_decode_chunk_paged(
        te.params, torch.tensor(first), tslab, tpool, pos, active, n_steps, tkw["temperature"], tkw["topp"],
        tkw["topk"], tkw["seeds"], torch.from_numpy(tables), torch.from_numpy(matched))
    jt, _, _ = split_chunk_outputs(np.asarray(jout), n_steps)
    tt, _, tfin = split_chunk_outputs(tout.numpy(), n_steps)
    assert np.array_equal(tt, jt) and tfin.all()
    _same_slab(tslab, jslab, tp)


def test_q40_slab_forward_within_the_cross_path_tolerance(engines):
    """q40 weights at tp = 2: prefill logits within 2.5e-2 of max |logit|
    of the JAX TP backend's, the greedy token equal where the JAX top-2 gap
    exceeds that tolerance."""
    je, te = engines("q40", 2)
    jb, tb = je._tp_engine, te.tp_backend
    jslab, tslab = jb.init_batch_cache(2, jnp.bfloat16), tb.init_batch_cache(2, torch.bfloat16)
    compared = 0
    for row, prompt in enumerate(PROMPTS[:2]):
        toks = _padded(prompt)
        jl, jslab = jb.slab_forward(je.params, toks, jslab, row, 0, len(prompt))
        tl, tslab = tb.slab_forward(te.params, torch.from_numpy(toks), tslab, row, 0, len(prompt))
        want, got = np.asarray(jl)[: len(prompt)], tl[: len(prompt)].numpy()
        tol = _Q40_TOL * np.abs(want).max()
        _close(got, want, _Q40_TOL)
        top2 = -np.sort(-want, axis=-1)[:, :2]
        sure = top2[:, 0] - top2[:, 1] > tol
        assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
        compared += int(sure.sum())
    assert compared > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_full_vocab_pick_equals_sharded_topk_composition(tp):
    """The JAX TP sampler composes its candidates over the vocab shards
    (``sharded_topk_indices``) before the all-gather; the port picks from
    the gathered logits. On logits full of ties, also across a shard
    boundary, the composed candidates are the port's candidate order and
    every row draws the same token, for top-k, top-p and both. A nucleus
    wider than the candidate window falls back to the full sort in both
    packages (tie-free logits there: a full-vocab cumsum may round a coin's
    crossing differently by an ulp, the sampler's stated caveat)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from distributed_llama_tpu.parallel.tensor_parallel import shard_map

    rng = np.random.RandomState(tp)
    V, B, K = 512, 8, jsampling.TOPP_FAST_K
    tied = (np.round(rng.randn(B, V) * 2) / 2).astype(np.float32)
    tied[:, V // tp - 3: V // tp + 3] = tied.max()  # a tie straddling a shard boundary
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    compose = jax.jit(shard_map(lambda x: jsampling.sharded_topk_indices(x, "tp", K), mesh=mesh,
                                in_specs=P(None, "tp"), out_specs=P(), check_vma=False))
    order = torch.sort(torch.from_numpy(tied), dim=-1, descending=True, stable=True).indices[:, :K]
    assert np.array_equal(np.asarray(compose(jnp.asarray(tied))), order.numpy())
    seeds, pos = [prng.fold_seed(s) for s in range(B)], list(range(3, 3 + B))
    wide = rng.randn(B, V).astype(np.float32)
    for logits, (temp, topp, topk) in ((tied, (0.8, 1.0, 7)), (tied, (0.8, 0.9, 0)), (tied, (1.3, 0.5, 20)),
                                       (wide, (2.0, 0.999, 0))):
        args = (jnp.asarray(logits), jnp.asarray(np.array(seeds, np.uint32)), jnp.asarray(pos, jnp.int32),
                jnp.full(B, temp, jnp.float32), jnp.full(B, topp, jnp.float32), jnp.full(B, topk, jnp.int32))
        want = np.asarray(jsampling.fused_sample_batched(*args, cand=compose(jnp.asarray(logits)))).tolist()
        assert want == np.asarray(jsampling.fused_sample_batched(*args)).tolist()
        got = sampling.fused_sample_batched(
            torch.from_numpy(logits), torch.tensor(seeds), torch.tensor(pos), torch.full((B,), temp),
            torch.full((B,), topp), torch.full((B,), topk, dtype=torch.int64))
        assert got.tolist() == want, (temp, topp, topk)


def decode_tokens(stream, prompt, temp, seed, n=8, topp=0.9):
    """One request through the fused serving flow on a scheduler row."""
    stream.reset()
    first = stream.prefill_device(prompt, temp, topp, seed)
    got = []

    def on_token(prev, tok):
        got.append(tok)
        return len(got) < n

    stream.stream_decode(first, on_token, temp, topp, seed=seed, limit=stream.pos + n, first_prev=prompt[-1])
    return got


# a cold greedy request, then three co-batched ones: its prefix hit, a
# sampled miss, and a longer prompt sharing the cold one's first page
ROUND = [(0, PROMPTS[2], 0.0, 7), (1, PROMPTS[0], 0.8, 3), (2, PROMPTS[2][:9] + [5, 6, 9], 0.0, 11)]


def run_round(sched):
    streams = [sched.new_stream() for _ in range(3)]
    out = {"cold": decode_tokens(streams[0], PROMPTS[2], 0.0, 7)}

    def run(row, prompt, temp, seed):
        out[row] = decode_tokens(streams[row], prompt, temp, seed)

    threads = [threading.Thread(target=run, args=r) for r in ROUND]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sched.check_prefix()
    return out


def test_scheduler_streams_match_jax(engines):
    """The TP scheduler at tp = 2 (the batched half at tp = 4 is held
    above): the JAX TP scheduler's streams, hits included."""
    je, te = engines("f32", 2)
    want = run_round(JaxScheduler(je, **SCHED))
    sched = BatchScheduler(te, **SCHED)
    got = run_round(sched)
    assert got == want
    assert got[0] == got["cold"] and sched._prefix.hits == 2
    assert sched.decode_forwards > 0


def test_i8_cache_under_tp(engines):
    """The int8 cache under TP (the JAX package's ``test_kv_cache.py``
    ``test_tp_i8_cache_sharded``): every rank's cache, slab and pool hold
    int8 rows of its own kv heads with per-(slot, head) scales; the
    engine's greedy tokens equal the JAX TP engine's, and the scheduler's
    prefix hit streams what its cold run streamed."""
    je, te = engines("f32", 2, "i8")
    want = []
    for engine in (je, te):
        engine.reset()
        engine.prefill(PROMPTS[0])
        want.append([int(t) for t in engine.generate_on_device(4, 6, temperature=0.0)])
    assert want[1] == want[0] and len(want[0]) == 6
    k0 = te.default_stream.cache[1][0]
    assert tuple(k0.data.shape) == (2, SPEC["seq_len"], 2, 64) and tuple(k0.scales.shape) == (2, SPEC["seq_len"], 2, 1)
    sched = BatchScheduler(te, **SCHED)
    leaf, (pk, _) = sched._slab[1][0], sched._pool[1][0]
    assert isinstance(leaf, kvc.QuantizedKV) and leaf.data.dtype == torch.int8
    assert tuple(leaf.data.shape) == (2, 3, SPEC["seq_len"], 2, 64) and tuple(leaf.scales.shape[-2:]) == (2, 1)
    assert tuple(pk.data.shape[1:]) == (PAGE, 2, 64) and pk.scales.dtype == torch.float32
    got = run_round(sched)
    assert got[0] == got["cold"] and sched._prefix.hits == 2


class TestTensorParallelPool:
    """The JAX package's ``tests/test_paged_attention.py::
    TestTensorParallelPool`` cases on the port (f32 weights, page 4)."""

    PAGE = 4
    PROMPT = [1, 5, 9, 2, 7, 3, 11, 4, 6, 8]  # 10 tokens = 2 full pages + 2

    @pytest.fixture(scope="class")
    def tiny(self, tmp_path_factory):
        path = str(tmp_path_factory.mktemp("tp_pool") / "m.m")
        tsyn.write_synthetic_model(path, tsyn.tiny_spec(seq_len=96), seed=0)
        return path

    def _sched(self, engine, **kw):
        kw.setdefault("prefix_cache", True)
        kw.setdefault("kv_pages", 16)
        kw.setdefault("page_size", self.PAGE)
        return BatchScheduler(engine, n_rows=2, chunk=4, **kw)

    def _decode(self, stream, n=8):
        return decode_tokens(stream, self.PROMPT, 0.0, 7, n)

    def test_tp_hit_matches_cold(self, tiny):
        sched = self._sched(TorchEngine(tiny, dtype=torch.float32, device="cpu", tp=2))
        assert sched._prefix is not None  # tp does not disable the cache
        s0, s1 = sched.new_stream(), sched.new_stream()
        cold = self._decode(s0)
        hit = self._decode(s1)
        assert s1.matched_len == 2 * self.PAGE  # the alias engaged
        assert hit == cold
        sched.check_prefix()

    def test_tp_hit_matches_single_chip(self, tiny):
        """The sharded pool does not change numerics: a tp=2 prefix-hit
        stream equals the single-chip prefix-hit stream."""
        a = self._sched(TorchEngine(tiny, dtype=torch.float32, device="cpu")).new_stream()
        self._decode(a)
        want = self._decode(a)
        b = self._sched(TorchEngine(tiny, dtype=torch.float32, device="cpu", tp=2)).new_stream()
        self._decode(b)
        assert self._decode(b) == want

    def test_tp_publish_and_alias_invariants(self, tiny):
        sched = self._sched(TorchEngine(tiny, dtype=torch.float32, device="cpu", tp=2))
        s = sched.new_stream()
        self._decode(s, 2)
        assert sched._prefix.pages_in_use() == 2
        s.reset()
        s.prefill(self.PROMPT)  # hit mid-request: pins held
        assert s.matched_len == 2 * self.PAGE
        sched.check_prefix()
        s.reset()
        assert all(nd.refs == 0 for nd in sched._prefix._walk())


def test_moe_batched_rows_ids_then_tokens(monkeypatch, tmp_path):
    """Mixtral (f32, dim 256) at tp = 2: a batched chunk's expert ids on
    every router call equal the one-rank batched chunk's (the ranks route
    once per layer from the byte-identical residual), every routing margin
    above 1e-5; then the tokens equal the JAX TP backend's."""
    from distributed_llama_tpu.formats import synthetic as jsyn
    from distributed_llama_tpu.quants import FloatType as JaxFloatType

    from tests.test_moe import mixtral_spec

    path = str(tmp_path / "mixtral.m")
    jsyn.write_synthetic_model(path, mixtral_spec(**WIDE, weights_float_type=JaxFloatType.F32), seed=0)
    je = JaxEngine(path, dtype=jnp.float32, tp=2)
    te1 = TorchEngine(path, dtype=torch.float32, device="cpu")
    te = TorchEngine(path, dtype=torch.float32, device="cpu", tp=2)
    prompts = [[1, 5, 9, 13, 2, 7], [30, 11, 4, 8], [3, 3, 17]]
    B, n_steps = 4, 3
    active = [True, True, True, False]
    pos = [len(p) for p in prompts] + [0]
    tkw, jkw = _settings()

    def prefill(slab, forward):
        firsts = []
        for row, p in enumerate(prompts):
            logits, slab = forward(torch.from_numpy(_padded(p)), slab, row, len(p))
            firsts.append(int(logits[len(p) - 1].argmax()))
        return torch.tensor(firsts + [0]), slab

    from distributed_llama_tpu_torch.models import llama as tllama

    def one_rank(toks, slab, row, n):
        logits, _ = tllama.forward_tokens(te1.cfg, te1.params, toks, [kvc.slab_row(leaf, row) for leaf in slab], 0,
                                          n_real=n)
        return logits, slab

    first1, slab1 = prefill(tllama.init_batch_cache(te1.cfg, B, torch.float32, "cpu"), one_rank)
    firsts, tslab = prefill(te.tp_backend.init_batch_cache(B, torch.float32),
                            lambda t, s, r, n: te.tp_backend.slab_forward(te.params, t, s, r, 0, n))
    assert torch.equal(first1, firsts)
    with recording(monkeypatch, tmoe, lambda t: t.detach().numpy()) as want_ids:
        out1, _ = sampling.decode_chunk_batched(te1.cfg, te1.params, first1, slab1, pos, active, n_steps, **tkw)
    with recording(monkeypatch, tmoe, lambda t: t.detach().numpy()) as got_ids:
        tout, _ = te.tp_backend.batched_decode_chunk(te.params, firsts, tslab, pos, active, n_steps, **tkw)
    assert len(got_ids.ids) == len(want_ids.ids) > 0
    for g, w in zip(got_ids.ids, want_ids.ids):
        np.testing.assert_array_equal(g, w)
    assert got_ids.min_margin() > 1e-5
    jb = je._tp_engine
    jslab = jb.init_batch_cache(B, jnp.float32)
    for row, p in enumerate(prompts):
        _, jslab = jb.slab_forward(je.params, _padded(p), jslab, row, 0, len(p))
    jout, _ = jb.batched_decode_chunk(je.params, jnp.asarray(firsts.numpy(), jnp.int32), jslab,
                                      jnp.asarray(pos, jnp.int32), jnp.asarray(active), n_steps, *jkw)
    jt, _, _ = split_chunk_outputs(np.asarray(jout), n_steps)
    tt, _, _ = split_chunk_outputs(tout.numpy(), n_steps)
    assert np.array_equal(tt[:, :3], jt[:, :3])
    assert np.array_equal(tt[:, :3], split_chunk_outputs(out1.numpy(), n_steps)[0][:, :3])


def test_spec_and_spill_disabled_under_tp_with_the_jax_messages(engines, capsys):
    """``--spec-draft`` and the host spill arena are disabled under TP,
    each with the JAX package's warning, and the scheduler serves on."""
    je, te = engines("f32", 2)
    JaxScheduler(je, n_rows=2, chunk=4, prefix_cache=True, page_size=PAGE, spec_draft=3, host_spill_bytes=1 << 20)
    want = capsys.readouterr().out
    sched = BatchScheduler(te, n_rows=2, chunk=4, prefix_cache=True, page_size=PAGE, spec_draft=3,
                           spill_arena=HostArena(1 << 20))
    got = capsys.readouterr().out
    assert got == want and "speculative decode disabled" in got and "host-RAM spill disabled" in got
    assert sched.spec_draft == 0 and sched._prefix.spill is None
    assert decode_tokens(sched.new_stream(), PROMPTS[0], 0.0, 1, 4)


CHAOS = "batch.row:kind=nan,row=1,count=1;batch.dispatch:kind=raise,after=1,count=1"


def test_row_faults_retries_and_preemption_per_row_under_tp(engines):
    """Under TP a row fault retires its row alone (the survivor's stream is
    the unfaulted one), a failed dispatch is retried once, and a preemption
    evicts its row with RowPreempted, as on one rank."""
    _, te = engines("f32", 2)
    faults.install(faults.parse(CHAOS))
    sched = BatchScheduler(te, n_rows=2, chunk=4, retries=2, retry_backoff_s=0.0)
    streams = [sched.new_stream(), sched.new_stream()]
    out, errs = {}, {}

    def go(row):
        try:
            out[row] = decode_tokens(streams[row], PROMPTS[row], 0.0, 5, 8)
        except Exception as e:  # the retired row
            errs[row] = type(e).__name__

    threads = [threading.Thread(target=go, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    faults.clear()
    assert errs == {1: "RowQuarantined"} and sched.quarantined_total == 1 and sched.retries_total == 1
    assert out[0] == decode_tokens(BatchScheduler(te, n_rows=2, chunk=4).new_stream(), PROMPTS[0], 0.0, 5, 8)
    victim = streams[0]
    victim.reset()
    victim.priority = 0
    first = victim.prefill_device(PROMPTS[0], 0.0, 0.9, 5)
    assert sched.preempt_below(1) and sched.preempted_total == 1
    with pytest.raises(faults.RowPreempted):
        victim.stream_decode(first, lambda p, t: True, 0.0, 0.9, seed=5, limit=victim.pos + 4,
                             first_prev=PROMPTS[0][-1])


def test_tp_transfer_fires_and_the_engine_keeps_its_estimate(model_path):
    """``tp.transfer`` raises inside the probe: the engine builds with the
    estimate 0, a later refresh measures it, and a refresh that fails
    again keeps the measured value."""
    plan = faults.install(faults.parse("tp.transfer:kind=raise,count=1"))
    te = TorchEngine(model_path, dtype=torch.float32, device="cpu", tp=2)
    assert plan.injected_total == 1 and te._transfer_ms == 0.0
    te._tokens = te.TRANSFER_REFRESH_TOKENS
    te.refresh_transfer()
    measured = te._transfer_ms
    assert measured > 0
    plan.reset()  # arm it once more
    te._tokens += te.TRANSFER_REFRESH_TOKENS
    te.refresh_transfer()
    assert plan.injected_total == 2 and te._transfer_ms == measured
    te.reset()
    assert len(te.prefill(PROMPTS[0])) == SPEC["vocab_size"]  # requests are unaffected

