"""Sequence parallelism (``--sp``) in the port held against the JAX package's
on the 8-device CPU mesh, which runs ``tests/test_context_parallel.py``'s
programs (its ring ``ppermute`` and pmax/psum merges inside ``shard_map``).

Inputs are made with numpy from seeds; the models are that file's: dim 64,
8 heads, 4 kv heads, hidden 128, vocab 96, seq_len 32 with f32 weights
(seed 2), and dim 128, hidden 256, vocab 128 with Q40 weights (seed 4) for
the ``tp x sp`` layout. Tolerances, each stated where it is used:

* attention: 2e-5 absolute and relative, the JAX tests' bound, against the
  JAX functions and against f64 full causal attention;
* f32 engines: logits within 1e-4 of max |logit| of the JAX SP engine's
  (the TP tests' f32 bound; the readings are ~1e-6), greedy streams equal
  token for token; q40: streams equal, logits within 2.5e-2 of max |logit|
  (the repo's cross-package q40 tolerance);
* the int8 cache: every rank's int8 rows and scales byte-equal to the JAX
  engine's addressable shards, with both packages' K/V projections
  replaced by the same exact function of the rope rows (the packages' f32
  matmuls round differently in the last ulp, which moves scales), so the
  placement, masking, padding and quantization of every write are held
  exactly. The JAX engine's compiled program multiplies by the f32
  reciprocal of 127 where ``quantize_rows`` divides by 127 (XLA's rewrite
  of a division by a constant), one ulp apart where the two roundings
  part; the port divides, as the formula is written and as every other
  port test holds it, so the byte comparison installs the JAX formula with
  its divisor behind an optimization barrier, and
  ``test_jax_engines_scale_by_the_reciprocal`` holds the rewrite itself.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh, PartitionSpec as P

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.models import llama as jllama
from distributed_llama_tpu.ops import kv_cache as jkvc
from distributed_llama_tpu.parallel import context_parallel as jcp
from distributed_llama_tpu.parallel.tensor_parallel import shard_map
from distributed_llama_tpu.server.api import ApiState as JaxApiState
from distributed_llama_tpu.tokenizer import Sampler as JaxSampler
from distributed_llama_tpu.tokenizer import Tokenizer as JaxTokenizer

from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.models import llama as tllama
from distributed_llama_tpu_torch.ops import attention as tattn
from distributed_llama_tpu_torch.ops import kv_cache as tkvc
from distributed_llama_tpu_torch.parallel import context_parallel as tcp
from distributed_llama_tpu_torch.quants import FloatType
from distributed_llama_tpu_torch.server import api as tapi
from tests.torch_probe_telemetry import assert_probe_telemetry_matches_jax
from distributed_llama_tpu_torch.tokenizer import Sampler as TorchSampler
from distributed_llama_tpu_torch.tokenizer import Tokenizer as TorchTokenizer

from tests.test_context_parallel import full_causal_attention

SPEC = dict(dim=64, n_heads=8, n_kv_heads=4, hidden_dim=128, vocab_size=96, seq_len=32)
Q40_SPEC = dict(dim=128, n_heads=8, n_kv_heads=4, hidden_dim=256, vocab_size=128, seq_len=32)
ATT_TOL = 2e-5
F32_TOL = 1e-4  # of max |logit|
Q40_TOL = 2.5e-2  # of max |logit|
LONG = [1, 5, 9, 13, 2, 7, 30, 63]  # 8 * 4 >= seq_len 32: the ring pass
SHORT = [1, 5, 9, 13, 2]  # the chunked path
_DTYPES = {"f32": (jnp.float32, torch.float32), "q40": ("q40", "q40")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sp")
    out = {}
    for name, spec, seed, ft in (("f32", SPEC, 2, FloatType.F32), ("q40", Q40_SPEC, 4, FloatType.Q40),
                                 ("long", dict(SPEC, seq_len=4096), 6, FloatType.F32)):
        out[name] = str(d / f"{name}.m")
        tsyn.write_synthetic_model(out[name], tsyn.tiny_spec(**spec, weights_float_type=ft), seed=seed)
    return out


@pytest.fixture(scope="module")
def engines(files):
    """(JAX engine, port engine) per (model, sp, tp, cache dtype), built once;
    the port's tp ranks sum with K4's arm (its plain version on the CPU)."""
    made = {}

    def get(model, sp, tp=1, cache=None):
        key = (model, sp, tp, cache)
        if key not in made:
            jdt, tdt = _DTYPES["q40" if model == "q40" else "f32"]
            made[key] = (JaxEngine(files[model], dtype=jdt, sp=sp, tp=tp, cache_dtype=cache),
                         TorchEngine(files[model], dtype=tdt, device="cpu", sp=sp, tp=tp, cache_dtype=cache,
                                     allreduce="ring"))
        return made[key]

    return get


def _mesh(n):
    return Mesh(mesh_utils.create_device_mesh((n,), devices=jax.devices()[:n]), ("sp",))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n,heads,kv_heads", [(4, 4, 4), (8, 8, 2), (2, 4, 2), (1, 2, 2)])
def test_ring_attention_matches_jax_and_f64(n, heads, kv_heads):
    S, hd = 32, 8
    rng = np.random.RandomState(n)
    q = rng.randn(S, heads, hd).astype(np.float32)
    k = rng.randn(S, kv_heads, hd).astype(np.float32)
    v = rng.randn(S, kv_heads, hd).astype(np.float32)
    fn = shard_map(functools.partial(jcp.ring_attention, axis_name="sp"), mesh=_mesh(n),
                   in_specs=(P("sp"), P("sp"), P("sp")), out_specs=P("sp"), check_vma=False)
    want = np.asarray(jax.jit(fn)(q, k, v))
    cut = [np.split(a, n) for a in (q, k, v)]
    got = np.concatenate([o.numpy() for o in tcp.ring_attention(*[[torch.from_numpy(c) for c in a] for a in cut])])
    np.testing.assert_allclose(got, want, rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose(got, full_causal_attention(q, k, v), rtol=ATT_TOL, atol=ATT_TOL)


def test_empty_partials_merge_as_an_exact_identity():
    """A chunk wholly in a rank's future gives m = -inf, l = 0, o = 0: two
    such partials merge to an empty partial (no NaN), and one merged with a
    live partial passes its bits through unchanged."""
    rng = np.random.RandomState(0)
    qg = torch.from_numpy(rng.randn(3, 2, 2, 8).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(4, 2, 8).astype(np.float32)) for _ in range(2))
    empty = tattn.chunk_attention(qg, k, v, torch.arange(3), 10 + torch.arange(4))
    assert torch.isneginf(empty[0]).all() and not empty[1].any() and not empty[2].any()
    m, l, o = tattn.merge_partials(*empty, *empty)
    assert torch.isneginf(m).all() and not l.isnan().any() and not o.isnan().any() and not l.any()
    live = tattn.chunk_attention(qg, k, v, 5 + torch.arange(3), torch.arange(4))
    for merged in (tattn.merge_partials(*live, *empty), tattn.merge_partials(*empty, *live)):
        assert all(torch.equal(a, b) for a, b in zip(merged, live))


def _jax_sharded(q, k, v, q_pos, n):
    fn = shard_map(functools.partial(jcp.sp_sharded_attention, axis_name="sp"), mesh=_mesh(n),
                   in_specs=(P(), P("sp"), P("sp"), P()), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(fn)(q, k, v, jnp.asarray(q_pos, jnp.int32)))


def _f64_rows(q, k, v, pos):
    """f64 attention of query rows q [T, H, hd] at pos..pos+T-1 over slots
    0..pos+t of k, v [S, K, hd]."""
    T, H, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(T, K, H // K, hd).astype(np.float64)
    scores = np.einsum("tkmh,skh->tkms", qg, k.astype(np.float64)) / np.sqrt(hd)
    mask = np.arange(k.shape[0])[None, :] <= (pos + np.arange(T))[:, None]
    scores = np.where(mask[:, None, None, :], scores, -np.inf)
    w = np.exp(scores - scores.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    return np.einsum("tkms,skh->tkmh", w, v.astype(np.float64)).reshape(T, H, hd)


@pytest.mark.parametrize("S,T,pos", [(32, 1, 0), (32, 1, 5), (32, 1, 30), (32, 1, 31), (32, 4, 9),
                                     (4096, 1, 2500), (4096, 32, 1000), (4096, 32, 4070)])
def test_sharded_attention_matches_jax_and_f64(S, T, pos):
    """sp = 4: slices of 8 slots take one masked pass, slices of 1024 (S =
    4096) the blocked scan with its dynamic bound (SP_ATT_CHUNK = 512) and
    the clamped max of ranks with no live slot; T = 1 is
    ``sp_decode_attention``, T > 1 the chunk path's rows (pos 4070: the
    rows past seq_len of a padded chunk)."""
    n, H, K, hd = 4, 4, 2, 8
    rng = np.random.RandomState(S + pos)
    k = rng.randn(S, K, hd).astype(np.float32)
    v = rng.randn(S, K, hd).astype(np.float32)
    q = rng.randn(T, H, hd).astype(np.float32)
    want = _jax_sharded(q, k, v, pos + np.arange(T), n)
    ks, vs = (list(torch.from_numpy(a).chunk(n)) for a in (k, v))
    if T == 1:
        got = tcp.sp_decode_attention(torch.from_numpy(q[0]), ks, vs, pos)[None].numpy()
    else:
        got = tcp.sp_sharded_attention(torch.from_numpy(q), ks, vs, pos).numpy()
    np.testing.assert_allclose(got, want, rtol=ATT_TOL, atol=ATT_TOL)
    live = min(T, S - pos)  # rows past seq_len attend every slot
    np.testing.assert_allclose(got[:live], _f64_rows(q, k, v, pos)[:live], rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("prompt,dispatches", [(LONG, 1), (SHORT, 1), (list(range(1, 8)) * 2, 1)])
def test_prefill_ring_and_chunked_match_jax(engines, sp, prompt, dispatches):
    """The ring pass (a prompt of seq_len/4 or more at position 0) and the
    chunked path (shorter prompts) against the JAX SP engine, with the
    JAX backend's dispatch count."""
    je, te = engines("f32", sp)
    je.reset()
    te.reset()
    want = je.prefill(prompt)
    got = te.prefill(prompt)
    assert te.tp_backend.last_forward_dispatches == je._tp_engine.last_forward_dispatches == dispatches
    _close(got, want)


def test_mid_context_prefill_multi_chunk_matches_jax(engines):
    """A 7-token delta at position 3 in 4-token chunks: 2 dispatches, the
    logits of every row, then a greedy stream off the updated cache equal
    to the JAX engine's; the stats entry pays the transfer share twice."""
    delta = [4, 5, 6, 7, 8, 9, 10]
    je, te = engines("f32", 4)
    out = []
    for engine, backend in ((je, je._tp_engine), (te, te.tp_backend)):
        backend.mid_prefill_chunk = 4
        engine.reset()
        engine.prefill([1, 2, 3])
        logits = engine.forward(delta)
        assert backend.last_forward_dispatches == 2 and engine.pos == 10
        out.append((logits, engine.generate_on_device(11, 6, temperature=0.0).tolist()))
        backend.mid_prefill_chunk = 32
    _close(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]
    entry = te.stats[-7]
    assert entry.n_tokens == 7 and entry.transfer_ms == pytest.approx(min(2 * te._transfer_ms, entry.generation_ms))


def test_mid_context_prefill_at_the_context_limit(engines):
    """A delta whose padded chunk crosses seq_len: the pad rows past the
    context drop, the real rows keep their own rope rows."""
    head = list(range(1, 29))
    je, te = engines("f32", 4)
    out = []
    for engine, backend in ((je, je._tp_engine), (te, te.tp_backend)):
        backend.mid_prefill_chunk = 8
        engine.reset()
        engine.prefill(head)
        out.append(engine.forward([30, 31, 32]))
        assert engine.pos == 31
        backend.mid_prefill_chunk = 32
    _close(out[1], out[0])


@pytest.mark.parametrize("model,sp,tp", [("f32", 2, 1), ("f32", 4, 1), ("f32", 2, 2), ("q40", 2, 2), ("q40", 4, 1)])
def test_greedy_streams_match_jax(engines, model, sp, tp):
    """Prefill, then 8 greedy tokens in one ``generate_on_device`` equal to
    the JAX SP engine's token for token; at sp 2 also in decode chunks of
    3 (each chunk size is one more JAX program to compile)."""
    je, te = engines(model, sp, tp)
    runs = []
    for engine in (je, te):
        engine.reset()
        logits = engine.prefill([1, 5, 9])
        first = int(np.argmax(logits))
        loop = [int(t) for t in engine.generate_on_device(first, 8, temperature=0.0)]
        chunks = None
        if (model, sp, tp) == ("f32", 2, 1):
            engine.reset()
            engine.prefill([1, 5, 9])
            chunks = list(engine.generate_chunks(first, temperature=0.0, chunk=3, limit=12))
        runs.append((logits, loop, chunks))
    _close(runs[1][0], runs[0][0], Q40_TOL if model == "q40" else F32_TOL)
    assert runs[1][1] == runs[0][1] and runs[1][2] == runs[0][2] and len(runs[0][1]) == 8


@pytest.mark.parametrize("sp,tp", [(4, 1), (2, 2)])
def test_cache_slices_are_sequence_cut(engines, sp, tp):
    """Each rank's slice holds [S/sp, K/tp, hd]: the JAX engine's shard
    shapes."""
    je, te = engines("f32", sp, tp)
    jshapes = {s.data.shape for layer in je.cache for half in layer for s in half.addressable_shards}
    caches = te.default_stream.cache
    assert len(caches) == tp and all(len(c) == sp for c in caches)
    tshapes = {tuple(leaf.shape[1:]) for c in caches for rank in c for leaf in rank}
    assert tshapes == jshapes == {(32 // sp, 4 // tp, 8)}


def _fake_kv(k, rope_rows, xp):
    """K and V rows from the rope rows alone: [T, K_local, hd] each, the
    rows times powers of two per head, exact in f32 whatever order a
    compiler multiplies them in."""
    T, K, hd = k.shape
    r = xp.reshape(rope_rows, (T, 1, hd))
    heads = xp.reshape(2.0 ** xp.arange(K, dtype=xp.float32), (1, K, 1))
    return r * heads * 4.0, r * heads * -0.5


def _jax_quantize_as_written(x):
    """The JAX package's ``quantize_rows`` with its divisor behind an
    optimization barrier, so that a compiled program divides by 127 as the
    formula is written."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scales = jnp.maximum(amax, 1e-8) / jax.lax.optimization_barrier(jnp.full_like(amax, 127.0))
    return jnp.clip(jnp.round(xf / scales), -127, 127).astype(jnp.int8), scales


def test_jax_engines_scale_by_the_reciprocal():
    """Compiled, the JAX package's ``quantize_rows`` multiplies by the f32
    reciprocal of 127 (XLA's rewrite of a division by a constant); eager,
    and in the port, it divides. The two part by one ulp where their
    roundings part (amax 3.999968 here); with the divisor behind an
    optimization barrier the compiled formula divides again."""
    x = np.zeros((1, 1, 8), np.float32)
    x[0, 0, 0] = np.float32(3.999968)
    eager = np.asarray(jkvc.quantize_rows(jnp.asarray(x))[1]).view(np.uint32)
    compiled = np.asarray(jax.jit(jkvc.quantize_rows)(jnp.asarray(x))[1]).view(np.uint32)
    barrier = np.asarray(jax.jit(_jax_quantize_as_written)(jnp.asarray(x))[1]).view(np.uint32)
    port = tkvc.quantize_rows(torch.from_numpy(x))[1].numpy().view(np.uint32)
    assert compiled.item() == eager.item() - 1
    assert port.item() == eager.item() == barrier.item()


@pytest.mark.parametrize("sp,tp", [(4, 1), (2, 2)])
def test_i8_cache_bytes_equal_jax_shards(monkeypatch, files, sp, tp):
    """The int8 cache after a ring pass, a 2-chunk delta and 3 decode steps,
    and after a delta at the context limit: every rank's int8 rows and
    scales equal the JAX engine's addressable shards byte for byte (both
    packages' K/V rows from the rope rows, as ``_fake_kv``; the JAX
    quantization as written, ``_jax_quantize_as_written``), and its logits
    stay within the f32 tolerance of the JAX engine's."""
    monkeypatch.setattr(jkvc, "quantize_rows", _jax_quantize_as_written)
    jorig, torig = jllama.project_qkv, tllama.project_qkv

    def jfake(cfg, lp, x, rope_rows):
        q, k, _ = jorig(cfg, lp, x, rope_rows)
        return (q, *_fake_kv(k, rope_rows, jnp))

    def tfake(cfg, lp, x, rope_rows, path="int8"):
        q, k, _ = torig(cfg, lp, x, rope_rows, path)
        return (q, *_fake_kv(k, rope_rows, torch))

    monkeypatch.setattr(jllama, "project_qkv", jfake)
    monkeypatch.setattr(tllama, "project_qkv", tfake)
    je = JaxEngine(files["f32"], dtype=jnp.float32, sp=sp, tp=tp, cache_dtype="i8")
    te = TorchEngine(files["f32"], dtype=torch.float32, device="cpu", sp=sp, tp=tp, cache_dtype="i8")
    for engine, backend in ((je, je._tp_engine), (te, te.tp_backend)):
        backend.mid_prefill_chunk = 4
    Sl, Kl = 32 // sp, 4 // tp

    def same_bytes():
        for l, layer in enumerate(je.cache):
            for h, half in enumerate(layer):
                for sd, ss in zip(half.data.addressable_shards, half.scales.addressable_shards):
                    i, t = (sd.index[0].start or 0) // Sl, (sd.index[1].start or 0) // Kl
                    leaf = te.default_stream.cache[t][i][l]
                    assert leaf.data.dtype == torch.int8
                    np.testing.assert_array_equal(leaf.data[h].numpy(), np.asarray(sd.data))
                    np.testing.assert_array_equal(leaf.scales[h].numpy(), np.asarray(ss.data))

    logits = [[], []]
    for n, engine in enumerate((je, te)):
        logits[n].append(engine.prefill(LONG))
        logits[n].append(engine.forward([4, 5, 6, 7, 8]))
        for tok in (3, 9, 27):
            logits[n].append(engine.decode_step(tok))
    same_bytes()
    for n, engine in enumerate((je, te)):
        engine.reset()
        engine.prefill(list(range(1, 29)))
        logits[n].append(engine.forward([30, 31, 32]))
    same_bytes()
    for got, want in zip(*reversed(logits)):
        _close(got, want)


def test_blocked_slices_engine_matches_jax(engines):
    """seq_len 4096 at sp = 4: 1024-slot slices scan in 512-slot chunks up
    to the live position; a 40-token prompt (2 chunks) and a decode step
    against the JAX engine, whose slices take the same blocked scan."""
    je, te = engines("long", 4)
    prompt = list(np.random.RandomState(3).randint(1, 96, 40))
    got, want = [], []
    for engine, out in ((je, want), (te, got)):
        engine.reset()
        out.append(engine.prefill(prompt))
        out.append(engine.decode_step(7))
    assert te.tp_backend.last_forward_dispatches == 1  # the decode step
    for g, w in zip(got, want):
        _close(g, w)


def test_transfer_probe_and_bytes_match_jax(engines):
    """The transfer probe's replay runs and is timed; the bytes it stands
    for per token equal the JAX backend's count, at sp 4 and tp 2 x sp 2."""
    for sp, tp in ((4, 1), (2, 2)):
        je, te = engines("f32", sp, tp)
        assert te.tp_backend.transfer_bytes_per_token() == je._tp_engine.transfer_bytes_per_token()
        assert te._transfer_ms > 0 and te.tp_backend.measure_transfer_ms(n_tokens=2) > 0
        assert te.tp_backend.mesh_shape == {"tp": tp, "sp": sp}


def test_transfer_probe_telemetry_matches_jax(engines):
    """The SP backend's probe (the mixin the TP and EP backends share) is a
    ``transfer_probe`` span and feeds the three families as JAX's does."""
    je, te = engines("f32", 4, 1)
    assert_probe_telemetry_matches_jax(je._tp_engine, te.tp_backend)


def test_cli_generate_sp_prints_what_sp1_prints(tmp_path, capsys):
    """The CLI over the f32 model widened to the synthetic tokenizer's vocab
    (512): ``--tp 2 --sp 2`` prints what ``--sp 1`` prints, greedy, on the
    CPU."""
    model, tok = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    tsyn.write_synthetic_model(model, tsyn.tiny_spec(**dict(SPEC, vocab_size=512)), seed=2)
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=512))
    base = ["generate", "--model", model, "--tokenizer", tok, "--prompt", "hello world", "--steps", "20",
            "--device", "cpu", "--temperature", "0", "--seed", "3", "--decode-chunk", "4", "--dtype", "f32"]
    runs, texts = [], []
    for extra in ([], ["--tp", "2", "--sp", "2", "--allreduce", "ring"]):
        runs.append(tcli.main(base + extra))
        texts.append(capsys.readouterr().out.split("Generated tokens:")[0])
    assert runs[0]["tokens"] == runs[1]["tokens"] and len(runs[0]["tokens"]) > 4
    assert texts[0] == texts[1]


def test_server_serves_independent_lanes_as_jax_does(tmp_path, capsys):
    """``--sp 2 --parallel 2``: both servers print the batch-decode refusal
    and serve independent streams; the port's greedy completions, finish
    reasons and usage equal the JAX server's. ``--replicas 2`` is reduced
    to one replica with the JAX warning."""
    from tests.test_torch_server import ARGS, SPEC as SERVER_SPEC, conversation

    model, tok = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    tsyn.write_synthetic_model(model, tsyn.tiny_spec(**SERVER_SPEC), seed=2)
    data = tsyn.synthetic_tokenizer_data(vocab_size=SERVER_SPEC["vocab_size"])
    data.chat_template = "{% for m in messages %}<|im_start|>{{m.role}}...{% endfor %}"
    with open(tok, "wb") as f:
        write_tokenizer_file(f, data)
    vocab = SERVER_SPEC["vocab_size"]
    jstate = JaxApiState(JaxEngine(model, dtype=jnp.float32, sp=2), JaxTokenizer.from_file(tok),
                         JaxSampler(vocab_size=vocab, temperature=0.0, topp=0.9, seed=1),
                         types.SimpleNamespace(**ARGS))
    want = conversation(jstate)
    assert "⚠️ batch decode disabled" in capsys.readouterr().out

    def engine():
        return TorchEngine(model, dtype=torch.float32, device="cpu", sp=2)

    state = tapi.ApiState(engine(), TorchTokenizer.from_file(tok),
                          TorchSampler(vocab_size=vocab, temperature=0.0, topp=0.9, seed=1),
                          types.SimpleNamespace(**ARGS, replicas=2), engine_factory=engine)
    out = capsys.readouterr().out
    assert "⚠️ batch decode disabled: batched decode is supported on the single-chip and tp backends only" in out
    assert "⚠️ replicas reduced to 1: batch decode unavailable" in out
    assert state.batch is None and len(state.pool.replicas) == 1 and len(state.slots) == 2
    assert conversation(state) == want
