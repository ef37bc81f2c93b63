"""Three repairs of the port, held on the CPU.

* K2 serves any number of queries per (row, kv head) and every head size
  that is a multiple of 16 up to 256: its plain version at T*M = 40 (K = 2,
  M = 8, T = 5) and hd 64 and 96 against the JAX package's fused kernel in
  interpret mode, within K2_TOL_REL (of max |out|: 1e-5 for an f32 cache,
  where only the order of f32 sums and an ulp of exp differ; 4e-4 for a
  bf16 cache, whose softmax weights are rounded to bf16, where an ulp of
  exp can flip one rounding). At hd 96 the comparison runs on an f32 cache
  only: the jitted JAX reference divides the scores by sqrt(96) as a
  multiply by its reciprocal, an ulp off the true division (the port's and
  the card's) for ~0.3% of scores, and on a bf16 cache such ulps flip
  weight roundings (7.5e-4 of max |out| on these inputs); at hd 64,
  sqrt(hd) = 8 and the two agree. Its two passes' plain functions compose
  to the plain scan bit for bit at those shapes; the wrapper raises
  ValueError for a head size it does not serve, before any launch.
* A batched verify window on the einsum attention (seq_len 1000, and a
  pool page of 40 positions, which does not divide 512) gives, bit for bit,
  the logits of the same tokens fed as batched decode steps, for bf16 and
  int8 caches: each window position attends as one decode step.
* ``_at_row_bucket`` runs its op on 64-row blocks only, whatever the row
  count, and every row equals its lone-row result bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops import attention as jattn

from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.models import llama
from distributed_llama_tpu_torch.ops import attention as tattn
from distributed_llama_tpu_torch.ops import kv_cache as tkvc
from distributed_llama_tpu_torch.ops import q40 as tq

K2_TOL_REL = {"f32": 1e-5, "bf16": 4e-4}  # as tests/test_torch_paged_attention.py and chip_smoke.py
K2_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
S, CHUNK, PAGE, P = 1024, 512, 64, 24

# ---------------------------------------------------------------------------
# K2 at 40 queries per (row, kv head), head sizes 64 and 96
# ---------------------------------------------------------------------------


def _k2_inputs(hd: int, seed: int):
    """bf16-exact f32 arrays: q [B, T, K, M, hd], slab and pool halves,
    tables, pos and matched for two rows, one read partly from the pool."""
    B, T, K, M = 2, 5, 2, 8
    rng = np.random.RandomState(seed)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()

    q = rng.randn(B, T, K, M, hd).astype(np.float32)
    slab = bf16(rng.randn(2, B, S, K, hd).astype(np.float32))
    pool = bf16(rng.randn(2, P, PAGE, K, hd).astype(np.float32))
    pos, matched = np.asarray([700, 1010], np.int32), np.asarray([576, 0], np.int32)
    tables = np.zeros((B, S // PAGE), np.int32)
    tables[0, :9] = rng.permutation(P)[:9]
    return q, slab, pool, tables, pos, matched


def _port_args(q, slab, pool, tables, pos, matched, dtype="bf16"):
    slab, pool = (torch.from_numpy(a).to(K2_DTYPES[dtype][1]) for a in (slab, pool))
    return (torch.from_numpy(q), slab[0], slab[1], torch.from_numpy(pos),
            (pool[0], pool[1], torch.from_numpy(tables), torch.from_numpy(matched)))


@pytest.mark.parametrize("hd,dtype", [(64, "bf16"), (64, "f32"), (96, "f32")])
def test_k2_plain_at_40_queries_matches_jax_fused_kernel(hd, dtype):
    arrays = _k2_inputs(hd, seed=hd)
    q, slab, pool, tables, pos, matched = arrays
    js, jp = (jnp.asarray(a).astype(K2_DTYPES[dtype][0]) for a in (slab, pool))
    want = np.asarray(jattn.fused_paged_verify_attention(
        jnp.asarray(q), js[0], js[1], jnp.asarray(pos), CHUNK,
        (jp[0], jp[1], jnp.asarray(tables), jnp.asarray(matched)), interpret=True))
    launches = dict(tattn.launches)
    tq_, tk, tv, tpos, tpaged = _port_args(*arrays, dtype)
    got = tattn.batched_verify_attention(tq_, tk, tv, tpos, CHUNK, paged=tpaged)
    assert tattn.launches == launches  # CPU tensors take the plain version
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=K2_TOL_REL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("hd", [64, 96])
def test_k2_two_pass_plain_at_40_queries_equals_scan(hd):
    tq_, tk, tv, tpos, tpaged = _port_args(*_k2_inputs(hd, seed=3 * hd))
    ws = tattn.paged_attention_partials_plain(tq_, tk, tv, tpos, CHUNK, tpaged)
    assert ws.shape == (2, 2, S // CHUNK, 40, hd + 2)
    got = tattn.paged_attention_fold_plain(ws, tq_.shape)
    assert torch.equal(got, tattn.paged_attention_plain(tq_, tk, tv, tpos, CHUNK, tpaged))


@pytest.mark.parametrize("hd", [72, 8, 272])
def test_k2_rejects_unserved_head_size(hd):
    qg = torch.zeros((1, 2, 1, hd))
    half = torch.zeros((1, S, 2, hd), dtype=torch.bfloat16)
    launches = dict(tattn.launches)
    with pytest.raises(ValueError, match="multiples of 16 from 16 to 256"):
        tattn.batched_decode_attention(qg, half, half, torch.zeros(1, dtype=torch.int64), CHUNK)
    with pytest.raises(ValueError, match="head size"):
        tattn.fused_paged_verify_attention(qg[:, None], half, half, torch.zeros(1, dtype=torch.int64), CHUNK)
    assert tattn.launches == launches


# ---------------------------------------------------------------------------
# The batched verify window on the einsum attention == batched decode steps
# ---------------------------------------------------------------------------

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_repairs")
    out = {}
    for seq_len in (1000, 1024):
        out[seq_len] = str(d / f"m{seq_len}.m")
        tsyn.write_synthetic_model(out[seq_len], tsyn.tiny_spec(**SPEC, seq_len=seq_len), seed=seq_len + 1)
    return out


def _half(a: np.ndarray, dtype):
    t = torch.from_numpy(a)
    return tkvc.QuantizedKV(*tkvc.quantize_rows(t)) if dtype == "i8" else t.to(dtype)


def _copy(leaf):
    if isinstance(leaf, tkvc.QuantizedKV):
        return tkvc.QuantizedKV(leaf.data.clone(), leaf.scales.clone())
    return leaf.clone()


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "i8"])
@pytest.mark.parametrize("seq_len", [1000, 1024])
def test_batched_verify_equals_decode_steps(models, seq_len, cache_dtype):
    """Rows with a prefix in 40-position pool pages, an inactive row, and a
    4-token window: seq_len 1000 takes the einsum attention, seq_len 1024
    (page 40 does not divide the 512-position chunk) K2's plain version
    over virtual rows. The verify forward's logits at window position t
    equal, bit for bit, those of a batched decode step at pos + t after the
    steps before it."""
    engine = TorchEngine(models[seq_len], dtype=torch.float32, device="cpu")
    cfg, params = engine.cfg, engine.params
    rng = np.random.RandomState(seq_len)
    B, T, page, n_pages = 4, 4, 40, 30
    Kh, hd = cfg.n_kv_heads, cfg.head_size
    slab = [_half(rng.randn(2, B, seq_len, Kh, hd).astype(np.float32), cache_dtype) for _ in range(cfg.n_layers)]
    pool = [tuple(_half(rng.randn(n_pages, page, Kh, hd).astype(np.float32), cache_dtype) for _ in range(2))
            for _ in range(cfg.n_layers)]
    n_table = -(-seq_len // page)
    tables = np.zeros((B, n_table), np.int32)
    tables[0, :14] = rng.permutation(n_pages)[:14]
    tables[2, :3] = [5, 9, 2]
    pos, active, matched = [600, 0, 130, 900], [True, False, True, True], [560, 0, 120, 0]
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T))).long()
    paged = (pool, torch.from_numpy(tables), torch.tensor(matched))

    window, _ = llama.forward_verify_batched(cfg, params, tokens, [_copy(x) for x in slab], pos, active, paged=paged)
    cache = [_copy(x) for x in slab]
    for t in range(T):
        step, cache = llama.forward_step_batched(cfg, params, tokens[:, t], cache, [p + t for p in pos], active,
                                                 paged=paged)
        for b in range(B):
            if active[b]:
                assert torch.equal(window[b, t], step[b]), f"row {b}, window position {t}"


# ---------------------------------------------------------------------------
# 64-row blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [63, 64, 80, 130])
def test_row_blocks_are_64_rows_and_rows_equal_alone(n):
    calls = []

    def spy(x):
        calls.append(tuple(x.shape))
        return x * 2.0

    x = torch.from_numpy(np.random.RandomState(n).randn(n, 48).astype(np.float32))
    assert torch.equal(tq._at_row_bucket(spy, x), x * 2.0)
    assert calls == [(tq.ROW_BUCKET, 48)] * -(-n // tq.ROW_BUCKET)
    b = torch.from_numpy(np.random.RandomState(1).randn(48, 96).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(2).rand(48).astype(np.float32))
    mm, norm = tq._true_f32_matmul(x, b), tq.rmsnorm_ref(x, w)
    assert mm.shape == (n, 96) and norm.shape == (n, 48)
    for i in range(n):
        assert torch.equal(mm[i : i + 1], tq._true_f32_matmul(x[i : i + 1], b))
        assert torch.equal(norm[i : i + 1], tq.rmsnorm_ref(x[i : i + 1], w))
