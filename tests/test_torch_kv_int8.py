"""The port's int8 KV cache held against the JAX package's.

``quantize_rows`` must give the same int8 values and scales bit for bit.
Every write of the same rows into an int8 cache and every copy of one (the
prefix-cache publish) then holds the JAX package's bytes, and the
reads agree within the tolerance of the bf16 weights: the attention output,
as a share of its largest magnitude, within 4e-4, the bound
tests/test_torch_attention.py gives a bf16 cache, since the softmax weights
(scaled by the slot's value scale) are rounded to bf16 before the value mix
and an ulp of exp can flip one such rounding. Inputs are made with numpy
from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.formats import synthetic as jsyn
from distributed_llama_tpu.models import config as jconfig
from distributed_llama_tpu.models import llama as jllama
from distributed_llama_tpu.ops import kv_cache as jkvc

from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import llama as tllama
from distributed_llama_tpu_torch.ops import attention as tattn
from distributed_llama_tpu_torch.ops import kv_cache as tkvc

SPEC = dict(dim=1024, hidden_dim=2048, n_layers=1, n_heads=8, n_kv_heads=4, vocab_size=512)
ATT_TOL = 4e-4  # of max |att|

# (cache seq_len, T, pos): the attention branch each takes
CASES = {
    "blocked_decode": (1024, 1, 700),
    "blocked_verify_window": (1024, 5, 509),
    "full_s_prefill": (1024, 12, 300),
    "full_s_small_cache": (256, 4, 100),
}


def _arrays(h) -> list:
    """Stored arrays of either package's int8 half, as numpy."""
    return [np.asarray(h.data), np.asarray(h.scales)]


def _assert_same_bytes(t, j) -> None:
    for got, want in zip(_arrays(t), _arrays(j), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_rows_bit_identical(scale):
    rng = np.random.RandomState(int(scale * 7) + 1)
    x = (rng.randn(6, 5, 4, 64) * rng.rand(6, 5, 4, 1) * scale).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero (row, head): the 1e-8 floor
    x[1, 2, 3, :3] = [127.5, -127.5, 0.5]  # values landing on rounding ties
    for arr in (x, x.astype(jnp.bfloat16)):
        jq, js = jkvc.quantize_rows(jnp.asarray(arr))
        tq, ts = tkvc.quantize_rows(torch.from_numpy(np.asarray(arr, np.float32)).to(
            torch.bfloat16 if arr.dtype != np.float32 else torch.float32))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (6, 5, 4, 1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", list(CASES))
def test_attention_teacher_forced_i8_matches_jax(monkeypatch, case):
    """One ``llama.attention`` layer over an int8 cache: both packages get
    the same q/k/v rows and the same quantized cache, whose slots past the
    query positions hold garbage the causal mask must hide."""
    S, T, pos = CASES[case]
    jcfg = jconfig.config_from_spec(jsyn.tiny_spec(**SPEC, seq_len=S))
    tcfg = tconfig.config_from_spec(tsyn.tiny_spec(**SPEC, seq_len=S))
    H, K, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_size
    rng = np.random.RandomState(S + T + pos)
    q = rng.randn(T, H, hd).astype(np.float32)
    k = rng.randn(T, K, hd).astype(np.float32)
    v = rng.randn(T, K, hd).astype(np.float32)
    cache = rng.randn(2, S, K, hd).astype(np.float32)

    monkeypatch.setattr(jllama, "project_qkv", lambda *a, **kw: tuple(map(jnp.asarray, (q, k, v))))
    monkeypatch.setattr(tllama, "project_qkv", lambda *a, **kw: tuple(map(torch.from_numpy, (q, k, v))))
    want, jcache = jllama.attention(
        jcfg, jnp.zeros((T, SPEC["dim"]), jnp.float32), {},
        jkvc.QuantizedKV(*jkvc.quantize_rows(jnp.asarray(cache))), jnp.int32(pos), None, None,
    )
    got, tcache = tllama.attention(
        tcfg, torch.zeros(T, SPEC["dim"]), {}, tkvc.QuantizedKV(*tkvc.quantize_rows(torch.from_numpy(cache))),
        pos, None,
    )
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape == (T, H * hd)
    _assert_same_bytes(tcache, jcache)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATT_TOL * np.abs(want).max())


def test_cache_builders_and_pool_bytes_match_jax():
    cfg_j = jconfig.config_from_spec(jsyn.tiny_spec(**SPEC, seq_len=256))
    cfg_t = tconfig.config_from_spec(tsyn.tiny_spec(**SPEC, seq_len=256))
    for page in (16, 64):
        assert tllama.page_pool_bytes(cfg_t, page, "i8") == jllama.page_pool_bytes(cfg_j, page, "i8")
        assert tllama.page_pool_bytes(cfg_t, page, torch.bfloat16) == jllama.page_pool_bytes(cfg_j, page,
                                                                                            jnp.bfloat16)
    built = [(tllama.init_cache(cfg_t, "i8", "cpu"), jllama.init_cache(cfg_j, dtype="i8", layered=True)),
             (tllama.init_batch_cache(cfg_t, 3, "i8", "cpu"), jllama.init_batch_cache(cfg_j, 3, dtype="i8")),
             ([h for pair in tllama.init_page_pool(cfg_t, 5, 16, "i8", "cpu") for h in pair],
              [h for pair in jllama.init_page_pool(cfg_j, 5, 16, dtype="i8") for h in pair])]
    for got, want in built:
        for t, j in zip(got, want, strict=True):
            for ta, ja in zip(_arrays(t), _arrays(j), strict=True):
                assert ta.shape == ja.shape and ta.dtype == ja.dtype and not ta.any()
    pool = tllama.init_page_pool(cfg_t, 5, 16, "i8", "cpu")
    assert sum(tkvc.half_bytes(h) for pair in pool for h in pair) == 5 * tllama.page_pool_bytes(cfg_t, 16, "i8")


def test_mixed_quantization_classes_raise():
    """K2 takes one cache kind: int8 slab halves with a float pool (or a
    float value half) raise ValueError before any launch, decode and
    verify alike, on the CPU too."""
    rng = np.random.RandomState(4)
    B, S, K, M, hd, P, page = 2, 1024, 2, 2, 16, 8, 64
    slab = rng.randn(2, B, S, K, hd).astype(np.float32)
    pool = rng.randn(2, P, page, K, hd).astype(np.float32)
    q8 = tkvc.QuantizedKV(*tkvc.quantize_rows(torch.from_numpy(slab)))
    p8 = tkvc.QuantizedKV(*tkvc.quantize_rows(torch.from_numpy(pool)))
    pf = torch.from_numpy(pool)
    tables, matched, pos = torch.zeros((B, S // page), dtype=torch.int32), torch.tensor([64, 0]), torch.tensor([70, 9])
    mixed = [
        (q8[0], q8[1], (pf[0], pf[1], tables, matched)),
        (q8[0], torch.from_numpy(slab[1]), None),
        (torch.from_numpy(slab[0]), torch.from_numpy(slab[1]), (p8[0], p8[1], tables, matched)),
    ]
    launches = dict(tattn.launches)
    for T in (1, 3):
        qg = torch.from_numpy(rng.randn(*((B, T, K, M, hd) if T > 1 else (B, K, M, hd))).astype(np.float32))
        fn = tattn.batched_verify_attention if T > 1 else tattn.batched_decode_attention
        for keys, values, paged in mixed:
            with pytest.raises(ValueError, match="mix int8 and float"):
                fn(qg, keys, values, pos, 512, paged=paged)
        fn(qg, q8[0], q8[1], pos, 512, paged=(p8[0], p8[1], tables, matched))  # one class: fine
    assert tattn.launches == launches


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("kv_int8") / "model.m"
    tsyn.write_synthetic_model(str(path), tsyn.tiny_spec(dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                                                         n_kv_heads=2, vocab_size=512, seq_len=1024), seed=1)
    return str(path)


@pytest.mark.parametrize("T", [1, 4])
def test_batched_step_and_verify_i8_match_jax(monkeypatch, model_path, T):
    """One batched decode step (T = 1) and one verify window (T = 4) over an
    int8 slab and pool, with paged rows, an inactive row and a bucket row,
    on identical contents: the logits agree within 1e-4 of their largest
    magnitude (the bf16 weight rounding of the attention, carried through
    two layers). The written K/V come from projections that differ by ulps
    between the packages, so a scale may move by an ulp and a value cross a
    rounding tie: scales agree within 1e-6 relative, int8 values within 1."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng = JaxEngine(model_path, dtype=jnp.float32)
    teng = TorchEngine(model_path, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(6 + T)
    B, P, PAGE = 4, 12, 64
    slab = [rng.randn(2, B, 1024, 2, 16).astype(np.float32) for _ in range(2)]
    pool = [[rng.randn(P, PAGE, 2, 16).astype(np.float32) for _ in range(2)] for _ in range(2)]
    tables = np.zeros((B, 1024 // PAGE), np.int32)
    tables[0, :9] = rng.permutation(P)[:9]
    tables[2, :2] = [3, 7]
    pos, active, matched = [600, 300, 130, 0], [True, False, True, False], [576, 0, 128, 0]
    tokens = rng.randint(0, 512, (B, T)).astype(np.int32)

    def jq(a):
        return jkvc.QuantizedKV(*jkvc.quantize_rows(jnp.asarray(a)))

    def tq(a):
        return tkvc.QuantizedKV(*tkvc.quantize_rows(torch.from_numpy(a)))

    jpaged = ([tuple(map(jq, p)) for p in pool], jnp.asarray(tables), jnp.asarray(matched, jnp.int32))
    tpaged = ([tuple(map(tq, p)) for p in pool], torch.from_numpy(tables), torch.tensor(matched))
    jargs = (jnp.asarray(pos, jnp.int32), jnp.asarray(active))
    if T == 1:
        jlogits, jcache = jllama.forward_step_batched(jeng.cfg, jeng.params, jnp.asarray(tokens[:, 0]),
                                                      [jq(s) for s in slab], *jargs, paged=jpaged)
        tlogits, tcache = tllama.forward_step_batched(teng.cfg, teng.params, torch.from_numpy(tokens[:, 0]).long(),
                                                      [tq(s) for s in slab], pos, active, paged=tpaged)
    else:
        jlogits, jcache = jllama.forward_verify_batched(jeng.cfg, jeng.params, jnp.asarray(tokens),
                                                        [jq(s) for s in slab], *jargs, paged=jpaged)
        tlogits, tcache = tllama.forward_verify_batched(teng.cfg, teng.params, torch.from_numpy(tokens).long(),
                                                        [tq(s) for s in slab], pos, active, paged=tpaged)
    want = np.asarray(jlogits)
    assert tlogits.shape == want.shape
    np.testing.assert_allclose(tlogits.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    for t, j in zip(tcache, jcache, strict=True):
        (td, ts), (jd, js) = _arrays(t), _arrays(j)
        assert np.abs(td.astype(np.int32) - jd.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
