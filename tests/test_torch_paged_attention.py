"""K2's plain version (the port's segmented paged chunk scan) held against
the JAX package's fused paged-attention kernel, run in interpret mode as
its own tests run it, and against its XLA segmented scan
(``DLT_FUSED_PAGED=0``); plus the pool's publish/gather round trip.

Inputs are made with numpy from a seed: a slab of B_max = 4 rows (3 read),
S = 1024, a page pool of 64-position pages, per-row page tables, and
positions/matched lengths chosen so that the pool-only, mixed and
slab-only segments all occur. The int8 cache's halves are each package's
``quantize_rows`` of the same f32 inputs (bit-identical,
tests/test_torch_kv_int8.py). Tolerance, as a share of max |out|: 1e-6
for an f32 cache (products are exact in f32 in both packages; only the
order of f32 sums and an ulp of exp differ) and 4e-4 for a bf16 or int8
cache (the softmax weights, for int8 after the value scale folds in, are
rounded to bf16 before the value mix, and an ulp of exp can flip one such
rounding, as tests/test_torch_attention.py reads it).
The verify window is held only at tolerance: the JAX kernel's own verify
bit-parity test fails at this tree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops import attention as jattn
from distributed_llama_tpu.ops import kv_cache as jkvc

from distributed_llama_tpu_torch.ops import attention as tattn
from distributed_llama_tpu_torch.ops import kv_cache as tkvc

S, CHUNK, PAGE, B_MAX, K, M, HD, P = 1024, 512, 64, 4, 2, 2, 16, 20
TOL = {"f32": 1e-6, "bf16": 4e-4, "i8": 4e-4}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16), "i8": ("i8", "i8")}


def _jhalf(a: np.ndarray, dtype):
    """A JAX cache half (or leaf) holding f32 values ``a`` in ``dtype``."""
    if dtype == "i8":
        return jkvc.QuantizedKV(*jkvc.quantize_rows(jnp.asarray(a)))
    return jnp.asarray(a).astype(DTYPES[dtype][0])


def _thalf(a: np.ndarray, dtype):
    """The port's cache half (or leaf) holding f32 values ``a`` in ``dtype``."""
    if dtype == "i8":
        return tkvc.QuantizedKV(*tkvc.quantize_rows(torch.from_numpy(a)))
    return torch.from_numpy(a).to(DTYPES[dtype][1])


def _np(h) -> list:
    """The stored arrays of a half of either package (data and scales for
    int8), as numpy."""
    if isinstance(h, (jkvc.QuantizedKV, tkvc.QuantizedKV)):
        return _np(h.data) + _np(h.scales)
    if isinstance(h, torch.Tensor):
        return [h.numpy() if h.dtype in (torch.int8, torch.float32) else h.float().numpy()]
    return [np.asarray(h if h.dtype in (jnp.int8, jnp.float32) else h.astype(jnp.float32))]

# name -> (pos [B], matched [B], T): the segments each case visits
CASES = {
    "mixed_then_slab": ([700, 515, 1000], [0, 64, 128], 1),
    "pool_then_mixed": ([600, 900, 1010], [576, 512, 1000], 1),
    "no_hit": ([5, 530, 77], [0, 0, 0], 1),
    "verify_mixed_then_slab": ([700, 515, 1000], [0, 64, 128], 3),
    "verify_pool_then_mixed": ([598, 900, 1010], [576, 512, 1000], 3),
}


def _inputs(case, dtype):
    pos, matched, T = CASES[case]
    B = len(pos)
    rng = np.random.RandomState(len(case) + T)
    shape_q = (B, T, K, M, HD) if T > 1 else (B, K, M, HD)
    q = rng.randn(*shape_q).astype(np.float32)
    slab = rng.randn(2, B_MAX, S, K, HD).astype(np.float32)
    pool = rng.randn(2, P, PAGE, K, HD).astype(np.float32)
    if dtype == "bf16":  # values the bf16 cache holds exactly
        slab = torch.from_numpy(slab).to(torch.bfloat16).to(torch.float32).numpy()
        pool = torch.from_numpy(pool).to(torch.bfloat16).to(torch.float32).numpy()
    tables = np.zeros((B, S // PAGE), np.int32)
    for b, mt in enumerate(matched):
        n = -(-mt // PAGE)
        tables[b, :n] = rng.permutation(P)[:n]
    return q, slab, pool, tables, np.asarray(pos, np.int32), np.asarray(matched, np.int32)


def _jax(q, slab, pool, tables, pos, matched, dtype):
    slab, pool = _jhalf(slab, dtype), _jhalf(pool, dtype)
    return (jnp.asarray(q), slab[0], slab[1], jnp.asarray(pos),
            (pool[0], pool[1], jnp.asarray(tables), jnp.asarray(matched)))


def _torch(q, slab, pool, tables, pos, matched, dtype):
    slab, pool = _thalf(slab, dtype), _thalf(pool, dtype)
    return (torch.from_numpy(q), slab[0], slab[1], torch.from_numpy(pos),
            (pool[0], pool[1], torch.from_numpy(tables), torch.from_numpy(matched)))


# the JAX kernel in interpret mode takes ~9 s a case on the CPU: it is the
# reference for a few cases (one decode and one verify for int8), the XLA
# scan for all
FUSED_REF = {("mixed_then_slab", "f32"), ("pool_then_mixed", "bf16"), ("verify_pool_then_mixed", "f32"),
             ("pool_then_mixed", "i8"), ("verify_mixed_then_slab", "i8")}


def _port(arrays, dtype, verify):
    tq, tk, tv, tpos, tpaged = _torch(*arrays, dtype)
    tfn = tattn.batched_verify_attention if verify else tattn.batched_decode_attention
    launches = dict(tattn.launches)
    got = tfn(tq, tk, tv, tpos, CHUNK, paged=tpaged)
    assert tattn.launches == launches  # CPU tensors take the plain version, no kernel
    assert got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_scan_matches_jax_scan(monkeypatch, case, dtype):
    arrays = _inputs(case, dtype)
    verify = CASES[case][2] > 1
    jq, jk, jv, jpos, jpaged = _jax(*arrays, dtype)
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jscan = jattn.batched_verify_attention if verify else jattn.batched_decode_attention
    want = np.asarray(jscan(jq, jk, jv, jpos, CHUNK, paged=jpaged))
    got = _port(arrays, dtype, verify)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("case,dtype", sorted(FUSED_REF))
def test_plain_scan_matches_jax_fused_kernel(case, dtype):
    arrays = _inputs(case, dtype)
    verify = CASES[case][2] > 1
    jq, jk, jv, jpos, jpaged = _jax(*arrays, dtype)
    jfused = jattn.fused_paged_verify_attention if verify else jattn.fused_paged_decode_attention
    want = np.asarray(jfused(jq, jk, jv, jpos, CHUNK, jpaged, interpret=True))
    got = _port(arrays, dtype, verify)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unpaged_scan_matches_jax(monkeypatch, dtype):
    q, slab, pool, tables, pos, matched = _inputs("no_hit", dtype)
    jq, jk, jv, jpos, _ = _jax(q, slab, pool, tables, pos, matched, dtype)
    tq, tk, tv, tpos, _ = _torch(q, slab, pool, tables, pos, matched, dtype)
    want = np.asarray(jattn.batched_decode_attention(jq, jk, jv, jpos, CHUNK))
    got = tattn.batched_decode_attention(tq, tk, tv, tpos, CHUNK)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


def test_paged_segments_match_jax():
    for matched in ([0, 64, 128], [576, 512, 1000], [0, 0], [1024, 1024], [513]):
        for n in (1, 2):
            want = tuple(int(x) for x in jattn.paged_segments(jnp.asarray(matched), CHUNK, n))
            assert tattn.paged_segments(matched, CHUNK, n) == want


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_publish_and_paged_reads_match_jax(dtype):
    """publish_row_pages stores the row's exact bytes; gather, virtual row
    and the pool chunk read them back as the JAX package's do; out-of-range
    page ids write nothing."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    slab = rng.randn(2, S, K, HD).astype(np.float32)
    ids, src = [4, 2, 0, P], [0, 1, 2, 3]  # the last entry is padding: dropped
    jpool = jkvc.publish_row_pages(jkvc.init_page_pool_half(P, PAGE, K, HD, jdt), _jhalf(slab, dtype),
                                   jnp.int32(1), jnp.asarray(src, jnp.int32), jnp.asarray(ids, jnp.int32), PAGE)
    tpool = tkvc.publish_row_pages(tkvc.init_page_pool_half(P, PAGE, K, HD, tdt, "cpu"),
                                   _thalf(slab, dtype), 1, src, ids, PAGE)
    for got, want in zip(_np(tpool), _np(jpool), strict=True):
        np.testing.assert_array_equal(got, want)
    table = np.zeros(S // PAGE, np.int32)
    table[:3] = ids[:3]
    jrow = _jhalf(slab[0], dtype)
    trow = _thalf(slab[0], dtype)
    for matched in (0, 130, 192):
        want = jkvc.virtual_row(jrow, jpool, jnp.asarray(table), jnp.int32(matched))
        got = tkvc.virtual_row(trow, tpool, torch.from_numpy(table), matched)
        for g, w in zip(_np(got), _np(want), strict=True):
            np.testing.assert_array_equal(g, w)
    want = jkvc.pool_chunk_row(jpool, jnp.asarray(table), 0, CHUNK // PAGE)
    got = tkvc.pool_chunk_row(tpool, torch.from_numpy(table), 0, CHUNK // PAGE)
    for g, w in zip(_np(got), _np(want), strict=True):
        np.testing.assert_array_equal(g, w)



# K2 runs on the card as two passes: the chunk partials into a workspace,
# then their fold in chunk order. Their plain versions must compose to the
# plain scan bit for bit (the fold repeats the scan's merges in its order,
# and every chunk past the live bound is the empty partial, an exact
# identity), and so agree with the JAX kernel as the scan does.
TWO_PASS = [(case, dtype, True) for case in CASES for dtype in DTYPES] + [("no_hit", dtype, False) for dtype in DTYPES]


def _two_pass(arrays, dtype, paged: bool):
    tq, tk, tv, tpos, tpaged = _torch(*arrays, dtype)
    tpaged = tpaged if paged else None
    ws = tattn.paged_attention_partials_plain(tq, tk, tv, tpos, CHUNK, tpaged)
    return ws, tattn.paged_attention_fold_plain(ws, tq.shape), (tq, tk, tv, tpos, tpaged)


@pytest.mark.parametrize("case,dtype,paged", TWO_PASS)
def test_two_pass_plain_equals_plain_scan_bit_for_bit(case, dtype, paged):
    arrays = _inputs(case, dtype)
    ws, got, (tq, tk, tv, tpos, tpaged) = _two_pass(arrays, dtype, paged)
    pos, _matched, T = CASES[case]
    B, K_, M_ = len(pos), tq.shape[-3], tq.shape[-2]
    assert ws.shape == (B, K_, S // CHUNK, T * M_, HD + 2) and ws.dtype == torch.float32
    for b, p in enumerate(pos):  # chunks past the row's live bound: the empty partial
        for c in range(-(-(p + T) // CHUNK), S // CHUNK):
            assert torch.isneginf(ws[b, :, c, :, 0]).all() and not ws[b, :, c, :, 1:].any()
    want = tattn.paged_attention_plain(tq, tk, tv, tpos, CHUNK, tpaged)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,dtype", sorted(FUSED_REF))
def test_two_pass_plain_matches_jax_fused_kernel(case, dtype):
    arrays = _inputs(case, dtype)
    verify = CASES[case][2] > 1
    jq, jk, jv, jpos, jpaged = _jax(*arrays, dtype)
    jfused = jattn.fused_paged_verify_attention if verify else jattn.fused_paged_decode_attention
    want = np.asarray(jfused(jq, jk, jv, jpos, CHUNK, jpaged, interpret=True))
    _ws, got, _ = _two_pass(arrays, dtype, True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


def test_workspace_layout_round_trips():
    """A partial in the query layout survives the workspace layout (query
    index t*M + m) unchanged, decode and verify."""
    rng = np.random.RandomState(7)
    for shape in ((3, K, M), (3, 4, K, M)):
        m, l = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(2))
        o = torch.from_numpy(rng.randn(*shape, HD).astype(np.float32))
        verify = len(shape) == 4
        x = tattn._partial_to_ws(m, l, o, verify)
        assert x.shape == (3, K, shape[1] * M if verify else M, HD + 2)
        if verify:
            assert torch.equal(x[1, 0, 2 * M + 1], torch.cat((m[1, 2, 0, 1:2], l[1, 2, 0, 1:2], o[1, 2, 0, 1])))
        for got, want in zip(tattn._ws_to_partial(x, shape[1] if verify else 1, verify), (m, l, o), strict=True):
            assert torch.equal(got, want)
