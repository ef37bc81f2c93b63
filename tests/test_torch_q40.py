"""The port's Q40 layer (ops/q40.py) held against the JAX package's.

Inputs are made from a numpy seed and fed to both packages. The JAX side
runs its Pallas kernels in interpret mode through ``_q40_matmul_int8`` /
``_q40_matmul_f32`` directly, after checking that its tile rule really
selects the kernel (n >= 1024 here: matrices with n_pad % 512 != 0 take
the XLA fallback instead). The port's wrappers compute their kernels' plain
PyTorch versions on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops import q40 as jq
from distributed_llama_tpu_torch.ops import q40 as tq
from distributed_llama_tpu.quants import quantize_q40


def _weights(n, d, seed=0):
    return (np.random.RandomState(seed).randn(n, d) / np.sqrt(n)).astype(np.float32)


def _pair(n, d, seed=0):
    w = _weights(n, d, seed)
    return jq.quantize_q40_tpu(w), tq.quantize_q40_tpu(w)


def _jax_tiles(jm, T):
    tiles = jq._resolve_tiles(jm, T, jq.BLOCK_N, jq.BLOCK_D)
    assert tiles is not None, "the JAX side would take its XLA fallback, not the kernel"
    return tiles


@pytest.mark.parametrize("n,d", [(1024, 1536), (608, 2500), (96, 64), (2048, 512)])
def test_pack_bytes_bit_exact(n, d):
    """Half-split nibbles, f32 scales and padding: byte for byte."""
    jm, tm = _pair(n, d)
    np.testing.assert_array_equal(tm.qs.numpy(), np.asarray(jm.qs))
    np.testing.assert_array_equal(tm.scales.numpy(), np.asarray(jm.scales))
    assert (tm.n, tm.d, tm.n_padded, tm.d_padded) == (jm.n, jm.d, jm.n_padded, jm.d_padded)


def test_pack_from_raw_file_bytes_bit_exact():
    """The loader's repack of raw `.m` blocks equals pack_q40_tpu's."""
    w = _weights(1536, 1024, seed=1)  # file orientation [d_out, d_in]
    qs, scales = quantize_q40(w)
    raw = np.empty((scales.size, 18), np.uint8)
    raw[:, :2] = scales.reshape(-1).view(np.uint8).reshape(-1, 2)
    raw[:, 2:] = qs.reshape(-1, 16)
    jm = jq.pack_q40_tpu(qs.reshape(-1, 16), scales.reshape(-1), w.shape)
    tm = tq.pack_q40_raw(raw.reshape(-1), w.shape)
    np.testing.assert_array_equal(tm.qs.numpy(), np.asarray(jm.qs))
    np.testing.assert_array_equal(tm.scales.numpy(), np.asarray(jm.scales))


def test_dequantize_bit_exact():
    jm, tm = _pair(1024, 1536, seed=2)
    np.testing.assert_array_equal(tq.dequantize_tpu(tm).numpy(), jq.dequantize_tpu(jm))


@pytest.mark.parametrize("T", [1, 5])
def test_quantize_q80_bit_exact(T):
    """int8 values and f32 scales: x / scale, round half to even, clip."""
    x = (np.random.RandomState(3).randn(T, 1024) * 3).astype(np.float32)
    x[0, :32] = 0.0  # an all-zero block takes the 1e-8 floor
    jxq, jsx = jq.quantize_q80(jnp.asarray(x))
    txq, tsx = tq.quantize_q80(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


# The int8 path's block dots are exact integers in both packages and the
# Q80 inputs are bit-identical (tested above); only the f32 epilogue sums
# associate differently, so the outputs agree to ~1e-6 of their magnitude.
# The f32 path sums f32 products in another order: the same bound holds.
_REL_TOL = 1e-5


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("path", ["int8", "f32"])
def test_matmul_matches_jax_kernel(T, path):
    jm, tm = _pair(1024, 1536, seed=4)
    x = np.random.RandomState(5).randn(T, 1024).astype(np.float32)
    jax_fn = jq._q40_matmul_int8 if path == "int8" else jq._q40_matmul_f32
    want = np.asarray(jax_fn(jnp.asarray(x), jm, *_jax_tiles(jm, T), True))
    got = tq.q40_matmul(torch.from_numpy(x), tm, path).numpy()
    assert got.shape == want.shape == (T, 1536)
    np.testing.assert_allclose(got, want, rtol=0, atol=_REL_TOL * np.abs(want).max())


def test_fused_rmsnorm_entry_matches_jax():
    jm, tm = _pair(1024, 2048, seed=6)
    rng = np.random.RandomState(7)
    x = rng.randn(3, 1024).astype(np.float32)
    wt = (1 + 0.1 * rng.randn(1024)).astype(np.float32)
    want = np.asarray(jq.rmsnorm_q40_matmul(jnp.asarray(x), jnp.asarray(wt), jm, interpret=True, path="int8"))
    got = tq.rmsnorm_q40_matmul(torch.from_numpy(x), torch.from_numpy(wt), tm).numpy()
    # rmsnorm's f32 mean/rsqrt may differ by an ulp between the packages,
    # and a bf16 rounding that flips moves one activation by a bf16 step:
    # allow 1e-3 of the output scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("path", ["int8", "f32"])
def test_fused_rmsnorm_entry_bit_identical_to_unfused(path):
    """Inside the port the fused entry IS the unfused chain: rmsnorm ->
    bf16 -> pad -> Q80 -> kernel, bit for bit."""
    _, tm = _pair(1024, 2048, seed=8)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(4, 1024).astype(np.float32))
    wt = torch.from_numpy((1 + 0.1 * rng.randn(1024)).astype(np.float32))
    fused = tq.rmsnorm_q40_matmul(x, wt, tm, path=path)
    unfused = tq.q40_matmul(tq.rmsnorm_ref(x, wt).to(torch.bfloat16), tm, path)
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("n,d", [(256, 96), (64, 96), (512, 100), (512, 256), (1024, 1024), (3008, 2000)])
def test_eligibility_rule_matches_jax(n, d):
    jm, tm = _pair(n, d, seed=10)
    assert tq.kernel_eligible(tm) == (jq._resolve_tiles(jm, 1, jq.BLOCK_N, jq.BLOCK_D) is not None)


@pytest.mark.parametrize("n,d", [(256, 96), (96, 40)])
def test_fallback_matches_jax(n, d):
    """Ineligible matrices: f32 dequantize-then-matmul, no Q80 step."""
    jm, tm = _pair(n, d, seed=11)
    assert not tq.kernel_eligible(tm)
    x = np.random.RandomState(12).randn(2, n).astype(np.float32)
    want = np.asarray(jq.q40_matmul(jnp.asarray(x), jm))
    before = dict(tq.launches)
    got = tq.q40_matmul(torch.from_numpy(x), tm, "int8").numpy()
    assert tq.launches == before
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_int8_block_sums_are_exact():
    """The plain int8 version's f32 block dots are exact integer sums:
    compare against an int64 numpy evaluation of the same epilogue."""
    rng = np.random.RandomState(13)
    T, n, d = 2, 1024, 256
    xq = rng.randint(-127, 128, size=(T, n)).astype(np.int8)
    sx = rng.rand(T, n // 32).astype(np.float32)
    qs = rng.randint(0, 256, size=(n // 2, d)).astype(np.uint8)
    sc = rng.rand(n // 32, d).astype(np.float32)
    got = tq.q40_int8_plain(*(torch.from_numpy(a) for a in (xq, sx, qs, sc))).numpy()
    nib = np.concatenate([qs & 0xF, qs >> 4]).astype(np.int64).reshape(n // 32, 32, d)
    P = np.einsum("tbi,bid->btd", xq.astype(np.int64).reshape(T, n // 32, 32), nib)
    want = (P * sc[:, None, :].astype(np.float64) * sx.T[:, :, None].astype(np.float64)).sum(0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_wrappers_reject_non_cpu_non_cuda_tensors():
    """A tensor that is not on the CPU never takes the plain version: a
    device other than CUDA raises instead of falling back."""
    T, n, d = 1, 1024, 128
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tq.q40_int8(torch.empty((T, n), dtype=torch.int8, **meta),
                    torch.empty((T, n // 32), **meta),
                    torch.empty((n // 2, d), dtype=torch.uint8, **meta),
                    torch.empty((n // 32, d), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        tq.q40_dequant(torch.empty((T, n), dtype=torch.bfloat16, **meta),
                       torch.empty((n // 2, d), dtype=torch.uint8, **meta),
                       torch.empty((n // 32, d), **meta))


def test_wrappers_check_dtype_and_shape():
    _, tm = _pair(1024, 256, seed=14)
    xq, sx = tq.quantize_q80(torch.zeros(1, 1024))
    with pytest.raises(TypeError):
        tq.q40_int8(xq.to(torch.int32), sx, tm.qs, tm.scales)
    with pytest.raises(ValueError):
        tq.q40_int8(xq, sx[:, :8], tm.qs, tm.scales)
    assert tq.launches == {"q40_int8": 0, "q40_dequant": 0}  # CPU calls launch nothing
