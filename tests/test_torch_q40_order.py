"""K1's ordered plain version (``ops/q40.py q40_int8_ordered_plain``): the
f32 order both of K1's tiles on the card follow bit for bit, held on the CPU.

* Against ``q40_int8_plain`` (the CPU path's plain version, which sums the
  blocks in another order) within TOL_REL["q40_int8"] = 1e-5 of the output
  scale, as chip_smoke.py holds the kernel against it.
* Against a numpy float32 simulation of the same order (slice b % 16,
  blocks in increasing b, low half then high half, every product and sum
  rounded on its own, the 16 partials added in slice order): bit for bit.
* Row for row: each row of a T-row call equals a T = 1 call of that row,
  bit for bit, the property that lets a verify window equal decode.
* Through ``_int8_core`` (kernel + bias correction) against the JAX
  package's ``_int8_core``, its Pallas kernel in interpret mode as
  tests/test_torch_q40.py runs it, within 1e-5 of the output scale.

Inputs come from numpy seeds; n covers block counts per half that are a
multiple of 16, one that is not, and one below 16 (empty slices).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops import q40 as jq
from distributed_llama_tpu_torch.ops import q40 as tq

TOL_REL = 1e-5  # chip_smoke.py TOL_REL["q40_int8"]: only the f32 epilogue's order differs


def _operands(T: int, n_pad: int, d: int, seed: int):
    """Random Q80 activations and a Q40 pack in the kernel's layout."""
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, size=(T, n_pad)).astype(np.int8)
    sx = (rng.rand(T, n_pad // 32) / 50).astype(np.float32)
    qs = rng.randint(0, 256, size=(n_pad // 2, d)).astype(np.uint8)
    sc = (rng.rand(n_pad // 32, d) / 60).astype(np.float32)
    return xq, sx, qs, sc


def _numpy_ordered(xq, sx, qs, sc) -> np.ndarray:
    """The ordered epilogue in numpy float32, one block at a time."""
    T, n_pad = xq.shape
    half, nb = n_pad // 2, n_pad // 64
    nib = (qs & 0xF, qs >> 4)
    f32 = np.float32
    out = np.zeros((T, qs.shape[1]), f32)
    for s in range(16):
        acc = np.zeros_like(out)
        for b in range(s, nb, 16):
            for h in range(2):
                x = xq[:, h * half + b * 32 : h * half + b * 32 + 32].astype(np.int64)
                dot = (x @ nib[h][b * 32 : b * 32 + 32].astype(np.int64)).astype(f32)  # exact: |dot| < 2**24
                term = (dot * sc[h * nb + b][None, :]).astype(f32) * sx[:, h * nb + b][:, None]
                acc = (acc + term.astype(f32)).astype(f32)
        out = (out + acc).astype(f32)
    return out


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("T,n_pad,d", [(1, 1024, 256), (5, 1536, 192), (20, 512, 128), (3, 4608, 64)])
def test_ordered_plain_matches_plain(T, n_pad, d):
    ops = _t(*_operands(T, n_pad, d, seed=T + n_pad))
    got = tq.q40_int8_ordered_plain(*ops)
    want = tq.q40_int8_plain(*ops)
    assert got.shape == want.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL_REL * want.abs().max().item())


@pytest.mark.parametrize("T,n_pad,d", [(2, 1024, 96), (4, 1536, 64), (1, 512, 128), (3, 2112, 64)])
def test_ordered_plain_equals_numpy_order_bit_for_bit(T, n_pad, d):
    arrays = _operands(T, n_pad, d, seed=100 + T)
    got = tq.q40_int8_ordered_plain(*_t(*arrays)).numpy()
    np.testing.assert_array_equal(got, _numpy_ordered(*arrays))


@pytest.mark.parametrize("T", [5, 20, 64, 80])
def test_rows_equal_their_lone_row_call(T):
    xq, sx, qs, sc = _t(*_operands(T, 1536, 128, seed=7))
    whole = tq.q40_int8_ordered_plain(xq, sx, qs, sc)
    alone = torch.cat([tq.q40_int8_ordered_plain(xq[t : t + 1], sx[t : t + 1], qs, sc) for t in range(T)])
    assert torch.equal(whole, alone)


@pytest.mark.parametrize("kernel", ["plain", "ordered"])
@pytest.mark.parametrize("T", [1, 5, 20])
def test_int8_core_matches_jax(monkeypatch, kernel, T):
    """The port's kernel + bias epilogue, its kernel's plain version being
    the CPU path's or the ordered one, against the JAX package's on the
    same Q80 activations (bit-identical in both packages)."""
    w = (np.random.RandomState(T).randn(1024, 1536) / 32).astype(np.float32)
    jm, tm = jq.quantize_q40_tpu(w), tq.quantize_q40_tpu(w)
    x = np.random.RandomState(50 + T).randn(T, 1024).astype(np.float32)
    jxq, jsx = jq.quantize_q80(jnp.asarray(x))
    tiles = jq._resolve_tiles(jm, T, jq.BLOCK_N, jq.BLOCK_D)
    assert tiles is not None, "the JAX side would take its XLA fallback, not the kernel"
    want = np.asarray(jq._int8_core(jxq, jsx, jm, *tiles, True))
    if kernel == "ordered":
        monkeypatch.setattr(tq, "q40_int8", tq.q40_int8_ordered_plain)
    got = tq._int8_core(*tq.quantize_q80(torch.from_numpy(x)), tm).numpy()
    assert got.shape == want.shape == (T, 1536)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_REL * np.abs(want).max())


def test_tile_rule_and_counts():
    """One tile per row count; CPU calls count no launch of either."""
    assert tq.k1_tile(1) == "dp4a"
    assert all(tq.k1_tile(T) == "mma" for T in (tq.K1_MMA_MIN_T, 20, 64, 512))
    assert set(tq.tile_launches) == set(tq.K1_TILES)
    ops = _t(*_operands(4, 512, 64, seed=3))
    tq.reset_launches()
    tq.q40_int8(*ops)
    assert tq.launches == {"q40_int8": 0, "q40_dequant": 0} and tq.tile_launches == {"dp4a": 0, "mma": 0}
