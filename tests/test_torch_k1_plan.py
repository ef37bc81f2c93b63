"""K1's decode tile (``csrc/q40_int8_decode.cuh``, T = 1): its plans and its
order, held on the CPU.

* A plain PyTorch simulation of the tile at each plan of ``ops/q40.py
  K1_PLANS``: a CTA per 64 columns walks its ring pieces (piece u of block
  16 j + s for slice s at step j, ``rows`` packed rows each), adds each
  piece's exact int32 dots (the high half as 16 times its dot, shifted
  down after the block), runs a block's f32 epilogue after its last piece,
  every product and sum rounded on its own, then adds each column's 16
  slice partials in slice order. It is held bit for bit against
  ``q40_int8_ordered_plain`` at every plan, for block counts per half that
  are a multiple of 16, one that is not, and one below 16, at d = 64 and at
  a d = 4096 width.
* The plan (``k1_plan``) at every T = 1 shape ``chip_smoke.py`` launches:
  a plan the kernel takes, whose pieces reach every row of every block of
  both halves exactly once, each slice's blocks in increasing order.
* The launch wrapper hands the plan to the C entry point, whose signature
  has one argument per ctypes argtype.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import cuda_build
from distributed_llama_tpu_torch.ops import q40 as tq

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(n_pad: int, d: int, seed: int):
    """One row of random Q80 activations and a Q40 pack in the kernel's
    layout, as torch tensors."""
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, size=(1, n_pad)).astype(np.int8)
    sx = (rng.rand(1, n_pad // 32) / 50).astype(np.float32)
    qs = rng.randint(0, 256, size=(n_pad // 2, d)).astype(np.uint8)
    sc = (rng.rand(n_pad // 32, d) / 60).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (xq, sx, qs, sc))


def _pieces(nb: int, rows: int) -> list[tuple[int, int]]:
    """A CTA's ring pieces in order: (step, piece of the block)."""
    steps = -(-nb // tq.K1_SLICES)
    return [divmod(k, 32 // rows) for k in range(steps * (32 // rows))]


def _decode_tile_sim(xq, sx, qs, sc, plan: int) -> torch.Tensor:
    """The decode tile's arithmetic in its order, f32 [1, d]."""
    rows, _stages = tq.K1_PLANS[plan]
    n_pad, d = xq.shape[1], qs.shape[1]
    half, nb = n_pad // 2, n_pad // 64
    x = xq[0].to(torch.int64)
    nib = (qs.to(torch.int64) & 0xF, qs.to(torch.int64) & 0xF0)  # the high nibbles in place: 16 times
    lo = torch.zeros((tq.K1_SLICES, d), dtype=torch.int64)
    hi16 = torch.zeros((tq.K1_SLICES, d), dtype=torch.int64)
    acc = torch.zeros((tq.K1_SLICES, d), dtype=torch.float32)
    for j, u in _pieces(nb, rows):
        for s in range(tq.K1_SLICES):
            b = tq.K1_SLICES * j + s
            if b >= nb:
                continue
            r0 = b * 32 + u * rows
            lo[s] += x[r0:r0 + rows] @ nib[0][r0:r0 + rows]
            hi16[s] += x[half + r0:half + r0 + rows] @ nib[1][r0:r0 + rows]
            if u == 32 // rows - 1:  # the block's last piece: its epilogue
                for h, dots in ((0, lo[s]), (1, hi16[s] >> 4)):
                    acc[s] = acc[s] + (dots.to(torch.float32) * sc[h * nb + b]) * sx[0, h * nb + b]
                lo[s] = 0
                hi16[s] = 0
    out = torch.zeros(d, dtype=torch.float32)
    for s in range(tq.K1_SLICES):  # the fold, in slice order
        out = out + acc[s]
    return out[None]


@pytest.mark.parametrize("plan", range(len(tq.K1_PLANS)))
@pytest.mark.parametrize("d", [64, 4096])
@pytest.mark.parametrize("n_pad", [2048, 2112, 512])  # 32, 33 and 8 blocks per half
def test_plan_equals_ordered_plain(n_pad, d, plan):
    ops = _operands(n_pad, d, seed=n_pad + d + plan)
    got = _decode_tile_sim(*ops, plan)
    want = tq.q40_int8_ordered_plain(*ops)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape == (1, d)
    assert torch.equal(got, want)


def _t1_shapes():
    cs = _chip_smoke()
    for set_name, shapes in cs.K1_T1_SETS.items():
        for shape, (n, d, _per_token) in shapes.items():
            yield set_name, shape, tq._n_padded(n), tq._d_padded(d)


def test_plan_covers_every_row_once():
    shapes = list(_t1_shapes())
    assert len(shapes) == 22 and {s for s, *_ in shapes} == {"7B", "7B --tp shards", "MoE experts",
                                                               "Mixtral --tp shards"}
    for set_name, shape, n_pad, d_pad in shapes:
        plan = tq.k1_plan(n_pad, d_pad)
        assert plan in range(len(tq.K1_PLANS)), (set_name, shape)
        rows, stages = tq.K1_PLANS[plan]
        assert 32 % rows == 0 and rows % 8 == 0 and stages >= 3
        nb = n_pad // 64
        seen = {s: [] for s in range(tq.K1_SLICES)}  # slice -> its (block, first row) in ring order
        for j, u in _pieces(nb, rows):
            for s in range(tq.K1_SLICES):
                if tq.K1_SLICES * j + s < nb:
                    seen[s].append((tq.K1_SLICES * j + s, u * rows))
        for s, got in seen.items():
            assert got == sorted(got), (set_name, shape, s)  # blocks in increasing b, rows in order
            assert all(b % tq.K1_SLICES == s for b, _ in got)
        assert sorted(p for v in seen.values() for p in v) == [(b, r) for b in range(nb) for r in range(0, 32, rows)]


def test_plan_rule():
    assert [tq.k1_plan(4096, d) for d in (1024, 4096, 5120, 6144, 8448, 11264, 12288, 22528, 25344, 28672)] == [
        0, 0, 0, 1, 1, 2, 2, 2, 2, 3]
    assert tq.k1_plan(11264, 4096) == tq.k1_plan(2048, 4096) == 0  # several blocks a slice: whole blocks
    assert tq.k1_plan(1024, 4096) == 1  # one block a slice: 8-row pieces overlap its only step


class _Stream:
    cuda_stream = 0


def test_launch_passes_the_plan(monkeypatch):
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(cuda_build, "function", lambda name, symbol=None: fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    xq, sx, qs, sc = _operands(2048, 4096, seed=1)
    tq._q40_int8_launch(xq, sx, qs, sc, "dp4a")
    tq._q40_int8_launch(xq, sx, qs, sc, "dp4a", 2)
    tq._q40_int8_launch(xq, sx, qs, sc, "mma")
    assert [c[5:10] for c in calls] == [(1, 2048, 4096, 0, tq.k1_plan(2048, 4096)), (1, 2048, 4096, 0, 2),
                                        (1, 2048, 4096, 1, tq.k1_plan(2048, 4096))]
    monkeypatch.setattr(cuda_build, "function", lambda name, symbol=None: lambda *a: 716)
    with pytest.raises(RuntimeError, match="cudaError 716"):
        tq._q40_int8_launch(xq, sx, qs, sc, "dp4a")


def test_entry_point_signature_matches_argtypes():
    src = (cuda_build.CSRC / "q40_int8.cu").read_text()
    sig = re.search(r'extern "C" int q40_int8_matmul\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in sig.split(",")]
    _file, fn, argtypes = cuda_build.KERNELS["q40_int8"]
    assert fn == "q40_int8_matmul" and len(params) == len(argtypes) == 11
    assert params[9] == "int plan" and argtypes[9] is cuda_build._I
