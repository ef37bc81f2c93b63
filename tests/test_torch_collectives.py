"""The port's all-reduce seam (ops/collectives.py) held against the JAX
package: K4's plain version against a step-by-step numpy simulation of the
Pallas ring kernel, the plain arms against the JAX ring schedule and seam on
the 8-device CPU mesh, K5's plain version against the unfused path, and the
seam's routing. The CUDA kernels themselves are held against these plain
versions by chip_smoke.py phase 7 on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distributed_llama_tpu.ops import collectives as jcoll
from distributed_llama_tpu.ops.q40 import quantize_q40_tpu as jquantize

from distributed_llama_tpu_torch.engine import weights as tweights
from distributed_llama_tpu_torch.models import llama as tllama
from distributed_llama_tpu_torch.ops import collectives as coll
from distributed_llama_tpu_torch.ops import q40 as tq


def simulate_ring_kernel(xs: list) -> list:
    """The JAX ``_make_ring_kernel`` step by step on numpy f32, one state per
    rank: 2n chunks (index 2c + d: ring d's chunk at position c), both
    rings' reduce-scatter hops (a rank receives its left neighbour's
    clockwise partial and its right neighbour's counter-clockwise one and
    adds its own local chunk), the owned sums stored, then the all-gather
    hops copying them verbatim. Returns each rank's output."""
    n = len(xs)
    d = xs[0].shape[-1]
    pad = (-d) % (2 * n)
    chunks = [np.split(np.pad(x, ((0, 0), (0, pad))), 2 * n, axis=-1) for x in xs]

    def local(r, ring, c):
        return chunks[r][2 * c + ring]

    p_cw = [local(r, 0, r) for r in range(n)]
    p_ccw = [local(r, 1, r) for r in range(n)]
    for s in range(1, n):
        got_cw = [p_cw[(r - 1) % n] for r in range(n)]  # sent clockwise by r-1
        got_ccw = [p_ccw[(r + 1) % n] for r in range(n)]  # sent counter-clockwise by r+1
        p_cw = [got_cw[r] + local(r, 0, (r - s) % n) for r in range(n)]
        p_ccw = [got_ccw[r] + local(r, 1, (r + s) % n) for r in range(n)]
    out = [[None] * (2 * n) for _ in range(n)]
    for r in range(n):
        out[r][2 * ((r + 1) % n)] = p_cw[r]
        out[r][2 * ((r - 1) % n) + 1] = p_ccw[r]
    c_cw, c_ccw = p_cw, p_ccw
    for s in range(1, n):
        c_cw = [c_cw[(r - 1) % n] for r in range(n)]
        c_ccw = [c_ccw[(r + 1) % n] for r in range(n)]
        for r in range(n):
            out[r][2 * ((r - s + 1) % n)] = c_cw[r]
            out[r][2 * ((r + s - 1) % n) + 1] = c_ccw[r]
    return [np.concatenate(o, axis=-1)[:, :d] for o in out]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _rank_inputs(n: int, d: int, seed: int, rows: int = 2) -> list:
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, d) * rng.choice([0.01, 1.0, 100.0])).astype(np.float32) for _ in range(n)]


def test_ring_fold_order_pinned():
    """The association derived from the kernel's carries: clockwise chunk
    2c folds ranks c, c+1, ...; counter-clockwise chunk 2c+1 folds c, c-1, ..."""
    assert [coll.ring_fold_order(4, k) for k in range(8)] == [
        [0, 1, 2, 3], [0, 3, 2, 1], [1, 2, 3, 0], [1, 0, 3, 2],
        [2, 3, 0, 1], [2, 1, 0, 3], [3, 0, 1, 2], [3, 2, 1, 0],
    ]
    assert [coll.ring_fold_order(2, k) for k in range(4)] == [[0, 1], [0, 1], [1, 0], [1, 0]]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("d", [4096, 4100, 256])
def test_plain_ring_equals_kernel_simulation(n, d):
    """K4's plain version is the Pallas ring kernel's function bit for bit
    on every column, and every simulated rank ends with the same bytes."""
    xs = _rank_inputs(n, d, seed=n * 1000 + d)
    sim = simulate_ring_kernel(xs)
    for r in range(1, n):
        np.testing.assert_array_equal(_bits(sim[r]), _bits(sim[0]))
    got = coll.all_reduce([torch.from_numpy(x) for x in xs], "ring")
    assert len(got) == n
    for g in got:
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(sim[0]))


def _jax_ring_xla(xs: list) -> np.ndarray:
    """The JAX package's ``ring_all_reduce_xla`` over an n-device mesh, each
    device holding one rank's input: [n, rows, d] per-device outputs."""
    n = len(xs)
    mesh = Mesh(mesh_utils.create_device_mesh((n,), devices=jax.devices()[:n]), ("tp",))
    fn = jcoll.shard_map_compat(lambda x: jcoll.ring_all_reduce_xla(x[0], "tp", n)[None], mesh=mesh,
                                in_specs=P("tp"), out_specs=P("tp"))
    return np.asarray(jax.jit(fn)(jnp.asarray(np.stack(xs))))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("d", [4096, 4100, 256])
def test_plain_rings_against_jax_ring_xla(n, d):
    """The port's ring_xla arm equals the JAX schedule bit for bit; its K4
    arm equals it bit for bit on the clockwise chunks (the same fold order
    where the two chunkings overlap) and within the JAX test's 1e-5
    elsewhere (the counter-clockwise chunks fold the other way round)."""
    xs = _rank_inputs(n, d, seed=7 * n + d)
    want = _jax_ring_xla(xs)
    for r in range(1, n):
        np.testing.assert_array_equal(_bits(want[r]), _bits(want[0]))
    ring_xla = coll.all_reduce([torch.from_numpy(x) for x in xs], "ring_xla")[0].numpy()
    np.testing.assert_array_equal(_bits(ring_xla), _bits(want[0]))
    ring = coll.all_reduce([torch.from_numpy(x) for x in xs], "ring")[0].numpy()
    cols = np.arange(d)
    k4_chunk = cols // -(-d // (2 * n))
    same_fold = (k4_chunk % 2 == 0) & (cols // -(-d // n) == k4_chunk // 2)
    assert same_fold.sum() >= d // 2 - 2 * n
    np.testing.assert_array_equal(_bits(ring[:, same_fold]), _bits(want[0][:, same_fold]))
    np.testing.assert_allclose(ring, want[0], rtol=1e-5, atol=1e-5)


def test_psum_is_the_rank_order_sum():
    xs = [torch.from_numpy(x) for x in _rank_inputs(4, 300, seed=3)]
    got = coll.all_reduce(xs, "psum")
    assert all(torch.equal(g, ((xs[0] + xs[1]) + xs[2]) + xs[3]) for g in got)


def _seam_setup():
    """tests/test_kernel_parity.py TestMatmulAllReduceSeam's inputs: 8 ranks,
    n_shard 512, d 128, T 2."""
    rng = np.random.RandomState(0)
    n_shard, d, T = 512, 128, 2
    packs = [jquantize(rng.randn(n_shard, d).astype(np.float32) / 32) for _ in range(8)]
    xs = rng.randn(8, T, n_shard).astype(np.float32)
    return packs, xs


def _to_port(pack) -> tq.QuantizedMatrix:
    tree = {"qs": np.asarray(pack.qs), "scales": np.asarray(pack.scales), "n": pack.n, "d": pack.d}
    return tweights.params_from_jax({"w": tree}, "cpu")["w"]


def test_seam_arms_against_jax_matmul_all_reduce():
    """Each arm of the port's seam against the JAX seam's psum arm (the JAX
    test's setup and its 1e-5 of scale)."""
    packs, xs = _seam_setup()
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *packs)
    mesh = Mesh(mesh_utils.create_device_mesh((8,)), ("tp",))

    def f(x, qm):
        return jcoll.matmul_all_reduce(x[0], jax.tree.map(lambda a: a[0], qm), "tp", impl="psum")

    want = np.asarray(jax.jit(jcoll.shard_map_compat(
        f, mesh=mesh, in_specs=(P("tp"), P("tp")), out_specs=P(None, None)))(jnp.asarray(xs), stacked))
    qms = [_to_port(p) for p in packs]
    scale = np.abs(want).max()
    for impl in coll.IMPLS:
        outs = coll.matmul_all_reduce([torch.from_numpy(x) for x in xs], qms, impl)
        assert len(outs) == 8 and all(torch.equal(o, outs[0]) for o in outs)
        np.testing.assert_allclose(outs[0].numpy() / scale, want / scale, atol=1e-5, err_msg=impl)


def _eligible_setup(n: int, T: int, seed: int = 5):
    rng = np.random.RandomState(seed)
    qms = [tq.quantize_q40_tpu(rng.randn(512, 1024).astype(np.float32) / 32) for _ in range(n)]
    xs = [torch.from_numpy(rng.randn(T, 512).astype(np.float32)).to(torch.bfloat16) for _ in range(n)]
    return xs, qms


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("T", [1, 3, 8])
def test_fused_plain_equals_unfused_plain(monkeypatch, n, T):
    """Under ``ring``, an eligible wo/down shape takes K5 (its plain version
    on the CPU), which equals K1 + correction + K4 (their plain versions)
    bit for bit on every rank."""
    xs, qms = _eligible_setup(n, T)
    assert coll.fused_ring_eligible(xs, qms)
    calls = []
    real = coll.fused_matmul_ring_plain
    monkeypatch.setattr(coll, "fused_matmul_ring_plain", lambda *a: calls.append(1) or real(*a))
    fused = coll.matmul_all_reduce(xs, qms, "ring")
    assert calls == [1]
    unfused = coll.all_reduce([tllama._matmul(x, w) for x, w in zip(xs, qms)], "ring")
    for f, u in zip(fused, unfused):
        assert torch.equal(f, u)
    assert coll.launches == {"ring_all_reduce": 0, "fused_matmul_ring": 0, "ring_all_reduce_ipc": 0}  # the CPU launches no kernel


def test_fused_gate_and_routing(monkeypatch):
    """K5 serves only T <= 8 on the int8 path with an unpadded output width
    divisible by 2n x 64; everything else takes the rank matmuls + the
    all-reduce arm, and a payload narrower than n takes psum."""
    xs, qms = _eligible_setup(2, 1)
    assert not coll.fused_ring_eligible(xs, qms, path="f32")
    xs9, qms9 = _eligible_setup(2, 9)
    assert not coll.fused_ring_eligible(xs9, qms9)
    rng = np.random.RandomState(1)
    odd = [tq.quantize_q40_tpu(rng.randn(512, 1536).astype(np.float32)) for _ in range(4)]
    assert not coll.fused_ring_eligible([xs[0]] * 4, odd)  # 1536 % (2*4*64) != 0
    plain_w = [torch.randn(512, 1024) for _ in range(2)]
    assert not coll.fused_ring_eligible(xs, plain_w)
    calls = []
    monkeypatch.setattr(coll, "fused_matmul_ring", lambda *a: calls.append(1))
    out = coll.matmul_all_reduce(xs9, qms9, "ring")
    assert calls == [] and out[0].shape == (9, 1024)
    # the deterministic small-payload rule: [1, 4] over 8 ranks is psum
    monkeypatch.setattr(coll, "ring_all_reduce", lambda xs: pytest.fail("ring on a narrow payload"))
    small = [torch.full((1, 4), float(r + 1)) for r in range(8)]
    for impl in coll.IMPLS:
        got = coll.all_reduce(small, impl)
        assert all(torch.equal(g, torch.full((1, 4), 36.0)) for g in got)
    assert coll.all_reduce(small[:1], "ring")[0] is small[0]


def test_wrappers_check_their_operands():
    xs = [torch.zeros(2, 64), torch.zeros(2, 64, dtype=torch.float64)]
    with pytest.raises(TypeError):
        coll.ring_all_reduce(xs)
    with pytest.raises(NotImplementedError, match="several cards"):
        coll.ring_all_reduce([torch.zeros(2, 64), torch.zeros(2, 64, device="meta")])
    with pytest.raises(ValueError, match="at most 8"):
        coll.ring_all_reduce([torch.zeros(1, 64)] * 9)
    with pytest.raises(ValueError, match="unknown all-reduce"):
        coll.all_reduce([torch.zeros(1, 8)] * 2, "nccl")
    xs, qms = _eligible_setup(2, 1)
    preps = [tq.quantize_for(x, qm) for x, qm in zip(xs, qms)]
    corrs = [tq.bias_correction(xq, sx, qm) for (xq, sx), qm in zip(preps, qms)]
    with pytest.raises(ValueError, match="corr"):
        coll.fused_matmul_ring([p[0] for p in preps], [p[1] for p in preps], [c[:, :64] for c in corrs],
                               [qm.qs for qm in qms], [qm.scales for qm in qms])
