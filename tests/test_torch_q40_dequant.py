"""K3 (the Q40 dequant matmul, ``--q40-path f32``) and K5's cluster fold,
held on the CPU against what their CUDA kernels compute.

* The kernel's dequantization (two nibbles spliced into a bf16 pair with
  0x43004300, minus 128, times the bf16 scale pair) is emulated on uint16
  bit patterns with numpy and equals ``q40.dequant_weights`` (the plain
  version's weights) bit for bit, for every nibble and every finite f16
  scale, subnormals and signed zeros included.
* The f32 path's rows against lone-row calls bit for bit, across the
  64-row block too (its JAX parity at T = 1, 2, 5, 20 is
  ``tests/test_torch_q40.py::test_matmul_matches_jax_kernel``).
* A numpy simulation of K5's cluster (CTA i of a column tile holds rank
  ``(c + step i) % n`` and the fold adds the CTAs' terms in CTA order)
  equals ``fused_matmul_ring_plain`` bit for bit for n = 2, 4, 8.
* Greedy ``--q40-path f32 --spec-draft 3`` prints the tokens of the plain
  f32-path run.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import collectives as coll
from distributed_llama_tpu_torch.ops import q40 as tq


def _bf16_bits(f32: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns, round to nearest even (no NaNs here)."""
    u = np.ascontiguousarray(f32, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _finite_f16() -> np.ndarray:
    f = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    return f[np.isfinite(f)]


def _splice_dequant(qs: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """What the kernel computes per pair of packed rows (r, r + 1) of one
    column: the two bytes spliced into the 16-bit halves of a word, LOP3
    with 0x000F000F / 0x43004300 (for the high nibbles after a shift by 4),
    HSUB2 of {128, 128}, HMUL2 by the bf16 scale pair. Returns bf16 bit
    patterns [n_pad, d] (low-nibble rows, then high-nibble rows)."""
    half, d = qs.shape
    s_bits = _bf16_bits(scales)  # [n_pad/32, d]
    out = np.empty((2 * half, d), np.uint16)
    for h in range(2):
        for r in range(0, half, 2):
            word = qs[r].astype(np.uint32) | (qs[r + 1].astype(np.uint32) << 16)
            biased = ((word >> (4 * h)) & 0x000F000F) | 0x43004300
            s = _bf16_value(s_bits[h * (half // 32) + r // 32])
            for lane, row in ((0, r), (1, r + 1)):
                v = _bf16_value(((biased >> (16 * lane)) & 0xFFFF).astype(np.uint16))
                nib = _bf16_bits(v - np.float32(128.0))  # exact: n in 0..15
                # a 4-bit integer times an 8-bit mantissa is exact in f32
                out[h * half + row] = _bf16_bits(_bf16_value(nib) * s)
    return out


def test_splice_dequant_equals_plain_weights_for_every_nibble_and_f16_scale():
    f16 = _finite_f16()
    assert f16.size == 63488 and (f16 == 0).sum() == 2  # +0 and -0
    d = f16.size
    rows = np.arange(32)[:, None]
    cols = np.arange(d)[None, :]
    # every low nibble in every column, high nibbles rotating with the column
    qs = ((rows % 16) | (((rows + cols) % 16) << 4)).astype(np.uint8)
    scales = np.stack([f16.astype(np.float32), f16[::-1].astype(np.float32)])  # [2, d]: n_pad = 64
    want = tq.dequant_weights(torch.from_numpy(qs), torch.from_numpy(scales), torch.bfloat16)
    got = _splice_dequant(qs, scales)
    np.testing.assert_array_equal(got, want.view(torch.int16).numpy().view(np.uint16))
    # negative scales give -0 for the nibble 0 in both
    assert (got[:, scales[0] < 0][0] == 0x8000).all()


def _pack(n, d, seed):
    return tq.quantize_q40_tpu((np.random.RandomState(seed).randn(n, d) / np.sqrt(n)).astype(np.float32))


@pytest.mark.parametrize("T", [5, 70])
def test_f32_path_rows_equal_lone_rows(T):
    """Every row of the f32 path (the dequant matmul, the block sums and the
    bias correction) equals that row computed alone, bit for bit, also
    across the 64-row block: what speculative verify on the f32 path
    needs."""
    tm = _pack(1024, 1536, seed=6)
    x = torch.from_numpy(np.random.RandomState(7).randn(T, 1024).astype(np.float32))
    both = tq.q40_matmul(x, tm, "f32")
    alone = torch.cat([tq.q40_matmul(x[t:t + 1], tm, "f32") for t in range(T)])
    assert torch.equal(both, alone)


def _cluster_fold_sim(ys: list, n: int) -> np.ndarray:
    """K5's cluster: a 64-column tile lies in chunk k (width d / 2n); CTA i
    of its cluster holds rank (c + step i) % n, c = k // 2, step 1 for even
    k and n - 1 for odd k; the fold is y of CTA 0, then += y of CTA 1, ...,
    in float32."""
    T, d = ys[0].shape
    w = d // (2 * n)
    out = np.empty((T, d), np.float32)
    for col0 in range(0, d, 64):
        k = col0 // w
        c, step = k // 2, (n - 1 if k % 2 else 1)
        ranks = [(c + step * i) % n for i in range(n)]
        total = ys[ranks[0]][:, col0:col0 + 64].copy()
        for r in ranks[1:]:
            total = (total + ys[r][:, col0:col0 + 64]).astype(np.float32)
        out[:, col0:col0 + 64] = total
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("T", [1, 8])
def test_k5_cluster_fold_equals_plain(n, T):
    rng = np.random.RandomState(10 + n)
    qms = [tq.quantize_q40_tpu(rng.randn(512, 1024).astype(np.float32) / 32) for _ in range(n)]
    xs = [torch.from_numpy(rng.randn(T, 512).astype(np.float32)).to(torch.bfloat16) for _ in range(n)]
    assert coll.fused_ring_eligible(xs, qms)
    preps = [tq.quantize_for(x, qm) for x, qm in zip(xs, qms)]
    corrs = [tq.bias_correction(xq, sx, qm) for (xq, sx), qm in zip(preps, qms)]
    qss, scs = [qm.qs for qm in qms], [qm.scales for qm in qms]
    plain = coll.fused_matmul_ring_plain([p[0] for p in preps], [p[1] for p in preps], corrs, qss, scs)
    # each CTA's term: the K1 tile, minus 8 corr (an exact product, one rounding)
    ys = [tq.q40_int8_plain(xq, sx, qs, sc).numpy() - np.float32(8.0) * c.numpy()
          for (xq, sx), qs, sc, c in zip(preps, qss, scs, corrs)]
    want = _cluster_fold_sim(ys, n)
    for p in plain:
        np.testing.assert_array_equal(p.numpy().view(np.uint32), want.view(np.uint32))


def test_cli_f32_path_spec_generate_equals_plain(tmp_path, monkeypatch):
    """``generate --q40-path f32 --spec-draft 3`` on a Q40 model whose
    matrices take the dequant kernel's path prints the plain f32-path
    run's tokens, greedy."""
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.formats import synthetic as tsyn
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.quants import FloatType

    model, tok = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    spec = tsyn.tiny_spec(dim=512, hidden_dim=1024, n_heads=8, n_kv_heads=4, vocab_size=512, seq_len=128,
                          weights_float_type=FloatType.Q40)
    tsyn.write_random_q40_model(model, spec, seed=3)
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=spec.vocab_size))
    calls = []
    real = tq.q40_dequant
    monkeypatch.setattr(tq, "q40_dequant", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    base = ["generate", "--model", model, "--tokenizer", tok, "--prompt", "hello world hello", "--device",
            "cpu", "--dtype", "q40", "--q40-path", "f32", "--steps", "24", "--temperature", "0"]
    plain = cli.main(base)
    spec_run = cli.main(base + ["--spec-draft", "3"])
    assert spec_run["tokens"] == plain["tokens"] and len(plain["tokens"]) > 0
    assert max(calls) > 1  # verify windows (or the prefill) went through the dequant path


def test_cpu_witness_computes_the_f32_path_in_the_cards_arithmetic(monkeypatch):
    """``CPU_DEQUANT_DTYPE`` bf16 gives the CPU the card's f32 path: x
    rounded to bf16 times the weights as the kernel dequantizes them
    (``dequant_weights`` in bf16), less the bias correction on the f32
    scales, equal to that formula in f64 up to f32 sums; the f32 default
    (the JAX package's interpret mode) lies two orders further from it."""
    tm = _pack(1024, 1536, seed=6)
    x = torch.from_numpy(np.random.RandomState(8).randn(3, 1024).astype(np.float32))
    default = tq.q40_matmul(x, tm, "f32")
    monkeypatch.setattr(tq, "CPU_DEQUANT_DTYPE", torch.bfloat16)
    got = tq.q40_matmul(x, tm, "f32")
    xb = x.to(torch.bfloat16).double()
    w = tq.dequant_weights(tm.qs, tm.scales, torch.bfloat16).double()
    want = (xb @ w - 8.0 * xb.reshape(3, -1, 32).sum(-1) @ tm.scales.double())[:, :tm.d]
    scale = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    assert err <= 2e-6 * scale  # measured 5.0e-7
    assert (default.double() - want).abs().max().item() >= 100 * err
