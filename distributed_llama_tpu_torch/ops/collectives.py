"""The all-reduce seam of tensor parallelism, and the two kernels behind its
``ring`` arm.

Every tensor-parallel layer sums the ranks' partial outputs twice, after
wo and after down (``models.llama.block_tail_tp``). A rank's tensors are a
list entry here: :func:`all_reduce` takes one tensor per rank and returns
one per rank, every one holding the same bytes (replicated sampling relies
on that). The arm is the caller's ``impl``, the values of the JAX package's
``DLT_ALLREDUCE``:

* ``psum``     the plain sum in rank order (the JAX package leaves psum to
               XLA, outside any Pallas kernel);
* ``ring_xla`` the plain unidirectional schedule: n chunks, chunk c summed
               over ranks c, c+1, ..., c+n-1;
* ``ring``     K4, ``csrc/ring_all_reduce.cu``: the bidirectional ring's
               function, 2n chunks, even chunks summed clockwise and odd
               chunks counter-clockwise (:func:`ring_fold_order`).

:func:`matmul_all_reduce` is the wo/down seam: under ``ring``, where
:func:`fused_ring_eligible` holds, K5 (``csrc/fused_matmul_ring.cu``)
computes each rank's int8 matmul tile and sums the ranks in K4's order
without writing any rank's product to device memory; otherwise each rank
runs its matmul and :func:`all_reduce` follows.

Each kernel wrapper launches its kernel for CUDA tensors or raises, counts
the launch in :data:`launches`, and computes the kernel's plain version for
CPU tensors. There is no fallback between arms. With telemetry on, each
sum counts in ``dllama_kernel_path_total{kernel="all_reduce"}`` by the path
that ran: ``k4_ring`` / ``k5_fused`` / ``psum`` / ``plain``.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.ops import q40

IMPLS = ("psum", "ring_xla", "ring")
MAX_RANKS = 8  # the kernels' pointer tables
COL_TILE = 64  # K1's output columns per CTA: a K5 chunk is whole tiles

SEVERAL_CARDS = ("tensor-parallel ranks on several cards are not ported yet "
                 "(ROADMAP.md Queue 1: ranks on several cards, with peer access or events between devices)")

# kernel name -> launches since the last reset_launches(); a wrapper adds one
# where it launches its CUDA kernel and nowhere else
launches: dict[str, int] = {"ring_all_reduce": 0, "fused_matmul_ring": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def ring_fold_order(n: int, k: int) -> list[int]:
    """The ranks, in summation order, of chunk ``k`` of the bidirectional
    ring's 2n chunks: the JAX kernel's reduce-scatter carries chunk 2c
    clockwise from rank c (its partial picks up rank c+1, then c+2, ...) and
    chunk 2c+1 counter-clockwise (c, c-1, ...), each as a left fold."""
    c = k // 2
    step = 1 if k % 2 == 0 else -1
    return [(c + step * i) % n for i in range(n)]


def _fold(xs: list, n_chunks: int, order) -> torch.Tensor:
    """The last axis, zero-padded to a multiple of ``n_chunks`` and cut into
    that many chunks; chunk k is the left fold of the ranks ``order(k)`` in
    f32, then the padding is trimmed. One tensor of the inputs' shape."""
    n, shape = len(xs), xs[0].shape
    d = shape[-1]
    stacked = torch.stack([x.reshape(-1, d) for x in xs])  # [n, R, d]
    pad = (-d) % n_chunks
    if pad:
        stacked = torch.nn.functional.pad(stacked, (0, pad))
    R, w = stacked.shape[1], stacked.shape[2] // n_chunks
    stacked = stacked.reshape(n, R, n_chunks, w)
    ranks = torch.tensor([order(k) for k in range(n_chunks)], device=stacked.device).t()  # [i, k]
    ks = torch.arange(n_chunks, device=stacked.device)
    acc = stacked[ranks[0], :, ks]  # [n_chunks, R, w]
    for i in range(1, n):
        acc = acc + stacked[ranks[i], :, ks]
    return acc.permute(1, 0, 2).reshape(R, n_chunks * w)[:, :d].reshape(shape)


def psum(xs: list) -> list:
    """The plain sum in rank order, one copy per rank."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return [acc] * len(xs)


def ring_xla(xs: list) -> list:
    """The plain unidirectional ring schedule of the JAX package's
    ``ring_all_reduce_xla``: n chunks, chunk c the left fold over ranks c,
    c+1, ..., c+n-1."""
    n = len(xs)
    return [_fold(xs, n, lambda k: [(k + i) % n for i in range(n)])] * n


def ring_all_reduce_plain(xs: list) -> list:
    """K4's plain version: the last axis zero-padded to a multiple of 2n,
    2n chunks, chunk k the left fold over :func:`ring_fold_order`, trimmed."""
    n = len(xs)
    return [_fold(xs, 2 * n, lambda k: ring_fold_order(n, k))] * n


def _ptrs(ts: list):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _check_ranks(name: str, ts: list, dtype: torch.dtype, shape: tuple) -> torch.device:
    """One rank's operand per entry: all of ``dtype`` and ``shape``, all on
    one device (ranks on several cards raise NotImplementedError)."""
    dev = ts[0].device
    for r, t in enumerate(ts):
        if t.device != dev:
            raise NotImplementedError(SEVERAL_CARDS)
        q40._check(f"{name}[{r}]", t, dtype, shape, dev)
    if len(ts) > MAX_RANKS:
        raise ValueError(f"{name}: {len(ts)} ranks, at most {MAX_RANKS}")
    return dev


def ring_all_reduce(xs: list) -> list:
    """Wrapper of K4 (``csrc/ring_all_reduce.cu``): f32 [..., d] per rank in,
    the all-reduced sum per rank out (:func:`ring_all_reduce_plain`'s bytes
    on every rank). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    xs = [x.contiguous() for x in xs]
    dev = _check_ranks("xs", xs, torch.float32, tuple(xs[0].shape))
    if dev.type == "cpu":
        telemetry.note_kernel_path("all_reduce", "plain")
        return ring_all_reduce_plain(xs)
    if dev.type != "cuda":
        raise ValueError(f"ring_all_reduce: unsupported device {dev}")
    from distributed_llama_tpu_torch.ops import cuda_build

    n, d = len(xs), xs[0].shape[-1]
    outs = [torch.empty_like(x) for x in xs]
    fn = cuda_build.function("ring_all_reduce")
    q40._check_launch(fn(_ptrs(xs), _ptrs(outs), n, xs[0].numel() // d, d,
                         torch.cuda.current_stream(dev).cuda_stream), "ring_all_reduce")
    launches["ring_all_reduce"] += 1
    telemetry.note_kernel_path("all_reduce", "k4_ring")
    return outs


def all_reduce(xs: list, impl: str = "psum") -> list:
    """THE all-reduce seam: the sum over ranks of ``xs`` (one tensor per
    rank), the same bytes on every rank. One rank is the identity; a ring
    arm with a payload narrower than the rank count takes psum (the
    deterministic shape rule of the JAX seam)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown all-reduce {impl!r}; expected one of {IMPLS}")
    n = len(xs)
    if n <= 1:
        return list(xs)
    if impl != "psum" and xs[0].shape[-1] < n:
        impl = "psum"
    if impl == "ring":
        return ring_all_reduce(xs)
    if impl == "ring_xla":
        telemetry.note_kernel_path("all_reduce", "plain")
        return ring_xla(xs)
    telemetry.note_kernel_path("all_reduce", "psum")
    return psum(xs)


# ---------------------------------------------------------------------------
# K5: the int8 Q40 matmul fused into K4 (csrc/fused_matmul_ring.cu)
# ---------------------------------------------------------------------------


def fused_matmul_ring_plain(xqs: list, sxs: list, corrs: list, qss: list, scaless: list) -> list:
    """K5's plain version: per rank y_r = K1(xq_r, sx_r, qs_r, scales_r) -
    8 corr_r (K1's plain version), then K4's plain version over the y_r."""
    ys = [q40.q40_int8_plain(xq, sx, qs, sc) - 8.0 * corr
          for xq, sx, qs, sc, corr in zip(xqs, sxs, qss, scaless, corrs)]
    return ring_all_reduce_plain(ys)


def fused_matmul_ring(xqs: list, sxs: list, corrs: list, qss: list, scaless: list) -> list:
    """Wrapper of K5: per rank the Q80 activations (xq int8 [T, n_pad], sx
    f32 [T, n_pad/32]), the bias correction corr f32 [T, d_pad]
    (:func:`ops.q40.bias_correction`) and the Q40 pack (qs, scales); out
    f32 [T, d_pad] per rank, equal to K1, then ``- 8 corr``, then K4. T <= 8
    and d_pad a multiple of 2n x 64. CPU tensors take the plain version;
    CUDA tensors launch the kernel as clusters of n CTAs or raise (a refused
    cluster launch included)."""
    n = len(xqs)
    T, n_pad = xqs[0].shape
    d_pad = qss[0].shape[1]
    dev = _check_ranks("xq", xqs, torch.int8, (T, n_pad))
    for name, ts, dt, shape in (("sx", sxs, torch.float32, (T, n_pad // 32)),
                                ("corr", corrs, torch.float32, (T, d_pad)),
                                ("qs", qss, torch.uint8, (n_pad // 2, d_pad)),
                                ("scales", scaless, torch.float32, (n_pad // 32, d_pad))):
        if _check_ranks(name, ts, dt, shape) != dev:
            raise NotImplementedError(SEVERAL_CARDS)
    if T > 8 or n_pad % 64 or d_pad % (2 * n * COL_TILE):
        raise ValueError(f"fused_matmul_ring: T {T} > 8, n_pad {n_pad} or d_pad {d_pad} not tiled for {n} ranks")
    if dev.type == "cpu":
        telemetry.note_kernel_path("all_reduce", "plain")
        return fused_matmul_ring_plain(xqs, sxs, corrs, qss, scaless)
    if dev.type != "cuda":
        raise ValueError(f"fused_matmul_ring: unsupported device {dev}")
    from distributed_llama_tpu_torch.ops import cuda_build

    outs = [torch.empty((T, d_pad), dtype=torch.float32, device=dev) for _ in range(n)]
    fn = cuda_build.function("fused_matmul_ring")
    q40._check_launch(fn(_ptrs(xqs), _ptrs(sxs), _ptrs(qss), _ptrs(scaless), _ptrs(corrs), _ptrs(outs),
                         n, T, n_pad, d_pad, torch.cuda.current_stream(dev).cuda_stream), "fused_matmul_ring")
    launches["fused_matmul_ring"] += 1
    telemetry.note_kernel_path("all_reduce", "k5_fused")
    return outs


def k5_cluster_dims(n: int) -> tuple[int, int, int]:
    """The thread-block cluster shape K5 launches with for ``n`` ranks (one
    CTA per rank of a column tile), as its C library reports it."""
    from distributed_llama_tpu_torch.ops import cuda_build

    dims = (ctypes.c_int * 3)()
    q40._check_launch(cuda_build.function("fused_matmul_ring", "fused_matmul_ring_cluster")(n, dims),
                      "fused_matmul_ring_cluster")
    return tuple(dims)


def fused_ring_eligible(xs: list, ws: list, path: str = "int8") -> bool:
    """Where K5 serves the ``ring`` arm: every rank's weight a kernel-tiled
    Q40 pack of one shape on the int8 path, T <= 8 (K1's largest token
    tile), and the output width unpadded and a multiple of 2n x 64, so that
    each of the 2n ring chunks is whole 64-column K1 tiles and the chunks
    are those of K4 over the trimmed output. The JAX gate also bounds the
    operands by the TPU's VMEM (``_fused_ring_eligible``); the card streams
    the weights from HBM, and that bound would turn away a 7B down shard
    (11.3 MB of nibbles at tp=2) for nothing: it picks which arm serves,
    not what is computed."""
    n, w0 = len(xs), ws[0]
    return (path == "int8" and n <= MAX_RANKS and xs[0].dim() == 2 and xs[0].shape[0] <= 8
            and all(isinstance(w, q40.QuantizedMatrix) and q40.kernel_eligible(w)
                    and w.qs.shape == w0.qs.shape for w in ws)
            and w0.d == w0.d_padded and w0.d_padded % (2 * n * COL_TILE) == 0)


def fused_matmul_ring_all_reduce(xs: list, qms: list) -> list:
    """sum over ranks of x_r @ dequant(qm_r) through K5: each rank's Q80
    quantize and bias correction (the same ops as the unfused int8 path),
    then one launch for the matmuls and the ring."""
    preps = [q40.quantize_for(x, qm) for x, qm in zip(xs, qms)]
    corrs = [q40.bias_correction(xq, sx, qm) for (xq, sx), qm in zip(preps, qms)]
    return fused_matmul_ring([p[0] for p in preps], [p[1] for p in preps], corrs,
                             [qm.qs for qm in qms], [qm.scales for qm in qms])


def matmul_all_reduce(xs: list, ws: list, impl: str = "psum", path: str = "int8") -> list:
    """THE matmul + all-reduce seam: sum over ranks of ``xs[r] @ ws[r]``,
    the same bytes on every rank. Under ``ring``, K5 where
    :func:`fused_ring_eligible` holds; otherwise each rank's matmul
    (``models.llama._matmul``), then :func:`all_reduce` under ``impl``."""
    from distributed_llama_tpu_torch.models.llama import _matmul

    if impl == "ring" and len(xs) > 1 and fused_ring_eligible(xs, ws, path):
        return fused_matmul_ring_all_reduce(xs, ws)
    return all_reduce([_matmul(x, w, path) for x, w in zip(xs, ws)], impl)
