"""Q40 matmul: weights stay 4-bit in device memory and are contracted by
hand-written CUDA kernels.

Layout (``pack_q40_tpu``, the same bytes as the JAX package's pack): for a
matmul ``y[T,d] = x[T,n] @ W[n,d]``, with n padded to ``n_pad`` (zero-scale
rows) and ``half = n_pad/2``:

  * ``qs``     uint8 [n_pad/2, d_pad] — W[i,j] in the low nibble and
               W[i+half,j] in the high nibble ("half-split" pairing), values
               biased by +8 (the file format's bias);
  * ``scales`` f32 [n_pad/32, d_pad] — per-(32-input-block, output-column)
               scale.

Padding rows and columns carry zero scales, so they contribute exact zeros;
outputs are trimmed to the logical ``d``. The repack from the file's
row-major blocks is exact (nibbles are reordered, never re-quantized) and
runs with torch ops on the target device.

Two kernels sit behind :func:`q40_matmul`:

  * ``path="int8"`` (the default): activations are quantized to Q80
    (:func:`quantize_q80`) and ``csrc/q40_int8.cu`` runs exact int32 block
    dots with a scale-product epilogue;
  * ``path="f32"``: ``csrc/q40_dequant.cu`` dequantizes nibbles x scale in
    bf16 and accumulates bf16 products in f32 on the bf16 tensor cores.

Both leave the +8 nibble bias to the caller, which subtracts
``8 * (block sums of x) @ scales`` in true f32. Matrices whose padded input
dim is not a multiple of 512 (or output dim not of 128) take an f32
dequantize-then-matmul fallback with no Q80 step, the same eligibility rule
as the JAX package, so both packages compute the same numbers on small
models.

Each kernel wrapper (:func:`q40_int8`, :func:`q40_dequant`) launches its CUDA
kernel for CUDA tensors and counts the launch in :data:`launches`; for CPU
tensors it computes the kernel's plain PyTorch version beside it. There is
no other fallback. With telemetry on, every wrapper call (and the f32
fallback) also counts in ``dllama_kernel_path_total{kernel="q40_matmul"}``
by the path that ran: ``k1_dp4a`` / ``k1_mma`` / ``k3`` / ``plain``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.quants import Q40_BLOCK_BYTES, QK, quantize_q40

# kernel name -> launches since the last reset_launches(); a wrapper adds one
# where it launches its CUDA kernel and nowhere else
launches: dict[str, int] = {"q40_int8": 0, "q40_dequant": 0}
# K1's launches by the tile that ran (their sum is launches["q40_int8"]):
# "dp4a" (CUDA cores: at T = 1 the decode tile csrc/q40_int8_decode.cuh,
# above it csrc/q40_int8_tile.cuh) or "mma" (csrc/q40_int8_mma.cuh, int8
# tensor cores)
tile_launches: dict[str, int] = {"dp4a": 0, "mma": 0}

PATHS = ("int8", "f32")


def reset_launches() -> None:
    for d in (launches, tile_launches):
        for k in d:
            d[k] = 0


@dataclasses.dataclass
class QuantizedMatrix:
    """Q40 weight for ``x @ W``: packed nibbles + block scales, possibly
    padded; ``n``/``d`` are the logical (unpadded) matmul dims."""

    qs: torch.Tensor  # uint8 [n_pad/2, d_pad]
    scales: torch.Tensor  # f32 [n_pad/32, d_pad]
    n_logical: int = 0  # 0 = unpadded
    d_logical: int = 0

    @property
    def n(self) -> int:
        return self.n_logical or self.qs.shape[-2] * 2

    @property
    def d(self) -> int:
        return self.d_logical or self.qs.shape[-1]

    @property
    def n_padded(self) -> int:
        return self.qs.shape[-2] * 2

    @property
    def d_padded(self) -> int:
        return self.qs.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.d)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16  # the activation dtype the matmul expects

    @property
    def device(self) -> torch.device:
        return self.qs.device


def _n_padded(n: int) -> int:
    """512-multiples for kernel-eligible widths, 64-multiples below that
    (half-split block alignment; such matrices take the fallback)."""
    m = 512 if n > 512 else 64
    return -(-n // m) * m


def _d_padded(d: int) -> int:
    """Only output dims above 1024 are padded (to 1024-multiples)."""
    return -(-d // 1024) * 1024 if d > 1024 else d


def kernel_eligible(qm: QuantizedMatrix) -> bool:
    """The JAX package's tile rule: a kernel runs iff n_pad % 512 == 0 and
    d_pad % 128 == 0; everything else takes the f32 fallback."""
    return qm.n_padded % 512 == 0 and qm.d_padded % 128 == 0


def _pack_halves(vals_t: torch.Tensor, scales_t: torch.Tensor, n: int, d: int) -> QuantizedMatrix:
    """Pack biased nibble values [n, d] (uint8) and f32 scales [n/32, d]
    into the half-split layout after zero-scale padding."""
    n_pad, d_pad = _n_padded(n), _d_padded(d)
    if n_pad != n or d_pad != d:
        vals_t = torch.nn.functional.pad(vals_t, (0, d_pad - d, 0, n_pad - n))
        scales_t = torch.nn.functional.pad(
            scales_t, (0, d_pad - d, 0, n_pad // QK - scales_t.shape[0])
        )
    half = n_pad // 2
    packed = vals_t[:half] | (vals_t[half:] << 4)
    return QuantizedMatrix(packed.contiguous(), scales_t.contiguous(), n_logical=n, d_logical=d)


def pack_q40_raw(raw, shape: tuple[int, int], device="cpu") -> QuantizedMatrix:
    """Repack a tensor's raw `.m` Q40 bytes (file shape ``(d_out, d_in)``)
    into the half-split layout on ``device``, exactly."""
    d_out, d_in = shape
    if d_in % QK:
        raise ValueError(f"d_in {d_in} not divisible by {QK}")
    if not isinstance(raw, torch.Tensor):
        raw = torch.from_numpy(np.array(np.frombuffer(raw, np.uint8)))  # a writable copy
    blocks = raw.to(device).reshape(d_out * d_in // QK, Q40_BLOCK_BYTES)
    scales = blocks[:, :2].contiguous().view(torch.float16).reshape(d_out, d_in // QK)
    qs = blocks[:, 2:].reshape(d_out, d_in // QK, QK // 2)
    # biased nibble values in file order: low nibble = value j, high = j+16
    vals = torch.cat([qs & 0xF, qs >> 4], dim=-1).reshape(d_out, d_in)
    return _pack_halves(vals.t(), scales.float().t(), d_in, d_out)


def pack_q40_tpu(file_qs: np.ndarray, file_scales: np.ndarray, shape: tuple[int, int],
                 device="cpu") -> QuantizedMatrix:
    """Repack file-form Q40 (``file_qs`` uint8 [n_blocks, 16], ``file_scales``
    f16 [n_blocks], file shape ``(d_out, d_in)``) for ``x[T, d_in] @ W.T``."""
    raw = np.empty((file_scales.size, Q40_BLOCK_BYTES), np.uint8)
    raw[:, :2] = np.ascontiguousarray(file_scales, np.float16).reshape(-1).view(np.uint8).reshape(-1, 2)
    raw[:, 2:] = np.asarray(file_qs).reshape(-1, QK // 2)
    return pack_q40_raw(raw.reshape(-1), shape, device)


def quantize_q40_tpu(w: np.ndarray, device="cpu") -> QuantizedMatrix:
    """Quantize a float matrix W [n, d] (x@W orientation) to the packed
    layout; quantization blocks run along the input dim n."""
    n, d = w.shape
    qs_file, scales_file = quantize_q40(np.ascontiguousarray(np.asarray(w, np.float32).T))
    return pack_q40_tpu(qs_file.reshape(-1, QK // 2), scales_file.reshape(-1), (d, n), device)


def _block_rows(scales: torch.Tensor) -> torch.Tensor:
    """Per-block scales [n/32, d] repeated to per-row [n, d] (an expand,
    no host sync)."""
    nb, d = scales.shape
    return scales[:, None, :].expand(nb, QK, d).reshape(nb * QK, d)


def _nibbles(qm: QuantizedMatrix) -> torch.Tensor:
    """Biased nibble values [n_pad, d_pad] (uint8): low nibbles are rows
    [0, half), high nibbles rows [half, n_pad)."""
    return torch.cat([qm.qs & 0xF, qm.qs >> 4], dim=0)


def dequantize_tpu(qm: QuantizedMatrix) -> torch.Tensor:
    """f32 [n, d] weights of the packed layout, padding trimmed."""
    vals = _nibbles(qm).to(torch.float32) - 8.0
    return (vals * _block_rows(qm.scales))[: qm.n, : qm.d]


def quantize_q80(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Activations [T, n_pad] -> (int8 [T, n_pad], f32 scales [T, n_pad/32]):
    scale = max(amax, 1e-8) / 127, q = clip(round_half_even(x / scale),
    -127, 127). The division is a true division, as in the JAX package,
    so the int8 values and scales are bit-identical."""
    T, n = x.shape
    xb = x.to(torch.float32).reshape(T, n // QK, QK)
    amax = xb.abs().amax(dim=-1)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which can differ in the last bit
    sx = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xb / sx[..., None]), -127, 127).to(torch.int8)
    return q.reshape(T, n), sx


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1: int8 Q40 x Q80 block dots (csrc/q40_int8.cu)
# ---------------------------------------------------------------------------


# K1's accumulation slices (csrc/q40_int8_tile.cuh kSlices): block b adds
# into slice b % 16
K1_SLICES = 16
# rows from which K1 runs its tensor-core tile ("mma"); fewer take the dp4a
# tile. Both compute every row bit for bit alike, so the switch point is a
# matter of speed only (PERF.md: measured with ``chip_smoke.py --k1``)
K1_MMA_MIN_T = 2
K1_TILES = ("dp4a", "mma")


def q40_int8_plain(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: out [T, d_pad] f32 =
    sum_b sx[t,b] * sw[b,d] * P[b,t,d] with P the per-block dot of int8
    activations and biased nibbles. The block dots run as f32 products of
    integers whose partial sums stay below 2**24, so P is the exact int32
    block sum; the epilogue order (P * sw, then * sx, low half then high
    half) is the JAX kernel's."""
    T, n_pad = xq.shape
    half, nb = n_pad // 2, n_pad // 64

    def part(x_win, nib, sw, sx_win):
        xb = x_win.to(torch.float32).reshape(T, nb, QK).transpose(0, 1)  # [nb, T, 32]
        wb = nib.to(torch.float32).reshape(nb, QK, -1)  # [nb, 32, d]
        P = torch.bmm(xb, wb)  # exact int32 block sums [nb, T, d]
        return ((P * sw[:, None, :]) * sx_win.t()[:, :, None]).sum(dim=0)

    lo = part(xq[:, :half], qs & 0xF, scales[:nb], sx[:, :nb])
    hi = part(xq[:, half:], qs >> 4, scales[nb:], sx[:, nb:])
    return lo + hi


def q40_int8_ordered_plain(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel in the kernel's own f32
    order, which both its tiles follow bit for bit: block b (of each half)
    belongs to slice b % 16; within a slice the blocks run in increasing
    b, each adding ``(P_lo * sw_lo) * sx_lo`` and then the high half's term
    to the slice's partial, every product and sum rounded on its own; the
    16 partials are then added in slice order, starting from 0. The block
    dots P are the exact f32 ``bmm`` of :func:`q40_int8_plain`; the slices
    run side by side."""
    T, n_pad = xq.shape
    half, nb = n_pad // 2, n_pad // 64
    d = qs.shape[1]

    def dots(x_win, nib):  # exact int32 block sums [nb, T, d]
        xb = x_win.to(torch.float32).reshape(T, nb, QK).transpose(0, 1)
        return torch.bmm(xb, nib.to(torch.float32).reshape(nb, QK, d))

    p_lo, p_hi = dots(xq[:, :half], qs & 0xF), dots(xq[:, half:], qs >> 4)
    sx_t = sx.t()[:, :, None]  # [n_pad/32, T, 1]
    acc = torch.zeros((K1_SLICES, T, d), dtype=torch.float32, device=xq.device)
    for b0 in range(0, nb, K1_SLICES):  # the step-th block of every slice
        s = min(K1_SLICES, nb - b0)
        lo = (p_lo[b0 : b0 + s] * scales[b0 : b0 + s, None, :]) * sx_t[b0 : b0 + s]
        acc[:s] = acc[:s] + lo
        hi = (p_hi[b0 : b0 + s] * scales[nb + b0 : nb + b0 + s, None, :]) * sx_t[nb + b0 : nb + b0 + s]
        acc[:s] = acc[:s] + hi
    out = torch.zeros((T, d), dtype=torch.float32, device=xq.device)
    for k in range(K1_SLICES):
        out = out + acc[k]
    return out


def k1_tile(T: int) -> str:
    """The K1 tile that :func:`q40_int8` launches for T rows."""
    return "mma" if T >= K1_MMA_MIN_T else "dp4a"


# K1's decode tile (csrc/q40_int8_decode.cuh) at T = 1: its plans, (rows of
# a block a ring piece, ring stages), indexed by the C entry point's `plan`.
# Their shared memory lets 1, 1, 3 and 4 CTAs share an SM
K1_PLANS = ((32, 4), (8, 8), (8, 4), (8, 3))
K1_COLS = 64  # output columns of a decode tile's CTA
H100_SMS = 132


def k1_plan(n_pad: int, d_pad: int) -> int:
    """The plan of K1's decode tile for a [n_pad/2, d_pad] pack: whole
    blocks in 4 stages (the most bytes in flight on each SM) while d leaves
    at most 80 tiles of 64 columns and a slice has more than one block;
    8-row pieces in 8 stages up to a tile per SM (and for one block a
    slice, whose 8-row pieces overlap its only step); then 8-row pieces in
    4 or 3 stages, 3 or 4 CTAs an SM, so that every tile is resident at
    once. Every plan computes the same bits; the rule picked the fastest
    plan, or one within 2% of it, at each T = 1 shape of the port (PERF.md,
    ``chip_smoke.py --k1``)."""
    tiles = d_pad // K1_COLS
    if tiles <= 80 and n_pad // 64 > K1_SLICES:
        return 0
    if tiles <= H100_SMS:
        return 1
    return 2 if tiles <= 3 * H100_SMS else 3


def _q40_int8_launch(xq, sx, qs, scales, tile: str, plan: int | None = None) -> torch.Tensor:
    """Launch K1's ``tile`` on checked CUDA operands (not counted: the
    wrapper counts; ``chip_smoke.py`` calls this to hold each tile, and at
    T = 1 each plan of the decode tile, against the plain version).
    ``plan``: an index of K1_PLANS, by default :func:`k1_plan`'s."""
    from distributed_llama_tpu_torch.ops import cuda_build

    T, n_pad = xq.shape
    d_pad = qs.shape[1]
    if plan is None:
        plan = k1_plan(n_pad, d_pad)
    fn = cuda_build.function("q40_int8")
    out = torch.empty((T, d_pad), dtype=torch.float32, device=qs.device)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    _check_launch(
        fn(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), scales.data_ptr(), out.data_ptr(),
           T, n_pad, d_pad, K1_TILES.index(tile), plan, stream),
        "q40_int8",
    )
    return out


def q40_int8(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Wrapper of the int8 kernel: out f32 [T, d_pad], before the +8 bias
    correction. CPU tensors take :func:`q40_int8_plain`; CUDA tensors
    launch ``csrc/q40_int8.cu`` (the tile :func:`k1_tile` picks) or
    raise."""
    T, n_pad = xq.shape
    d_pad = qs.shape[1]
    dev = qs.device
    _check("xq", xq, torch.int8, (T, n_pad), dev)
    _check("sx", sx, torch.float32, (T, n_pad // QK), dev)
    _check("qs", qs, torch.uint8, (n_pad // 2, d_pad), dev)
    _check("scales", scales, torch.float32, (n_pad // QK, d_pad), dev)
    if dev.type == "cpu":
        telemetry.note_kernel_path("q40_matmul", "plain")
        return q40_int8_plain(xq, sx, qs, scales)
    if dev.type != "cuda":
        raise ValueError(f"q40_int8: unsupported device {dev}")
    if n_pad % 64 or d_pad % 64:
        raise ValueError(f"q40_int8: n_pad {n_pad} and d_pad {d_pad} must be multiples of 64")
    tile = k1_tile(T)
    out = _q40_int8_launch(xq, sx, qs, scales, tile)
    launches["q40_int8"] += 1
    tile_launches[tile] += 1
    telemetry.note_kernel_path("q40_matmul", f"k1_{tile}")
    return out


# row block at which matmuls and row norms run, whatever the row count
ROW_BUCKET = 64


def _at_row_bucket(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a row-wise op on x [N, ...], run on consecutive
    ROW_BUCKET-row blocks of x, the last one zero-padded, and concatenated.
    The summation order of cuBLAS's matmul and of PyTorch's row reductions
    may depend on the row count; at one fixed shape a decode step (B rows),
    a verify window (B*T rows, also 64 or more) and a single-stream step
    all give each row the value of that row alone, so a speculative step
    computes what plain decode computes."""
    n = x.shape[0]
    if x.dim() != 2:
        return fn(x)
    pad = -n % ROW_BUCKET
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    if x.shape[0] == ROW_BUCKET:
        return fn(x)[:n]
    return torch.cat([fn(blk) for blk in x.split(ROW_BUCKET)])[:n]


def _true_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32 (no TF32): the bias correction is ~5x the output
    magnitude, so TF32 rounding would leak straight into the result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return _at_row_bucket(lambda x: x @ b, a)


def bias_correction(xq: torch.Tensor, sx: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """(sx * block sums of xq) @ scales in true f32, [T, d_pad]: the kernel
    output minus 8x this is the matmul of the dequantized Q80 activations
    (exactly the values the kernel consumed) with the unbiased weights."""
    T, n_pad = xq.shape
    qsum = xq.to(torch.float32).reshape(T, n_pad // QK, QK).sum(dim=-1)
    return _true_f32_matmul(sx * qsum, qm.scales)


def _int8_core(xq: torch.Tensor, sx: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """Kernel + bias epilogue on already-quantized Q80 activations, trimmed
    to the logical d."""
    out = q40_int8(xq, sx, qm.qs, qm.scales) - 8.0 * bias_correction(xq, sx, qm)
    return out[:, : qm.d] if qm.d_padded != qm.d else out


def _pad_to(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n_pad - x.shape[-1])) if x.shape[-1] != n_pad else x


def quantize_for(x: torch.Tensor, qm: QuantizedMatrix) -> tuple[torch.Tensor, torch.Tensor]:
    """Activations x [T, n] zero-padded to qm's input width and quantized to
    Q80: the (xq, sx) the int8 kernel takes for ``x @ qm``."""
    xq, sx = quantize_q80(_pad_to(x, qm.n_padded))
    return xq.contiguous(), sx.contiguous()


def _q40_matmul_int8(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    return _int8_core(*quantize_for(x, qm), qm)


# ---------------------------------------------------------------------------
# K3: bf16 dequantize-in-registers matmul (csrc/q40_dequant.cu)
# ---------------------------------------------------------------------------


def q40_dequant_plain(xb: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dequant kernel: dequantize biased
    nibbles x scale in ``xb``'s dtype (each product rounded to that dtype),
    then a matmul of ``xb`` with f32 accumulation. For bf16 the products
    of two bf16 values are exact in f32, so the f32 matmul of the upcast
    operands is bf16 products with f32 accumulation."""
    w = dequant_weights(qs, scales, xb.dtype)
    return _true_f32_matmul(xb.to(torch.float32), w.to(torch.float32))


def dequant_weights(qs: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weights the dequant kernel multiplies, [n_pad, d_pad] in
    ``dtype``: each biased nibble times its block scale rounded to
    ``dtype``, the product rounded to ``dtype`` once (for bf16 what the
    kernel's splice, HSUB2 and HMUL2 give bit for bit)."""
    nib = torch.cat([qs & 0xF, qs >> 4], dim=0).to(dtype)
    return nib * _block_rows(scales.to(dtype))


def q40_dequant(xb: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Wrapper of the dequant kernel: out f32 [T, d_pad], before the +8 bias
    correction. CPU tensors take :func:`q40_dequant_plain` in ``xb``'s
    dtype; CUDA tensors must be bf16 and launch ``csrc/q40_dequant.cu`` or
    raise."""
    T, n_pad = xb.shape
    d_pad = qs.shape[1]
    dev = qs.device
    _check("qs", qs, torch.uint8, (n_pad // 2, d_pad), dev)
    _check("scales", scales, torch.float32, (n_pad // QK, d_pad), dev)
    if dev.type == "cpu":
        _check("x", xb, xb.dtype, (T, n_pad), dev)
        telemetry.note_kernel_path("q40_matmul", "plain")
        return q40_dequant_plain(xb, qs, scales)
    if dev.type != "cuda":
        raise ValueError(f"q40_dequant: unsupported device {dev}")
    _check("x", xb, torch.bfloat16, (T, n_pad), dev)
    if n_pad % 64 or d_pad % 64:
        raise ValueError(f"q40_dequant: n_pad {n_pad} and d_pad {d_pad} must be multiples of 64")
    from distributed_llama_tpu_torch.ops import cuda_build

    fn = cuda_build.function("q40_dequant")
    out = torch.empty((T, d_pad), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_launch(
        fn(xb.data_ptr(), qs.data_ptr(), scales.data_ptr(), out.data_ptr(), T, n_pad, d_pad, stream),
        "q40_dequant",
    )
    launches["q40_dequant"] += 1
    telemetry.note_kernel_path("q40_matmul", "k3")
    return out


# the dequant path's compute dtype on the CPU: f32, as the JAX package's
# interpret mode computes; bf16 gives the card's arithmetic (all but the
# order of f32 sums), a CPU witness of a run on the card
CPU_DEQUANT_DTYPE = torch.float32


def _q40_matmul_f32(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """The dequant path: bf16 compute on the card, :data:`CPU_DEQUANT_DTYPE`
    on the CPU."""
    n_pad = qm.n_padded
    cdt = CPU_DEQUANT_DTYPE if qm.device.type == "cpu" else torch.bfloat16
    xb = _pad_to(x, n_pad).to(cdt).contiguous()
    out = q40_dequant(xb, qm.qs, qm.scales)
    # the block sums of bf16 values are not exact in f32, so they too run
    # at the fixed row block: a row's bits do not depend on the row count
    xsum = _at_row_bucket(lambda v: v.reshape(-1, n_pad // QK, QK).sum(dim=-1), xb.to(torch.float32))
    out = out - 8.0 * _true_f32_matmul(xsum, qm.scales)
    return out[:, : qm.d] if qm.d_padded != qm.d else out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _q40_matmul_fallback(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """f32 dequantize-then-matmul for matrices no kernel tiles (no Q80 step)."""
    telemetry.note_kernel_path("q40_matmul", "plain")
    w = (_nibbles(qm).to(torch.float32) - 8.0) * _block_rows(qm.scales)
    out = _true_f32_matmul(_pad_to(x, qm.n_padded).to(torch.float32), w)
    return out[:, : qm.d] if qm.d_padded != qm.d else out


def q40_matmul(x: torch.Tensor, qm: QuantizedMatrix, path: str = "int8") -> torch.Tensor:
    """y[T, d] = x[T, n] @ dequant(qm) in f32: the one Q40 matmul entry."""
    if path not in PATHS:
        raise ValueError(f"unknown q40 path {path!r}; expected one of {PATHS}")
    if not kernel_eligible(qm):
        return _q40_matmul_fallback(x, qm)
    if path == "int8":
        return _q40_matmul_int8(x, qm)
    return _q40_matmul_f32(x, qm)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalize over the last axis in f32, result in x.dtype — the one
    rmsnorm definition the fused entry below inlines."""
    def norm(xf):
        return weight.to(torch.float32) * (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))

    return _at_row_bucket(norm, x.to(torch.float32)).to(x.dtype)


def rmsnorm_q40_matmul(x: torch.Tensor, weight: torch.Tensor, qm: QuantizedMatrix,
                       eps: float = 1e-5, path: str = "int8") -> torch.Tensor:
    """y = rmsnorm(x, weight) @ dequant(qm): rmsnorm in f32 -> x.dtype ->
    bf16, then :func:`q40_matmul` (zero-pad -> Q80 on the int8 path), the
    op order of the JAX package's fused rmsnorm->Q80 entry, which is
    bit-identical to its unfused chain."""
    return q40_matmul(rmsnorm_ref(x, weight, eps).to(torch.bfloat16), qm, path)
