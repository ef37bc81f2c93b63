// Q40 x Q80 int8 matmul for Hopper (sm_90a), K1.
//
// Replaces the Pallas TPU kernel distributed_llama_tpu/ops/q40.py
// `_make_q40_int8_kernel` (launched by `_int8_core`). It computes, for
// activations already quantized to Q80,
//
//   out[t, d] = sum_b sx[t, b] * sw[b, d] * sum_{i in block b} xq[t, i] * nib[i, d]
//
// over BIASED nibbles (0..15) of the half-split pack: packed row r of `qs`
// holds logical row r in its low nibble and row n_pad/2 + r in its high
// nibble, so one byte feeds two 32-deep blocks (b and NB + b, NB = n_pad/64)
// against two contiguous windows of x. Each block dot is exact in int32;
// the scale product and the f32 sum stay in registers. The caller subtracts
// the +8 bias as 8 * ((sx * qsum) @ scales) in full f32, as the JAX package
// does.
//
// Two tiles compute this function, every output element bit for bit alike
// (the order of f32 roundings in q40_int8_mma.cuh), so the caller chooses by
// speed alone:
//
// * tile 0, dp4a: at decode (T = 1) the decode tile (q40_int8_decode.cuh):
//   the packed weight stream (half a byte per weight plus one f32 scale per
//   32 weights) over the 3.35 TB/s memory rate bounds it; each CTA streams
//   its 64 columns' blocks through a cp.async ring in shared memory, in
//   pieces and stages that the host's `plan` sets per shape. Above one row,
//   q40_int8_tile.cuh (which K5 shares): the TPU's sequential n-tile grid
//   axis becomes a loop inside the CTA, one CTA per 64 output columns and
//   TT <= 8 tokens; nothing carries between CTAs.
// * tile 1, mma (q40_int8_mma.cuh): T >= 2 rows on the int8 tensor cores,
//   one CTA of 16 slice warps per 32 output columns and up to 32 tokens,
//   so a verify window reads the weights once; the weight stream bounds it
//   at verify widths, the per-block f32 epilogue from a few hundred rows.

#include "q40_int8_decode.cuh"
#include "q40_int8_mma.cuh"
#include "q40_int8_tile.cuh"

namespace {

using namespace q40tile;

template <int TT>
__global__ void __launch_bounds__(kThreads)
q40_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                float* __restrict__ out, int T, int n_pad, int d_pad) {
  __shared__ Partials<TT> red;
  const int col0 = blockIdx.x * kColsPerCta;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  tile_partials<TT>(xq, sx, qs, scales, n_pad, d_pad, col0, t0, nt, red);
  __syncthreads();
  for (int e = threadIdx.x; e < TT * kColsPerCta; e += kThreads) {
    const int t = e / kColsPerCta;
    const int col = e % kColsPerCta;
    if (t < nt) out[(size_t)(t0 + t) * d_pad + col0 + col] = tile_sum<TT>(red, t, col);
  }
}

template <int TT>
void launch(const int8_t* xq, const float* sx, const uint8_t* qs, const float* scales,
            float* out, int T, int n_pad, int d_pad, cudaStream_t stream) {
  dim3 grid(d_pad / kColsPerCta, (T + TT - 1) / TT);
  q40_int8_kernel<TT><<<grid, kThreads, 0, stream>>>(xq, sx, qs, scales, out, T, n_pad, d_pad);
}

// 8-row tiles run two CTAs an SM (64 registers a thread), faster than one
template <int NT, int SPW>
__global__ void __launch_bounds__(32 * q40mma::kSlices / SPW, NT == 1 ? 2 : 1)
q40_int8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                    float* __restrict__ out, int T, int n_pad, int d_pad) {
  extern __shared__ __align__(16) float part[];
  // token tiles fastest: the CTAs that share a column tile's weights run together
  const int t0 = blockIdx.x * 8 * NT;
  q40mma::mma_tile<NT, SPW>(xq, sx, qs, scales, out, T, n_pad, d_pad, blockIdx.y * q40mma::kCols, t0,
                            min(8 * NT, T - t0), part);
}

template <int NT, int SPW>
int launch_mma(const int8_t* xq, const float* sx, const uint8_t* qs, const float* scales, float* out, int T,
               int n_pad, int d_pad, cudaStream_t stream) {
  constexpr int bytes = q40mma::smem_bytes<NT>();
  static bool configured = false;  // the opt-in above 48 KB, set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(q40_int8_mma_kernel<NT, SPW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((T + 8 * NT - 1) / (8 * NT), d_pad / q40mma::kCols);
  q40_int8_mma_kernel<NT, SPW><<<grid, 32 * q40mma::kSlices / SPW, bytes, stream>>>(xq, sx, qs, scales, out, T,
                                                                                  n_pad, d_pad);
  return 0;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// C entry point, bound with ctypes. Shapes: xq int8 [T, n_pad], sx f32
// [T, n_pad/32], qs uint8 [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad],
// out f32 [T, d_pad]; n_pad % 64 == 0, d_pad % 64 == 0. tile 0 runs the dp4a
// tile (at T = 1 the decode tile with `plan` 0-3; xq, qs and scales 16-byte
// aligned), tile 1 the tensor-core tile (scales 16-byte aligned); `plan` is
// read at T = 1 on tile 0 only.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int q40_int8_matmul(const void* xq, const void* sx, const void* qs,
                               const void* scales, void* out, int T, int n_pad, int d_pad, int tile,
                               int plan, void* stream) {
  if (T <= 0 || n_pad % 64 || d_pad % kColsPerCta || (tile != 0 && tile != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* q = static_cast<const uint8_t*>(qs);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  if (tile == 1) {
    if (misaligned(scales)) return (int)cudaErrorMisalignedAddress;
    // 8, 16 or 24 rows in one tile, a warp per slice; wider in tiles of
    // 32 rows, a warp per two slices (the registers of 32 rows)
    const int err = T <= 8    ? launch_mma<1, 1>(x, sxp, q, sc, o, T, n_pad, d_pad, s)
                    : T <= 16 ? launch_mma<2, 1>(x, sxp, q, sc, o, T, n_pad, d_pad, s)
                    : T <= 24 ? launch_mma<3, 1>(x, sxp, q, sc, o, T, n_pad, d_pad, s)
                              : launch_mma<4, 2>(x, sxp, q, sc, o, T, n_pad, d_pad, s);
    if (err != 0) return err;
  } else if (T == 1) {
    if (misaligned(xq) || misaligned(qs) || misaligned(scales)) return (int)cudaErrorMisalignedAddress;
    // the plans of ops/q40.py K1_PLANS: (rows a piece, ring stages)
    const int err = plan == 0   ? q40dec::launch<32, 4>(x, sxp, q, sc, o, n_pad, d_pad, s)
                    : plan == 1 ? q40dec::launch<8, 8>(x, sxp, q, sc, o, n_pad, d_pad, s)
                    : plan == 2 ? q40dec::launch<8, 4>(x, sxp, q, sc, o, n_pad, d_pad, s)
                    : plan == 3 ? q40dec::launch<8, 3>(x, sxp, q, sc, o, n_pad, d_pad, s)
                                : (int)cudaErrorInvalidValue;
    if (err != 0) return err;
  } else if (T <= 4) {
    launch<4>(x, sxp, q, sc, o, T, n_pad, d_pad, s);
  } else {
    launch<8>(x, sxp, q, sc, o, T, n_pad, d_pad, s);
  }
  return (int)cudaGetLastError();
}
