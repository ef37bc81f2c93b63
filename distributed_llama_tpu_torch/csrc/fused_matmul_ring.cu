// The int8 Q40 x Q80 matmul fused into the all-reduce, for Hopper (sm_90a), K5.
//
// Replaces the Pallas TPU kernel distributed_llama_tpu/ops/collectives.py
// `_make_fused_matmul_ring_kernel` (launched by
// `fused_matmul_ring_all_reduce`), the wo/down projection of a
// tensor-parallel layer in decode: for each rank r,
//
//   y_r = K1(xq_r, sx_r, qs_r, scales_r) - 8 corr_r
//
// all-reduced with K4's association (chunk k of the 2n chunks of width
// w = d_pad / 2n is the left fold over the ranks c, c+1, ... for even k and
// c, c-1, ... for odd k, c = k / 2), and no y_r is ever written to device
// memory. The TPU kernel computes each chunk's matmul on demand inside its
// ring walk so the next chunk's MXU work overlaps the remote copies; here
// the ranks share one card, so the fusion keeps the n products in
// registers and shared memory and saves the launches and the [T, d] round
// trips between K1, the correction and K4.
//
// Fused equals unfused, bit for bit: one CTA owns 64 output columns (one
// K1 tile, inside one chunk since w is a multiple of 64) and TT tokens and,
// for each rank in its chunk's fold order, runs K1's own tile code
// (q40_int8_tile.cuh), sums the slices in K1's order, subtracts 8 corr_r
// and adds the result into the fold with __fadd_rn. corr_r is an input,
// the same (sx * qsum) @ scales that the unfused path computes with
// cuBLAS in true f32: the JAX kernel computes it inside, at HIGHEST
// precision, but cuBLAS's summation order cannot be reproduced inside a
// kernel, and any other order would break the bit equality.
//
// What bounds it on an H100: at T <= 8 the n ranks' packed weight streams,
// i.e. the whole matrix's Q40 bytes, over 3.35 TB/s (as K1's bound); each
// CTA walks its n tiles one after another.

#include "q40_int8_tile.cuh"

namespace {

using namespace q40tile;

constexpr int kMaxRanks = 8;

struct Ranks {
  const void* p[kMaxRanks];
};
struct OutRanks {
  float* p[kMaxRanks];
};

template <int TT>
__global__ void __launch_bounds__(kThreads)
fused_matmul_ring_kernel(Ranks xq, Ranks sx, Ranks qs, Ranks scales, Ranks corr, OutRanks out, int n,
                         int T, int n_pad, int d_pad, int w) {
  __shared__ Partials<TT> red;
  constexpr int kPer = (TT * kColsPerCta + kThreads - 1) / kThreads;  // elements per thread
  const int col0 = blockIdx.x * kColsPerCta;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const int k = col0 / w;
  const int c = k >> 1;
  const int step = (k & 1) ? n - 1 : 1;  // counter-clockwise: c - i == c + (n-1) i (mod n)
  float total[kPer] = {};
  for (int i = 0; i < n; ++i) {
    const int r = (c + step * i) % n;
    tile_partials<TT>(static_cast<const int8_t*>(xq.p[r]), static_cast<const float*>(sx.p[r]),
                      static_cast<const uint8_t*>(qs.p[r]), static_cast<const float*>(scales.p[r]),
                      n_pad, d_pad, col0, t0, nt, red);
    __syncthreads();
    const float* cr = static_cast<const float*>(corr.p[r]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int t = e / kColsPerCta;
      const int col = e % kColsPerCta;
      if (e < TT * kColsPerCta && t < nt) {
        const float y = __fsub_rn(tile_sum<TT>(red, t, col),
                                  __fmul_rn(8.0f, cr[(size_t)(t0 + t) * d_pad + col0 + col]));
        total[j] = i == 0 ? y : __fadd_rn(total[j], y);
      }
    }
    __syncthreads();  // the next rank's tile rewrites `red`
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int t = e / kColsPerCta;
    const int col = e % kColsPerCta;
    if (e < TT * kColsPerCta && t < nt)
      for (int r = 0; r < n; ++r) out.p[r][(size_t)(t0 + t) * d_pad + col0 + col] = total[j];
  }
}

template <int TT>
void launch(const Ranks& xq, const Ranks& sx, const Ranks& qs, const Ranks& scales, const Ranks& corr,
            const OutRanks& out, int n, int T, int n_pad, int d_pad, cudaStream_t stream) {
  dim3 grid(d_pad / kColsPerCta, (T + TT - 1) / TT);
  fused_matmul_ring_kernel<TT><<<grid, kThreads, 0, stream>>>(xq, sx, qs, scales, corr, out, n, T, n_pad,
                                                              d_pad, d_pad / (2 * n));
}

}  // namespace

// C entry point, bound with ctypes. Each pointer argument is a host array of
// n device pointers, one per rank: xq int8 [T, n_pad], sx f32 [T, n_pad/32],
// qs uint8 [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad], corr f32
// [T, d_pad], outs f32 [T, d_pad]; 1 <= n <= 8, 1 <= T <= 8,
// n_pad % 64 == 0, d_pad % (2 n 64) == 0. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int fused_matmul_ring(const void* const* xq, const void* const* sx, const void* const* qs,
                                 const void* const* scales, const void* const* corr, void* const* outs,
                                 int n, int T, int n_pad, int d_pad, void* stream) {
  if (n < 1 || n > kMaxRanks || T < 1 || T > 8 || n_pad % 64 || d_pad % (2 * n * kColsPerCta))
    return (int)cudaErrorInvalidValue;
  Ranks rx{}, rsx{}, rqs{}, rsc{}, rc{};
  OutRanks ro{};
  for (int r = 0; r < n; ++r) {
    rx.p[r] = xq[r];
    rsx.p[r] = sx[r];
    rqs.p[r] = qs[r];
    rsc.p[r] = scales[r];
    rc.p[r] = corr[r];
    ro.p[r] = static_cast<float*>(outs[r]);
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (T == 1)
    launch<1>(rx, rsx, rqs, rsc, rc, ro, n, T, n_pad, d_pad, s);
  else if (T <= 4)
    launch<4>(rx, rsx, rqs, rsc, rc, ro, n, T, n_pad, d_pad, s);
  else
    launch<8>(rx, rsx, rqs, rsc, rc, ro, n, T, n_pad, d_pad, s);
  return (int)cudaGetLastError();
}
