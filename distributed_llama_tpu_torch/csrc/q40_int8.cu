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
// What bounds it on an H100: at decode (T <= 8) the packed weight stream
// (half a byte per weight plus one f32 scale per 32 weights) over the
// 3.35 TB/s memory rate; the arithmetic is about one integer operation per
// weight byte and token. At a prefill of 64 tokens the dp4a arithmetic
// (no tensor cores yet) is the bound.
//
// Design: the TPU's sequential n-tile grid axis becomes a loop inside the
// CTA, one CTA per 64 output columns and TT tokens (q40_int8_tile.cuh,
// which K5 shares); nothing carries between CTAs.

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

}  // namespace

// C entry point, bound with ctypes. Shapes: xq int8 [T, n_pad], sx f32
// [T, n_pad/32], qs uint8 [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad],
// out f32 [T, d_pad]; n_pad % 64 == 0, d_pad % 64 == 0. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int q40_int8_matmul(const void* xq, const void* sx, const void* qs,
                               const void* scales, void* out, int T, int n_pad, int d_pad,
                               void* stream) {
  if (T <= 0 || n_pad % 64 || d_pad % kColsPerCta) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* q = static_cast<const uint8_t*>(qs);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  if (T == 1)
    launch<1>(x, sxp, q, sc, o, T, n_pad, d_pad, s);
  else if (T <= 4)
    launch<4>(x, sxp, q, sc, o, T, n_pad, d_pad, s);
  else
    launch<8>(x, sxp, q, sc, o, T, n_pad, d_pad, s);
  return (int)cudaGetLastError();
}
