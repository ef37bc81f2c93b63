// Q40 x Q80 int8 matmul for Hopper (sm_90a).
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
// Design:
//   * one CTA owns 64 output columns and a tile of TT tokens; the TPU's
//     sequential n-tile grid axis becomes a loop inside the CTA. The 256
//     threads are 16 column lanes (4 adjacent columns each, one 32-bit word
//     per packed row) x 16 k-slices; slice s walks blocks s, s+16, ... and
//     the slices' f32 partials are summed through shared memory at the end.
//     Nothing carries between CTAs.
//   * a block's 32 packed rows are 32 independent 4-byte loads per thread
//     (16 lanes read 64 contiguous bytes of a row), all in flight at once;
//   * a 4x4 byte transpose (8 PRMTs) turns 4 rows x 4 columns into 4
//     column words of 4 consecutive k, so the low and high nibbles each feed
//     one dp4a against a 4-byte word of the matching x window;
//   * the per-block epilogue folds sx[t,b] * sw[b,d] into the f32 sum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kColsPerCta = 64;
constexpr int kColLanes = kColsPerCta / 4;  // 16
constexpr int kSlices = 16;
constexpr int kThreads = kColLanes * kSlices;  // 256

__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                             uint32_t& c3) {
  // r_i byte j = (row i, column j)  ->  c_j byte i = (row i, column j)
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c0 = __byte_perm(t0, t2, 0x5410);
  c1 = __byte_perm(t0, t2, 0x7632);
  c2 = __byte_perm(t1, t3, 0x5410);
  c3 = __byte_perm(t1, t3, 0x7632);
}

template <int TT>
__global__ void __launch_bounds__(kThreads)
q40_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                float* __restrict__ out, int T, int n_pad, int d_pad) {
  __shared__ float red[kSlices][TT][kColsPerCta];

  const int lane_c = threadIdx.x % kColLanes;
  const int slice = threadIdx.x / kColLanes;
  const int d0 = blockIdx.x * kColsPerCta + lane_c * 4;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const int half = n_pad / 2;
  const int nb = half / 32;          // blocks per half
  const int nbx = n_pad / 32;        // Q80 scale columns

  float acc[TT][4];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;

  for (int b = slice; b < nb; b += kSlices) {
    uint32_t w[32];
    const uint8_t* qrow = qs + (size_t)(b * 32) * d_pad + d0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(qrow + (size_t)i * d_pad));
    const float4 slo = __ldg(reinterpret_cast<const float4*>(scales + (size_t)b * d_pad + d0));
    const float4 shi =
        __ldg(reinterpret_cast<const float4*>(scales + (size_t)(nb + b) * d_pad + d0));

    int ilo[TT][4], ihi[TT][4];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) ilo[t][c] = ihi[t][c] = 0;

#pragma unroll
    for (int g = 0; g < 8; ++g) {
      uint32_t col[4];
      transpose4x4(w[4 * g], w[4 * g + 1], w[4 * g + 2], w[4 * g + 3], col[0], col[1], col[2],
                   col[3]);
      int wl[4], wh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wl[c] = (int)(col[c] & 0x0F0F0F0Fu);
        wh[c] = (int)((col[c] >> 4) & 0x0F0F0F0Fu);
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t < nt) {
          const int8_t* xr = xq + (size_t)(t0 + t) * n_pad + b * 32 + 4 * g;
          const int xl = __ldg(reinterpret_cast<const int*>(xr));
          const int xh = __ldg(reinterpret_cast<const int*>(xr + half));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ilo[t][c] = __dp4a(xl, wl[c], ilo[t][c]);
            ihi[t][c] = __dp4a(xh, wh[c], ihi[t][c]);
          }
        }
      }
    }

    const float swl[4] = {slo.x, slo.y, slo.z, slo.w};
    const float swh[4] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t < nt) {
        const float sxl = __ldg(sx + (size_t)(t0 + t) * nbx + b);
        const float sxh = __ldg(sx + (size_t)(t0 + t) * nbx + nb + b);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[t][c] += (float)ilo[t][c] * swl[c] * sxl;
          acc[t][c] += (float)ihi[t][c] * swh[c] * sxh;
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[slice][t][lane_c * 4 + c] = acc[t][c];
  __syncthreads();

  for (int e = threadIdx.x; e < TT * kColsPerCta; e += kThreads) {
    const int t = e / kColsPerCta;
    const int col = e % kColsPerCta;
    if (t < nt) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kSlices; ++k) s += red[k][t][col];
      out[(size_t)(t0 + t) * d_pad + blockIdx.x * kColsPerCta + col] = s;
    }
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
