// The per-CTA tile of the Q40 x Q80 int8 matmul (K1), shared by
// q40_int8.cu (K1) and fused_matmul_ring.cu (K5), so that K5 reproduces
// K1's accumulation order by construction.
//
// One CTA owns 64 output columns and a tile of TT tokens. Its 256 threads
// are 16 column lanes (4 adjacent columns each, one 32-bit word per packed
// row) x 16 k-slices; slice s walks quant blocks s, s+16, ... of each half
// of the half-split pack and keeps an f32 partial per (token, column):
//
//   partial += ((float)dot(block) * sw[b, d]) * sx[t, b]
//
// low half then high half per block, each product and sum rounded as
// written (no fused multiply-add). tile_partials() leaves the partials in
// shared memory; after a __syncthreads(), tile_sum() adds a (token, column)
// element's 16 slice partials in slice order.
//
//   * a block's 32 packed rows are 32 independent 4-byte loads per thread
//     (16 lanes read 64 contiguous bytes of a row), all in flight at once;
//   * a 4x4 byte transpose (8 PRMTs) turns 4 rows x 4 columns into 4 column
//     words of 4 consecutive k, so the low and high nibbles each feed one
//     dp4a against a 4-byte word of the matching x window.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace q40tile {

constexpr int kColsPerCta = 64;
constexpr int kColLanes = kColsPerCta / 4;  // 16
constexpr int kSlices = 16;
constexpr int kThreads = kColLanes * kSlices;  // 256

template <int TT>
using Partials = float[kSlices][TT][kColsPerCta];

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

// Slice partials of output columns [col0, col0 + 64) for tokens
// [t0, t0 + nt) into `red`. Shapes: xq int8 [T, n_pad], sx f32
// [T, n_pad/32], qs uint8 [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad].
template <int TT>
__device__ __forceinline__ void tile_partials(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                                              const uint8_t* __restrict__ qs,
                                              const float* __restrict__ scales, int n_pad, int d_pad,
                                              int col0, int t0, int nt, Partials<TT>& red) {
  const int lane_c = threadIdx.x % kColLanes;
  const int slice = threadIdx.x / kColLanes;
  const int d0 = col0 + lane_c * 4;
  const int half = n_pad / 2;
  const int nb = half / 32;    // blocks per half
  const int nbx = n_pad / 32;  // Q80 scale columns

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
          acc[t][c] = __fadd_rn(acc[t][c], __fmul_rn(__fmul_rn((float)ilo[t][c], swl[c]), sxl));
          acc[t][c] = __fadd_rn(acc[t][c], __fmul_rn(__fmul_rn((float)ihi[t][c], swh[c]), sxh));
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[slice][t][lane_c * 4 + c] = acc[t][c];
}

// Output element (t, col) of the tile: the 16 slice partials in slice order.
template <int TT>
__device__ __forceinline__ float tile_sum(const Partials<TT>& red, int t, int col) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) s = __fadd_rn(s, red[k][t][col]);
  return s;
}

}  // namespace q40tile
