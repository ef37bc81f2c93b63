// K1's tensor-core tile: the Q40 x Q80 int8 matmul for T >= 2 token rows
// on Hopper's int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), with
// every output element bit-identical to what the dp4a tile
// (q40_int8_tile.cuh) computes for that row.
//
// The contract both tiles keep, per output element (t, d): block b of each
// half belongs to slice b % 16; within a slice the blocks run in increasing
// b, each adding
//
//   acc = acc + (float(dot_lo) * sw_lo) * sx_lo,  then the high half alike
//
// with every product and sum rounded as written (no FMA); the 16 slice
// partials are then added in slice order, starting from 0. A block dot is
// an exact int32, so any instruction that yields it exactly keeps the
// contract. Both tiles keep the 16 partials apart and add them at the end.
//
// What bounds it on an H100: at verify widths the packed weight stream,
// which this tile reads once for up to 32 rows (the dp4a tile read it once
// per 8 rows); from a few hundred rows the per-block f32 epilogue (3 f32
// operations per row x column x block half), which the tensor cores cannot
// take. Measured (PERF.md) it stays at 2-5x that bound: the epilogue and
// the fragment building issue about one instruction a cycle per SM.
//
// Design: the dp4a tile's shape with the tensor cores doing the dots. A
// CTA owns 32 output columns and 8, 16, 24 or 32 token rows, and has 16
// warps, one per slice (8 warps of two slices each at 32 rows, for their
// registers): warp s walks blocks s, s + 16, ... with no barrier, its
// partial in registers, and the CTA adds the 16 partials in slice order
// through shared memory at the end. More rows take more token tiles, each
// reading the weights again (from L2 when the tiles run together). The weights take the mma's A side
// (M = 16 columns), the tokens its B side (N = 8 rows), so a tile pads the
// rows to a multiple of 8, not 16. Per block a lane loads its 8 words of
// the packed block straight into registers (rows 4 tig + j and 16 + 4 tig
// + j at columns 4 g .. 4 g + 3), one block ahead of the one it computes;
// the 4x4 byte transpose of the dp4a tile turns them into 4 consecutive k
// of columns 4 g .. 4 g + 3, and the low and high nibbles are the two
// halves' A fragments: m tile p's row g is column 4 g + 2 p and its row
// g + 8 column 4 g + 2 p + 1, so every transposed word is used. A B
// fragment is two 4-byte loads of a token's x window. The mma's
// accumulator input is the int bits of 1.5 * 2^23: D read as a float is
// then 12582912 + dot exactly (|dot| <= 32 * 127 * 15 < 2^22), and one
// exact f32 subtraction gives float(dot) without an int-to-float
// conversion. A lane's accumulators are columns 4 g .. 4 g + 3 of tokens
// 2 tig and 2 tig + 1 of each 8-row n tile.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "q40_int8_tile.cuh"

namespace q40mma {

using q40tile::transpose4x4;

constexpr int kSlices = q40tile::kSlices;
constexpr int kCols = 32;                 // output columns per CTA
// the mma accumulator input: the int bits of 12582912.0f = 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.0f;

// shared memory of a CTA of NT 8-row n tiles: the 16 slice partials
template <int NT>
constexpr int smem_bytes() {
  return kSlices * 8 * NT * kCols * 4;
}

// d = magic + a (16 x 32, s8) . b (32 x 8, s8), exact in int32
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(kMagicBits), "r"(kMagicBits),
        "r"(kMagicBits), "r"(kMagicBits));
}

// a lane's 8 words of packed block b: rows 16 kg + 4 tig + j, columns
// col0 + 4 g .. + 3
__device__ __forceinline__ void load_block(const uint8_t* __restrict__ qs, int d_pad, int col0, int b, int g,
                                           int tig, uint32_t (&w)[2][4]) {
  const uint8_t* p = qs + (size_t)(b * 32 + 4 * tig) * d_pad + col0 + 4 * g;
#pragma unroll
  for (int kg = 0; kg < 2; ++kg)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[kg][j] = __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)(16 * kg + j) * d_pad));
}

// n tile ni's token loads for block b, half h: token g's two x words (B)
// and the Q80 scales of tokens 2 tig + tt
__device__ __forceinline__ void load_tokens(const int8_t* xg, const int (&trow)[2], const float* __restrict__ sx,
                                            int nb, int nbx, int b, int h, uint32_t (&xb)[2], float (&sxv)[2]) {
  const int8_t* xr = xg + (h * nb + b) * 32;
  xb[0] = __ldg(reinterpret_cast<const uint32_t*>(xr));
  xb[1] = __ldg(reinterpret_cast<const uint32_t*>(xr + 16));
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) sxv[tt] = __ldg(sx + (size_t)trow[tt] * nbx + h * nb + b);
}

// one half of one block against one n tile: the two m tiles' mmas and
// their epilogue into the n tile's accumulators (m tile p: row g = column
// 4 g + 2 p, row g + 8 = column 4 g + 2 p + 1)
__device__ __forceinline__ void half_tile(const uint32_t (&a)[2][4], const uint32_t (&xb)[2], const float (&sxv)[2],
                                          const float4& swv, float (&acc)[2][4]) {
  const float sw[4] = {swv.x, swv.y, swv.z, swv.w};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int d[4];
    mma_s8(d, a[0][2 * p], a[0][2 * p + 1], a[1][2 * p], a[1][2 * p + 1], xb[0], xb[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = 2 * p + (e >> 1), tt = e & 1;
      const float dot = __fsub_rn(__int_as_float(d[e]), kMagic);
      acc[tt][cc] = __fadd_rn(acc[tt][cc], __fmul_rn(__fmul_rn(dot, sw[cc]), sxv[tt]));
    }
  }
}

// one slice's partial of a lane's accumulators: blocks slice, slice + 16,
// ... of the packed matrix, low half then high half for every element, the
// lane's weight words loaded one block ahead of the one it computes. With
// NT <= 2 every n tile's token loads are issued at the top of a block;
// wider tiles load each n tile's just before its mmas, to stay within the
// registers. Rows past nt are clamped to a real row: they compute what is
// never stored.
template <int NT>
__device__ __forceinline__ void slice_partial(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                                              const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                                              int T, int n_pad, int d_pad, int col0, int t0, int nt, int slice,
                                              float (&acc)[NT][2][4]) {
  constexpr bool kHoist = NT <= 2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int nb = n_pad / 64;  // blocks per half
  const int nbx = n_pad / 32;
  // this lane's token rows: 2 tig + tt of each n tile (Q80 scales) and
  // token g (x windows, the B fragments)
  int trow[NT][2];
  const int8_t* xg[NT];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) trow[ni][tt] = min(t0 + 8 * ni + 2 * tig + tt, T - 1);
    xg[ni] = xq + (size_t)min(t0 + 8 * ni + g, T - 1) * n_pad + 4 * tig;
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[ni][tt][cc] = 0.f;

  uint32_t wn[2][4];
  if (slice < nb) load_block(qs, d_pad, col0, slice, g, tig, wn);
#pragma unroll 1
  for (int b = slice; b < nb; b += kSlices) {
    uint32_t w[2][4];
#pragma unroll
    for (int kg = 0; kg < 2; ++kg)
#pragma unroll
      for (int j = 0; j < 4; ++j) w[kg][j] = wn[kg][j];
    if (b + kSlices < nb) load_block(qs, d_pad, col0, b + kSlices, g, tig, wn);  // one block ahead
    // B: token g's x windows; the Q80 scales of tokens 2 tig + tt
    uint32_t xb[NT][2][2];
    float sxv[NT][2][2];
    if (kHoist) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) load_tokens(xg[ni], trow[ni], sx, nb, nbx, b, h, xb[ni][h], sxv[ni][h]);
    }
    float4 swv[2];  // the weight scales of this lane's columns, low and high half
#pragma unroll
    for (int h = 0; h < 2; ++h)
      swv[h] = __ldg(reinterpret_cast<const float4*>(scales + (size_t)(h * nb + b) * d_pad + col0 + 4 * g));
    // A: column words of 4 consecutive k, low and high nibbles apart
    uint32_t a[2][2][4];  // [half][kg][column 4 g + c]
#pragma unroll
    for (int kg = 0; kg < 2; ++kg) {
      uint32_t c[4];
      transpose4x4(w[kg][0], w[kg][1], w[kg][2], w[kg][3], c[0], c[1], c[2], c[3]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        a[0][kg][cc] = c[cc] & 0x0F0F0F0Fu;
        a[1][kg][cc] = (c[cc] >> 4) & 0x0F0F0F0Fu;
      }
    }
    // every element takes the low half, then the high half; the order over
    // halves and n tiles is the one each width runs fastest
    if (kHoist) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 s4 = swv[h];
        const float sw[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          if (8 * ni >= nt) break;  // CTA-uniform: no row in this n tile
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            int d[4];
            mma_s8(d, a[h][0][2 * p], a[h][0][2 * p + 1], a[h][1][2 * p], a[h][1][2 * p + 1], xb[ni][h][0],
                   xb[ni][h][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cc = 2 * p + (e >> 1), tt = e & 1;
              const float dot = __fsub_rn(__int_as_float(d[e]), kMagic);
              acc[ni][tt][cc] = __fadd_rn(acc[ni][tt][cc], __fmul_rn(__fmul_rn(dot, sw[cc]), sxv[ni][h][tt]));
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        if (ni > 0 && 8 * ni >= nt) break;  // CTA-uniform: no row in this n tile
#pragma unroll
        for (int h = 0; h < 2; ++h) load_tokens(xg[ni], trow[ni], sx, nb, nbx, b, h, xb[ni][h], sxv[ni][h]);
#pragma unroll
        for (int h = 0; h < 2; ++h) half_tile(a[h], xb[ni][h], sxv[ni][h], swv[h], acc[ni]);
      }
    }
  }
}

// out[t0 + t, col0 + c] for t < nt (<= 8 NT), c < 32, with `part` the
// CTA's smem_bytes<NT>() of shared memory: warp w takes slices w, w + 16 /
// SPW, ..., leaves each partial in shared memory, and each (token, column)
// then adds the 16 partials in slice order. Shapes as
// q40tile::tile_partials; out f32 [T, d_pad].
template <int NT, int SPW>
__device__ __forceinline__ void mma_tile(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                                         const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                                         float* __restrict__ out, int T, int n_pad, int d_pad, int col0,
                                         int t0, int nt, float* part) {
  constexpr int kWarps = kSlices / SPW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  auto slice_to_smem = [&](int slice) {
    float acc[NT][2][4];  // [n tile][token 2 tig + tt][column 4 g + cc]
    slice_partial<NT>(xq, sx, qs, scales, T, n_pad, d_pad, col0, t0, nt, slice, acc);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
        *reinterpret_cast<float4*>(part + ((size_t)slice * 8 * NT + 8 * ni + 2 * tig + tt) * kCols + 4 * g) =
            make_float4(acc[ni][tt][0], acc[ni][tt][1], acc[ni][tt][2], acc[ni][tt][3]);
  };
  if (SPW == 1) {
    slice_to_smem(warp);
  } else {
#pragma unroll 1
    for (int sp = 0; sp < SPW; ++sp) slice_to_smem(warp + kWarps * sp);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nt * kCols; e += kWarps * 32) {
    float tot = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) tot = __fadd_rn(tot, part[(size_t)s * 8 * NT * kCols + e]);
    out[(size_t)(t0 + e / kCols) * d_pad + col0 + e % kCols] = tot;
  }
}

}  // namespace q40mma
