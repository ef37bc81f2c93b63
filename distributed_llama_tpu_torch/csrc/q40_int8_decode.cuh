// K1's decode tile: the Q40 x Q80 int8 matmul for one token row (T = 1:
// every decoded token of the CLI, every server step with one live row) on
// Hopper, every output element bit-identical to what the dp4a tile
// (q40_int8_tile.cuh) and the tensor-core tile (q40_int8_mma.cuh) compute
// for that row.
//
// The contract (q40_int8_mma.cuh states it in full): block b of each half
// belongs to slice b % 16; within a slice the blocks run in increasing b,
// acc = acc + (float(dot_lo) * sw_lo) * sx_lo, then the high half alike,
// every product and sum rounded as written; the 16 slice partials are then
// added in slice order, starting from 0. A block dot is an exact int32, so
// how its rows are split up and summed is free; the f32 order is not.
//
// What bounds it on an H100: the packed weight stream, half a byte per
// weight and one f32 scale per 32 weights, over the 3.35 TB/s memory rate.
// The dp4a tile, which ran T = 1 until this tile, kept too few bytes in
// flight: each of its slices issued a block's loads only after the previous
// block's arithmetic, one memory round trip per block, so a long-K matrix
// (down: 11 blocks a slice) paid some 11 round trips a launch, and at
// d = 4096 its 64 CTAs held some 32 KB in flight each.
//
// Design: one CTA per 64 output columns, one thread per (slice, column
// lane of 4 columns), as in the dp4a tile; the blocks stream through a
// ring of S stages in shared memory fed by 16-byte cp.async copies. A block
// arrives in 32 / RS pieces of RS packed rows (with the two x windows of
// those rows; its weight scales and Q80 scales come with its last piece),
// and a stage holds the same piece of the 16 blocks of one step (block
// 16 j + s for slice s at step j). S - 1 stages are in flight while one is
// computed, so a CTA pays the memory latency about once per launch. A slice
// thread dots its lane's 4 columns of each piece into exact int32 sums (the
// 4x4 byte transpose, dp4a on the low nibbles, and on the high nibbles in
// place, which gives 16 times their dot for one AND a word less) and, after
// a block's last piece, runs the f32 epilogue into its partial in
// registers; at the end the CTA adds each column's 16 partials in slice
// order through shared memory. The weight copies ask the L2 for the whole
// 128-byte line, of which the next tile's CTA reads the other half. The host
// picks (RS, S) per shape (ops/q40.py k1_plan): whole blocks in 4 stages,
// about 130 KB in flight on each SM, where d leaves at most 80 tiles and a
// slice has several blocks; 8-row pieces in 8 stages up to a tile per SM;
// then 8-row pieces in 4 stages (3 CTAs an SM) up to 3 tiles per SM, and in
// 3 stages (4 CTAs an SM) beyond.
//
// Measured across the port's T = 1 shapes on an H100 (PERF.md, chip_smoke.py
// --k1), this beat three other shapes of the same ring: a tile's slices
// split over a cluster of 2-8 CTAs and folded through distributed shared
// memory (the extra SMs gained nothing, the cluster barriers cost up to
// 1.5 us), 32-column tiles (twice the CTAs), and four threads sharing a
// block (four times the warps, a third more instructions).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "q40_int8_tile.cuh"

namespace q40dec {

using q40tile::transpose4x4;

constexpr int kCols = 64;          // output columns per tile
constexpr int kLanes = kCols / 4;  // column lanes of 4 columns
constexpr int kSlices = 16;
constexpr int kThreads = kLanes * kSlices;  // 256

// words of one block's piece before its padding
template <int RS>
constexpr int piece_words() { return 2 * kCols + RS * kLanes + RS / 2 + 4; }

// one block's rows [u RS, u RS + RS) in a ring stage, with the block's
// weight scales and Q80 scales beside its last piece; padded to 16 words
// more than a multiple of 32, so that the two slices of a warp read their
// words from different banks
template <int RS>
struct Piece {
  float4 sw[2][kLanes];      // weight scales, low and high half
  uint32_t w[RS * kLanes];   // packed row u RS + r, lane l at w[r * 16 + l]
  uint32_t x[2][RS / 4];     // the low and high x windows of these rows
  float sx[4];               // the block's Q80 scales (two used)
  uint32_t pad[(16 - piece_words<RS>() % 32 + 32) % 32];
};

template <int RS, int S>
constexpr int smem_bytes() {
  return S * kSlices * (int)sizeof(Piece<RS>) + kSlices * kCols * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// the same, with the L2 fetching the whole 128 bytes around it: the next
// tile's CTA reads the other half of the line soon after
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// issue the copies of piece u of the 16 blocks first + s (blocks at or
// past nb are skipped) into stage `st`; the last piece also brings the
// scales
template <int RS>
__device__ __forceinline__ void load_piece(Piece<RS>* st, const int8_t* __restrict__ xq, const float* __restrict__ sx,
                                           const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                                           int half, int nb, int d_pad, int col0, int first, int u) {
  const int t = threadIdx.x;
#pragma unroll
  for (int it = 0; it < RS * 4 * kSlices / kThreads; ++it) {  // 16-byte pieces of packed rows
    const int i = t + it * kThreads;
    const int p = i / (RS * 4), r = (i >> 2) % RS, q = i & 3;
    const int b = first + p;
    if (b < nb) cp_async16_l2(&st[p].w[r * kLanes + 4 * q], qs + (size_t)(b * 32 + u * RS + r) * d_pad + col0 + 16 * q);
  }
  constexpr int kXPieces = RS >= 16 ? RS / 16 : 1;  // copies per x window
  if (t < 2 * kXPieces * kSlices) {
    const int p = t / (2 * kXPieces), h = (t / kXPieces) & 1, q = t % kXPieces;
    const int b = first + p;
    const int8_t* src = xq + h * half + b * 32 + u * RS + 16 * q;
    if (b < nb) {
      if constexpr (RS >= 16) cp_async16(&st[p].x[h][4 * q], src);
      else cp_async_small<RS>(&st[p].x[h][0], src);
    }
  }
  if (u == 32 / RS - 1) {
#pragma unroll
    for (int it = 0; it < 32 * kSlices / kThreads; ++it) {  // weight scales, 4 columns a piece
      const int i = t + it * kThreads;
      const int p = i >> 5, h = (i >> 4) & 1, q = i & 15;
      const int b = first + p;
      if (b < nb) cp_async16_l2(&st[p].sw[h][q], scales + (size_t)(h * nb + b) * d_pad + col0 + 4 * q);
    }
    if (t < 2 * kSlices) {  // Q80 scales
      const int p = t >> 1, h = t & 1;
      const int b = first + p;
      if (b < nb) cp_async_small<4>(&st[p].sx[h], sx + h * nb + b);
    }
  }
}

// d += the dot of a's signed bytes with b's unsigned bytes
__device__ __forceinline__ int dp4a_su(int a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a piece's rows into the lane's exact int32 dots of the low half (lo) and
// 16 times those of the high half (hi16: the high nibbles dotted in place,
// one AND a word less)
template <int RS>
__device__ __forceinline__ void piece_dots(const Piece<RS>& pc, int lane, int (&lo)[4], int (&hi16)[4]) {
#pragma unroll
  for (int g = 0; g < RS / 4; ++g) {
    uint32_t col[4];
    transpose4x4(pc.w[(4 * g) * kLanes + lane], pc.w[(4 * g + 1) * kLanes + lane], pc.w[(4 * g + 2) * kLanes + lane],
                 pc.w[(4 * g + 3) * kLanes + lane], col[0], col[1], col[2], col[3]);
    const int xl = (int)pc.x[0][g], xh = (int)pc.x[1][g];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = __dp4a(xl, (int)(col[c] & 0x0F0F0F0Fu), lo[c]);
      hi16[c] = dp4a_su(xh, col[c] & 0xF0F0F0F0u, hi16[c]);
    }
  }
}

// the block's epilogue into the slice partial: (dot * sw) * sx, low half
// then high half
template <int RS>
__device__ __forceinline__ void block_epilogue(const Piece<RS>& pc, int lane, const int (&lo)[4],
                                               const int (&hi16)[4], float (&acc)[4]) {
  const float4 slo = pc.sw[0][lane], shi = pc.sw[1][lane];
  const float swl[4] = {slo.x, slo.y, slo.z, slo.w};
  const float swh[4] = {shi.x, shi.y, shi.z, shi.w};
  const float sxl = pc.sx[0], sxh = pc.sx[1];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[c] = __fadd_rn(acc[c], __fmul_rn(__fmul_rn((float)lo[c], swl[c]), sxl));
    acc[c] = __fadd_rn(acc[c], __fmul_rn(__fmul_rn((float)(hi16[c] >> 4), swh[c]), sxh));
  }
}

// out[0, d] for one row, the 64 columns of tile blockIdx.x; a block
// arrives in 32 / RS pieces of RS rows through a ring of S stages. Shapes:
// xq int8 [1, n_pad], sx f32 [1, n_pad/32], qs uint8 [n_pad/2, d_pad],
// scales f32 [n_pad/32, d_pad], out f32 [1, d_pad]; xq, qs and scales
// 16-byte aligned.
template <int RS, int S>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx, const uint8_t* __restrict__ qs,
              const float* __restrict__ scales, float* __restrict__ out, int n_pad, int d_pad) {
  constexpr int U = 32 / RS;  // pieces a block
  extern __shared__ __align__(16) unsigned char smem[];
  Piece<RS>* ring = reinterpret_cast<Piece<RS>*>(smem);  // S stages of 16 pieces
  float(*part)[kCols] = reinterpret_cast<float(*)[kCols]>(smem + S * kSlices * sizeof(Piece<RS>));
  const int col0 = (int)blockIdx.x * kCols;
  const int lane = threadIdx.x % kLanes, slice = threadIdx.x / kLanes;
  const int half = n_pad / 2, nb = n_pad / 64;
  const int pieces = (nb + kSlices - 1) / kSlices * U;  // steps of slice 0, the one with the most blocks

#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < pieces) load_piece<RS>(ring + k * kSlices, xq, sx, qs, scales, half, nb, d_pad, col0, kSlices * (k / U), k % U);
    cp_async_commit();
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int lo[4] = {0, 0, 0, 0}, hi16[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < pieces; ++k) {
    cp_async_wait<S - 2>();  // piece k has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; piece k - 1's stage is free
    const int next = k + S - 1;
    if (next < pieces)
      load_piece<RS>(ring + (next % S) * kSlices, xq, sx, qs, scales, half, nb, d_pad, col0, kSlices * (next / U),
                     next % U);
    cp_async_commit();
    if (kSlices * (k / U) + slice < nb) {
      const Piece<RS>& pc = ring[(k % S) * kSlices + slice];
      piece_dots<RS>(pc, lane, lo, hi16);
      if (k % U == U - 1) {
        block_epilogue<RS>(pc, lane, lo, hi16, acc);
#pragma unroll
        for (int c = 0; c < 4; ++c) lo[c] = hi16[c] = 0;
      }
    }
  }
  *reinterpret_cast<float4*>(&part[slice][4 * lane]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (threadIdx.x < kCols) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) s = __fadd_rn(s, part[k][threadIdx.x]);
    out[col0 + threadIdx.x] = s;
  }
}

// launch for one row; returns the cudaError_t of the launch
template <int RS, int S>
int launch(const int8_t* xq, const float* sx, const uint8_t* qs, const float* scales, float* out, int n_pad,
           int d_pad, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<RS, S>();
  static bool configured = false;  // the opt-in above 48 KB, set once per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_kernel<RS, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  decode_kernel<RS, S><<<d_pad / kCols, kThreads, bytes, stream>>>(xq, sx, qs, scales, out, n_pad, d_pad);
  return (int)cudaGetLastError();
}

}  // namespace q40dec
