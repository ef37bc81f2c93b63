// Q40 dequantize-in-registers matmul (W4A16) for Hopper (sm_90a), K3.
//
// Replaces the Pallas TPU kernel distributed_llama_tpu/ops/q40.py
// `_make_q40_kernel` (launched by `_q40_matmul_f32`). It computes
//
//   out[t, d] = sum_i x[t, i] * bf16(nib[i, d] * bf16(scale[i/32, d]))
//
// with x in bf16, each weight dequantized from its BIASED nibble (0..15)
// times its block scale and rounded to bf16 (the product a bf16 multiply
// gives), bf16 x bf16 products and f32 accumulation. The half-split pack
// feeds low nibbles against x[:, :n_pad/2] and high nibbles against
// x[:, n_pad/2:]. The caller subtracts 8 * (xsum @ scales) in full f32.
//
// What bounds it on an H100: at decode the packed weight stream (half a
// byte per weight and an f32 scale per 32) over 3.35 TB/s; from a few
// hundred rows the bf16 tensor cores. The design keeps the per-weight
// work off the token count and the CUDA cores light:
//
//   * two weights per instruction, exactly: a PRMT splices two packed
//     bytes into the 16-bit halves of a word, and a LOP3 with 0x43004300
//     turns a nibble n in each half into the bf16 value 128 + n (exact:
//     bf16 holds every integer of [128, 256)); HSUB2 {128, 128} leaves n
//     exactly and HMUL2 by {bf16(s), bf16(s)} rounds n * bf16(s) once,
//     which is bf16(nib * bf16(scale)) bit for bit (a 4-bit integer times
//     an 8-bit mantissa is exact before that rounding, and scales that
//     come from f16 keep every product a normal bf16 number);
//   * the dot on the tensor cores: mma.sync m16n8k16 bf16 -> f32 with the
//     weights on the M side (16 output columns) and the token rows on the
//     N side (8 rows), so a CTA dequantizes its weight tile once for all
//     its rows and the token count only adds mmas;
//   * the bytes streamed in 16-byte cp.async copies into a 4-stage ring
//     per warp (three blocks in flight ahead of the one computed), so a
//     warp never waits on a CTA barrier until the final fold.
//
// Tile: 32 output columns and 8, 16, 24 or 32 token rows per CTA; 16
// warps, one per k-slice: warp s walks quant blocks s, s + 16, ... of the
// half-split pack, its f32 partial in the mma accumulators (per block:
// packed rows 0-15, low then high half, then rows 16-31 alike), and the CTA
// adds the 16 partials in slice order through shared memory at the end.
// A lane of group g (lane / 4) and thread-in-group tig (lane % 4) holds
// columns 4 g .. 4 g + 3; m tile p's row g is column 4 g + 2 p and its row
// g + 8 column 4 g + 2 p + 1. Its k slots take packed rows 16 k + 4 tig + j
// (j = 0..3: the pairs {0, 1} and {2, 3} are the fragment's two k pairs),
// and the B fragment is then 8 contiguous bytes of the token's x window.
//
// Every output element takes the same sequence of mma accumulations
// whatever T is (an mma's output element depends on its own A row, B
// column and C element only), and the fold has a fixed order, so every row
// of a launch equals, bit for bit, a T = 1 launch of that row, and repeat
// launches are bit-equal. Rows past T are clamped to row T - 1: they
// compute what is never stored.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // output columns per CTA
constexpr int kSlices = 16;   // warps per CTA, one k-slice each
constexpr int kThreads = 32 * kSlices;
constexpr int kStages = 4;    // blocks in a warp's cp.async ring
// one ring stage: a block's 32 packed rows x 32 columns (1 KB, 64 chunks of
// 16 bytes), then the low and high halves' 32 scales (128 bytes each)
constexpr int kStageBytes = 32 * kCols + 2 * kCols * 4;
constexpr int kStageChunks = kStageBytes / 16;  // 80
constexpr int kRingBytes = kSlices * kStages * kStageBytes;

template <int NT>
constexpr int smem_bytes() {
  constexpr int part = kSlices * 8 * NT * kCols * 4;  // the slice partials, after the ring
  return part > kRingBytes ? part : kRingBytes;
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset in a stage of packed row r's 16-byte chunk c (columns 16 c ..
// 16 c + 15): rows come in 128-byte lines of 4; the chunk position in its
// line is XORed with twice the line index (mod 4), so that the 32 lanes'
// words of one fragment read (rows 16 k + 4 tig + j, word g) fall in 32
// different banks
__device__ __forceinline__ int chunk_offset(int r, int c) {
  const int line = r >> 2;
  return line * 128 + (((2 * (r & 3) + c) ^ (2 * (line & 3))) << 4);
}

// issue the copies of block b (of each half) into the stage at `stage`
// (a shared-space address)
__device__ __forceinline__ void load_block(uint32_t stage, const uint8_t* __restrict__ qs,
                                           const float* __restrict__ scales, int d_pad, int nb,
                                           int col0, int b, int lane) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int q = lane + 32 * k;
    if (q < 64) {
      const int r = q >> 1, c = q & 1;
      cp_async16(stage + chunk_offset(r, c), qs + (size_t)(b * 32 + r) * d_pad + col0 + 16 * c);
    } else if (q < kStageChunks) {
      const int h = (q - 64) >> 3, c = (q - 64) & 7;
      cp_async16(stage + 32 * kCols + h * kCols * 4 + 16 * c,
                 scales + (size_t)(h * nb + b) * d_pad + col0 + 4 * c);
    }
  }
}

// {bf16(128 + n0), bf16(128 + n1)} - {128, 128} = {n0, n1}, times s2: the
// nibbles in bits 0-3 and 16-19 of u
__device__ __forceinline__ uint32_t dequant2(uint32_t u, __nv_bfloat162 s2) {
  const uint32_t biased = (u & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 n = __hsub2(v, __floats2bfloat162_rn(128.f, 128.f));
  const __nv_bfloat162 w = __hmul2(n, s2);
  return *reinterpret_cast<const uint32_t*>(&w);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8-row tiles run two CTAs an SM (64 registers a thread)
template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
q40_dequant_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
                   const float* __restrict__ scales, float* __restrict__ out, int T, int n_pad, int d_pad) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  // token tiles fastest: the CTAs that share a column tile's weights run together
  const int t0 = blockIdx.x * 8 * NT;
  const int nt = min(8 * NT, T - t0);
  const int col0 = blockIdx.y * kCols;
  const int half = n_pad / 2;
  const int nb = n_pad / 64;  // blocks per half
  const int slice = warp;

  // this lane's B rows: token g of each n tile, its k slots 4 tig .. 4 tig + 3
  const __nv_bfloat16* xg[NT];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) xg[ni] = x + (size_t)min(t0 + 8 * ni + g, T - 1) * n_pad + 4 * tig;

  float acc[NT][2][4];  // [n tile][m tile p][mma output element]
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][p][e] = 0.f;

  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + warp * kStages * kStageBytes;
  const uint8_t* ring_p = smem + warp * kStages * kStageBytes;
  // prologue: blocks 0 .. kStages - 2 of this slice in flight
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int b = slice + kSlices * i;
    if (b < nb) load_block(ring + i * kStageBytes, qs, scales, d_pad, nb, col0, b, lane);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; slice + kSlices * i < nb; ++i) {
    const int b = slice + kSlices * i;
    // x first: its loads overlap the wait for the weights
    uint2 xb[NT][2][2];  // [n tile][rows 0-15, 16-31][half]
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xb[ni][k][h] = __ldg(reinterpret_cast<const uint2*>(xg[ni] + h * half + b * 32 + 16 * k));
    {
      const int bn = b + kSlices * (kStages - 1);
      if (bn < nb) load_block(ring + ((i + kStages - 1) % kStages) * kStageBytes, qs, scales, d_pad, nb, col0, bn, lane);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint8_t* st = ring_p + (i % kStages) * kStageBytes;
    // the scales of columns 4 g .. 4 g + 3, low and high half, as bf16 pairs
    __nv_bfloat162 s2[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 s = *reinterpret_cast<const float4*>(st + 32 * kCols + h * kCols * 4 + 16 * g);
      s2[h][0] = __float2bfloat162_rn(s.x);
      s2[h][1] = __float2bfloat162_rn(s.y);
      s2[h][2] = __float2bfloat162_rn(s.z);
      s2[h][3] = __float2bfloat162_rn(s.w);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // rows 16 k + 4 tig + j, columns 4 g .. 4 g + 3 (one word each)
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const uint32_t*>(st + chunk_offset(16 * k + 4 * tig + j, g >> 2) + 4 * (g & 3));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // bytes {w0[2p], w0[2p+1], w1[2p], w1[2p+1]}: column 4 g + 2 p in
        // bits 0-7 and 16-23, column 4 g + 2 p + 1 in bits 8-15 and 24-31;
        // the low nibbles are the low half's weights, the high the high half's
        const uint32_t sel = p ? 0x7632u : 0x5410u;
        const uint32_t v01 = __byte_perm(w[0], w[1], sel);
        const uint32_t v23 = __byte_perm(w[2], w[3], sel);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a0 = dequant2(v01 >> (4 * h), s2[h][2 * p]);
          const uint32_t a1 = dequant2(v01 >> (8 + 4 * h), s2[h][2 * p + 1]);
          const uint32_t a2 = dequant2(v23 >> (4 * h), s2[h][2 * p]);
          const uint32_t a3 = dequant2(v23 >> (8 + 4 * h), s2[h][2 * p + 1]);
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            if (ni > 0 && 8 * ni >= nt) break;  // CTA-uniform: no row in this n tile
            mma_bf16(acc[ni][p], a0, a1, a2, a3, xb[ni][k][h].x, xb[ni][k][h].y);
          }
        }
      }
    }
    __syncwarp();  // every lane has read this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partials take its place

  float* part = reinterpret_cast<float*>(smem);
  // a lane's accumulators: m tile p element e is column 4 g + 2 p + (e >> 1)
  // of token 2 tig + (e & 1)
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
      *reinterpret_cast<float4*>(part + ((size_t)slice * 8 * NT + 8 * ni + 2 * tig + tt) * kCols + 4 * g) =
          make_float4(acc[ni][0][tt], acc[ni][0][2 + tt], acc[ni][1][tt], acc[ni][1][2 + tt]);
  __syncthreads();
  for (int e = threadIdx.x; e < nt * kCols; e += kThreads) {
    float tot = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) tot = __fadd_rn(tot, part[(size_t)s * 8 * NT * kCols + e]);
    out[(size_t)(t0 + e / kCols) * d_pad + col0 + e % kCols] = tot;
  }
}

template <int NT>
int launch(const __nv_bfloat16* x, const uint8_t* qs, const float* scales, float* out, int T, int n_pad,
           int d_pad, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<NT>();
  static bool configured = false;  // the opt-in above 48 KB, set once per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(q40_dequant_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((T + 8 * NT - 1) / (8 * NT), d_pad / kCols);
  q40_dequant_kernel<NT><<<grid, kThreads, bytes, stream>>>(x, qs, scales, out, T, n_pad, d_pad);
  return (int)cudaGetLastError();
}

bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

}  // namespace

// C entry point, bound with ctypes. Shapes: x bf16 [T, n_pad], qs uint8
// [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad], out f32 [T, d_pad];
// n_pad % 64 == 0, d_pad % 64 == 0; qs and scales 16-byte aligned, x 8.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int q40_dequant_matmul(const void* x, const void* qs, const void* scales, void* out, int T,
                                  int n_pad, int d_pad, void* stream) {
  if (T <= 0 || n_pad % 64 || d_pad % 64) return (int)cudaErrorInvalidValue;
  if (misaligned(qs, 16) || misaligned(scales, 16) || misaligned(x, 8)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const uint8_t*>(qs);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  return T <= 8    ? launch<1>(xp, q, sc, o, T, n_pad, d_pad, s)
         : T <= 16 ? launch<2>(xp, q, sc, o, T, n_pad, d_pad, s)
         : T <= 24 ? launch<3>(xp, q, sc, o, T, n_pad, d_pad, s)
                   : launch<4>(xp, q, sc, o, T, n_pad, d_pad, s);
}
