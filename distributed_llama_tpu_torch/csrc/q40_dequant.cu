// Q40 dequantize-in-registers matmul (W4A16) for Hopper (sm_90a).
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
// What bounds it on an H100: the dequantization arithmetic, not the bytes.
// Each weight costs an extract, a convert, a multiply and a bf16 rounding
// on the CUDA cores before one FMA per token; at decode that is several
// times the time the packed bytes take at 3.35 TB/s. Tensor-core
// (mma/wgmma) dequant GEMMs are later work: this arm is the A/B
// counterpart of the int8 kernel and is kept simple.
//
// Design: the int8 kernel's skeleton (64 output columns and TT tokens per
// CTA, 16 column lanes x 16 k-slices, a 32-row block of 4-byte loads per
// thread in flight, slice partials summed in shared memory). A block is
// dequantized 8 rows at a time into registers and each token's 8 x values
// of each window arrive as one 16-byte load.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kColsPerCta = 64;
constexpr int kColLanes = kColsPerCta / 4;  // 16
constexpr int kSlices = 16;
constexpr int kThreads = kColLanes * kSlices;  // 256

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void bf16x8_to_float(const uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

template <int TT>
__global__ void __launch_bounds__(kThreads)
q40_dequant_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
                   const float* __restrict__ scales, float* __restrict__ out, int T, int n_pad,
                   int d_pad) {
  __shared__ float red[kSlices][TT][kColsPerCta];

  const int lane_c = threadIdx.x % kColLanes;
  const int slice = threadIdx.x / kColLanes;
  const int d0 = blockIdx.x * kColsPerCta + lane_c * 4;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const int half = n_pad / 2;
  const int nb = half / 32;

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
    const float swl[4] = {round_bf16(slo.x), round_bf16(slo.y), round_bf16(slo.z),
                          round_bf16(slo.w)};
    const float swh[4] = {round_bf16(shi.x), round_bf16(shi.y), round_bf16(shi.z),
                          round_bf16(shi.w)};

#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float wl[8][4], wh[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t word = w[8 * g + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (word >> (8 * c)) & 0xFFu;
          wl[r][c] = round_bf16((float)(byte & 0xFu) * swl[c]);
          wh[r][c] = round_bf16((float)(byte >> 4) * swh[c]);
        }
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t < nt) {
          const __nv_bfloat16* xr = x + (size_t)(t0 + t) * n_pad + b * 32 + 8 * g;
          float xl[8], xh[8];
          bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr)), xl);
          bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + half)), xh);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[t][c] = fmaf(xl[r], wl[r][c], acc[t][c]);
              acc[t][c] = fmaf(xh[r], wh[r][c], acc[t][c]);
            }
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
void launch(const __nv_bfloat16* x, const uint8_t* qs, const float* scales, float* out, int T,
            int n_pad, int d_pad, cudaStream_t stream) {
  dim3 grid(d_pad / kColsPerCta, (T + TT - 1) / TT);
  q40_dequant_kernel<TT><<<grid, kThreads, 0, stream>>>(x, qs, scales, out, T, n_pad, d_pad);
}

}  // namespace

// C entry point, bound with ctypes. Shapes: x bf16 [T, n_pad], qs uint8
// [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad], out f32 [T, d_pad];
// n_pad % 64 == 0, d_pad % 64 == 0. Returns the launch's cudaError_t.
extern "C" int q40_dequant_matmul(const void* x, const void* qs, const void* scales, void* out,
                                  int T, int n_pad, int d_pad, void* stream) {
  if (T <= 0 || n_pad % 64 || d_pad % kColsPerCta) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const uint8_t*>(qs);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  if (T == 1)
    launch<1>(xp, q, sc, o, T, n_pad, d_pad, s);
  else if (T <= 4)
    launch<4>(xp, q, sc, o, T, n_pad, d_pad, s);
  else
    launch<8>(xp, q, sc, o, T, n_pad, d_pad, s);
  return (int)cudaGetLastError();
}
