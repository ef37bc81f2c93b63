// Fused paged attention (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributed_llama_tpu/ops/attention.py
// `_fused_paged_attention` (behind `fused_paged_decode_attention` and
// `fused_paged_verify_attention`). For each row b of a batched decode (T=1)
// or speculative-verify (T>1) step, its T queries at positions pos[b]+t
// attend causally over the row's KV: positions below matched[b] are read
// from the prefix cache's page pool through the row's page table, the rest
// from the row's own slab row. Per 512-position chunk (the JAX ATT_CHUNK):
//
//   s = dot(round_cdt(q), k) / sqrt(hd)   f32 accumulation, masked k_pos <= q_pos
//   m = max s (-inf when the chunk is fully masked), p = exp(s - m), l = sum p
//   o = sum round_cdt(p) * v              f32 accumulation
//
// merged into the running (m, l, o) with the online-softmax formula and
// its isfinite guards (`merge_partials`); the output is o / max(l, 1e-30).
// round_cdt rounds to the cache dtype (bf16 or f32). The merge granularity
// stays the 512-position chunk: p's bf16 rounding depends on the chunk max.
//
// What bounds it on an H100: the bytes. Each live KV position is read once
// (2 * K * hd * sizeof(cache dtype) per position and row) and the
// arithmetic per byte is a few FMAs per query, far below the card's
// operations-per-byte ridge, so the bound is live KV bytes / 3.35 TB/s.
//
// Design (simple and right first; wgmma, TMA and double buffering are
// later work): one CTA per (row, kv head), 256 threads. The TPU kernel's
// sequential chunk grid becomes a loop inside the CTA, up to the row's own
// bound ceil((pos[b]+T)/512) (chunks past it are empty partials, which the
// merge passes through exactly). Per chunk: (1) each position's K/V row
// address is resolved once (pool page or slab row) into shared memory;
// (2) one warp per position scores it against every query (lanes split hd,
// shuffle-reduced); (3) one warp per query takes the chunk max, exp and sum
// and stores the rounded weights; (4) threads split hd in pairs and the
// positions into slices to mix V; (5) the slices are summed in a fixed
// order and merged into the running o. Everything stays in shared memory
// and registers; the output is written once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_cdt(float v);
template <>
__device__ __forceinline__ float round_cdt<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_cdt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shared memory of one CTA, in floats before the two pointer arrays
__host__ __device__ constexpr int smem_floats(int tm, int hd) {
  return tm * hd                                  // q (rounded)
         + tm * kChunk                            // scores, then rounded weights
         + (kThreads / (hd / 2)) * tm * hd        // per-slice value partials
         + tm * hd                                // running o
         + 4 * tm;                                // running m, l; merge factors a1, a2
}

__host__ __device__ constexpr size_t smem_bytes(int tm, int hd) {
  return ((size_t)smem_floats(tm, hd) + 1) / 2 * 2 * sizeof(float) + 2 * kChunk * sizeof(void*);
}

template <typename T, int HD, int TMAX>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ slab_k,
                       const T* __restrict__ slab_v, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v, const int* __restrict__ tables,
                       const int* __restrict__ pos, const int* __restrict__ matched,
                       float* __restrict__ out, int T_, int K, int M, int S, int page, int n_table,
                       float scale) {
  constexpr int EPL = HD / 32;                // elements of a row per lane (scores)
  constexpr int kPairLanes = HD / 2;          // threads per position (value mix)
  constexpr int kSlices = kThreads / kPairLanes;
  extern __shared__ float smem[];
  const int TM = T_ * M;
  float* s_q = smem;
  float* s_p = s_q + TM * HD;
  float* s_red = s_p + TM * kChunk;
  float* s_o = s_red + kSlices * TM * HD;
  float* s_m = s_o + TM * HD;
  float* s_l = s_m + TM;
  float* s_a1 = s_l + TM;
  float* s_a2 = s_a1 + TM;
  const T** s_kp = reinterpret_cast<const T**>(smem + (smem_floats(TM, HD) + 1) / 2 * 2);
  const T** s_vp = s_kp + kChunk;

  const int b = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = pos[b];
  const int mt = matched[b];
  const int live = min(p0 + T_, S);  // positions any query of this row may see
  const int n_chunks = (live + kChunk - 1) / kChunk;
  const int ppc = kChunk / page;
  const size_t row_stride = (size_t)K * HD;  // elements between two positions

  for (int e = tid; e < TM * HD; e += kThreads) {
    const int qi = e / HD;
    const int t = qi / M;
    const int m = qi % M;
    s_q[e] = round_cdt<T>(q[((((size_t)b * T_ + t) * K + k) * M + m) * HD + e % HD]);
    s_o[e] = 0.f;
  }
  for (int qi = tid; qi < TM; qi += kThreads) {
    s_m[qi] = -INFINITY;
    s_l[qi] = 0.f;
  }

  for (int i = 0; i < n_chunks; ++i) {
    const int start = i * kChunk;
    const int n_live = min(kChunk, live - start);
    // (1) each position's source: a pool page through the table, or the slab
    const int base = min(max(i * ppc, 0), n_table - ppc);
    for (int j = tid; j < n_live; j += kThreads) {
      const int a = start + j;
      size_t off;
      const T *kp, *vp;
      if (a < mt) {
        const int pid = tables[(size_t)b * n_table + base + j / page];
        off = ((size_t)pid * page + j % page) * row_stride + (size_t)k * HD;
        kp = pool_k + off;
        vp = pool_v + off;
      } else {
        off = ((size_t)b * S + a) * row_stride + (size_t)k * HD;
        kp = slab_k + off;
        vp = slab_v + off;
      }
      s_kp[j] = kp;
      s_vp[j] = vp;
    }
    __syncthreads();

    // (2) scores: one warp per position, lanes split hd (element e*32+lane)
    for (int j = warp; j < kChunk; j += kWarps) {
      if (j < n_live) {
        const T* kp = s_kp[j];
        float kv[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[e] = to_f(kp[e * 32 + lane]);
#pragma unroll
        for (int qi = 0; qi < TMAX; ++qi) {
          if (qi < TM) {
            const float* qq = s_q + qi * HD;
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc = fmaf(qq[e * 32 + lane], kv[e], acc);
            acc = warp_sum(acc);
            if (lane == 0) s_p[qi * kChunk + j] = acc / scale;
          }
        }
      }
    }
    __syncthreads();

    // (3) per query: chunk max, exp, sum; rounded weights; merge factors
    for (int qi = warp; qi < TM; qi += kWarps) {
      float* sp = s_p + qi * kChunk;
      const int last = p0 + qi / M - start;  // the query sees chunk slots j <= last
      float mx = -INFINITY;
      for (int j = lane; j < kChunk; j += 32)
        if (j <= last) mx = fmaxf(mx, sp[j]);
      mx = warp_max(mx);
      const float safe = isfinite(mx) ? mx : 0.f;
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float p = j <= last ? expf(sp[j] - safe) : 0.f;
        sum += p;
        sp[j] = round_cdt<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float m_old = s_m[qi];
        const float m_new = fmaxf(m_old, mx);
        const float sf = isfinite(m_new) ? m_new : 0.f;
        const float a1 = isfinite(m_old) ? expf(m_old - sf) : 0.f;
        const float a2 = isfinite(mx) ? expf(mx - sf) : 0.f;
        s_a1[qi] = a1;
        s_a2[qi] = a2;
        s_m[qi] = m_new;
        s_l[qi] = __fadd_rn(__fmul_rn(s_l[qi], a1), __fmul_rn(sum, a2));
      }
    }
    __syncthreads();

    // (4) value mix: thread = (pair of hd elements, slice of positions)
    {
      const int hp = tid % kPairLanes;
      const int sl = tid / kPairLanes;
      float acc[TMAX][2];
#pragma unroll
      for (int qi = 0; qi < TMAX; ++qi) acc[qi][0] = acc[qi][1] = 0.f;
      for (int j = sl; j < n_live; j += kSlices) {
        float v0, v1;
        load_pair(s_vp[j] + 2 * hp, v0, v1);
#pragma unroll
        for (int qi = 0; qi < TMAX; ++qi) {
          if (qi < TM) {
            const float w = s_p[qi * kChunk + j];
            acc[qi][0] = fmaf(w, v0, acc[qi][0]);
            acc[qi][1] = fmaf(w, v1, acc[qi][1]);
          }
        }
      }
#pragma unroll
      for (int qi = 0; qi < TMAX; ++qi) {
        if (qi < TM) {
          float* r = s_red + ((size_t)sl * TM + qi) * HD + 2 * hp;
          r[0] = acc[qi][0];
          r[1] = acc[qi][1];
        }
      }
    }
    __syncthreads();

    // (5) sum the slices in a fixed order and merge into the running o
    for (int e = tid; e < TM * HD; e += kThreads) {
      const int qi = e / HD;
      float oc = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < kSlices; ++s2) oc += s_red[(size_t)s2 * TM * HD + e];
      s_o[e] = __fadd_rn(__fmul_rn(s_o[e], s_a1[qi]), __fmul_rn(oc, s_a2[qi]));
    }
    __syncthreads();
  }

  for (int e = tid; e < TM * HD; e += kThreads) {
    const int qi = e / HD;
    const int t = qi / M;
    const int m = qi % M;
    out[((((size_t)b * T_ + t) * K + k) * M + m) * HD + e % HD] = s_o[e] / fmaxf(s_l[qi], 1e-30f);
  }
}

template <typename T, int HD, int TMAX>
int launch(const void* q, const void* sk, const void* sv, const void* pk, const void* pv,
           const void* tables, const void* pos, const void* matched, void* out, int B, int nT, int K,
           int M, int S, int page, int n_table, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, HD, TMAX>;
  const size_t bytes = smem_bytes(nT * M, HD);
  static size_t configured = 0;  // the opt-in above 48 KB, set once per instantiation
  if (bytes > configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const float scale = sqrtf(static_cast<float>(HD));
  kernel<<<dim3(B, K), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(sk), static_cast<const T*>(sv),
      static_cast<const T*>(pk), static_cast<const T*>(pv), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<const int*>(matched), static_cast<float*>(out), nT,
      K, M, S, page, n_table, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_tm(const void* q, const void* sk, const void* sv, const void* pk, const void* pv,
              const void* tables, const void* pos, const void* matched, void* out, int B, int nT,
              int K, int M, int S, int page, int n_table, cudaStream_t stream) {
  const int tm = nT * M;
  if (tm <= 1)
    return launch<T, HD, 1>(q, sk, sv, pk, pv, tables, pos, matched, out, B, nT, K, M, S, page,
                            n_table, stream);
  if (tm <= 4)
    return launch<T, HD, 4>(q, sk, sv, pk, pv, tables, pos, matched, out, B, nT, K, M, S, page,
                            n_table, stream);
  if (tm <= 16)
    return launch<T, HD, 16>(q, sk, sv, pk, pv, tables, pos, matched, out, B, nT, K, M, S, page,
                             n_table, stream);
  return launch<T, HD, 32>(q, sk, sv, pk, pv, tables, pos, matched, out, B, nT, K, M, S, page,
                           n_table, stream);
}

}  // namespace

// C entry point, bound with ctypes. Shapes: q f32 [B, T, K, M, hd]; slab
// halves [B_max >= B, S, K, hd] and pool halves [P, page, K, hd], all of one
// cache dtype (bf16 = 1, f32 = 0), contiguous; tables int32 [B, n_table];
// pos, matched int32 [B]; out f32 [B, T, K, M, hd]. The pool pointers may be
// null when every matched[b] is 0. Requires chunk == 512, hd in {64, 128},
// T * M <= 32, chunk % page == 0, S % chunk == 0 and n_table >= chunk / page.
// Returns the launch's cudaError_t.
extern "C" int paged_attention(const void* q, const void* slab_k, const void* slab_v,
                               const void* pool_k, const void* pool_v, const void* tables,
                               const void* pos, const void* matched, void* out, int B, int T, int K,
                               int M, int hd, int S, int page, int n_table, int chunk, int bf16,
                               void* stream) {
  if (chunk != kChunk || B < 1 || T < 1 || K < 1 || M < 1 || T * M > 32 || page < 1 ||
      chunk % page || S % chunk || n_table < chunk / page)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128) {
    return bf16 ? launch_tm<__nv_bfloat16, 128>(q, slab_k, slab_v, pool_k, pool_v, tables, pos,
                                                 matched, out, B, T, K, M, S, page, n_table, s)
                : launch_tm<float, 128>(q, slab_k, slab_v, pool_k, pool_v, tables, pos, matched,
                                        out, B, T, K, M, S, page, n_table, s);
  }
  if (hd == 64) {
    return bf16 ? launch_tm<__nv_bfloat16, 64>(q, slab_k, slab_v, pool_k, pool_v, tables, pos,
                                                matched, out, B, T, K, M, S, page, n_table, s)
                : launch_tm<float, 64>(q, slab_k, slab_v, pool_k, pool_v, tables, pos, matched,
                                       out, B, T, K, M, S, page, n_table, s);
  }
  return (int)cudaErrorInvalidValue;
}
