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
// round_cdt rounds to the compute dtype: the cache dtype for bf16 and f32
// caches, bf16 for the int8 cache. The merge granularity stays the
// 512-position chunk: p's bf16 rounding depends on the chunk max.
//
// The int8 cache (the JAX QuantizedKV) stores int8 rows with one f32 scale
// per (position, kv head), in four more arrays laid out as the data with
// hd replaced by 1. Its arithmetic is the JAX package's, in its order:
//
//   s = (dot(round_bf16(q), k_int8) * kscale) / sqrt(hd)   each product exact in f32
//   w = round_bf16(p * vscale), o = sum w * v_int8         l sums the unscaled p
//
// so the value scale folds into the weight before its bf16 rounding.
//
// What bounds it on an H100: the bytes. Each live KV position is read once
// (2 * K * hd * sizeof(cache dtype) per position and row, plus 2 * K * 4
// bytes of scales for int8) and the arithmetic per byte is a few FMAs per
// query, far below the card's operations-per-byte ridge, so the bound is
// live KV bytes / 3.35 TB/s.
//
// Design (simple and right first; wgmma, TMA and double buffering are
// later work): one CTA per (row, kv head), 256 threads. The TPU kernel's
// sequential chunk grid becomes a loop inside the CTA, up to the row's own
// bound ceil((pos[b]+T)/512) (chunks past it are empty partials, which the
// merge passes through exactly). Per chunk: (1) each position's K/V row
// address (and, for int8, its two scales) is resolved once (pool page or
// slab row) into shared memory; (2) one warp per position scores it against
// every query (lanes split hd, shuffle-reduced; an int8 row is read as one
// 4-byte word per lane); (3) one warp per query takes the chunk max, exp
// and sum and stores the rounded weights; (4) threads split hd in pairs and
// the positions into slices to mix V; (5) the slices are summed in a fixed
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

// storage traits: the compute dtype queries and weights round to, and
// whether the cache carries per-position scales
template <typename T>
struct Cache {
  using Compute = T;
  static constexpr bool kQuant = false;
};
template <>
struct Cache<int8_t> {
  using Compute = __nv_bfloat16;
  static constexpr bool kQuant = true;
};

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
__device__ __forceinline__ void load_pair(const int8_t* p, float& a, float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = static_cast<float>(v.x);
  b = static_cast<float>(v.y);
}

// One lane's EPL elements of a key row for the score dot, and the query
// element each pairs with. Float rows: elements e * 32 + lane (coalesced
// 2- or 4-byte loads). Int8 rows: EPL contiguous bytes at lane * EPL, one
// 4-byte (hd 128) or 2-byte (hd 64) load converted in registers.
template <typename T, int EPL>
__device__ __forceinline__ void load_key(const T* kp, int lane, float (&kv)[EPL]) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) kv[e] = to_f(kp[e * 32 + lane]);
}
template <>
__device__ __forceinline__ void load_key<int8_t, 4>(const int8_t* kp, int lane, float (&kv)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(kp + lane * 4);
  kv[0] = static_cast<float>(v.x);
  kv[1] = static_cast<float>(v.y);
  kv[2] = static_cast<float>(v.z);
  kv[3] = static_cast<float>(v.w);
}
template <>
__device__ __forceinline__ void load_key<int8_t, 2>(const int8_t* kp, int lane, float (&kv)[2]) {
  load_pair(kp + lane * 2, kv[0], kv[1]);
}
template <typename T, int EPL>
__device__ __forceinline__ int key_elem(int e, int lane) {
  return Cache<T>::kQuant ? lane * EPL + e : e * 32 + lane;
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
         + 4 * tm                                 // running m, l; merge factors a1, a2
         + 2 * kChunk;                            // per-position k and v scales (int8)
}

__host__ __device__ constexpr size_t smem_bytes(int tm, int hd) {
  return ((size_t)smem_floats(tm, hd) + 1) / 2 * 2 * sizeof(float) + 2 * kChunk * sizeof(void*);
}

template <typename T, int HD, int TMAX>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ slab_k,
                       const T* __restrict__ slab_v, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v, const float* __restrict__ slab_ks,
                       const float* __restrict__ slab_vs, const float* __restrict__ pool_ks,
                       const float* __restrict__ pool_vs, const int* __restrict__ tables,
                       const int* __restrict__ pos, const int* __restrict__ matched,
                       float* __restrict__ out, int T_, int K, int M, int S, int page, int n_table,
                       float scale) {
  constexpr int EPL = HD / 32;                // elements of a row per lane (scores)
  constexpr int kPairLanes = HD / 2;          // threads per position (value mix)
  constexpr int kSlices = kThreads / kPairLanes;
  constexpr bool kQuant = Cache<T>::kQuant;
  using Cdt = typename Cache<T>::Compute;
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
  float* s_ks = s_a2 + TM;
  float* s_vs = s_ks + kChunk;
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
    s_q[e] = round_cdt<Cdt>(q[((((size_t)b * T_ + t) * K + k) * M + m) * HD + e % HD]);
    s_o[e] = 0.f;
  }
  for (int qi = tid; qi < TM; qi += kThreads) {
    s_m[qi] = -INFINITY;
    s_l[qi] = 0.f;
  }

  for (int i = 0; i < n_chunks; ++i) {
    const int start = i * kChunk;
    const int n_live = min(kChunk, live - start);
    // (1) each position's source: a pool page through the table, or the
    // slab; an int8 position's scales sit at the data offset / hd
    const int base = min(max(i * ppc, 0), n_table - ppc);
    for (int j = tid; j < n_live; j += kThreads) {
      const int a = start + j;
      const bool pooled = a < mt;
      size_t off;
      if (pooled) {
        const int pid = tables[(size_t)b * n_table + base + j / page];
        off = ((size_t)pid * page + j % page) * row_stride + (size_t)k * HD;
      } else {
        off = ((size_t)b * S + a) * row_stride + (size_t)k * HD;
      }
      s_kp[j] = (pooled ? pool_k : slab_k) + off;
      s_vp[j] = (pooled ? pool_v : slab_v) + off;
      if (kQuant) {
        s_ks[j] = (pooled ? pool_ks : slab_ks)[off / HD];
        s_vs[j] = (pooled ? pool_vs : slab_vs)[off / HD];
      }
    }
    __syncthreads();

    // (2) scores: one warp per position, lanes split hd as load_key reads it
    for (int j = warp; j < kChunk; j += kWarps) {
      if (j < n_live) {
        float kv[EPL];
        load_key<T, EPL>(s_kp[j], lane, kv);
        const float ks = kQuant ? s_ks[j] : 1.f;
#pragma unroll
        for (int qi = 0; qi < TMAX; ++qi) {
          if (qi < TM) {
            const float* qq = s_q + qi * HD;
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc = fmaf(qq[key_elem<T, EPL>(e, lane)], kv[e], acc);
            acc = warp_sum(acc);
            if (kQuant) acc = __fmul_rn(acc, ks);  // the key scale after the raw dot
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
        // int8: the value scale folds into the weight before its rounding
        sp[j] = kQuant ? (j <= last ? round_cdt<Cdt>(__fmul_rn(p, s_vs[j])) : 0.f) : round_cdt<Cdt>(p);
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
int launch(const void* const* a, const int* d, cudaStream_t stream) {
  const int B = d[0], nT = d[1], K = d[2], M = d[3], S = d[4], page = d[5], n_table = d[6];
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
      static_cast<const float*>(a[0]), static_cast<const T*>(a[1]), static_cast<const T*>(a[2]),
      static_cast<const T*>(a[3]), static_cast<const T*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const float*>(a[6]), static_cast<const float*>(a[7]),
      static_cast<const float*>(a[8]), static_cast<const int*>(a[9]),
      static_cast<const int*>(a[10]), static_cast<const int*>(a[11]),
      static_cast<float*>(const_cast<void*>(a[12])), nT, K, M, S, page, n_table, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_tm(const void* const* a, const int* d, cudaStream_t stream) {
  const int tm = d[1] * d[3];
  if (tm <= 1) return launch<T, HD, 1>(a, d, stream);
  if (tm <= 4) return launch<T, HD, 4>(a, d, stream);
  if (tm <= 8) return launch<T, HD, 8>(a, d, stream);
  if (tm <= 16) return launch<T, HD, 16>(a, d, stream);
  return launch<T, HD, 32>(a, d, stream);
}

template <int HD>
int launch_dtype(int dtype, const void* const* a, const int* d, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_tm<float, HD>(a, d, stream);
    case 1: return launch_tm<__nv_bfloat16, HD>(a, d, stream);
    case 2: return launch_tm<int8_t, HD>(a, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes. Shapes: q f32 [B, T, K, M, hd]; slab
// halves [B_max >= B, S, K, hd] and pool halves [P, page, K, hd], all of one
// cache dtype (dtype 0 = f32, 1 = bf16, 2 = int8), contiguous; for int8 the
// four scale arrays are f32 [B_max, S, K, 1] (slab) and [P, page, K, 1]
// (pool), null otherwise; tables int32 [B, n_table]; pos, matched int32
// [B]; out f32 [B, T, K, M, hd]. The pool pointers may be null when every
// matched[b] is 0. Requires chunk == 512, hd in {64, 128}, T * M <= 32,
// chunk % page == 0, S % chunk == 0 and n_table >= chunk / page. Returns
// the launch's cudaError_t.
extern "C" int paged_attention(const void* q, const void* slab_k, const void* slab_v,
                               const void* pool_k, const void* pool_v, const void* slab_ks,
                               const void* slab_vs, const void* pool_ks, const void* pool_vs,
                               const void* tables, const void* pos, const void* matched, void* out,
                               int B, int T, int K, int M, int hd, int S, int page, int n_table,
                               int chunk, int dtype, void* stream) {
  if (chunk != kChunk || B < 1 || T < 1 || K < 1 || M < 1 || T * M > 32 || page < 1 ||
      chunk % page || S % chunk || n_table < chunk / page)
    return (int)cudaErrorInvalidValue;
  if (dtype == 2 && (!slab_ks || !slab_vs || (pool_k && (!pool_ks || !pool_vs))))
    return (int)cudaErrorInvalidValue;
  const void* const a[13] = {q,       slab_k,  slab_v, pool_k, pool_v,  slab_ks, slab_vs,
                             pool_ks, pool_vs, tables, pos,    matched, out};
  const int d[7] = {B, T, K, M, S, page, n_table};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dtype<128>(dtype, a, d, s);
  if (hd == 64) return launch_dtype<64>(dtype, a, d, s);
  return (int)cudaErrorInvalidValue;
}
