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
// and the chunks' (m, l, o) partials fold in chunk order with the
// online-softmax formula and its isfinite guards; the output is
// o / max(l, 1e-30). round_cdt rounds to the compute dtype: the cache dtype
// for bf16 and f32 caches, bf16 for the int8 cache. The chunk stays the
// softmax unit: p's bf16 rounding depends on the chunk max.
//
// The int8 cache (the JAX QuantizedKV) stores int8 rows with one f32 scale
// per (position, kv head), laid out as the data with hd replaced by 1. Its
// arithmetic is the JAX package's, in its order:
//
//   s = (dot(round_bf16(q), k_int8) * kscale) / sqrt(hd)   each product exact in f32
//   w = round_bf16(p * vscale), o = sum w * v_int8         l sums the unscaled p
//
// What bounds it on an H100: the bytes. Each live KV position is read once
// (2 * K * hd * sizeof(cache dtype) per position and row, plus 2 * K * 4
// bytes of scales for int8) with a few FMAs per byte and query, far below
// the card's operations-per-byte ridge: the bound is live KV bytes over
// 3.35 TB/s. Reaching it takes tens of KB in flight on every SM.
//
// Design. Two launches:
// (1) `partials_kernel`, grid (S/512 chunks x kClusterCtas, K, B x query
//     blocks), 128 threads, fixed by S and never by max(pos). Each chunk is
//     shared by a thread-block cluster of kClusterCtas = 4 CTAs, each
//     taking 128 positions (two 64-position pages). A CTA takes at most 32
//     of a row's T*M queries (fewer where they would not fit its shared
//     memory): more queries add query blocks, each reading the slice again,
//     and leave every query's arithmetic as it is. A CTA resolves its page
//     ids once per page and each slot's source once, then issues q, the
//     int8 scales and its K slice as one cp.async group and its V slice as
//     a second, 16 bytes a thread: 32-64 KB in flight per CTA, V landing
//     while the scores and the softmax run (where both slices and the
//     queries' arrays would not fit the 227 KB a CTA may opt into, as for
//     an f32 cache at hd 256, V lands in K's buffer after the scores). A
//     row's 16-byte segments are stored XOR-swizzled by row, so
//     neighbouring rows read at one segment hit distinct banks. Scores: a
//     thread per slot, each query's dot one f32 chain over hd in order, no
//     cross-lane sums. The CTAs of a cluster exchange their per-query
//     maxima through distributed shared memory, so every p is rounded
//     against the chunk max, as a one-CTA chunk would. p is exp rounded
//     once to f32 (through f64): an ulp of exp flips a bf16 weight, and
//     the correctly rounded value is what the plain version's CPU exp
//     returns for ~99% of arguments. The value mix gives a thread 4
//     elements of hd and a group of slots summed in order (hd 128: 4
//     groups of 32), the groups then summed in order; the cluster sums its
//     CTAs' (l, o) in rank order, and the chunk's (m, l, o) go to the
//     workspace f32 [B, K, S/512, T*M, hd + 2]. A cluster whose chunk lies
//     past the row's live bound ceil((pos[b]+T)/512) writes the empty
//     partial (m = -inf, l = 0, o = 0) and exits.
// (2) `merge_kernel`, one CTA per (row, kv head, block of queries whose
//     fold factors fit 48 KB of shared memory), folds chunks 0..S/512-1 in
//     order (the empty partial folds as an exact identity) and writes
//     o / max(l, 1e-30).
//
// Head sizes: any multiple of 16 up to 256; 64 and 128 are compiled for
// their size, the others read it at run time.
//
// Contracts:
// - A query's arithmetic is fixed by absolute position (chunk, cluster
//   rank, lane) and never by T, B, the other rows, max(pos) or the SM
//   count: a verify window's row t equals a decode launch at pos+t, and a
//   row is the same alone or in a batch, bit for bit. A position that a
//   query masks adds exact zeros; positions past the live bound are
//   neither read nor summed.
// - The same KV through a pool page or the slab gives the same bits.
// - No atomics, no floating-point sum in an order that depends on timing:
//   two launches on the same inputs give the same bits.
// - pos and matched stay on the device; the kernels allocate nothing (the
//   caller passes the workspace).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 512;
constexpr int kClusterCtas = 4;
constexpr int kSlice = kChunk / kClusterCtas;  // positions per CTA
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeThreads = 128;
constexpr int kMaxHeadSize = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// EPL = 16 / sizeof(T) elements of a row as floats, from one 16-byte word
template <typename T, int EPL>
__device__ __forceinline__ void unpack16(const T* p, float (&x)[EPL]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < EPL; ++i) x[i] = to_f(e[i]);
}

// 4 consecutive row elements as floats (8, 4 or 16 bytes)
__device__ __forceinline__ void unpack4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}
__device__ __forceinline__ void unpack4(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = static_cast<float>(v.x);
  x[1] = static_cast<float>(v.y);
  x[2] = static_cast<float>(v.z);
  x[3] = static_cast<float>(v.w);
}
__device__ __forceinline__ void unpack4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// exp rounded once to f32, from the f64 exp: p an ulp off can flip a
// weight's bf16 rounding, and CUDA's expf (up to 2 ulp) is off far more
// often than the correctly rounded value, which the plain version's exp on
// the CPU returns for all but ~1% of arguments
__device__ __forceinline__ float exp_rn(float x) { return __double2float_rn(exp(static_cast<double>(x))); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shared memory of one partials CTA, in bytes: the K slice and (unless
// `serial`, where V lands in K's buffer once the scores are done) the V
// slice, then f32 arrays, then the slots' offsets and the page ids
__host__ __device__ constexpr size_t kv_bytes(int esize, int hd) { return (size_t)kSlice * hd * esize; }
// queries per value-mix pass (4 accumulators each, at most 32 registers)
__host__ __device__ constexpr int mix_queries(int tmax) { return tmax < 8 ? tmax : 8; }
// f32 words of one partials CTA after the KV slices; qr = min(tm, QB)
__host__ __device__ constexpr int smem_floats(int tm, int hd, int qr) {
  return 2 * kSlice            // k and v scales (int8)
         + tm * hd             // q (rounded)
         + tm * kSlice         // scores, then rounded weights
         + kThreads * 4 * qr   // the value mix's per-group partials
         + tm * hd             // this CTA's o (read by the cluster)
         + 3 * tm;             // local max (read by the cluster), chunk max, local l
}
// tm: the queries of one CTA (its query block)
__host__ __device__ constexpr size_t smem_bytes(int esize, int hd, int tm, int tmax, bool serial) {
  const int qr = tm < mix_queries(tmax) ? tm : mix_queries(tmax);
  return (serial ? 1 : 2) * kv_bytes(esize, hd) + (size_t)((smem_floats(tm, hd, qr) + 1) & ~1) * sizeof(float) +
         kSlice * (sizeof(long long) + sizeof(int));
}
// the value mix's slot groups: a power of two of them, each taking hd / 4
// threads (4 elements of hd a thread)
__host__ __device__ constexpr int mix_groups(int hd) {
  int g = 1;
  while (2 * g * (hd / 4) <= kThreads) g *= 2;
  return g;
}

// HD_: the head size, or 0 for one read at run time (`hd`); TMAX: the most
// queries a CTA takes. A CTA takes the queries [qb * QBLK, + TMl) of its row
// (grid z = row x query block): a query's arithmetic never depends on
// which others share its CTA.
template <typename T, int HD_, int TMAX, bool SERIAL>
__global__ void __cluster_dims__(kClusterCtas, 1, 1) __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ q, const T* __restrict__ slab_k, const T* __restrict__ slab_v,
                const T* __restrict__ pool_k, const T* __restrict__ pool_v,
                const float* __restrict__ slab_ks, const float* __restrict__ slab_vs,
                const float* __restrict__ pool_ks, const float* __restrict__ pool_vs,
                const int* __restrict__ tables, const int* __restrict__ pos, const int* __restrict__ matched,
                float* __restrict__ ws, int T_, int K, int M, int S, int page, int n_table, float scale, int hd,
                int qblk) {
  constexpr int EPL = 16 / sizeof(T);  // row elements in one 16-byte segment
  const int HD = HD_ ? HD_ : hd;
  const int LPR = HD / EPL;            // segments per row
  const int SWZ = ((LPR & -LPR) < 8 ? (LPR & -LPR) : 8) - 1;  // stays inside the row
  const int kMixLanes = HD / 4;        // threads per row in the value mix
  const int kGroups = mix_groups(HD);
  const int kGroupLen = kSlice / kGroups;
  constexpr int QB = mix_queries(TMAX);
  static_assert(kThreads == kSlice, "the scores take a thread per slot");
  constexpr bool kQuant = Cache<T>::kQuant;
  using Cdt = typename Cache<T>::Compute;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TM = T_ * M;                // the row's queries
  const int nqb = (TM + qblk - 1) / qblk;
  const int q_base = (int)(blockIdx.z % nqb) * qblk;
  const int TMl = min(qblk, TM - q_base);  // this CTA's queries
  const int QR = TMl < QB ? TMl : QB;
  T* s_k = reinterpret_cast<T*>(smem_raw);
  T* s_v = SERIAL ? s_k : s_k + kSlice * HD;
  float* s_ks = reinterpret_cast<float*>(smem_raw + (SERIAL ? 1 : 2) * kv_bytes(sizeof(T), HD));
  float* s_vs = s_ks + kSlice;
  float* s_q = s_vs + kSlice;
  float* s_p = s_q + TMl * HD;
  float* s_red = s_p + TMl * kSlice;  // 16-byte aligned, as s_q and s_o
  float* s_o = s_red + kThreads * 4 * QR;
  float* s_mx = s_o + TMl * HD;
  float* s_cm = s_mx + TMl;
  float* s_l = s_cm + TMl;
  long long* s_off = reinterpret_cast<long long*>(s_ks + ((smem_floats(TMl, HD, QR) + 1) & ~1));
  int* s_pid = reinterpret_cast<int*>(s_off + kSlice);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunk = blockIdx.x / kClusterCtas;
  const int k = blockIdx.y;
  const int b = blockIdx.z / nqb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = S / kChunk;
  const int p0 = pos[b];
  const int mt = matched[b];
  const int live = min(p0 + T_, S);  // positions any query of this row may see
  float* wsc = ws + ((((size_t)b * K + k) * n_chunks + chunk) * TM + q_base) * (HD + 2);
  if (chunk * kChunk >= live) {  // the whole cluster: the empty partial
    for (int e = rank * kThreads + tid; e < TMl * (HD + 2); e += kClusterCtas * kThreads)
      wsc[e] = e % (HD + 2) == 0 ? -INFINITY : 0.f;
    return;
  }
  const int off0 = rank * kSlice;           // this CTA's first slot in the chunk
  const int start = chunk * kChunk + off0;  // its absolute position
  const int n_live = max(0, min(kSlice, live - start));
  const long long row_stride = (long long)K * HD;  // elements between two positions

  // page ids once per page touching this CTA's slots (when any is pooled),
  // each slot's offset once (a pool page's row stored as ~offset), then q,
  // the scales and K as one cp.async group and V as a second, landing
  // while the scores and the softmax run (SERIAL: V once the scores are
  // done, into K's buffer)
  const int ppc = kChunk / page;
  const int pg0 = off0 / page;
  if (mt > start) {
    const int base = min(max(chunk * ppc, 0), n_table - ppc);
    const int npg = (off0 + kSlice - 1) / page - pg0 + 1;
    for (int i = tid; i < npg; i += kThreads) s_pid[i] = tables[(size_t)b * n_table + base + pg0 + i];
  }
  __syncthreads();
  for (int j = tid; j < n_live; j += kThreads) {
    long long o;
    if (start + j < mt) {
      const int r = off0 + j;
      o = ~(((long long)s_pid[r / page - pg0] * page + r % page) * row_stride + (long long)k * HD);
    } else {
      o = ((long long)b * S + start + j) * row_stride + (long long)k * HD;
    }
    s_off[j] = o;
    if (kQuant) {  // an int8 slot's scales sit at its data offset / hd
      const bool pooled = o < 0;
      const long long so = (pooled ? ~o : o) / HD;
      cp_async4(s_ks + j, (pooled ? pool_ks : slab_ks) + so);
      cp_async4(s_vs + j, (pooled ? pool_vs : slab_vs) + so);
    }
  }
  for (int s = tid; s < TMl * HD / 4; s += kThreads) {
    const int qi = q_base + s * 4 / HD;
    cp_async16(s_q + s * 4, q + ((((size_t)b * T_ + qi / M) * K + k) * M + qi % M) * HD + s * 4 % HD);
  }
  __syncthreads();
  // a row's 16-byte segment seg lands at seg ^ (j & SWZ), so that
  // neighbouring rows read at one logical segment hit distinct banks
  auto issue_rows = [&](T* dst, const T* slab, const T* pool) {
    for (int s = tid; s < n_live * LPR; s += kThreads) {
      const int j = s / LPR;
      const int seg = s % LPR;
      const long long o = s_off[j];
      cp_async16(dst + j * HD + (seg ^ (j & SWZ)) * EPL, (o < 0 ? pool + ~o : slab + o) + seg * EPL);
    }
    cp_commit();
  };
  issue_rows(s_k, slab_k, pool_k);
  if (!SERIAL) {
    issue_rows(s_v, slab_v, pool_v);
    cp_wait<1>();  // q, the scales and K
  } else {
    cp_wait<0>();
  }
  __syncthreads();
  for (int e = tid; e < TMl * HD; e += kThreads) s_q[e] = round_cdt<Cdt>(s_q[e]);
  __syncthreads();

  // scores: a thread per slot, every query's dot in one f32 chain over
  // hd in order (the queries are read as broadcasts), no cross-lane sums
  {
    const int j = tid;
    if (j < n_live) {
      float acc[TMAX];
#pragma unroll
      for (int qi = 0; qi < TMAX; ++qi) acc[qi] = 0.f;
      const T* kr = s_k + j * HD;
#pragma unroll 2
      for (int seg = 0; seg < LPR; ++seg) {
        float kx[EPL];
        unpack16<T, EPL>(kr + (seg ^ (j & SWZ)) * EPL, kx);
#pragma unroll
        for (int qi = 0; qi < TMAX; ++qi) {
          if (qi < TMl) {
            const float4* qq = reinterpret_cast<const float4*>(s_q + qi * HD + seg * EPL);
#pragma unroll
            for (int e4 = 0; e4 < EPL / 4; ++e4) {
              const float4 q4 = qq[e4];
              acc[qi] = fmaf(q4.x, kx[4 * e4], acc[qi]);
              acc[qi] = fmaf(q4.y, kx[4 * e4 + 1], acc[qi]);
              acc[qi] = fmaf(q4.z, kx[4 * e4 + 2], acc[qi]);
              acc[qi] = fmaf(q4.w, kx[4 * e4 + 3], acc[qi]);
            }
          }
        }
      }
      const float ks = kQuant ? s_ks[j] : 1.f;
#pragma unroll
      for (int qi = 0; qi < TMAX; ++qi) {
        if (qi < TMl) {
          float a = acc[qi];
          if (kQuant) a = __fmul_rn(a, ks);  // the key scale after the raw dot
          s_p[qi * kSlice + j] = a / scale;
        }
      }
    }
  }
  __syncthreads();
  if (SERIAL) issue_rows(s_v, slab_v, pool_v);  // K is read: V takes its buffer

  // this CTA's max per query over the slots it sees, shared with the cluster
  for (int qi = warp; qi < TMl; qi += kWarps) {
    const int lim = min(p0 + (q_base + qi) / M - start, n_live - 1);  // visible slots j <= lim
    float mx = -INFINITY;
    for (int j = lane; j <= lim; j += 32) mx = fmaxf(mx, s_p[qi * kSlice + j]);
    mx = warp_max(mx);
    if (lane == 0) s_mx[qi] = mx;
  }
  cluster.sync();

  // the chunk max (exact in any order), p, l over this slice, rounded weights
  for (int qi = warp; qi < TMl; qi += kWarps) {
    float mx = -INFINITY;
    for (int r = 0; r < kClusterCtas; ++r) mx = fmaxf(mx, cluster.map_shared_rank(s_mx, r)[qi]);
    const float safe = isfinite(mx) ? mx : 0.f;
    const int lim = min(p0 + (q_base + qi) / M - start, n_live - 1);
    float* sp = s_p + qi * kSlice;
    float sum = 0.f;
    for (int j = lane; j < kSlice; j += 32) {
      float w = 0.f;
      if (j <= lim) {
        const float p = exp_rn(sp[j] - safe);
        sum = __fadd_rn(sum, p);
        // int8: the value scale folds into the weight before its rounding
        w = kQuant ? round_cdt<Cdt>(__fmul_rn(p, s_vs[j])) : round_cdt<Cdt>(p);
      }
      sp[j] = w;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s_cm[qi] = mx;
      s_l[qi] = sum;
    }
  }
  cp_wait<0>();  // V
  __syncthreads();

  // value mix: thread = (4 elements of hd, group of kGroupLen slots
  // summed in order), QB queries at a time; the groups then sum in order
  {
    const int e0 = (tid % kMixLanes) * 4;
    const int g = tid / kMixLanes;  // threads past the last group only sync
    const int j_begin = g * kGroupLen;
    const int j_end = min(j_begin + kGroupLen, n_live);
    for (int q0 = 0; q0 < TMl; q0 += QB) {
      float acc[QB][4];
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int j = j_begin; j < j_end; ++j) {
        float vx[4];
        unpack4(s_v + j * HD + ((e0 / EPL) ^ (j & SWZ)) * EPL + e0 % EPL, vx);
#pragma unroll
        for (int i = 0; i < QB; ++i) {
          if (q0 + i < TMl) {
            const float w = s_p[(q0 + i) * kSlice + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(w, vx[e], acc[i][e]);
          }
        }
      }
      if (g < kGroups) {
#pragma unroll
        for (int i = 0; i < QB; ++i)
          if (q0 + i < TMl)
            *reinterpret_cast<float4*>(s_red + ((size_t)g * QR + i) * HD + e0) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      for (int e = tid; e < QR * HD; e += kThreads) {
        if (q0 + e / HD < TMl) {
          float o = s_red[e];
#pragma unroll
          for (int g2 = 1; g2 < kGroups; ++g2) o = __fadd_rn(o, s_red[(size_t)g2 * QR * HD + e]);
          s_o[q0 * HD + e] = o;
        }
      }
      __syncthreads();
    }
  }
  cluster.sync();

  // the chunk's (m, l, o): l and o summed over the cluster in rank order,
  // each CTA writing a share of the elements
  for (int e = rank * kThreads + tid; e < TMl * (HD + 2); e += kClusterCtas * kThreads) {
    const int qi = e / (HD + 2);
    const int f = e % (HD + 2);
    float v;
    if (f == 0) {
      v = s_cm[qi];
    } else {
      float* src = f == 1 ? s_l + qi : s_o + qi * HD + (f - 2);
      v = *cluster.map_shared_rank(src, 0);
#pragma unroll
      for (int r = 1; r < kClusterCtas; ++r) v = __fadd_rn(v, *cluster.map_shared_rank(src, r));
    }
    wsc[e] = v;
  }
  cluster.sync();  // no CTA leaves while the cluster reads its shared memory
}

// fold the chunk partials of one (row, kv head, query block) in chunk
// order: a thread per query folds (m, l) and keeps each chunk's two factors
// in shared memory; then every (query, hd element) folds its o with those
// factors, its loads independent of one another. HD_ as partials_kernel.
template <int HD_>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ ws, float* __restrict__ out, int T_, int K, int M, int n_chunks, int hd,
             int qblk) {
  extern __shared__ float s_f[];  // [QM][n_chunks] a1, then a2, then the final l [QM]
  const int HD = HD_ ? HD_ : hd;
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int TM = T_ * M;
  const int q_base = blockIdx.z * qblk;
  const int TMl = min(qblk, TM - q_base);
  float* s_a1 = s_f;
  float* s_a2 = s_a1 + TMl * n_chunks;
  float* s_lf = s_a2 + TMl * n_chunks;
  const float* w = ws + (((size_t)b * K + k) * n_chunks * TM + q_base) * (HD + 2);
  for (int qi = threadIdx.x; qi < TMl; qi += kMergeThreads) {
    float m = -INFINITY, l = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* pc = w + ((size_t)c * TM + qi) * (HD + 2);
      const float mc = pc[0];
      const float m_new = fmaxf(m, mc);
      const float sf = isfinite(m_new) ? m_new : 0.f;
      const float a1 = isfinite(m) ? expf(m - sf) : 0.f;
      const float a2 = isfinite(mc) ? expf(mc - sf) : 0.f;
      l = __fadd_rn(__fmul_rn(l, a1), __fmul_rn(pc[1], a2));
      m = m_new;
      s_a1[qi * n_chunks + c] = a1;
      s_a2[qi * n_chunks + c] = a2;
    }
    s_lf[qi] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TMl * HD; e += kMergeThreads) {
    const int qi = e / HD;
    const int h = e % HD;
    const float* pc = w + (size_t)qi * (HD + 2) + 2 + h;
    const float* a1 = s_a1 + qi * n_chunks;
    const float* a2 = s_a2 + qi * n_chunks;
    float o = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_chunks; ++c)
      o = __fadd_rn(__fmul_rn(o, a1[c]), __fmul_rn(pc[(size_t)c * TM * (HD + 2)], a2[c]));
    const int qg = q_base + qi;
    out[((((size_t)b * T_ + qg / M) * K + k) * M + qg % M) * HD + h] = o / s_lf[qi];
  }
}

int max_smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// a[] = q, slab_k, slab_v, pool_k, pool_v, slab_ks, slab_vs, pool_ks,
// pool_vs, tables, pos, matched, out, ws; d[] = B, T, K, M, S, page,
// n_table, hd; the query block qblk as launch_tm chose it
template <typename T, int HD_, int TMAX, bool SERIAL>
int launch_partials(const void* const* a, const int* d, int qblk, cudaStream_t stream) {
  const int B = d[0], nT = d[1], K = d[2], M = d[3], S = d[4], page = d[5], n_table = d[6], hd = d[7];
  auto kernel = partials_kernel<T, HD_, TMAX, SERIAL>;
  const int tm = nT * M;
  const size_t bytes = smem_bytes(sizeof(T), hd, tm < qblk ? tm : qblk, TMAX, SERIAL);
  static size_t configured = 0;  // the opt-in above 48 KB, raised as needed per instantiation
  if (bytes > configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const float scale = sqrtf(static_cast<float>(hd));
  const int nqb = (tm + qblk - 1) / qblk;
  kernel<<<dim3(S / kChunk * kClusterCtas, K, B * nqb), kThreads, bytes, stream>>>(
      static_cast<const float*>(a[0]), static_cast<const T*>(a[1]), static_cast<const T*>(a[2]),
      static_cast<const T*>(a[3]), static_cast<const T*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const float*>(a[6]), static_cast<const float*>(a[7]),
      static_cast<const float*>(a[8]), static_cast<const int*>(a[9]),
      static_cast<const int*>(a[10]), static_cast<const int*>(a[11]),
      static_cast<float*>(const_cast<void*>(a[13])), nT, K, M, S, page, n_table, scale, hd, qblk);
  return (int)cudaGetLastError();
}

int launch_merge(const void* ws, void* out, int B, int T, int K, int M, int hd, int S, cudaStream_t stream) {
  const int n_chunks = S / kChunk;
  const int tm = T * M;
  // queries per CTA such that their fold factors fit in 48 KB
  const int per_q = (2 * n_chunks + 1) * (int)sizeof(float);
  const int qblk = max(1, min(tm, 48 * 1024 / per_q));
  if ((size_t)qblk * per_q > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, B, (tm + qblk - 1) / qblk);
  const size_t bytes = (size_t)qblk * per_q;
  const auto* w = static_cast<const float*>(ws);
  auto* o = static_cast<float*>(out);
  if (hd == 128)
    merge_kernel<128><<<grid, kMergeThreads, bytes, stream>>>(w, o, T, K, M, n_chunks, hd, qblk);
  else if (hd == 64)
    merge_kernel<64><<<grid, kMergeThreads, bytes, stream>>>(w, o, T, K, M, n_chunks, hd, qblk);
  else
    merge_kernel<0><<<grid, kMergeThreads, bytes, stream>>>(w, o, T, K, M, n_chunks, hd, qblk);
  return (int)cudaGetLastError();
}

// the query block (at most 32 queries, the most that fit the opt-in shared
// memory), then the TMAX instantiation; SERIAL (V in K's buffer) only where
// no query block fits both slices, which only an f32 cache at a head size
// read at run time reaches
template <typename T, int HD_, bool SERIAL>
int launch_fitting(const void* const* a, const int* d, cudaStream_t stream) {
  const int tm = d[1] * d[3], hd = d[7];
  const size_t limit = (size_t)max_smem_optin();
  const int qblks[] = {32, 16, 8, 4, 1};
  for (const int qblk : qblks) {
    const int q = tm < qblk ? tm : qblk;
    const int tmax = q <= 1 ? 1 : q <= 4 ? 4 : q <= 8 ? 8 : q <= 16 ? 16 : 32;
    if (smem_bytes(sizeof(T), hd, q, tmax, SERIAL) > limit) continue;
    switch (tmax) {
      case 1: return launch_partials<T, HD_, 1, SERIAL>(a, d, q, stream);
      case 4: return launch_partials<T, HD_, 4, SERIAL>(a, d, q, stream);
      case 8: return launch_partials<T, HD_, 8, SERIAL>(a, d, q, stream);
      case 16: return launch_partials<T, HD_, 16, SERIAL>(a, d, q, stream);
      default: return launch_partials<T, HD_, 32, SERIAL>(a, d, q, stream);
    }
  }
  return -1;  // nothing fits
}

template <typename T, int HD_>
int launch_tm(const void* const* a, const int* d, cudaStream_t stream) {
  const int err = launch_fitting<T, HD_, false>(a, d, stream);
  if (err != -1) return err;
  if constexpr (HD_ == 0 && sizeof(T) == 4) return launch_fitting<T, HD_, true>(a, d, stream);
  return (int)cudaErrorInvalidValue;
}

template <int HD_>
int launch_dtype(int dtype, const void* const* a, const int* d, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_tm<float, HD_>(a, d, stream);
    case 1: return launch_tm<__nv_bfloat16, HD_>(a, d, stream);
    case 2: return launch_tm<int8_t, HD_>(a, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// the head sizes K2 serves: multiples of 16 up to 256
bool head_size_ok(int hd) { return hd >= 16 && hd <= kMaxHeadSize && hd % 16 == 0; }

int partials(const void* q, const void* slab_k, const void* slab_v, const void* pool_k, const void* pool_v,
             const void* slab_ks, const void* slab_vs, const void* pool_ks, const void* pool_vs,
             const void* tables, const void* pos, const void* matched, void* out, void* ws, int B, int T, int K,
             int M, int hd, int S, int page, int n_table, int chunk, int dtype, cudaStream_t stream) {
  if (chunk != kChunk || B < 1 || T < 1 || K < 1 || M < 1 || page < 1 || chunk % page || S % chunk ||
      n_table < chunk / page || !head_size_ok(hd) || !ws)
    return (int)cudaErrorInvalidValue;
  if (dtype == 2 && (!slab_ks || !slab_vs || (pool_k && (!pool_ks || !pool_vs))))
    return (int)cudaErrorInvalidValue;
  if (misaligned(slab_k) || misaligned(slab_v) || misaligned(pool_k) || misaligned(pool_v))
    return (int)cudaErrorMisalignedAddress;
  const void* const a[14] = {q,       slab_k,  slab_v, pool_k,  pool_v, slab_ks, slab_vs,
                             pool_ks, pool_vs, tables, pos,     matched, out,   ws};
  const int d[8] = {B, T, K, M, S, page, n_table, hd};
  if (hd == 128) return launch_dtype<128>(dtype, a, d, stream);
  if (hd == 64) return launch_dtype<64>(dtype, a, d, stream);
  return launch_dtype<0>(dtype, a, d, stream);
}

}  // namespace

// C entry points, bound with ctypes. Shapes: q f32 [B, T, K, M, hd]; slab
// halves [B_max >= B, S, K, hd] and pool halves [P, page, K, hd], all of one
// cache dtype (dtype 0 = f32, 1 = bf16, 2 = int8), contiguous and 16-byte
// aligned; for int8 the four scale arrays are f32 [B_max, S, K, 1] (slab)
// and [P, page, K, 1] (pool), null otherwise; tables int32 [B, n_table];
// pos, matched int32 [B]; out f32 [B, T, K, M, hd]; ws f32 workspace
// [B, K, S / chunk, T * M, hd + 2], written whole by the first pass. The
// pool pointers may be null when every matched[b] is 0. Requires
// chunk == 512, hd a multiple of 16 in [16, 256], chunk % page == 0,
// S % chunk == 0 and n_table >= chunk / page; any T * M. Each returns the
// cudaError_t of its launches.
//
// paged_attention: both passes (the chunk partials, then the fold).
extern "C" int paged_attention(const void* q, const void* slab_k, const void* slab_v, const void* pool_k,
                               const void* pool_v, const void* slab_ks, const void* slab_vs,
                               const void* pool_ks, const void* pool_vs, const void* tables, const void* pos,
                               const void* matched, void* out, void* ws, int B, int T, int K, int M, int hd,
                               int S, int page, int n_table, int chunk, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int err = partials(q, slab_k, slab_v, pool_k, pool_v, slab_ks, slab_vs, pool_ks, pool_vs, tables, pos,
                           matched, out, ws, B, T, K, M, hd, S, page, n_table, chunk, dtype, s);
  if (err != 0) return err;
  return launch_merge(ws, out, B, T, K, M, hd, S, s);
}

// paged_attention_partials: the first pass alone (writes ws; out unused)
extern "C" int paged_attention_partials(const void* q, const void* slab_k, const void* slab_v,
                                        const void* pool_k, const void* pool_v, const void* slab_ks,
                                        const void* slab_vs, const void* pool_ks, const void* pool_vs,
                                        const void* tables, const void* pos, const void* matched, void* out,
                                        void* ws, int B, int T, int K, int M, int hd, int S, int page,
                                        int n_table, int chunk, int dtype, void* stream) {
  return partials(q, slab_k, slab_v, pool_k, pool_v, slab_ks, slab_vs, pool_ks, pool_vs, tables, pos, matched,
                  out, ws, B, T, K, M, hd, S, page, n_table, chunk, dtype, reinterpret_cast<cudaStream_t>(stream));
}

// paged_attention_merge: the second pass alone, ws -> out
extern "C" int paged_attention_merge(const void* ws, void* out, int B, int T, int K, int M, int hd, int S,
                                     int chunk, void* stream) {
  if (chunk != kChunk || B < 1 || T < 1 || K < 1 || M < 1 || S % chunk || !head_size_ok(hd))
    return (int)cudaErrorInvalidValue;
  return launch_merge(ws, out, B, T, K, M, hd, S, reinterpret_cast<cudaStream_t>(stream));
}
