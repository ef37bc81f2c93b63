// All-reduce over tensor-parallel ranks for Hopper (sm_90a), K4.
//
// Replaces the Pallas TPU kernel distributed_llama_tpu/ops/collectives.py
// `_make_ring_kernel` (launched by `ring_all_reduce`). That kernel walks a
// bidirectional ring over the TPU's torus links: the last axis, padded to a
// multiple of 2n, is cut into 2n chunks of width w; chunk k = 2c (clockwise)
// is reduced as the left fold over ranks c, c+1, ..., c+n-1 and chunk
// k = 2c+1 (counter-clockwise) over c, c-1, ..., c-n+1 (mod n), each sum
// formed once and then copied verbatim to every rank, so every rank holds
// the same bytes (replicated sampling relies on that).
//
// What it must keep is that function, not its hops: the ring exists so that
// each torus link direction carries half the payload, while NVLink through
// NVSwitch is all-to-all and a decode payload ([1, 4096] f32 per rank,
// 16 KB) costs a launch's latency, not bandwidth. So this is the one-shot
// form: each thread owns 4 (or 1) columns of one row, reads the n ranks'
// values in its chunk's fold order, adds them in f32 with __fadd_rn in that
// order, and writes the sum to all n outputs. No synchronisation between
// CTAs is needed when every rank's input is ready at launch (the ranks
// share one card and one stream). The padding columns are never formed:
// padding to a multiple of 2n only places the chunk boundaries.
//
// What bounds it on an H100: the bytes, n inputs read and n outputs
// written (2 n R d 4 over 3.35 TB/s), which at decode payloads is far
// below the launch itself.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 256;

struct InPtrs {
  const float* p[kMaxRanks];
};
struct OutPtrs {
  float* p[kMaxRanks];
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
  }
};

// V columns per thread; with V = 4, d and w are multiples of 4, so the V
// columns lie in one chunk.
template <int V>
__global__ void __launch_bounds__(kThreads)
ring_all_reduce_kernel(InPtrs in, OutPtrs out, int n, long long rows, int d, int w) {
  using T = typename Vec<V>::T;
  const int dv = d / V;
  const long long total = rows * dv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(i % dv) * V;
    const int k = col / w;
    const int c = k >> 1;
    const int step = (k & 1) ? n - 1 : 1;  // counter-clockwise: c - j == c + (n-1) j (mod n)
    T s = __ldg(reinterpret_cast<const T*>(in.p[c]) + i);
    for (int j = 1; j < n; ++j)
      s = Vec<V>::add(s, __ldg(reinterpret_cast<const T*>(in.p[(c + step * j) % n]) + i));
    for (int r = 0; r < n; ++r) reinterpret_cast<T*>(out.p[r])[i] = s;
  }
}

template <int V>
void launch(const InPtrs& in, const OutPtrs& out, int n, long long rows, int d, int w,
            cudaStream_t stream) {
  const long long work = rows * (d / V);
  const int grid = (int)std::min<long long>((work + kThreads - 1) / kThreads, 132LL * 16);
  ring_all_reduce_kernel<V><<<grid, kThreads, 0, stream>>>(in, out, n, rows, d, w);
}

}  // namespace

// C entry point, bound with ctypes: `xs` and `outs` are host arrays of n
// device pointers, each an f32 [rows, d] tensor of one rank; 1 <= n <= 8.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ring_all_reduce(const void* const* xs, void* const* outs, int n, long long rows, int d,
                               void* stream) {
  if (n < 1 || n > kMaxRanks || rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  InPtrs in{};
  OutPtrs out{};
  bool aligned = true;  // 16-byte loads and stores need 16-byte aligned bases
  for (int r = 0; r < n; ++r) {
    in.p[r] = static_cast<const float*>(xs[r]);
    out.p[r] = static_cast<float*>(outs[r]);
    aligned = aligned && reinterpret_cast<uintptr_t>(xs[r]) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(outs[r]) % 16 == 0;
  }
  const int w = (d + 2 * n - 1) / (2 * n);  // chunk width of the 2n-padded axis
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (aligned && d % 4 == 0 && w % 4 == 0)
    launch<4>(in, out, n, rows, d, w, s);
  else
    launch<1>(in, out, n, rows, d, w, s);
  return (int)cudaGetLastError();
}
