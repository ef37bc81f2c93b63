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
//
// Across processes (worker mode: each process holds a run of the ranks)
// the same kernel reads all n inputs and writes only the calling
// process's outputs. Each process keeps one staging buffer with a slot per
// local rank, exported with cudaIpcGetMemHandle and mapped by its peers
// with cudaIpcOpenMemHandle (cudaIpcMemLazyEnablePeerAccess: the same
// code serves processes on several cards), and two interprocess events,
// "ready" (its partials are in its slots) and "done" (its launch has read
// every peer's slots). One all-reduce is: wait on the peers' previous
// "done", copy the partials into the slots, record "ready" (ring_ipc_stage);
// a host barrier, so every peer's record has been issued; wait on every
// peer's "ready", launch, record "done" (ring_ipc_reduce); a second host
// barrier. Ordering rests on event waits alone: processes sharing one card
// time-slice, and a flag spun on in device memory could stall a whole slice
// or hang. Every process folds every chunk in the same order, so all hold
// the same bytes.
//
// The sequence- and expert-parallel exchanges across processes (the ring
// pass's rotation of K/V chunks, the gather of attention partials, the
// expert all_to_alls and all_gather) use the same buffers and events with
// another second half: ring_ipc_fetch waits on every peer's "ready",
// copies the slot ranges the process needs out of the mapped buffers into
// its own tensors (device-to-device, never through the host) and records
// "done". The copies move bytes unchanged.

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
ring_all_reduce_kernel(InPtrs in, OutPtrs out, int n, int n_out, long long rows, int d, int w) {
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
    for (int r = 0; r < n_out; ++r) reinterpret_cast<T*>(out.p[r])[i] = s;
  }
}

template <int V>
void launch(const InPtrs& in, const OutPtrs& out, int n, int n_out, long long rows, int d, int w,
            cudaStream_t stream) {
  const long long work = rows * (d / V);
  const int grid = (int)std::min<long long>((work + kThreads - 1) / kThreads, 132LL * 16);
  ring_all_reduce_kernel<V><<<grid, kThreads, 0, stream>>>(in, out, n, n_out, rows, d, w);
}

// n inputs folded, the sum written to the n_out outputs
int reduce(const void* const* xs, void* const* outs, int n, int n_out, long long rows, int d, void* stream) {
  if (n < 1 || n > kMaxRanks || n_out < 1 || n_out > n || rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  InPtrs in{};
  OutPtrs out{};
  bool aligned = true;  // 16-byte loads and stores need 16-byte aligned bases
  for (int r = 0; r < n; ++r) {
    in.p[r] = static_cast<const float*>(xs[r]);
    aligned = aligned && reinterpret_cast<uintptr_t>(xs[r]) % 16 == 0;
  }
  for (int r = 0; r < n_out; ++r) {
    out.p[r] = static_cast<float*>(outs[r]);
    aligned = aligned && reinterpret_cast<uintptr_t>(outs[r]) % 16 == 0;
  }
  const int w = (d + 2 * n - 1) / (2 * n);  // chunk width of the 2n-padded axis
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (aligned && d % 4 == 0 && w % 4 == 0)
    launch<4>(in, out, n, n_out, rows, d, w, s);
  else
    launch<1>(in, out, n, n_out, rows, d, w, s);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes: `xs` and `outs` are host arrays of n
// device pointers, each an f32 [rows, d] tensor of one rank; 1 <= n <= 8.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ring_all_reduce(const void* const* xs, void* const* outs, int n, long long rows, int d,
                               void* stream) {
  return reduce(xs, outs, n, n, rows, d, stream);
}

// ---- K4 across processes: buffers, events, and the two halves of one call.
// Each returns a cudaError_t (0 = done); `handle` is a 64-byte IPC handle.

extern "C" int ring_ipc_alloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return (int)e;
}

extern "C" int ring_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
                             cudaIpcMemLazyEnablePeerAccess);
  return (int)e;
}

extern "C" int ring_ipc_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  return (int)(e == cudaSuccess ? cudaIpcCloseMemHandle(ptr) : e);
}

extern "C" int ring_ipc_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  return (int)(e == cudaSuccess ? cudaFree(ptr) : e);
}

extern "C" int ring_ipc_event_create(int device, void** event, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  cudaEvent_t ev = nullptr;
  if (e == cudaSuccess) e = cudaEventCreateWithFlags(&ev, cudaEventInterprocess | cudaEventDisableTiming);
  if (e == cudaSuccess) e = cudaIpcGetEventHandle(static_cast<cudaIpcEventHandle_t*>(handle), ev);
  *event = ev;
  return (int)e;
}

extern "C" int ring_ipc_event_open(int device, const void* handle, void** event) {
  cudaError_t e = cudaSetDevice(device);
  cudaEvent_t ev = nullptr;
  if (e == cudaSuccess) e = cudaIpcOpenEventHandle(&ev, *static_cast<const cudaIpcEventHandle_t*>(handle));
  *event = ev;
  return (int)e;
}

extern "C" int ring_ipc_event_destroy(int device, void* event) {
  cudaError_t e = cudaSetDevice(device);
  return (int)(e == cudaSuccess ? cudaEventDestroy(static_cast<cudaEvent_t>(event)) : e);
}

// The first half: the stream waits on each peer's "done" event, copies the
// m local partials xs[j] (`bytes` each) into slot j of `staging` (slots
// `slot_bytes` apart), and records this process's "ready" event.
extern "C" int ring_ipc_stage(int device, const void* const* xs, int m, void* staging, long long slot_bytes,
                              long long bytes, void* const* peer_done, int n_peers, void* ready, void* stream) {
  if (m < 1 || bytes > slot_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  for (int p = 0; p < n_peers && e == cudaSuccess; ++p)
    e = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(peer_done[p]), 0);
  for (int j = 0; j < m && e == cudaSuccess; ++j)
    e = cudaMemcpyAsync(static_cast<char*>(staging) + j * slot_bytes, xs[j], (size_t)bytes,
                        cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess) e = cudaEventRecord(static_cast<cudaEvent_t>(ready), s);
  return (int)e;
}

// The second half: the stream waits on each peer's "ready" event, launches
// the kernel over the n global ranks' slots `ins` (own and mapped, in
// global rank order) writing the m local outputs `outs`, and records this
// process's "done" event.
extern "C" int ring_ipc_reduce(int device, const void* const* ins, void* const* outs, int m, int n,
                               long long rows, int d, void* const* peer_ready, int n_peers, void* done,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  for (int p = 0; p < n_peers && e == cudaSuccess; ++p)
    e = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(peer_ready[p]), 0);
  if (e != cudaSuccess) return (int)e;
  int err = reduce(ins, outs, n, m, rows, d, stream);
  if (err != 0) return err;
  return (int)cudaEventRecord(static_cast<cudaEvent_t>(done), s);
}

// The other second half (the exchanges): the stream waits on each peer's
// "ready" event, copies `count` ranges of `bytes` each from `srcs` (own or
// mapped slots) to `dsts`, and records this process's "done" event.
extern "C" int ring_ipc_fetch(int device, const void* const* srcs, void* const* dsts, int count, long long bytes,
                              void* const* peer_ready, int n_peers, void* done, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  for (int p = 0; p < n_peers && e == cudaSuccess; ++p)
    e = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(peer_ready[p]), 0);
  for (int j = 0; j < count && e == cudaSuccess; ++j)
    e = cudaMemcpyAsync(dsts[j], srcs[j], (size_t)bytes, cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return (int)e;
}
