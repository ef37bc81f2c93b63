// The int8 Q40 x Q80 matmul fused into the all-reduce, for Hopper (sm_90a), K5.
//
// Replaces the Pallas TPU kernel distributed_llama_tpu/ops/collectives.py
// `_make_fused_matmul_ring_kernel` (launched by
// `fused_matmul_ring_all_reduce`), the wo/down projection of a
// tensor-parallel layer in decode: for each rank r,
//
//   y_r = K1(xq_r, sx_r, qs_r, scales_r) - 8 corr_r
//
// all-reduced with K4's association (chunk k of the 2n chunks of width
// w = d_pad / 2n is the left fold over the ranks c, c+1, ... for even k and
// c, c-1, ... for odd k, c = k / 2), and no y_r is ever written to device
// memory. The TPU kernel computes each chunk's matmul on demand inside its
// ring walk so the next chunk's MXU work overlaps the remote copies; here
// the ranks share one card, so the fusion keeps the n products in
// registers and shared memory and saves the launches and the [T, d] round
// trips between K1, the correction and K4.
//
// Fused equals unfused, bit for bit. The grid is one cluster of n CTAs per
// (64-column K1 tile, TT-row block); the tile lies inside one chunk k since
// w is a multiple of 64. CTA i of the cluster runs K1's own tile code
// (q40_int8_tile.cuh) on rank r_i = (c + step i) % n, the i-th rank of the
// chunk's fold order, sums the slices in K1's order, subtracts 8 corr_r
// (__fsub_rn of __fmul_rn) and leaves y_r in its shared memory. After a
// cluster barrier each CTA folds its share of the tile's elements, reading
// the n partials through distributed shared memory in CTA order, which is
// the fold order: total = y_0, then total = __fadd_rn(total, y_i). It
// writes the sum to every rank's output; a second cluster barrier keeps
// every CTA's shared memory alive until the others have read it. corr_r is
// an input, the same (sx * qsum) @ scales that the unfused path computes
// with cuBLAS in true f32: the JAX kernel computes it inside, at HIGHEST
// precision, but cuBLAS's summation order cannot be reproduced inside a
// kernel, and any other order would break the bit equality.
//
// What bounds it on an H100: at T <= 8 the n ranks' packed weight streams,
// i.e. the whole matrix's Q40 bytes, over 3.35 TB/s (as K1's bound). The
// cluster puts the n rank tiles on n SMs at once (n times the CTAs of one
// CTA per tile walking the ranks in series: 64 CTAs at d = 4096 left most
// of the 132 SMs idle).

#include <cooperative_groups.h>

#include "q40_int8_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace q40tile;

constexpr int kMaxRanks = 8;  // the portable cluster size

struct Ranks {
  const void* p[kMaxRanks];
};
struct OutRanks {
  float* p[kMaxRanks];
};

// ranks.p[r] for a CTA-uniform r, by compares against constant indices, so
// that the kernel parameters are read in place and not copied to local memory
template <typename P>
__device__ __forceinline__ P pick(const P (&p)[kMaxRanks], int r) {
  P v = p[0];
#pragma unroll
  for (int q = 1; q < kMaxRanks; ++q)
    if (q == r) v = p[q];
  return v;
}

template <int TT>
__global__ void __launch_bounds__(kThreads)
fused_matmul_ring_kernel(Ranks xq, Ranks sx, Ranks qs, Ranks scales, Ranks corr, OutRanks out, int n,
                         int T, int n_pad, int d_pad, int w) {
  __shared__ Partials<TT> red;
  __shared__ float y[TT * kColsPerCta];  // this CTA's rank term, read by the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int i = (int)cluster.block_rank();  // the position in the chunk's fold order
  const int col0 = (blockIdx.x / n) * kColsPerCta;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const int k = col0 / w;
  const int c = k >> 1;
  const int step = (k & 1) ? n - 1 : 1;  // counter-clockwise: c - i == c + (n-1) i (mod n)
  const int r = (c + step * i) % n;
  tile_partials<TT>(static_cast<const int8_t*>(pick(xq.p, r)), static_cast<const float*>(pick(sx.p, r)),
                    static_cast<const uint8_t*>(pick(qs.p, r)), static_cast<const float*>(pick(scales.p, r)),
                    n_pad, d_pad, col0, t0, nt, red);
  __syncthreads();
  const float* cr = static_cast<const float*>(pick(corr.p, r));
  for (int e = threadIdx.x; e < nt * kColsPerCta; e += kThreads) {
    const int t = e / kColsPerCta, col = e % kColsPerCta;
    y[e] = __fsub_rn(tile_sum<TT>(red, t, col), __fmul_rn(8.0f, cr[(size_t)(t0 + t) * d_pad + col0 + col]));
  }
  cluster.sync();  // every rank's term is in its CTA's shared memory
  for (int e = i + n * threadIdx.x; e < nt * kColsPerCta; e += n * kThreads) {
    float total = *cluster.map_shared_rank(&y[e], 0);
    for (int j = 1; j < n; ++j) total = __fadd_rn(total, *cluster.map_shared_rank(&y[e], j));
    const size_t o = (size_t)(t0 + e / kColsPerCta) * d_pad + col0 + e % kColsPerCta;
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q)
      if (q < n) out.p[q][o] = total;
  }
  cluster.sync();  // no CTA exits while another still reads its `y`
}

template <int TT>
int launch(const Ranks& xq, const Ranks& sx, const Ranks& qs, const Ranks& scales, const Ranks& corr,
           const OutRanks& out, int n, int T, int n_pad, int d_pad, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * (d_pad / kColsPerCta), (T + TT - 1) / TT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fused_matmul_ring_kernel<TT>, xq, sx, qs, scales, corr, out,
                                             n, T, n_pad, d_pad, d_pad / (2 * n));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster shape (x, y, z) that fused_matmul_ring launches for n ranks:
// n CTAs along x, one per rank of a column tile.
extern "C" int fused_matmul_ring_cluster(int n, int* dims) {
  if (n < 1 || n > kMaxRanks) return (int)cudaErrorInvalidValue;
  dims[0] = n;
  dims[1] = 1;
  dims[2] = 1;
  return 0;
}

// C entry point, bound with ctypes. Each pointer argument is a host array of
// n device pointers, one per rank: xq int8 [T, n_pad], sx f32 [T, n_pad/32],
// qs uint8 [n_pad/2, d_pad], scales f32 [n_pad/32, d_pad], corr f32
// [T, d_pad], outs f32 [T, d_pad]; 1 <= n <= 8, 1 <= T <= 8,
// n_pad % 64 == 0, d_pad % (2 n 64) == 0. Returns the cudaError_t of the
// cluster launch (0 = launched).
extern "C" int fused_matmul_ring(const void* const* xq, const void* const* sx, const void* const* qs,
                                 const void* const* scales, const void* const* corr, void* const* outs,
                                 int n, int T, int n_pad, int d_pad, void* stream) {
  if (n < 1 || n > kMaxRanks || T < 1 || T > 8 || n_pad % 64 || d_pad % (2 * n * kColsPerCta))
    return (int)cudaErrorInvalidValue;
  Ranks rx{}, rsx{}, rqs{}, rsc{}, rc{};
  OutRanks ro{};
  for (int r = 0; r < n; ++r) {
    rx.p[r] = xq[r];
    rsx.p[r] = sx[r];
    rqs.p[r] = qs[r];
    rsc.p[r] = scales[r];
    rc.p[r] = corr[r];
    ro.p[r] = static_cast<float*>(outs[r]);
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (T == 1) return launch<1>(rx, rsx, rqs, rsc, rc, ro, n, T, n_pad, d_pad, s);
  if (T <= 4) return launch<4>(rx, rsx, rqs, rsc, rc, ro, n, T, n_pad, d_pad, s);
  return launch<8>(rx, rsx, rqs, rsc, rc, ro, n, T, n_pad, d_pad, s);
}
