// Fused GroupNorm(+SiLU) for Hopper (sm_90a) on contiguous NCHW bf16.
//
// Replaces the TPU kernel agenda_tpu/kernels/groupnorm.py::_gn_kernel
// (groupnorm.py:94, launched by _gn_pallas at groupnorm.py:143-163): f32
// E[x] and E[x^2] group statistics, per-channel affine, optional SiLU.
//
// Numerics follow flax's default nn.GroupNorm (_compute_stats with
// use_fast_variance): var = max(0, E[x^2] - E[x]^2), biased, eps inside the
// rsqrt, statistics in f32 from the bf16 input, y = x * a + (beta - mean * a)
// with a = rstd * gamma, as the TPU kernel's mul/add form.
//
// What bounds it on the H100: about ten f32 operations per element against
// 4 bytes moved (2 read, 2 written) -- memory. The least time is 4 bytes per
// element over 3.35 TB/s, which needs x read from device memory once.
//
// Design: on contiguous NCHW one (batch, group) is one contiguous span of
// (C/G) * HW elements, moved as 16-byte chunks of 8 (hence HW % 8 == 0, as at
// every main-path layer; a chunk lies in one channel).
// - A span can be split over a thread-block cluster of up to 8 blocks: the
//   largest cluster that keeps the launch at one block an SM at most (the
//   card's SM count is read at run time). On the H100's 132 SMs the UNet's
//   B * G = 128 spans take one block each and the VAE's 64 clusters of two.
//   Clusters that take a launch past one block an SM measured slower at
//   every main-path shape there (PERF.md): a cluster's blocks wait for one
//   another, and are placed only where all of them fit at once.
// - Each block reduces its slice to one (sum, sum of squares) pair: one warp
//   shuffle of the pair and one __syncthreads. A cluster combines its blocks'
//   pairs through distributed shared memory (mapa and ld.shared::cluster
//   between two cluster barriers), in rank order, so every block gets the
//   same statistics: no second launch and no atomics, and two launches give
//   bitwise-equal outputs.
// - A block has 512 or 1024 threads. A thread keeps 8 of its chunks in
//   registers and up to 13 more in shared memory between the statistics and
//   the normalise, so x is read from device memory once wherever a block's
//   slice fits in 1024 threads x 21 chunks (172 032 elements): at every UNet
//   shape and the VAE's 64 x 64 and 128 x 128 ones. The VAE's spans of 0.5 to
//   2 M elements read the rest of their slice a second time (chip_smoke.py
//   prints how much).
// - Loads are issued in batches before the first sum waits on one, so that
//   a thread keeps several in flight.
// - SiLU is v / (1 + e^-v) with the fast divide (__fdividef).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_common.cuh"

namespace {

constexpr int kRegChunks = 8;       // chunks a thread keeps in registers
constexpr int kMaxSmemChunks = 13;  // and at most this many in shared memory
constexpr int kBatch = 4;           // loads a thread issues before it waits on one
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kSmallSpan = 1024;    // chunks: a span this small takes one block
constexpr int kMinThreads = 512;    // fewer measured slower at the small spans

struct GnParams {
  const uint4* x;  // (B, C, HW) bf16 as 16-byte chunks
  const float* gamma;
  const float* beta;
  uint4* y;
  int span;   // chunks in one (batch, group) span: (C / G) * HW / 8
  int slice;  // chunks of a span each block of its cluster takes
  int hw8;        // chunks in one channel: HW / 8
  int cg;         // channels in one group
  int G;
  int smem_chunks;  // chunks a thread keeps in shared memory, after its kRegChunks
  float inv_n, eps;
  int act_silu;
};

__device__ __forceinline__ void accumulate(const uint4& raw, float& s, float& ss) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v2[j]);
    s += f.x + f.y;
    ss += f.x * f.x + f.y * f.y;
  }
}

// y = x * a + sh (+ SiLU) of one chunk
__device__ __forceinline__ uint4 normalise(const uint4& raw, float a, float sh, int act_silu) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v2[j]);
    float u0 = f.x * a + sh, u1 = f.y * a + sh;
    if (act_silu) {
      u0 = __fdividef(u0, 1.f + __expf(-u0));
      u1 = __fdividef(u1, 1.f + __expf(-u1));
    }
    o2[j] = __floats2bfloat162_rn(u0, u1);
  }
  return out;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    groupnorm_kernel(const __grid_constant__ GnParams p) {
  extern __shared__ uint4 held[];  // [smem_chunks][THREADS]
  __shared__ float2 part[THREADS / 32];
  __shared__ float2 total;  // this block's pair, read by the cluster
  const uint32_t rank = hopper::cluster_rank(), cs = hopper::cluster_size();
  const int bg = blockIdx.x / cs;  // batch * G + group
  const int t = threadIdx.x, lane = t % 32;
  const uint4* xs = p.x + (int64_t)bg * p.span;
  uint4* ys = p.y + (int64_t)bg * p.span;
  // this thread's chunks of the span: lo + i * THREADS < hi
  const int lo = rank * p.slice + t, hi = min(p.span, (int)(rank + 1) * p.slice);
  const int streamed = lo + (kRegChunks + p.smem_chunks) * THREADS;

  // kBatch loads at a time, then the 8 chunks kept in registers, which come
  // last so that they are not live while the others are read

  float s = 0.f, ss = 0.f;
  for (int i0 = 0; i0 < p.smem_chunks; i0 += kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = lo + (kRegChunks + i0 + j) * THREADS;
      if (i0 + j < p.smem_chunks && c < hi) v[j] = xs[c];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = lo + (kRegChunks + i0 + j) * THREADS;
      if (i0 + j < p.smem_chunks && c < hi) {
        held[(i0 + j) * THREADS + t] = v[j];
        accumulate(v[j], s, ss);
      }
    }
  }
  for (int c0 = streamed; c0 < hi; c0 += kBatch * THREADS) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j * THREADS < hi) v[j] = xs[c0 + j * THREADS];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j * THREADS < hi) accumulate(v[j], s, ss);
  }
  uint4 reg[kRegChunks];
#pragma unroll
  for (int i = 0; i < kRegChunks; ++i)
    if (lo + i * THREADS < hi) reg[i] = xs[lo + i * THREADS];
#pragma unroll
  for (int i = 0; i < kRegChunks; ++i)
    if (lo + i * THREADS < hi) accumulate(reg[i], s, ss);

  // the block's pair, then the cluster's
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) part[t / 32] = make_float2(s, ss);
  __syncthreads();
  float2 sum = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    sum.x += part[w].x;
    sum.y += part[w].y;
  }
  if (cs > 1) {
    if (t == 0) total = sum;
    hopper::cluster_arrive();
    hopper::cluster_wait();
    // lane r reads block r's pair; a butterfly leaves the same sum, bit for
    // bit, in every lane of every block
    sum = lane < (int)cs ? hopper::ld_cluster_f2(&total, lane) : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      sum.x += __shfl_xor_sync(0xffffffffu, sum.x, o);
      sum.y += __shfl_xor_sync(0xffffffffu, sum.y, o);
    }
    hopper::cluster_arrive();  // done reading the other blocks' pairs
  }
  const float mean = sum.x * p.inv_n;
  const float var = fmaxf(0.f, sum.y * p.inv_n - mean * mean);
  const float rstd = rsqrtf(var + p.eps);

  const int ch0 = (bg % p.G) * p.cg;  // the group's first channel
  auto write = [&](int c, const uint4& v) {
    const int ch = ch0 + c / p.hw8;
    const float a = rstd * __ldg(p.gamma + ch);
    ys[c] = normalise(v, a, __ldg(p.beta + ch) - mean * a, p.act_silu);
  };
#pragma unroll
  for (int i = 0; i < kRegChunks; ++i)
    if (lo + i * THREADS < hi) write(lo + i * THREADS, reg[i]);
  for (int i = 0; i < p.smem_chunks; ++i) {
    const int c = lo + (kRegChunks + i) * THREADS;
    if (c < hi) write(c, held[i * THREADS + t]);
  }
  for (int c0 = streamed; c0 < hi; c0 += kBatch * THREADS) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j * THREADS < hi) v[j] = xs[c0 + j * THREADS];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j * THREADS < hi) write(c0 + j * THREADS, v[j]);
  }
  if (cs > 1) hopper::cluster_wait();  // no block leaves while another may read its pair
}

template <int THREADS>
cudaError_t launch(const GnParams& p, int blocks, int cluster, cudaStream_t stream) {
  static bool attr_set = false;  // opt in to > 48 KB of dynamic shared memory once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(groupnorm_kernel<THREADS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           THREADS * kMaxSmemChunks * 16);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = (size_t)p.smem_chunks * THREADS * 16;
  if (cluster == 1) {
    groupnorm_kernel<THREADS><<<blocks, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, groupnorm_kernel<THREADS>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How a launch splits its spans: blocks a cluster (one span), threads a
// block, and chunks a thread keeps in shared memory.
struct Plan {
  int cluster, threads, smem_chunks;
  int slice;  // chunks a block takes
};

// B * G spans of `span` chunks on a card of `sms` SMs: the largest cluster
// (1 to 8 blocks a span) that leaves the launch at most one block an SM
// (spans of at most kSmallSpan chunks take one block); the fewest threads
// that keep a block's slice in registers, else 1024 with the rest in shared
// memory as far as it goes.
Plan plan(int spans, int span, int sms) {
  Plan pl;
  pl.cluster = 1;
  if (span > kSmallSpan)
    while (pl.cluster < kMaxCluster && 2ll * spans * pl.cluster <= sms) pl.cluster *= 2;
  pl.slice = (span + pl.cluster - 1) / pl.cluster;
  pl.threads = kMinThreads;
  while (pl.threads < kMaxThreads && pl.threads * kRegChunks < pl.slice) pl.threads *= 2;
  const int rest = pl.slice - pl.threads * kRegChunks;
  pl.smem_chunks = rest <= 0 ? 0 : std::min(kMaxSmemChunks, (rest + pl.threads - 1) / pl.threads);
  return pl;
}

}  // namespace

// The plan of a launch on (B, C, HW) with G groups on the current device,
// into out[4]: cluster size, threads a block, chunks a thread keeps in shared
// memory, and chunks of each slice read twice from device memory (0 where x
// is read once). Returns 0.
extern "C" int agenda_groupnorm_plan(int B, int C, int HW, int G, long long* out) {
  const Plan pl = plan(B * G, (C / G) * (HW / 8), hopper::sm_count());
  const int kept = pl.threads * (kRegChunks + pl.smem_chunks);
  out[0] = pl.cluster;
  out[1] = pl.threads;
  out[2] = pl.smem_chunks;
  out[3] = pl.slice > kept ? pl.slice - kept : 0;
  return 0;
}

// x, y: contiguous (B, C, HW) bf16 with HW % 8 == 0 and 16-byte-aligned bases
// (the kernel moves 8 elements at a time); gamma, beta: (C,) f32. Returns a
// cudaError_t.
extern "C" int agenda_groupnorm(const void* x, const void* gamma, const void* beta, void* y,
                                int B, int C, int HW, int G, float eps, int act_silu,
                                void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || HW % 8 != 0 ||
      (long long)B * G * kMaxCluster > 0x7fffffff || (long long)(C / G) * HW / 8 > 0x3fffffff ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  GnParams p;
  p.x = static_cast<const uint4*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.y = static_cast<uint4*>(y);
  p.cg = C / G;
  p.hw8 = HW / 8;
  p.G = G;
  p.span = p.cg * p.hw8;
  p.inv_n = 1.f / (float)((int64_t)p.cg * HW);
  p.eps = eps;
  p.act_silu = act_silu;
  const Plan pl = plan(B * G, p.span, hopper::sm_count());
  p.slice = pl.slice;
  p.smem_chunks = pl.smem_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * G * pl.cluster;
  return (int)(pl.threads == kMinThreads ? launch<kMinThreads>(p, blocks, pl.cluster, st)
                                         : launch<kMaxThreads>(p, blocks, pl.cluster, st));
}
