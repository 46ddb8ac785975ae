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
// (C/G) * HW elements, moved as 16-byte chunks of 8.
// - Where HW % 8 == 0 and x is 16-byte aligned (every layer of a 512x512
//   sample), each span starts on a chunk and a chunk lies in one channel.
// - Otherwise (the tail path: the UNet's 6x6 and 10x10 levels at 384 and 640,
//   any base alignment) a span keeps its 16-byte moves from its first aligned
//   element on; the up to 7 elements before it (head) and after its last
//   whole chunk (tail) are read and written one at a time by the first and
//   the last block of the span, and a chunk's 8 elements take their own
//   channel's weight and bias, since a chunk may cross a channel boundary.
//   The two are separate instantiations: the tail path, run at the aligned
//   shapes, measured slower over a generation batch's group norms on an
//   H100 (kernel_variants.py gn_tail_everywhere; PERF.md has the times).
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
  const uint4* x;  // (B, C, HW) bf16, as 16-byte chunks where 16-byte aligned
  const float* gamma;
  const float* beta;
  uint4* y;   // as x, with the same address mod 16
  int span;   // the aligned path's chunks in one (batch, group) span: n / 8
  int slice;  // chunks of a span each block of its cluster takes
  int hw8;        // the aligned path's chunks in one channel: HW / 8
  int cg;         // channels in one group
  int G;
  int smem_chunks;  // chunks a thread keeps in shared memory, after its kRegChunks
  float inv_n, eps;
  int act_silu;
  int n;   // elements in one span: (C / G) * HW
  int hw;  // elements in one channel
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

__device__ __forceinline__ float affine_act(float v, float a, float sh, int act_silu) {
  float u = v * a + sh;
  if (act_silu) u = __fdividef(u, 1.f + __expf(-u));
  return u;
}

// the tail path's chunk: elements e .. e + 7 of the span, each with its own
// channel's a and sh (the same arithmetic as normalise)
__device__ __forceinline__ uint4 normalise_mixed(const uint4& raw, int e, const GnParams& p,
                                                 int ch0, float mean, float rstd) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
  int ch = e / p.hw;
  int left = (ch + 1) * p.hw - e;  // elements of channel ch from e on
  float a = rstd * __ldg(p.gamma + ch0 + ch);
  float sh = __ldg(p.beta + ch0 + ch) - mean * a;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j == left) {
      ++ch;
      left += p.hw;
      a = rstd * __ldg(p.gamma + ch0 + ch);
      sh = __ldg(p.beta + ch0 + ch) - mean * a;
    }
    o[j] = __float2bfloat16_rn(affine_act(__bfloat162float(v[j]), a, sh, p.act_silu));
  }
  return out;
}

template <int THREADS, bool TAIL>
__global__ void __launch_bounds__(THREADS)
    groupnorm_kernel(const __grid_constant__ GnParams p) {
  extern __shared__ uint4 held[];  // [smem_chunks][THREADS]
  __shared__ float2 part[THREADS / 32];
  __shared__ float2 total;  // this block's pair, read by the cluster
  const uint32_t rank = hopper::cluster_rank(), cs = hopper::cluster_size();
  const int bg = blockIdx.x / cs;  // batch * G + group
  const int t = threadIdx.x, lane = t % 32;
  // the span's whole chunks start at xs, ys; on the tail path, the head
  // elements before its first 16-byte boundary and the tail ones after its
  // last whole chunk are moved one at a time
  const __nv_bfloat16* const xe = reinterpret_cast<const __nv_bfloat16*>(p.x);
  __nv_bfloat16* const ye = reinterpret_cast<__nv_bfloat16*>(p.y);
  const int64_t e0 = (int64_t)bg * p.n;  // the span's first element
  int head = 0, span = p.span, tail0 = p.n;
  const uint4* xs = p.x + (int64_t)bg * p.span;
  uint4* ys = p.y + (int64_t)bg * p.span;
  if constexpr (TAIL) {
    head = min(p.n, (int)(((16u - (reinterpret_cast<uintptr_t>(xe + e0) & 15u)) & 15u) >> 1));
    span = (p.n - head) >> 3;
    tail0 = head + 8 * span;
    xs = reinterpret_cast<const uint4*>(xe + e0 + head);
    ys = reinterpret_cast<uint4*>(ye + e0 + head);
  }
  // this thread's chunks of the span: lo + i * THREADS < hi
  const int lo = rank * p.slice + t, hi = min(TAIL ? span : p.span, (int)(rank + 1) * p.slice);
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
  float head_x = 0.f, tail_x = 0.f;  // this thread's head and tail elements, if any
  bool has_head = false, has_tail = false;
  if constexpr (TAIL) {
    has_head = rank == 0 && t < head;
    has_tail = rank == cs - 1 && t < p.n - tail0;
    if (has_head) {
      head_x = __bfloat162float(xe[e0 + t]);
      s += head_x;
      ss += head_x * head_x;
    }
    if (has_tail) {
      tail_x = __bfloat162float(xe[e0 + tail0 + t]);
      s += tail_x;
      ss += tail_x * tail_x;
    }
  }

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
    if constexpr (TAIL) {
      ys[c] = normalise_mixed(v, head + 8 * c, p, ch0, mean, rstd);
    } else {
      const int ch = ch0 + c / p.hw8;
      const float a = rstd * __ldg(p.gamma + ch);
      ys[c] = normalise(v, a, __ldg(p.beta + ch) - mean * a, p.act_silu);
    }
  };
  if constexpr (TAIL) {
    auto write_one = [&](int e, float v) {
      const int ch = ch0 + e / p.hw;
      const float a = rstd * __ldg(p.gamma + ch);
      ye[e0 + e] = __float2bfloat16_rn(affine_act(v, a, __ldg(p.beta + ch) - mean * a,
                                                  p.act_silu));
    };
    if (has_head) write_one(t, head_x);
    if (has_tail) write_one(tail0 + t, tail_x);
  }
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

template <int THREADS, bool TAIL>
cudaError_t launch(const GnParams& p, int blocks, int cluster, cudaStream_t stream) {
  static bool attr_set = false;  // opt in to > 48 KB of dynamic shared memory once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(groupnorm_kernel<THREADS, TAIL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           THREADS * kMaxSmemChunks * 16);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = (size_t)p.smem_chunks * THREADS * 16;
  if (cluster == 1) {
    groupnorm_kernel<THREADS, TAIL><<<blocks, THREADS, smem, stream>>>(p);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, groupnorm_kernel<THREADS, TAIL>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How a launch splits its spans: blocks a cluster (one span), threads a
// block, and chunks a thread keeps in shared memory.
struct Plan {
  int cluster, threads, smem_chunks;
  int slice;  // chunks a block takes
};

// B * G spans of `span` whole chunks on a card of `sms` SMs: the largest cluster
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
  const Plan pl = plan(B * G, (int)((long long)(C / G) * HW / 8), hopper::sm_count());
  const int kept = pl.threads * (kRegChunks + pl.smem_chunks);
  out[0] = pl.cluster;
  out[1] = pl.threads;
  out[2] = pl.smem_chunks;
  out[3] = pl.slice > kept ? pl.slice - kept : 0;
  return 0;
}

// x, y: contiguous (B, C, HW) bf16 at any 2-byte-aligned addresses that agree
// mod 16 (the kernel moves 8 elements at a time from the same offsets of
// both); gamma, beta: (C,) f32. Returns a cudaError_t.
extern "C" int agenda_groupnorm(const void* x, const void* gamma, const void* beta, void* y,
                                int B, int C, int HW, int G, float eps, int act_silu,
                                void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
      (long long)B * G * kMaxCluster > 0x7fffffff || (long long)(C / G) * HW > 0x7ffffff0 ||
      xa % 2 != 0 || xa % 16 != ya % 16)
    return (int)cudaErrorInvalidValue;
  GnParams p;
  p.x = static_cast<const uint4*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.y = static_cast<uint4*>(y);
  p.cg = C / G;
  p.hw = HW;
  p.hw8 = HW / 8;
  p.G = G;
  p.n = p.cg * HW;
  p.span = p.n / 8;
  p.inv_n = 1.f / (float)p.n;
  p.eps = eps;
  p.act_silu = act_silu;
  const Plan pl = plan(B * G, p.span, hopper::sm_count());
  p.slice = pl.slice;
  p.smem_chunks = pl.smem_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * G * pl.cluster;
  if (HW % 8 != 0 || xa % 16 != 0)  // the tail path
    return (int)(pl.threads == kMinThreads ? launch<kMinThreads, true>(p, blocks, pl.cluster, st)
                                           : launch<kMaxThreads, true>(p, blocks, pl.cluster, st));
  return (int)(pl.threads == kMinThreads ? launch<kMinThreads, false>(p, blocks, pl.cluster, st)
                                         : launch<kMaxThreads, false>(p, blocks, pl.cluster, st));
}
