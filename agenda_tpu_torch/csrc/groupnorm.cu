// Fused GroupNorm(+SiLU) for Hopper (sm_90a) on contiguous NCHW bf16.
//
// Replaces the TPU kernel agenda_tpu/kernels/groupnorm.py::_gn_kernel
// (groupnorm.py:94, launched by _gn_pallas at groupnorm.py:143-163): f32
// E[x] and E[x^2] group statistics, per-channel affine, optional SiLU, one
// read for the statistics and one for the normalise, one write.
//
// Numerics follow flax's default nn.GroupNorm (_compute_stats with
// use_fast_variance): var = max(0, E[x^2] - E[x]^2), biased, eps inside the
// rsqrt, statistics in f32 from the bf16 input, y = x * a + (beta - mean * a)
// with a = rstd * gamma, as the TPU kernel's mul/add form.
//
// What bounds it on the H100: about ten f32 operations per element against
// 4 bytes moved (2 read, 2 written) -- memory. The least time is 4 bytes per
// element over 3.35 TB/s (the statistics pass re-reads x, usually from L2).
//
// Design: on contiguous NCHW one (batch, group) is one contiguous span of
// (C/G) * HW elements, so one block owns one span: a vectorised (8 x bf16,
// hence HW % 8 == 0, as every main-path layer has) sweep accumulates the sum and the sum of squares in f32, a warp-shuffle and
// shared-memory reduction gives mean and rstd, and a second sweep writes the
// result. The grid is only B * G blocks: at the VAE decoder's 512 x 512
// layers each span is 1 M elements over 32 * B blocks, which leaves most SMs
// idle. It is correct and slow there; splitting the reduction across blocks
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

template <int THREADS>
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < THREADS / 32 ? scratch[lane] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (threadIdx.x == 0) scratch[32] = x;
  __syncthreads();
  x = scratch[32];
  __syncthreads();  // scratch is reused by the next reduction
  return x;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    groupnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, __nv_bfloat16* __restrict__ y, int C,
                     int HW, int G, float eps, int act_silu) {
  __shared__ float scratch[33];
  const int bg = blockIdx.x;  // batch * G + group
  const int g = bg % G;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW;
  const __nv_bfloat16* xs = x + (int64_t)bg * n;
  __nv_bfloat16* ys = y + (int64_t)bg * n;

  float s = 0.f, ss = 0.f;
  for (int64_t i = (int64_t)threadIdx.x * 8; i < n; i += (int64_t)THREADS * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(v2[j]);
      s += f.x + f.y;
      ss += f.x * f.x + f.y * f.y;
    }
  }
  s = block_sum<THREADS>(s, scratch);
  ss = block_sum<THREADS>(ss, scratch);
  const float mean = s / (float)n;
  const float var = fmaxf(0.f, ss / (float)n - mean * mean);
  const float rstd = rsqrtf(var + eps);

  // HW % 8 == 0: the 8 elements of a chunk share one channel
  for (int64_t i = (int64_t)threadIdx.x * 8; i < n; i += (int64_t)THREADS * 8) {
    const int c = g * cg + (int)(i / HW);
    const float a = rstd * gamma[c];
    const float sh = beta[c] - mean * a;
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 out;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(v2[j]);
      float u0 = f.x * a + sh, u1 = f.y * a + sh;
      if (act_silu) {
        u0 = silu(u0);
        u1 = silu(u1);
      }
      o2[j] = __floats2bfloat162_rn(u0, u1);
    }
    *reinterpret_cast<uint4*>(ys + i) = out;
  }
}

}  // namespace

// x, y: contiguous (B, C, HW) bf16 with HW % 8 == 0 and 16-byte-aligned bases
// (the kernel moves 8 elements at a time); gamma, beta: (C,) f32. Returns a
// cudaError_t.
extern "C" int agenda_groupnorm(const void* x, const void* gamma, const void* beta, void* y,
                                int B, int C, int HW, int G, float eps, int act_silu,
                                void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || HW % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t span = (int64_t)(C / G) * HW;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (span >= (1 << 16))
    groupnorm_kernel<1024><<<B * G, 1024, 0, st>>>(xb, gf, bf, yb, C, HW, G, eps, act_silu);
  else
    groupnorm_kernel<256><<<B * G, 256, 0, st>>>(xb, gf, bf, yb, C, HW, G, eps, act_silu);
  return (int)cudaGetLastError();
}
