// One-pass int8 AdamW (+ EMA) update for Hopper (sm_90a), in place.
//
// Replaces the TPU kernels agenda_tpu/kernels/fused_adamw.py::_kernel
// (fused_adamw.py:111) and ::_kernel_ema (:118), whose math is _update_math
// (:61-108). For each quantization row of 256 elements of one parameter leaf:
//   g  = g * gscale                                  (global-norm clip)
//   m  = deq(qm, sm), v = deq(qv, sv)                (int8 log code, row absmax)
//   m  = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g g
//   u  = (m / c1) / (sqrt(v / c2) + eps)
//   p' = p - lr (u + wd p)                           (decoupled weight decay)
//   qm, sm = quant(m); qv, sv = quant(v)             (requantize, new row absmax)
//   ema' = ema decay + (1 - decay) p'                (the EMA variant only)
// with deq(q, s) = sign(q) exp(ln10 * 7/126 * (|q| - 127)) s (0 for q = 0) and
// quant(x) = sign(x) clip(rint(127 + 18 ln(max(|x| / max(absmax, 1e-30), 1e-30))
// / ln10), 0, 127). The scalars [lr, gscale, c1, c2, decay] are read from a
// device f32 tensor, so a training step never waits on the host. p, qm, sm,
// qv, sv (and ema) are updated in place, as the TPU kernel's
// input_output_aliases (:210-212) do.
//
// Numerics: rint (round half to even) as jnp.round; expf and logf, not the
// __expf/__logf intrinsics; the products and sums are written with __fmul_rn
// and __fadd_rn so that nvcc contracts none of them into an FMA, as the
// reference rounds each one. Codes then agree with the reference within one.
//
// What bounds it on the H100: about 60 operations per element against 16
// bytes (p read and written 8, g 4, two int8 codes read and written 4), 24
// with the EMA (its shadow read and written 8), far below the card's ~20 f32
// operations per byte: memory. The least time is 16 or 24 bytes per element
// over 3.35 TB/s.
//
// Design: one warp per 256-element row (8 values a lane, as two float4 loads
// at lane*4 and 128 + lane*4, so a warp reads the row's 1 KB coalesced),
// 8 rows a block. The row absmax of the new m and v is a warp-shuffle max; the
// quantization rows are row-local (fused_adamw.py:161-166), so nothing is
// reduced across warps or blocks. A ragged last row (n % 256 != 0) is read
// with guarded scalar loads and its tail treated as zeros, which is what the
// TPU wrapper's zero padding gives, and nothing past n is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // quantization row (train/optim.py _BLOCK)
constexpr int kRowsPerBlock = 8;
constexpr float kDeqK = (float)(2.302585092994046 * 7.0 / 126.0);  // ln10 * SPAN / 126
constexpr float kLn10 = (float)2.302585092994046;
constexpr float kQuantK = 18.0f;  // 126 / SPAN

struct AdamParams {
  float* p;
  const float* g;
  int8_t* qm;
  float* sm;
  int8_t* qv;
  float* sv;
  float* ema;
  const float* scalars;  // [lr, gscale, c1, c2, decay]
  long long n;
  long long nb;
  float b1, omb1, b2, omb2, eps, wd;  // 1 - b1 and 1 - b2 rounded from double, as in JAX
};

__device__ __forceinline__ float dequant(int code, float scale) {
  const float q = (float)code;
  const float mag = fabsf(q);
  const float val = mag > 0.f ? copysignf(expf(__fmul_rn(kDeqK, mag - 127.f)), q) : 0.f;
  return __fmul_rn(val, scale);
}

__device__ __forceinline__ int8_t quantize(float x, float safe) {
  const float ratio = fabsf(x) / safe;
  float mag = rintf(__fadd_rn(127.f, __fmul_rn(kQuantK, logf(fmaxf(ratio, 1e-30f)) / kLn10)));
  mag = fminf(fmaxf(mag, 0.f), 127.f);
  return (int8_t)(x > 0.f ? mag : (x < 0.f ? -mag : 0.f));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <bool kEma>
__global__ void __launch_bounds__(32 * kRowsPerBlock) fused_adamw8bit_kernel(AdamParams a) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= a.nb) return;
  const int lane = threadIdx.x % 32;
  const long long base = row * kBlock;
  const bool full = base + kBlock <= a.n;

  // this lane's 8 elements: [lane*4, lane*4 + 4) and [128 + lane*4, 128 + lane*4 + 4)
  float p[8], g[8], e[8];
  int qm[8], qv[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = base + h * 128 + lane * 4;
    if (full) {
      const float4 pv = *reinterpret_cast<const float4*>(a.p + i0);
      const float4 gv = *reinterpret_cast<const float4*>(a.g + i0);
      const char4 mv = *reinterpret_cast<const char4*>(a.qm + i0);
      const char4 vv = *reinterpret_cast<const char4*>(a.qv + i0);
      p[4 * h + 0] = pv.x; p[4 * h + 1] = pv.y; p[4 * h + 2] = pv.z; p[4 * h + 3] = pv.w;
      g[4 * h + 0] = gv.x; g[4 * h + 1] = gv.y; g[4 * h + 2] = gv.z; g[4 * h + 3] = gv.w;
      qm[4 * h + 0] = mv.x; qm[4 * h + 1] = mv.y; qm[4 * h + 2] = mv.z; qm[4 * h + 3] = mv.w;
      qv[4 * h + 0] = vv.x; qv[4 * h + 1] = vv.y; qv[4 * h + 2] = vv.z; qv[4 * h + 3] = vv.w;
      if (kEma) {
        const float4 ev = *reinterpret_cast<const float4*>(a.ema + i0);
        e[4 * h + 0] = ev.x; e[4 * h + 1] = ev.y; e[4 * h + 2] = ev.z; e[4 * h + 3] = ev.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long i = i0 + t;
        const bool in = i < a.n;
        p[4 * h + t] = in ? a.p[i] : 0.f;
        g[4 * h + t] = in ? a.g[i] : 0.f;
        qm[4 * h + t] = in ? a.qm[i] : 0;
        qv[4 * h + t] = in ? a.qv[i] : 0;
        if (kEma) e[4 * h + t] = in ? a.ema[i] : 0.f;
      }
    }
  }

  const float lr = a.scalars[0], gscale = a.scalars[1], c1 = a.scalars[2], c2 = a.scalars[3];
  const float sm = a.sm[row], sv = a.sv[row];
  float m[8], v[8], p2[8];
  float mmax = 0.f, vmax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float gj = __fmul_rn(g[j], gscale);
    m[j] = __fadd_rn(__fmul_rn(a.b1, dequant(qm[j], sm)), __fmul_rn(a.omb1, gj));
    v[j] = __fadd_rn(__fmul_rn(a.b2, dequant(qv[j], sv)), __fmul_rn(__fmul_rn(a.omb2, gj), gj));
    const float u = (m[j] / c1) / __fadd_rn(sqrtf(v[j] / c2), a.eps);
    p2[j] = __fsub_rn(p[j], __fmul_rn(lr, __fadd_rn(u, __fmul_rn(a.wd, p[j]))));
    mmax = fmaxf(mmax, fabsf(m[j]));
    vmax = fmaxf(vmax, fabsf(v[j]));
  }
  mmax = warp_max(mmax);
  vmax = warp_max(vmax);
  const float msafe = fmaxf(mmax, 1e-30f), vsafe = fmaxf(vmax, 1e-30f);
  if (kEma) {
    const float decay = a.scalars[4], omd = __fsub_rn(1.f, decay);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __fadd_rn(__fmul_rn(e[j], decay), __fmul_rn(omd, p2[j]));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = base + h * 128 + lane * 4;
    int8_t cm[4], cv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      cm[t] = quantize(m[4 * h + t], msafe);
      cv[t] = quantize(v[4 * h + t], vsafe);
    }
    if (full) {
      *reinterpret_cast<float4*>(a.p + i0) =
          make_float4(p2[4 * h + 0], p2[4 * h + 1], p2[4 * h + 2], p2[4 * h + 3]);
      *reinterpret_cast<char4*>(a.qm + i0) = make_char4(cm[0], cm[1], cm[2], cm[3]);
      *reinterpret_cast<char4*>(a.qv + i0) = make_char4(cv[0], cv[1], cv[2], cv[3]);
      if (kEma)
        *reinterpret_cast<float4*>(a.ema + i0) =
            make_float4(e[4 * h + 0], e[4 * h + 1], e[4 * h + 2], e[4 * h + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long i = i0 + t;
        if (i >= a.n) continue;
        a.p[i] = p2[4 * h + t];
        a.qm[i] = cm[t];
        a.qv[i] = cv[t];
        if (kEma) a.ema[i] = e[4 * h + t];
      }
    }
  }
  if (lane == 0) {
    a.sm[row] = mmax;
    a.sv[row] = vmax;
  }
}

}  // namespace

// p, g, ema: n f32 (16-byte-aligned); qm, qv: n int8 (4-byte-aligned); sm, sv:
// ceil(n / 256) f32; scalars: 5 f32 on the device [lr, gscale, c1, c2, decay]
// (decay is read only with ema). ema may be null: the update without the EMA
// shadow. p, qm, sm, qv, sv and ema are updated in place. Returns a
// cudaError_t (0 on success).
extern "C" int agenda_fused_adamw8bit(void* p, const void* g, void* qm, void* sm, void* qv,
                                      void* sv, void* ema, const void* scalars, long long n,
                                      float b1, float omb1, float b2, float omb2, float eps,
                                      float wd, void* stream) {
  const uintptr_t align16 = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                            reinterpret_cast<uintptr_t>(ema);
  const uintptr_t align4 = reinterpret_cast<uintptr_t>(qm) | reinterpret_cast<uintptr_t>(qv);
  if (n <= 0 || align16 % 16 != 0 || align4 % 4 != 0) return (int)cudaErrorInvalidValue;
  AdamParams a;
  a.p = static_cast<float*>(p);
  a.g = static_cast<const float*>(g);
  a.qm = static_cast<int8_t*>(qm);
  a.sm = static_cast<float*>(sm);
  a.qv = static_cast<int8_t*>(qv);
  a.sv = static_cast<float*>(sv);
  a.ema = static_cast<float*>(ema);
  a.scalars = static_cast<const float*>(scalars);
  a.n = n;
  a.nb = (n + kBlock - 1) / kBlock;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.eps = eps;
  a.wd = wd;
  const long long blocks = (a.nb + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ema != nullptr)
    fused_adamw8bit_kernel<true><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, st>>>(a);
  else
    fused_adamw8bit_kernel<false><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}
