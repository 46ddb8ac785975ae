// One-pass int8 AdamW (+ EMA) update of every quantized leaf of a training
// step, in place, in one launch, for Hopper (sm_90a).
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
// quant(x) = sign(x) clip(rint(127 + 18 log10(|x| / max(absmax, 1e-30))), 0,
// 127). The scalars [lr, gscale, c1, c2, decay] are read from a device f32
// tensor, so a training step never waits on the host. The TPU kernel runs
// once a leaf; here one launch walks the rows of all the step's leaves, whose
// pointers and row offsets ride in the kernel's parameter space (up to
// kMaxLeaves a launch; the C entry splits a longer list).
//
// What bounds it on the H100: 16 bytes an element (p read and written 8, g
// 4, two int8 codes read and written 4), 24 with the EMA shadow: memory, at
// 3.35 TB/s. The earlier one-launch-a-leaf kernel (one warp a row) did not
// reach it: two accurate expf, two logf, seven IEEE divisions and a sqrt an
// element made it issue-bound. Here:
//   - dequant is a shared-memory table of the 256 codes' values, indexed by
//     the code's byte: copysignf(expf(__fmul_rn(kDeqK, |k| - 127)), k) as
//     before, so m and v are bitwise the earlier kernel's, and so is the new
//     row absmax (sm, sv);
//   - requantize takes one reciprocal of the row's absmax a row, lg2.approx
//     of the ratio for the code, and one compare against a table of the exact
//     bin edges 10^((k - 127.5) / 18) (rounded from double on the host) that
//     corrects lg2's error (1e-5 of a bin): a code differs from the plain
//     version's only where the ratio is within an ulp of an edge;
//   - the bias corrections divide by c1 and c2 through their reciprocals,
//     taken once a thread: q = x * (1/c), corrected by one FMA residual
//     (Markstein), is the correctly rounded x / c, so m/c1 and v/c2 stay
//     bitwise the IEEE quotients; the update's divide and sqrt stay IEEE.
//     (The product alone, an ulp or two off, moved p' by up to 1.9e-6
//     where lr * |u| nears 1 -- v's code 0 and a tiny gradient -- past the
//     1e-6 limit.)
//
// Layout: 16 lanes a row and 16 elements a lane, so the row absmax is a
// 16-lane shuffle max; a block of 256 threads takes 16 rows at a time and
// the grid (enough blocks to fill the card once) strides over all rows of
// all leaves, filling its tables once. A lane owns four 4-element pieces 256
// bytes apart: its floats move as 16-byte pieces that coalesce fully across
// the half-warp, its codes 4 bytes a piece. (A lane that owns 16 contiguous
// elements moves its codes as 16 bytes, but its floats as pieces 64 bytes
// apart: that layout measured slower on the card, PERF.md.) p and the
// shadow are stored before the codes are
// requantized, which frees their registers: the kernel without the EMA then
// fits three blocks an SM. A ragged last row (n % 256 != 0) is read with
// guarded scalar loads and its tail treated as zeros, which is what the TPU
// wrapper's zero padding gives, and nothing past n is written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kBlock = 256;     // quantization row (train/optim.py _BLOCK)
constexpr int kLanes = 16;      // lanes a row
constexpr int kPerLane = 16;    // elements a lane
constexpr int kThreads = 256;   // 16 rows a block at a time
constexpr int kRowsPerPass = kThreads / kLanes;
constexpr int kMaxLeaves = 440;  // leaves a launch: the parameters stay under 32 764 bytes
constexpr float kDeqK = (float)(2.302585092994046 * 7.0 / 126.0);  // ln10 * SPAN / 126
constexpr float kQuantLog2 = (float)(18.0 * 0.30102999566398120);  // 18 log10(2)

struct LeavesParams {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  int8_t* qm[kMaxLeaves];
  float* sm[kMaxLeaves];
  int8_t* qv[kMaxLeaves];
  float* sv[kMaxLeaves];
  float* ema[kMaxLeaves];  // the EMA variant only
  long long n[kMaxLeaves];
  int row0[kMaxLeaves + 1];  // first row of each leaf; row0[count] = rows
  float edge[129];           // edge[k] = 10^((k - 127.5) / 18), edge[0] = 0, edge[128] = inf
  const float* scalars;      // [lr, gscale, c1, c2, decay]
  int rows;
  float b1, omb1, b2, omb2, eps, wd;  // 1 - b1 and 1 - b2 rounded from double, as in JAX
};
static_assert(sizeof(LeavesParams) <= 32764, "kernel parameters exceed 32 764 bytes");

// offset in its row of lane l's piece j (4 elements)
__device__ __forceinline__ int piece(int l, int j) { return 64 * j + 4 * l; }

// every load and store of the streams, in one place
template <class T>
__device__ __forceinline__ T ld(const void* p) {
  return *reinterpret_cast<const T*>(p);
}
template <class T>
__device__ __forceinline__ void st(void* p, T v) {
  *reinterpret_cast<T*>(p) = v;
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// x / c correctly rounded, from ic = 1 / c correctly rounded: one product and
// one FMA residual step (Markstein), no divide
__device__ __forceinline__ float div_by(float x, float c, float ic) {
  const float q = __fmul_rn(x, ic);
  return fmaf(fmaf(-q, c, x), ic, q);
}

// the value of byte t of a word of codes, from the table of the 256 codes' values
__device__ __forceinline__ float dequant(const float* deq, uint32_t word, int t, float scale) {
  return __fmul_rn(deq[(word >> (8 * t)) & 0xffu], scale);
}

// the code of x in a row whose absmax has reciprocal inv: lg2.approx gives the
// bin within one, the edge table decides
__device__ __forceinline__ uint32_t quantize(const float* edge, float x, float inv) {
  const float r = __fmul_rn(fabsf(x), inv);
  const float t = fmaf(__log2f(r), kQuantLog2, 127.f);
  const float k0 = fminf(fmaxf(rintf(t), 0.f), 127.f);
  int k = (int)k0;
  if (t > k0)
    k += r >= edge[k + 1];
  else
    k -= r < edge[k];
  const int code = x > 0.f ? k : (x < 0.f ? -k : 0);
  return (uint32_t)(code & 0xff);
}

template <bool kEma>
__global__ void __launch_bounds__(kThreads) fused_adamw8bit_kernel(const __grid_constant__ LeavesParams a) {
  __shared__ float deq[256];  // deq[b]: the value of code (int8_t)b at scale 1
  __shared__ float edge[129];
  for (int b = threadIdx.x; b < 256; b += kThreads) {
    const float code = (float)(int8_t)b, mag = fabsf(code);
    deq[b] = mag > 0.f ? copysignf(expf(__fmul_rn(kDeqK, mag - 127.f)), code) : 0.f;
    if (b < 129) edge[b] = a.edge[b];
  }
  __syncthreads();

  const float lr = a.scalars[0], gscale = a.scalars[1];
  const float c1 = a.scalars[2], c2 = a.scalars[3];
  const float ic1 = 1.f / c1, ic2 = 1.f / c2;
  const float decay = kEma ? a.scalars[4] : 0.f, omd = __fsub_rn(1.f, decay);
  const int l = threadIdx.x % kLanes;
  const int half = threadIdx.x / kLanes;  // this half-warp's row of the block's 16
  const int first = threadIdx.x / 32 * 2;  // the warp's first row of the 16
  int leaf = 0;
  // a warp's two rows go round together, so the shuffles always have 32 lanes
  for (int base = blockIdx.x * kRowsPerPass; base + first < a.rows;
       base += gridDim.x * kRowsPerPass) {
    const int row = base + half;
    const bool live = row < a.rows;
    const int r = live ? row : a.rows - 1;
    while (r >= a.row0[leaf + 1]) ++leaf;
    const long long e0 = (long long)(r - a.row0[leaf]) * kBlock;
    const long long lim = live ? a.n[leaf] - e0 : 0;  // elements of this row in its leaf
    const bool full = lim >= kBlock;
    float* P = a.p[leaf] + e0;
    const float* G = a.g[leaf] + e0;
    int8_t* QM = a.qm[leaf] + e0;
    int8_t* QV = a.qv[leaf] + e0;
    float* E = kEma ? a.ema[leaf] + e0 : nullptr;

    float p[kPerLane], g[kPerLane], e[kPerLane];
    uint32_t wm[4], wv[4];
    if (full) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = piece(l, j);
        const float4 pv = ld<float4>(P + o);
        const float4 gv = ld<float4>(G + o);
        p[4 * j] = pv.x; p[4 * j + 1] = pv.y; p[4 * j + 2] = pv.z; p[4 * j + 3] = pv.w;
        g[4 * j] = gv.x; g[4 * j + 1] = gv.y; g[4 * j + 2] = gv.z; g[4 * j + 3] = gv.w;
        wm[j] = ld<uint32_t>(QM + o);
        wv[j] = ld<uint32_t>(QV + o);
        if (kEma) {
          const float4 ev = ld<float4>(E + o);
          e[4 * j] = ev.x; e[4 * j + 1] = ev.y; e[4 * j + 2] = ev.z; e[4 * j + 3] = ev.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wm[j] = 0u;
        wv[j] = 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = piece(l, j) + t;
          const bool in = i < lim;
          p[4 * j + t] = in ? P[i] : 0.f;
          g[4 * j + t] = in ? G[i] : 0.f;
          wm[j] |= in ? (uint32_t)(uint8_t)QM[i] << (8 * t) : 0u;
          wv[j] |= in ? (uint32_t)(uint8_t)QV[i] << (8 * t) : 0u;
          if (kEma) e[4 * j + t] = in ? E[i] : 0.f;
        }
      }
    }

    const float sm = live ? a.sm[leaf][r - a.row0[leaf]] : 0.f;
    const float sv = live ? a.sv[leaf][r - a.row0[leaf]] : 0.f;
    float m[kPerLane], v[kPerLane];
    float mmax = 0.f, vmax = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float gi = __fmul_rn(g[i], gscale);
      m[i] = __fadd_rn(__fmul_rn(a.b1, dequant(deq, wm[i / 4], i % 4, sm)),
                       __fmul_rn(a.omb1, gi));
      v[i] = __fadd_rn(__fmul_rn(a.b2, dequant(deq, wv[i / 4], i % 4, sv)),
                       __fmul_rn(__fmul_rn(a.omb2, gi), gi));
      const float u = div_by(m[i], c1, ic1) / __fadd_rn(sqrtf(div_by(v[i], c2, ic2)), a.eps);
      p[i] = __fsub_rn(p[i], __fmul_rn(lr, __fadd_rn(u, __fmul_rn(a.wd, p[i]))));
      if (kEma) e[i] = __fadd_rn(__fmul_rn(e[i], decay), __fmul_rn(omd, p[i]));
      mmax = fmaxf(mmax, fabsf(m[i]));
      vmax = fmaxf(vmax, fabsf(v[i]));
    }
    if (full) {  // p and the shadow first: their registers free up for the codes
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = piece(l, j);
        st(P + o, make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]));
        if (kEma) st(E + o, make_float4(e[4 * j], e[4 * j + 1], e[4 * j + 2], e[4 * j + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int k = piece(l, i / 4) + i % 4;
        if (k >= lim) continue;
        P[k] = p[i];
        if (kEma) E[k] = e[i];
      }
    }
    mmax = half_max(mmax);
    vmax = half_max(vmax);
    const float minv = 1.f / fmaxf(mmax, 1e-30f), vinv = 1.f / fmaxf(vmax, 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm[j] = 0u;
      wv[j] = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wm[j] |= quantize(edge, m[4 * j + t], minv) << (8 * t);
        wv[j] |= quantize(edge, v[4 * j + t], vinv) << (8 * t);
      }
    }

    if (full) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st(QM + piece(l, j), wm[j]);
        st(QV + piece(l, j), wv[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = piece(l, j) + t;
          if (i >= lim) continue;
          QM[i] = (int8_t)(wm[j] >> (8 * t));
          QV[i] = (int8_t)(wv[j] >> (8 * t));
        }
      }
    }
    if (live && l == 0) {
      a.sm[leaf][r - a.row0[leaf]] = mmax;
      a.sv[leaf][r - a.row0[leaf]] = vmax;
    }
  }
}

template <bool kEma>
int blocks_an_sm() {
  static int blocks = 0;
  if (blocks == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, fused_adamw8bit_kernel<kEma>, kThreads, 0) != cudaSuccess)
    blocks = 0;
  return blocks > 0 ? blocks : 1;
}

}  // namespace

// The most leaves one launch takes (a longer list is split into launches of
// this many, in order).
extern "C" int agenda_fused_adamw8bit_capacity() { return kMaxLeaves; }

// Every leaf's update of one step. ptrs: 7 * count pointers, stream by stream
// (p[count], g[count], qm[count], sm[count], qv[count], sv[count],
// ema[count]), the ema ones read only with `ema` != 0; sizes: the leaves'
// element counts. p, g, ema: n f32; qm, qv: n int8; sm, sv: ceil(n / 256)
// f32; all 16-byte aligned. scalars: 5 f32 on the device [lr, gscale, c1,
// c2, decay]. Updates p, qm, sm, qv, sv (and ema) in place, in
// ceil(count / kMaxLeaves) launches. Returns a cudaError_t (0 on success).
extern "C" int agenda_fused_adamw8bit_leaves(const long long* ptrs, const long long* sizes,
                                             int count, int ema, const void* scalars, float b1,
                                             float omb1, float b2, float omb2, float eps,
                                             float wd, void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < 7; ++s)
    for (int i = 0; i < count; ++i)
      if ((s < 6 || ema) && (ptrs[s * count + i] == 0 || ptrs[s * count + i] % 16 != 0))
        return (int)cudaErrorInvalidValue;
  LeavesParams a;  // about 30 KB; the launch copies it
  a.edge[0] = 0.f;
  for (int k = 1; k < 128; ++k) a.edge[k] = (float)pow(10.0, (k - 127.5) / 18.0);
  a.edge[128] = INFINITY;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long grid_cap =
      (long long)hopper::sm_count() * (ema ? blocks_an_sm<true>() : blocks_an_sm<false>());
  for (int first = 0; first < count; first += kMaxLeaves) {
    const int k = count - first < kMaxLeaves ? count - first : kMaxLeaves;
    long long rows = 0;
    for (int i = 0; i < k; ++i) {
      const long long n = sizes[first + i];
      if (n <= 0) return (int)cudaErrorInvalidValue;
      const int leaf = first + i;
      a.p[i] = reinterpret_cast<float*>(ptrs[0 * count + leaf]);
      a.g[i] = reinterpret_cast<const float*>(ptrs[1 * count + leaf]);
      a.qm[i] = reinterpret_cast<int8_t*>(ptrs[2 * count + leaf]);
      a.sm[i] = reinterpret_cast<float*>(ptrs[3 * count + leaf]);
      a.qv[i] = reinterpret_cast<int8_t*>(ptrs[4 * count + leaf]);
      a.sv[i] = reinterpret_cast<float*>(ptrs[5 * count + leaf]);
      a.ema[i] = ema ? reinterpret_cast<float*>(ptrs[6 * count + leaf]) : nullptr;
      a.n[i] = n;
      a.row0[i] = (int)rows;
      rows += (n + kBlock - 1) / kBlock;
      if (rows >= 0x7fffffffLL - kRowsPerPass) return (int)cudaErrorInvalidValue;
    }
    a.row0[k] = (int)rows;
    a.scalars = static_cast<const float*>(scalars);
    a.rows = (int)rows;
    a.b1 = b1;
    a.omb1 = omb1;
    a.b2 = b2;
    a.omb2 = omb2;
    a.eps = eps;
    a.wd = wd;
    const long long passes = (rows + kRowsPerPass - 1) / kRowsPerPass;
    const unsigned grid = (unsigned)(passes < grid_cap ? passes : grid_cap);
    if (ema)
      fused_adamw8bit_kernel<true><<<grid, kThreads, 0, st>>>(a);
    else
      fused_adamw8bit_kernel<false><<<grid, kThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
