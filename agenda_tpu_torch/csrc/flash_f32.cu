// Flash attention's backward in full f32 for Hopper (sm_90a): the dK/dV and
// dQ that --mixed_precision no runs on the card, up to D = 160 (the forward,
// on the tensor cores, is flash_fwd_f32.cu; the backward above D = 160 is
// flash_bwd_f32_wide.cu's).
//
// Replaces the TPU kernels of agenda_tpu/kernels/flash.py on f32 operands,
// which they take as they take bf16 (their dispatch in
// agenda_tpu/kernels/attention.py:119-126 has no dtype test):
// _flash_bwd_dkv_kernel (flash.py:153, launched at flash.py:239) and
// _flash_bwd_dq_kernel (flash.py:192, launched at flash.py:265): P from
// lse, dS = P (dP - delta), gradients in the input dtype (flash.py:306-309).
// Every product, P, dS and the softmax statistics are f32 here; nothing is
// rounded to bf16 or TF32.
//
// What bounds them on the H100: 7*B*H*S^2*D multiply-adds of f32 products
// (dK/dV 4, dQ 3), 2*B*H*S^2 exponentials, on 4*B*S*H*D*4 bytes. The cheapest
// f32-accurate product the card has is three TF32 tensor-core passes (hi*hi
// + hi*lo + lo*hi) at 495 TFLOP/s, i.e. 165 TFLOP/s of f32 products (or six
// bf16 passes over three bf16 pieces, as the forward does); these kernels
// use the CUDA cores' FFMA instead (67 TFLOP/s peak), which is what bounds
// them. At S = 64 and 256 the bytes bound the work.
//
// Design (simple kernels that are right first; no TMA, no wgmma, no
// pipelining across tiles). Up to D = 160:
// - One block of 256 threads (a 16 x 16 grid, ty x tx) takes 64 rows of one
//   (batch, head) and loops over the 64-row tiles of the other side; every
//   tile is copied from device memory into shared memory in 16-byte loads,
//   rows past S and columns past D zero-filled, between two __syncthreads.
// - Scores: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
//   (i, j < 4) of the 64 x 64 score tile and reads both operands as float4
//   along D from row-major tiles whose row pitch is an odd number of 16-byte
//   units, so a warp's 16 distinct rows fall in distinct bank groups: 8
//   float4 loads (12 shared-memory wavefronts a warp) for 64 FFMA a thread.
// - Products into the output (dV += P^T dO, dK += dS^T Q, dQ += dS K):
//   thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of the
//   64 x (16 * NJ) accumulator (D zero-filled to 16 * NJ), with P or dS
//   staged in shared memory and read as float4 along the reduction.
// - Every tile is whole in shared memory (198 KB at D = 160 in the dK/dV,
//   181 KB in the dQ).
// Each output element has one owner and a fixed summation order: no
// atomics; two launches on the same inputs give bitwise-equal outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // rows a block owns, and rows of a tile it loops over
constexpr int kLdP = kTile + 4;       // pitch of the staged P / dS tiles: 17 float4, odd
constexpr int kMaxBwdHeadDim = 160;
struct Operand {
  const float* p;
  long long sb, ss, sh;  // element strides of batch, sequence, head (D is unit-stride)
};

struct Params {
  Operand q, k, v, dout;
  const float* lse;    // (B*H, S)
  const float* delta;  // (B*H, S)
  float *dq, *dk, *dv;
  int S, H, D;
  float scale;
};

// The products' operands as they are read: exact f32. (The card tests'
// broken copies round these to TF32 to show that the limit catches it.)
struct DkvOperand {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
struct DqOperand {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
template <typename F>
__device__ __forceinline__ float4 operand4(const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const F f{};
  return make_float4(f(x.x), f(x.y), f(x.z), f(x.w));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float part(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// rows [s0, s0 + rows) of one (batch, head) of t, columns [c0, c0 + WIDTH),
// into dst[r * ld + c]; rows past S and columns past D are zero
template <int WIDTH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const Operand& t, int b, int h,
                                          int s0, int rows, int S, int c0, int D) {
  constexpr int kW4 = WIDTH / 4;
  const float* base = t.p + b * t.sb + h * t.sh;
  for (int i = threadIdx.x; i < rows * kW4; i += kThreads) {
    const int r = i / kW4, c = 4 * (i % kW4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S && c0 + c < D)
      x = __ldg(reinterpret_cast<const float4*>(base + (long long)(s0 + r) * t.ss + c0 + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// acc[i][j] += sum over d < dn of A[(ty + 16 i) * lda + d] * B[(tx + 16 j) * ldb + d]
template <typename F>
__device__ __forceinline__ void scores(float (&acc)[4][4], const float* A, int lda,
                                       const float* B, int ldb, int dn, int ty, int tx) {
  for (int d = 0; d < dn; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = operand4<F>(A + (ty + 16 * i) * lda + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = operand4<F>(B + (tx + 16 * j) * ldb + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum over r < rows of W[(ty + 16 i) * kLdP + r] * X[r * ldx + tx + 16 j]
template <int NJ, typename F>
__device__ __forceinline__ void accumulate(float (&acc)[4][NJ], const float* W, const float* X,
                                           int ldx, int rows, int ty, int tx) {
  for (int r = 0; r < rows; r += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = operand4<F>(W + (ty + 16 * i) * kLdP + r);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = F()(X[(r + c) * ldx + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(part(w[i], c), x, acc[i][j]);
      }
    }
  }
}

// -- the backward -----------------------------------------------------------------

template <int NJ>
struct BwdTile {
  static constexpr int kW = 16 * NJ;
  static constexpr int kLd = kW + 4;
  static constexpr int kDkvSmem = (4 * kTile * kLd + 2 * kTile * kLdP) * 4;
  static constexpr int kDqSmem = (4 * kTile * kLd + kTile * kLdP) * 4;
};

// P and dS of a 64 x 64 tile from its scores s and dP, rows' (or columns')
// lse and delta; zero where a row or a key lies past S
__device__ __forceinline__ void p_and_ds(float& s, float& dp, bool valid, float lse, float delta,
                                         float scale) {
  const float pr = valid ? expf(s * scale - lse) : 0.f;
  dp = pr * (dp - delta);
  s = pr;
}

// One block owns 64 keys of a (batch, head): K and V stay in shared memory
// while the query tiles pass; thread (ty, tx) computes P^T and dS^T at keys
// ty + 16 i and queries tx + 16 j, then dV += P^T dO and dK += dS^T Q at keys
// ty + 16 i and columns tx + 16 j.
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ Params p) {
  using T = BwdTile<NJ>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * T::kLd;
  float* Qs = Vs + kTile * T::kLd;
  float* Os = Qs + kTile * T::kLd;  // dO
  float* Pt = Os + kTile * T::kLd;
  float* dSt = Pt + kTile * kLdP;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, n0 = blockIdx.x * kTile;
  const float* lse = p.lse + (long long)bh * p.S;
  const float* delta = p.delta + (long long)bh * p.S;

  load_tile<T::kW>(Ks, T::kLd, p.k, b, h, n0, kTile, p.S, 0, p.D);
  load_tile<T::kW>(Vs, T::kLd, p.v, b, h, n0, kTile, p.S, 0, p.D);
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int m0 = 0; m0 < p.S; m0 += kTile) {
    __syncthreads();  // every thread is done with the last query tile
    load_tile<T::kW>(Qs, T::kLd, p.q, b, h, m0, kTile, p.S, 0, p.D);
    load_tile<T::kW>(Os, T::kLd, p.dout, b, h, m0, kTile, p.S, 0, p.D);
    float row_lse[4], row_delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + tx + 16 * j;
      row_lse[j] = r < p.S ? lse[r] : 0.f;
      row_delta[j] = r < p.S ? delta[r] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    scores<DkvOperand>(s, Ks, T::kLd, Qs, T::kLd, p.D, ty, tx);
    scores<DkvOperand>(dp, Vs, T::kLd, Os, T::kLd, p.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = n0 + ty + 16 * i < p.S && m0 + tx + 16 * j < p.S;
        p_and_ds(s[i][j], dp[i][j], valid, row_lse[j], row_delta[j], p.scale);
        Pt[(ty + 16 * i) * kLdP + tx + 16 * j] = s[i][j];
        dSt[(ty + 16 * i) * kLdP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    accumulate<NJ, DkvOperand>(dv, Pt, Os, T::kLd, kTile, ty, tx);
    accumulate<NJ, DkvOperand>(dk, dSt, Qs, T::kLd, kTile, ty, tx);
  }
  const int rs = p.H * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty + 16 * i;
    if (key >= p.S) continue;
    const long long off = ((long long)b * p.S + key) * rs + (long long)h * p.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < p.D) {
        p.dk[off + tx + 16 * j] = dk[i][j] * p.scale;
        p.dv[off + tx + 16 * j] = dv[i][j];
      }
  }
}

// One block owns 64 queries: Q and dO stay in shared memory while the key
// tiles pass; thread (ty, tx) computes P and dS at queries ty + 16 i and keys
// tx + 16 j, then dQ += dS K at queries ty + 16 i and columns tx + 16 j.
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ Params p) {
  using T = BwdTile<NJ>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + kTile * T::kLd;  // dO
  float* Ks = Os + kTile * T::kLd;
  float* Vs = Ks + kTile * T::kLd;
  float* dSs = Vs + kTile * T::kLd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, m0 = blockIdx.x * kTile;

  load_tile<T::kW>(Qs, T::kLd, p.q, b, h, m0, kTile, p.S, 0, p.D);
  load_tile<T::kW>(Os, T::kLd, p.dout, b, h, m0, kTile, p.S, 0, p.D);
  float row_lse[4], row_delta[4], dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    row_lse[i] = r < p.S ? p.lse[(long long)bh * p.S + r] : 0.f;
    row_delta[i] = r < p.S ? p.delta[(long long)bh * p.S + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;
  }
  for (int n0 = 0; n0 < p.S; n0 += kTile) {
    __syncthreads();  // every thread is done with the last key tile and dS
    load_tile<T::kW>(Ks, T::kLd, p.k, b, h, n0, kTile, p.S, 0, p.D);
    load_tile<T::kW>(Vs, T::kLd, p.v, b, h, n0, kTile, p.S, 0, p.D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    scores<DqOperand>(s, Qs, T::kLd, Ks, T::kLd, p.D, ty, tx);
    scores<DqOperand>(dp, Os, T::kLd, Vs, T::kLd, p.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = m0 + ty + 16 * i < p.S && n0 + tx + 16 * j < p.S;
        p_and_ds(s[i][j], dp[i][j], valid, row_lse[i], row_delta[i], p.scale);
        dSs[(ty + 16 * i) * kLdP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    accumulate<NJ, DqOperand>(dq, dSs, Ks, T::kLd, kTile, ty, tx);
  }
  const int rs = p.H * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.S) continue;
    float* out = p.dq + ((long long)b * p.S + row) * rs + (long long)h * p.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < p.D) out[tx + 16 * j] = dq[i][j] * p.scale;
  }
}

// -- host side --------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int rows, const Params& p, int B,
                   cudaStream_t stream, bool* attr_set) {
  if (!*attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  const dim3 grid((p.S + rows - 1) / rows, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_dkv(const Params& p, int B, cudaStream_t st) {
  static bool attr_set = false;
  return launch(flash_bwd_dkv_f32_kernel<NJ>, BwdTile<NJ>::kDkvSmem, kTile, p, B, st,
                &attr_set);
}

template <int NJ>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t st) {
  static bool attr_set = false;
  return launch(flash_bwd_dq_f32_kernel<NJ>, BwdTile<NJ>::kDqSmem, kTile, p, B, st, &attr_set);
}

// Checks shared by the entries (four f32 operands at 16-byte-aligned bases with
// strides that are multiples of 4 elements; D a multiple of 8 up to max_d);
// fills p's operands and scalars. Returns cudaSuccess or cudaErrorInvalidValue.
cudaError_t make_params(Params* p, const void* const* ptrs, const long long* strides, int B,
                        int S, int H, int D, int max_d) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > max_d || B * H > 65535)
    return cudaErrorInvalidValue;
  Operand* ops[4] = {&p->q, &p->k, &p->v, &p->dout};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 4 != 0) return cudaErrorInvalidValue;
    *ops[i] = Operand{static_cast<const float*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                      strides[3 * i + 2]};
  }
  p->dq = p->dk = p->dv = nullptr;
  p->lse = p->delta = nullptr;
  p->S = S;
  p->H = H;
  p->D = D;
  p->scale = 1.f / sqrtf((float)D);
  return cudaSuccess;
}

}  // namespace

// The largest head dim of the backward (flash_bwd_f32_wide.cu's takes a larger one).
extern "C" int agenda_flash_f32_bwd_max_head_dim() { return kMaxBwdHeadDim; }

// q, k, v, dout: (B, S, H, D) f32 with the given element strides (q, k, v,
// dout; batch, seq, head each; D unit-stride), 16-byte-aligned bases and
// strides that are multiples of 4; D a multiple of 8 up to 160; lse, delta:
// (B*H, S) f32 contiguous; dk, dv: contiguous (B, S, H, D) f32. Returns a
// cudaError_t.
extern "C" int agenda_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int S, int H, int D,
                                        const long long* strides, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  Params p;
  cudaError_t err = make_params(&p, ptrs, strides, B, S, H, D, kMaxBwdHeadDim);
  if (err != cudaSuccess) return (int)err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 48) return (int)launch_dkv<3>(p, B, st);
  if (D <= 80) return (int)launch_dkv<5>(p, B, st);
  return (int)launch_dkv<10>(p, B, st);
}

// dQ, same inputs; dq: contiguous (B, S, H, D) f32. Returns a cudaError_t.
extern "C" int agenda_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int B, int S, int H, int D,
                                       const long long* strides, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  Params p;
  cudaError_t err = make_params(&p, ptrs, strides, B, S, H, D, kMaxBwdHeadDim);
  if (err != cudaSuccess) return (int)err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 48) return (int)launch_dq<3>(p, B, st);
  if (D <= 80) return (int)launch_dq<5>(p, B, st);
  return (int)launch_dq<10>(p, B, st);
}
