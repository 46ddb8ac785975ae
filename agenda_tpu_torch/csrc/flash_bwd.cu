// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in, f32
// accumulate, gradients written in bf16.
//
// Replaces the TPU kernels agenda_tpu/kernels/flash.py::_flash_bwd_dkv_kernel
// (flash.py:153) and ::_flash_bwd_dq_kernel (flash.py:192), launched by
// _flash_bwd_impl (flash.py:222-287). Both recompute the probabilities from
// the forward's row logsumexp, P = exp(Q K^T * scale - lse), and take
// delta = rowsum(dO * O) (f32, computed outside the kernels as at
// flash.py:235):
//   dV_j = sum_i P_ij^T dO_i,  dK_j = scale * sum_i dS_ij^T Q_i,
//   dQ_i = scale * sum_j dS_ij K_j,  dS = P * (dO V^T - delta).
// The TPU kernels write f32 and the custom_vjp casts to the input dtype
// (flash.py:306-309); here the f32 accumulators are rounded to bf16 once, on
// the store.
//
// What bounds it on the H100: dK/dV does four products of 2*S^2*D per head
// (Q K^T, P^T dO, V dO^T, dS^T Q) and dQ three (Q K^T, dO V^T, dS K): 14 *
// B*H*S^2*D operations in all on about 11 * B*S*H*D * 2 bytes, i.e. ~0.6 * S
// bf16 operations per byte, far above the card's ~295 at S >= 1024, so the
// tensor cores bound it.
//
// Design (FA2-style, mma.sync; wgmma and TMA are later work):
// - Blocks run in parallel in no order, so the backward is split as on the
//   TPU: one kernel owns a key tile (dK, dV) and loops over every query tile,
//   the other owns a query tile (dQ) and loops over every key tile. Each
//   output element has one owner: no atomics, and the sums are deterministic.
// - 4 warps a block, 16 rows each. dK/dV: S^T = K Q^T, P^T, dP^T = V dO^T and
//   dS^T are 16 x BQ register fragments of a warp's 16 keys; P^T and dS^T are
//   rounded to bf16 and reused in registers as the A operand of P^T dO and
//   dS^T Q. dQ: the same with queries as rows, dS K through ldmatrix.trans.
// - The looped-over operands (Q and dO, or K and V) are double-buffered in
//   shared memory with cp.async; the owned tile is loaded once, and its A
//   fragments are re-read from shared memory at every k-step.
// - Ragged S: rows past S are zero-filled; a query past S gets lse = +inf in
//   the dK/dV kernel (P = 0), and a key past S gets P = 0 in the dQ kernel.
//   D (a multiple of 8 up to 160) is zero-padded to the tile width DP = 48,
//   80 or 160 only in shared memory.
// - Tile widths: 64 keys by 64 queries, except dK/dV at DP = 160, which takes
//   32-query tiles so that its two 16 x 160 accumulators fit in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::a_frag;
using flash::b_frag;
using flash::b_frag_t;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::load_tile;
using flash::mma_bf16;
using flash::pack_bf16;

constexpr int kMaxHeadDim = 160;
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kOwn = 64;       // rows a block owns (keys in dK/dV, queries in dQ)
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // (B*H, S) f32, contiguous
  const float* delta;  // (B*H, S) f32, contiguous
  __nv_bfloat16* dq;   // (B, S, H, D) bf16, contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t q_sb, q_ss, q_sh;  // element strides of batch, seq, head; D is unit-stride
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t d_sb, d_ss, d_sh;
  int S, H, D;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

template <int DP>
struct DkvTile {
  static constexpr int kRow = DP + 8;
  static constexpr int kBQ = DP > 80 ? 32 : 64;  // queries per looped tile
  static constexpr size_t kSmem =
      (size_t)(2 * kOwn + 4 * kBQ) * kRow * 2 + 4 * kBQ * sizeof(float);
};

template <int DP>
struct DqTile {
  static constexpr int kRow = DP + 8;
  static constexpr int kBK = 64;  // keys per looped tile
  static constexpr size_t kSmem = (size_t)(2 * kOwn + 4 * kBK) * kRow * 2;
};

// Store a warp's 16 x DP accumulator (times mul) as bf16 rows of a contiguous
// (B, S, H, D) tensor; rows past S and columns past D are dropped.
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (*acc)[4], int row0,
                                           float mul, const BwdParams& p) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int64_t ss = (int64_t)p.H * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + r * 8;
    if (row >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * ss + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
  using T = DkvTile<DP>;
  constexpr int ROW = T::kRow, BQ = T::kBQ, KT = DP / 16, NT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kOwn * ROW;
  __nv_bfloat16* Qs = Vs + kOwn * ROW;  // two stages
  __nv_bfloat16* Ds = Qs + 2 * BQ * ROW;  // dO, two stages
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BQ * ROW);  // lse * log2(e), two stages
  float* Es = Ls + 2 * BQ;                                  // delta, two stages

  const int g = blockIdx.y;
  const int b = g / p.H, h = g % p.H;
  const int k0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dg = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse = p.lse + (int64_t)g * p.S;
  const float* delta = p.delta + (int64_t)g * p.S;

  // plain loads into the stage's row statistics; a query past S gets P = 0
  auto load_stats = [&](int stage, int row0) {
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int row = row0 + i;
      Ls[stage * BQ + i] = row < p.S ? lse[row] * kLog2e : INFINITY;
      Es[stage * BQ + i] = row < p.S ? delta[row] : 0.f;
    }
  };

  load_tile<DP, kOwn, kThreads>(Ks, kg, p.k_ss, k0, p.S, p.D);
  load_tile<DP, kOwn, kThreads>(Vs, vg, p.v_ss, k0, p.S, p.D);
  load_tile<DP, BQ, kThreads>(Qs, qg, p.q_ss, 0, p.S, p.D);
  load_tile<DP, BQ, kThreads>(Ds, dg, p.d_ss, 0, p.S, p.D);
  cp_async_commit();
  load_stats(0, 0);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_tiles = (p.S + BQ - 1) / BQ;
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {  // prefetch the next Q/dO tile into the other stage
      load_tile<DP, BQ, kThreads>(Qs + (stage ^ 1) * BQ * ROW, qg, p.q_ss, (i + 1) * BQ, p.S,
                                  p.D);
      load_tile<DP, BQ, kThreads>(Ds + (stage ^ 1) * BQ * ROW, dg, p.d_ss, (i + 1) * BQ, p.S,
                                  p.D);
      cp_async_commit();
      load_stats(stage ^ 1, (i + 1) * BQ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + stage * BQ * ROW;
    const __nv_bfloat16* Dt = Ds + stage * BQ * ROW;
    const float* Lt = Ls + stage * BQ;
    const float* Et = Es + stage * BQ;

    // S^T = K Q^T on this warp's 16 keys x BQ queries
    float s[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      a_frag<ROW>(Ks, warp * 16, kk, a);
#pragma unroll
      for (int n = 0; n < BQ / 8; n += 2) {
        uint32_t bq[4];
        b_frag<ROW>(Qt, n, kk, bq);
        mma_bf16(s[n], a, bq[0], bq[1]);
        mma_bf16(s[n + 1], a, bq[2], bq[3]);
      }
    }
    // P^T = exp(S^T * scale - lse[query]), in base 2
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        s[n][e] = exp2f(s[n][e] * p.scale_log2 - Lt[col]);
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(s[n][0], s[n][1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bd[4];
        b_frag_t<ROW>(Dt, n, kk, bd);
        mma_bf16(dv[n], pa[kk], bd[0], bd[1]);
        mma_bf16(dv[n + 1], pa[kk], bd[2], bd[3]);
      }
    }
    // dP^T = V dO^T
    float dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      a_frag<ROW>(Vs, warp * 16, kk, a);
#pragma unroll
      for (int n = 0; n < BQ / 8; n += 2) {
        uint32_t bd[4];
        b_frag<ROW>(Dt, n, kk, bd);
        mma_bf16(dp[n], a, bd[0], bd[1]);
        mma_bf16(dp[n + 1], a, bd[2], bd[3]);
      }
    }
    // dS^T = P^T * (dP^T - delta[query]), rounded to bf16 as the next A operand
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        ds[e] = s[n][e] * (dp[n][e] - Et[col]);
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dK += dS^T Q (times scale at the store)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bq[4];
        b_frag_t<ROW>(Qt, n, kk, bq);
        mma_bf16(dk[n], pa[kk], bq[0], bq[1]);
        mma_bf16(dk[n + 1], pa[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
  store_rows<NT>(p.dk + off, dk, k0 + warp * 16, p.scale, p);
  store_rows<NT>(p.dv + off, dv, k0 + warp * 16, 1.f, p);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  using T = DqTile<DP>;
  constexpr int ROW = T::kRow, BK = T::kBK, KT = DP / 16, NT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ds = Qs + kOwn * ROW;  // dO
  __nv_bfloat16* Ks = Ds + kOwn * ROW;  // two stages
  __nv_bfloat16* Vs = Ks + 2 * BK * ROW;  // two stages

  const int g = blockIdx.y;
  const int b = g / p.H, h = g % p.H;
  const int q0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dg = p.dout + b * p.d_sb + h * p.d_sh;

  load_tile<DP, kOwn, kThreads>(Qs, qg, p.q_ss, q0, p.S, p.D);
  load_tile<DP, kOwn, kThreads>(Ds, dg, p.d_ss, q0, p.S, p.D);
  load_tile<DP, BK, kThreads>(Ks, kg, p.k_ss, 0, p.S, p.D);
  load_tile<DP, BK, kThreads>(Vs, vg, p.v_ss, 0, p.S, p.D);
  cp_async_commit();

  float lse2[2], dl[2];  // rows gr and gr + 8 of this warp's slice
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + r * 8;
    lse2[r] = row < p.S ? p.lse[(int64_t)g * p.S + row] * kLog2e : 0.f;
    dl[r] = row < p.S ? p.delta[(int64_t)g * p.S + row] : 0.f;
  }

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_tiles = (p.S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      load_tile<DP, BK, kThreads>(Ks + (stage ^ 1) * BK * ROW, kg, p.k_ss, (j + 1) * BK, p.S,
                                  p.D);
      load_tile<DP, BK, kThreads>(Vs + (stage ^ 1) * BK * ROW, vg, p.v_ss, (j + 1) * BK, p.S,
                                  p.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * BK * ROW;
    const __nv_bfloat16* Vt = Vs + stage * BK * ROW;
    const int k0 = j * BK;

    // S = Q K^T and dP = dO V^T on this warp's 16 queries x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t aq[4], ad[4];
      a_frag<ROW>(Qs, warp * 16, kk, aq);
      a_frag<ROW>(Ds, warp * 16, kk, ad);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bk[4], bv[4];
        b_frag<ROW>(Kt, n, kk, bk);
        b_frag<ROW>(Vt, n, kk, bv);
        mma_bf16(s[n], aq, bk[0], bk[1]);
        mma_bf16(s[n + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[n], ad, bv[0], bv[1]);
        mma_bf16(dp[n + 1], ad, bv[2], bv[3]);
      }
    }
    // dS = P * (dP - delta), P = exp(S * scale - lse) and 0 past S
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        const float pr = key < p.S ? exp2f(s[n][e] * p.scale_log2 - lse2[e / 2]) : 0.f;
        ds[e] = pr * (dp[n][e] - dl[e / 2]);
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K (times scale at the store); K tiles are (key x d), read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bk[4];
        b_frag_t<ROW>(Kt, n, kk, bk);
        mma_bf16(dq[n], pa[kk], bk[0], bk[1]);
        mma_bf16(dq[n + 1], pa[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
  store_rows<NT>(p.dq + off, dq, q0 + warp * 16, p.scale, p);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const BwdParams& p, int batch_heads,
                   cudaStream_t stream, bool* attr_set) {
  if (!*attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  dim3 grid((p.S + kOwn - 1) / kOwn, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const BwdParams& p, int batch_heads, cudaStream_t stream) {
  static bool attr_set = false;
  return launch(flash_bwd_dkv_kernel<DP>, DkvTile<DP>::kSmem, p, batch_heads, stream,
                &attr_set);
}

template <int DP>
cudaError_t launch_dq(const BwdParams& p, int batch_heads, cudaStream_t stream) {
  static bool attr_set = false;
  return launch(flash_bwd_dq_kernel<DP>, DqTile<DP>::kSmem, p, batch_heads, stream, &attr_set);
}

// Checks shared by both entries; fills p. Returns cudaSuccess or
// cudaErrorInvalidValue.
cudaError_t make_params(BwdParams* p, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, int B, int S,
                        int H, int D, const long long* strides) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > kMaxHeadDim ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, dout};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  p->q = static_cast<const __nv_bfloat16*>(q);
  p->k = static_cast<const __nv_bfloat16*>(k);
  p->v = static_cast<const __nv_bfloat16*>(v);
  p->dout = static_cast<const __nv_bfloat16*>(dout);
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->q_sb = strides[0]; p->q_ss = strides[1]; p->q_sh = strides[2];
  p->k_sb = strides[3]; p->k_ss = strides[4]; p->k_sh = strides[5];
  p->v_sb = strides[6]; p->v_ss = strides[7]; p->v_sh = strides[8];
  p->d_sb = strides[9]; p->d_ss = strides[10]; p->d_sh = strides[11];
  p->S = S;
  p->H = H;
  p->D = D;
  p->scale = 1.f / sqrtf((float)D);
  p->scale_log2 = kLog2e / sqrtf((float)D);
  p->dq = p->dk = p->dv = nullptr;
  return cudaSuccess;
}

}  // namespace

extern "C" int agenda_flash_bwd_max_head_dim() { return kMaxHeadDim; }

// q, k, v, dout: (B, S, H, D) bf16 with the given element strides (q, k, v,
// dout; batch, seq, head each; D unit-stride), 16-byte-aligned bases and
// strides that are multiples of 8; D a multiple of 8 up to 160; lse, delta:
// (B*H, S) f32 contiguous; dk, dv: contiguous (B, S, H, D) bf16. Returns a
// cudaError_t (0 on success).
extern "C" int agenda_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int S, int H, int D,
                                    const long long* strides, void* stream) {
  BwdParams p;
  cudaError_t err = make_params(&p, q, k, v, dout, lse, delta, B, S, H, D, strides);
  if (err != cudaSuccess) return (int)err;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 48) return (int)launch_dkv<48>(p, B * H, st);
  if (D <= 80) return (int)launch_dkv<80>(p, B * H, st);
  return (int)launch_dkv<160>(p, B * H, st);
}

// As agenda_flash_bwd_dkv; dq: contiguous (B, S, H, D) bf16.
extern "C" int agenda_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int S, int H, int D,
                                   const long long* strides, void* stream) {
  BwdParams p;
  cudaError_t err = make_params(&p, q, k, v, dout, lse, delta, B, S, H, D, strides);
  if (err != cudaSuccess) return (int)err;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 48) return (int)launch_dq<48>(p, B * H, st);
  if (D <= 80) return (int)launch_dq<80>(p, B * H, st);
  return (int)launch_dq<160>(p, B * H, st);
}
