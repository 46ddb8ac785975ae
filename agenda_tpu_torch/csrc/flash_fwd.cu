// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 logsumexp.
//
// Replaces the TPU kernel agenda_tpu/kernels/flash.py::_flash_fwd_kernel
// (flash.py:55, launched by _flash_fwd_impl at flash.py:95-145): non-causal,
// unmasked softmax(Q K^T / sqrt(D)) V with an online softmax, f32 running max,
// sum and accumulator, and the per-row logsumexp the backward needs.
//
// What bounds it on the H100: 4*B*H*S^2*D tensor operations on 4*B*S*H*D*2
// bytes, i.e. S/2 bf16 operations per byte (>= 512 at S = 1024), far above
// the card's ~295 operations per byte; and B*H*S^2 exponentials on the SFU
// at about 3.9e12/s. At D = 40 the exponentials take longer than the
// products (0.138 against 0.087 ms at (4, 4096, 8, 40)), at D >= 80 the
// tensor cores bound it; at S <= 256 the bytes do. In practice the supply of
// K/V tiles does at D = 40: a tile row is 80 bytes, one per (s, h), and a
// copy of the kernel that only loads its tiles takes about 70% of the whole
// kernel's time (kernel_variants.py).
//
// Two kernels, picked by D:
//
// D <= 160 (every UNet head dim): flash_fwd_wgmma_kernel, FlashAttention-3's
// shape, built from hopper_common.cuh as the backward (flash_bwd.cu) is.
// - A producer warp loads the block's Q tile once and keeps K and V tiles in
//   flight in a ring of three or four stages, by TMA under full/empty
//   mbarriers, from (D, H, S, B) tensor maps of the caller's strides: 64-column
//   boxes, 128-byte swizzle, zero fill past S and past D. No padded copy is
//   made in device memory; the maps are encoded on every call.
// - Consumer warpgroups own 64 query rows each and share the ring, so each
//   K/V tile is read from L2 once for every 64 * WGS queries: four groups a
//   block at D = 40 and two at 80, one where that would leave fewer blocks
//   than the card has SMs, and one at 160. S = Q K^T is wgmma SS over
//   ceil(D/16) k-steps; P is
//   rounded to bf16 in registers (as the TPU kernel casts P to V's dtype) and
//   O += P V is wgmma RS with V read MN-major from the same tile.
// - Online softmax in f32, base 2: each score costs one FFMA (the scale
//   folded into the exponent's argument) and one ex2.approx.ftz; keys past S
//   are masked only in the last key tile; the row sum is taken from f32 P.
// - Overlap: tile j's S = Q K^T is issued before tile j-1's P V, and its
//   softmax runs while P V does (FlashAttention-3's intra-warpgroup
//   pipelining); the groups of a block overlap one another's products and
//   softmax as the warp schedulers see fit. Two of FlashAttention-3's
//   devices measured slower here over a generation batch, and are not
//   used: groups taking turns at named barriers, and pairs of blocks sharing
//   each K/V tile by TMA multicast.
// - Each output element has one owner: no atomics; two launches on the same
//   inputs give bitwise-equal outputs.
//
// D > 160 (the VAE's single-head D = 512): flash_fwd_wide_kernel, FA2-style
// mma.sync, one launch a batch, level with SDPA there. A 16 x 512 f32
// accumulator would take 256 registers a thread, so 8 warps split O's
// columns in two halves (the two warps of a row slice each compute the same
// 16 x 32 scores); key tiles are 32 rows, double-buffered by cp.async, so
// that Q and two K/V stages fit in 227 KB of shared memory, and Q's
// fragments are re-read from shared memory at each k-step. D is zero-padded
// to 512 in shared memory only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kMaxHeadDim = 512;
constexpr int kMaxWgmmaHeadDim = 160;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

// -- D <= 160: wgmma and TMA --------------------------------------------------

using hopper::acc_to_a;
using hopper::align1024;
using hopper::desc_k_major;
using hopper::desc_mn_major;
using hopper::exp2_ftz;
using hopper::fence_regs;
using hopper::load_rows;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
using hopper::WgmmaRS;
using hopper::WgmmaSS;

struct FwdParams {
  CUtensorMap tq, tk, tv;  // bf16 (D, H, S, B) maps, 64-column boxes, 128-byte swizzle
  __nv_bfloat16* o;        // (B, S, H, D) bf16 with the element strides below
  float* lse;              // (B*H, S) f32, contiguous
  int64_t o_sb, o_ss, o_sh;
  int S, H, D;
  float scale_log2;  // log2(e) / sqrt(D): the softmax runs in base 2
};

// Block shape for an RS width ND (40, 80 or 160) and WGS consumer
// warpgroups: tiles are kAtoms blocks of 64 columns (128 bytes a row), kKSteps
// k-steps of 16 cover ND, and a block owns 64 query rows for each consumer
// warpgroup. Key tiles are 128 rows at ND = 80 and 64 rows at 40 and 160
// (registers: four groups at 40, the 64 x 160 f32 accumulator at 160), in a
// ring of four stages at 40 and three at 80 and 160 (as deep as 227 KB of
// shared memory allows at 80).
template <int ND, int WGS>
struct FwdTile {
  static constexpr int kAtoms = (ND + 63) / 64;
  static constexpr int kKSteps = (ND + 15) / 16;
  static constexpr uint32_t kRowBytes = kAtoms * 128;
  static constexpr int kOwn = 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kBK = ND == 80 ? 128 : 64;   // keys per K/V tile
  static constexpr int kStages = ND == 40 ? 4 : 3;  // ring of K/V tiles
  static constexpr uint32_t kQBytes = kOwn * kRowBytes;
  static constexpr uint32_t kTileBytes = kBK * kRowBytes;
  // Q; K and V per stage; barriers; alignment slack
  static constexpr size_t kSmem =
      kQBytes + 2 * kStages * kTileBytes + (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// the most consumer warpgroups a block takes at each width (registers: four
// groups of 128 and a producer warp leave 112 a thread; at 160 the 64 x 160
// f32 accumulator takes 80 of them, and one group a block fills the card at
// every main-path shape)
constexpr int fwd_warpgroups(int nd) { return nd == 40 ? 4 : nd == 80 ? 2 : 1; }

template <int ND, int WGS>
__global__ void __launch_bounds__(FwdTile<ND, WGS>::kThreads)
    flash_fwd_wgmma_kernel(const __grid_constant__ FwdParams p) {
  using T = FwdTile<ND, WGS>;
  constexpr int A = T::kAtoms, KS = T::kKSteps, BK = T::kBK, OWN = T::kOwn;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + T::kQBytes;                 // kStages tiles
  unsigned char* Vs = Ks + T::kStages * T::kTileBytes;  // kStages tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + T::kStages * T::kTileBytes);
  uint64_t* empty = full + T::kStages;
  uint64_t* own = empty + T::kStages;

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int q0 = blockIdx.x * OWN;
  const int n_tiles = (p.S + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers / 32);  // one arrival a consumer warp
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= T::kConsumers) {  // the producer warp: one thread issues every load
    if (threadIdx.x == T::kConsumers) {
      mbar_arrive_expect_tx(own, T::kQBytes);
      load_rows<A, OWN>(Qs, &p.tq, own, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % T::kStages;
        mbar_wait(&empty[s], ((j / T::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);
        load_rows<A, BK>(Ks + s * T::kTileBytes, &p.tk, &full[s], j * BK, h, b);
        load_rows<A, BK>(Vs + s * T::kTileBytes, &p.tv, &full[s], j * BK, h, b);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg owns queries q0 + 64 * wg + [0, 64); this thread
    // holds rows 16 * warp + gr (+8) of them: scores s[4 j + e] at key
    // 8 j + 2 tq + (e & 1), row half e >> 1
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
    const uint32_t q_s = hopper::smem_u32(Qs) + wg * 64 * 128;

    float o[ND / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t pa[BK / 16][4];  // P of the previous tile as A operands
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores, base 2
    float l[2] = {0.f, 0.f};              // running sums, this thread's columns
    mbar_wait(own, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % T::kStages;
      mbar_wait(&full[st], (j / T::kStages) & 1);
      const uint32_t k_s = hopper::smem_u32(Ks + st * T::kTileBytes);
      const uint32_t v_prev =
          hopper::smem_u32(Vs + (j + T::kStages - 1) % T::kStages * T::kTileBytes);

      // S = Q K^T (64 queries x BK keys), then the previous tile's O += P V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaSS<BK>::run(s, desc_k_major<OWN>(q_s, kk), desc_k_major<BK>(k_s, kk), kk > 0);
      wgmma_commit();
      if (j > 0) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          WgmmaRS<ND, 1>::run(o, pa[kk], desc_mn_major<BK>(v_prev, kk), 1);
        wgmma_commit();
      }

      // online softmax of S while P V runs
      if (j > 0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      const int key0 = j * BK;
      if (key0 + BK > p.S) {  // the last tile: keys past S get P = 0
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (key0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= p.S) s[i] = -INFINITY;
      }
      // max and sum over two partial results a row half, (i >> 2) & 1, so
      // that each chain is half as long
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 3] = fmaxf(mx[(i >> 1) & 3], s[i]);
      float neg[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], mx[r + 2]);
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);  // finite: key0 < S
        alpha[r] = exp2_ftz(m[r] - m_new);
        neg[r] = -m_new;
        m[r] = m_new;
      }
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = exp2_ftz(fmaf(s[i], p.scale_log2, neg[(i >> 1) & 1]));
        sum[(i >> 1) & 3] += s[i];
      }
      l[0] = l[0] * alpha[0] + (sum[0] + sum[2]);
      l[1] = l[1] * alpha[1] + (sum[1] + sum[3]);

      // the previous P V is done: its K/V stage is free, O is rescaled to
      // the new max and P takes this tile's probabilities
      wgmma_wait<0>();
      fence_regs<ND / 2>(o);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % T::kStages]);
#pragma unroll
      for (int i = 0; i < ND / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
    }
    // the last tile's O += P V
    wgmma_fence();
    const uint32_t v_last = hopper::smem_u32(Vs + (n_tiles - 1) % T::kStages * T::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<ND, 1>::run(o, pa[kk], desc_mn_major<BK>(v_last, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<ND / 2>(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + 64 * wg + 16 * (threadIdx.x / 32 % 4) + gr;
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.S) continue;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 2 * r; i < ND / 2; i += 4) {
        const int col = 8 * (i >> 2) + 2 * tq;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)row * p.o_ss + col) =
              __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
      if (tq == 0) p.lse[(int64_t)g * p.S + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int ND, int WGS>
cudaError_t launch_wgmma(const FwdParams& p, int batch_heads, cudaStream_t stream) {
  using T = FwdTile<ND, WGS>;
  static bool attr_set = false;  // opt in to > 48 KB of dynamic shared memory once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<ND, WGS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((p.S + T::kOwn - 1) / T::kOwn, batch_heads);
  flash_fwd_wgmma_kernel<ND, WGS><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The most warpgroups a block at width ND takes, unless that leaves fewer
// blocks than the card has SMs; then one (64 query rows a block).
template <int ND>
cudaError_t launch_nd(FwdParams* p, const void* const* ptr, const long long* strides, int B,
                      cudaStream_t stream) {
  constexpr int WGS = fwd_warpgroups(ND);
  using Many = FwdTile<ND, WGS>;
  using One = FwdTile<ND, 1>;
  const int bh = B * p->H;
  const int sms = hopper::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const bool many = WGS > 1 && (long long)bh * ((p->S + Many::kOwn - 1) / Many::kOwn) >= sms;
  const int q_rows = many ? Many::kOwn : One::kOwn;
  const int kv_rows = many ? Many::kBK : One::kBK;
  if (!hopper::encode_bshd(&p->tq, ptr[0], strides, B, p->S, p->H, p->D, q_rows) ||
      !hopper::encode_bshd(&p->tk, ptr[1], strides + 3, B, p->S, p->H, p->D, kv_rows) ||
      !hopper::encode_bshd(&p->tv, ptr[2], strides + 6, B, p->S, p->H, p->D, kv_rows))
    return cudaErrorInvalidValue;
  return many ? launch_wgmma<ND, WGS>(*p, bh, stream) : launch_wgmma<ND, 1>(*p, bh, stream);
}

// -- D > 160: mma.sync --------------------------------------------------------

using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldmatrix_x4;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;

struct WideParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int64_t q_sb, q_ss, q_sh;  // element strides of batch, seq, head; D is unit-stride
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int S, H, D;
  float scale_log2;
};

namespace wide {
constexpr int kDP = kMaxHeadDim;  // D zero-padded to 512 in shared memory
constexpr int kBQ = 64;           // query rows per block: 4 row slices of 16
constexpr int kThreads = 256;     // two warps per row slice, one for each half of O's columns
constexpr int kBK = 32;           // keys per K/V tile
constexpr int kRow = kDP + 8;     // 16 bytes of pad: ldmatrix rows land in distinct banks
constexpr int kKT = kDP / 16;     // k-steps of Q K^T
constexpr int kNT = kDP / 8 / 2;  // 8-column tiles of O per warp
constexpr size_t kSmem = (size_t)(kBQ + 4 * kBK) * kRow * 2;  // Q, K[2], V[2]
}  // namespace wide

// rows [row0, row0 + ROWS) of one (batch, head) slice -> a (ROWS x 512) smem
// tile, zero-filled past S and past D
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int row0, const WideParams& p) {
  constexpr int chunks = wide::kDP / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += wide::kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool valid = row0 + r < p.S && c < p.D;
    const __nv_bfloat16* g = valid ? src + (int64_t)(row0 + r) * row_stride + c : src;
    cp_async16(flash::smem_u32(dst + r * wide::kRow + c), g, valid);
  }
}

__global__ void __launch_bounds__(wide::kThreads) flash_fwd_wide_kernel(WideParams p) {
  using namespace wide;
  constexpr int ROW = kRow, BK = kBK, KT = kKT, NT = kNT;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * ROW;  // two stages
  __nv_bfloat16* Vs = Ks + 2 * BK * ROW;

  const int g = blockIdx.y;
  const int b = g / p.H, h = g % p.H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slice = warp % 4;       // this warp's 16 query rows
  const int n0 = (warp / 4) * NT;   // this warp's first 8-column tile of O
  const int gr = lane / 4, tq = lane % 4;  // fragment row group, thread in quad
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;

  load_tile<kBQ>(Qs, qg, p.q_ss, q0, p);
  cp_async_commit();
  load_tile<BK>(Ks, kg, p.k_ss, 0, p);
  load_tile<BK>(Vs, vg, p.v_ss, 0, p);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const __nv_bfloat16* q_frag = Qs + (slice * 16 + (lane % 16)) * ROW + (lane / 16) * 8;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // rows gr and gr + 8, base-2 scaled
  float l_row[2] = {0.f, 0.f};               // per-thread partial sums

  const int n_tiles = (p.S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      load_tile<BK>(Ks + (stage ^ 1) * BK * ROW, kg, p.k_ss, (j + 1) * BK, p);
      load_tile<BK>(Vs + (stage ^ 1) * BK * ROW, vg, p.v_ss, (j + 1) * BK, p);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * BK * ROW;
    const __nv_bfloat16* Vt = Vs + stage * BK * ROW;
    const int k0 = j * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(flash::smem_u32(q_frag + kk * 16), a);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {  // two 8-key tiles per ldmatrix.x4
        uint32_t bk[4];
        ldmatrix_x4(flash::smem_u32(Kt + (n * 8 + (lane % 8) + (lane / 16) * 8) * ROW +
                                    kk * 16 + ((lane / 8) % 2) * 8),
                    bk);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax on rows gr (elements 0, 1) and gr + 8 (elements 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        const float v = key < p.S ? s[n][e] * p.scale_log2 : -INFINITY;
        s[n][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);  // finite: key k0 is in range
      alpha[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    uint32_t pa[BK / 16][4];  // P as A fragments, bf16 as the TPU kernel rounds it
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m_row[0]), p1 = exp2f(s[n][1] - m_row[0]);
      const float p2 = exp2f(s[n][2] - m_row[1]), p3 = exp2f(s[n][3] - m_row[1]);
      l_row[0] += p0 + p1;
      l_row[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V on this warp's columns; V tiles are (key x d) row-major, read
    // transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(flash::smem_u32(Vt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                                   ROW +
                                          (n0 + n) * 8 + (lane / 16) * 8),
                          bv);
        mma_bf16(o[n], pa[kk], bv[0], bv[1]);
        mma_bf16(o[n + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + slice * 16 + gr + r * 8;
    if (row >= p.S) continue;
    const float inv = 1.f / l_row[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = (n0 + n) * 8 + 2 * tq;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)row * p.o_ss + col) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (tq == 0 && n0 == 0) p.lse[(int64_t)g * p.S + row] = (m_row[r] + log2f(l_row[r])) * kLn2;
  }
}

cudaError_t launch_wide(const WideParams& p, int batch_heads, cudaStream_t stream) {
  static bool attr_set = false;  // opt in to > 48 KB of dynamic shared memory once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((p.S + wide::kBQ - 1) / wide::kBQ, batch_heads);
  flash_fwd_wide_kernel<<<grid, wide::kThreads, wide::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int agenda_flash_fwd_max_head_dim() { return kMaxHeadDim; }

// Host time, in ns, of the tensor-map encodes of `reps` launches at D <= 160
// (three maps a launch, here all of q's: (B, S, H, D) with q's element
// strides); -1 if cuTensorMapEncodeTiled refuses a map.
extern "C" int agenda_flash_fwd_encode_ns(const void* q, int B, int S, int H, int D,
                                          long long q_sb, long long q_ss, long long q_sh,
                                          int reps) {
  const long long strides[3] = {q_sb, q_ss, q_sh};
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < 3 * reps; ++i)
    if (!hopper::encode_bshd(&map, q, strides, B, S, H, D, 64)) return -1;
  return (int)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

// q, k, v, o: (B, S, H, D) bf16 with the given element strides (D unit-stride),
// 16-byte-aligned bases and strides that are multiples of 8; D a multiple of
// 8 up to kMaxHeadDim; lse: (B*H, S) f32, contiguous. Returns a cudaError_t
// (0 on success).
extern "C" int agenda_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int S, int H, int D, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                                long long o_ss, long long o_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > kMaxHeadDim ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  for (long long s : strides)
    if (s % 8 != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  if (D <= kMaxWgmmaHeadDim) {
    FwdParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.S = S;
    p.H = H;
    p.D = D;
    p.scale_log2 = scale_log2;
    if (D <= 40) return (int)launch_nd<40>(&p, ptrs, strides, B, st);
    if (D <= 80) return (int)launch_nd<80>(&p, ptrs, strides, B, st);
    return (int)launch_nd<160>(&p, ptrs, strides, B, st);
  }
  WideParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.S = S;
  p.H = H;
  p.D = D;
  p.scale_log2 = scale_log2;
  return (int)launch_wide(p, B * H, st);
}
