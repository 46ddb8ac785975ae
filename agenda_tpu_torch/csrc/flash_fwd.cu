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
// D > 160 (the VAE's single-head D = 512): flash_fwd_wide_wgmma_kernel, the
// same TMA ring and wgmma products with D split between two consumer
// warpgroups. Its bound is the tensor operations, 4*B*H*S^2*D (0.0695 ms at
// the VAE decode's (2, 4096, 1, 512)). The warp-level kernel it replaces
// reached 15% of that: its 16-row warps re-read every K and V tile and their
// Q slice from shared memory, warp by warp (about 512 KB of shared-memory
// reads a 32-key tile, some 4 100 clocks at 128 bytes a clock), the two warps
// of each row slice computed the same 16 x 32 scores, and every tile waited
// on its copies under __syncthreads.
// - A 64 x 512 f32 accumulator does not fit one warpgroup (256 registers a
//   thread), so group c owns O's columns [256 c, 256 c + 256), 128 registers.
// - Scores once: group c computes the partial S = Q K^T over its own half of
//   D (wgmma SS, 64 queries x 32 keys); the two partials meet in shared
//   memory under a named barrier of the 256 consumer threads, and each group
//   adds the other's to its own in the same fragment order. The sum is
//   commutative, so both groups hold the same S, run the same softmax on it
//   and stay deterministic. P feeds O_c += P V[:, half c] as the register A
//   operand (wgmma RS, N = 256, V read MN-major).
// - wgmma reads each B tile once a 64-row warpgroup: about 128 KB of
//   shared-memory reads a 32-key tile instead of 512.
// - A producer warp (one thread of it), after the two consumer warpgroups,
//   loads Q once and K and V tiles of 32 keys by TMA from (D, H, S, B) maps
//   of the caller's strides (64-column boxes, 128-byte swizzle, zero fill
//   past S and past D, whole boxes past D too, so that every group issues
//   the same products at every D), K and V each in a ring of two stages
//   under full/empty mbarriers, so that V lands while S is computed: 64 KB
//   of Q, 128 KB of ring and 32 KB of partial S (two parities) fill 225 KB,
//   one block an SM.
// - Registers: every thread of a block gets the same count, and a block of
//   9 to 12 warps at most 168: the register file is four sub-partitions of
//   16384, and three of its warps share one (a cap of 224 at 288 threads is
//   refused at launch, kernel_variants.py fwd_wide_maxnreg). ptxas gives the
//   kernel 166 with 64 bytes of spills and serializes its wgmma products
//   (C7512), at 288 threads as at 384, the likelier reason it reaches about
//   a third of its bound. So tile j's S and tile j-1's P V are not in flight
//   together (the two groups overlap each other's products instead), and
//   the softmax keeps one max and one sum a row half. Whether setmaxnreg,
//   with a producer warpgroup to take registers from, lifts the cap is open.
// - Each 64-query block reads all of its head's K and V from L2 (1 GB at
//   (2, 4096, 1, 512)). Clusters of two blocks that shared each tile by TMA
//   multicast halved those reads and measured the same (PERF.md), so
//   the kernel has no cluster.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

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

// -- D > 160: two consumer warpgroups split D ---------------------------------

using hopper::bar_sync;
using hopper::fence_async_smem;

// Block shape of the wide kernel: 64 query rows, 32-key K/V tiles in a ring
// of two stages (K and V under barriers of their own), tiles of eight
// 64-column blocks (D <= 512), and two buffers of each group's partial S (a
// parity of the key tile).
struct WideFwd {
  static constexpr int kBQ = 64;
  static constexpr int kBK = 32;
  static constexpr int kHalf = 256;  // O columns (and S's k-range) of a consumer warpgroup
  static constexpr int kAtoms = kMaxHeadDim / 64;
  static constexpr int kStages = 2;
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp, last
  static constexpr uint32_t kQBytes = kBQ * kAtoms * 128;     // 64 KB
  static constexpr uint32_t kTileBytes = kBK * kAtoms * 128;  // 32 KB, K or V
  static constexpr uint32_t kXBytes = kBQ * kBK * 4;          // a partial S, f32
  // Q; K and V per stage; partial S of both groups, two parities; barriers; slack
  static constexpr size_t kSmem = kQBytes + 2 * kStages * kTileBytes + 4 * kXBytes +
                                  (4 * kStages + 1) * sizeof(uint64_t) + 1024;
};

__global__ void __launch_bounds__(WideFwd::kThreads, 1)
    flash_fwd_wide_wgmma_kernel(const __grid_constant__ FwdParams p) {
  using W = WideFwd;
  constexpr int BK = W::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + W::kQBytes;                  // kStages tiles
  unsigned char* Vs = Ks + W::kStages * W::kTileBytes;  // kStages tiles
  float* Xs = reinterpret_cast<float*>(Vs + W::kStages * W::kTileBytes);  // [parity][group]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(Xs) +
                                                 4 * W::kXBytes);
  uint64_t* empty_k = full_k + W::kStages;
  uint64_t* full_v = empty_k + W::kStages;
  uint64_t* empty_v = full_v + W::kStages;
  uint64_t* own = empty_v + W::kStages;

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int q0 = blockIdx.x * W::kBQ;
  const int n_tiles = (p.S + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], W::kConsumers / 32);  // one arrival a consumer warp
      mbar_init(&empty_v[s], W::kConsumers / 32);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = hopper::warpgroup_index();
  if (wg == 2) {  // the producer warp: one thread issues every load
    if (threadIdx.x == W::kConsumers) {
      mbar_arrive_expect_tx(own, W::kQBytes);
      load_rows<W::kAtoms, W::kBQ>(Qs, &p.tq, own, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % W::kStages;
        const uint32_t phase = ((j / W::kStages) & 1) ^ 1;
        mbar_wait(&empty_k[s], phase);
        mbar_arrive_expect_tx(&full_k[s], W::kTileBytes);
        load_rows<W::kAtoms, BK>(Ks + s * W::kTileBytes, &p.tk, &full_k[s], j * BK, h, b);
        mbar_wait(&empty_v[s], phase);
        mbar_arrive_expect_tx(&full_v[s], W::kTileBytes);
        load_rows<W::kAtoms, BK>(Vs + s * W::kTileBytes, &p.tv, &full_v[s], j * BK, h, b);
      }
    }
    __syncwarp();
  } else {
    // Consumer warpgroup c owns O's columns [256 c, 256 c + 256) and S's
    // k-range over the same columns of D; this thread holds rows 16 * warp +
    // gr (+8) of the block's 64: scores s[4 j + e] at key 8 j + 2 tq + (e & 1),
    // row half e >> 1, in both groups alike.
    const int c = wg, t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
    const uint32_t q_half = hopper::smem_u32(Qs) + 4 * c * W::kBQ * 128;
    const uint32_t half_off = 4 * c * BK * 128;  // the group's first column block in a K/V tile

    float o[W::kHalf / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < W::kHalf / 2; ++i) o[i] = 0.f;
    uint32_t pa[BK / 16][4];  // P as A operands
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores, base 2
    float l[2] = {0.f, 0.f};              // running sums, this thread's columns
    mbar_wait(own, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % W::kStages;
      const uint32_t parity = (j / W::kStages) & 1;
      mbar_wait(&full_k[st], parity);
      const uint32_t k_half = hopper::smem_u32(Ks + st * W::kTileBytes) + half_off;

      // this group's partial S = Q K^T over its columns of D. Tile j's S and
      // tile j-1's P V are not in flight together: with O's 128 registers a
      // thread both would take more than a block of 384 threads has (168)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W::kHalf / 16; ++kk)
        WgmmaSS<BK>::run(s, desc_k_major<W::kBQ>(q_half, kk), desc_k_major<BK>(k_half, kk),
                         kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      if (lane == 0) mbar_arrive(&empty_k[st]);

      // S = the two groups' partials: each writes its own and adds the
      // other's, in its own fragment order (thread t of both groups holds the
      // same elements); the sum is commutative, so both groups hold the same S
      float* x_own = Xs + ((j & 1) * 2 + c) * (W::kXBytes / 4);
      const float* x_other = Xs + ((j & 1) * 2 + (c ^ 1)) * (W::kXBytes / 4);
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4)
        *reinterpret_cast<float4*>(x_own + (i / 4 * 128 + t) * 4) =
            make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
      bar_sync(1, W::kConsumers);
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        const float4 xo = *reinterpret_cast<const float4*>(x_other + (i / 4 * 128 + t) * 4);
        s[i] += xo.x;
        s[i + 1] += xo.y;
        s[i + 2] += xo.z;
        s[i + 3] += xo.w;
      }

      // online softmax of S, as in the kernel for D <= 160
      const int key0 = j * BK;
      if (key0 + W::kBK > p.S) {  // keys past S get P = 0
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (key0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= p.S) s[i] = -INFINITY;
      }
      // one max and one sum a row half (the kernel for D <= 160 keeps two
      // partials of each; here the registers are short)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float neg[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);  // finite: key0 < S
        alpha[r] = exp2_ftz(m[r] - m_new);
        neg[r] = -m_new;
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = exp2_ftz(fmaf(s[i], p.scale_log2, neg[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];

      // O rescaled to the new max, then O += P V[:, half c], V read MN-major
#pragma unroll
      for (int i = 0; i < W::kHalf / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
      mbar_wait(&full_v[st], parity);
      const uint32_t v_half = hopper::smem_u32(Vs + st * W::kTileBytes) + half_off;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<W::kHalf, 1>::run(o, pa[kk], desc_mn_major<BK>(v_half, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<W::kHalf / 2>(o);
      if (lane == 0) mbar_arrive(&empty_v[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + 16 * (t / 32) + gr;
    const int col0 = W::kHalf * c;
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.S) continue;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 2 * r; i < W::kHalf / 2; i += 4) {
        const int col = col0 + 8 * (i >> 2) + 2 * tq;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)row * p.o_ss + col) =
              __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
      if (c == 0 && tq == 0) p.lse[(int64_t)g * p.S + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// Q in boxes of 64 rows, K and V in boxes of 32; one block a 64-query tile of
// a (batch, head)
cudaError_t launch_wide(FwdParams* p, const void* const* ptr, const long long* strides, int B,
                        cudaStream_t stream) {
  using W = WideFwd;
  static bool attr_set = false;  // opt in to > 48 KB of dynamic shared memory once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)W::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (!hopper::encode_bshd(&p->tq, ptr[0], strides, B, p->S, p->H, p->D, W::kBQ) ||
      !hopper::encode_bshd(&p->tk, ptr[1], strides + 3, B, p->S, p->H, p->D, W::kBK) ||
      !hopper::encode_bshd(&p->tv, ptr[2], strides + 6, B, p->S, p->H, p->D, W::kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((p->S + W::kBQ - 1) / W::kBQ, B * p->H);
  flash_fwd_wide_wgmma_kernel<<<grid, W::kThreads, W::kSmem, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int agenda_flash_fwd_max_head_dim() { return kMaxHeadDim; }

// Host time, in ns, of the tensor-map encodes of `reps` launches (three maps a
// launch, here all of q's: (B, S, H, D) with q's element strides); -1 if
// cuTensorMapEncodeTiled refuses a map.
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
  if (D <= kMaxWgmmaHeadDim) return (int)launch_nd<160>(&p, ptrs, strides, B, st);
  return (int)launch_wide(&p, ptrs, strides, B, st);
}
