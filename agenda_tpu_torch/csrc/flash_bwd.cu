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
// (K Q^T, P^T dO, V dO^T, dS^T Q) and dQ three (Q K^T, dO V^T, dS K), on
// about 11 * B*S*H*D * 2 bytes: ~0.6 * S bf16 operations per byte, far above
// the card's ~295 at S >= 1024. Each kernel also takes B*H*S^2 exponentials
// (P is recomputed in both), on the SFU at about 3.9e12/s; at D = 40 that
// takes longer than dQ's three products at 989e12/s. So the tensor cores or
// the exponentials bound it, never the bytes from device memory. In practice
// the tiles' supply does: at D = 40 a tile row is 80 bytes, one per (s, h),
// and a copy of the kernel with the dP product, the RS products and the
// exponentials taken out still takes about 70% of the whole kernel's time.
//
// Design (wgmma and TMA; consumer warpgroups and one producer warp a block):
// - Blocks run in parallel in no order, so the backward is split as on the
//   TPU: one kernel owns keys (dK, dV) and loops over every query tile, the
//   other owns queries (dQ) and loops over every key tile. Each output
//   element has one owner: no atomics, and the sums are deterministic (two
//   launches on the same inputs give bitwise-equal gradients).
// - Each consumer warpgroup owns 64 rows; a block has one to three of them
//   (Block, DkvTile, DqTile), which share the looped-over tiles, so each is
//   read from L2 once for every 64 to 192 owned rows.
// - The producer warp loads the owned tile once and keeps the looped-over
//   tiles (K and V, or Q and dO with their lse and delta rows) in flight in a
//   ring of two or three stages, by TMA (cp.async.bulk.tensor) under
//   full/empty mbarriers; the consumers never run __syncthreads. The four
//   tensor maps are encoded on every call from the caller's (B, S, H, D)
//   strides; TMA zero-fills rows past S and columns past D in shared memory
//   (128-byte swizzle). The dK/dV producer reads the next tile's lse and
//   delta while it waits for a free stage.
// - A consumer warpgroup runs every product as wgmma over its 64 rows:
//   S = Q K^T and dP = dO V^T (or their transposes) with both operands in
//   shared memory (SS), each group committed on its own so that exp(S)
//   overlaps the dP product; P and dS are rounded to bf16 in registers and
//   feed dQ += dS K, dV += P^T dO and dK += dS^T Q as the register A operand
//   (RS), with K, dO and Q read MN-major from the same tiles. The last
//   products of a tile are waited for only in the next one, after its S.
// - Only ceil(D / 16) k-steps over D are issued, and the RS products are
//   N = 40, 80 or 160 wide (D rounded up to the next of these).
// - Ragged S: a query past S gets lse = +inf in the dK/dV kernel (P = 0), and
//   a key past S gets P = 0 in the dQ kernel.
// - Registers: dK/dV holds two 64 x N f32 accumulators, 160 registers a
//   thread at N = 160, so there a block has one consumer warpgroup and its
//   query tiles shrink to 32 rows (the scores then take 16 registers each).
//   Blocks are sized for one an SM; the producer warp's spare registers
//   would not buy another warpgroup, so no setmaxnreg.
//
// D > 160 (the VAE's single-head mid-block attention, D = 512): two
// mma.sync kernels in the shape of the wide forward (flash_fwd.cu), for any
// D up to 512 that is a multiple of 8. Neither a 64 x 512 f32 accumulator
// (dK and dV need two) nor 64-row tiles of 512 bf16 fit a warpgroup's
// registers or a block's shared memory, so:
// - A block owns 32 rows (keys in dK/dV, queries in dQ) and loops over
//   tiles of 32 rows of the other side, double-buffered by cp.async; owned
//   rows and two stages of two tiles, 512 columns each, are 195 KB.
// - Eight warps: two row slices of 16 owned rows times four quarters of D.
//   Each warp accumulates its 16 rows x 128 columns of each gradient (dK and
//   dV: 128 f32 registers a thread).
// - The score products split by columns, not by D: for each looped tile,
//   warp (slice, quarter) computes the 16 x 8 block of S (and dP) of its
//   slice's rows and the quarter's 8 looped rows over all of D, so no
//   product is computed twice and no partial sum crosses warps. It rounds P
//   and dS of its block to bf16 into shared memory; after a barrier every
//   warp of the slice reads the whole 16 x 32 block as its A operand and
//   multiplies it into its own 128 columns (V, dO, Q or K read transposed by
//   ldmatrix).
// - Ragged S: a tile row past S is loaded as row S - 1 (every read in
//   bounds, no zero fill), and the kernels mask those rows: a query past S
//   gets lse = +inf and delta = 0 in dK/dV (P = dS = 0), a key past S gets
//   P = 0 in dQ. Columns past D are zero-filled in shared memory, and only
//   ceil(D / 32) * 2 k-steps of the score products are issued.
// - Each gradient element has one owner: no atomics, deterministic sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using hopper::acc_to_a;
using hopper::align1024;
using hopper::desc_k_major;
using hopper::desc_mn_major;
using hopper::exp2_ftz;
using hopper::fence_regs;
using hopper::load_rows;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
using hopper::WgmmaRS;
using hopper::WgmmaSS;

constexpr int kMaxWgmmaHeadDim = 160;
constexpr int kMaxHeadDim = 512;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // bf16 (D, H, S, B) maps, 64-column boxes, 128-byte swizzle
  const float* lse;             // (B*H, S) f32, contiguous
  const float* delta;           // (B*H, S) f32, contiguous
  __nv_bfloat16* dq;            // (B, S, H, D) bf16, contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, H, D;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

// Block shape for an RS width ND (40, 80 or 160) and WGS consumer
// warpgroups: tiles are kAtoms blocks of 64 columns (128 bytes a row), and
// kKSteps k-steps of 16 cover ND. A block owns kOwn rows (keys in dK/dV,
// queries in dQ), 64 for each consumer warpgroup; they share the looped-over
// tiles, so more of them read those tiles fewer times a row.
template <int ND, int WGS>
struct Block {
  static constexpr int kAtoms = (ND + 63) / 64;
  static constexpr int kKSteps = (ND + 15) / 16;
  static constexpr uint32_t kRowBytes = kAtoms * 128;
  static constexpr int kOwn = 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr uint32_t kOwnBytes = kOwn * kRowBytes;
};

// dK/dV: two consumer warpgroups at ND <= 80; one at 160, where two 64 x 160
// f32 accumulators take 160 registers a thread and query tiles shrink to 32
constexpr int dkv_warpgroups(int nd) { return nd > 80 ? 1 : 2; }

template <int ND>
struct DkvTile : Block<ND, dkv_warpgroups(ND)> {
  using B = Block<ND, dkv_warpgroups(ND)>;
  static constexpr int kBQ = ND > 80 ? 32 : 64;  // queries per looped tile
  static constexpr int kStages = 3;                // ring of looped-over tiles
  static constexpr uint32_t kTileBytes = kBQ * B::kRowBytes;
  // K, V; Q and dO per stage; lse and delta per stage; barriers; alignment slack
  static constexpr size_t kSmem = 2 * B::kOwnBytes + 2 * kStages * kTileBytes +
                                  2 * kStages * kBQ * sizeof(float) +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// dQ: three consumer warpgroups at ND = 40 (their registers allow it), two at
// 80, one at 160
constexpr int dq_warpgroups(int nd) { return nd > 80 ? 1 : nd > 40 ? 2 : 3; }

template <int ND>
struct DqTile : Block<ND, dq_warpgroups(ND)> {
  using B = Block<ND, dq_warpgroups(ND)>;
  static constexpr int kBK = 64;                   // keys per looped tile
  static constexpr int kStages = ND > 80 ? 2 : 3;  // ring of looped-over tiles
  static constexpr uint32_t kTileBytes = kBK * B::kRowBytes;
  // Q, dO; K and V per stage; barriers; alignment slack
  static constexpr size_t kSmem = 2 * B::kOwnBytes + 2 * kStages * kTileBytes +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// Store a warpgroup's 64 x N f32 accumulator (N2 = N / 2 registers a
// thread), times mul, as bf16 rows [row0, row0 + 64) of a contiguous
// (B, S, H, D) tensor; rows past S and columns past D are dropped.
template <int N2>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float* d, int row0,
                                          float mul, const BwdParams& p) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int64_t rs = (int64_t)p.H * p.D;
  row0 += 16 * (threadIdx.x / 32 % 4) + gr;
#pragma unroll
  for (int i = 0; i < N2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * tq;
    if (row < p.S && col < p.D)
      *reinterpret_cast<__nv_bfloat162*>(out + row * rs + col) =
          __floats2bfloat162_rn(d[i] * mul, d[i + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int ND>
__global__ void __launch_bounds__(DkvTile<ND>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  using T = DkvTile<ND>;
  constexpr int A = T::kAtoms, KS = T::kKSteps, BQ = T::kBQ, OWN = T::kOwn;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + T::kOwnBytes;
  unsigned char* Qs = Vs + T::kOwnBytes;          // kStages tiles
  unsigned char* Ds = Qs + T::kStages * T::kTileBytes;  // dO, kStages tiles
  float* Ls = reinterpret_cast<float*>(Ds + T::kStages * T::kTileBytes);  // lse * log2(e)
  float* Es = Ls + T::kStages * BQ;                                       // delta
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + T::kStages * BQ);
  uint64_t* empty = full + T::kStages;
  uint64_t* own = empty + T::kStages;

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int k0 = blockIdx.x * OWN;
  const int n_tiles = (p.S + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 32);  // every producer lane arrives once its stats are written
      mbar_init(&empty[s], T::kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= T::kConsumers) {  // the producer warp
    const int lane = threadIdx.x - T::kConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(own, 2 * T::kOwnBytes);
      load_rows<A, OWN>(Ks, &p.tk, own, k0, h, b);
      load_rows<A, OWN>(Vs, &p.tv, own, k0, h, b);
    }
    // Each lane carries rows lane + 32 * r of a tile's lse and delta; the
    // next tile's are read from global memory while this one's wait for a
    // free stage, so that their latency is off the ring's critical path. A
    // query past S gets lse = +inf (P = 0).
    const float* lse = p.lse + (int64_t)g * p.S;
    const float* delta = p.delta + (int64_t)g * p.S;
    constexpr int R = BQ / 32;
    float l[R], e[R];
    auto read_stats = [&](int i) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = i * BQ + lane + 32 * r;
        l[r] = row < p.S ? lse[row] * kLog2e : INFINITY;
        e[r] = row < p.S ? delta[row] : 0.f;
      }
    };
    read_stats(0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % T::kStages;
      mbar_wait(&empty[s], ((i / T::kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * T::kTileBytes);
        load_rows<A, BQ>(Qs + s * T::kTileBytes, &p.tq, &full[s], i * BQ, h, b);
        load_rows<A, BQ>(Ds + s * T::kTileBytes, &p.tdo, &full[s], i * BQ, h, b);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Ls[s * BQ + lane + 32 * r] = l[r];
        Es[s * BQ + lane + 32 * r] = e[r];
      }
      mbar_arrive(&full[s]);
      if (i + 1 < n_tiles) read_stats(i + 1);
    }
    return;
  }

  // consumer warpgroup wg owns keys k0 + 64 * wg + [0, 64); this thread's
  // accumulator columns are 8 * j + 2 * tq (+1), its rows 16 * warp + gr (+8)
  const int wg = threadIdx.x / 128, tq = threadIdx.x % 4;
  const uint32_t k_s = smem_u32(Ks) + wg * 64 * 128, v_s = smem_u32(Vs) + wg * 64 * 128;
  float dk[ND / 2], dv[ND / 2], st[BQ / 2], dpt[BQ / 2];
  zero<ND / 2>(dk);
  zero<ND / 2>(dv);
  zero<BQ / 2>(st);
  zero<BQ / 2>(dpt);
  uint32_t pa[BQ / 16][4], pb[BQ / 16][4];  // P^T and dS^T as A operands
  mbar_wait(own, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % T::kStages;
    mbar_wait(&full[s], (i / T::kStages) & 1);
    const uint32_t q_s = smem_u32(Qs + s * T::kTileBytes);
    const uint32_t d_s = smem_u32(Ds + s * T::kTileBytes);
    const float* Lt = Ls + s * BQ;
    const float* Et = Es + s * BQ;

    // S^T = K Q^T and dP^T = V dO^T (64 keys x BQ queries), two groups, while
    // the previous tile's dV and dK products may still run
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<BQ>::run(st, desc_k_major<OWN>(k_s, kk), desc_k_major<BQ>(q_s, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<BQ>::run(dpt, desc_k_major<OWN>(v_s, kk), desc_k_major<BQ>(d_s, kk), kk > 0);
    wgmma_commit();

    // P^T = exp(S^T * scale - lse[query]), in base 2, while dP^T runs
    wgmma_wait<1>();  // the previous dV and dK and this S^T are done
    fence_regs<BQ / 2>(st);
    if (i > 0) mbar_arrive(&empty[(i - 1) % T::kStages]);  // its Q, dO and stats are free
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * tq);
      st[4 * j + 0] = exp2_ftz(st[4 * j + 0] * p.scale_log2 - l.x);
      st[4 * j + 1] = exp2_ftz(st[4 * j + 1] * p.scale_log2 - l.y);
      st[4 * j + 2] = exp2_ftz(st[4 * j + 2] * p.scale_log2 - l.x);
      st[4 * j + 3] = exp2_ftz(st[4 * j + 3] * p.scale_log2 - l.y);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(st, kk, pa[kk]);

    // dV += P^T dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<ND, 1>::run(dv, pa[kk], desc_mn_major<BQ>(d_s, kk), 1);
    wgmma_commit();

    // dS^T = P^T * (dP^T - delta[query]) while dV runs
    wgmma_wait<1>();
    fence_regs<BQ / 2>(dpt);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 e = *reinterpret_cast<const float2*>(Et + 8 * j + 2 * tq);
      dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - e.x);
      dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - e.y);
      dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - e.x);
      dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - e.y);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(dpt, kk, pb[kk]);

    // dK += dS^T Q (times scale at the store); dV and dK are waited for in
    // the next tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<ND, 1>::run(dk, pb[kk], desc_mn_major<BQ>(q_s, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<ND / 2>(dv);
  fence_regs<ND / 2>(dk);

  const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
  store_acc<ND / 2>(p.dk + off, dk, k0 + 64 * wg, p.scale, p);
  store_acc<ND / 2>(p.dv + off, dv, k0 + 64 * wg, 1.f, p);
}

template <int ND>
__global__ void __launch_bounds__(DqTile<ND>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using T = DqTile<ND>;
  constexpr int A = T::kAtoms, KS = T::kKSteps, BK = T::kBK, OWN = T::kOwn;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ds = Qs + T::kOwnBytes;             // dO
  unsigned char* Ks = Ds + T::kOwnBytes;             // kStages tiles
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
      mbar_init(&empty[s], T::kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= T::kConsumers) {  // the producer warp: one thread issues every load
    if (threadIdx.x == T::kConsumers) {
      mbar_arrive_expect_tx(own, 2 * T::kOwnBytes);
      load_rows<A, OWN>(Qs, &p.tq, own, q0, h, b);
      load_rows<A, OWN>(Ds, &p.tdo, own, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % T::kStages;
        mbar_wait(&empty[s], ((j / T::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);
        load_rows<A, BK>(Ks + s * T::kTileBytes, &p.tk, &full[s], j * BK, h, b);
        load_rows<A, BK>(Vs + s * T::kTileBytes, &p.tv, &full[s], j * BK, h, b);
      }
    }
    return;
  }

  // consumer warpgroup wg owns queries q0 + 64 * wg + [0, 64); this thread
  // holds rows 16 * warp + gr (+8) of them
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * (threadIdx.x / 32 % 4) + gr + 8 * r;
    lse2[r] = row < p.S ? p.lse[(int64_t)g * p.S + row] * kLog2e : 0.f;
    dl[r] = row < p.S ? p.delta[(int64_t)g * p.S + row] : 0.f;
  }
  const uint32_t q_s = smem_u32(Qs) + wg * 64 * 128, d_s = smem_u32(Ds) + wg * 64 * 128;
  float dq[ND / 2], s[BK / 2], dp[BK / 2];
  zero<ND / 2>(dq);
  zero<BK / 2>(s);
  zero<BK / 2>(dp);
  uint32_t pa[BK / 16][4];
  mbar_wait(own, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % T::kStages;
    mbar_wait(&full[st], (j / T::kStages) & 1);
    const uint32_t k_s = smem_u32(Ks + st * T::kTileBytes);
    const uint32_t v_s = smem_u32(Vs + st * T::kTileBytes);
    const int key0 = j * BK;

    // S = Q K^T and dP = dO V^T (64 queries x BK keys), two groups, while the
    // previous tile's dQ product may still run
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<BK>::run(s, desc_k_major<OWN>(q_s, kk), desc_k_major<BK>(k_s, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<BK>::run(dp, desc_k_major<OWN>(d_s, kk), desc_k_major<BK>(v_s, kk), kk > 0);
    wgmma_commit();

    // P = exp(S * scale - lse), in base 2, and 0 past S, while dP runs
    wgmma_wait<1>();  // the previous dQ and this S are done
    fence_regs<BK / 2>(s);
    if (j > 0) mbar_arrive(&empty[(j - 1) % T::kStages]);  // its K and V are free
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = exp2_ftz(s[i] * p.scale_log2 - lse2[(i >> 1) & 1]);
    if (key0 + BK > p.S) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (key0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= p.S) s[i] = 0.f;
    }
    // dS = P * (dP - delta), rounded to bf16 as the next A operand
    wgmma_wait<0>();
    fence_regs<BK / 2>(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(dp, kk, pa[kk]);

    // dQ += dS K (times scale at the store), K read MN-major; waited for in
    // the next tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<ND, 1>::run(dq, pa[kk], desc_mn_major<BK>(k_s, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<ND / 2>(dq);

  const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
  store_acc<ND / 2>(p.dq + off, dq, q0 + 64 * wg, p.scale, p);
}


// -- D > 160: mma.sync ---------------------------------------------------------

struct WideBwdParams {
  const __nv_bfloat16* in[4];   // q, k, v, dO: (B, S, H, D) bf16, D unit-stride
  int64_t sb[4], ss[4], sh[4];  // their element strides: batch, seq, head
  const float* lse;             // (B*H, S) f32, contiguous
  const float* delta;           // (B*H, S) f32, contiguous
  __nv_bfloat16* dq;            // (B, S, H, D) bf16, contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, H, D;
  float scale, scale_log2;
};

namespace wide {
constexpr int kDP = kMaxHeadDim;               // D zero-padded to 512 in shared memory
constexpr int kRows = 32;                      // owned rows a block, and rows a looped tile
constexpr int kQuarters = 4;                   // warps a row slice, one for each quarter of D
constexpr int kThreads = 32 * (kRows / 16) * kQuarters;  // 256
constexpr int kRow = kDP + 8;                  // bf16 a tile row; 16 bytes of pad
constexpr int kCols = kDP / kQuarters;         // 128 gradient columns a warp
constexpr int kNT = kCols / 8;                 // its 8-column accumulator tiles
constexpr int kPRow = kRows + 8;               // bf16 a row of a 16 x 32 P or dS block
constexpr int kTile = kRows * kRow;            // elements of a tile
constexpr int kBlock = 16 * kPRow;             // elements of a slice's P or dS block
// two owned tiles, two stages of two looped tiles; P and dS blocks of both slices
constexpr size_t kSmem = (size_t)(6 * kTile + 4 * kBlock) * sizeof(__nv_bfloat16);
}  // namespace wide

// Rows [row0, row0 + 32) of tensor t's (batch, head) slice -> a 32 x 512 smem
// tile. A row past S is read as row S - 1 (the kernels mask it); columns past
// D are zero-filled.
__device__ __forceinline__ void load_wide(__nv_bfloat16* dst, const WideBwdParams& p, int t,
                                          int b, int h, int row0) {
  constexpr int chunks = wide::kDP / 8;
  const __nv_bfloat16* src = p.in[t] + b * p.sb[t] + h * p.sh[t];
  for (int i = threadIdx.x; i < wide::kRows * chunks; i += wide::kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool valid = c < p.D;
    const __nv_bfloat16* g = valid ? src + (int64_t)min(row0 + r, p.S - 1) * p.ss[t] + c : src;
    flash::cp_async16(flash::smem_u32(dst + r * wide::kRow + c), g, valid);
  }
}

// s = X[x0, x0 + 16) . Y[y0, y0 + 8)^T and dp = U[x0, x0 + 16) . W[y0, y0 + 8)^T
// (16 x 8 f32 each) over the first kt k-steps of D (kt even), from 512-wide
// smem tiles
__device__ __forceinline__ void score_blocks(float* s, const __nv_bfloat16* X,
                                             const __nv_bfloat16* Y, float* dp,
                                             const __nv_bfloat16* U, const __nv_bfloat16* W,
                                             int x0, int y0, int kt) {
  const int lane = threadIdx.x % 32;
  const int a_off = (x0 + lane % 16) * wide::kRow + (lane / 16) * 8;
  const int b_off = (y0 + lane % 8) * wide::kRow + (lane / 8) * 8;  // two k-steps a load
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = dp[e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kt; kk += 2) {
    uint32_t by[4], bw[4], a[4];
    flash::ldmatrix_x4(flash::smem_u32(Y + b_off + kk * 16), by);
    flash::ldmatrix_x4(flash::smem_u32(W + b_off + kk * 16), bw);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      flash::ldmatrix_x4(flash::smem_u32(X + a_off + (kk + u) * 16), a);
      flash::mma_bf16(s, a, by[2 * u], by[2 * u + 1]);
      flash::ldmatrix_x4(flash::smem_u32(U + a_off + (kk + u) * 16), a);
      flash::mma_bf16(dp, a, bw[2 * u], bw[2 * u + 1]);
    }
  }
}

// A warp's 16 x 8 f32 block (rows gr, gr + 8; columns 2 * tq, + 1) rounded to
// bf16 into columns [c, c + 8) of a 16 x 32 smem block
__device__ __forceinline__ void put_block(__nv_bfloat16* blk, const float* x, int c) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  *reinterpret_cast<uint32_t*>(blk + gr * wide::kPRow + c + 2 * tq) = flash::pack_bf16(x[0], x[1]);
  *reinterpret_cast<uint32_t*>(blk + (gr + 8) * wide::kPRow + c + 2 * tq) =
      flash::pack_bf16(x[2], x[3]);
}

// acc (16 x 128 f32 from column c0) += A (a 16 x 32 smem block) . Y (a 32-row
// tile, read transposed), over the first nt 8-column tiles (nt even)
__device__ __forceinline__ void grad_product(float (*acc)[4], const __nv_bfloat16* A,
                                             const __nv_bfloat16* Y, int c0, int nt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < wide::kRows / 16; ++kk) {
    uint32_t a[4];
    flash::ldmatrix_x4(flash::smem_u32(A + (lane % 16) * wide::kPRow + (lane / 16) * 8 + kk * 16),
                       a);
#pragma unroll
    for (int n = 0; n < wide::kNT; n += 2) {
      if (n < nt) {
        uint32_t b[4];
        flash::ldmatrix_x4_trans(
            flash::smem_u32(Y + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * wide::kRow + c0 +
                            n * 8 + (lane / 16) * 8),
            b);
        flash::mma_bf16(acc[n], a, b[0], b[1]);
        flash::mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// Rows row0 + gr (+ 8) of a warp's 16 x 128 accumulator from column c0, times
// mul, as bf16 into a contiguous (B, S, H, D) slice; rows past S and columns
// past D are dropped
__device__ __forceinline__ void store_wide(__nv_bfloat16* out, const float (*acc)[4], int row0,
                                           int c0, float mul, const WideBwdParams& p) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int64_t rs = (int64_t)p.H * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    if (row >= p.S) continue;
#pragma unroll
    for (int n = 0; n < wide::kNT; ++n) {
      const int col = c0 + 8 * n + 2 * tq;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(out + row * rs + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

// The warp's place: row slice (16 owned rows), quarter of D (its gradient
// columns and its 8 rows of each looped tile), and the k-steps and column
// tiles that D needs
struct WideWarp {
  int slice, quarter, c0, nt, kt;
  __device__ explicit WideWarp(int D) {
    const int warp = threadIdx.x / 32;
    slice = warp % 2;
    quarter = warp / 2;
    c0 = quarter * wide::kCols;
    nt = min(wide::kNT, max(0, (D - c0 + 15) / 16 * 2));
    kt = (D + 31) / 32 * 2;
  }
};

__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ WideBwdParams p) {
  using namespace wide;
  extern __shared__ __align__(128) unsigned char wide_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(wide_smem);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qs = Vs + kTile;      // two stages
  __nv_bfloat16* Ds = Qs + 2 * kTile;  // dO, two stages
  __nv_bfloat16* Pt = Ds + 2 * kTile;  // P^T blocks of both slices
  __nv_bfloat16* St = Pt + 2 * kBlock; // dS^T blocks

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int k0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, tq = lane % 4;
  const WideWarp w(p.D);
  const int n_tiles = (p.S + kRows - 1) / kRows;
  const float* lse = p.lse + (int64_t)g * p.S;
  const float* delta = p.delta + (int64_t)g * p.S;

  load_wide(Ks, p, 1, b, h, k0);
  load_wide(Vs, p, 2, b, h, k0);
  load_wide(Qs, p, 0, b, h, 0);
  load_wide(Ds, p, 3, b, h, 0);
  flash::cp_async_commit();

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  __nv_bfloat16* pt = Pt + w.slice * kBlock;
  __nv_bfloat16* dst = St + w.slice * kBlock;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {  // prefetch the next Q and dO tiles into the other stage
      load_wide(Qs + (stage ^ 1) * kTile, p, 0, b, h, (i + 1) * kRows);
      load_wide(Ds + (stage ^ 1) * kTile, p, 3, b, h, (i + 1) * kRows);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + stage * kTile;
    const __nv_bfloat16* Dt = Ds + stage * kTile;

    // this warp's queries: 8 * quarter + 2 * tq (+1) of the tile; a query
    // past S gets lse = +inf and delta = 0, so P = dS = 0
    const int qc = 8 * w.quarter;
    float l[2], e[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = i * kRows + qc + 2 * tq + u, qr = min(q, p.S - 1);
      l[u] = q < p.S ? lse[qr] * kLog2e : INFINITY;
      e[u] = q < p.S ? delta[qr] : 0.f;
    }
    // S^T = K Q^T and dP^T = V dO^T on (16 keys of the slice) x (8 queries)
    float s[4], dp[4];
    score_blocks(s, Ks, Qt, dp, Vs, Dt, 16 * w.slice, qc, w.kt);
    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      s[x] = exp2f(s[x] * p.scale_log2 - l[x & 1]);
      dp[x] = s[x] * (dp[x] - e[x & 1]);
    }
    put_block(pt, s, qc);
    put_block(dst, dp, qc);
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q on this warp's columns
    grad_product(dv, pt, Dt, w.c0, w.nt);
    grad_product(dk, dst, Qt, w.c0, w.nt);
    __syncthreads();  // the stage and the blocks are free
  }

  const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
  store_wide(p.dk + off, dk, k0 + 16 * w.slice, w.c0, p.scale, p);
  store_wide(p.dv + off, dv, k0 + 16 * w.slice, w.c0, 1.f, p);
}

__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ WideBwdParams p) {
  using namespace wide;
  extern __shared__ __align__(128) unsigned char wide_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(wide_smem);
  __nv_bfloat16* Ds = Qs + kTile;      // dO
  __nv_bfloat16* Ks = Ds + kTile;      // two stages
  __nv_bfloat16* Vs = Ks + 2 * kTile;  // two stages
  __nv_bfloat16* Sb = Vs + 2 * kTile;  // dS blocks of both slices

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const WideWarp w(p.D);
  const int n_tiles = (p.S + kRows - 1) / kRows;

  load_wide(Qs, p, 0, b, h, q0);
  load_wide(Ds, p, 3, b, h, q0);
  load_wide(Ks, p, 1, b, h, 0);
  load_wide(Vs, p, 2, b, h, 0);
  flash::cp_async_commit();

  // this thread's queries q0 + 16 * slice + gr (+8); one past S is not stored
  float l[2], e[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + 16 * w.slice + gr + 8 * r, p.S - 1);
    l[r] = p.lse[(int64_t)g * p.S + row] * kLog2e;
    e[r] = p.delta[(int64_t)g * p.S + row];
  }
  float dq[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dq[n][x] = 0.f;
  __nv_bfloat16* dsb = Sb + w.slice * kBlock;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K and V tiles into the other stage
      load_wide(Ks + (stage ^ 1) * kTile, p, 1, b, h, (j + 1) * kRows);
      load_wide(Vs + (stage ^ 1) * kTile, p, 2, b, h, (j + 1) * kRows);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * kTile;
    const __nv_bfloat16* Vt = Vs + stage * kTile;

    // S = Q K^T and dP = dO V^T on (16 queries of the slice) x (8 keys)
    const int kc = 8 * w.quarter;
    float s[4], dp[4];
    score_blocks(s, Qs, Kt, dp, Ds, Vt, 16 * w.slice, kc, w.kt);
    // P = exp2(S * scale * log2(e) - lse * log2(e)), 0 for a key past S;
    // dS = P (dP - delta)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int key = j * kRows + kc + 2 * tq + (x & 1);
      const float pv = key < p.S ? exp2f(s[x] * p.scale_log2 - l[x >> 1]) : 0.f;
      dp[x] = pv * (dp[x] - e[x >> 1]);
    }
    put_block(dsb, dp, kc);
    __syncthreads();

    // dQ += dS K on this warp's columns (times scale at the store)
    grad_product(dq, dsb, Kt, w.c0, w.nt);
    __syncthreads();  // the stage and the blocks are free
  }

  const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
  store_wide(p.dq + off, dq, q0 + 16 * w.slice, w.c0, p.scale, p);
}

// -- host side ----------------------------------------------------------------

struct Inputs {
  const void* ptr[4];        // q, k, v, dout
  const long long* strides;  // 12 element strides: batch, seq, head of q, k, v, dout
  int B;
};

// A (D, H, S, B) map of input t with boxes of 64 columns x `rows` rows
bool encode(CUtensorMap* map, const Inputs& in, int t, const BwdParams& p, int rows) {
  return hopper::encode_bshd(map, in.ptr[t], in.strides + 3 * t, in.B, p.S, p.H, p.D, rows);
}

// q and dO in boxes of qd_rows rows, k and v in boxes of kv_rows rows
bool encode_maps(BwdParams* p, const Inputs& in, int qd_rows, int kv_rows) {
  return encode(&p->tq, in, 0, *p, qd_rows) && encode(&p->tk, in, 1, *p, kv_rows) &&
         encode(&p->tv, in, 2, *p, kv_rows) && encode(&p->tdo, in, 3, *p, qd_rows);
}

template <typename Tile, typename Kernel>
cudaError_t launch(Kernel kernel, const BwdParams& p, int batch_heads, cudaStream_t stream,
                   bool* attr_set) {
  const size_t smem = Tile::kSmem;
  if (!*attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  dim3 grid((p.S + Tile::kOwn - 1) / Tile::kOwn, batch_heads);
  kernel<<<grid, Tile::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch_dkv(BwdParams* p, const Inputs& in, cudaStream_t stream) {
  static bool attr_set = false;
  using T = DkvTile<ND>;
  if (!encode_maps(p, in, T::kBQ, T::kOwn)) return cudaErrorInvalidValue;
  return launch<T>(flash_bwd_dkv_kernel<ND>, *p, in.B * p->H, stream, &attr_set);
}

template <int ND>
cudaError_t launch_dq(BwdParams* p, const Inputs& in, cudaStream_t stream) {
  static bool attr_set = false;
  using T = DqTile<ND>;
  if (!encode_maps(p, in, T::kOwn, T::kBK)) return cudaErrorInvalidValue;
  return launch<T>(flash_bwd_dq_kernel<ND>, *p, in.B * p->H, stream, &attr_set);
}

// The wide kernels (D > 160): strides and pointers straight from the caller
template <typename Kernel>
cudaError_t launch_wide(Kernel kernel, const BwdParams& bp, const Inputs& in,
                        cudaStream_t stream, bool* attr_set) {
  WideBwdParams p;
  for (int t = 0; t < 4; ++t) {
    p.in[t] = static_cast<const __nv_bfloat16*>(in.ptr[t]);
    p.sb[t] = in.strides[3 * t];
    p.ss[t] = in.strides[3 * t + 1];
    p.sh[t] = in.strides[3 * t + 2];
  }
  p.lse = bp.lse;
  p.delta = bp.delta;
  p.dq = bp.dq;
  p.dk = bp.dk;
  p.dv = bp.dv;
  p.S = bp.S;
  p.H = bp.H;
  p.D = bp.D;
  p.scale = bp.scale;
  p.scale_log2 = bp.scale_log2;
  if (!*attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)wide::kSmem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  dim3 grid((p.S + wide::kRows - 1) / wide::kRows, in.B * p.H);
  kernel<<<grid, wide::kThreads, wide::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Checks shared by both entries; fills p's scalars. Returns cudaSuccess or
// cudaErrorInvalidValue.
cudaError_t make_params(BwdParams* p, const Inputs& in, const void* lse, const void* delta,
                        int S, int H, int D) {
  if (in.B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > kMaxHeadDim ||
      in.B * H > 65535)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (in.strides[i] % 8 != 0) return cudaErrorInvalidValue;
  for (const void* ptr : in.ptr)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
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

// Dynamic shared memory of the instantiation that runs head dim D (dkv != 0:
// the dK/dV kernel, else dQ), in bytes; 0 for a D the kernels do not take.
extern "C" int agenda_flash_bwd_smem_bytes(int dkv, int D) {
  if (D <= 0 || D > kMaxHeadDim) return 0;
  if (D > kMaxWgmmaHeadDim) return (int)wide::kSmem;
  if (D <= 40) return (int)(dkv ? DkvTile<40>::kSmem : DqTile<40>::kSmem);
  if (D <= 80) return (int)(dkv ? DkvTile<80>::kSmem : DqTile<80>::kSmem);
  return (int)(dkv ? DkvTile<160>::kSmem : DqTile<160>::kSmem);
}

// q, k, v, dout: (B, S, H, D) bf16 with the given element strides (q, k, v,
// dout; batch, seq, head each; D unit-stride), 16-byte-aligned bases and
// strides that are multiples of 8; D a multiple of 8 up to 512 (above 160
// the mma.sync kernels); lse, delta:
// (B*H, S) f32 contiguous; dk, dv: contiguous (B, S, H, D) bf16. Returns a
// cudaError_t (0 on success).
extern "C" int agenda_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int S, int H, int D,
                                    const long long* strides, void* stream) {
  const Inputs in{{q, k, v, dout}, strides, B};
  BwdParams p;
  cudaError_t err = make_params(&p, in, lse, delta, S, H, D);
  if (err != cudaSuccess) return (int)err;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kMaxWgmmaHeadDim) {
    static bool attr_set = false;
    return (int)launch_wide(flash_bwd_dkv_wide_kernel, p, in, st, &attr_set);
  }
  if (D <= 40) return (int)launch_dkv<40>(&p, in, st);
  if (D <= 80) return (int)launch_dkv<80>(&p, in, st);
  return (int)launch_dkv<160>(&p, in, st);
}

// As agenda_flash_bwd_dkv; dq: contiguous (B, S, H, D) bf16.
extern "C" int agenda_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int S, int H, int D,
                                   const long long* strides, void* stream) {
  const Inputs in{{q, k, v, dout}, strides, B};
  BwdParams p;
  cudaError_t err = make_params(&p, in, lse, delta, S, H, D);
  if (err != cudaSuccess) return (int)err;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kMaxWgmmaHeadDim) {
    static bool attr_set = false;
    return (int)launch_wide(flash_bwd_dq_wide_kernel, p, in, st, &attr_set);
  }
  if (D <= 40) return (int)launch_dq<40>(&p, in, st);
  if (D <= 80) return (int)launch_dq<80>(&p, in, st);
  return (int)launch_dq<160>(&p, in, st);
}
