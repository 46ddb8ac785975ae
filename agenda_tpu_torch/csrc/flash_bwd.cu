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
// D > 160 (the VAE's single-head mid-block attention, D = 512), for any D up
// to 512 that is a multiple of 8. Neither a 64 x 512 f32 accumulator (dK and
// dV need two) nor 64-row tiles of 512 bf16 fit a warpgroup's registers or a
// block's shared memory as the kernels above hold them.
//
// dK/dV (flash_bwd_dkv_wide_wgmma_kernel), wgmma and TMA. Its bound is the
// tensor operations, four S^2 D products a head (0.0347 ms at the VAE step's
// (8, 1024, 1, 512)); the warp-level kernel it replaces reached 12% of that,
// held back by 16-row products fed warp by warp from shared memory and by
// tile copies under block-wide barriers. The accumulators of R owned keys
// take R x 4 KB at D = 512, so a block owns 32 keys and wgmma's 64 rows run
// over D, not over keys:
// - dV^T = dO^T P and dK^T = Q^T dS, one 64 x 32 f32 accumulator for each
//   64-column chunk of D (16 registers a thread; 8 chunks of one gradient a
//   warpgroup), A = dO^T or Q^T read MN-major (transposed) from the chunk's
//   box, B = P^T or dS^T (32 keys x 64 queries, bf16) from shared memory.
// - Two consumer warpgroups split the work by input, not by output: group 0
//   computes S = Q K^T (64 queries x 32 keys, SS over D), P, and dK; group 1
//   dP = dO V^T, dS = P (dP - delta) with P in f32, and dV. Each reads one
//   ring: group 0 Q's, group 1 dO's. P (f32 and P^T in bf16) and dS^T pass
//   between them in shared memory under named barriers (ready and free, both
//   ways).
// - Two producer warps, after the two consumer warpgroups, stream the query
//   tiles as 64-row x 64-column boxes by TMA, one ring of nine boxes for Q
//   and one for dO (full/empty mbarriers): a tile's S needs all of its
//   boxes, and each box is released as soon as its chunk's gradient product
//   is done, so the next tile's boxes load while this tile's products run.
//   K and V (32 KB each), both rings (144 KB), P^T, dS^T and P (16 KB) fill
//   225 KB: one block an SM. Boxes past D are zero-filled whole, so that
//   every D issues the same products.
// - Registers: a block of 9 to 12 warps gets at most 168 a thread (three
//   of its warps share one of the register file's four sub-partitions; a
//   cap of 200 at 320 threads is refused at launch, kernel_variants.py
//   bwd_wide_maxnreg). Group 1 writes dS before its dV product starts, so
//   that the 128 accumulator registers are not in flight with dP's 16.
//   ptxas still gives the kernel 156 with spills and serializes its wgmma
//   products (C7512), the likelier reason it reaches about a fifth of its
//   bound.
// - Each 32-key block reads all of its head's Q and dO from L2 (512 MB at
//   (8, 1024, 1, 512)). Clusters of two blocks that shared each box by TMA
//   multicast halved those reads and measured the same (PERF.md), so
//   the kernel has no cluster.
// - Ragged S: TMA zero-fills Q and dO rows past S, and such a query gets
//   lse = +inf and delta = 0 (P = dS = 0) without reading either: past the
//   last (batch, head)'s S they lie past the end of their buffers, and a NaN
//   read there would make 0 * P NaN. A key past S is not stored: its rows
//   belong to the next batch element, or lie past the end of dK and dV.
//
// dQ (flash_bwd_dq_wide_wgmma_kernel), wgmma and TMA, the dK/dV kernel's
// design with queries and keys swapped. Its bound is three S^2 D products a
// head (0.0261 ms at (8, 1024, 1, 512)). A block owns 32 queries and loops
// over tiles of 64 keys:
// - dQ^T = K^T dS^T, one 64 x 32 f32 accumulator for each 64-column chunk of
//   D (16 registers a thread), A = K^T read MN-major from the chunk's K box,
//   B = dS^T (32 queries x 64 keys, bf16) from shared memory. Group c owns
//   chunks 4 c to 4 c + 3: 64 accumulator registers, with S^T's or dP^T's 16
//   and eight lse or delta values beside them, well under the cap of 168.
// - Group 0 computes S^T = K Q^T (64 keys x 32 queries, SS over D) and P,
//   group 1 dP^T = V dO^T and dS^T = P^T (dP^T - delta) with P in f32; each
//   reads one ring (group 0 K's, group 1 V's) and the owned Q or dO. P and
//   dS^T pass between them in shared memory under named barriers (ready and
//   free, both ways); both groups then run their dQ chunks from K's ring.
// - Two producer warps stream the key tiles as 64-row x 64-column boxes by
//   TMA, each ring a tile and a box (nine boxes): a K box is freed once every
//   warp that reads it is done with it (group 0's S^T, and the dQ chunk's
//   group), a V box once dP^T is done. Q and dO (32 KB each), the rings (144
//   KB), dS^T and P (12 KB) fill 221 KB: one block an SM, 256 blocks at (8,
//   1024, 1, 512).
// - The accumulators are rounded to bf16 into the group's own owned tile
//   (Q's or dO's, each done with by then) and stored as 16-byte pieces of
//   whole query rows.
// - Ragged S and D: TMA zero-fills K and V rows past S and boxes past D, so
//   that every D issues the same products (no run-time branch around a
//   wgmma, which ptxas would read as divergence); a key past S gets P = 0. A
//   query past S gets lse = +inf and delta = 0 without reading either, as in
//   the dK/dV kernel, and is not stored: its rows belong to the next batch
//   element, or lie past the end of dq.
// - Each gradient element has one owner (a block, a group, a chunk): no
//   atomics, deterministic sums.
// - ptxas gives it 128 registers without spills and keeps its wgmma products
//   in flight (no C7512, unlike the two wide kernels above). What bounds it
//   is the K and V supply into each SM, 128 KB a key tile: a copy without
//   its dQ products takes nearly all of its time on the H100, and clusters
//   of two blocks that shared each box by TMA multicast halved the L2 reads
//   and gained nothing (kernel_variants.py, PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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


// -- D > 160, dK/dV: wgmma and TMA, the gradient products transposed ----------

using hopper::bar_arrive;
using hopper::bar_sync;
using hopper::fence_async_smem;
using hopper::tma_load_4d;
using hopper::wgmma_wait_upto;

// Block shape of the wide dK/dV kernel: 32 owned keys (K and V tiles of
// eight 64-column blocks, 32 KB each), query tiles of 64 rows streamed as
// 64-row x 64-column boxes through two rings (Q's and dO's) of kSlots boxes,
// P^T and dS^T as 32 x 64 bf16 tiles (keys x queries), and P as 64 x 32 f32.
struct DkvWide {
  static constexpr int kOwn = 32;
  static constexpr int kBQ = 64;
  static constexpr int kAtoms = kMaxHeadDim / 64;
  static constexpr int kSlots = 9;
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 64;  // + the two producer warps, last
  static constexpr uint32_t kOwnBytes = kOwn * kAtoms * 128;
  static constexpr uint32_t kBoxBytes = kBQ * 128;
  static constexpr uint32_t kPBytes = kOwn * 128;
  static constexpr uint32_t kXBytes = kBQ * kOwn * 4;
  // K, V; both rings; P^T, dS^T; P; barriers; alignment slack
  static constexpr size_t kSmem = 2 * kOwnBytes + 2 * kSlots * kBoxBytes + 2 * kPBytes + kXBytes +
                                  (4 * kSlots + 1) * sizeof(uint64_t) + 1024;
};

// named barriers of the wide kernels: between their two consumer warpgroups
// (256 threads), and kStaged + c within group c (128 threads)
enum WideBarrier { kPReady = 1, kDsReady = 2, kPFree = 3, kDsFree = 4, kStaged = 5 };

// bf16 x into a 32 x 64 tile at row n and column m (keys and queries in the
// dK/dV kernel, queries and keys in the dQ kernel), as a TMA load with
// 128-byte swizzle lays one out (hopper_common.cuh)
__device__ __forceinline__ void put_t(unsigned char* tile, int n, int m, float x) {
  *reinterpret_cast<__nv_bfloat16*>(tile + n * 128 + (((m >> 3) ^ (n & 7)) << 4) + (m & 7) * 2) =
      __float2bfloat16_rn(x);
}

// Chunk a of a group's transposed gradient (columns [64 a, 64 a + 64) of D x
// 32 keys from k0, f32), times mul, as bf16 into a contiguous (B, S, H, D)
// slice; keys past S and columns past D are dropped
__device__ __forceinline__ void store_chunk(__nv_bfloat16* out, const float* d, int col0, int k0,
                                            float mul, const BwdParams& p) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int64_t rs = (int64_t)p.H * p.D;
  col0 += 16 * (threadIdx.x / 32 % 4) + gr;
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const int col = col0 + 8 * ((x >> 1) & 1), key = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
    if (key < p.S && col < p.D) out[key * rs + col] = __float2bfloat16_rn(d[x] * mul);
  }
}

__global__ void __launch_bounds__(DkvWide::kThreads, 1)
    flash_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ BwdParams p) {
  using W = DkvWide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + W::kOwnBytes;
  unsigned char* Qr = Vs + W::kOwnBytes;              // Q's ring
  unsigned char* Dr = Qr + W::kSlots * W::kBoxBytes;  // dO's ring
  unsigned char* Pt = Dr + W::kSlots * W::kBoxBytes;  // P^T, bf16
  unsigned char* St = Pt + W::kPBytes;                // dS^T, bf16
  float* Xp = reinterpret_cast<float*>(St + W::kPBytes);  // P, f32, in fragment order
  uint64_t* full_q = reinterpret_cast<uint64_t*>(St + W::kPBytes + W::kXBytes);
  uint64_t* empty_q = full_q + W::kSlots;
  uint64_t* full_d = empty_q + W::kSlots;
  uint64_t* empty_d = full_d + W::kSlots;
  uint64_t* own = empty_d + W::kSlots;

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int k0 = blockIdx.x * W::kOwn;
  const int n_tiles = (p.S + W::kBQ - 1) / W::kBQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::kSlots; ++s) {
      mbar_init(&full_q[s], 1);
      mbar_init(&full_d[s], 1);
      mbar_init(&empty_q[s], 4);  // the four warps of the group that reads the ring
      mbar_init(&empty_d[s], 4);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = hopper::warpgroup_index();
  if (wg == 2) {  // the producer warps: the first feeds Q's ring (and loads K, V), the second dO's
    const int pw = (threadIdx.x - W::kConsumers) / 32;
    if (threadIdx.x % 32 == 0) {
      if (pw == 0) {
        mbar_arrive_expect_tx(own, 2 * W::kOwnBytes);
        load_rows<W::kAtoms, W::kOwn>(Ks, &p.tk, own, k0, h, b);
        load_rows<W::kAtoms, W::kOwn>(Vs, &p.tv, own, k0, h, b);
      }
      const CUtensorMap* map = pw == 0 ? &p.tq : &p.tdo;
      unsigned char* ring = pw == 0 ? Qr : Dr;
      uint64_t* full = pw == 0 ? full_q : full_d;
      uint64_t* empty = pw == 0 ? empty_q : empty_d;
      // box n: column block n % 8 of query tile n / 8, into slot n % kSlots
      for (int n = 0; n < n_tiles * W::kAtoms; ++n) {
        const int slot = n % W::kSlots;
        mbar_wait(&empty[slot], ((n / W::kSlots) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[slot], W::kBoxBytes);
        tma_load_4d(ring + slot * W::kBoxBytes, map, &full[slot], 64 * (n % W::kAtoms), h,
                    n / W::kAtoms * W::kBQ, b);
      }
    }
    __syncwarp();
  } else {
    // Group 0 reads Q's ring: S = Q K^T, P, dK^T += Q^T dS. Group 1 reads
    // dO's: dP = dO V^T, dS, dV^T += dO^T P. This thread holds queries 16 *
    // warp + gr (+8) of a tile in S or dP (s[4 j + e] at key 8 j + 2 tq + (e &
    // 1), row half e >> 1), and D columns 64 a + 16 * warp + gr (+8) of chunk a
    // of its group's gradient (acc[a][4 j + e] at the same keys).
    const int c = wg, t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
    unsigned char* ring = c == 0 ? Qr : Dr;
    uint64_t* full = c == 0 ? full_q : full_d;
    uint64_t* empty = c == 0 ? empty_q : empty_d;
    const uint32_t own_s = smem_u32(c == 0 ? Ks : Vs);   // B of S or dP
    const uint32_t grad_b = smem_u32(c == 0 ? St : Pt);  // B of dK^T or dV^T
    const float* stats = (c == 0 ? p.lse : p.delta) + (int64_t)g * p.S;
    // a query past S gets lse = +inf (P = 0) and delta = 0, read from nowhere
    auto stat = [&](int i, int r) {
      const int row = i * W::kBQ + 16 * (t / 32) + gr + 8 * r;
      return row < p.S ? (c == 0 ? stats[row] * kLog2e : stats[row]) : (c == 0 ? INFINITY : 0.f);
    };
    float acc[W::kAtoms][16], s[16];
#pragma unroll
    for (int a = 0; a < W::kAtoms; ++a) zero<16>(acc[a]);
    float st[2] = {stat(0, 0), stat(0, 1)};
    mbar_wait(own, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int n0 = i * W::kAtoms;
      // S = Q K^T or dP = dO V^T (64 queries x 32 keys) over D
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a) {
        const int slot = (n0 + a) % W::kSlots;
        mbar_wait(&full[slot], ((n0 + a) / W::kSlots) & 1);
        const uint32_t box = smem_u32(ring + slot * W::kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<32>::run(s, desc_k_major<W::kBQ>(box, kk),
                           desc_k_major<W::kOwn>(own_s, 4 * a + kk), a > 0 || kk > 0);
      }
      wgmma_commit();
      const float next[2] = {i + 1 < n_tiles ? stat(i + 1, 0) : 0.f,
                             i + 1 < n_tiles ? stat(i + 1, 1) : 0.f};
      wgmma_wait<0>();
      fence_regs<16>(s);

      if (c == 0) {
        // P = exp2(S * scale * log2(e) - lse * log2(e)) into P (f32) and P^T (bf16)
#pragma unroll
        for (int x = 0; x < 16; ++x) s[x] = exp2_ftz(s[x] * p.scale_log2 - st[(x >> 1) & 1]);
        if (i > 0) bar_sync(kPFree, W::kConsumers);  // group 1 is done with the last tile's
#pragma unroll
        for (int x = 0; x < 16; x += 4)
          *reinterpret_cast<float4*>(Xp + (x / 4 * 128 + t) * 4) =
              make_float4(s[x], s[x + 1], s[x + 2], s[x + 3]);
#pragma unroll
        for (int x = 0; x < 16; ++x)
          put_t(Pt, 8 * (x >> 2) + 2 * tq + (x & 1), 16 * (t / 32) + gr + 8 * ((x >> 1) & 1),
                s[x]);
        fence_async_smem();
        bar_arrive(kPReady, W::kConsumers);
        bar_sync(kDsReady, W::kConsumers);  // group 1's dS^T of this tile
      } else {
        // dS = P * (dP - delta) into dS^T (bf16)
        bar_sync(kPReady, W::kConsumers);
#pragma unroll
        for (int x = 0; x < 16; x += 4) {
          const float4 pf = *reinterpret_cast<const float4*>(Xp + (x / 4 * 128 + t) * 4);
          s[x] = pf.x * (s[x] - st[(x >> 1) & 1]);
          s[x + 1] = pf.y * (s[x + 1] - st[((x + 1) >> 1) & 1]);
          s[x + 2] = pf.z * (s[x + 2] - st[((x + 2) >> 1) & 1]);
          s[x + 3] = pf.w * (s[x + 3] - st[((x + 3) >> 1) & 1]);
        }
        if (i > 0) bar_sync(kDsFree, W::kConsumers);  // group 0 is done with the last tile's
#pragma unroll
        for (int x = 0; x < 16; ++x)
          put_t(St, 8 * (x >> 2) + 2 * tq + (x & 1), 16 * (t / 32) + gr + 8 * ((x >> 1) & 1),
                s[x]);
        fence_async_smem();
        bar_arrive(kDsReady, W::kConsumers);
      }

      // dK^T += Q^T dS (group 0) or dV^T += dO^T P (group 1): chunk a is 64
      // columns of D x 32 keys over the tile's 64 queries, A read MN-major
      // from the chunk's box; one wgmma group a chunk, and each box is freed
      // once its product is done
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a) {
        const uint32_t box = smem_u32(ring + (n0 + a) % W::kSlots * W::kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < W::kBQ / 16; ++kk)
          WgmmaSS<32, 1, 0>::run(acc[a], desc_mn_major<W::kBQ>(box, kk),
                                 desc_k_major<W::kOwn>(grad_b, kk), 1);
        wgmma_commit();
      }
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a) {
        wgmma_wait_upto(W::kAtoms - 1 - a);
        if (lane == 0) mbar_arrive(&empty[(n0 + a) % W::kSlots]);
      }
      // dS^T (group 0) or P and P^T (group 1) are free
      if (i + 1 < n_tiles) bar_arrive(c == 0 ? kDsFree : kPFree, W::kConsumers);
      st[0] = next[0];
      st[1] = next[1];
    }
#pragma unroll
    for (int a = 0; a < W::kAtoms; ++a) fence_regs<16>(acc[a]);

    const int64_t off = (int64_t)b * p.S * p.H * p.D + (int64_t)h * p.D;
    if (c == 0) {
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a) store_chunk(p.dk + off, acc[a], 64 * a, k0, p.scale, p);
    } else {
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a) store_chunk(p.dv + off, acc[a], 64 * a, k0, 1.f, p);
    }
  }
}

// -- D > 160, dQ: wgmma and TMA, the gradient product transposed -------------

// Block shape of the wide dQ kernel: 32 owned queries (Q and dO tiles of
// eight 64-column blocks, 32 KB each), key tiles of 64 rows streamed as
// 64-row x 64-column boxes through two rings (K's and V's) of a tile and a
// box each; dS^T as a 32 x 64 bf16 tile (queries x keys), P as 64 x 32 f32.
struct DqWide {
  static constexpr int kOwn = 32;
  static constexpr int kBK = 64;
  static constexpr int kAtoms = kMaxHeadDim / 64;
  static constexpr int kKSlots = kAtoms + 1;
  static constexpr int kVSlots = kAtoms + 1;
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 64;  // + the two producer warps, last
  static constexpr uint32_t kOwnBytes = kOwn * kAtoms * 128;
  static constexpr uint32_t kBoxBytes = kBK * 128;
  static constexpr uint32_t kDsBytes = kOwn * 128;
  static constexpr uint32_t kXBytes = kBK * kOwn * 4;
  static constexpr int kPitch = 4 * 64 + 8;  // bf16 a row of a group's staged dQ; 16 bytes of pad
  // Q, dO; both rings; dS^T; P; barriers; alignment slack
  static constexpr size_t kSmem = 2 * kOwnBytes + (kKSlots + kVSlots) * kBoxBytes + kDsBytes +
                                  kXBytes + (2 * (kKSlots + kVSlots) + 1) * sizeof(uint64_t) +
                                  1024;
  static_assert(kOwn * kPitch * 2 <= kOwnBytes, "a group's staged dQ fits its owned tile");
};

__global__ void __launch_bounds__(DqWide::kThreads, 1)
    flash_bwd_dq_wide_wgmma_kernel(const __grid_constant__ BwdParams p) {
  using W = DqWide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ds = Qs + W::kOwnBytes;               // dO
  unsigned char* Kr = Ds + W::kOwnBytes;               // K's ring
  unsigned char* Vr = Kr + W::kKSlots * W::kBoxBytes;  // V's ring
  unsigned char* St = Vr + W::kVSlots * W::kBoxBytes;  // dS^T, bf16
  float* Xp = reinterpret_cast<float*>(St + W::kDsBytes);  // P, f32, in fragment order
  uint64_t* full_k = reinterpret_cast<uint64_t*>(St + W::kDsBytes + W::kXBytes);
  uint64_t* empty_k = full_k + W::kKSlots;
  uint64_t* full_v = empty_k + W::kKSlots;
  uint64_t* empty_v = full_v + W::kVSlots;
  uint64_t* own = empty_v + W::kVSlots;

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int q0 = blockIdx.x * W::kOwn;
  const int n_tiles = (p.S + W::kBK - 1) / W::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::kKSlots; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], 8);  // every consumer warp: group 0 reads each K box, group 1 half
    }
    for (int s = 0; s < W::kVSlots; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], 4);  // the four warps of group 1
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = hopper::warpgroup_index();
  if (wg == 2) {  // the producer warps: the first feeds K's ring (and loads Q, dO), the second V's
    const int pw = (threadIdx.x - W::kConsumers) / 32;
    if (threadIdx.x % 32 == 0) {
      if (pw == 0) {
        mbar_arrive_expect_tx(own, 2 * W::kOwnBytes);
        load_rows<W::kAtoms, W::kOwn>(Qs, &p.tq, own, q0, h, b);
        load_rows<W::kAtoms, W::kOwn>(Ds, &p.tdo, own, q0, h, b);
      }
      const CUtensorMap* map = pw == 0 ? &p.tk : &p.tv;
      unsigned char* ring = pw == 0 ? Kr : Vr;
      uint64_t* full = pw == 0 ? full_k : full_v;
      uint64_t* empty = pw == 0 ? empty_k : empty_v;
      const int slots = pw == 0 ? W::kKSlots : W::kVSlots;
      // box n: column block n % 8 of key tile n / 8, into slot n % slots
      for (int n = 0; n < n_tiles * W::kAtoms; ++n) {
        const int slot = n % slots;
        mbar_wait(&empty[slot], ((n / slots) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[slot], W::kBoxBytes);
        tma_load_4d(ring + slot * W::kBoxBytes, map, &full[slot], 64 * (n % W::kAtoms), h,
                    n / W::kAtoms * W::kBK, b);
      }
    }
    __syncwarp();
  } else {
    // Group 0 reads K's ring: S^T = K Q^T and P. Group 1 reads V's: dP^T = V
    // dO^T and dS. Both then take dQ^T += K^T dS^T over the tile's keys,
    // group c D's 64-column chunks 4 c to 4 c + 3, A read from K's ring. This
    // thread holds keys 16 * warp + gr (+8) of a tile in S^T or dP^T (s[4 j +
    // e] at owned query 8 j + 2 tq + (e & 1), key half e >> 1), and D columns
    // 64 (4 c + a) + 16 * warp + gr (+8) of chunk a (acc[a][4 j + e] at the
    // same queries).
    const int c = wg, t = threadIdx.x % 128, w = t / 32;
    const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
    unsigned char* ring = c == 0 ? Kr : Vr;
    uint64_t* full = c == 0 ? full_k : full_v;
    const int slots = c == 0 ? W::kKSlots : W::kVSlots;
    const uint32_t own_s = smem_u32(c == 0 ? Qs : Ds);  // B of S^T or dP^T
    const uint32_t ds_s = smem_u32(St);                 // B of dQ^T
    // lse (group 0) or delta (group 1) of this thread's eight queries, read
    // once; a query past S gets lse = +inf (P = 0) and delta = 0, read from
    // nowhere (past the last (batch, head)'s S they lie past the buffers' end)
    const float* stats = (c == 0 ? p.lse : p.delta) + (int64_t)g * p.S;
    float st[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int q = q0 + 8 * (x >> 1) + 2 * tq + (x & 1);
      st[x] = q < p.S ? (c == 0 ? stats[q] * kLog2e : stats[q]) : (c == 0 ? INFINITY : 0.f);
    }
    float acc[4][16], s[16];
#pragma unroll
    for (int a = 0; a < 4; ++a) zero<16>(acc[a]);
    mbar_wait(own, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int n0 = j * W::kAtoms;
      // S^T = K Q^T or dP^T = V dO^T (64 keys x 32 queries) over D
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a) {
        const int slot = (n0 + a) % slots;
        mbar_wait(&full[slot], ((n0 + a) / slots) & 1);
        const uint32_t box = smem_u32(ring + slot * W::kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<32>::run(s, desc_k_major<W::kBK>(box, kk),
                           desc_k_major<W::kOwn>(own_s, 4 * a + kk), a > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(s);

      if (c == 0) {
        // the K boxes of group 1's chunks are done with here
        if (lane == 0) {
#pragma unroll
          for (int a = 4; a < W::kAtoms; ++a) mbar_arrive(&empty_k[(n0 + a) % W::kKSlots]);
        }
        // P = exp2(S * scale * log2(e) - lse * log2(e)), 0 for a key past S
#pragma unroll
        for (int x = 0; x < 16; ++x)
          s[x] = exp2_ftz(s[x] * p.scale_log2 - st[2 * (x >> 2) + (x & 1)]);
        if ((j + 1) * W::kBK > p.S) {  // the last tile, ragged
#pragma unroll
          for (int x = 0; x < 16; ++x)
            if (j * W::kBK + 16 * w + gr + 8 * ((x >> 1) & 1) >= p.S) s[x] = 0.f;
        }
        if (j > 0) bar_sync(kPFree, W::kConsumers);  // group 1 has read the last tile's
#pragma unroll
        for (int x = 0; x < 16; x += 4)
          *reinterpret_cast<float4*>(Xp + (x / 4 * 128 + t) * 4) =
              make_float4(s[x], s[x + 1], s[x + 2], s[x + 3]);
        bar_arrive(kPReady, W::kConsumers);
        bar_sync(kDsReady, W::kConsumers);  // group 1's dS^T of this tile
      } else {
        if (lane == 0) {  // this tile's V boxes are done with
#pragma unroll
          for (int a = 0; a < W::kAtoms; ++a) mbar_arrive(&empty_v[(n0 + a) % W::kVSlots]);
        }
        // dS = P * (dP - delta) into dS^T (bf16)
        bar_sync(kPReady, W::kConsumers);
#pragma unroll
        for (int x = 0; x < 16; x += 4) {
          const float4 pf = *reinterpret_cast<const float4*>(Xp + (x / 4 * 128 + t) * 4);
          s[x] = pf.x * (s[x] - st[2 * (x >> 2)]);
          s[x + 1] = pf.y * (s[x + 1] - st[2 * (x >> 2) + 1]);
          s[x + 2] = pf.z * (s[x + 2] - st[2 * (x >> 2)]);
          s[x + 3] = pf.w * (s[x + 3] - st[2 * (x >> 2) + 1]);
        }
        if (j + 1 < n_tiles) bar_arrive(kPFree, W::kConsumers);
        if (j > 0) bar_sync(kDsFree, W::kConsumers);  // both groups' last products are done
#pragma unroll
        for (int x = 0; x < 16; ++x)
          put_t(St, 8 * (x >> 2) + 2 * tq + (x & 1), 16 * w + gr + 8 * ((x >> 1) & 1), s[x]);
        fence_async_smem();
        bar_arrive(kDsReady, W::kConsumers);
        // this tile's K boxes: waited for so that this warp's arrivals count
        // in their phase; those of group 0's chunks are not read here
#pragma unroll
        for (int a = 0; a < W::kAtoms; ++a)
          mbar_wait(&full_k[(n0 + a) % W::kKSlots], ((n0 + a) / W::kKSlots) & 1);
        if (lane == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a) mbar_arrive(&empty_k[(n0 + a) % W::kKSlots]);
        }
      }

      // dQ^T += K^T dS^T: chunk a is 64 columns of D x 32 queries over the
      // tile's 64 keys, A read MN-major from the chunk's K box; one wgmma
      // group a chunk, and each box is freed once its product is done
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint32_t box = smem_u32(Kr + (n0 + 4 * c + a) % W::kKSlots * W::kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < W::kBK / 16; ++kk)
          WgmmaSS<32, 1, 0>::run(acc[a], desc_mn_major<W::kBK>(box, kk),
                                 desc_k_major<W::kOwn>(ds_s, kk), 1);
        wgmma_commit();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        wgmma_wait_upto(3 - a);
        if (lane == 0) mbar_arrive(&empty_k[(n0 + 4 * c + a) % W::kKSlots]);
      }
      if (c == 0 && j + 1 < n_tiles) bar_arrive(kDsFree, W::kConsumers);  // dS^T is free
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) fence_regs<16>(acc[a]);

    // dQ times scale, rounded to bf16 and staged in shared memory (group 0
    // in Q's tile, group 1 in dO's: each is done with its own), then stored
    // as 16-byte pieces of the owned rows. A query past S is not stored (its
    // rows belong to the next batch element, or lie past the end of dq), nor
    // a column past D.
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(c == 0 ? Qs : Ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < 16; ++x)
        stage[(8 * (x >> 2) + 2 * tq + (x & 1)) * W::kPitch + 64 * a + 16 * w + gr +
              8 * ((x >> 1) & 1)] = __float2bfloat16_rn(acc[a][x] * p.scale);
    bar_sync(kStaged + c, 128);
    const int64_t rs = (int64_t)p.H * p.D;
    __nv_bfloat16* out = p.dq + (int64_t)b * p.S * rs + (int64_t)h * p.D;
    for (int i = t; i < W::kOwn * 32; i += 128) {
      const int row = i / 32, piece = i % 32, q = q0 + row, col = 256 * c + 8 * piece;
      if (q < p.S && col < p.D)
        *reinterpret_cast<uint4*>(out + q * rs + col) =
            *reinterpret_cast<const uint4*>(stage + row * W::kPitch + 8 * piece);
    }
  }
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

// The wide dK/dV: q and dO in boxes of 64 rows, k and v in boxes of 32; one
// block a 32-key tile of a (batch, head)
cudaError_t launch_dkv_wide(BwdParams* p, const Inputs& in, cudaStream_t stream) {
  static bool attr_set = false;
  using T = DkvWide;
  if (!encode_maps(p, in, T::kBQ, T::kOwn)) return cudaErrorInvalidValue;
  return launch<T>(flash_bwd_dkv_wide_wgmma_kernel, *p, in.B * p->H, stream, &attr_set);
}

template <int ND>
cudaError_t launch_dq(BwdParams* p, const Inputs& in, cudaStream_t stream) {
  static bool attr_set = false;
  using T = DqTile<ND>;
  if (!encode_maps(p, in, T::kOwn, T::kBK)) return cudaErrorInvalidValue;
  return launch<T>(flash_bwd_dq_kernel<ND>, *p, in.B * p->H, stream, &attr_set);
}

// The wide dQ: q and dO in boxes of 32 rows, k and v in boxes of 64; one
// block a 32-query tile of a (batch, head)
cudaError_t launch_dq_wide(BwdParams* p, const Inputs& in, cudaStream_t stream) {
  static bool attr_set = false;
  using T = DqWide;
  if (!encode_maps(p, in, T::kOwn, T::kBK)) return cudaErrorInvalidValue;
  return launch<T>(flash_bwd_dq_wide_wgmma_kernel, *p, in.B * p->H, stream, &attr_set);
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
  if (D > kMaxWgmmaHeadDim) return (int)(dkv ? DkvWide::kSmem : DqWide::kSmem);
  if (D <= 40) return (int)(dkv ? DkvTile<40>::kSmem : DqTile<40>::kSmem);
  if (D <= 80) return (int)(dkv ? DkvTile<80>::kSmem : DqTile<80>::kSmem);
  return (int)(dkv ? DkvTile<160>::kSmem : DqTile<160>::kSmem);
}

// q, k, v, dout: (B, S, H, D) bf16 with the given element strides (q, k, v,
// dout; batch, seq, head each; D unit-stride), 16-byte-aligned bases and
// strides that are multiples of 8; D a multiple of 8 up to 512 (above 160
// the wide kernels); lse, delta:
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
  if (D > kMaxWgmmaHeadDim) return (int)launch_dkv_wide(&p, in, st);
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
  if (D > kMaxWgmmaHeadDim) return (int)launch_dq_wide(&p, in, st);
  if (D <= 40) return (int)launch_dq<40>(&p, in, st);
  if (D <= 80) return (int)launch_dq<80>(&p, in, st);
  return (int)launch_dq<160>(&p, in, st);
}
