// Flash attention's backward in full f32 for D <= 160, on the Hopper
// (sm_90a) tensor cores: the dK/dV and dQ that --mixed_precision no runs at
// the SD UNet's self-attention (D = 40 at S = 4096, 80 at 1024, 160 at 256
// and 64). Above D = 160 the f32 backward is flash_bwd_f32_wide.cu's three
// passes.
//
// Replaces the TPU kernels of agenda_tpu/kernels/flash.py on f32 operands,
// which they take as they take bf16 (their dispatch in
// agenda_tpu/kernels/attention.py:119-126 has no dtype test):
// _flash_bwd_dkv_kernel (flash.py:153, launched at flash.py:239) and
// _flash_bwd_dq_kernel (flash.py:192, launched at flash.py:265):
// P = exp(Q K^T scale - lse), dS = P (dO V^T - delta), dV = P^T dO,
// dK = scale dS^T Q, dQ = scale dS K, the gradients in the input dtype
// (flash.py:306-309).
//
// What bounds them on the H100: 7*B*H*S^2*D multiply-adds of f32-accurate
// products (dK/dV 4, dQ 3) and B*H*S^2 exponentials in each. The tensor
// cores take no f32 operand, so, as in flash_fwd_f32.cu, each f32 operand is
// three bf16 pieces, x = b0 + b1 + b2 (f32_pieces.cuh; the sum exact), and a
// product is the six piece products with i + j <= 2, smallest first: six
// bf16 passes at 989 TFLOP/s cost what three TF32 passes at 495 cost, the
// bound chip_smoke.py counts (f32_bound). At (4, 4096, 8, 40) that is
// 1.04 ms for dK/dV and 0.78 for dQ; the bytes (the twelve planes, lse,
// delta, the gradients) take a tenth of it.
//
// Design: flash_bwd.cu's one-pass layout on the pieces of the pre-pass
// flash_f32_split (flash_fwd_f32.cu) of q, k, v and dO, which TMA reads from
// a (D, H, S, 12 B) map of its twelve contiguous planes (128-byte swizzle,
// zero fill past S and past D). No scratch: at (4, 4096, 8, 40) the wide
// kernel's three passes would write and read back 6.4 GB of P and dS pieces.
// - The dK/dV kernel owns keys and loops over query tiles; the dQ kernel
//   owns queries and loops over key tiles. Both are bwd_f32_body<DKV, ND>:
//   the owned side X, Y (K and V, or Q and dO) stays in shared memory, three
//   pieces each; a producer warp streams the other side XS, YS (Q and dO, or
//   K and V) into a ring under full/empty mbarriers, with each query tile's
//   lse and delta in the dK/dV kernel.
// - A consumer warpgroup owns 64 rows. S = X XS^T and dP = Y YS^T (S^T and
//   dP^T in the dK/dV kernel) are six wgmma SS piece products each over D;
//   P = exp(S scale - lse) with expf and dS = P (dP - delta) are f32 in
//   registers, split into three bf16 pieces there (the RS form's A), and
//   feed the gradient products with the streamed operand read MN-major:
//   dV += P^T dO, dK += dS^T Q, or dQ += dS K, six wgmma RS piece products
//   each.
// - Each streamed tile's gradient products go into an accumulator that
//   starts from zero, which is then added to the f32 sum: the tensor cores'
//   accumulation does not round to nearest, and one accumulator over all of
//   S read 1.39-2.53x the limit in the f32 forward (flash_fwd_f32.cu). dK's
//   and dQ's scale multiplies the sums at the store.
// - Every group of wgmma products is waited for before its registers are
//   touched, as in flash_fwd_f32.cu, so that ptxas keeps the products in
//   flight (it serializes flash_bwd.cu's, which overlap the exponentials
//   with dP: C7515). The warpgroups of a block overlap each other instead.
// - Registers (a thread's f32 values; ptxas caps a block of 9 warps at 168,
//   of 5 at 255): the sums (ND / 2 each: dK and dV, or dQ), S and dP
//   (BS / 2 each), the pieces of P or dS (3 BS / 8 registers) and one
//   product's tile accumulator (ND / 2). dK/dV at ND = 40: 40 + 16 + 16 +
//   12 + 20, at most about 100 live at once, so two consumer warpgroups
//   with 32-query tiles; at ND = 80: 80 + 16 + 16 + 12 + 40, about 160, so
//   one warpgroup (the two sides' pieces, 96 KB owned and 48 KB a 32-row
//   stage, also leave no room for two). dQ at ND = 40: 20 + 32 + 32 + 24 +
//   20 with 64-key tiles, two warpgroups; at ND = 80 one, 32-key tiles.
//   ptxas keeps more live than that count: 168 and 229 registers a thread
//   in dK/dV, 167 and 168 in dQ (ND = 40, 80), at or near the caps, without
//   spills. At ND = 160 one warpgroup and 32-row tiles in one stage (the
//   owned 64 rows' pieces take 147 KB, a stage 74 KB); dK/dV's sums alone
//   take 160 registers, so its two tile products share one accumulator:
//   160 + 80 + 16 + 16 + 24, over the cap of 255, and ptxas spills (952
//   bytes stored a thread on the H100); dQ 222 registers, no spills. Even
//   so one pass beat the three wide passes at the SD step's D = 160 by
//   25-42%. The shared memory: 170-222 KB a block, one block an SM.
// - Ragged S: a query past S gets lse = +inf and delta = 0 in the dK/dV
//   kernel (P = dS = 0; TMA zero-fills its Q and dO rows), a key past S gets
//   P = 0 in the dQ kernel; rows past S are not stored.
// Each output element has one owner and a fixed order of summation: no
// atomics; two launches on the same inputs give bitwise-equal outputs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_pieces.cuh"
#include "hopper_common.cuh"

namespace {

using f32pieces::piece_a;
using f32pieces::piece_b;
using f32pieces::split3_pair;
using hopper::align1024;
using hopper::desc_k_major;
using hopper::desc_mn_major;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
using hopper::WgmmaRS;
using hopper::WgmmaSS;

constexpr int kMaxHeadDim = 160;                 // above it: flash_bwd_f32_wide.cu
constexpr int kQ = 0, kK = 1, kV = 2, kDO = 3;  // the operands' order in the planes

// Each streamed tile's gradient products start from zero in the tensor cores
// and are added to the f32 sums. (False, a broken copy of the card tests: the
// products accumulate in the tensor cores over all of S.)
constexpr bool kTileFromZero = true;
// The pieces of each operand that go into a product. (2, a broken copy of
// the card tests: b0 + b1 only, 16 bits an operand.)
constexpr int kPieces = 3;

// the piece products kept, and the first of them, which starts a sum from zero
__host__ __device__ constexpr bool kept(int pr) {
  return piece_a(pr) < kPieces && piece_b(pr) < kPieces;
}
constexpr int kFirst = kPieces == 3 ? 0 : kPieces == 2 ? 1 : 5;

struct Params {
  CUtensorMap own, str;  // the twelve planes as (D, H, S, 12 B) maps: boxes of kOwn, kBS rows
  const float* lse;      // (B*H, S) f32, contiguous
  const float* delta;    // (B*H, S) f32, contiguous
  float* out0;           // dK (the dK/dV kernel) or dQ: (B, S, H, D) f32, contiguous
  float* out1;           // dV (the dK/dV kernel)
  int B, S, H, D;
  float scale;  // 1 / sqrt(D)
};

// Block shape for an RS width ND (40, 80 or 160): kWGS consumer warpgroups of 64
// owned rows, streamed tiles of kBS rows in kStages stages; a piece tile is
// kAtoms blocks of 64 columns (128 bytes a row).
template <bool DKV, int ND>
struct Tile {
  static constexpr int kAtoms = (ND + 63) / 64;
  static constexpr int kKSteps = (ND + 15) / 16;
  static constexpr uint32_t kRowBytes = kAtoms * 128;
  static constexpr int kWGS = ND > 40 ? 1 : 2;
  static constexpr int kOwn = 64 * kWGS;
  static constexpr int kConsumers = 128 * kWGS;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kBS = DKV || ND > 40 ? 32 : 64;
  static constexpr int kStages = ND == 160 ? 1 : DKV && ND == 40 ? 3 : 2;
  static constexpr uint32_t kOwnPiece = kOwn * kRowBytes;  // one piece of an owned operand
  static constexpr uint32_t kStrPiece = kBS * kRowBytes;   // one piece of a streamed tile
  static constexpr int kStats = DKV ? 2 * kBS : 0;         // lse and delta of a stage's queries
  // X, Y; XS and YS per stage; the stats per stage; barriers; alignment slack
  static constexpr size_t kSmem = 6 * kOwnPiece + 6 * kStages * kStrPiece +
                                  kStages * kStats * sizeof(float) +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// the three pieces of operand t, rows [row0, row0 + ROWS) of head h, batch b,
// all ATOMS column blocks, into three tiles of ROWS rows
template <int ATOMS, int ROWS>
__device__ __forceinline__ void load_pieces(unsigned char* dst, const CUtensorMap* map,
                                            uint64_t* bar, int t, int row0, int h, int b,
                                            int B) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tma_load_4d(dst + (i * ATOMS + a) * ROWS * 128, map, bar, 64 * a, h, row0,
                  (3 * t + i) * B + b);
}

// the six piece products of a 64 x N tile over 16 KS rows of reduction, into
// d from zero: SS, A's pieces at a + i * a_piece and B's at b + j * b_piece,
// both K-major
template <int N, int OWN, int KS>
__device__ __forceinline__ void ss_product(float* d, uint32_t a, uint32_t a_piece, uint32_t b,
                                           uint32_t b_piece) {
#pragma unroll
  for (int pr = 0; pr < 6; ++pr) {
    if (!kept(pr)) continue;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<N>::run(d, desc_k_major<OWN>(a + piece_a(pr) * a_piece, kk),
                      desc_k_major<N>(b + piece_b(pr) * b_piece, kk), pr != kFirst || kk > 0);
  }
}

// the six piece products of one streamed tile's gradient product, A's
// pieces from registers, B's (BS rows of reduction) at b + j * b_piece read
// MN-major, into acc: from zero, or (the broken copy) on top of the earlier
// tiles' after the first
template <int ND, int BS>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t (&pa)[3][BS / 16][4],
                                           uint32_t b, uint32_t b_piece, bool first_tile) {
  wgmma_fence();
#pragma unroll
  for (int pr = 0; pr < 6; ++pr) {
    if (!kept(pr)) continue;
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk)
      WgmmaRS<ND, 1>::run(acc, pa[piece_a(pr)][kk],
                          desc_mn_major<BS>(b + piece_b(pr) * b_piece, kk),
                          pr != kFirst || kk > 0 || (!kTileFromZero && !first_tile));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<ND / 2>(acc);
}

// an accumulator's f32 values as the pieces of the RS form's A operands
template <int BS>
__device__ __forceinline__ void split_a(const float* d, uint32_t (&pa)[3][BS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t a3[3];
      split3_pair(d[8 * kk + 2 * c], d[8 * kk + 2 * c + 1], a3);
#pragma unroll
      for (int i = 0; i < 3; ++i) pa[i][kk][c] = a3[i];
    }
}

template <int N>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void add_to(float* sum, const float* acc) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] += acc[i];
}

// rows row0 and row0 + 8 of a 64 x ND f32 sum (this thread's), times mul, into
// a contiguous (B, S, H, D) tensor; rows past S and columns past D are dropped
template <int ND>
__device__ __forceinline__ void store_rows(float* out, const float* sum, int row0, int b, int h,
                                           float mul, const Params& p) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.S) continue;
    float* at = out + (((long long)b * p.S + row) * p.H + h) * p.D;
#pragma unroll
    for (int i = 2 * r; i < ND / 2; i += 4) {
      const int col = 8 * (i >> 2) + 2 * tq;
      if (col < p.D)
        *reinterpret_cast<float2*>(at + col) = make_float2(sum[i] * mul, sum[i + 1] * mul);
    }
  }
}

template <bool DKV, int ND>
__device__ __forceinline__ void bwd_f32_body(const Params& p) {
  using T = Tile<DKV, ND>;
  constexpr int KS = T::kKSteps, BS = T::kBS, OWN = T::kOwn, A = T::kAtoms, NS = T::kStages;
  // X, Y: the owned operands (the A of S and of dP); XS, YS: the streamed ones
  constexpr int X = DKV ? kK : kQ, Y = DKV ? kV : kDO, XS = DKV ? kQ : kK, YS = DKV ? kDO : kV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xo = align1024(smem_raw);       // three pieces
  unsigned char* Yo = Xo + 3 * T::kOwnPiece;     // three pieces
  unsigned char* ring = Yo + 3 * T::kOwnPiece;   // [stage]: XS's three pieces, then YS's
  float* stats = reinterpret_cast<float*>(ring + NS * 6 * T::kStrPiece);  // [stage]: lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + NS * T::kStats);
  uint64_t* empty = full + NS;
  uint64_t* own = empty + NS;

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const int r0 = blockIdx.x * OWN;
  const int n_tiles = (p.S + BS - 1) / BS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], DKV ? 32 : 1);  // dK/dV: every producer lane, once its stats are in
      mbar_init(&empty[s], T::kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (hopper::warpgroup_index() == T::kWGS) {  // the producer warp
    const int lane = threadIdx.x - T::kConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(own, 6 * T::kOwnPiece);
      load_pieces<A, OWN>(Xo, &p.own, own, X, r0, h, b, p.B);
      load_pieces<A, OWN>(Yo, &p.own, own, Y, r0, h, b, p.B);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NS;
      // the dK/dV kernel's query stats, read before the wait: a query past S
      // gets lse = +inf (P = 0) and delta = 0
      float l = 0.f, e = 0.f;
      const int row = j * BS + lane;
      if (DKV && lane < BS) {
        l = row < p.S ? p.lse[(long long)g * p.S + row] : INFINITY;
        e = row < p.S ? p.delta[(long long)g * p.S + row] : 0.f;
      }
      mbar_wait(&empty[s], ((j / NS) & 1) ^ 1);
      unsigned char* stage = ring + s * 6 * T::kStrPiece;
      if (lane == 0) {
        if constexpr (DKV)
          mbar_expect_tx(&full[s], 6 * T::kStrPiece);
        else
          mbar_arrive_expect_tx(&full[s], 6 * T::kStrPiece);
        load_pieces<A, BS>(stage, &p.str, &full[s], XS, j * BS, h, b, p.B);
        load_pieces<A, BS>(stage + 3 * T::kStrPiece, &p.str, &full[s], YS, j * BS, h, b, p.B);
      }
      if constexpr (DKV) {
        if (lane < BS) {
          stats[s * T::kStats + lane] = l;
          stats[s * T::kStats + BS + lane] = e;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows r0 + 64 wg + [0, 64); this thread's
  // accumulator elements i lie at rows row0 + 8 ((i >> 1) & 1), columns
  // 8 (i >> 2) + 2 tq + (i & 1)
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int row0 = r0 + 64 * wg + 16 * (t / 32) + gr;
  const uint32_t x_s = smem_u32(Xo) + wg * 64 * 128, y_s = smem_u32(Yo) + wg * 64 * 128;
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};  // the dQ kernel's row stats
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.S) {
        lr[r] = p.lse[(long long)g * p.S + row];
        dr[r] = p.delta[(long long)g * p.S + row];
      }
    }
  }
  // sum0: dK or dQ; sum1: dV. acc0: a tile's products, dV's then dK's (acc1:
  // dV's own in the broken copy, which accumulates each over all of S)
  constexpr int kAcc1 = DKV && !kTileFromZero ? ND / 2 : 1;
  float sum0[ND / 2], sum1[DKV ? ND / 2 : 1], acc0[ND / 2], acc1[kAcc1];
  float s[BS / 2], dp[BS / 2];
  uint32_t pa[3][BS / 16][4];  // P's or dS's pieces as A operands
  zero<ND / 2>(sum0);
  zero<DKV ? ND / 2 : 1>(sum1);
  zero<ND / 2>(acc0);
  zero<kAcc1>(acc1);
  mbar_wait(own, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NS;
    mbar_wait(&full[st], (j / NS) & 1);
    const uint32_t xs = smem_u32(ring + st * 6 * T::kStrPiece), ys = xs + 3 * T::kStrPiece;

    // S = X XS^T and dP = Y YS^T over D, 64 owned x BS streamed rows
    wgmma_fence();
    ss_product<BS, OWN, KS>(s, x_s, T::kOwnPiece, xs, T::kStrPiece);
    ss_product<BS, OWN, KS>(dp, y_s, T::kOwnPiece, ys, T::kStrPiece);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BS / 2>(s);
    fence_regs<BS / 2>(dp);

    // P = exp(S scale - lse) and dS = P (dP - delta) in f32, natural units
    if constexpr (DKV) {  // the columns are queries: their stats from the stage
      const float* ls = stats + st * T::kStats;
#pragma unroll
      for (int c = 0; c < BS / 8; ++c) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * c + 2 * tq);
        const float2 e = *reinterpret_cast<const float2*>(ls + BS + 8 * c + 2 * tq);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = 4 * c + u;
          s[i] = expf(s[i] * p.scale - (u & 1 ? l.y : l.x));
          dp[i] = s[i] * (dp[i] - (u & 1 ? e.y : e.x));
        }
      }
    } else {  // the rows are queries; a key past S gets P = 0
      const int key0 = j * BS;
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pv = expf(s[i] * p.scale - lr[r]);
        if (key0 + BS > p.S && key0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= p.S) pv = 0.f;
        dp[i] = pv * (dp[i] - dr[r]);
      }
    }

    if constexpr (DKV) {  // dV += P^T dO, then dK += dS^T Q (its scale at the store)
      float* acc = kTileFromZero ? acc0 : acc1;
      split_a<BS>(s, pa);
      if (kTileFromZero) zero<ND / 2>(acc);
      rs_product<ND, BS>(acc, pa, ys, T::kStrPiece, j == 0);
      if (kTileFromZero) add_to<ND / 2>(sum1, acc);
    }
    // dK += dS^T Q, or dQ += dS K (each times scale at the store)
    split_a<BS>(dp, pa);
    if (kTileFromZero) zero<ND / 2>(acc0);
    rs_product<ND, BS>(acc0, pa, xs, T::kStrPiece, j == 0);
    if (kTileFromZero) add_to<ND / 2>(sum0, acc0);
    mbar_arrive(&empty[st]);  // this thread is done with the stage
  }
  if constexpr (!kTileFromZero) {
    add_to<ND / 2>(sum0, acc0);
    add_to<kAcc1>(sum1, acc1);
  }

  store_rows<ND>(p.out0, sum0, row0, b, h, p.scale, p);
  if constexpr (DKV) store_rows<ND>(p.out1, sum1, row0, b, h, 1.f, p);
}

template <int ND>
__global__ void __launch_bounds__(Tile<true, ND>::kThreads, 1)
    flash_bwd_dkv_f32_wgmma_kernel(const __grid_constant__ Params p) {
  bwd_f32_body<true, ND>(p);
}

template <int ND>
__global__ void __launch_bounds__(Tile<false, ND>::kThreads, 1)
    flash_bwd_dq_f32_wgmma_kernel(const __grid_constant__ Params p) {
  bwd_f32_body<false, ND>(p);
}

// The block shape's maps over the planes at `pieces`, then one launch: a
// block a tile of kOwn owned rows of a (batch, head).
template <bool DKV, int ND, typename Kernel>
cudaError_t launch(Kernel kernel, Params* p, const void* pieces, cudaStream_t stream) {
  using T = Tile<DKV, ND>;
  static bool attr_set = false;
  if (!attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long strides[3] = {(long long)p->S * p->H * p->D, (long long)p->H * p->D, p->D};
  if (!hopper::encode_bshd(&p->own, pieces, strides, 12 * p->B, p->S, p->H, p->D, T::kOwn) ||
      !hopper::encode_bshd(&p->str, pieces, strides, 12 * p->B, p->S, p->H, p->D, T::kBS))
    return cudaErrorInvalidValue;
  const dim3 grid((p->S + T::kOwn - 1) / T::kOwn, p->B * p->H);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace

// The largest head dim of these kernels (flash_bwd_f32_wide.cu takes D above it).
extern "C" int agenda_flash_bwd_f32_max_head_dim() { return kMaxHeadDim; }

// pieces: agenda_flash_f32_split's twelve planes of (B, S, H, D) q, k, v and
// dout (16-byte aligned); lse, delta: (B*H, S) f32, contiguous; dkv != 0:
// out0 = dK, out1 = dV, else out0 = dQ (out1 unused); each contiguous
// (B, S, H, D) f32. D a multiple of 8 up to 160. Returns a cudaError_t.
extern "C" int agenda_flash_bwd_f32(const void* pieces, const void* lse, const void* delta,
                                    void* out0, void* out1, int B, int S, int H, int D, int dkv,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > kMaxHeadDim ||
      B * H > 65535 || (long long)B * S * H * D / 4 >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(pieces) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = static_cast<float*>(out0);
  p.out1 = static_cast<float*>(out1);
  p.B = B;
  p.S = S;
  p.H = H;
  p.D = D;
  p.scale = 1.f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dkv) {
    if (D <= 40) return (int)launch<true, 40>(flash_bwd_dkv_f32_wgmma_kernel<40>, &p, pieces, st);
    if (D <= 80) return (int)launch<true, 80>(flash_bwd_dkv_f32_wgmma_kernel<80>, &p, pieces, st);
    return (int)launch<true, 160>(flash_bwd_dkv_f32_wgmma_kernel<160>, &p, pieces, st);
  }
  if (D <= 40) return (int)launch<false, 40>(flash_bwd_dq_f32_wgmma_kernel<40>, &p, pieces, st);
  if (D <= 80) return (int)launch<false, 80>(flash_bwd_dq_f32_wgmma_kernel<80>, &p, pieces, st);
  return (int)launch<false, 160>(flash_bwd_dq_f32_wgmma_kernel<160>, &p, pieces, st);
}
