// Flash attention's backward in full f32 for 160 < D <= 512, on the Hopper
// (sm_90a) tensor cores: the dK/dV and dQ that f32 VAE pretraining runs at
// its single-head mid-block attention (D = 512; S = 1024 at 256 px, 4096 at
// 512 px). flash_bwd_f32.cu takes D <= 160 in one pass.
//
// Replaces the TPU kernels of agenda_tpu/kernels/flash.py on f32 operands,
// which they take as they take bf16 (their dispatch in
// agenda_tpu/kernels/attention.py:119-126 has no dtype test):
// _flash_bwd_dkv_kernel (flash.py:153, launched at flash.py:239) and
// _flash_bwd_dq_kernel (flash.py:192, launched at flash.py:265): P from lse,
// dS = P (dP - delta), dK = scale dS^T Q, dV = P^T dO, dQ = scale dS K, the
// gradients in the input dtype (flash.py:306-309).
//
// What bounds them on the H100: 7*B*H*S^2*D multiply-adds of f32-accurate
// products (dK/dV 4, dQ 3). The tensor cores take no f32 operand, so, as in
// flash_fwd_f32.cu, each f32 operand is three bf16 pieces, x = b0 + b1 + b2
// (f32_pieces.cuh; the sum exact), and a product is the six piece products
// with i + j <= 2, smallest first: six bf16 passes at 989 TFLOP/s cost what three TF32 passes
// at 495 cost, the bound chip_smoke.py counts (f32_bound).
//
// Why not one flash kernel: at D = 512 three bf16 pieces of 32 owned rows
// take 96 KB an operand, so K and V alone would fill 192 KB, and the score
// products need 64 rows of the streamed side (96 KB more over half of D).
// Each entry instead runs three kernels that meet in device memory, each a
// pipelined tensor-core loop with room to spare in shared memory:
// 1. the pre-pass, flash_fwd_f32.cu's flash_f32_split_kernel over q, k, v
//    and dO: twelve contiguous bf16 planes, operand t (q, k, v, dO) and
//    piece i at plane 3 t + i, each (B, S, H, D), which TMA reads as the
//    forward reads its nine.
// 2. flash_f32_wide_scores_kernel<DKV>: a block a 128 x 64 tile of one
//    (batch, head)'s score matrix, whose rows are the dK/dV entry's keys (it
//    forms S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out
//    row-major for step 3) or the dQ entry's queries (S = Q K^T, dP = dO
//    V^T). A producer warp streams D in boxes of 64 columns by TMA into a
//    ring of three stages (full/empty mbarriers, 128-byte swizzle, zero fill
//    past S and D) that alternate S's box and dP's; two consumer
//    warpgroups each own a 64 x 64 square and put each stage's six products
//    (24 wgmma m64n64k16) into an accumulator that starts from zero and is
//    added to the f32 sum of S or of dP. Each then forms P = exp(S scale -
//    lse) with expf and dS = P (dP - delta) scale (dK's and dQ's scale folded
//    in) and writes both to scratch as three bf16 pieces (P for the dK/dV
//    entry only): rows past S are not stored, columns past S or past the
//    chunk's queries are 0. Its reads of the pieces from L2 bind it: at
//    (8, 1024, 1, 512) a 128 x 64 tile reads 1.18 GB and a 64 x 64 one 1.57
//    (kernel_variants.py bwd_f32_wide_scores_64x64: 0.290 ms against 0.267).
// 3. flash_f32_wide_products_kernel<DKV>: out = A B with A the scratch's
//    pieces (K-major) and B the operand's (read MN-major: its rows are the
//    reduction): dV = P^T dO and dK = dS^T Q (blockIdx.z picks one), or
//    dQ = dS K. A block owns a 128 x 128 output tile, two consumer
//    warpgroups of 64 rows, and loops over the reduction in 64-row tiles
//    (two stages of A, 48 KB, and B, 48 KB, under TMA). Each tile's six
//    products (24 wgmma m64n128k16) start from zero in the tensor cores and
//    are added to the f32 result by FFMA: the tensor cores' accumulation
//    does not round to nearest, and the forward's O accumulated in them over
//    all of S drifted to 1.4-2.5x the limit (flash_fwd_f32.cu).
// The scratch (P and dS pieces: 12 bytes an element of the S x S matrix for
// the dK/dV entry, 6 for the dQ) is the wrapper's (kernels/flash.py), which
// bounds it by chunking over (batch, head) and query rows. A chunk of
// queries after the first continues dK and dV from the output
// (accumulate), tile after tile as one chunk would, so every chunk plan
// gives the same bits. Each output element has one owner and a fixed order
// of summation: two launches on the same inputs give bitwise-equal outputs.

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
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
using hopper::WgmmaSS;

constexpr int kMinHeadDim = 160;  // exclusive: flash_bwd_f32.cu takes D <= 160
constexpr int kMaxHeadDim = 512;
constexpr int kQ = 0, kK = 1, kV = 2, kDO = 3;  // the operands' order in the planes
constexpr uint32_t kBox = 64 * 128;              // a TMA box: 64 rows of 64 bf16, 8 KB

// Each reduction tile's products start from zero in the tensor cores and are
// added to the f32 result by FFMA. (False, a broken copy of the card tests:
// the tiles accumulate in the tensor cores over the whole reduction.)
constexpr bool kTileFromZero = true;

// -- the chunk ------------------------------------------------------------------------

// One chunk of a call: (batch, head) bh0 + [0, nbh), queries q0 + [0, nq).
// Its scratch holds, for each (batch, head) z of the chunk, planes of rows x
// cols bf16 at ((plane * nbh + z) * rows + row) * cols + col: for the dK/dV
// entry P^T's three pieces then dS^T's (keys x queries of the chunk, rows =
// S, cols = nq rounded up to 64), for the dQ entry dS's (queries x keys,
// rows = nq, cols = S rounded up to 64).
struct ChunkParams {
  CUtensorMap ops;      // the twelve planes as a (D, H, S, 12 B) map, boxes of 64 rows
  CUtensorMap scratch;  // the scratch as a (cols, 1, rows, planes * nbh) map, boxes of 128 rows
  __nv_bfloat16* sc;    // the scratch
  const float* lse;     // (B*H, S)
  const float* delta;   // (B*H, S)
  float* out[2];        // the dK/dV entry: dV, dK; the dQ entry: dQ. Contiguous (B, S, H, D)
  int B, S, H, D;
  int bh0, nbh, q0, nq;
  int rows, cols;
  int accumulate;       // 1: add to the output (a chunk of queries after the first)
  float scale;          // 1 / sqrt(D)
};

// -- 2. the scores pass --------------------------------------------------------------

// A block's tile of the score matrix: kScoreRowWGs x kScoreColWGs consumer
// warpgroups, each a 64 x 64 square of it. The ring's stages alternate S's
// box j (X = K or Q, Y = Q or K) and dP's (X = V or dO, Y = dO or V), so that
// one accumulator serves both products and every warpgroup holds S and dP of
// its square: 96 registers of sums a thread. ptxas builds the dQ
// instantiation in 162 registers a thread and the dK/dV one at 168, the most
// it gives this block, with 48 bytes spilled (the build's ptxas -v log). 2 x 1 (128 x 64, three stages
// of 72 KB): 0.267 ms at (8, 1024, 1, 512) in the dK/dV; 2 x 2 (128 x 128,
// two of 96 KB, 544 threads) spills at ptxas's 96 registers a thread and
// took 0.397 (kernel_variants.py bwd_f32_wide_scores_128x128).
constexpr int kScoreRowWGs = 2, kScoreColWGs = 1;
// the scratch's columns: a multiple of 128, whatever the tile's width
constexpr int kColAlign = 128;
static_assert(kColAlign % (64 * kScoreColWGs) == 0, "a tile past the scratch's columns");

template <int RW, int CW>
struct Scores {
  static constexpr int kThreads = 128 * RW * CW + 32;
  static constexpr uint32_t kXPiece = RW * kBox, kYPiece = CW * kBox;  // one piece of a box
  static constexpr uint32_t kStage = 3 * (kXPiece + kYPiece);
  static constexpr int kStages = (225 * 1024) / kStage;  // 3 at 2 x 1 (72 KB), 2 at 2 x 2
  static constexpr size_t kSmem = kStages * kStage + 2 * kStages * sizeof(uint64_t) + 1024;
};
using ScoreTile = Scores<kScoreRowWGs, kScoreColWGs>;

// one stage's six piece products of a 64 x 64 square into acc, from zero
__device__ __forceinline__ void square_product(float* acc, uint32_t xs, uint32_t ys,
                                               uint32_t x_piece, uint32_t y_piece) {
  wgmma_fence();
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<64>::run(acc, desc_k_major<64>(xs + piece_a(pr) * x_piece, kk),
                       desc_k_major<64>(ys + piece_b(pr) * y_piece, kk), pr > 0 || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(acc);
}

template <bool DKV>
__global__ void __launch_bounds__(ScoreTile::kThreads, 1)
    flash_f32_wide_scores_kernel(const __grid_constant__ ChunkParams p) {
  using T = ScoreTile;
  constexpr int RW = kScoreRowWGs, CW = kScoreColWGs, NS = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [stage]: X's pieces, then Y's
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * T::kStage);
  uint64_t* empty = full + NS;

  const int z = blockIdx.z, bh = p.bh0 + z, b = bh / p.H, h = bh % p.H;
  const int r0 = 64 * RW * blockIdx.y, c0 = 64 * CW * blockIdx.x;  // the tile in the plane
  // X's rows are the tile's rows, Y's its columns: keys and queries (dK/dV),
  // or queries and keys (dQ)
  const int x_row0 = DKV ? r0 : p.q0 + r0, y_row0 = DKV ? p.q0 + c0 : c0;
  const int n_stages = 2 * ((p.D + 63) / 64);  // S's and dP's box of each 64 columns of D
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * RW * CW);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (hopper::warpgroup_index() == RW * CW) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * RW * CW) {
      for (int u = 0; u < n_stages; ++u) {
        const int s = u % NS, j = u / 2;
        const int tx = u % 2 == 0 ? (DKV ? kK : kQ) : (DKV ? kV : kDO);
        const int ty = u % 2 == 0 ? (DKV ? kQ : kK) : (DKV ? kDO : kV);
        unsigned char* st = ring + s * T::kStage;
        mbar_wait(&empty[s], ((u / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], T::kStage);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int r = 0; r < RW; ++r)
            tma_load_4d(st + i * T::kXPiece + r * kBox, &p.ops, &full[s], 64 * j, h,
                        x_row0 + 64 * r, (3 * tx + i) * p.B + b);
#pragma unroll
          for (int c = 0; c < CW; ++c)
            tma_load_4d(st + 3 * T::kXPiece + i * T::kYPiece + c * kBox, &p.ops, &full[s],
                        64 * j, h, y_row0 + 64 * c, (3 * ty + i) * p.B + b);
        }
      }
    }
    __syncwarp();
  } else {
    // warpgroup (wr, wc) owns the square at rows r0 + 64 wr, columns c0 + 64 wc;
    // element i of thread t at its row 16 w + gr + 8 ((i >> 1) & 1), column
    // 8 (i >> 2) + 2 tq + (i & 1)
    const int wgi = threadIdx.x / 128, wr = wgi / CW, wc = wgi % CW, t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, w = t / 32, gr = lane / 4, tq = lane % 4;
    float st[32], dp[32], acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.f;
    for (int u = 0; u < n_stages; u += 2) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {  // S's box, then dP's
        const int s = (u + g) % NS;
        mbar_wait(&full[s], ((u + g) / NS) & 1);
        const uint32_t base = smem_u32(ring + s * T::kStage);
        square_product(acc, base + wr * 64 * 128, base + 3 * T::kXPiece + wc * 64 * 128,
                       T::kXPiece, T::kYPiece);
        if (lane == 0) mbar_arrive(&empty[s]);
        float* sum = g == 0 ? st : dp;
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[i] += acc[i];
      }
    }

    // P = exp(S scale - lse), dS = P (dP - delta) scale; zero at a query past
    // the chunk or a key past S
    const float* lse = p.lse + (long long)bh * p.S;
    const float* delta = p.delta + (long long)bh * p.S;
    const int row0 = r0 + 64 * wr + 16 * w + gr, col0 = c0 + 64 * wc + 2 * tq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1), col = col0 + 8 * (i >> 2) + (i & 1);
      const int query = p.q0 + (DKV ? col : row), key = DKV ? row : col;
      const bool valid = (DKV ? col : row) < p.nq && key < p.S;
      st[i] = valid ? expf(st[i] * p.scale - lse[query]) : 0.f;
      dp[i] = valid ? st[i] * (dp[i] - delta[query]) * p.scale : 0.f;
    }
    // P's pieces (the dK/dV entry only) at planes 0-2, dS's at 3-5 (dK/dV) or 0-2 (dQ)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int row = row0 + 8 * r2;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + 8 * j;
        const long long at = ((long long)z * p.rows + row) * p.cols + col;
        const long long plane = (long long)p.nbh * p.rows * p.cols;
        uint32_t a3[3];
        if (DKV) {
          split3_pair(st[4 * j + 2 * r2], st[4 * j + 2 * r2 + 1], a3);
#pragma unroll
          for (int i = 0; i < 3; ++i) *reinterpret_cast<uint32_t*>(p.sc + i * plane + at) = a3[i];
        }
        split3_pair(dp[4 * j + 2 * r2], dp[4 * j + 2 * r2 + 1], a3);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          *reinterpret_cast<uint32_t*>(p.sc + ((DKV ? 3 : 0) + i) * plane + at) = a3[i];
      }
    }
  }
}

// -- 3. the gradient products ----------------------------------------------------

struct Products {
  static constexpr int kThreads = 288;  // two consumer warpgroups and a producer warp
  static constexpr int kStages = 2;
  static constexpr uint32_t kAPiece = 128 * 128;  // a 128-row box of A: 16 KB
  static constexpr uint32_t kA = 3 * kAPiece;      // three pieces: 48 KB
  static constexpr uint32_t kB = 3 * 2 * kBox;     // three pieces of 64 rows x 128 columns: 48 KB
  static constexpr uint32_t kStage = kA + kB;
  static constexpr size_t kSmem = kStages * kStage + 2 * kStages * sizeof(uint64_t) + 1024;
};

template <bool DKV>
__global__ void __launch_bounds__(Products::kThreads, 1)
    flash_f32_wide_products_kernel(const __grid_constant__ ChunkParams p) {
  constexpr int NS = Products::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [stage]: A's pieces, then B's
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * Products::kStage);
  uint64_t* empty = full + NS;

  // the dK/dV entry: which 0 is dV = P^T dO, which 1 dK = dS^T Q; the dQ entry: dQ = dS K
  const int which = DKV ? blockIdx.z & 1 : 0;
  const int z = DKV ? blockIdx.z >> 1 : blockIdx.z, bh = p.bh0 + z, b = bh / p.H, h = bh % p.H;
  const int m0 = 128 * blockIdx.y, n0 = 128 * blockIdx.x;  // scratch rows, columns of D
  const int n_tiles = p.cols / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (hopper::warpgroup_index() == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      const int tb = DKV ? (which ? kQ : kDO) : kK, k_row0 = DKV ? p.q0 : 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % NS;
        unsigned char* st = ring + s * Products::kStage;
        mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], Products::kStage);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          tma_load_4d(st + i * Products::kAPiece, &p.scratch, &full[s], 64 * kt, 0, m0,
                      (3 * which + i) * p.nbh + z);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            tma_load_4d(st + Products::kA + (2 * i + a) * kBox, &p.ops, &full[s], n0 + 64 * a,
                        h, k_row0 + 64 * kt, (3 * tb + i) * p.B + b);
      }
    }
    __syncwarp();
  } else {
    // warpgroup wg owns rows m0 + 64 wg + [0, 64) of the tile; element i of
    // a thread at row 16 w + gr + 8 ((i >> 1) & 1) of those, column
    // n0 + 8 (i >> 2) + 2 tq + (i & 1)
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, w = t / 32, gr = lane / 4, tq = lane % 4;
    float* rows_at[2];  // this thread's two output rows, or null past the chunk
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int m = m0 + 64 * wg + 16 * w + gr + 8 * r2;
      const int seq = DKV ? m : p.q0 + m;  // the output's row: a key or a query
      rows_at[r2] = m < p.rows ? p.out[which] + (((long long)b * p.S + seq) * p.H + h) * p.D
                               : nullptr;
    }
    float res[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float* row = rows_at[(i >> 1) & 1];
      const int col = n0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      res[i] = p.accumulate && row != nullptr && col < p.D ? row[col] : 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % NS;
      mbar_wait(&full[s], (kt / NS) & 1);
      const uint32_t as = smem_u32(ring + s * Products::kStage) + wg * 64 * 128;
      const uint32_t bs = smem_u32(ring + s * Products::kStage + Products::kA);
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<128, 0, 1>::run(acc, desc_k_major<128>(as + piece_a(pr) * Products::kAPiece, kk),
                                  desc_mn_major<64>(bs + piece_b(pr) * 2 * kBox, kk),
                                  pr > 0 || kk > 0 || (!kTileFromZero && kt > 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
      if (kTileFromZero) {
#pragma unroll
        for (int i = 0; i < 64; ++i) res[i] += acc[i];
      }
    }
    if (!kTileFromZero) {
#pragma unroll
      for (int i = 0; i < 64; ++i) res[i] += acc[i];
    }
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float* row = rows_at[r2];
      if (row == nullptr) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col < p.D)
          *reinterpret_cast<float2*>(row + col) =
              make_float2(res[4 * j + 2 * r2], res[4 * j + 2 * r2 + 1]);
      }
    }
  }
}

// -- host side --------------------------------------------------------------------

int round_cols(int n) { return (n + kColAlign - 1) / kColAlign * kColAlign; }

bool dims_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && H > 0 && D > kMinHeadDim && D <= kMaxHeadDim && D % 8 == 0 &&
         B * H <= 65535 && (long long)B * S * H * D / 4 < (1ll << 31);
}

// The chunk's geometry and the two maps; cudaErrorInvalidValue for a chunk
// out of range, a dK/dV chunk of queries that does not start at a multiple
// of 64 (its sums would not continue tile by tile), or a map that
// cuTensorMapEncodeTiled refuses.
cudaError_t make_chunk(ChunkParams* p, const void* pieces, const void* scratch, int B, int S,
                       int H, int D, int bh0, int nbh, int q0, int nq, bool dkv) {
  if (!dims_ok(B, S, H, D) || bh0 < 0 || nbh <= 0 || bh0 + nbh > B * H || nbh > 32767 ||
      q0 < 0 || nq <= 0 || q0 + nq > S || (dkv && q0 % 64 != 0) ||
      reinterpret_cast<uintptr_t>(pieces) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return cudaErrorInvalidValue;
  p->sc = static_cast<__nv_bfloat16*>(const_cast<void*>(scratch));
  p->B = B;
  p->S = S;
  p->H = H;
  p->D = D;
  p->bh0 = bh0;
  p->nbh = nbh;
  p->q0 = q0;
  p->nq = nq;
  p->rows = dkv ? S : nq;
  p->cols = dkv ? round_cols(nq) : round_cols(S);
  p->accumulate = 0;
  p->scale = 1.f / sqrtf((float)D);
  const long long ops[3] = {(long long)S * H * D, (long long)H * D, D};
  const long long sc[3] = {(long long)p->rows * p->cols, p->cols, p->cols};
  if (!hopper::encode_bshd(&p->ops, pieces, ops, 12 * B, S, H, D, 64) ||
      !hopper::encode_bshd(&p->scratch, scratch, sc, (dkv ? 6 : 3) * nbh, p->rows, 1, p->cols,
                           128))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, dim3 grid, const ChunkParams& p,
                   cudaStream_t stream, bool* attr_set) {
  if (!*attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t launch_scores(const ChunkParams& p, cudaStream_t st) {
  static bool attr_set = false;
  constexpr int rows = 64 * kScoreRowWGs, cols = 64 * kScoreColWGs;
  const dim3 grid(p.cols / cols, (p.rows + rows - 1) / rows, p.nbh);
  return launch(flash_f32_wide_scores_kernel<DKV>, ScoreTile::kSmem, ScoreTile::kThreads, grid,
                p, st, &attr_set);
}

template <bool DKV>
cudaError_t launch_products(const ChunkParams& p, cudaStream_t st) {
  static bool attr_set = false;
  const dim3 grid((p.D + 127) / 128, (p.rows + 127) / 128, p.nbh * (DKV ? 2 : 1));
  return launch(flash_f32_wide_products_kernel<DKV>, Products::kSmem, Products::kThreads, grid,
                p, st, &attr_set);
}

}  // namespace

// The largest head dim of the wide backward (it takes D in (160, 512]).
extern "C" int agenda_flash_f32_wide_bwd_max_head_dim() { return kMaxHeadDim; }

// The scores pass of one chunk: pieces from agenda_flash_f32_split of q, k,
// v and dout; lse, delta (B*H, S) f32 contiguous; scratch: the chunk's
// planes (16-byte aligned; see ChunkParams). dkv: 1 for the dK/dV entry (P^T and dS^T), 0
// for the dQ entry (dS). Returns a cudaError_t.
extern "C" int agenda_flash_f32_wide_scores(const void* pieces, const void* lse,
                                            const void* delta, void* scratch, int B, int S,
                                            int H, int D, int bh0, int nbh, int q0, int nq,
                                            int dkv, void* stream) {
  ChunkParams p;
  cudaError_t err = make_chunk(&p, pieces, scratch, B, S, H, D, bh0, nbh, q0, nq, dkv != 0);
  if (err != cudaSuccess) return (int)err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out[0] = p.out[1] = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dkv ? launch_scores<true>(p, st) : launch_scores<false>(p, st));
}

// The gradient products of one chunk, from the same pieces and the scratch
// its scores pass wrote: dkv 1: out0 = dV, out1 = dK; dkv 0: out0 = dQ; each
// contiguous (B, S, H, D) f32. accumulate: add to the outputs (a dK/dV chunk
// of queries after the first). Returns a cudaError_t.
extern "C" int agenda_flash_f32_wide_products(const void* pieces, const void* scratch,
                                              void* out0, void* out1, int B, int S, int H,
                                              int D, int bh0, int nbh, int q0, int nq, int dkv,
                                              int accumulate, void* stream) {
  ChunkParams p;
  cudaError_t err = make_chunk(&p, pieces, scratch, B, S, H, D, bh0, nbh, q0, nq, dkv != 0);
  if (err != cudaSuccess) return (int)err;
  p.lse = p.delta = nullptr;
  p.out[0] = static_cast<float*>(out0);
  p.out[1] = static_cast<float*>(out1);
  p.accumulate = accumulate != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dkv ? launch_products<true>(p, st) : launch_products<false>(p, st));
}
