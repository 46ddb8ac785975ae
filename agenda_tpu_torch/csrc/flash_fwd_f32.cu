// Flash-attention forward in full f32 for Hopper (sm_90a), on the tensor
// cores: what --mixed_precision no runs on the card.
//
// Replaces the TPU kernel agenda_tpu/kernels/flash.py::_flash_fwd_kernel
// (flash.py:55, launched at flash.py:117) on f32 operands, which it takes
// as it takes bf16 (its dispatch in agenda_tpu/kernels/attention.py:119-126
// has no dtype test): non-causal softmax(Q K^T / sqrt(D)) V, P multiplied in
// V's dtype (f32 here, flash.py:79), O written in q's dtype (flash.py:91,
// 130), the row logsumexp in f32.
//
// What bounds it on the H100: 4*B*H*S^2*D f32 operations, B*H*S^2
// exponentials, 4*B*S*H*D*4 bytes. The tensor cores take no f32 operand, so
// each f32 operand is split into three bf16 pieces, x = b0 + b1 + b2
// (f32_pieces.cuh: 24 significant bits, as in f32, and the sum is exact). A
// product is the six piece products with i + j <= 2 (the three dropped ones
// lie below 2^-25 of it), added smallest first into one f32 accumulator.
// Six bf16 passes at 989 TFLOP/s cost what three TF32 passes cost at 495
// (the bound chip_smoke.py counts, f32_bound). Three bf16 pieces rather
// than TF32 hi/lo: 6 bytes an element in shared memory, not 8; bf16 wgmma
// reads B MN-major, so O += P V takes V as it lies; and a TF32 pair keeps
// about 22 bits.
//
// Two launches:
// - flash_f32_split_kernel (the pre-pass): q, k and v as the caller's
//   strided views, read once in 16-byte loads, into nine contiguous bf16
//   planes, operand t and piece i at plane 3 t + i, each (B, S, H, D). TMA
//   reads them as it reads the bf16 kernel's operands; views and their
//   contiguous copies give the same planes, bit for bit. (The wide f32
//   backward, flash_bwd_f32_wide.cu, runs the same kernel over q, k, v and
//   dO, into twelve planes.) It moves 30 bytes
//   an element of q, k and v, about 4% of the forward's time at
//   (4, 4096, 8, 40); splitting inside the forward instead would read 4
//   bytes an element from L2 in place of 6 but take shared memory the
//   pieces already fill.
// - flash_fwd_f32_kernel<ND, WGS> and flash_fwd_f32_wide_kernel,
//   flash_fwd.cu's design on the pieces. A producer warp loads the block's
//   Q pieces once and K and V tiles of kBK keys (all three pieces each) into
//   rings under full/empty mbarriers, K and V under barriers of their own,
//   so that a K stage is free as soon as S is computed; boxes of 64 columns,
//   128-byte swizzle, zero fill past S and past D, from (D, H, S, 9B) maps
//   of the planes. Consumer warpgroups own 64 query rows each: S = Q K^T is
//   six wgmma SS passes over the pieces; the softmax runs in f32 in natural
//   units with expf (accurate, not the bf16 kernel's ex2.approx with the
//   scale folded in); P is split into its three pieces in registers, and
//   each key tile's P V is six wgmma RS passes into an accumulator that
//   starts from zero, V read MN-major, then O = O alpha + P V in f32 with one
//   rounding. (The tensor cores' accumulation does not round to nearest: an
//   O accumulated in the tensor cores over all of S, 1 536 products at
//   S = 4096, drifted to 1.4-2.5x the limit at S >= 1000; twelve products a
//   tile keep it under 0.2x.) Each output element has one owner and a fixed
//   order of summation: two launches on the same inputs give bitwise-equal
//   outputs.
//   * D <= 160: ND = 40 (D <= 40): two consumer warpgroups (128 queries)
//     share each K/V tile, 64-key tiles in three stages (192 KB); ND = 80:
//     two warpgroups, 32-key tiles in two stages (192 KB); ND = 160: one
//     warpgroup, 32-key tiles in two stages (216 KB). Two warpgroups and a
//     producer warp cap ptxas at 168 registers a thread (flash_fwd.cu).
//   * 160 < D <= 512 (the VAE's single-head D = 512): a cluster of two
//     blocks that own the same 64 queries and half of D each (ND = 256):
//     the Q pieces of all of D take 192 KB, one block's half 96 KB, and a
//     64 x 512 f32 O takes 256 registers a thread, one block's half 128.
//     Each block computes a partial S over its half, writes it into the
//     other block's shared memory by st.async (which completes the other's
//     mbarrier), and adds the two in rank order, as the other does, so both
//     hold the same S and run the same softmax. P V runs in two passes of
//     128 columns through a 64-register accumulator. One consumer warpgroup
//     and a producer warp a block (160 threads) leave ptxas up to 255
//     registers (248 used); a block holds 96 KB of Q pieces, one 32-key
//     stage of K and one of V (48 KB each) and the partial S (two parities).
//     Clusters of four blocks of 128 columns (kernel_variants.py
//     fwd_f32_wide_cluster4) took 3.36 ms against 1.99 at (4, 4096, 1, 512).

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
using hopper::WgmmaRS;
using hopper::WgmmaSS;

constexpr int kMaxHeadDim = 512;
constexpr int kMaxNarrowHeadDim = 160;

// -- the split --------------------------------------------------------------------

// The operands as they are split: exact f32. (The card tests' broken copies
// round these to TF32, one tensor-core pass, to show that the limit catches it.)
struct SplitOperand {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

struct SplitParams {
  const float* in[4];             // q, k, v (and the wide backward's dO): (B, S, H, D)
  long long sb[4], ss[4], sh[4];  // their element strides (D unit-stride)
  __nv_bfloat16* out;             // three contiguous (B, S, H, D) planes an operand
  int S, H, D, quads;             // quads: B*S*H*D / 4, an operand's float4s
};

// blockIdx.y = the operand; each thread one float4 of it, into three planes
__global__ void __launch_bounds__(256)
    flash_f32_split_kernel(const __grid_constant__ SplitParams p) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.quads) return;
  const int d4 = p.D / 4;
  const int c = 4 * (i % d4), row = i / d4;  // row = (b * S + s) * H + h
  const int h = row % p.H, bs = row / p.H, s = bs % p.S, b = bs / p.S;
  const float4 x = __ldg(reinterpret_cast<const float4*>(
      p.in[t] + b * p.sb[t] + s * p.ss[t] + h * p.sh[t] + c));
  const SplitOperand op{};
  uint32_t lo[3], hi[3];
  split3_pair(op(x.x), op(x.y), lo);
  split3_pair(op(x.z), op(x.w), hi);
  const long long plane = 4ll * p.quads;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    *reinterpret_cast<uint2*>(p.out + (3 * t + k) * plane + 4ll * i) = make_uint2(lo[k], hi[k]);
}

// -- the forward -----------------------------------------------------------------

struct FwdParams {
  CUtensorMap tq, tkv;  // the planes as (D, H, S, 9B) bf16 maps: boxes of kOwn and kBK rows
  float* o;             // (B, S, H, D) f32, contiguous
  float* lse;           // (B*H, S) f32, contiguous
  int B, S, H, D;
  float scale;          // 1 / sqrt(D)
};

// Block shape: ND columns of D a block (all of D, or 1 / NC of 512 in a
// cluster of NC), WGS consumer warpgroups of 64 queries, key tiles of kBK
// rows in kStages stages of K and of V; a piece tile is kAtoms blocks of 64
// columns; P V runs in passes of kPass columns.
template <int ND, int WGS, int NC>
struct F32Fwd {
  static constexpr int kAtoms = (ND + 63) / 64;
  static constexpr int kKSteps = (ND + 15) / 16;
  static constexpr uint32_t kRowBytes = kAtoms * 128;
  static constexpr int kOwn = 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kBK = ND == 40 ? 64 : 32;
  static constexpr int kStages = ND == 40 ? 3 : ND > 160 ? 1 : 2;
  static constexpr int kPass = ND > 160 ? 128 : ND;
  static constexpr uint32_t kQPiece = kOwn * kRowBytes;
  static constexpr uint32_t kKPiece = kBK * kRowBytes;  // one piece of a K or V tile
  static constexpr uint32_t kXBytes = 64 * kBK * 4;      // a partial S
  static constexpr uint32_t kXAll = NC > 1 ? 2 * NC * kXBytes : 0;  // [parity][rank]
  // Q; K and V per stage; the cluster's partial S; barriers; alignment slack
  static constexpr size_t kSmem = 3 * kQPiece + 6 * kStages * kKPiece + kXAll +
                                  (4 * kStages + 3) * sizeof(uint64_t) + 1024;
};

// the three pieces of operand t (0 q, 1 k, 2 v), rows [row0, row0 + ROWS)
// of head h, batch b, columns [col0, col0 + 64 ATOMS), into three tiles
template <int ATOMS, int ROWS>
__device__ __forceinline__ void load_pieces(unsigned char* dst, const CUtensorMap* map,
                                            uint64_t* bar, int t, int col0, int row0, int h,
                                            int b, int B) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tma_load_4d(dst + (i * ATOMS + a) * ROWS * 128, map, bar, col0 + 64 * a, h, row0,
                  (3 * t + i) * B + b);
}

// four floats into the shared memory of another block of the cluster,
// completing as many bytes of that block's mbarrier (addresses from mapa)
__device__ __forceinline__ void st_async_f4(uint32_t remote, float a, float b, float c, float d,
                                            uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(remote_bar)
      : "memory");
}

// the address of this block's shared-memory `addr` in cluster block `rank`
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

template <int ND, int WGS, int NC>
__device__ __forceinline__ void flash_fwd_f32_body(const FwdParams& p) {
  using T = F32Fwd<ND, WGS, NC>;
  constexpr int KS = T::kKSteps, BK = T::kBK, OWN = T::kOwn, A = T::kAtoms;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + 3 * T::kQPiece;                   // kStages tiles of 3 pieces
  unsigned char* Vs = Ks + 3 * T::kStages * T::kKPiece;      // kStages tiles of 3 pieces
  float* Xs = reinterpret_cast<float*>(Vs + 3 * T::kStages * T::kKPiece);  // [parity][rank]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(Xs) +
                                                 T::kXAll);
  uint64_t* empty_k = full_k + T::kStages;
  uint64_t* full_v = empty_k + T::kStages;
  uint64_t* empty_v = full_v + T::kStages;
  uint64_t* own = empty_v + T::kStages;
  uint64_t* xfull = own + 1;  // [parity]: the other blocks' partial S have landed

  const int g = blockIdx.y, b = g / p.H, h = g % p.H;
  const uint32_t rank = NC > 1 ? hopper::cluster_rank() : 0;
  const int q0 = blockIdx.x / NC * OWN;
  const int col0 = ND * (int)rank;  // this block's columns of D
  const int n_tiles = (p.S + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], T::kConsumers / 32);  // one arrival a consumer warp
      mbar_init(&empty_v[s], T::kConsumers / 32);
    }
    mbar_init(own, 1);
    mbar_init(&xfull[0], 1);
    mbar_init(&xfull[1], 1);
    mbar_fence_init();
  }
  if constexpr (NC > 1) {  // the others' barriers are set before they are written to
    hopper::cluster_arrive();
    hopper::cluster_wait();
  } else {
    __syncthreads();
  }

  if (hopper::warpgroup_index() == WGS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == T::kConsumers) {
      mbar_arrive_expect_tx(own, 3 * T::kQPiece);
      load_pieces<A, OWN>(Qs, &p.tq, own, 0, col0, q0, h, b, p.B);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % T::kStages;
        const uint32_t phase = ((j / T::kStages) & 1) ^ 1;
        mbar_wait(&empty_k[s], phase);
        mbar_arrive_expect_tx(&full_k[s], 3 * T::kKPiece);
        load_pieces<A, BK>(Ks + 3 * s * T::kKPiece, &p.tkv, &full_k[s], 1, col0, j * BK, h, b,
                           p.B);
        mbar_wait(&empty_v[s], phase);
        mbar_arrive_expect_tx(&full_v[s], 3 * T::kKPiece);
        load_pieces<A, BK>(Vs + 3 * s * T::kKPiece, &p.tkv, &full_v[s], 2, col0, j * BK, h, b,
                           p.B);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg owns queries q0 + 64 * wg + [0, 64); this thread
    // holds rows 16 * warp + gr (+8) of them: scores s[4 j + e] at key
    // 8 j + 2 tq + (e & 1), row half e >> 1; O likewise at column 8 j + ...
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
    const uint32_t q_s = smem_u32(Qs) + wg * 64 * 128;

    // O: the running sum in f32 (o), and each key tile's P V on the tensor
    // cores from zero (acc, kPass columns at a time), added to it with one
    // rounding: the tensor cores' own accumulation over all the tiles'
    // products drifts past the limit at S = 1000 (flash_fwd_f32.cu's note)
    constexpr int NP = T::kPass;
    float o[ND / 2], acc[NP / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) o[i] = 0.f;
    uint32_t pa[3][BK / 16][4];           // P's pieces as A operands
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores
    float l[2] = {0.f, 0.f};              // running sums, this thread's columns
    mbar_wait(own, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % T::kStages;
      const uint32_t parity = (j / T::kStages) & 1;
      if constexpr (NC > 1) {
        if (t == 0) mbar_arrive_expect_tx(&xfull[j & 1], (NC - 1) * T::kXBytes);
      }
      mbar_wait(&full_k[st], parity);
      const uint32_t k_s = smem_u32(Ks + 3 * st * T::kKPiece);

      // S = Q K^T over this block's columns: the six piece products, smallest first
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < 6; ++pr) {
        const uint32_t qa = q_s + piece_a(pr) * T::kQPiece, kb = k_s + piece_b(pr) * T::kKPiece;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          WgmmaSS<BK>::run(s, desc_k_major<OWN>(qa, kk), desc_k_major<BK>(kb, kk),
                           pr > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      if (lane == 0) mbar_arrive(&empty_k[st]);

      if constexpr (NC > 1) {
        // S = the cluster's partials, summed in rank order by every block
        // (so all hold the same S): this block's into the others' slot
        // [parity][rank], then the others' from this block's
        const uint32_t slot = smem_u32(Xs) + ((j & 1) * NC + rank) * T::kXBytes;
#pragma unroll
        for (int r = 1; r < NC; ++r) {
          const uint32_t peer = (rank + r) % NC;
          const uint32_t to = map_to_rank(slot, peer);
          const uint32_t bar = map_to_rank(smem_u32(&xfull[j & 1]), peer);
#pragma unroll
          for (int i = 0; i < BK / 2; i += 4)
            st_async_f4(to + (i / 4 * 128 + t) * 16, s[i], s[i + 1], s[i + 2], s[i + 3], bar);
        }
        mbar_wait(&xfull[j & 1], (j >> 1) & 1);
        float sum[BK / 2];
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          const float* from = Xs + ((j & 1) * NC + r) * (T::kXBytes / 4);
#pragma unroll
          for (int i = 0; i < BK / 2; i += 4) {
            float4 x = make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
            if (r != (int)rank)
              x = *reinterpret_cast<const float4*>(from + (i / 4 * 128 + t) * 4);
            sum[i] = r == 0 ? x.x : sum[i] + x.x;
            sum[i + 1] = r == 0 ? x.y : sum[i + 1] + x.y;
            sum[i + 2] = r == 0 ? x.z : sum[i + 2] + x.z;
            sum[i + 3] = r == 0 ? x.w : sum[i + 3] + x.w;
          }
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = sum[i];
      }

      // online softmax in f32, natural units; keys past S get P = 0
      const int key0 = j * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] *= p.scale;
        if (key0 + BK > p.S && key0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= p.S) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // finite: key0 < S
        alpha[r] = expf(m[r] - m_new);           // 0 at the first tile
        m[r] = m_new;
      }
      float rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = expf(s[i] - m[(i >> 1) & 1]);
        rowsum[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * alpha[0] + rowsum[0];
      l[1] = l[1] * alpha[1] + rowsum[1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t a3[3];
          split3_pair(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1], a3);
#pragma unroll
          for (int i = 0; i < 3; ++i) pa[i][kk][c] = a3[i];
        }

      // this tile's P V over this block's columns, pass by pass: the six
      // piece products, smallest first, then O = O alpha + P V
      mbar_wait(&full_v[st], parity);
#pragma unroll
      for (int c = 0; c < ND / NP; ++c) {
        const uint32_t v_s = smem_u32(Vs + 3 * st * T::kKPiece) + c * (NP / 64) * BK * 128;
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < 6; ++pr) {
          const uint32_t vb = v_s + piece_b(pr) * T::kKPiece;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            WgmmaRS<NP, 1>::run(acc, pa[piece_a(pr)][kk], desc_mn_major<BK>(vb, kk),
                                pr > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NP / 2>(acc);
#pragma unroll
        for (int i = 0; i < NP / 2; ++i)
          o[c * NP / 2 + i] = fmaf(o[c * NP / 2 + i], alpha[(i >> 1) & 1], acc[i]);
      }
      if (lane == 0) mbar_arrive(&empty_v[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + 64 * wg + 16 * (t / 32) + gr;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.S) continue;
      float* out = p.o + (((long long)b * p.S + row) * p.H + h) * p.D;
#pragma unroll
      for (int i = 2 * r; i < ND / 2; i += 4) {
        const int col = col0 + 8 * (i >> 2) + 2 * tq;
        if (col < p.D)
          *reinterpret_cast<float2*>(out + col) = make_float2(o[i] / l[r], o[i + 1] / l[r]);
      }
      if (rank == 0 && tq == 0) p.lse[(long long)g * p.S + row] = m[r] + logf(l[r]);
    }
  }
  if constexpr (NC > 1) {  // no block leaves while another may still write to it
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
}

template <int ND, int WGS>
__global__ void __launch_bounds__(F32Fwd<ND, WGS, 1>::kThreads, 1)
    flash_fwd_f32_kernel(const __grid_constant__ FwdParams p) {
  flash_fwd_f32_body<ND, WGS, 1>(p);
}

constexpr int kWideND = 256, kWideNC = kMaxHeadDim / kWideND;

__global__ void __cluster_dims__(kWideNC, 1, 1)
    __launch_bounds__(F32Fwd<kWideND, 1, kWideNC>::kThreads, 1)
    flash_fwd_f32_wide_kernel(const __grid_constant__ FwdParams p) {
  flash_fwd_f32_body<kWideND, 1, kWideNC>(p);
}

// The block shape's maps over the planes at `pieces`, then one launch: a
// block (a cluster of NC blocks) a tile of kOwn queries of a (batch, head).
template <int ND, int WGS, int NC, typename Kernel>
cudaError_t launch(Kernel kernel, FwdParams* p, const void* pieces, cudaStream_t stream,
                   bool* attr_set) {
  using T = F32Fwd<ND, WGS, NC>;
  if (!*attr_set) {  // opt in to > 48 KB of dynamic shared memory once
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  const long long strides[3] = {(long long)p->S * p->H * p->D, (long long)p->H * p->D, p->D};
  if (!hopper::encode_bshd(&p->tq, pieces, strides, 9 * p->B, p->S, p->H, p->D, T::kOwn) ||
      !hopper::encode_bshd(&p->tkv, pieces, strides, 9 * p->B, p->S, p->H, p->D, T::kBK))
    return cudaErrorInvalidValue;
  const dim3 grid(NC * ((p->S + T::kOwn - 1) / T::kOwn), p->B * p->H);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(*p);
  return cudaGetLastError();
}

template <int ND, int WGS>
cudaError_t launch_narrow(FwdParams* p, const void* pieces, cudaStream_t stream) {
  static bool attr_set = false;
  return launch<ND, WGS, 1>(flash_fwd_f32_kernel<ND, WGS>, p, pieces, stream, &attr_set);
}

cudaError_t launch_wide(FwdParams* p, const void* pieces, cudaStream_t stream) {
  static bool attr_set = false;
  return launch<kWideND, 1, kWideNC>(flash_fwd_f32_wide_kernel, p, pieces, stream, &attr_set);
}

bool dims_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && H > 0 && D > 0 && D % 8 == 0 && D <= kMaxHeadDim &&
         B * H <= 65535 && (long long)B * S * H * D / 4 < (1ll << 31);
}

}  // namespace

extern "C" int agenda_flash_fwd_f32_max_head_dim() { return kMaxHeadDim; }

// q, k, v and dout (null for the forward; the wide backward's): (B, S, H,
// D) f32 with the given element strides (q, k, v, dout; batch, seq, head
// each; D unit-stride), 16-byte-aligned bases and strides that are
// multiples of 4; D a multiple of 8 up to 512 -> pieces: three contiguous
// (B, S, H, D) bf16 planes an operand, operand t (q, k, v, dout) and piece
// i at plane 3 t + i. Returns a cudaError_t.
extern "C" int agenda_flash_f32_split(const void* q, const void* k, const void* v,
                                      const void* dout, void* pieces, int B, int S, int H, int D,
                                      const long long* strides, void* stream) {
  if (!dims_ok(B, S, H, D) || reinterpret_cast<uintptr_t>(pieces) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  SplitParams p;
  const void* ptrs[4] = {q, k, v, dout};
  const int n = dout == nullptr ? 3 : 4;
  for (int t = 0; t < n; ++t) {
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16 != 0) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * t + j] % 4 != 0) return (int)cudaErrorInvalidValue;
    p.in[t] = static_cast<const float*>(ptrs[t]);
    p.sb[t] = strides[3 * t];
    p.ss[t] = strides[3 * t + 1];
    p.sh[t] = strides[3 * t + 2];
  }
  p.out = static_cast<__nv_bfloat16*>(pieces);
  p.S = S;
  p.H = H;
  p.D = D;
  p.quads = (int)((long long)B * S * H * D / 4);
  const dim3 grid((p.quads + 255) / 256, n);
  flash_f32_split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// pieces: agenda_flash_f32_split's planes of (B, S, H, D) q, k, v (16-byte
// aligned); o: contiguous (B, S, H, D) f32; lse: (B*H, S) f32, contiguous.
// Returns a cudaError_t (0 on success).
extern "C" int agenda_flash_fwd_f32(const void* pieces, void* o, void* lse, int B, int S, int H,
                                    int D, void* stream) {
  if (!dims_ok(B, S, H, D) || reinterpret_cast<uintptr_t>(pieces) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.H = H;
  p.D = D;
  p.scale = 1.f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 40) return (int)launch_narrow<40, 2>(&p, pieces, st);
  if (D <= 80) return (int)launch_narrow<80, 2>(&p, pieces, st);
  if (D <= kMaxNarrowHeadDim) return (int)launch_narrow<160, 1>(&p, pieces, st);
  return (int)launch_wide(&p, pieces, st);
}
