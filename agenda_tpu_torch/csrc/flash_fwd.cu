// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 logsumexp.
//
// Replaces the TPU kernel agenda_tpu/kernels/flash.py::_flash_fwd_kernel
// (flash.py:55, launched by _flash_fwd_impl at flash.py:95-145): non-causal,
// unmasked softmax(Q K^T / sqrt(D)) V with an online softmax, f32 running max,
// sum and accumulator, and the per-row logsumexp the backward needs.
//
// What bounds it on the H100: at the main path's shapes it does 4*B*H*S^2*D
// operations on 4*B*S*H*D*2 bytes, i.e. S/2 bf16 operations per byte
// (>= 512 at S = 1024), far above the card's ~295 operations per byte, so the
// tensor cores bound it. The kernel feeds them with mma.sync (FA2-style);
// wgmma and TMA are later work.
//
// Design:
// - q, k, v and out are read through their (B, S, H, D) strides: no transpose
//   to (B*H, S, D) and no pad of D to 128 in device memory. D (a multiple of
//   8, up to 512) is zero-padded to the tile width DP only in shared memory,
//   so D = 40, 80, 160 and 512 work; rows past S are zero-filled and their
//   keys masked with -inf, so any S works.
// - One block per (64 query rows, batch*head). Each warp owns 16 query rows
//   and keeps its scores, P and its columns of the output accumulator in
//   mma.sync.m16n8k16 fragments (bf16 -> f32). K/V tiles are double-buffered
//   in shared memory with cp.async; ldmatrix (.trans for V) feeds the MMAs.
// - f32 online softmax in base 2; P is rounded to bf16 before P V, as the
//   TPU kernel casts P to V's dtype; the row sum uses the f32 P.
// - Tile widths DP = 48, 80 and 160: 4 warps, 64-key tiles, Q held as A
//   fragments in registers.
// - DP = 512 (the VAE's D = 512): a 16 x 512 f32 accumulator would take 256
//   registers a thread, so 8 warps split O's columns in two halves (the two
//   warps of a row slice each compute the same 16 x 32 scores), key tiles
//   shrink to 32 rows so that Q and two K/V stages fit in 227 KB of shared
//   memory, and Q's fragments are re-read from shared memory at each k-step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 512;
constexpr int kBQ = 64;  // query rows per block: 4 row slices of 16

struct FlashParams {
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
  float scale_log2;  // log2(e) / sqrt(D): the softmax runs in base 2
};

// Tile shape for a head dim padded to DP.
template <int DP>
struct Tile {
  static constexpr bool kWide = DP > 256;
  static constexpr int kWarpCols = kWide ? 2 : 1;  // warps sharing one 16-row slice
  static constexpr int kThreads = 4 * 32 * kWarpCols;
  static constexpr int kBK = kWide ? 32 : 64;  // keys per K/V tile
  static constexpr int kRow = DP + 8;  // 16 bytes of pad: ldmatrix rows land in distinct banks
  static constexpr int kKT = DP / 16;  // k-steps of Q K^T
  static constexpr int kNT = DP / 8 / kWarpCols;  // 8-column tiles of O per warp
  static constexpr size_t kSmem = (size_t)(kBQ + 4 * kBK) * kRow * 2;  // Q, K[2], V[2]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 destination bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = a (16x16 bf16, row) * b (16x8 bf16, col) + d, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of one (batch, head) slice -> a (ROWS x DP) smem
// tile, zero-filled past S and past D
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int row0, const FlashParams& p) {
  constexpr int chunks = DP / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += Tile<DP>::kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool valid = row0 + r < p.S && c < p.D;
    const __nv_bfloat16* g = valid ? src + (int64_t)(row0 + r) * row_stride + c : src;
    cp_async16(smem_u32(dst + r * Tile<DP>::kRow + c), g, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(Tile<DP>::kThreads) flash_fwd_kernel(FlashParams p) {
  using T = Tile<DP>;
  constexpr int ROW = T::kRow, BK = T::kBK, KT = T::kKT, NT = T::kNT;
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

  load_tile<DP, kBQ>(Qs, qg, p.q_ss, q0, p);
  cp_async_commit();
  load_tile<DP, BK>(Ks, kg, p.k_ss, 0, p);
  load_tile<DP, BK>(Vs, vg, p.v_ss, 0, p);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const __nv_bfloat16* q_frag = Qs + (slice * 16 + (lane % 16)) * ROW + (lane / 16) * 8;
  uint32_t qa[T::kWide ? 1 : KT][4];  // Q as A fragments, when they fit in registers
  if constexpr (!T::kWide) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldmatrix_x4(smem_u32(q_frag + kk * 16), qa[kk]);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // rows gr and gr + 8, base-2 scaled
  float l_row[2] = {0.f, 0.f};               // per-thread partial sums

  const int n_tiles = (p.S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      load_tile<DP, BK>(Ks + (stage ^ 1) * BK * ROW, kg, p.k_ss, (j + 1) * BK, p);
      load_tile<DP, BK>(Vs + (stage ^ 1) * BK * ROW, vg, p.v_ss, (j + 1) * BK, p);
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
      if constexpr (T::kWide) {
        ldmatrix_x4(smem_u32(q_frag + kk * 16), a);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      }
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {  // two 8-key tiles per ldmatrix.x4
        uint32_t bk[4];
        ldmatrix_x4(smem_u32(Kt + (n * 8 + (lane % 8) + (lane / 16) * 8) * ROW + kk * 16 +
                             ((lane / 8) % 2) * 8),
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
        ldmatrix_x4_trans(smem_u32(Vt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ROW +
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
    if (tq == 0 && n0 == 0)
      p.lse[(int64_t)g * p.S + row] = (m_row[r] + log2f(l_row[r])) * 0.69314718055994531f;
  }
}

template <int DP>
cudaError_t launch(const FlashParams& p, int batch_heads, cudaStream_t stream) {
  using T = Tile<DP>;
  static bool attr_set = false;  // opt in to > 48 KB of dynamic shared memory once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((p.S + kBQ - 1) / kBQ, batch_heads);
  flash_fwd_kernel<DP><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// One tile per main-path head dim (40, 80, 160, 512); any other D runs in the
// next wider tile, zero-padded in shared memory.
cudaError_t (*pick(int D))(const FlashParams&, int, cudaStream_t) {
  if (D <= 48) return launch<48>;
  if (D <= 80) return launch<80>;
  if (D <= 160) return launch<160>;
  return launch<512>;
}

}  // namespace

extern "C" int agenda_flash_fwd_max_head_dim() { return kMaxHeadDim; }

// q, k, v, o: (B, S, H, D) bf16 with the given element strides (D unit-stride),
// 16-byte-aligned bases and strides that are multiples of 8 (cp.async moves
// 16-byte chunks); D a multiple of 8 up to kMaxHeadDim; lse: (B*H, S) f32,
// contiguous. Returns a cudaError_t (0 on success).
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
  FlashParams p;
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
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  return (int)pick(D)(p, B * H, static_cast<cudaStream_t>(stream));
}
