// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) and the GroupNorm (groupnorm.cu), in raw PTX:
// mbarriers, TMA tile loads, thread-block clusters and their distributed
// shared memory, named barriers, the wgmma shared-memory matrix descriptor,
// and wgmma.mma_async in its SS form (A and B from shared memory, either
// read transposed) and RS form (A from registers); and, on the host, the
// card's SM count and the (D, H, S, B) tensor maps that the flash kernels'
// TMA loads read.
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: a tile of R rows (R a multiple of 8) and up to 64 * A bf16 columns
// is A column blocks of 64 columns (128 bytes a row), block c at c * R * 128
// bytes; within a block, row r is at r * 128 and its 16-byte chunk j at
// (j ^ (r % 8)) * 16. Every block is 1024-byte aligned, so the swizzle atom
// (8 rows x 128 bytes) starts at an address whose bits [7, 10) are 0, which
// is what the descriptor's base offset 0 assumes. One tile serves both views:
//   K-major (rows are M or N, columns are K), as Q, K, V and dO in Q K^T:
//     k-step kk (16 columns) starts at (kk / 4) * R * 128 + (kk % 4) * 32;
//     SBO = 1024 bytes between 8-row groups, LBO unused;
//   MN-major (rows are K, columns are N), as K in dS K, V in P V or dO in
//   P^T dO:
//     k-step kk (16 rows) starts at kk * 2048; SBO = 1024 bytes between
//     8-row groups of K, LBO = R * 128 bytes between 64-column blocks of N.
//
// Accumulator layout of wgmma m64nNk16 (f32): thread t of the warpgroup,
// warp w = t / 32, lane = 4 * gr + tq, holds d[4 * j + e] at row
// 16 * w + gr + 8 * (e / 2), column 8 * j + 2 * tq + (e % 2), j < N / 8. The
// RS form's A fragment of a 64 x 16 bf16 tile has the same row and column
// map as two neighbouring 8-column accumulator blocks, so an f32
// accumulator of columns [16 kk, 16 kk + 16) rounded to bf16 pairwise is the
// A operand of k-step kk (acc_to_a): how P and dS feed the next product
// without leaving registers, as FlashAttention-3 does.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` more of TMA transactions in this phase, without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait of more than
// 2^35 cycles (about 20 s) can only be a fault in the pipeline: trap, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// -- TMA ----------------------------------------------------------------------

// a 4-D box of `map` at coordinates {c0, c1, c2, c3} (innermost first) into
// shared memory at dst; completes `bar`'s transaction count by the box's bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023) & ~1023u) - s);
}

// rows [row0, row0 + ROWS) of one (batch, head) of a (D, H, S, B) map, all
// ATOMS column blocks of 64, into a tile of ROWS rows
template <int ATOMS, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* tile, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h, int b) {
#pragma unroll
  for (int c = 0; c < ATOMS; ++c) tma_load_4d(tile + c * ROWS * 128, map, bar, 64 * c, h, row0, b);
}

// -- thread-block clusters ------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives (its shared-memory
// writes released) ...
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// ... and waits for all the others (their writes acquired)
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float2 at `p` in this block's shared memory, read from the same
// address in the shared memory of cluster block `rank`
__device__ __forceinline__ float2 ld_cluster_f2(const float2* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// -- wgmma --------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// k-step kk of a tile read K-major (see the header)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16, 1024);
}

// k-step kk of a tile read MN-major (see the header)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this warpgroup's wgmma groups are pending, n a
// run-time value in [0, 7] (wait_group takes an immediate)
__device__ __forceinline__ void wgmma_wait_upto(int n) {
  switch (n) {
    case 0: wgmma_wait<0>(); break;
    case 1: wgmma_wait<1>(); break;
    case 2: wgmma_wait<2>(); break;
    case 3: wgmma_wait<3>(); break;
    case 4: wgmma_wait<4>(); break;
    case 5: wgmma_wait<5>(); break;
    case 6: wgmma_wait<6>(); break;
    default: wgmma_wait<7>(); break;
  }
}

// Named barriers of `count` threads (a multiple of 32; id 0 is __syncthreads):
// sync waits for all `count` arrivals, its own included; arrive counts one
// and goes on. Both order shared-memory writes before them for the threads
// that sync.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// This thread's warpgroup, read from lane 0 so that the compiler knows it is
// the same across the warp: wgmma in a branch on it is then not serialized
// as code on a divergent path
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// Shared-memory writes of this thread (the generic proxy) made visible to
// later wgmma reads of them (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it: call after wgmma_wait, before use.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU, subnormal results flushed to 0 (P below 2^-126 is 0 here)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f32 accumulator columns [16 kk, 16 kk + 16) -> the RS form's A fragment
__device__ __forceinline__ void acc_to_a(const float* d, int kk, uint32_t* a) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Operand lists of the wgmma asm below: "%0, ..., %9" (WG_R10()), "%10, ...,
// %19" (WG_R10(1)), ...; "+f"(d[i]) ... for the accumulator.
#define WG_R10(t)                                                                         \
  "%" #t "0, %" #t "1, %" #t "2, %" #t "3, %" #t "4, %" #t "5, %" #t "6, %" #t "7, %" #t \
  "8, %" #t "9"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(i) WG_F4(i), WG_F4(i + 4)
#define WG_F16(i) WG_F8(i), WG_F8(i + 8)
#define WG_F20(i) WG_F16(i), WG_F4(i + 16)
#define WG_F40(i) WG_F20(i), WG_F20(i + 20)

// D(64 x N, f32) = A(64 x 16) B(16 x N) + (scale_d ? D : 0), bf16 operands.
// SS: A and B from shared memory, K-major unless TRANS_A / TRANS_B is 1 (then
// read MN-major: A's 64 rows, or B's N columns, contiguous in a tile row;
// N = 32 and 128 take them).
template <int N, int TRANS_A = 0, int TRANS_B = 0>
struct WgmmaSS;

template <int TRANS_A, int TRANS_B>
struct WgmmaSS<32, TRANS_A, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, uint64_t a, uint64_t b, int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" WG_R10() ", %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : WG_F16(0)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
#endif
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float* d, uint64_t a, uint64_t b, int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) ", " WG_R10(2) ", %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_F16(0), WG_F16(16)
        : "l"(a), "l"(b), "r"(scale_d));
#endif
  }
};

template <int TRANS_A, int TRANS_B>
struct WgmmaSS<128, TRANS_A, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, uint64_t a, uint64_t b, int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) ", " WG_R10(2) ", " WG_R10(3) ", " WG_R10(4) ", " WG_R10(5)
        ", %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WG_F40(0), WG_F20(40), WG_F4(60)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
#endif
  }
};

// RS: A (64 x 16 bf16) from registers, B from shared memory; TRANS_B = 1
// reads B MN-major.
template <int N, int TRANS_B>
struct WgmmaRS;

template <int TRANS_B>
struct WgmmaRS<40, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t b,
                                             int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
        : WG_F20(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
#endif
  }
};

template <int TRANS_B>
struct WgmmaRS<80, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t b,
                                             int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) ", " WG_R10(2) ", " WG_R10(3) "}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : WG_F40(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
#endif
  }
};

template <int TRANS_B>
struct WgmmaRS<128, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t b,
                                             int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) ", " WG_R10(2) ", " WG_R10(3) ", " WG_R10(4) ", " WG_R10(5)
        ", %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WG_F40(0), WG_F20(40), WG_F4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
#endif
  }
};

template <int TRANS_B>
struct WgmmaRS<160, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t b,
                                             int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) ", " WG_R10(2) ", " WG_R10(3) ", " WG_R10(4) ", " WG_R10(5)
        ", " WG_R10(6) ", " WG_R10(7) "}, {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
        : WG_F40(0), WG_F40(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
#endif
  }
};

template <int TRANS_B>
struct WgmmaRS<256, TRANS_B> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t b,
                                             int scale_d) {
#ifdef __CUDA_ARCH__  // the host compiler caps asm operands at 30
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" WG_R10() ", " WG_R10(1) ", " WG_R10(2) ", " WG_R10(3) ", " WG_R10(4) ", " WG_R10(5)
        ", " WG_R10(6) ", " WG_R10(7) ", " WG_R10(8) ", " WG_R10(9) ", " WG_R10(10) ", "
        WG_R10(11) ", %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : WG_F40(0), WG_F40(40), WG_F40(80), WG_F8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
#endif
  }
};

#undef WG_R10
#undef WG_F4
#undef WG_F8
#undef WG_F16
#undef WG_F20
#undef WG_F40

// -- host side ------------------------------------------------------------------

// SMs of the current device, read once a device (launch plans size their
// grids by it); 0 if the runtime cannot say
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] <= 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (D, H, S, B) map of a bf16 (B, S, H, D) tensor at `ptr` with element
// strides {batch, seq, head} (D unit-stride), in boxes of 64 columns x `rows`
// rows of one head, 128-byte swizzle; TMA zero-fills rows past S and columns
// past D. False if cuTensorMapEncodeTiled refuses it.
inline bool encode_bshd(CUtensorMap* map, const void* ptr, const long long* strides, int B,
                        int S, int H, int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
