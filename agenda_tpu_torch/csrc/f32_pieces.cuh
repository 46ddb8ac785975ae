// The f32 kernels' arithmetic on the Hopper tensor cores (flash_fwd_f32.cu,
// flash_bwd_f32_wide.cu): the tensor cores take no f32 operand, so each f32
// value is split into three bf16 pieces, x = b0 + b1 + b2 with b0 = bf16(x),
// b1 = bf16(x - b0), b2 = bf16(x - b0 - b1): 24 significant bits, as in f32,
// and the sum is exact (the remainders are exact in f32). A product is the
// six piece products with i + j <= 2 (the three dropped ones lie below 2^-25
// of it), added smallest first.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace f32pieces {

// x = b[0] + b[1] + b[2], each a bf16, the remainders exact in f32
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&b)[3]) {
  b[0] = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(b[0]);
  b[1] = __float2bfloat16_rn(r);
  r -= __bfloat162float(b[1]);
  b[2] = __float2bfloat16_rn(r);
}

// the pieces of x and y as three bf16 pairs, x in the low half: the RS
// form's A registers, or two neighbouring elements of a piece plane
__device__ __forceinline__ void split3_pair(float x, float y, uint32_t (&a)[3]) {
  __nv_bfloat16 bx[3], by[3];
  split3(x, bx);
  split3(y, by);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    __nv_bfloat162 v = __halves2bfloat162(bx[i], by[i]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// The six piece pairs (i, j) with i + j <= 2, smallest first: (2, 0), (1, 1),
// (0, 2), (1, 0), (0, 1), (0, 0); pair pr's piece of A and of B
__host__ __device__ constexpr int piece_a(int pr) { return pr == 0 ? 2 : pr == 1 || pr == 3; }
__host__ __device__ constexpr int piece_b(int pr) { return pr == 2 ? 2 : pr == 1 || pr == 4; }

}  // namespace f32pieces
