// bf16 tensor-core fragments shared by the kernels that run dots on
// mma.sync (triples_resident.cu, triples_probe.cu).
//
// mma.sync m16n8k16, A row-major, B column-major, bf16 in, fp32
// accumulate.  A 32-bit register holds two bf16 values, the lower k in the
// low half.  With lane = 4 g + t, the fragments are
//   A: a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//      a[2] = A[g][2t+8..+9],   a[3] = A[g+8][2t+8..+9];
//   B: b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..+9][g];
//   C: c[e] = C[g + 8 (e >> 1)][2t + (e & 1)].
// The bf16x3 ("split") product forms each operand's pair hi = rn(x),
// lo = rn(x - hi) and sums hi.hi + hi.lo + lo.hi, the function of the JAX
// package's bf16x3 (HIGH) matmul precision; bf16 takes hi.hi.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// the bf16 (hi, lo) pairs of two consecutive values, packed
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0)
       | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0)
       | ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

// c += a . b on one 16 x 8 x 16 tile
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mma
