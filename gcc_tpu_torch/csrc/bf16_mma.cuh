// bf16 tensor-core products, ldmatrix fragments and bf16 storage helpers for
// Hopper (sm_90a), used by mobile_block_bf16.cu, flash_attention_bf16.cu
// and mobile_block.cu's bf16 depthwise backward.
//
// The TPU kernels' bf16 arithmetic: products of bf16 operands, exact in
// fp32, summed in fp32 (the MXU's preferred_element_type=f32). On Hopper
// that is one mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per
// 16 x 8 x 16 block of a product, where split-TF32 takes three m16n8k8.
//
// Fragment layout of m16n8k16 for lane = 4 g + t (each register holds two
// bf16, the lower-indexed element in the low half):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9);
//   B (16 x 8, column-major): b0 (2t..2t+1, g), b1 (2t+8..2t+9, g);
//   C/D (16 x 8, fp32): d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
//                       d3 (g + 8, 2t + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;

// x rounded to bf16 (round to nearest even), as an fp32 value
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ldmatrix: lane l gives the address of row l % 8 of 8x8 matrix l / 8 (16
// bytes a row). Plain: register i of lane 4 g + t holds row g, columns
// 2t, 2t + 1 of matrix i; .trans: rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: one 16 x 8 x 16 product of bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An asynchronous copy of 16 bytes into shared memory; bytes below `bytes`
// (16 or 0) are read, the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

}  // namespace bf16mma
