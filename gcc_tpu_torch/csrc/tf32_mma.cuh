// Split-TF32 tensor-core products and cp.async copies for Hopper (sm_90a),
// shared by flash_attention.cu and mobile_block.cu.
//
// Split-TF32 ("3xTF32"): x = hi + lo, hi = x with the low 13 bits masked,
// lo = (x - hi) masked the same way; a b = lo*hi + hi*lo + hi*hi with fp32
// accumulators, three mma.sync.m16n8k8 .tf32 per product. Plain TF32 keeps
// 10 mantissa bits and misses the port's fp32 bounds (1e-4 for the stage's
// b-hat, 1e-5 max(|ref|, 1) for attention's O, 1e-4 max(|ref|, 1) for its
// gradients); the split product is within a few fp32 roundings of fp32
// (tests/test_torch_attention.py, tests/test_torch_mobile_block.py emulate
// both against float64). Its rate, a third of the 495 TFLOP/s TF32 peak, is
// 165 TFLOP/s against 67 on the fp32 CUDA cores.
//
// Fragment layout of m16n8k8 for lane = 4 g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8, column-major): b0 (t, g), b1 (t + 4, g);
//   C/D (16 x 8): d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
//                 d3 (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x's top 19 bits as a tf32 operand (the low 13 bits of the fp32 masked off)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// The split-TF32 operands of an mma: x = hi + lo, each exact in tf32 up to
// lo's own 13 dropped bits (|lo| < 2^-10 |x|, so the error is < 2^-20 |x|).
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split-TF32: lo*hi + hi*lo + hi*hi (lo*lo, < 2^-20 |ab|, is
// dropped), small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// An asynchronous copy of 16 bytes (vec) or 4 into shared memory; bytes
// below the copy's size are read, the rest of it is zero-filled (0: zeros).
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool vec) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}

// Wait until at most n of this thread's copy groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

}  // namespace tf32x3
