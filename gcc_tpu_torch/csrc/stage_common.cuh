// Pieces shared by the MobileResnet stage kernels (kernel B2) of
// mobile_block.cu (fp32) and mobile_block_bf16.cu (bf16): the block size,
// InstanceNorm's eps, the reflect index, fixed-order block sums and the
// ordered sum of split-k partials. Each library is one translation unit.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block, in every stage kernel
constexpr float kEps = 1e-5f;  // torch InstanceNorm2d default
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The sums over a block of NT threads of K values at once, returned to every
// thread in v: a shuffle tree per value, then one exchange through shared
// memory (sh: NT / 32 * K floats). Fixed association order, so the results
// repeat from run to run.
template <int K, int NT = kThreads>
__device__ void block_sums(float (&v)[K], float* sh) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  __syncthreads();  // sh may still be read by a previous call
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sh[(threadIdx.x >> 5) * K + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) t += sh[w * K + k];
    v[k] = t;
  }
}

// Sum of v over a block of NT threads (sh: NT / 32 floats).
template <int NT = kThreads>
__device__ float block_sum(float v, float* sh) {
  float t[1] = {v};
  block_sums<1, NT>(t, sh);
  return t[0];
}

// out[i] = sum over z of part[z * N + i] in a fixed order: warp w of a block
// sums z in [w Z / 8, (w + 1) Z / 8) for 32 neighbouring i, then warp 0 adds
// the eight warp sums in order. No atomics: the bits repeat.
__global__ void __launch_bounds__(kThreads) sum_partials_kernel(
    const float* __restrict__ part, float* __restrict__ out, int Z,
    long long N) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sh[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < N)
    for (int z = warp * Z / kWarps; z < (warp + 1) * Z / kWarps; ++z)
      s += part[z * N + i];
  sh[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sh[w][lane];
    out[i] = t;
  }
}

int sum_partials(const float* part, float* out, int Z, long long N,
                 cudaStream_t st) {
  sum_partials_kernel<<<(unsigned)((N + 31) / 32), kThreads, 0, st>>>(
      part, out, Z, N);
  return (int)cudaGetLastError();
}

}  // namespace
