// Fused MobileResnet separable-conv stage for Hopper (sm_90a), fp32, NCHW.
//
// One stage is  y = IN(pw1x1(IN(dw3x3(reflectpad1(x))))) [relu] [+ res]
// with affine-free InstanceNorm (eps 1e-5, two-pass statistics in fp32).
// Conv biases are inert (every conv feeds an affine-free IN) and are not read.
//
// Replaces the three Pallas kernels of gcc_tpu/ops/pallas/mobile_block.py:
//   gcc_stage_fwd     <- _stage_fwd_kernel     (:155, pallas_call :286)
//   gcc_stage_bwd_pw  <- _stage_bwd_pw_kernel  (:187, pallas_call :324)
//   gcc_stage_bwd_dw  <- _stage_bwd_dw_kernel  (:220, pallas_call :345)
// Each entry point is one TPU kernel's function and issues several launches.
//
// What bounds it on the card. The stage's one real product is the pointwise
// conv, a (M x C) . (C x H*W) matrix product per sample: at the teacher's
// C = M = 256 it does 2*B*H*W*C*M flops against ~2 bytes/flop of activations,
// so the stage is bound by fp32 operations (67 TFLOP/s outside the tensor
// cores), not by the 3.35 TB/s of HBM. The depthwise conv and both norms are
// bound by bytes.
//
// What the design does about it, and where it leaves the TPU design:
//  * The TPU program holds one whole sample (up to 64x64x256 f32, 4 MB) in
//    VMEM; a Hopper block has 227 KB. InstanceNorm over the full plane is
//    therefore split by plane: one block per (sample, channel) plane runs the
//    depthwise conv and both passes of the norm over its own plane, re-reading
//    it from L2; the pointwise product is a separate tiled shared-memory SGEMM
//    (64x64 tiles, 16-deep k, 4x4 outputs a thread) whose output plane is then
//    normalised by a third per-plane kernel. Several launches per TPU kernel.
//  * Channels are not padded to 128 (a TPU lane artefact): the SGEMM masks its
//    ragged edges, so the student's widths 24/48/72/112 run as they are.
//  * The TPU accumulates dW over its sequential batch grid. CUDA blocks run in
//    no order, so every weight gradient is written as per-(sample, k-chunk)
//    partials and summed in a fixed order by sum_partials_kernel. No float
//    atomics: results repeat bit for bit from run to run.
//  * The backward saves the normalised intermediates a-hat, b-hat and the two
//    per-plane 1/std vectors in the forward instead of recomputing the stage
//    (the TPU recomputes to stay inside VMEM; device memory is ample here).
//  * The pointwise product runs on the fp32 CUDA cores. wgmma/TMA tiles (and
//    bf16) are later work; this first kernel is the simple one that is right.
//
// Every entry point returns cudaGetLastError() as an int; the Python wrapper
// raises when it is not 0. Nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // every kernel here is launched with 256 threads
constexpr float kEps = 1e-5f;  // torch InstanceNorm2d default
constexpr int BM = 64, BN = 64, BK = 16;

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Sum of v over the block, returned to every thread. Fixed association
// order, so the result repeats from run to run. sh holds kThreads/32 floats.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // sh may still be read by a previous block_sum
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += sh[w];
  return t;
}

// One block per (b, c) plane: a = dw3x3(reflectpad1(x)), then a-hat = IN(a)
// written in place of a, and 1/std of the plane.
__global__ void __launch_bounds__(kThreads) dw_in_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dw,
    float* __restrict__ ahat, float* __restrict__ rstd, int C, int H, int W) {
  __shared__ float sh[kThreads / 32];
  const int plane = blockIdx.x, c = plane % C, n = H * W;
  const float* xp = x + (size_t)plane * n;
  float* ap = ahat + (size_t)plane * n;
  float w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = dw[c * 9 + t];
  float s = 0.f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int i = p / W, j = p - (p / W) * W;
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const float* row = xp + (size_t)reflect1(i + di - 1, H) * W;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc += row[reflect1(j + dj - 1, W)] * w[di * 3 + dj];
    }
    ap[p] = acc;
    s += acc;
  }
  const float mean = block_sum(s, sh) / n;
  float v = 0.f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float d = ap[p] - mean;
    v += d * d;
  }
  const float r = 1.f / sqrtf(block_sum(v, sh) / n + kEps);
  for (int p = threadIdx.x; p < n; p += kThreads) ap[p] = (ap[p] - mean) * r;
  if (threadIdx.x == 0) rstd[plane] = r;
}

// One block per (b, m) plane: b-hat = IN(b) in place, 1/std, and
// y = [relu](b-hat) [+ res].
__global__ void __launch_bounds__(kThreads) in_fwd_kernel(
    float* __restrict__ bh, float* __restrict__ rstd,
    const float* __restrict__ res, float* __restrict__ y, int n, int relu) {
  __shared__ float sh[kThreads / 32];
  const size_t off = (size_t)blockIdx.x * n;
  float* bp = bh + off;
  float s = 0.f;
  for (int p = threadIdx.x; p < n; p += kThreads) s += bp[p];
  const float mean = block_sum(s, sh) / n;
  float v = 0.f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float d = bp[p] - mean;
    v += d * d;
  }
  const float r = 1.f / sqrtf(block_sum(v, sh) / n + kEps);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float t = (bp[p] - mean) * r;
    bp[p] = t;
    float o = relu ? fmaxf(t, 0.f) : t;
    if (res != nullptr) o += res[off + p];
    y[off + p] = o;
  }
  if (threadIdx.x == 0) rstd[blockIdx.x] = r;
}

// One block per plane: backward of t-hat = IN(t) given the upstream g (masked
// by t-hat > 0 when relu), out = r * (g - mean(g) - t-hat * mean(g * t-hat)).
__global__ void __launch_bounds__(kThreads) in_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ that,
    const float* __restrict__ rstd, float* __restrict__ out, int n, int relu) {
  __shared__ float sh[kThreads / 32];
  const size_t off = (size_t)blockIdx.x * n;
  float s1 = 0.f, s2 = 0.f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float t = that[off + p];
    const float gg = (relu && !(t > 0.f)) ? 0.f : g[off + p];
    s1 += gg;
    s2 += gg * t;
  }
  const float gm = block_sum(s1, sh) / n;
  const float gym = block_sum(s2, sh) / n;
  const float r = rstd[blockIdx.x];
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float t = that[off + p];
    const float gg = (relu && !(t > 0.f)) ? 0.f : g[off + p];
    out[off + p] = r * (gg - gm - t * gym);
  }
}

// One block per (b, c) plane, given ga = d(loss)/d(a):
//  gx = reflect-pad adjoint of the transposed depthwise conv of ga, gathered
//       per output pixel (a padded row pi maps to x row i = pi-1, and rows 0
//       and H+1 fold onto rows 1 and H-2; columns likewise), and
//  gdw_part[plane, tap] = sum over the plane of ga * (tap-shifted padded x).
__global__ void __launch_bounds__(kThreads) dw_bwd_kernel(
    const float* __restrict__ ga, const float* __restrict__ x,
    const float* __restrict__ dw, float* __restrict__ gx,
    float* __restrict__ gdw_part, int C, int H, int W) {
  __shared__ float sh[kThreads / 32];
  const int plane = blockIdx.x, c = plane % C, n = H * W;
  const float* gp = ga + (size_t)plane * n;
  const float* xp = x + (size_t)plane * n;
  float w[9], acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    w[t] = dw[c * 9 + t];
    acc[t] = 0.f;
  }
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int i = p / W, j = p - (p / W) * W;
    const float gij = gp[p];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const float* row = xp + (size_t)reflect1(i + di - 1, H) * W;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc[di * 3 + dj] += gij * row[reflect1(j + dj - 1, W)];
    }
    int pr[3], pc[3], nr = 0, nc = 0;
    pr[nr++] = i + 1;
    if (i == 1) pr[nr++] = 0;
    if (i == H - 2) pr[nr++] = H + 1;
    pc[nc++] = j + 1;
    if (j == 1) pc[nc++] = 0;
    if (j == W - 2) pc[nc++] = W + 1;
    float g = 0.f;
    for (int a = 0; a < nr; ++a)
      for (int di = 0; di < 3; ++di) {
        const int r = pr[a] - di;
        if (r < 0 || r >= H) continue;
        for (int b = 0; b < nc; ++b)
          for (int dj = 0; dj < 3; ++dj) {
            const int q = pc[b] - dj;
            if (q < 0 || q >= W) continue;
            g += w[di * 3 + dj] * gp[r * W + q];
          }
      }
    gx[(size_t)plane * n + p] = g;
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float tot = block_sum(acc[t], sh);
    if (threadIdx.x == 0) gdw_part[(size_t)plane * 9 + t] = tot;
  }
}

// Strided batched SGEMM with split-k: for block z = zb * splits + s,
//   Cm[z](i, j) = sum_{k in chunk s} A[zb](i, k) * B[zb](k, j).
// Operands are addressed through strides, so one kernel serves the forward
// product, d(a-hat) (A transposed) and dW (B transposed). Shared-memory
// tiles are BM x BK and BK x BN; each thread owns a 4x4 block of outputs.
__global__ void __launch_bounds__(kThreads) sgemm_kernel(
    int I, int J, int K, int k_chunk, int splits,
    const float* __restrict__ A, long long a_i, long long a_k, long long a_z,
    const float* __restrict__ B, long long b_k, long long b_j, long long b_z,
    float* __restrict__ Cm, long long c_i, long long c_j, long long c_z) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int zb = blockIdx.z / splits, s = blockIdx.z - zb * splits;
  const int k_begin = s * k_chunk, k_end = min(K, k_begin + k_chunk);
  A += zb * a_z;
  B += zb * b_z;
  Cm += blockIdx.z * c_z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // neighbouring threads load along whichever index is contiguous in memory
  const bool a_kfast = a_k == 1, b_jfast = b_j == 1;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += kThreads) {
      const int ii = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      const int gi = i0 + ii, gk = k0 + kk;
      As[kk][ii] = (gi < I && gk < k_end) ? A[gi * a_i + gk * a_k] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
      const int jj = b_jfast ? e % BN : e / BK;
      const int kk = b_jfast ? e / BN : e % BK;
      const int gj = j0 + jj, gk = k0 + kk;
      Bs[kk][jj] = (gj < J && gk < k_end) ? B[gk * b_k + gj * b_j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = Bs[kk][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gi = i0 + ty + 16 * r, gj = j0 + tx + 16 * q;
      if (gi < I && gj < J) Cm[gi * c_i + gj * c_j] = acc[r][q];
    }
}

// out[i] = sum_z part[z * N + i], z in increasing order (deterministic).
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int Z,
                                    long long N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float s = 0.f;
  for (int z = 0; z < Z; ++z) s += part[z * N + i];
  out[i] = s;
}

int sgemm(int I, int J, int K, int k_chunk, int zb, const float* A,
          long long a_i, long long a_k, long long a_z, const float* B,
          long long b_k, long long b_j, long long b_z, float* Cm,
          long long c_i, long long c_j, long long c_z, cudaStream_t st) {
  const int splits = (K + k_chunk - 1) / k_chunk;
  const dim3 grid((J + BN - 1) / BN, (I + BM - 1) / BM, zb * splits);
  sgemm_kernel<<<grid, kThreads, 0, st>>>(I, J, K, k_chunk, splits, A, a_i,
                                          a_k, a_z, B, b_k, b_j, b_z, Cm, c_i,
                                          c_j, c_z);
  return (int)cudaGetLastError();
}

int sum_partials(const float* part, float* out, int Z, long long N,
                 cudaStream_t st) {
  sum_partials_kernel<<<(unsigned)((N + kThreads - 1) / kThreads), kThreads, 0,
                        st>>>(part, out, Z, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward of one stage. x (B,C,H,W), dw (C,1,3,3), pw (M,C,1,1), res
// (B,M,H,W) or null. Writes y (B,M,H,W) and, for the backward, a-hat
// (B,C,H,W), b-hat (B,M,H,W), 1/std of a (B,C) and of b (B,M).
int gcc_stage_fwd(const float* x, const float* dw, const float* pw,
                  const float* res, float* y, float* ahat, float* bhat,
                  float* rstd_a, float* rstd_b, int B, int C, int M, int H,
                  int W, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)H * W;
  dw_in_fwd_kernel<<<B * C, kThreads, 0, st>>>(x, dw, ahat, rstd_a, C, H, W);
  if (int e = (int)cudaGetLastError()) return e;
  // b[b] (M x n) = pw (M x C) . a-hat[b] (C x n)
  if (int e = sgemm(M, (int)n, C, C, B, pw, C, 1, 0, ahat, n, 1, C * n, bhat,
                    n, 1, M * n, st))
    return e;
  in_fwd_kernel<<<B * M, kThreads, 0, st>>>(bhat, rstd_b, res, y, (int)n,
                                            relu);
  return (int)cudaGetLastError();
}

// Backward, pointwise side: relu + IN2 + pointwise conv. g (B,M,H,W) is
// d(loss)/dy. Writes gah = d(loss)/d(a-hat) (B,C,H,W) and gpw (M,C,1,1).
// Scratch: gb (B,M,H,W); gpw_part (B * ceil(H*W / k_chunk), M, C).
int gcc_stage_bwd_pw(const float* g, const float* ahat, const float* bhat,
                     const float* rstd_b, const float* pw, float* gb,
                     float* gah, float* gpw_part, float* gpw, int B, int C,
                     int M, int H, int W, int relu, int k_chunk,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)H * W;
  in_bwd_kernel<<<B * M, kThreads, 0, st>>>(g, bhat, rstd_b, gb, (int)n, relu);
  if (int e = (int)cudaGetLastError()) return e;
  // gah[b] (C x n) = pw^T (C x M) . gb[b] (M x n)
  if (int e = sgemm(C, (int)n, M, M, B, pw, 1, C, 0, gb, n, 1, M * n, gah, n,
                    1, C * n, st))
    return e;
  // gpw partial [b, s] (M x C) = gb[b] (M x chunk s) . a-hat[b]^T (chunk s x C)
  if (int e = sgemm(M, C, (int)n, k_chunk, B, gb, n, 1, M * n, ahat, 1, n,
                    C * n, gpw_part, C, 1, (long long)M * C, st))
    return e;
  const int splits = (int)((n + k_chunk - 1) / k_chunk);
  return sum_partials(gpw_part, gpw, B * splits, (long long)M * C, st);
}

// Backward, depthwise side: IN1 + depthwise conv + reflect-pad adjoint.
// gah (B,C,H,W) from gcc_stage_bwd_pw. Writes gx (B,C,H,W) and gdw
// (C,1,3,3). Scratch: ga (B,C,H,W); gdw_part (B, C, 9).
int gcc_stage_bwd_dw(const float* gah, const float* ahat, const float* rstd_a,
                     const float* x, const float* dw, float* ga, float* gx,
                     float* gdw_part, float* gdw, int B, int C, int H, int W,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  in_bwd_kernel<<<B * C, kThreads, 0, st>>>(gah, ahat, rstd_a, ga, H * W, 0);
  if (int e = (int)cudaGetLastError()) return e;
  dw_bwd_kernel<<<B * C, kThreads, 0, st>>>(ga, x, dw, gx, gdw_part, C, H, W);
  if (int e = (int)cudaGetLastError()) return e;
  return sum_partials(gdw_part, gdw, B, (long long)C * 9, st);
}

}  // extern "C"
