// Train-mode BatchNorm2d on bf16 NCHW activations for Hopper (sm_90a):
// the batch statistics, the normalisation and its backward in two launches
// each way, fp32 arithmetic, bf16 in and out.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses its elementwise chain on the TPU. In eager PyTorch that chain
// (ops/layers.py BatchNorm.forward on bf16: x.float(), mean, square, mean,
// sub, mul, add, .to(bf16)) is 18 launches and ~52 bytes an element forward,
// and its autograd backward 25 launches and ~120 bytes an element, with fp32
// copies of the activation saved between them. In the pix2pix U-Net
// iteration at batch 128 that was ~686 GB an iteration, about 61 % of the
// traffic outside the convolutions. Here the forward moves 6 bytes an
// element (x read for the statistics, x read and y written to normalise)
// and the backward 10 (x and g read for the two sums, read again and dx
// written): both are bound by the card's memory bandwidth, 3.35 TB/s.
//
// Arithmetic (ops/batch_norm.py's plain versions repeat it in PyTorch):
//  * statistics in fp32 from the bf16 values: mean = sum x / n,
//    var = sum x^2 / n - mean^2 (the JAX package's one-pass form for bf16),
//    invstd = rsqrt(var + eps);
//  * y = (x - mean) * (invstd * w) + b, each step rounded in fp32 (no
//    contraction, as the elementwise chain it replaces), rounded once to
//    bf16;
//  * running statistics, where asked: r <- keep r + momentum batch, the
//    variance unbiased by n / (n - 1);
//  * backward, x-hat = (x - mean) invstd recomputed from the saved bf16 x:
//    dx = (w invstd) ((g - sum g / n) - x-hat sum(g x-hat) / n), rounded once
//    to bf16; dw = sum g x-hat, db = sum g.
//
// Design. A channel's elements are its N planes of HW values, which lie
// apart (plane b at (b C + c) HW). Each plane is read in 16-byte slots of
// eight bf16 values at 16-byte aligned addresses: slot v of plane b starts
// at element 8 ((start_b >> 3) + v), so a plane whose HW is no multiple of 8
// (the PatchGAN's 31 x 31) takes a head and a tail slot that it shares with
// its neighbours; their values outside the plane are masked, and the stores
// of such a slot go element by element. A channel has N * vmax slots
// (vmax = HW / 8, or (HW + 14) / 8 where planes are not all aligned), and
// the grid is (splits, C): block (s, c) takes the s-th of `splits` equal
// runs of its channel's slots, consecutive threads on consecutive slots, so
// a plane of 4 values and one of 16,384 take the same vector path, and
// small planes spread over the threads of a block instead of one plane to
// a block. The split count (ops/batch_norm.py) fills the SMs with at most
// the eight blocks each holds at once where the channels are few (a
// partial second wave cost ~30 % at the U-Net's up_norm_1), with at least
// 1024 slots a block. A full slot takes an unmasked path.
//  1. gcc_bn_stats_bf16 writes each block's (sum x, sum x^2) to
//     part[(c splits + s) 2 + {0, 1}].
//  2. gcc_bn_apply_bf16: every block sums its channel's partials in the
//     same fixed order (warp 0: lane l takes s = l, l + 32, ..., then a
//     shuffle tree), derives the statistics and normalises its run; block
//     (0, c) also writes mean and invstd for the backward and moves the
//     running statistics.
//  3. gcc_bn_grad_stats_bf16: partial (sum g, sum g x-hat) over the same runs.
//  4. gcc_bn_grad_apply_bf16: the same ordered sums; dx over the run, and
//     block (0, c) writes dw and db where they are asked for.
// No atomics: the bits repeat from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;

// The eight fp32 values of a 16-byte slot of bf16.
__device__ __forceinline__ void unpack(const bf16* p, float (&f)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stores the values [lo, hi) of a slot: one 16-byte store where it is
// whole, else element by element (the rest belongs to other planes).
__device__ __forceinline__ void store(bf16* p, const float (&f)[8], int lo,
                                      int hi) {
  if (lo == 0 && hi == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k >= lo && k < hi) p[k] = __float2bfloat16_rn(f[k]);
  }
}

// Calls f(e0, lo, hi) for each slot of block (s, c)'s run that touches its
// plane, thread t taking the run's slots t, t + kThreads, ...: e0 is the
// slot's first element (an index into the tensor, a multiple of 8) and
// [lo, hi) the range of its eight values that lie in the plane. The run is
// the s-th of `splits` equal parts of the channel's N * vmax slots; slot j
// is slot v = j mod vmax of plane b = j / vmax, whose values start at
// element (b C + c) HW. One division a thread: the plane and the slot then
// advance by kThreads slots at a time.
template <class F>
__device__ __forceinline__ void for_slots(int N, int C, int HW, int vmax,
                                          int splits, F f) {
  const unsigned slots = (unsigned)N * vmax;
  const unsigned j1 =
      (unsigned)((unsigned long long)slots * (blockIdx.x + 1) / splits);
  unsigned j = (unsigned)((unsigned long long)slots * blockIdx.x / splits) +
               threadIdx.x;
  if (j >= j1) return;
  const unsigned uv = (unsigned)vmax, b = j / uv;
  unsigned v = j - b * uv;
  const unsigned q = kThreads / uv, r = kThreads - q * uv;
  const long long plane = (long long)C * HW, step = q * plane;
  long long start = b * plane + (long long)blockIdx.y * HW;
  for (; j < j1; j += kThreads) {
    const long long end = start + HW, e0 = ((start >> 3) + v) << 3;
    if (e0 < end)
      f(e0, start > e0 ? (int)(start - e0) : 0,
        end - e0 < 8 ? (int)(end - e0) : 8);
    v += r;
    start += step;
    if (v >= uv) {
      v -= uv;
      start += plane;
    }
  }
}

// The sums of v over a block of kThreads threads, to thread 0: a shuffle
// tree a warp, then the warps in order.
__device__ __forceinline__ void block_sums2(float (&v)[2]) {
  __shared__ float sh[kThreads / 32][2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if ((threadIdx.x & 31) == 0) {
    sh[threadIdx.x >> 5][0] = v[0];
    sh[threadIdx.x >> 5][1] = v[1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      a += sh[w][0];
      b += sh[w][1];
    }
    v[0] = a;
    v[1] = b;
  }
}

// Channel c's two sums over its `splits` partials, in a fixed order, to
// every thread of the block (through sh).
__device__ __forceinline__ void channel_sums(const float* __restrict__ part,
                                             int splits, float (&t)[2]) {
  __shared__ float sh[2];
  if (threadIdx.x < 32) {
    const float* p = part + (size_t)blockIdx.y * splits * 2;
    float a = 0.f, b = 0.f;
    for (int s = threadIdx.x; s < splits; s += 32) {
      a += p[2 * s];
      b += p[2 * s + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (threadIdx.x == 0) {
      sh[0] = a;
      sh[1] = b;
    }
  }
  __syncthreads();
  t[0] = sh[0];
  t[1] = sh[1];
}

__global__ void __launch_bounds__(kThreads) gcc_bn_stats_bf16(
    const bf16* __restrict__ x, float* __restrict__ part, int N, int C,
    int HW, int vmax, int splits) {
  float v[2] = {0.f, 0.f};
  for_slots(N, C, HW, vmax, splits, [&](long long e0, int lo, int hi) {
    float f[8];
    unpack(x + e0, f);
    if (lo == 0 && hi == 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[0] += f[k];
        v[1] = fmaf(f[k], f[k], v[1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k >= lo && k < hi) {
          v[0] += f[k];
          v[1] = fmaf(f[k], f[k], v[1]);
        }
    }
  });
  block_sums2(v);
  if (threadIdx.x == 0) {
    float* p = part + ((size_t)blockIdx.y * splits + blockIdx.x) * 2;
    p[0] = v[0];
    p[1] = v[1];
  }
}

__global__ void __launch_bounds__(kThreads) gcc_bn_apply_bf16(
    const bf16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ part,
    bf16* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ invstd_out, float* __restrict__ rmean,
    float* __restrict__ rvar, int N, int C, int HW, int vmax, int splits,
    float eps, float keep, float momentum, float unbias) {
  const int c = blockIdx.y;
  float t[2];
  channel_sums(part, splits, t);
  const float n = (float)N * (float)HW;
  const float mean = __fdiv_rn(t[0], n);
  const float var = __fsub_rn(__fdiv_rn(t[1], n), __fmul_rn(mean, mean));
  const float invstd = rsqrtf(__fadd_rn(var, eps));
  const float scale = __fmul_rn(invstd, w[c]), shift = bias[c];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    mean_out[c] = mean;
    invstd_out[c] = invstd;
    if (rmean != nullptr) {
      rmean[c] =
          __fadd_rn(__fmul_rn(rmean[c], keep), __fmul_rn(momentum, mean));
      rvar[c] = __fadd_rn(__fmul_rn(rvar[c], keep),
                          __fmul_rn(momentum, __fmul_rn(var, unbias)));
    }
  }
  for_slots(N, C, HW, vmax, splits, [&](long long e0, int lo, int hi) {
    float f[8];
    unpack(x + e0, f);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      f[k] = __fadd_rn(__fmul_rn(__fsub_rn(f[k], mean), scale), shift);
    store(y + e0, f, lo, hi);
  });
}

__global__ void __launch_bounds__(kThreads) gcc_bn_grad_stats_bf16(
    const bf16* __restrict__ g, const bf16* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    float* __restrict__ part, int N, int C, int HW, int vmax, int splits) {
  const float m = mean[blockIdx.y], r = invstd[blockIdx.y];
  float v[2] = {0.f, 0.f};
  for_slots(N, C, HW, vmax, splits, [&](long long e0, int lo, int hi) {
    float gf[8], xf[8];
    unpack(g + e0, gf);
    unpack(x + e0, xf);
    if (lo == 0 && hi == 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[0] += gf[k];
        v[1] = fmaf(gf[k], __fmul_rn(__fsub_rn(xf[k], m), r), v[1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k >= lo && k < hi) {
          v[0] += gf[k];
          v[1] = fmaf(gf[k], __fmul_rn(__fsub_rn(xf[k], m), r), v[1]);
        }
    }
  });
  block_sums2(v);
  if (threadIdx.x == 0) {
    float* p = part + ((size_t)blockIdx.y * splits + blockIdx.x) * 2;
    p[0] = v[0];
    p[1] = v[1];
  }
}

__global__ void __launch_bounds__(kThreads) gcc_bn_grad_apply_bf16(
    const bf16* __restrict__ g, const bf16* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ w, const float* __restrict__ part,
    bf16* __restrict__ dx, float* __restrict__ dw, float* __restrict__ db,
    int N, int C, int HW, int vmax, int splits) {
  const int c = blockIdx.y;
  float t[2];
  channel_sums(part, splits, t);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (db != nullptr) db[c] = t[0];
    if (dw != nullptr) dw[c] = t[1];
  }
  if (dx == nullptr) return;
  const float n = (float)N * (float)HW;
  const float m = mean[c], r = invstd[c];
  const float mg = __fdiv_rn(t[0], n), mgx = __fdiv_rn(t[1], n);
  const float k = __fmul_rn(w[c], r);
  for_slots(N, C, HW, vmax, splits, [&](long long e0, int lo, int hi) {
    float gf[8], xf[8];
    unpack(g + e0, gf);
    unpack(x + e0, xf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xh = __fmul_rn(__fsub_rn(xf[i], m), r);
      gf[i] = __fmul_rn(k, __fsub_rn(__fsub_rn(gf[i], mg), __fmul_rn(xh, mgx)));
    }
    store(dx + e0, gf, lo, hi);
  });
}

// Slots a plane: HW / 8 where every plane starts on a 16-byte boundary,
// else the most slots HW values can touch, ceil((HW + 7) / 8).
int slots_a_plane(int HW) { return HW % 8 == 0 ? HW / 8 : (HW + 14) / 8; }

}  // namespace

extern "C" {

// Forward of train-mode BatchNorm: x (N,C,H,W) bf16, 16-byte aligned;
// w, b (C) fp32. Writes y (N,C,H,W) bf16 and mean, invstd (C) fp32, and,
// where rmean is not null, moves rmean and rvar (C) fp32 in place. part:
// scratch of C * splits * 2 floats.
int gcc_bn_fwd_bf16(const bf16* x, const float* w, const float* b,
                    float* rmean, float* rvar, bf16* y, float* mean,
                    float* invstd, float* part, int N, int C, int HW,
                    int splits, float eps, float keep, float momentum,
                    float unbias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vmax = slots_a_plane(HW);
  const dim3 grid(splits, C);
  gcc_bn_stats_bf16<<<grid, kThreads, 0, st>>>(x, part, N, C, HW, vmax,
                                                splits);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  gcc_bn_apply_bf16<<<grid, kThreads, 0, st>>>(
      x, w, b, part, y, mean, invstd, rmean, rvar, N, C, HW, vmax, splits,
      eps, keep, momentum, unbias);
  return (int)cudaGetLastError();
}

// Backward: g, x (N,C,H,W) bf16, 16-byte aligned; mean, invstd, w (C)
// fp32. Writes dx (N,C,H,W) bf16 and dw, db (C) fp32, each where it is not
// null. part: scratch of C * splits * 2 floats.
int gcc_bn_bwd_bf16(const bf16* g, const bf16* x, const float* mean,
                    const float* invstd, const float* w, bf16* dx, float* dw,
                    float* db, float* part, int N, int C, int HW, int splits,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vmax = slots_a_plane(HW);
  const dim3 grid(splits, C);
  gcc_bn_grad_stats_bf16<<<grid, kThreads, 0, st>>>(g, x, mean, invstd, part,
                                                     N, C, HW, vmax, splits);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  gcc_bn_grad_apply_bf16<<<grid, kThreads, 0, st>>>(
      g, x, mean, invstd, w, part, dx, dw, db, N, C, HW, vmax, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
