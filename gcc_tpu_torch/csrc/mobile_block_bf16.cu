// Kernel B2's bf16 forward and pointwise backward for Hopper (sm_90a), NCHW:
// the MobileResnet separable-conv stage in the JAX package's default
// --compute_dtype bfloat16,
//
//   y = IN(pw1x1(IN(dw3x3(reflectpad1(x))))) [relu] [+ res]
//
// Replaces, for a bf16 activation, two Pallas kernels of
// gcc_tpu/ops/pallas/mobile_block.py:
//   gcc_stage_fwd_bf16     <- _stage_fwd_kernel     (:155, pallas_call :286)
//   gcc_stage_bwd_pw_bf16  <- _stage_bwd_pw_kernel  (:187, pallas_call :324)
// (the third, _stage_bwd_dw_kernel, is mobile_block.cu's
// gcc_stage_bwd_dw_bf16). x, y, res, g, a-hat, b-hat, d b-hat (gb) and
// d a-hat are bf16 in device memory; the weights, both 1/std vectors and
// dW_pw are fp32.
//
// Arithmetic, rounding for rounding the TPU kernel's (ops/mobile_block.py's
// plain versions repeat it in PyTorch):
//  * a: the nine taps of bf16 x with the fp32 depthwise weight, a row's
//    three products summed left to right, then the three rows,
//    ((t0 + t1) + t2) + ((t3 + t4) + t5) + ((t6 + t7) + t8), with
//    __fmul_rn/__fadd_rn (no contraction): the order XLA sums the TPU
//    kernel's taps in. a rounds to bf16.
//  * InstanceNorm: two-pass fp32 statistics of the rounded values (the mean,
//    then the mean of squared deviations), 1/std = 1 / sqrt(var + 1e-5).
//    a-hat, b, b-hat and y round to bf16; the residual is added to the
//    rounded y and the sum rounded once more.
//  * The pointwise products take the fp32 weight rounded to bf16 (the TPU
//    kernel's pwk.astype(cdt)) and bf16 activations: one m16n8k16 bf16
//    mma.sync per 16 x 8 x 16 block (bf16_mma.cuh), products exact, each
//    16-deep k step into a zeroed fragment added to the fp32 sum (summed
//    straight into one accumulator, the tensor cores' truncations lean one
//    way over C / 16 steps; tests/test_torch_stage_bf16_order.py emulates
//    the order kept).
//  * Backward: the relu test compares b-hat in fp32; gb = r (g - mean(g) -
//    b-hat mean(g b-hat)) and d a-hat round to bf16; dW_pw is an fp32 sum.
//  Only the sums' order differs from the plain versions: the statistics
//  sum pixel by pixel (thread t takes pixels t + 256 u), then by warp tree
//  and warps in order (plane_stats, block_sums), the products by k step.
//
// What bounds it on the card. The function's bytes: at the teacher stage
// (B 4, C = M = 256, 64 x 64) 17.0 MB in the forward (x in, y out: 0.0051
// ms at 3.35 TB/s) and 25.7 MB in the backward-pointwise (0.0077); the port
// also saves a-hat, b-hat and the 1/std vectors in the forward and reads
// them in the backward, ~0.010 ms each. Each product is 2.15 GFLOP, 2.2 us
// at 989 TFLOP/s. The kernels below do not reach either: on an H100 the
// products cost ~1.2 us a 32-deep k tile at the teacher, of which 0.64 us
// stays with the copies and the mma taken out (the ldmatrix fragments and
// the rounding pass through shared memory), where cuBLAS's bf16 product of
// the same shape takes 0.38 (scripts/b2_bf16_probes.py). A wgmma version
// (m64n128k16, A from registers, the weight rounded into core matrices)
// was right but no faster: waiting for each tile's wgmma, or ptxas
// serialising them when the next tile's A registers are loaded under them.
//
// Design, forward (three launches):
//  1. dw_in_fwd_bf16_kernel, one block per (b, c) plane: the plane comes
//     into shared memory by 16-byte cp.async (8 KB at 64 x 64) in two copy
//     groups, the rows of the first vector of each thread first, so their
//     taps are taken while the rest arrives; each thread takes vectors of 8
//     pixels of one row, their taps from the shared plane (16 bytes and two
//     reflected neighbours a kernel row: the reflect frame is read from
//     shared memory where it lies); the rounded a stays in registers (two
//     vectors, 16 pixels a thread at 64 x 64) for the normalise pass, and
//     takes x's place in shared memory for the two statistics passes
//     (plane_stats); a-hat goes out once in 16-byte stores. 128 threads a
//     plane were no faster.
//  2. pw_fwd_bf16_kernel, b[b] (M x n) = pw (M x C) . a-hat[b] (C x n) on
//     m16n8k16 mma.sync: blocks of 128 x 256 outputs (16 warps of 64 x 32,
//     four stages, one block an SM) where those give three quarters of the
//     SMs a block, else 128 x 128 (8 warps, three stages, two blocks an
//     SM); k 32 deep. a-hat's tile and the weight's fp32 tile come by
//     16-byte cp.async, stages - 1 tiles ahead; each thread rounds the
//     weight values it copied into a bf16 tile (no separate launch, no
//     scratch). Fragments by ldmatrix: the weight's [m][k] tile plain,
//     a-hat's [k][n] tile .trans; each k step summed straight into the
//     accumulators. b rounds to bf16 into a shared staging tile and leaves
//     in 16-byte stores.
//  3. in_fwd_bf16_kernel, one block per (b, m) plane: b read once in
//     16-byte loads and held in registers (16 pixels a thread) and, for the
//     statistics, in shared memory; 16-byte loads of the residual, 16-byte
//     stores of b-hat and y.
// Backward-pointwise (three launches; two where dW takes one run):
//  1. in_bwd_bf16_kernel: IN2's backward, g and b-hat in 16-byte loads,
//     in registers and, for the two sums, in shared memory; gb in 16-byte
//     stores.
//  2. pw_bwd_bf16_kernel, both products in one grid, with the forward's
//     tilings: its first blocks sum dW = sum_b gb[b] . a-hat[b]^T (M x C)
//     over runs of k tiles of the (sample, pixel) axis, gb's [m][k] and
//     a-hat's [c][k] tiles by cp.async and ldmatrix (plain); the rest form
//     d a-hat[b] = pw^T . gb[b] as the forward's product does, the weight's
//     [k][m] tile rounded as it loads and read by ldmatrix .trans. The dW
//     runs are sized so that both kinds of blocks finish together
//     (grad_per): at the teacher 32 partials of 256 x 256 (8.4 MB), where
//     a partial per (sample, 256-pixel chunk) made 64.
//  3. sum_partials_kernel: the partials in a fixed order. No float
//     atomics: two calls give the same bits.
// Routes: no shape is refused. Planes whose width is not a multiple of 8,
// planes past 64 x 64 and bases not 16-byte aligned take the plane kernels'
// pixel-by-pixel route (x staged in shared memory while it fits 40 KB, else
// read from device memory at every tap; a and b re-read from device
// memory); rows not a multiple of 8 take element copies in the products,
// and weights whose rows are not a multiple of 4 element loads.
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8; chip_smoke.py
// phase 17 (a) prints them): pw_fwd_bf16_kernel<128>, <256> and
// pw_bwd_bf16_kernel<256> 128 registers, no spills; pw_bwd_bf16_kernel<128>
// 128 with 96 bytes of spill stores; the plane kernels 32-60, none.
//
// Every entry point but the *_partials count returns cudaGetLastError() as
// an int; the Python wrapper raises when it is not 0. Nothing here
// allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "bf16_mma.cuh"
#include "stage_common.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16mma::bf16;
using bf16mma::cp_async16;
using bf16mma::ldsm_x4;
using bf16mma::ldsm_x4_t;
using bf16mma::mma;
using bf16mma::round_bf16;
using tf32x3::cp_commit;
using tf32x3::cp_wait;

constexpr int kVec = 8;  // bf16 in a 16-byte vector
// Threads of a plane kernel's block (128 were no faster on an H100), and
// planes of up to kPlaneMax pixels (64 x 64, the main path's) held in
// registers: kVPT vectors a thread
constexpr int kPlaneThreads = 256;
constexpr int kPlaneMax = 4096;
constexpr int kVPT = kPlaneMax / (kPlaneThreads * kVec);
static_assert(kVPT * kPlaneThreads * kVec == kPlaneMax, "whole vectors");
// bytes of x that the depthwise kernel's pixel route stages in shared memory
constexpr int kStageBytes = 40 * 1024;

// The products' tiles: BM x BN outputs a block, k 32 deep, in a ring of
// stages. bf16 tiles: rows of a [row][k] tile 40 bf16 apart (80 B), of a
// [k][row] tile BM or BN + 8 (272 or 528 B: an odd multiple of 16), so the
// eight 16-byte rows of an ldmatrix phase land on distinct banks and
// cp.async destinations stay 16-byte aligned. The fp32 weight's tiles: rows
// 36 floats apart ([m][k]) or 132 ([k][m]).
constexpr int BM = 128, BK = 32;
constexpr int LDK = BK + 8, LDR = BM + 8, LDWK = BK + 4, LDWR = BM + 4;
constexpr int kTile = BM * LDK;    // bf16: a [row][k] tile, or a [k][m]
constexpr int kWTile = BM * LDWK;  // fp32: the weight's tile
static_assert(BK * LDR <= kTile && BK * LDWR <= kWTile, "tiles fit");
// The dW partials at most this many bytes (grad_per).
constexpr long long kPartialBytes = 8LL << 20;

// A product's tiling. BN 128: 256 threads (8 warps of 64 x 32 outputs),
// three stages, two blocks an SM. BN 256: 512 threads, four stages, one
// block an SM; each tile of the weight (or, in dW, of gb) then serves twice
// the outputs, which cuts what the blocks read from L2 by a third: the
// products are bound by that traffic (about 3 TB/s on an H100).
// weight_product's shared memory: the stages' fp32 weight tiles and
// activation tiles, two bf16 weight tiles; grad_product's: the stages' gb
// and a-hat tiles; the epilogue's bf16 [m][n] staging tile reuses either.
template <int BN>
struct Tiling {
  static constexpr int kThreads = 2 * BN, kWarpsN = BN / 32;
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kBlocksPerSM = BN == 128 ? 2 : 1;
  static constexpr int LDX = BN + 8;         // the activation's [k][n] tile
  static constexpr int kXTile = BK * LDX;    // bf16
  static constexpr int kGTile = BN * LDK;    // bf16: dW's a-hat [c][k] tile
  static constexpr int kWeightSmem =
      kStages * (kWTile * 4 + kXTile * 2) + 2 * kTile * 2;
  static constexpr int kGradSmem = kStages * (kTile + kGTile) * 2;
  static constexpr int kSmem =
      kWeightSmem > kGradSmem ? kWeightSmem : kGradSmem;
  static_assert(BM * LDX * 2 <= kSmem, "the staging tile fits");
  static_assert(kSmem <= 227 * 1024 / kBlocksPerSM, "blocks fit an SM");
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void unpack8(uint4 q, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 floats rounded to bf16, as one 16-byte vector
__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return q;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(bf16* p, uint4 q) {
  *reinterpret_cast<uint4*>(p) = q;
}

// The two-pass statistics (mean, 1/std) of a plane of n <= kPlaneMax
// bf16 values held in shared memory, summed in the order of the pixel-by-
// pixel routes: thread t takes pixels t + u kPlaneThreads in turn, then
// block_sums. The 16-byte routes hold a thread's pixels 8 at a time;
// summed in that order instead, more a-hat, b-hat and gb values round to
// the other bf16 neighbour of the plain versions' on the CPU, and a deep
// network's gradients amplify it (chip_smoke.py phase 18 (e): the CycleGAN
// teacher's gradients 0.77 of the bf16-fp32 spread apart, 0.44 in this
// order).
__device__ __forceinline__ float2 plane_stats(const bf16* vs, int n,
                                              float* sh) {
  constexpr int NT = kPlaneThreads;
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kPlaneMax / NT; ++u) {
    const int p = threadIdx.x + u * NT;
    s += p < n ? __bfloat162float(vs[p]) : 0.f;
  }
  const float mean = block_sum<NT>(s, sh) / n;
  float var = 0.f;
#pragma unroll
  for (int u = 0; u < kPlaneMax / NT; ++u) {
    const int p = threadIdx.x + u * NT;
    const float d = (p < n ? __bfloat162float(vs[p]) : 0.f) - mean;
    if (p < n) var += d * d;
  }
  return make_float2(mean, 1.f / sqrtf(block_sum<NT>(var, sh) / n + kEps));
}

// One block per (b, c) plane: a = dw3x3(reflectpad1(x)) rounded to bf16,
// a-hat = IN(a), 1/std of the plane. VEC (W a multiple of 8, at most
// kPlaneMax pixels, 16-byte aligned bases): the plane staged by cp.async,
// vectors v = threadIdx.x + k kPlaneThreads of 8 pixels of a row, a kept in
// registers (and copied over x for plane_stats), a-hat stored in vectors.
// Otherwise pixel p = threadIdx.x + u kPlaneThreads at a time: x staged
// while it fits kStageBytes (else read from device memory), a written to
// a-hat and re-read by the later passes.
template <bool VEC>
__global__ void __launch_bounds__(kPlaneThreads) dw_in_fwd_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dw,
    bf16* __restrict__ ahat, float* __restrict__ rstd, int C, int H, int W) {
  constexpr int NT = kPlaneThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  __shared__ float sh[NT / 32];
  const int plane = blockIdx.x, c = plane % C, n = H * W;
  const bf16* xp = x + (size_t)plane * n;
  bf16* ap = ahat + (size_t)plane * n;
  const bool staged = VEC || n * (int)sizeof(bf16) <= kStageBytes;
  // VEC: the rows that the vectors of k = 0 read (one past their last row)
  // arrive in a first copy group and the rest in a second, so the taps of
  // k = 0 are taken while the rest of the plane is still on its way
  const int p1 = min(n, (cdiv(NT * kVec, W) + 1) * W);
  if (VEC) {
    for (int e = threadIdx.x; e < p1 / kVec; e += NT)
      cp_async16(xs + kVec * e, xp + kVec * e, 16);
    cp_commit();
    for (int e = p1 / kVec + threadIdx.x; e < n / kVec; e += NT)
      cp_async16(xs + kVec * e, xp + kVec * e, 16);
    cp_commit();
  } else if (staged) {
    for (int e = threadIdx.x; e < n; e += NT) xs[e] = xp[e];
  }
  float w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = dw[c * 9 + t];
  if (VEC) cp_wait<1>();
  __syncthreads();
  if constexpr (VEC) {
    float a[kVPT][kVec];
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (k == 1) {  // the rest of the plane
        cp_wait<0>();
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) a[k][u] = 0.f;
      if (v >= n / kVec) continue;
      const int p0 = kVec * v, i = p0 / W, j0 = p0 - i * W;
      const int jl = reflect1(j0 - 1, W), jr = reflect1(j0 + kVec, W);
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const bf16* row = xs + reflect1(i + di - 1, H) * W;
        float xv[kVec + 2], mid[kVec];
        unpack8(ld16(row + j0), mid);
        xv[0] = __bfloat162float(row[jl]);
#pragma unroll
        for (int u = 0; u < kVec; ++u) xv[u + 1] = mid[u];
        xv[kVec + 1] = __bfloat162float(row[jr]);
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const float r = __fadd_rn(
              __fadd_rn(__fmul_rn(xv[u], w[3 * di]),
                        __fmul_rn(xv[u + 1], w[3 * di + 1])),
              __fmul_rn(xv[u + 2], w[3 * di + 2]));
          a[k][u] = di == 0 ? r : __fadd_rn(a[k][u], r);
        }
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) a[k][u] = round_bf16(a[k][u]);
    }
    __syncthreads();  // x's plane is read; the rounded a takes its place
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v < n / kVec) st16(xs + kVec * v, pack8(a[k]));
    }
    __syncthreads();
    const float2 st = plane_stats(xs, n, sh);
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v >= n / kVec) continue;
      float o[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) o[u] = (a[k][u] - st.x) * st.y;
      st16(ap + kVec * v, pack8(o));
    }
    if (threadIdx.x == 0) rstd[plane] = st.y;
  } else {
    const bf16* src = staged ? xs : xp;
    float s = 0.f;
    for (int p = threadIdx.x; p < n; p += NT) {
      const int i = p / W, j = p - i * W;
      float acc = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const bf16* row = src + reflect1(i + di - 1, H) * W;
        float t[3];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          t[dj] = __fmul_rn(__bfloat162float(row[reflect1(j + dj - 1, W)]),
                            w[3 * di + dj]);
        const float rs = __fadd_rn(__fadd_rn(t[0], t[1]), t[2]);
        acc = di == 0 ? rs : __fadd_rn(acc, rs);
      }
      const bf16 q = __float2bfloat16_rn(acc);
      ap[p] = q;
      s += __bfloat162float(q);
    }
    const float mean = block_sum<NT>(s, sh) / n;
    float var = 0.f;
    for (int p = threadIdx.x; p < n; p += NT) {
      const float d = __bfloat162float(ap[p]) - mean;
      var += d * d;
    }
    const float r = 1.f / sqrtf(block_sum<NT>(var, sh) / n + kEps);
    for (int p = threadIdx.x; p < n; p += NT)
      ap[p] = __float2bfloat16_rn((__bfloat162float(ap[p]) - mean) * r);
    if (threadIdx.x == 0) rstd[plane] = r;
  }
}

// One block per (b, m) plane: b-hat = IN(b) in place of b, 1/std, and y =
// [relu](b-hat) [+ res], the residual added to the rounded value and the
// sum rounded. VEC (at most kPlaneMax pixels, a multiple of 8, 16-byte
// aligned bases): b in registers and shared memory, 16-byte loads and
// stores; otherwise b is re-read from device memory.
template <bool VEC>
__global__ void __launch_bounds__(kPlaneThreads) in_fwd_bf16_kernel(
    bf16* __restrict__ bh, float* __restrict__ rstd,
    const bf16* __restrict__ res, bf16* __restrict__ y, int n, int relu) {
  constexpr int NT = kPlaneThreads;
  __shared__ float sh[NT / 32];
  const size_t off = (size_t)blockIdx.x * n;
  bf16* bp = bh + off;
  // y at a normalised value t (b-hat before its rounding) and residual rv
  auto out = [&](float t, float rv) {
    t = round_bf16(t);
    const float o = relu ? fmaxf(t, 0.f) : t;
    return res != nullptr ? o + rv : o;
  };
  if constexpr (VEC) {
    __shared__ __align__(16) bf16 vs[kPlaneMax];  // the plane, for its sums
    uint4 b[kVPT];
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v < n / kVec) {
        b[k] = ld16(bp + kVec * v);
        st16(vs + kVec * v, b[k]);
      }
    }
    __syncthreads();
    const float2 st = plane_stats(vs, n, sh);
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v >= n / kVec) continue;
      float bv[kVec], rv[kVec] = {}, t[kVec], o[kVec];
      unpack8(b[k], bv);
      if (res != nullptr) unpack8(ld16(res + off + kVec * v), rv);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        t[u] = (bv[u] - st.x) * st.y;
        o[u] = out(t[u], rv[u]);
      }
      st16(bp + kVec * v, pack8(t));
      st16(y + off + kVec * v, pack8(o));
    }
    if (threadIdx.x == 0) rstd[blockIdx.x] = st.y;
  } else {
    float s = 0.f;
    for (int p = threadIdx.x; p < n; p += NT) s += __bfloat162float(bp[p]);
    const float mean = block_sum<NT>(s, sh) / n;
    float var = 0.f;
    for (int p = threadIdx.x; p < n; p += NT) {
      const float d = __bfloat162float(bp[p]) - mean;
      var += d * d;
    }
    const float r = 1.f / sqrtf(block_sum<NT>(var, sh) / n + kEps);
    for (int p = threadIdx.x; p < n; p += NT) {
      const float t = (__bfloat162float(bp[p]) - mean) * r;
      bp[p] = __float2bfloat16_rn(t);
      y[off + p] = __float2bfloat16_rn(
          out(t, res != nullptr ? __bfloat162float(res[off + p]) : 0.f));
    }
    if (threadIdx.x == 0) rstd[blockIdx.x] = r;
  }
}

// One block per (b, m) plane: IN2's backward given the upstream g (masked by
// b-hat > 0 when relu), gb = r (g - mean(g) - b-hat mean(g b-hat)) rounded
// to bf16. VEC as in_fwd_bf16_kernel's: g and b-hat in registers and
// shared memory, 16-byte loads and stores; otherwise both are re-read.
template <bool VEC>
__global__ void __launch_bounds__(kPlaneThreads) in_bwd_bf16_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ that,
    const float* __restrict__ rstd, bf16* __restrict__ gb, int n, int relu) {
  constexpr int NT = kPlaneThreads;
  __shared__ float sh[NT / 32 * 2];
  const size_t off = (size_t)blockIdx.x * n;
  float s[2] = {0.f, 0.f};
  if constexpr (VEC) {
    // the masked g and b-hat, for their sums in plane_stats' order
    __shared__ __align__(16) bf16 vg[kPlaneMax], vt[kPlaneMax];
    float gg[kVPT][kVec], tt[kVPT][kVec];
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v >= n / kVec) continue;
      const uint4 tq = ld16(that + off + kVec * v);
      unpack8(tq, tt[k]);
      unpack8(ld16(g + off + kVec * v), gg[k]);
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        if (relu && !(tt[k][u] > 0.f)) gg[k][u] = 0.f;
      st16(vt + kVec * v, tq);
      st16(vg + kVec * v, pack8(gg[k]));  // bf16 values: exact
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPlaneMax / NT; ++u) {
      const int p = threadIdx.x + u * NT;
      const float t = p < n ? __bfloat162float(vt[p]) : 0.f,
                  q = p < n ? __bfloat162float(vg[p]) : 0.f;
      s[0] += q;
      s[1] += q * t;
    }
    block_sums<2, NT>(s, sh);
    const float gm = s[0] / n, gym = s[1] / n, r = rstd[blockIdx.x];
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v >= n / kVec) continue;
      float o[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        o[u] = r * (gg[k][u] - gm - tt[k][u] * gym);
      st16(gb + off + kVec * v, pack8(o));
    }
  } else {
    auto grad = [&](int p, float t) {
      return (relu && !(t > 0.f)) ? 0.f : __bfloat162float(g[off + p]);
    };
    for (int p = threadIdx.x; p < n; p += NT) {
      const float t = __bfloat162float(that[off + p]), v = grad(p, t);
      s[0] += v;
      s[1] += v * t;
    }
    block_sums<2, NT>(s, sh);
    const float gm = s[0] / n, gym = s[1] / n, r = rstd[blockIdx.x];
    for (int p = threadIdx.x; p < n; p += NT) {
      const float t = __bfloat162float(that[off + p]);
      gb[off + p] = __float2bfloat16_rn(r * (grad(p, t) - gm - t * gym));
    }
  }
}

// The 16 x 8 x 16 products of one k step (16 deep at ks of a stage) for a
// warp's 64 x 32 outputs, summed straight into acc: A fragments from an
// [m][k] tile (plain ldmatrix) or, AK, a [k][m] tile (.trans); B from a
// [k][n] tile of row stride LDB (.trans) or, BNK, an [n][k] tile (plain).
template <bool AK, bool BNK, int LDB>
__device__ __forceinline__ void k_step(float (&acc)[4][4][4], const bf16* as,
                                       const bf16* bs, int ks, int wm,
                                       int wn) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, q0 = (lane >> 3) & 1,
            q1 = lane >> 4;
  uint32_t bfr[4][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    uint32_t r4[4];
    if constexpr (BNK)  // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), n 8-15
      ldsm_x4(r4, bs + (wn + 16 * jj + 8 * q1 + r8) * LDK + ks + 8 * q0);
    else  // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), then n 8-15
      ldsm_x4_t(r4, bs + (ks + 8 * q0 + r8) * LDB + wn + 16 * jj + 8 * q1);
    bfr[2 * jj][0] = r4[0];
    bfr[2 * jj][1] = r4[1];
    bfr[2 * jj + 1][0] = r4[2];
    bfr[2 * jj + 1][1] = r4[3];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t af[4];  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), k 8-15
    if constexpr (AK)
      ldsm_x4_t(af, as + (ks + 8 * q1 + r8) * LDR + wm + 16 * i + 8 * q0);
    else
      ldsm_x4(af, as + (wm + 16 * i + 8 * q0 + r8) * LDK + ks + 8 * q1);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(acc[i][j], af, bfr[j]);
  }
}

// Cm[b] (Mo x N) = A . X[b] rounded to bf16, A the fp32 weight rounded to
// bf16 as its tiles load: AT false, A = Wt (Mo x K, rows K apart: the
// forward's pw . a-hat); AT, A = Wt^T with Wt (K x Mo, rows Mo apart:
// d a-hat's pw^T . gb). X[b] (K x N) bf16, rows N apart. Block (n tile tn,
// m tile tm, sample b) of BM x BN outputs. avec: N a multiple of 8 and X,
// Cm 16-byte aligned (16-byte copies and stores); wvec: Wt's rows a
// multiple of 4 floats and Wt 16-byte aligned (16-byte copies).
// Tile kt's weight values and activations arrive by cp.async stages - 1
// tiles ahead; after tile kt's products each thread rounds the weight
// values it copied itself for tile kt + 1 into the bf16 tile that tile
// kt - 1 used, so one __syncthreads a tile orders copies, rounding and
// products.
template <bool AT, int BN>
__device__ __forceinline__ void weight_product(
    unsigned char* smem, const float* __restrict__ Wt,
    const bf16* __restrict__ X, bf16* __restrict__ Cm, int Mo, int N, int K,
    int tn, int tm, int b, int avec, int wvec) {
  using T = Tiling<BN>;
  constexpr int NT = T::kThreads, S = T::kStages, LDX = T::LDX;
  constexpr int LDF = AT ? LDWR : LDWK, LDH = AT ? LDR : LDK;
  constexpr int WQ = BM * BK / 4 / NT;  // weight chunks of 4 a thread
  float* wf = reinterpret_cast<float*>(smem);  // fp32 weight ring
  bf16* xs = reinterpret_cast<bf16*>(smem + S * kWTile * 4);
  bf16* wb = xs + S * T::kXTile;  // two bf16 weight tiles
  const int m0 = tm * BM, n0 = tn * BN;
  X += (size_t)b * K * N;
  Cm += (size_t)b * Mo * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            wm = 64 * (warp / T::kWarpsN), wn = 32 * (warp % T::kWarpsN);
  const int ldw = AT ? Mo : K, rows = AT ? K : Mo;  // Wt's row length, rows
  // the tile position (row, 4 columns) of this thread's weight chunk q: AT,
  // rows k and columns m of Wt; else rows m and columns k
  auto wpos = [&](int q, int& r, int& cc) {
    const int e = threadIdx.x + q * NT;
    r = AT ? e / (BM / 4) : e / (BK / 4);
    cc = 4 * (AT ? e % (BM / 4) : e % (BK / 4));
  };
  auto issue = [&](int kt, int s) {
    const int k0 = kt * BK;
    bf16* bs = xs + s * T::kXTile;  // X's [k][n] tile
    if (avec) {
      for (int e = threadIdx.x; e < BK * BN / kVec; e += NT) {
        const int r = e / (BN / kVec), cc = kVec * (e % (BN / kVec));
        const bool ok = k0 + r < K && n0 + cc < N;
        cp_async16(bs + r * LDX + cc,
                   ok ? X + (size_t)(k0 + r) * N + n0 + cc : X, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < BK * BN; e += NT) {
        const int r = e / BN, cc = e % BN;
        const bool ok = k0 + r < K && n0 + cc < N;
        bs[r * LDX + cc] = ok ? X[(size_t)(k0 + r) * N + n0 + cc]
                              : __float2bfloat16_rn(0.f);
      }
    }
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      int r, cc;
      wpos(q, r, cc);
      const int row = (AT ? k0 : m0) + r, col = (AT ? m0 : k0) + cc;
      float* dst = wf + s * kWTile + r * LDF + cc;
      const float* src = Wt + (size_t)row * ldw + col;
      if (wvec) {
        const bool ok = row < rows && col < ldw;
        cp_async16(dst, ok ? src : Wt, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = row < rows && col + u < ldw ? src[u] : 0.f;
      }
    }
  };
  // the weight values this thread copied for stage s, rounded into bf16
  // tile h
  auto round_weight = [&](int s, int h) {
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      int r, cc;
      wpos(q, r, cc);
      const float4 v =
          *reinterpret_cast<const float4*>(wf + s * kWTile + r * LDF + cc);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y),
                           hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(wb + h * kTile + r * LDH + cc) = u;
    }
  };
  float acc[4][4][4] = {};  // [m fragment][n fragment][accumulator]
  const int nk = cdiv(K, BK);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_commit();
  }
  cp_wait<S - 2>();
  round_weight(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // tile kt is in; what tile kt - 1 used is free
    const int nt = kt + S - 1;
    if (nt < nk) issue(nt, nt % S);
    cp_commit();
    const bf16 *as = wb + (kt & 1) * kTile, *bs = xs + (kt % S) * T::kXTile;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16)
      k_step<AT, false, LDX>(acc, as, bs, ks, wm, wn);
    cp_wait<S - 2>();  // this thread's copies of tile kt + 1
    if (kt + 1 < nk) round_weight((kt + 1) % S, (kt + 1) & 1);
  }
  cp_wait<0>();
  __syncthreads();  // the ring may be reused

  // rounded to bf16 through a shared [m][n] tile, out in 16-byte rows
  bf16* cs = reinterpret_cast<bf16*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            cs + (wm + 16 * i + g + 8 * h) * LDX + wn + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN / kVec; e += NT) {
    const int r = e / (BN / kVec), cc = kVec * (e % (BN / kVec));
    const int m = m0 + r, nn = n0 + cc;
    if (m >= Mo || nn >= N) continue;
    const bf16* src = cs + r * LDX + cc;
    bf16* dst = Cm + (size_t)m * N + nn;
    if (avec) {
      st16(dst, ld16(src));
    } else {
      for (int u = 0; u < kVec && nn + u < N; ++u) dst[u] = src[u];
    }
  }
}

// out (M x C, fp32) = sum over k tiles [kt0, kt1) of the (sample, pixel)
// axis (tiles of BK pixels, a sample's last one zero-filled past n) of
// G[b] tile (M x BK) . A[b] tile^T (BK x C): dW_pw's partial over a run of
// tiles, G = gb (B, M, n), A = a-hat (B, C, n), bf16. Block tile (tm, tc)
// of BM x BN outputs. avec: n a multiple of 8, 16-byte aligned bases.
// Both tiles arrive by cp.async, stages - 1 tiles ahead.
template <int BN>
__device__ __forceinline__ void grad_product(
    unsigned char* smem, const bf16* __restrict__ G,
    const bf16* __restrict__ A, float* __restrict__ out, int M, int C, int n,
    int kt0, int kt1, int tm, int tc, int avec) {
  using T = Tiling<BN>;
  constexpr int NT = T::kThreads, S = T::kStages;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // gb and a-hat tiles a stage
  const int m0 = tm * BM, c0 = tc * BN, tps = cdiv(n, BK);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            wm = 64 * (warp / T::kWarpsN), wn = 32 * (warp % T::kWarpsN);
  auto issue = [&](int kt, int s) {
    const int tile = kt0 + kt, b = tile / tps, p0 = (tile - b * tps) * BK;
    // rows r0 .. r0 + R - 1 (below rows) of src (rows n apart), pixels p0
    // .. p0 + 31, into an [r][k] tile
    auto copy = [&](bf16* dst, const bf16* src, int R, int r0, int rows) {
      if (avec) {
        for (int e = threadIdx.x; e < R * BK / kVec; e += NT) {
          const int r = e / (BK / kVec), cc = kVec * (e % (BK / kVec));
          const bool ok = r0 + r < rows && p0 + cc < n;
          cp_async16(dst + r * LDK + cc,
                     ok ? src + (size_t)(r0 + r) * n + p0 + cc : src,
                     ok ? 16 : 0);
        }
      } else {
        for (int e = threadIdx.x; e < R * BK; e += NT) {
          const int r = e / BK, cc = e % BK;
          const bool ok = r0 + r < rows && p0 + cc < n;
          dst[r * LDK + cc] = ok ? src[(size_t)(r0 + r) * n + p0 + cc]
                                 : __float2bfloat16_rn(0.f);
        }
      }
    };
    bf16* st = ring + s * (kTile + T::kGTile);
    copy(st, G + (size_t)b * M * n, BM, m0, M);
    copy(st + kTile, A + (size_t)b * C * n, BN, c0, C);
  };
  float acc[4][4][4] = {};
  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<S - 2>();
    __syncthreads();  // tile kt is in; what tile kt - 1 used is free
    const int nt = kt + S - 1;
    if (nt < nk) issue(nt, nt % S);
    cp_commit();
    const bf16* as = ring + (kt % S) * (kTile + T::kGTile);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16)
      k_step<false, true, LDK>(acc, as, as + kTile, ks, wm, wn);
  }
  cp_wait<0>();

  // rows m0 + wm + 16 i + g (+ 8), columns c0 + wn + 8 j + 2t (+ 1)
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = C % 2 == 0;  // float2 stores stay aligned
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + g + 8 * h;
      if (row >= M) continue;
      float* cr = out + (size_t)row * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + wn + 8 * j + 2 * t;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (pairs && col < C) {
          *reinterpret_cast<float2*>(cr + col) = make_float2(x, y);
        } else {
          if (col < C) cr[col] = x;
          if (col + 1 < C) cr[col + 1] = y;
        }
      }
    }
}

// b[b] (M x n) = pw (M x C) . a-hat[b] (C x n); grid (n tiles, M tiles, B)
template <int BN>
__global__ void __launch_bounds__(Tiling<BN>::kThreads,
                                  Tiling<BN>::kBlocksPerSM)
    pw_fwd_bf16_kernel(const float* __restrict__ pw,
                       const bf16* __restrict__ ahat, bf16* __restrict__ b,
                       int M, int n, int C, int avec, int wvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  weight_product<false, BN>(smem, pw, ahat, b, M, n, C, blockIdx.x,
                            blockIdx.y, blockIdx.z, avec, wvec);
}

// The backward's two products in one grid: blocks below
// (M tiles x C tiles x splits) sum dW_pw over run s of per k tiles (into
// gpw_out + s M C), the others form d a-hat[b] (C x n) = pw^T . gb[b].
template <int BN>
__global__ void __launch_bounds__(Tiling<BN>::kThreads,
                                  Tiling<BN>::kBlocksPerSM)
    pw_bwd_bf16_kernel(const float* __restrict__ pw,
                       const bf16* __restrict__ gb,
                       const bf16* __restrict__ ahat, bf16* __restrict__ gah,
                       float* __restrict__ gpw_out, int B, int C, int M,
                       int n, int splits, int per, int avec, int wvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles_c = cdiv(C, BN), n_w = cdiv(M, BM) * tiles_c * splits;
  if ((int)blockIdx.x < n_w) {
    const int s = blockIdx.x % splits, tile = blockIdx.x / splits;
    const int T = B * cdiv(n, BK);
    grad_product<BN>(smem, gb, ahat, gpw_out + (size_t)s * M * C, M, C, n,
                     s * per, min(T, (s + 1) * per), tile / tiles_c,
                     tile % tiles_c, avec);
  } else {
    const int i = blockIdx.x - n_w, tn = cdiv(n, BN), tcm = cdiv(C, BM);
    weight_product<true, BN>(smem, pw, gb, gah, C, n, M, i % tn,
                             i / tn % tcm, i / (tn * tcm), avec, wvec);
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Lets the products' kernels take their dynamic shared memory (past 48 KB),
// once per device: the call costs the host more than a launch.
int allow_gemm_smem() {
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (raised[dev]) return 0;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  for (int e : {(int)cudaFuncSetAttribute(pw_fwd_bf16_kernel<128>, a,
                                          Tiling<128>::kSmem),
                (int)cudaFuncSetAttribute(pw_fwd_bf16_kernel<256>, a,
                                          Tiling<256>::kSmem),
                (int)cudaFuncSetAttribute(pw_bwd_bf16_kernel<128>, a,
                                          Tiling<128>::kSmem),
                (int)cudaFuncSetAttribute(pw_bwd_bf16_kernel<256>, a,
                                          Tiling<256>::kSmem)})
    if (e) return e;
  raised[dev] = true;
  return 0;
}

// The products take 128 x 256 tiles where those still give three quarters
// of the card's sms SMs a block (the teacher's B 4, 256 channels, 64 x 64:
// 128 blocks), else 128 x 128 (two blocks an SM: the student's widths,
// CycleGAN's batch 1). blocks: the weight product's 128 x 256 tiles.
bool wide_tiles(long long blocks, int sms) { return 4 * blocks >= 3LL * sms; }

bool wide_bwd(int B, int C, int n, int sms) {
  return wide_tiles((long long)cdiv(C, BM) * cdiv(n, 256) * B, sms);
}

// k tiles of the (sample, pixel) axis that one dW block sums: about the
// grid's k tiles over the blocks the card holds at once, so that dW's
// blocks and d a-hat's finish together; no fewer than a d a-hat block's,
// and enough that the partials stay under kPartialBytes. Fixed for a shape
// and a card: the ordered sum repeats.
int grad_per(int B, int C, int M, int n, int sms) {
  const bool wide = wide_bwd(B, C, n, sms);
  const int bn = wide ? 256 : 128;
  const long long T = (long long)B * cdiv(n, BK), kd = cdiv(M, BK);
  const long long units = (long long)cdiv(C, BM) * cdiv(n, bn) * B * kd +
                          (long long)cdiv(M, BM) * cdiv(C, bn) * T;
  const long long slots = (long long)(wide ? 1 : 2) * std::max(sms, 1);
  const long long max_splits =
      std::max(1LL, kPartialBytes / (4LL * M * C));
  long long per = std::max(kd, (units + slots - 1) / slots);
  per = std::max(per, (T + max_splits - 1) / max_splits);
  return (int)std::min(per, T);
}

int grad_splits(int B, int C, int M, int n, int sms) {
  return cdiv(B * cdiv(n, BK), grad_per(B, C, M, n, sms));
}

}  // namespace

extern "C" {

// Forward of one stage in bf16: x (B,C,H,W), res (B,M,H,W) or null, bf16;
// dw (C,1,3,3), pw (M,C,1,1) fp32. Writes y (B,M,H,W) and, for the
// backward, a-hat (B,C,H,W), b-hat (B,M,H,W) in bf16, 1/std of a (B,C) and
// of b (B,M) in fp32. sms: the card's SM count.
int gcc_stage_fwd_bf16(const bf16* x, const float* dw, const float* pw,
                       const bf16* res, bf16* y, bf16* ahat, bf16* bhat,
                       float* rstd_a, float* rstd_b, int B, int C, int M,
                       int H, int W, int relu, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = H * W;
  if (int e = allow_gemm_smem()) return e;
  const int xbytes = n * (int)sizeof(bf16);
  if (W % kVec == 0 && n <= kPlaneMax && aligned16(x) && aligned16(ahat))
    dw_in_fwd_bf16_kernel<true><<<B * C, kPlaneThreads, xbytes, st>>>(
        x, dw, ahat, rstd_a, C, H, W);
  else
    dw_in_fwd_bf16_kernel<false>
        <<<B * C, kPlaneThreads, xbytes <= kStageBytes ? xbytes : 0, st>>>(
            x, dw, ahat, rstd_a, C, H, W);
  if (int e = (int)cudaGetLastError()) return e;
  const int avec = n % kVec == 0 && aligned16(ahat) && aligned16(bhat);
  const int wvec = C % 4 == 0 && aligned16(pw);
  if (wide_tiles((long long)cdiv(n, 256) * cdiv(M, BM) * B, sms))
    pw_fwd_bf16_kernel<256>
        <<<dim3(cdiv(n, 256), cdiv(M, BM), B), Tiling<256>::kThreads,
           Tiling<256>::kSmem, st>>>(pw, ahat, bhat, M, n, C, avec, wvec);
  else
    pw_fwd_bf16_kernel<128>
        <<<dim3(cdiv(n, 128), cdiv(M, BM), B), Tiling<128>::kThreads,
           Tiling<128>::kSmem, st>>>(pw, ahat, bhat, M, n, C, avec, wvec);
  if (int e = (int)cudaGetLastError()) return e;
  if (n % kVec == 0 && n <= kPlaneMax && aligned16(bhat) && aligned16(y) &&
      (res == nullptr || aligned16(res)))
    in_fwd_bf16_kernel<true>
        <<<B * M, kPlaneThreads, 0, st>>>(bhat, rstd_b, res, y, n, relu);
  else
    in_fwd_bf16_kernel<false>
        <<<B * M, kPlaneThreads, 0, st>>>(bhat, rstd_b, res, y, n, relu);
  return (int)cudaGetLastError();
}

// The number of (M, C) fp32 partials that gcc_stage_bwd_pw_bf16 sums into
// gpw on a card of sms SMs (0 where dW takes one run and is written
// directly): the size of its gpw_part scratch. Returns a count, not an
// error.
int gcc_stage_bwd_pw_bf16_partials(int B, int C, int M, int H, int W,
                                   int sms) {
  const int s = grad_splits(B, C, M, H * W, sms);
  return s > 1 ? s : 0;
}

// Backward, pointwise side, in bf16: relu + IN2 + pointwise conv. g
// (B,M,H,W) = d(loss)/dy, a-hat, b-hat bf16; rstd_b (B,M), pw fp32. Writes
// gah = d(loss)/d(a-hat) (B,C,H,W) bf16 and gpw (M,C,1,1) fp32. Scratch: gb
// (B,M,H,W) bf16; gpw_part (gcc_stage_bwd_pw_bf16_partials(B, C, M, H, W,
// sms), M, C) fp32, sms the card's SM count.
int gcc_stage_bwd_pw_bf16(const bf16* g, const bf16* ahat, const bf16* bhat,
                          const float* rstd_b, const float* pw, bf16* gb,
                          bf16* gah, float* gpw_part, float* gpw, int B,
                          int C, int M, int H, int W, int relu, int sms,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = H * W;
  if (int e = allow_gemm_smem()) return e;
  if (n % kVec == 0 && n <= kPlaneMax && aligned16(g) && aligned16(bhat) &&
      aligned16(gb))
    in_bwd_bf16_kernel<true>
        <<<B * M, kPlaneThreads, 0, st>>>(g, bhat, rstd_b, gb, n, relu);
  else
    in_bwd_bf16_kernel<false>
        <<<B * M, kPlaneThreads, 0, st>>>(g, bhat, rstd_b, gb, n, relu);
  if (int e = (int)cudaGetLastError()) return e;
  const int per = grad_per(B, C, M, n, sms);
  const int splits = cdiv(B * cdiv(n, BK), per);
  const int avec = n % kVec == 0 && aligned16(gb) && aligned16(ahat) &&
                   aligned16(gah);
  const int wvec = C % 4 == 0 && aligned16(pw);
  float* out = splits > 1 ? gpw_part : gpw;
  if (wide_bwd(B, C, n, sms))
    pw_bwd_bf16_kernel<256>
        <<<cdiv(M, BM) * cdiv(C, 256) * splits + cdiv(n, 256) * cdiv(C, BM) * B,
           Tiling<256>::kThreads, Tiling<256>::kSmem, st>>>(
            pw, gb, ahat, gah, out, B, C, M, n, splits, per, avec, wvec);
  else
    pw_bwd_bf16_kernel<128>
        <<<cdiv(M, BM) * cdiv(C, 128) * splits + cdiv(n, 128) * cdiv(C, BM) * B,
           Tiling<128>::kThreads, Tiling<128>::kSmem, st>>>(
            pw, gb, ahat, gah, out, B, C, M, n, splits, per, avec, wvec);
  if (int e = (int)cudaGetLastError()) return e;
  if (splits == 1) return 0;
  return sum_partials(gpw_part, gpw, splits, (long long)M * C, st);
}

}  // extern "C"
