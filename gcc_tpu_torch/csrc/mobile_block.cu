// Fused MobileResnet separable-conv stage for Hopper (sm_90a), NCHW, in
// fp32. The bf16 entry points (the JAX package's default --compute_dtype)
// are mobile_block_bf16.cu's.
//
// One stage is  y = IN(pw1x1(IN(dw3x3(reflectpad1(x))))) [relu] [+ res]
// with affine-free InstanceNorm (eps 1e-5, two-pass statistics in fp32).
// Conv biases are inert (every conv feeds an affine-free IN) and are not read.
//
// Replaces the three Pallas kernels of gcc_tpu/ops/pallas/mobile_block.py:
//   gcc_stage_fwd     <- _stage_fwd_kernel     (:155, pallas_call :286)
//   gcc_stage_bwd_pw  <- _stage_bwd_pw_kernel  (:187, pallas_call :324)
//   gcc_stage_bwd_dw  <- _stage_bwd_dw_kernel  (:220, pallas_call :345)
// Each entry point is one TPU kernel's function and issues several launches:
//   gcc_stage_fwd     dw_in_fwd_kernel, pw_gemm_kernel<0,0>, in_fwd_kernel
//   gcc_stage_bwd_pw  in_bwd_kernel, pw_gemm_kernel<1,0> (d a-hat),
//                     pw_gemm_kernel<0,1> (dW partials), sum_partials_kernel
//   gcc_stage_bwd_dw  dw_bwd_plane_kernel, sum_partials_kernel
//
// What bounds it on the card. The stage's real products are the pointwise
// conv's: b = pw . a-hat forward, d a-hat = pw^T . gb and dW = sum_b gb .
// a-hat^T backward, 2*B*H*W*C*M flops each. In split-TF32 on the tensor
// cores (165 TFLOP/s; 67 on the fp32 CUDA cores) they bound the teacher's
// C = M = 256: forward 0.013 ms against 0.010 for the function's own bytes
// (x in, y out), backward-pointwise 0.026 ms against 0.015 (x, g in; gah
// out). Everything else is bound by bytes: the depthwise side of the
// backward reads x and gah and writes gx (0.015 ms at the teacher, 50 MB at
// 3.35 TB/s). The port also saves a-hat, b-hat and both 1/std in the
// forward and reads them back in the backward instead of recomputing the
// stage (the TPU recomputes to stay inside VMEM): a cost of that choice,
// not of the function (chip_smoke.py prints both bounds).
//
// What the design does about it, and where it leaves the TPU design:
//  * The TPU program holds one whole sample (up to 64x64x256 f32, 4 MB) in
//    VMEM; a Hopper block has 227 KB. InstanceNorm over the full plane is
//    therefore split by plane, and each pointwise product is a separate
//    tiled matrix product. IN2 forward and backward hold a plane of up to
//    64x64 in registers (16 pixels a thread), so it is read once.
//  * All three products run in one tensor-core GEMM template,
//    pw_gemm_kernel<AT, BT>, in split-TF32 (tf32_mma.cuh: three
//    mma.sync.m16n8k8 .tf32 per product). Plain TF32 operands would miss
//    the port's bounds (b-hat 1e-4; gradients 1e-4 max(|ref|, 1)); split-
//    TF32 holds them within half (tests/test_torch_mobile_block.py::
//    test_pw_precision, test_pw_grad_precision emulate both against
//    float64). Block tiles of 128 x 128 x 16, 8 warps of 64 x 32 outputs
//    (4 x 4 m16n8 fragments); cp.async double buffering, tile k + 1 loading
//    while k computes; operands split into hi/lo as the fragments load.
//    128 registers (two blocks of 256 threads an SM); spill stores of 44 B
//    in <0,0>, 4 B in <1,0>, none in <0,1>; 37,888, 34,816 and 40,960 B of
//    shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8).
//  * Layouts and banks, lane = 4g + t (a0 at row g, k t; b0 at k t,
//    column g). A [m][k] and B^T [n][k] tiles have a row stride of GK + 4 =
//    20 floats: a warp's fragment load hits bank (20g + t) mod 32, and 20g
//    mod 32 = 0, 20, 8, 28, 16, 4, 24, 12 for g = 0..7, so with t = 0..3
//    all 32 banks. A^T [k][m] (d a-hat reads pw transposed) and B [k][n]
//    tiles have a stride of GN + 8 = 136: bank (136t + g) mod 32 = 8t + g,
//    again all 32 (+8 rows or columns only rotate them). Copies run along
//    whichever index is contiguous in device memory.
//  * The tensor cores truncate as they accumulate: summed straight into one
//    accumulator over C / 8 k steps, b-hat was 8.3e-6 off the plain version
//    at C = M = 256 and flipped relu masks. So each k step's three mma go
//    into a zeroed fragment that is added to the accumulator in fp32 (all
//    three products; dW sums 64 x 64 pixels per sample, so it matters more).
//    The forward's instantiation <0,0> keeps its tiles and per-k-step order:
//    its bits did not change when the template was generalised.
//  * Channels are not padded to 128 (a TPU lane artefact): ragged M, N and
//    K are zero-filled (cp.async with a source size of 0) and masked at the
//    store, so the student's widths 24/48/72/112 run as they are.
//  * The TPU accumulates dW over its sequential batch grid. CUDA blocks run
//    in no order, so dW is written as per-(sample, pixel-chunk) partials and
//    summed in a fixed order by sum_partials_kernel (8 warps over contiguous
//    ranges of partials, then warp 0 in order); likewise the depthwise
//    weight's per-plane partials over B. No float atomics: results repeat
//    bit for bit from run to run. The chunk is sized from the shape and the
//    card's SM count (pw_grad_chunk below; the wrapper sizes the partials
//    with gcc_stage_bwd_pw_partials) so that output tiles x chunks make
//    about two blocks per SM: on 132 SMs 256 blocks of 256-pixel chunks at
//    the teacher's 2 x 2 tiles, 256 of 64 pixels at the student's one tile.
//  * The two products of the backward run as two launches, not one grid:
//    d a-hat alone gives 256 blocks at the teacher and 128 at the student.
//  * The depthwise side of the backward (dw_bwd_plane_kernel) is one block
//    per (b, c) plane with three (H+2) x (W+2) shared tiles: x streams into
//    a reflect-padded one by cp.async while gah and a-hat are staged in the
//    other two and IN1's two sums are taken; then ga replaces gah, with a
//    zero border. Each thread walks a column strip (16 rows of one column
//    at 64x64 and 256 threads) with the 3x3 windows of ga and padded x in
//    registers: three new values of each per pixel, the 9-tap transposed
//    stencil for gx and the nine gdw products from the windows, and the pad
//    adjoint's folds (rows 1, H - 2, columns 1, W - 2) from the same
//    windows, since only ga's rows 1, H and columns 1, W reach the frame.
//    The nine gdw taps and IN1's two sums each take one combined shuffle
//    and shared-memory reduction. So x, gah and a-hat are read once, gx is
//    written once, and ga never goes to device memory. A 64x64 plane takes
//    52,272 B of shared memory; planes past 54 KB (above ~66x66) run the
//    same kernel reading ga's inputs and x from device memory at every tap.
//    64 registers, no spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 4 blocks
//    of 256 threads an SM, by registers (65,536 / 64 = 1024 threads) and by
//    shared memory alike, 528 on the card. The teacher's 1024 planes take
//    1.94 waves; the student's 288 and 448 planes one wave, 2.2 and 3.4
//    blocks an SM, 55 and 85 % of the threads the card holds. No launch
//    shape fills it at 288 planes while a thread needs 64 registers: more
//    threads per plane share the same 1024 an SM, so 288 blocks of 512
//    (147,456 threads) no longer fit in one wave (135,168), and a cluster
//    of blocks per plane only splits the same threads. The best fit, 320
//    threads (3 blocks an SM), would reach 68 %; it was not tried.
//
// Every entry point but the *_partials counts returns cudaGetLastError()
// as an int; the Python wrapper raises when it is not 0. Nothing here
// allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "stage_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int GM = 128, GN = 128, GK = 16;  // pw_gemm_kernel's tiles
constexpr int LDA = GK + 4;  // row stride of a [row][k] tile: A, or B^T
constexpr int LDB = GN + 8;  // row stride of a [k][row] tile: B, or A^T
static_assert(GM == GN, "A^T tiles use B's row stride");
constexpr int kGemmBlocksPerSM = 2;  // pw_gemm_kernel's launch bounds
// a plane's three tiles at most this: 64x64 (52,272 B) fits 4 blocks an SM
constexpr int kPlaneSmem = 54 * 1024;
constexpr int kPlaneBlocksPerSM = 4;  // dw_bwd_plane_kernel: 64 registers

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

// Pixels a thread holds in registers in in_fwd_kernel and in_bwd_kernel when
// a plane has at most kThreads * kPPT of them (64x64, the main path's), so
// the plane is read from device memory once; larger planes are re-read.
constexpr int kPPT = 16;

// One block per (b, m) plane: b-hat = IN(b) in place, 1/std, and
// y = [relu](b-hat) [+ res]. PPT > 0: the plane's b stays in registers
// between the passes; PPT = 0: it is re-read (any plane size). Both sum in
// the same order and give the same bits.
template <int PPT>
__global__ void __launch_bounds__(kThreads) in_fwd_kernel(
    float* __restrict__ bh, float* __restrict__ rstd,
    const float* __restrict__ res, float* __restrict__ y, int n, int relu) {
  __shared__ float sh[kThreads / 32];
  const size_t off = (size_t)blockIdx.x * n;
  float* bp = bh + off;
  auto out = [&](int p, float t) {
    bp[p] = t;
    float o = relu ? fmaxf(t, 0.f) : t;
    if (res != nullptr) o += res[off + p];
    y[off + p] = o;
  };
  float s = 0.f;
  if constexpr (PPT > 0) {
    float b[PPT];
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int p = threadIdx.x + u * kThreads;
      b[u] = p < n ? bp[p] : 0.f;
      s += b[u];
    }
    const float mean = block_sum(s, sh) / n;
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const float d = b[u] - mean;
      if (threadIdx.x + u * kThreads < n) v += d * d;
    }
    const float r = 1.f / sqrtf(block_sum(v, sh) / n + kEps);
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int p = threadIdx.x + u * kThreads;
      if (p < n) out(p, (b[u] - mean) * r);
    }
    if (threadIdx.x == 0) rstd[blockIdx.x] = r;
  } else {
    for (int p = threadIdx.x; p < n; p += kThreads) s += bp[p];
    const float mean = block_sum(s, sh) / n;
    float v = 0.f;
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float d = bp[p] - mean;
      v += d * d;
    }
    const float r = 1.f / sqrtf(block_sum(v, sh) / n + kEps);
    for (int p = threadIdx.x; p < n; p += kThreads) out(p, (bp[p] - mean) * r);
    if (threadIdx.x == 0) rstd[blockIdx.x] = r;
  }
}

// One block per (b, m) plane: IN2's backward given the upstream g (masked by
// b-hat > 0 when relu), gb = r * (g - mean(g) - b-hat * mean(g * b-hat)).
// PPT > 0: g and b-hat stay in registers between the passes (read once);
// PPT = 0: they are re-read (any plane size).
template <int PPT>
__global__ void __launch_bounds__(kThreads) in_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ that,
    const float* __restrict__ rstd, float* __restrict__ out, int n,
    int relu) {
  __shared__ float sh[kThreads / 32 * 2];
  const size_t off = (size_t)blockIdx.x * n;
  auto grad = [&](int p, float t) {
    return (relu && !(t > 0.f)) ? 0.f : g[off + p];
  };
  float s[2] = {0.f, 0.f};
  if constexpr (PPT > 0) {
    float gg[PPT], tt[PPT];
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int p = threadIdx.x + u * kThreads;
      tt[u] = p < n ? that[off + p] : 0.f;
      gg[u] = p < n ? grad(p, tt[u]) : 0.f;
      s[0] += gg[u];
      s[1] += gg[u] * tt[u];
    }
    block_sums(s, sh);
    const float gm = s[0] / n, gym = s[1] / n, r = rstd[blockIdx.x];
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int p = threadIdx.x + u * kThreads;
      if (p < n) out[off + p] = r * (gg[u] - gm - tt[u] * gym);
    }
  } else {
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float t = that[off + p], gg = grad(p, t);
      s[0] += gg;
      s[1] += gg * t;
    }
    block_sums(s, sh);
    const float gm = s[0] / n, gym = s[1] / n, r = rstd[blockIdx.x];
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float t = that[off + p];
      out[off + p] = r * (grad(p, t) - gm - t * gym);
    }
  }
}

// One block per (b, c) plane: IN1's backward and the depthwise side at once.
// ga = r * (gah - mean(gah) - a-hat * mean(gah * a-hat)) (IN1's backward),
//   gx = reflect-pad adjoint of the transposed depthwise conv of ga,
//   gdw_part[plane, tap] = sum over the plane of ga * (tap-shifted padded x).
// SMEM: three (H+2) x (W+2) shared tiles. x streams into a reflect-padded
// one by cp.async while gah and a-hat are staged in the other two and IN1's
// sums are taken; then ga replaces gah, with a zero border. So x, gah and
// a-hat are read from device memory once and ga never goes there. !SMEM
// (planes whose tiles pass kPlaneSmem): ga and the padded x are formed from
// device memory at every tap instead.
// Each thread walks one column strip (column j, rows i0 .. i1 - 1; W columns
// x kThreads / W strips), keeping the 3x3 windows of ga and padded x around
// its pixel in registers: three new values of each per pixel.
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, kPlaneBlocksPerSM)
    dw_bwd_plane_kernel(const float* __restrict__ gah,
                        const float* __restrict__ ahat,
                        const float* __restrict__ rstd,
                        const float* __restrict__ x,
                        const float* __restrict__ dw, float* __restrict__ gx,
                        float* __restrict__ gdw_part, int C, int H, int W) {
  extern __shared__ float tiles[];  // SMEM: ga, x, a-hat, (H+2) x (W+2) each
  __shared__ float sh[kThreads / 32 * 9];
  const int plane = blockIdx.x, c = plane % C, n = H * W, Wp = W + 2;
  const size_t off = (size_t)plane * n;
  const float *gp = gah + off, *ap = ahat + off, *xp = x + off;
  float *gs = tiles, *xs = gs + (H + 2) * Wp, *as = xs + (H + 2) * Wp;
  const int segs = max(1, kThreads / W), rows = (H + segs - 1) / segs;
  // f(j, i0, i1) on each of this thread's strips
  auto strips = [&](auto&& f) {
    for (int task = threadIdx.x; task < W * segs; task += kThreads) {
      const int j = task % W, i0 = task / W * rows;
      if (i0 < H) f(j, i0, min(H, i0 + rows));
    }
  };

  if constexpr (SMEM) {
    strips([&](int j, int i0, int i1) {
      for (int i = i0; i < i1; ++i)
        tf32x3::cp_async(&xs[(i + 1) * Wp + j + 1], xp + i * W + j, 4, false);
    });
    tf32x3::cp_commit();
  }
  float s[2] = {0.f, 0.f};  // IN1's sums of gah and gah * a-hat
  strips([&](int j, int i0, int i1) {
    for (int i = i0; i < i1; ++i) {
      const float v = gp[i * W + j], a = ap[i * W + j];
      s[0] += v;
      s[1] += v * a;
      if constexpr (SMEM) {
        gs[(i + 1) * Wp + j + 1] = v;
        as[(i + 1) * Wp + j + 1] = a;
      }
    }
  });
  if constexpr (SMEM)  // the frame: ga's zero border, x's reflected one
    for (int e = threadIdx.x; e < 2 * (Wp + H); e += kThreads) {
      const int f = e - 2 * Wp;
      const int i = e < Wp ? 0 : e < 2 * Wp ? H + 1 : f < H ? f + 1 : f - H + 1;
      const int j = e < Wp ? e : e < 2 * Wp ? e - Wp : f < H ? 0 : W + 1;
      gs[i * Wp + j] = 0.f;
      xs[i * Wp + j] = xp[reflect1(i - 1, H) * W + reflect1(j - 1, W)];
    }
  block_sums(s, sh);
  const float gm = s[0] / n, gym = s[1] / n, r = rstd[plane];
  if constexpr (SMEM) {
    strips([&](int j, int i0, int i1) {
      for (int i = i0; i < i1; ++i) {
        const int q = (i + 1) * Wp + j + 1;
        gs[q] = r * (gs[q] - gm - as[q] * gym);
      }
    });
    tf32x3::cp_wait<0>();
    __syncthreads();
  }
  // ga and x at padded coordinates (i, j), 0 <= i <= H + 1, 0 <= j <= W + 1;
  // ga is 0 on the border
  auto GA = [&](int i, int j) -> float {
    if constexpr (SMEM) {
      return gs[i * Wp + j];
    } else {
      if (i < 1 || i > H || j < 1 || j > W) return 0.f;
      const int p = (i - 1) * W + j - 1;
      return r * (gp[p] - gm - ap[p] * gym);
    }
  };
  auto XP = [&](int i, int j) -> float {
    if constexpr (SMEM)
      return xs[i * Wp + j];
    else
      return xp[reflect1(i - 1, H) * W + reflect1(j - 1, W)];
  };
  float w[9], acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    w[t] = dw[c * 9 + t];
    acc[t] = 0.f;
  }
  strips([&](int j, int i0, int i1) {
    // windows of padded rows i .. i + 2, columns j .. j + 2
    float gw[3][3], xw[3][3];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        gw[u + 1][v] = GA(i0 + u, j + v);
        xw[u + 1][v] = XP(i0 + u, j + v);
      }
    for (int i = i0; i < i1; ++i) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        gw[0][v] = gw[1][v];
        gw[1][v] = gw[2][v];
        gw[2][v] = GA(i + 2, j + v);
        xw[0][v] = xw[1][v];
        xw[1][v] = xw[2][v];
        xw[2][v] = XP(i + 2, j + v);
      }
      const float gc = gw[1][1];
      float g = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          acc[di * 3 + dj] += gc * xw[di][dj];
          g += w[di * 3 + dj] * gw[2 - di][2 - dj];
        }
      // the reflect pad's adjoint: d(loss)/d(padded x) on padded rows 0 and
      // H + 1 folds onto x rows 1 and H - 2, on padded columns 0 and W + 1
      // onto columns 1 and W - 2. Of its taps only those on ga's rows 1 and
      // H and columns 1 and W are not 0, and the window holds them there.
      const bool r0 = i == 1, r1 = i == H - 2, c0 = j == 1, c1 = j == W - 2;
      if (r0 || r1 || c0 || c1) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          if (r0) g += w[2 - u] * gw[0][u];      // padded row 0
          if (r1) g += w[8 - u] * gw[2][u];      // padded row H + 1
          if (c0) g += w[6 - 3 * u] * gw[u][0];  // padded column 0
          if (c1) g += w[8 - 3 * u] * gw[u][2];  // padded column W + 1
        }
        if (r0 && c0) g += w[0] * gw[0][0];
        if (r0 && c1) g += w[2] * gw[0][2];
        if (r1 && c0) g += w[6] * gw[2][0];
        if (r1 && c1) g += w[8] * gw[2][2];
      }
      gx[off + i * W + j] = g;
    }
  });
  block_sums(acc, sh);
  if (threadIdx.x == 0)
#pragma unroll
    for (int t = 0; t < 9; ++t) gdw_part[(size_t)plane * 9 + t] = acc[t];
}

// Rows r0 .. r0 + R - 1 and columns c0 .. c0 + CC - 1 of a row-major matrix
// (rows ld apart) by cp.async into a shared tile of row stride ld_s, rows
// from r_end and columns from c_end zero-filled (a copy with a source size
// of 0). vec: 16-byte copies, for ld, c0 and c_end multiples of 4 and a
// 16-byte aligned base, so that every copy lies wholly inside or outside.
template <int R, int CC>
__device__ __forceinline__ void load_tile(float* dst, int ld_s,
                                          const float* src, int ld, int r0,
                                          int r_end, int c0, int c_end,
                                          int vec) {
  using tf32x3::cp_async;
  if (vec) {
    for (int e = threadIdx.x; e < R * CC / 4; e += kThreads) {
      const int r = e / (CC / 4), c = 4 * (e % (CC / 4));
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async(dst + r * ld_s + c,
               ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok ? 16 : 0,
               true);
    }
  } else {
    for (int e = threadIdx.x; e < R * CC; e += kThreads) {
      const int r = e / CC, c = e % CC;
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async(dst + r * ld_s + c,
               ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok ? 4 : 0,
               false);
    }
  }
}

// Cm[z] (M x N) = A[zb] (M x K, columns in chunk s) . B[zb] (K x N, rows in
// chunk s), z = zb * splits + s, on the tensor cores in split-TF32.
// A is read as [m][k] (rows lda apart) or, AT, as [k][m]; B as [k][n] or,
// BT, as [n][k] (rows ldb apart). Chunk s covers k in [s k_chunk,
// (s + 1) k_chunk); splits > 1 makes Cm per-chunk partials. Block (column
// tile x, row tile y, z) of GM x GN outputs; warp w owns rows 64 (w / 4) ..
// and columns 32 (w % 4) .. of it. Ragged M, N and K are zero-filled in
// shared memory and masked at the store.
template <bool AT, bool BT>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSM) pw_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ Cm, int M, int N, int K, int lda, int ldb,
    long long a_z, long long b_z, int k_chunk, int splits, int vec) {
  using namespace tf32x3;
  __shared__ __align__(16) float As[2][AT ? GK * LDB : GM * LDA];
  __shared__ __align__(16) float Bs[2][BT ? GN * LDA : GK * LDB];
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int zb = blockIdx.z / splits;
  const int k_begin = (blockIdx.z - zb * splits) * k_chunk,
            k_end = min(K, k_begin + k_chunk);
  A += zb * a_z;
  Bm += zb * b_z;
  Cm += (size_t)blockIdx.z * M * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, wm = 64 * (warp >> 2), wn = 32 * (warp & 3);

  auto load = [&](int k0, int s) {
    if constexpr (AT)
      load_tile<GK, GM>(As[s], LDB, A, lda, k0, k_end, m0, M, vec);
    else
      load_tile<GM, GK>(As[s], LDA, A, lda, m0, M, k0, k_end, vec);
    if constexpr (BT)
      load_tile<GN, GK>(Bs[s], LDA, Bm, ldb, n0, N, k0, k_end, vec);
    else
      load_tile<GK, GN>(Bs[s], LDB, Bm, ldb, k0, k_end, n0, N, vec);
  };

  float acc[4][4][4] = {};  // [m fragment][n fragment][accumulator]
  const int nk = (k_end - k_begin + GK - 1) / GK;
  load(k_begin, 0);
  cp_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {  // fetch tile kt + 1 while kt computes
      load(k_begin + (kt + 1) * GK, s ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < GK; ks += 8) {
      FragB bf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (BT) {
          const float* br = &Bs[s][(wn + 8 * j + g) * LDA + ks + t];
          bf[j] = frag_b(br[0], br[4]);
        } else {
          const float* br = &Bs[s][(ks + t) * LDB + wn + 8 * j + g];
          bf[j] = frag_b(br[0], br[4 * LDB]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA af;
        if constexpr (AT) {
          const float* ar = &As[s][(ks + t) * LDB + wm + 16 * i + g];
          af = frag_a(ar[0], ar[8], ar[4 * LDB], ar[4 * LDB + 8]);
        } else {
          const float* ar = &As[s][(wm + 16 * i + g) * LDA + ks + t];
          af = frag_a(ar[0], ar[8 * LDA], ar[4], ar[8 * LDA + 4]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // one k step, then added in fp32
          float d[4] = {};
          mma3(d, af, bf[j]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += d[r];
        }
      }
    }
    __syncthreads();  // readers of stage s are done before it is refilled
  }

  // rows m0 + wm + 16 i + g (+ 8), columns n0 + wn + 8 j + 2t (+ 1)
  const bool pairs = N % 2 == 0;  // float2 stores stay aligned
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + g + 8 * h;
      if (row >= M) continue;
      float* cr = Cm + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (pairs && col < N) {
          *reinterpret_cast<float2*>(cr + col) = make_float2(x, y);
        } else {
          if (col < N) cr[col] = x;
          if (col + 1 < N) cr[col + 1] = y;
        }
      }
    }
}

// The launch of pw_gemm_kernel<AT, BT> for Z batches of ceil(K / k_chunk)
// chunks each (arguments as the kernel's).
template <bool AT, bool BT>
int gemm(const float* A, const float* Bm, float* Cm, int M, int N, int K,
         int lda, int ldb, long long a_z, long long b_z, int k_chunk, int Z,
         cudaStream_t st) {
  const int splits = (K + k_chunk - 1) / k_chunk;
  // 16-byte copies need the contiguous index of every tile a multiple of 4
  const bool k_fast = !AT || BT;
  const int vec = lda % 4 == 0 && ldb % 4 == 0 && a_z % 4 == 0 &&
                  b_z % 4 == 0 && (!AT || M % 4 == 0) &&
                  (BT || N % 4 == 0) &&
                  (!k_fast || (K % 4 == 0 && k_chunk % 4 == 0)) &&
                  ((uintptr_t)A | (uintptr_t)Bm) % 16 == 0;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, Z * splits);
  pw_gemm_kernel<AT, BT><<<grid, kThreads, 0, st>>>(
      A, Bm, Cm, M, N, K, lda, ldb, a_z, b_z, k_chunk, splits, vec);
  return (int)cudaGetLastError();
}

int dw_bwd_plane(const float* gah, const float* ahat, const float* rstd_a,
                 const float* x, const float* dw, float* gx, float* gdw_part,
                 int B, int C, int H, int W, cudaStream_t st) {
  const size_t smem = 3 * sizeof(float) * (H + 2) * (W + 2);
  if (smem <= kPlaneSmem) {
    // above 48 KB of dynamic shared memory only when asked for; asked once
    // per device, since the call costs the host more than the launch
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    if (int e = (int)cudaGetDevice(&dev)) return e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
      if (int e = (int)cudaFuncSetAttribute(
              dw_bwd_plane_kernel<true>,
              cudaFuncAttributeMaxDynamicSharedMemorySize, kPlaneSmem))
        return e;
      raised[dev] = true;
    }
    dw_bwd_plane_kernel<true><<<B * C, kThreads, smem, st>>>(
        gah, ahat, rstd_a, x, dw, gx, gdw_part, C, H, W);
  } else {
    dw_bwd_plane_kernel<false><<<B * C, kThreads, 0, st>>>(
        gah, ahat, rstd_a, x, dw, gx, gdw_part, C, H, W);
  }
  return (int)cudaGetLastError();
}

// Pixels per split-k partial of the pointwise weight gradient (M x C) over
// B samples of n pixels: a multiple of GK chosen so that output tiles x
// (sample, chunk) partials make about as many blocks as sms SMs hold at
// once, and one chunk where the batch and tiles fill them already. Fixed
// for a shape and a card, so the ordered sum repeats bit for bit.
int pw_grad_chunk(int B, int C, int M, int n, int sms) {
  const int tiles = (M + GM - 1) / GM * ((C + GN - 1) / GN);
  const int splits = std::max(
      1, std::min((n + GK - 1) / GK, kGemmBlocksPerSM * sms / (tiles * B)));
  const int chunk = (n + splits - 1) / splits;
  return (chunk + GK - 1) / GK * GK;
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
  const int n = H * W;
  dw_in_fwd_kernel<<<B * C, kThreads, 0, st>>>(x, dw, ahat, rstd_a, C, H, W);
  if (int e = (int)cudaGetLastError()) return e;
  // b[b] (M x n) = pw (M x C) . a-hat[b] (C x n)
  if (int e = gemm<false, false>(pw, ahat, bhat, M, n, C, C, n, 0,
                                 (long long)C * n, C, B, st))
    return e;
  if (n <= kThreads * kPPT)  // the plane fits in registers
    in_fwd_kernel<kPPT><<<B * M, kThreads, 0, st>>>(bhat, rstd_b, res, y, n,
                                                    relu);
  else
    in_fwd_kernel<0><<<B * M, kThreads, 0, st>>>(bhat, rstd_b, res, y, n, relu);
  return (int)cudaGetLastError();
}

// The number of (M, C) partials that gcc_stage_bwd_pw sums into gpw on a
// card of sms SMs: the size of its gpw_part scratch. Returns a count, not
// an error.
int gcc_stage_bwd_pw_partials(int B, int C, int M, int H, int W, int sms) {
  const int n = H * W, k_chunk = pw_grad_chunk(B, C, M, n, sms);
  return B * ((n + k_chunk - 1) / k_chunk);
}

// Backward, pointwise side: relu + IN2 + pointwise conv. g (B,M,H,W) is
// d(loss)/dy. Writes gah = d(loss)/d(a-hat) (B,C,H,W) and gpw (M,C,1,1).
// Scratch: gb (B,M,H,W); gpw_part (gcc_stage_bwd_pw_partials(B, C, M, H, W,
// sms), M, C), sms the card's SM count.
int gcc_stage_bwd_pw(const float* g, const float* ahat, const float* bhat,
                     const float* rstd_b, const float* pw, float* gb,
                     float* gah, float* gpw_part, float* gpw, int B, int C,
                     int M, int H, int W, int relu, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = H * W, k_chunk = pw_grad_chunk(B, C, M, n, sms);
  if (n <= kThreads * kPPT)
    in_bwd_kernel<kPPT><<<B * M, kThreads, 0, st>>>(g, bhat, rstd_b, gb, n,
                                                    relu);
  else
    in_bwd_kernel<0><<<B * M, kThreads, 0, st>>>(g, bhat, rstd_b, gb, n, relu);
  if (int e = (int)cudaGetLastError()) return e;
  // gah[b] (C x n) = pw^T (C x M) . gb[b] (M x n)
  if (int e = gemm<true, false>(pw, gb, gah, C, n, M, C, n, 0,
                                (long long)M * n, M, B, st))
    return e;
  // gpw partial [b, s] (M x C) = gb[b] (M x chunk s) . a-hat[b]^T (chunk s x C)
  if (int e = gemm<false, true>(gb, ahat, gpw_part, M, C, n, n, n,
                                (long long)M * n, (long long)C * n, k_chunk,
                                B, st))
    return e;
  const int splits = (n + k_chunk - 1) / k_chunk;
  return sum_partials(gpw_part, gpw, B * splits, (long long)M * C, st);
}

// Backward, depthwise side: IN1 + depthwise conv + reflect-pad adjoint.
// gah (B,C,H,W) from gcc_stage_bwd_pw. Writes gx (B,C,H,W) and gdw
// (C,1,3,3). Scratch: gdw_part (B, C, 9).
int gcc_stage_bwd_dw(const float* gah, const float* ahat, const float* rstd_a,
                     const float* x, const float* dw, float* gx,
                     float* gdw_part, float* gdw, int B, int C, int H, int W,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int e = dw_bwd_plane(gah, ahat, rstd_a, x, dw, gx, gdw_part, B, C, H, W,
                           st))
    return e;
  return sum_partials(gdw_part, gdw, B, (long long)C * 9, st);
}

}  // extern "C"
