// Flash self-attention for SAGAN on Hopper (sm_90a), one head, with fp32
// q, k, v and dO; and, for bf16 inputs, the streaming kernels of the wide
// shapes that flash_attention_bf16.cu's kernels do not hold.
//
//   O = softmax(q k^T) v  with UNSCALED logits (no 1/sqrt(d), SAGAN.py:97-103)
//   lse_i = log sum_j exp(q_i . k_j)
//
// Layout: channel-major, the layout the 1x1 q/k/v convs leave in NCHW:
// q, k (B, dq, N), v and O (B, dv, N), lse and delta (B, N). The kernels read
// it directly (every tile load runs along N, so it is coalesced); the wrapper
// makes no transposed copies.
//
// Replaces the three Pallas kernels of gcc_tpu/ops/pallas/attention.py:
//   gcc_attn_fwd[_bf16_wide]  <- _attn_fwd_kernel     (:44,  pallas_call :197)
//   gcc_attn_bwd[_bf16_wide]  <- _attn_bwd_dq_kernel  (:81,  pallas_call :277)
//                              + _attn_bwd_dkv_kernel (:110, pallas_call :295)
//
// bf16 here: only the wide route, gcc_attn_fwd_bf16_wide
// (attn_fwd_kernel<bf16, 8, true>) and gcc_attn_bwd_bf16_wide
// (attn_bwd_wide_kernel<bf16>), for the shapes whose bf16 tiles do not fit
// one block of flash_attention_bf16.cu (gcc_attn_bf16_serves there: the
// forward at dq > 290, the backward at dq + dv > 336 after padding, e.g.
// chip_smoke.py's wide_q and SAGAN D's attn2 backward at dq 64 / dv 512).
// Those kernels are templated on the storage type T of q, k, v, dO, O, dq,
// dk and dv. A bf16 element is widened to fp32 as its tile is loaded, and
// everything after that is the fp32 kernel's arithmetic (attention.py:54-56,
// :89-94, :119-124 upcast the same way); O, dq, dk and dv round to bf16
// once, on their store (:70, :103, :134-135). lse, delta and the dq
// partials stay fp32. cp.async copies bytes and cannot widen, so the bf16
// tile loader is synchronous: each thread reads 4 bf16 (8 bytes) through
// the read-only path, widens them in registers and stores a float4 to
// shared memory (one bf16 at a time where N % 4 != 0). The products stay
// split-TF32 on the same fragments; a bf16 value is exact in tf32, so its
// lo part is 0 and the mma with it adds nothing: the bf16 instantiations
// skip them (mma_x), one mma a product for S^T = k^T q and dP^T = v^T dO
// (both operands bf16), two for dV, dK and dQ (one bf16 operand). The bf16
// backward sums in one way of its own: S^T and dP^T per 8 channels, dK and
// dV per query tile, go into zeroed partials added in fp32 (kq_product,
// pt_accumulate), where the fp32 kernel keeps the tensor cores' running
// sums, whose truncations lean one way. The resident kernels
// (attn_fwd_kernel<T, VT, false>, attn_bwd_kernel) run fp32 only.
//
// Backward (FlashAttention-style): p_ij = exp(q_i . k_j - lse_i),
// delta_i = dO_i . O_i (a torch reduction in the wrapper, as the JAX package
// computes it outside its kernel), ds_ij = p_ij (dO_i . v_j - delta_i),
// dq = ds k, dk = ds^T q, dv = p^T dO.
//
// Products run on the tensor cores in split-TF32 (tf32_mma.cuh: operands
// x = hi + lo, three mma.sync.m16n8k8 .tf32 per product, 165 TFLOP/s against
// 67 on the fp32 CUDA cores). [channel][token] tiles have a row stride of
// LDT = 72 floats, so every fragment load of a warp hits 32 distinct banks.
//
// Forward (FlashAttention-2 style). Per (sample, query, key) pair it does
// 2(dq + dv) flops and one exp; the main path's shapes (N = 1024, dq 8 /
// dv 64 teacher, dq 2 / dv 16 student) give 70-150 flops per byte of
// q/k/v/O, so the work is bound by operations, not by the 3.35 TB/s of HBM.
// No N x N matrix ever reaches device memory.
//  * The TPU kernel carries m, l and the accumulator across a sequential
//    innermost grid axis. CUDA blocks run in no order, so each block owns a
//    128-query tile of O (8 warps, 16 queries each; the tile's q resident in
//    shared memory) and walks the 64-key tiles itself, fetching tile j + 1
//    of k and v with cp.async into the second of two shared-memory stages
//    while tile j computes.
//  * S = q^T k stays in fp32 on the CUDA cores, computed directly in the
//    m16n8 accumulator layout (a thread holds queries g and g + 8 of its
//    warp against keys 8 nt + 2t, + 1). The error of a split-TF32 S is
//    absolute and grows with |S|, and at q, k scale 2 (max |S| ~ 80) it
//    would take much of O's bound of 1e-5 max(|ref|, 1); with S in fp32
//    the kernel's arithmetic stays within half the bound
//    (tests/test_torch_attention.py::test_fwd_precision emulates it). S is
//    dq / (dq + dv) of the flops: 1/9 at both main-path widths.
//  * Online softmax on the fragments: row max and sum over the 4 lanes of a
//    quad (shfl_xor 1, 2); p = 2^(s log2 e - m log2 e) as one FMA and
//    ex2.approx (relative error ~2^-22; the rounding of m log2 e shifts a
//    whole row alike and cancels in O).
//  * O = alpha O + P V^T, the product on the tensor cores in split-TF32. P
//    is taken from the S accumulators as the A operand with the k index
//    (keys) permuted: column t is key 2t and t + 4 is key 2t + 1, which is
//    where the accumulator holds them, so V's B fragment is one ld2 of
//    Vs[channel][8 kk + 2t]. The backward forms dV the same way. The
//    tensor cores truncate as they accumulate, so each tile's product goes
//    into a zeroed partial that is added to O in fp32 (one FMA with the
//    rescale factor alpha). Summed straight into O, the truncations of 16
//    tiles x 24 mma all lean one way; emulated at q, k scale 2 they exceed
//    O's bound.
//  * Widths: dv is covered in chunks of 8 VT channels (VT = 1, 2, 4, 8 by
//    dv; V rows past dv zero in shared memory) on a grid axis, and each
//    chunk recomputes S; only chunk 0 writes lse. Any N: a ragged key tile
//    is masked by index, rows past N are not written. Any dq: where the
//    resident q tile and two k/v stages fit two blocks an SM (fwd_smem, dq
//    up to 72 at dv > 32: the main path's dq 8 / dv 64 and dq 2 / dv 16,
//    and SAGAN D's attn2 at dq 64 / dv 512), the block keeps its q; wider
//    (dq 320 of chip_smoke.py's wide_q) it runs attn_fwd_kernel<T, 8, true>,
//    which streams q and k through shared memory in 64-channel chunks for
//    each key tile (88 KB whatever dq is). The TPU's 128-lane padding of
//    dq/dv, its -1e30 sentinel feature column (attention.py:155-176) and
//    its lane-replicated (B, N, 128) lse/delta tiles are not carried over:
//    they are plain (B, N).
//  * O is stored from the accumulators: each store of a warp writes four
//    channels x 8 consecutive queries, whole 32-byte sectors.
//  * Registers of the fp32 instantiations (nvcc -Xptxas -v, sm_90a, CUDA
//    12.8): two blocks of 256 threads allow 128; <VT 8> (dv 64) uses them
//    and spills 44 B of stores, <4>, <2> and <1> use 123, 109 and 111
//    without spilling; the wide <8, true> spills 436 B. Dynamic shared
//    memory (fwd_smem): 45,568 B at dq 8 / dv 64, 11,392 B at dq 2 /
//    dv 16, 88,064 B wide.
//
// Backward, one pass. Per pair it needs S = q.k, p = exp(S - lse), dP =
// dO.v, ds, and three products into dq, dk, dv: 2(3 dq + 2 dv) flops, one
// exp. Split as the TPU's two kernels are, S and dP are computed twice.
//  * Block (key-tile group, output chunk, sample); for each key tile j of
//    64 keys of its group, k_j and v_j are loaded once and the block walks
//    the query tiles i, fetching tile i + 1
//    (q, dO, lse, delta) with cp.async into the second of two shared-memory
//    stages while tile i computes, keeping dK_j and dV_j in registers.
//    Each product is computed once per pair. dq, a sum over key tiles, goes
//    through partials of a bounded number of key-tile groups: G =
//    ceil(nkt / per) groups of per = ceil(nkt / min(nkt, 16)) consecutive
//    key tiles (dq_groups; G = nkt = 16 at N = 1024). Block x walks the
//    key tiles of group x in order and adds each tile's dQ into its
//    group's partial (B, G, dq, N) itself; attn_dq_reduce_kernel sums the
//    G partials in group order. No float atomics, so two calls on the same
//    inputs give the same bits, and the scratch is at most 16 dq N floats
//    a sample (33.5 MB at N = 65 536, dq 8) where per-key-tile partials
//    took nkt dq N (2.1 GB).
//  * Every product runs on the tensor cores in split-TF32, 8 warps. Warp w
//    owns keys 16 (w % 4).. and queries 32 (w / 4).. of a tile: 4 m16n8
//    accumulator fragments each for S^T and dP^T. P^T and dS^T stay in those
//    fragments and are the A operands of dV += P^T dO^T and dK += dS^T q^T
//    (the k index permuted to where the accumulator holds each query); the
//    two warps of a key group sum their dK, dV halves at the end. dS goes
//    through shared memory once for dQ = dS k^T (warps 0-3, 16 queries
//    each). Eight warps of at most 128 registers (__launch_bounds__(256, 2))
//    put two blocks, 16 warps, on an SM to hide the latency of the mma
//    chains.
//  * Split-TF32 keeps the gradients inside 1e-4 max(|ref|, 1), plain TF32
//    does not: test_split_tf32_precision (tests/test_torch_attention.py)
//    emulates these products at B 1, N 256, dq 8, dv 64 against float64:
//    dq/dk/dv err 4.7e-3 / 4.6e-3 / 1.1e-3 with TF32 operands (tolerances
//    1.5e-4 / 1.4e-4 / 1.0e-4), 1.8e-6 / 2.0e-6 / 5.2e-7 split, 4.8e-7 /
//    3.1e-7 / 8.0e-8 fp32.
//  * exp is __expf (ex2.approx), less exact than expf in its last bits; the
//    gradients stay far inside their bound (chip_smoke.py phase 6).
//  * Widths: dq and dv are padded with zero rows to multiples of 8 in shared
//    memory (dq 2 runs as 8). dK chunks of 8 QT channels (QT = 1, 4, 8 by
//    dq) and dV chunks of 8 VT (VT = 2, 8 by dv) live in registers; wider
//    outputs take more chunks as a grid axis, whose blocks past the first
//    recompute P (and dS where they hold a dK chunk). Where the resident
//    k/v tile and two q/dO stages fit two blocks an SM (bwd_smem: dq + dv
//    up to 112 after padding, the main path's dq 8 / dv 64 and dq 2 /
//    dv 16) the block runs as above; wider (SAGAN D's attn2 at dq 64 /
//    dv 512, chip_smoke.py's ragged dq 25 / dv 200 and wide_q dq 320 /
//    dv 320) attn_bwd_wide_kernel holds nothing resident: per (key tile,
//    query tile) it streams k/q, then v/dO, in 64-channel chunks through
//    two [64][LDT] buffers, and the rows of its dK, dV and dQ chunks as
//    it needs them (56 KB whatever the widths; 64-channel dK and dV chunks,
//    one stage, no prefetch). No width is refused: dq and dv are ints, and
//    the grid's y axis takes up to 65 535 chunks of 64 channels.
//  * Registers and shared memory of the fp32 instantiations (nvcc -Xptxas
//    -v, sm_90a, CUDA 12.8): they use the 128 registers that two blocks of
//    256 threads allow. <1, 8> (the teacher's dq 8 / dv 64) spills 32 B
//    of stores to a 24-byte stack frame, <1, 2> (the student's dq 2 /
//    dv 16) 60 B to 48,
//    <8, 8> 200 B to 144, the wide kernel 568 B to 272; the others do not
//    spill. Dynamic shared memory (bwd_smem): 81,664 B at dq 8 / dv 64 and
//    40,192 B at dq 2 / dv 16, two stages each; 55,808 B wide. The dq
//    reduction uses 32 registers.
//
// Every entry point returns cudaGetLastError() as an int; the Python wrapper
// raises when it is not 0. Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using namespace tf32x3;
using bf16 = __nv_bfloat16;

// bf16 instantiations accumulate dK and dV through per-tile partials
// (pt_accumulate) and S^T and dP^T through per-8-channel ones
// (kq_product), and skip the split-TF32 products of a zero lo part (mma_x)
template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

// d += a b in split-TF32 (mma3) where an operand whose values came from
// bf16 (XA for a, XB for b) is exact in tf32: its lo part is 0, and the
// products with it, which add 0 to d, are skipped. mma_x<false, false> is
// mma3.
template <bool XA, bool XB>
__device__ __forceinline__ void mma_x(float (&d)[4], const FragA& a,
                                      const FragB& b) {
  if constexpr (!XA) mma_tf32(d, a.lo, b.hi);
  if constexpr (!XB) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Stores of O, dq, dk and dv: fp32 as is, bf16 rounded to nearest even.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;     // 8 warps, every kernel but the reduction
constexpr int BT = 64;            // keys (forward) or queries (backward) of a
                                  // streamed tile
constexpr int LDT = BT + 8;       // row stride of a [channel][token] tile
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// dst[c * LD + t] = src[c * N + n0 + t] for c < D, t < TW, zero past N:
// 16-byte copies when vec (N % 4 == 0, aligned bases), else 4-byte ones.
template <int TW = BT, int LD = LDT>
__device__ __forceinline__ void cp_tile(float* dst, const float* src, int D,
                                        int N, int n0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < D * (TW / 4); e += kThreads) {
      const int c = e / (TW / 4), t = 4 * (e % (TW / 4)), n = n0 + t;
      cp_async(dst + c * LD + t, src + (size_t)c * N + (n < N ? n : 0),
               n < N ? 16 : 0, true);
    }
  } else {
    for (int e = threadIdx.x; e < D * TW; e += kThreads) {
      const int c = e / TW, t = e % TW, n = n0 + t;
      cp_async(dst + c * LD + t, src + (size_t)c * N + (n < N ? n : 0),
               n < N ? 4 : 0, false);
    }
  }
}

// The same tile from bf16, widened to fp32: synchronous loads (8 bytes when
// vec: N % 4 == 0 and 8-byte aligned bases, else 2), float stores. A bf16's
// bits are the high half of its fp32 value's.
template <int TW = BT, int LD = LDT>
__device__ __forceinline__ void cp_tile(float* dst, const bf16* src, int D,
                                        int N, int n0, bool vec) {
  if (vec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < D * (TW / 4); e += kThreads) {
      const int c = e / (TW / 4), t = 4 * (e % (TW / 4)), n = n0 + t;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) {
        const uint2 r =
            __ldg(reinterpret_cast<const uint2*>(src + (size_t)c * N + n));
        f = make_float4(__uint_as_float(r.x << 16),
                        __uint_as_float(r.x & 0xffff0000u),
                        __uint_as_float(r.y << 16),
                        __uint_as_float(r.y & 0xffff0000u));
      }
      *reinterpret_cast<float4*>(dst + c * LD + t) = f;
    }
  } else {
    for (int e = threadIdx.x; e < D * TW; e += kThreads) {
      const int c = e / TW, t = e % TW, n = n0 + t;
      dst[c * LD + t] =
          n < N ? __bfloat162float(src[(size_t)c * N + n]) : 0.f;
    }
  }
}

__device__ __forceinline__ void zero_rows(float* dst, int from, int to) {
  for (int e = threadIdx.x; e < (to - from) * LDT; e += kThreads)
    dst[from * LDT + e] = 0.f;
}

// ---------------------------------------------------------------------------
// Forward: S in fp32 on the CUDA cores, O += P V^T on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 128;  // queries of a forward block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, ex2.approx
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (16 queries x 64 keys a warp; fragment nt holds keys 8 nt + 2t, + 1)
// += q^T k over the n channels of a [n][BQ] q tile and a [n][LDT] k tile.
__device__ __forceinline__ void s_rows(float (&S)[8][4], const float* Qs,
                                       const float* Ks, int n, int qw, int g,
                                       int t) {
  for (int c = 0; c < n; ++c) {
    const float qa = Qs[c * BQ + qw + g], qb = Qs[c * BQ + qw + g + 8];
    const float* kr = Ks + c * LDT + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 x = ld2(kr + 8 * nt);
      S[nt][0] = fmaf(qa, x.x, S[nt][0]);
      S[nt][1] = fmaf(qa, x.y, S[nt][1]);
      S[nt][2] = fmaf(qb, x.x, S[nt][2]);
      S[nt][3] = fmaf(qb, x.y, S[nt][3]);
    }
  }
}

constexpr int DC = 64;  // channels of a streamed chunk on the wide paths

// Block (query tile of BQ, dv chunk y of 8 VT channels, sample b). Warp w
// owns queries qw = 16 w .. qw + 15 of the tile; per key tile j:
//   S = q^T k_j (fp32), m, l and O rescaled by the online softmax,
//   O += P V_j^T  (split-TF32, P from S's accumulator fragments).
// Lane (g, t) holds rows qw + g and qw + g + 8: m[0], l[0] and O[nt][0..1]
// for the first, m[1], l[1] and O[nt][2..3] for the second.
// WIDE: the q tile is not resident; each key tile's S streams q and k in
// DC-channel chunks through Qs and Kc, and the two stages hold v alone.
template <typename T, int VT, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int N, int dq, int dv, int vec) {
  constexpr int CW = 8 * VT;  // channels of a chunk
  extern __shared__ __align__(16) float sm[];
  const int kd = WIDE ? 0 : dq;       // k rows of a stage
  const int stage = (kd + CW) * LDT;  // k tile [kd][LDT], v tile [CW][LDT]
  float* Qs = sm;  // [dq][BQ] the block's queries, resident; WIDE: [DC][BQ]
  float* Kc = Qs + (WIDE ? DC : dq) * BQ;  // WIDE: a k chunk [DC][LDT]
  float* st0 = Kc + (WIDE ? DC * LDT : 0);  // two stages

  const int b = blockIdx.z, c0 = blockIdx.y * CW, r0 = blockIdx.x * BQ;
  const int cw = min(CW, dv - c0);  // channels of the chunk that exist
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, qw = 16 * warp;
  const T* qb = q + (size_t)b * dq * N;
  const T* kb = k + (size_t)b * dq * N;
  const T* vb = v + ((size_t)b * dv + c0) * N;

  for (int s = 0; s < 2; ++s) zero_rows(st0 + s * stage + kd * LDT, cw, CW);
  if (!WIDE) cp_tile<BQ, BQ>(Qs, qb, dq, N, r0, vec);
  auto fetch = [&](int j, int s) {
    float* Ks = st0 + s * stage;
    if (!WIDE) cp_tile(Ks, kb, dq, N, j * BT, vec);
    cp_tile(Ks + kd * LDT, vb, cw, N, j * BT, vec);
  };
  fetch(0, 0);
  cp_commit();

  float O[VT][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int nkt = (N + BT - 1) / BT;
  for (int j = 0; j < nkt; ++j) {
    const int s = j & 1, n0 = j * BT;
    if (j + 1 < nkt) {  // fetch tile j + 1 while j computes
      fetch(j + 1, s ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Ks = st0 + s * stage;
    const float* Vs = Ks + kd * LDT;

    float S[8][4] = {};
    if (WIDE) {
      for (int cq = 0; cq < dq; cq += DC) {
        const int n = min(DC, dq - cq);
        __syncthreads();  // readers of the previous chunk are done
        cp_tile<BQ, BQ>(Qs, qb + (size_t)cq * N, n, N, r0, vec);
        cp_tile(Kc, kb + (size_t)cq * N, n, N, n0, vec);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        s_rows(S, Qs, Kc, n, qw, g, t);
      }
    } else {
      s_rows(S, Qs, Ks, dq, qw, g, t);
    }
    if (n0 + BT > N) {  // ragged key tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = n0 + 8 * nt + 2 * t;
        if (key >= N) S[nt][0] = S[nt][2] = -INFINITY;
        if (key + 1 >= N) S[nt][1] = S[nt][3] = -INFINITY;
      }
    }
    // online softmax; key n0 < N is in every tile, so the row max is finite
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(S[nt][0], S[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(S[nt][2], S[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
    const float a0 = ex2(fmaf(m[0], kLog2e, -ml0));  // 0 on the first tile
    const float a1 = ex2(fmaf(m[1], kLog2e, -ml1));
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      S[nt][0] = ex2(fmaf(S[nt][0], kLog2e, -ml0));
      S[nt][1] = ex2(fmaf(S[nt][1], kLog2e, -ml0));
      S[nt][2] = ex2(fmaf(S[nt][2], kLog2e, -ml1));
      S[nt][3] = ex2(fmaf(S[nt][3], kLog2e, -ml1));
      ps0 += S[nt][0] + S[nt][1];
      ps1 += S[nt][2] + S[nt][3];
    }
    l[0] = l[0] * a0 + quad_sum(ps0);
    l[1] = l[1] * a1 + quad_sum(ps1);
    m[0] = mx0;
    m[1] = mx1;

    // The tile's P V^T (k = its keys; k column t is key 2t, t + 4 is
    // 2t + 1) into a zeroed partial, then O = alpha O + partial in fp32.
    // The tensor cores' accumulation truncates: summed straight into O,
    // each mma would cost up to an ulp of |O|, all one way; the partial's
    // truncations are relative to one tile's sum.
    float Tp[VT][4] = {};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const FragA a = frag_a(S[kk][0], S[kk][2], S[kk][1], S[kk][3]);
#pragma unroll
      for (int nt = 0; nt < VT; ++nt) {
        if (8 * nt >= cw) break;
        const float2 x = ld2(Vs + (8 * nt + g) * LDT + 8 * kk + 2 * t);
        mma_x<false, kBf16<T>>(Tp[nt], a, frag_b(x.x, x.y));
      }
    }
#pragma unroll
    for (int nt = 0; nt < VT; ++nt) {
      O[nt][0] = fmaf(O[nt][0], a0, Tp[nt][0]);
      O[nt][1] = fmaf(O[nt][1], a0, Tp[nt][1]);
      O[nt][2] = fmaf(O[nt][2], a1, Tp[nt][2]);
      O[nt][3] = fmaf(O[nt][3], a1, Tp[nt][3]);
    }
    __syncthreads();  // readers of stage s are done
  }

  // rows qw + g (r < 2) and qw + g + 8, channels 8 nt + 2t + (r & 1)
  const int n_lo = r0 + qw + g, n_hi = n_lo + 8;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  T* ob = o + ((size_t)b * dv + c0) * N;
#pragma unroll
  for (int nt = 0; nt < VT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 8 * nt + 2 * t + (r & 1), n = r < 2 ? n_lo : n_hi;
      if (c < cw && n < N)
        put(ob + (size_t)c * N + n, O[nt][r] * (r < 2 ? inv0 : inv1));
    }
  if (blockIdx.y == 0 && t == 0) {
    if (n_lo < N) lse[(size_t)b * N + n_lo] = m[0] + logf(l[0]);
    if (n_hi < N) lse[(size_t)b * N + n_hi] = m[1] + logf(l[1]);
  }
}

// Shared memory of attn_fwd_kernel<T, VT, wide>, in bytes.
size_t fwd_smem(int dq, int vt, bool wide) {
  const size_t q = wide ? (size_t)DC * (BQ + LDT) : (size_t)dq * BQ;
  return 4 * (q + 2 * (size_t)((wide ? 0 : dq) + 8 * vt) * LDT);
}

// vec: whole 4-element groups along N from aligned bases (16 bytes of fp32,
// 8 of bf16)
template <typename T>
int vec_ok(int N, uintptr_t bases) {
  return N % 4 == 0 && bases % (4 * sizeof(T)) == 0;
}

template <typename T, int VT, bool WIDE>
int fwd(const T* q, const T* k, const T* v, T* o, float* lse, int B, int N,
        int dq, int dv, cudaStream_t st) {
  const size_t smem = fwd_smem(dq, VT, WIDE);
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_kernel<T, VT, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int vec =
      vec_ok<T>(N, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v);
  const dim3 grid((N + BQ - 1) / BQ, (dv + 8 * VT - 1) / (8 * VT), B);
  attn_fwd_kernel<T, VT, WIDE><<<grid, kThreads, smem, st>>>(
      q, k, v, o, lse, N, dq, dv, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: one pass over the (query, key) pairs on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BH = BT / 2;     // queries of a warp in a tile
constexpr int kDqGroups = 16;  // most key-tile groups of the dq partials

// A[nt] += X^T Y over rows [0, n) (n a multiple of 8) of two [n][LDT]
// tiles: X's columns kw.. (keys) are the product's 16 rows, Y's columns
// qh + 8 nt.. (queries) its columns. S^T from k and q, dP^T from v and dO.
// X: both tiles hold bf16 values (one mma a product, mma_x), and each 8
// channels' mma goes into a zeroed partial added to A in fp32. The tensor
// cores truncate as they accumulate; summed straight into A over dv's 64
// channels, dP^T's truncations moved the bf16 dq at q, k scale 2 (where
// ds = p (dP - delta) cancels) farther from the float64 answer than the
// plain version (3.24 % of its elements rounded apart against 3.06 %), and
// with the partials it is nearer (2.46 % against 2.63 %, chip_smoke.py
// phase 18). fp32 keeps its running sum, and its bits.
template <bool X>
__device__ __forceinline__ void kq_product(float (&A)[4][4], const float* X_,
                                           const float* Y, int n, int kw,
                                           int qh, int g, int t) {
  for (int c0 = 0; c0 < n; c0 += 8) {
    const float* kr = X_ + (c0 + t) * LDT + kw + g;
    const FragA a = frag_a(kr[0], kr[8], kr[4 * LDT], kr[4 * LDT + 8]);
    const float* qr = Y + (c0 + t) * LDT + qh + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const FragB b = frag_b(qr[8 * nt], qr[4 * LDT + 8 * nt]);
      if constexpr (X) {
        float p[4] = {};
        mma_x<X, X>(p, a, b);
#pragma unroll
        for (int r = 0; r < 4; ++r) A[nt][r] += p[r];
      } else {
        mma_x<X, X>(A[nt], a, b);
      }
    }
  }
}

// P^T = exp(S^T - lse) in place; 0 for keys or queries past N.
__device__ __forceinline__ void softmax_p(float (&P)[4][4], const float* Ls,
                                          int n0, int N, int qh, int t,
                                          bool key_lo, bool key_hi) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int qi = qh + 8 * nt + 2 * t;
    const float2 l = ld2(Ls + qi);
    const bool q0 = n0 + qi < N, q1 = n0 + qi + 1 < N;
    P[nt][0] = key_lo && q0 ? __expf(P[nt][0] - l.x) : 0.f;
    P[nt][1] = key_lo && q1 ? __expf(P[nt][1] - l.y) : 0.f;
    P[nt][2] = key_hi && q0 ? __expf(P[nt][2] - l.x) : 0.f;
    P[nt][3] = key_hi && q1 ? __expf(P[nt][3] - l.y) : 0.f;
  }
}

// D[nt] += A R^T for the channels 8 nt.. (8 nt < n) of R, a [channel][LDT]
// tile over the query tile: A is P^T or dS^T in its accumulator fragments,
// taken as the A operand with the k index (queries) permuted so that k
// column t is query 2t and t + 4 is 2t + 1. dV from dO, dK from q.
// X: R holds bf16 values (two mma a product, mma_x).
template <bool X, int T>
__device__ __forceinline__ void pt_product(float (&D)[T][4],
                                           const float (&A)[4][4],
                                           const float* R, int n, int qh,
                                           int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const FragA a = frag_a(A[kk][0], A[kk][2], A[kk][1], A[kk][3]);
#pragma unroll
    for (int nt = 0; nt < T; ++nt) {
      if (8 * nt >= n) break;
      const float2 x = ld2(R + (8 * nt + g) * LDT + qh + 8 * kk + 2 * t);
      mma_x<false, X>(D[nt], a, frag_b(x.x, x.y));
    }
  }
}

// D[nt] += A R^T as pt_product; for bf16 (BF16) through a zeroed
// partial of the one query tile, added to D in fp32, as the forward adds
// each key tile's P V^T to O. The tensor cores truncate as they
// accumulate: over the 256 query tiles of N = 16384, a running sum's
// truncations lean one way, enough to put long_n's bf16 dk and dv past
// flash_attention.BF16_SHARE of the plain version's (chip_smoke.py phase
// 18 holds them under it). fp32 keeps its running sum, and its bits.
template <bool BF16, int C>
__device__ __forceinline__ void pt_accumulate(float (&D)[C][4],
                                              const float (&A)[4][4],
                                              const float* R, int n, int qh,
                                              int g, int t) {
  if constexpr (BF16) {
    float P[C][4] = {};
    pt_product<true, C>(P, A, R, n, qh, g, t);
#pragma unroll
    for (int nt = 0; nt < C; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) D[nt][r] += P[nt][r];
  } else {
    pt_product<false, C>(D, A, R, n, qh, g, t);
  }
}

// dS^T = P^T (dP^T - delta) in place in G, and dS[query][key] to Ss.
__device__ __forceinline__ void ds_store(float (&G)[4][4],
                                         const float (&P)[4][4],
                                         const float* Ds, float* Ss, int kw,
                                         int qh, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int qi = qh + 8 * nt + 2 * t;
    const float2 d = ld2(Ds + qi);
    G[nt][0] = P[nt][0] * (G[nt][0] - d.x);
    G[nt][1] = P[nt][1] * (G[nt][1] - d.y);
    G[nt][2] = P[nt][2] * (G[nt][2] - d.x);
    G[nt][3] = P[nt][3] * (G[nt][3] - d.y);
    float* sr = Ss + qi * LDT + kw + g;
    sr[0] = G[nt][0];
    sr[LDT] = G[nt][1];
    sr[8] = G[nt][2];
    sr[LDT + 8] = G[nt][3];
  }
}

// Warp w < 4: dQ of the tile's queries 16 w.. for channels c0 + 8 nt..
// (below dqp) = dS k^T, k's rows from Kr, a [channel][LDT] tile whose row 0
// is channel c0, over the block's keys (k permuted as in pt_product: k
// column t is key 2t, t + 4 is 2t + 1). Written into the group's partial
// on the group's first key tile, added to it on the others.
template <bool X, int QT>
__device__ __forceinline__ void dq_chunk(const float* Ss, const float* Kr,
                                         int c0, int dqp, int dq, float* part,
                                         int n0, int N, bool first, int warp,
                                         int g, int t) {
  const int qw = 16 * warp;
  float acc[QT][4] = {};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float2 r0 = ld2(Ss + (qw + g) * LDT + 8 * kk + 2 * t);
    const float2 r1 = ld2(Ss + (qw + g + 8) * LDT + 8 * kk + 2 * t);
    const FragA a = frag_a(r0.x, r1.x, r0.y, r1.y);
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) {
      if (c0 + 8 * nt >= dqp) break;
      const float2 x = ld2(Kr + (8 * nt + g) * LDT + 8 * kk + 2 * t);
      mma_x<false, X>(acc[nt], a, frag_b(x.x, x.y));
    }
  }
#pragma unroll
  for (int nt = 0; nt < QT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + 8 * nt + 2 * t + (r & 1);
      const int n = n0 + qw + g + 8 * (r >> 1);
      if (c < dq && n < N) {
        float* out = part + (size_t)c * N + n;
        *out = first ? acc[nt][r] : *out + acc[nt][r];
      }
    }
}

// The two warps of a key group hold dK and dV over their query halves:
// warp w + 4's go through shared memory at sm (free when this is called)
// and are added to warp w's, in that order, which write keys kw + g and
// kw + g + 8 of dK channels ck0.. and dV channels cv0...
template <typename T, int QT, int VT>
__device__ __forceinline__ void write_dkdv(
    float (&dK)[QT][4], float (&dV)[VT][4], float* sm, T* dk_out,
    T* dv_out, int key0, int ck0, int cv0, int dq, int dv, int N,
    bool with_ds, bool with_dv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  float* red = sm + (warp & 3) * (QT + VT) * 4 * 32 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int nt = 0; nt < QT; ++nt) red[(nt * 4 + r) * 32] = dK[nt][r];
#pragma unroll
      for (int nt = 0; nt < VT; ++nt) red[((QT + nt) * 4 + r) * 32] = dV[nt][r];
    }
  }
  __syncthreads();
  if (warp >= 4) return;
  // rows are keys: (key0, key0 + 8), columns channels (2t, 2t + 1)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) dK[nt][r] += red[(nt * 4 + r) * 32];
#pragma unroll
    for (int nt = 0; nt < VT; ++nt) dV[nt][r] += red[((QT + nt) * 4 + r) * 32];
    const int key = key0 + 8 * (r >> 1);
    if (key >= N) continue;
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) {
      const int c = ck0 + 8 * nt + 2 * t + (r & 1);
      if (with_ds && c < dq) put(dk_out + (size_t)c * N + key, dK[nt][r]);
    }
#pragma unroll
    for (int nt = 0; nt < VT; ++nt) {
      const int c = cv0 + 8 * nt + 2 * t + (r & 1);
      if (with_dv && c < dv) put(dv_out + (size_t)c * N + key, dV[nt][r]);
    }
  }
}

// Block (key-tile group x, output chunk y, sample b). It walks the key
// tiles j of its group in order; for each, warp w owns keys
// kw = 16 (w % 4) .. kw + 15 of the tile and queries qh = 32 (w / 4) ..
// qh + 31 of each query tile i it walks:
//   S^T = k_j^T q_i,  P^T = exp(S^T - lse_i),  dP^T = v_j^T dO_i,
//   dS^T = P^T (dP^T - delta_i),  dV_j += P^T dO_i^T,  dK_j += dS^T q_i^T,
//   dQ_i += dS k_j^T  (into the group's partial; attn_dq_reduce_kernel sums
//   the groups).
// P^T and dS^T stay in the accumulator fragments they were computed in and
// are the A operands of the dV and dK products. Chunk y accumulates dK
// channels [8 QT y, 8 QT (y + 1)) and dV channels [8 VT y, 8 VT (y + 1));
// only blocks with a dK chunk compute dP and dS, and only y = 0 writes dQ.
template <typename T, int QT, int VT>
__global__ void __launch_bounds__(kThreads, 2) attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out,
    float* __restrict__ dq_part, int N, int dq, int dv, int per, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int dqp = (dq + 7) & ~7, dvp = (dv + 7) & ~7;  // zero rows to 8
  const int stage = (dqp + dvp) * LDT + 2 * BT;  // q, dO, lse, delta tiles
  float* Ks = sm;                  // [dqp][LDT] the key tile's k, resident
  float* Vs = Ks + dqp * LDT;      // [dvp][LDT]
  float* Ss = Vs + dvp * LDT;      // [BT][LDT] dS[query][key]
  float* st0 = Ss + BT * LDT;      // two stages

  const int b = blockIdx.z, y = blockIdx.y, ck0 = 8 * QT * y, cv0 = 8 * VT * y;
  const bool with_ds = ck0 < dq, with_dv = cv0 < dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, kw = 16 * (warp & 3), qh = BH * (warp >> 2);
  const size_t oq = (size_t)b * dq * N, ov = (size_t)b * dv * N;
  const float* lb = lse + (size_t)b * N;
  const float* db = delta + (size_t)b * N;
  const int nkt = (N + BT - 1) / BT, j_first = blockIdx.x * per;
  float* part = dq_part + ((size_t)b * gridDim.x + blockIdx.x) * dq * N;

  auto fetch = [&](int i, int s) {
    float* Qs = st0 + s * stage;
    float* Os = Qs + dqp * LDT;
    const int n0 = i * BT, n = n0 + (threadIdx.x & (BT - 1));
    cp_tile(Qs, q + oq, dq, N, n0, vec);
    cp_tile(Os, dO + ov, dv, N, n0, vec);
    if (threadIdx.x < 2 * BT) {
      const float* src = threadIdx.x < BT ? lb : db;
      cp_async(Os + dvp * LDT + threadIdx.x, src + (n < N ? n : 0),
               n < N ? 4 : 0, false);
    }
  };

  for (int jt = j_first; jt < min(nkt, j_first + per); ++jt) {
    const int j0 = jt * BT;
    const bool key_lo = j0 + kw + g < N, key_hi = j0 + kw + g + 8 < N;
    zero_rows(Ks, dq, dqp);
    zero_rows(Vs, dv, dvp);
    for (int s = 0; s < 2; ++s) {
      zero_rows(st0 + s * stage, dq, dqp);
      zero_rows(st0 + s * stage + dqp * LDT, dv, dvp);
    }
    cp_tile(Ks, k + oq, dq, N, j0, vec);
    cp_tile(Vs, v + ov, dv, N, j0, vec);
    fetch(0, 0);
    cp_commit();

    float dK[QT][4] = {}, dV[VT][4] = {};
    for (int i = 0; i < nkt; ++i) {
      const int s = i & 1, n0 = i * BT;
      if (i + 1 < nkt) {  // fetch tile i + 1 while i computes
        fetch(i + 1, s ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* Qs = st0 + s * stage;
      const float* Os = Qs + dqp * LDT;
      const float* Ls = Os + dvp * LDT;
      const float* Ds = Ls + BT;

      // P^T (16 keys x 32 queries a warp): fragment nt holds queries qh + 8 nt..
      float P[4][4] = {};
      kq_product<kBf16<T>>(P, Ks, Qs, dqp, kw, qh, g,
                           t);
      softmax_p(P, Ls, n0, N, qh, t, key_lo, key_hi);
      if (with_dv)
        pt_accumulate<kBf16<T>>(dV, P, Os + cv0 * LDT, dvp - cv0, qh, g,
                                   t);
      if (with_ds) {
        float G[4][4] = {};  // dP^T, then dS^T
        kq_product<kBf16<T>>(G, Vs, Os, dvp, kw, qh, g, t);
        ds_store(G, P, Ds, Ss, kw, qh, g, t);
        pt_accumulate<kBf16<T>>(dK, G, Qs + ck0 * LDT, dqp - ck0, qh, g,
                                   t);
        __syncthreads();  // dS of all eight warps is in Ss
        if (y == 0 && warp < 4)
          for (int cq0 = 0; cq0 < dqp; cq0 += 8 * QT)
            dq_chunk<kBf16<T>, QT>(Ss, Ks + cq0 * LDT, cq0, dqp, dq, part,
                                   n0, N, jt == j_first, warp, g, t);
      }
      __syncthreads();  // readers of stage s and of Ss are done
    }
    write_dkdv<T, QT, VT>(dK, dV, sm, dk_out + oq, dv_out + ov, j0 + kw + g,
                          ck0, cv0, dq, dv, N, with_ds, with_dv);
    __syncthreads();  // the next key tile's loads overwrite sm
  }
}

// Wide widths: nothing resident. Per (key tile, query tile) the block
// streams DC-channel chunks of k and q (for S), then the dO rows of its dV
// chunk, chunks of v and dO (for dP), the q rows of its dK chunk and, for
// y = 0, chunks of k (for dQ) through two [DC][LDT] buffers; one stage, no
// prefetch. dK and dV chunks are DC channels (QT = VT = 8).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) attn_bwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out,
    float* __restrict__ dq_part, int N, int dq, int dv, int per, int vec) {
  constexpr int QT = DC / 8, VT = DC / 8;
  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;              // [DC][LDT] k or v rows of the key tile
  float* Ys = Xs + DC * LDT;   // [DC][LDT] q or dO rows of the query tile
  float* Ss = Ys + DC * LDT;   // [BT][LDT] dS[query][key]
  float* Ls = Ss + BT * LDT;   // [BT] lse, then [BT] delta
  const float* Ds = Ls + BT;
  const int dqp = (dq + 7) & ~7, dvp = (dv + 7) & ~7;

  const int b = blockIdx.z, y = blockIdx.y, ck0 = DC * y, cv0 = DC * y;
  const bool with_ds = ck0 < dq, with_dv = cv0 < dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, kw = 16 * (warp & 3), qh = BH * (warp >> 2);
  const size_t oq = (size_t)b * dq * N, ov = (size_t)b * dv * N;
  const int nkt = (N + BT - 1) / BT, j_first = blockIdx.x * per;
  float* part = dq_part + ((size_t)b * gridDim.x + blockIdx.x) * dq * N;

  // rows [c0, c0 + DC) of a (D, N) tensor's tile at n0, rows past D zero up
  // to the multiple of 8
  auto load = [&](float* dst, const T* src, int D, int c0, int n0) {
    const int r = min(DC, D - c0), rp = min(DC, ((D + 7) & ~7) - c0);
    cp_tile(dst, src + (size_t)c0 * N, r, N, n0, vec);
    zero_rows(dst, r, rp);
  };
  auto land = []() {  // the copies and zero rows, visible to every warp
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  };

  for (int jt = j_first; jt < min(nkt, j_first + per); ++jt) {
    const int j0 = jt * BT;
    const bool key_lo = j0 + kw + g < N, key_hi = j0 + kw + g + 8 < N;
    float dK[QT][4] = {}, dV[VT][4] = {};
    for (int i = 0; i < nkt; ++i) {
      const int n0 = i * BT;
      __syncthreads();  // readers of the buffers are done
      if (threadIdx.x < 2 * BT) {
        const int n = n0 + (threadIdx.x & (BT - 1));
        const float* src = (threadIdx.x < BT ? lse : delta) + (size_t)b * N;
        cp_async(Ls + threadIdx.x, src + (n < N ? n : 0), n < N ? 4 : 0,
                 false);
      }
      float P[4][4] = {};
      for (int c0 = 0; c0 < dq; c0 += DC) {
        if (c0 > 0) __syncthreads();
        load(Xs, k + oq, dq, c0, j0);
        load(Ys, q + oq, dq, c0, n0);
        land();
        kq_product<kBf16<T>>(P, Xs, Ys, min(DC, dqp - c0), kw, qh, g,
                             t);
      }
      softmax_p(P, Ls, n0, N, qh, t, key_lo, key_hi);
      if (with_dv) {
        __syncthreads();
        load(Ys, dO + ov, dv, cv0, n0);
        land();
        pt_accumulate<kBf16<T>>(dV, P, Ys, dvp - cv0, qh, g, t);
      }
      if (with_ds) {
        float G[4][4] = {};
        for (int c0 = 0; c0 < dv; c0 += DC) {
          __syncthreads();
          load(Xs, v + ov, dv, c0, j0);
          load(Ys, dO + ov, dv, c0, n0);
          land();
          kq_product<kBf16<T>>(G, Xs, Ys, min(DC, dvp - c0), kw, qh, g,
                               t);
        }
        ds_store(G, P, Ds, Ss, kw, qh, g, t);
        __syncthreads();
        load(Ys, q + oq, dq, ck0, n0);
        land();  // dS of all eight warps is in Ss too
        pt_accumulate<kBf16<T>>(dK, G, Ys, dqp - ck0, qh, g, t);
        if (y == 0) {
          for (int cq0 = 0; cq0 < dq; cq0 += DC) {
            __syncthreads();
            load(Xs, k + oq, dq, cq0, j0);
            land();
            if (warp < 4)
              dq_chunk<kBf16<T>, QT>(Ss, Xs, cq0, dqp, dq, part, n0, N,
                                     jt == j_first, warp, g, t);
          }
        }
      }
    }
    __syncthreads();  // readers of the buffers are done: sm is reused
    write_dkdv<T, QT, VT>(dK, dV, sm, dk_out + oq, dv_out + ov, j0 + kw + g,
                          ck0, cv0, dq, dv, N, with_ds, with_dv);
    __syncthreads();  // before the next key tile's loads
  }
}

// dq[b, c, n] = sum_x dq_part[b, x, c, n] over the groups x in order: no
// float atomics; rounded once to T.
template <typename T>
__global__ void __launch_bounds__(256) attn_dq_reduce_kernel(
    const float* __restrict__ dq_part, T* __restrict__ dq_out, int ng,
    int dqn, int total) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  const int b = e / dqn;
  const float* p = dq_part + (size_t)b * ng * dqn + (e - b * dqn);
  float s = 0.f;
  for (int j = 0; j < ng; ++j) s += p[(size_t)j * dqn];
  put(dq_out + e, s);
}

// The key-tile groups of the dq partials for N keys: per =
// ceil(nkt / min(nkt, kDqGroups)) consecutive key tiles a group; returns the
// number of groups, ceil(nkt / per) <= kDqGroups.
int dq_groups(int N, int* per) {
  const int nkt = (N + BT - 1) / BT, p = (nkt + kDqGroups - 1) / kDqGroups;
  if (per) *per = p;
  return (nkt + p - 1) / p;
}

// Shared memory of attn_bwd_kernel (two stages) and attn_bwd_wide_kernel.
size_t bwd_smem(int dq, int dv) {
  const size_t rows = ((dq + 7) & ~7) + ((dv + 7) & ~7);
  return 4 * (rows * LDT * 3 + 2 * BT * 2 + BT * LDT);
}
constexpr size_t kWideBwdSmem = 4 * ((2 * DC + BT) * LDT + 2 * BT);

template <typename T, typename Kernel>
int bwd_launch(Kernel kernel, size_t smem, int ny, const T* q, const T* k,
               const T* v, const T* dO, const float* lse, const float* delta,
               T* dq_out, T* dk_out, T* dv_out, float* dq_part, int B, int N,
               int dq, int dv, cudaStream_t st) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int vec = vec_ok<T>(N, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                   (uintptr_t)dO);
  int per;
  const int ng = dq_groups(N, &per);
  kernel<<<dim3(ng, ny, B), kThreads, smem, st>>>(
      q, k, v, dO, lse, delta, dk_out, dv_out, dq_part, N, dq, dv, per, vec);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  const int total = B * dq * N;
  attn_dq_reduce_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(
      dq_part, dq_out, ng, dq * N, total);
  return (int)cudaGetLastError();
}

template <typename T, int QT, int VT>
int bwd(const T* q, const T* k, const T* v, const T* dO, const float* lse,
        const float* delta, T* dq_out, T* dk_out, T* dv_out, float* dq_part,
        int B, int N, int dq, int dv, cudaStream_t st) {
  const int nyk = (dq + 8 * QT - 1) / (8 * QT), nyv = (dv + 8 * VT - 1) / (8 * VT);
  return bwd_launch(attn_bwd_kernel<T, QT, VT>, bwd_smem(dq, dv),
                    nyk > nyv ? nyk : nyv, q, k, v, dO, lse, delta, dq_out,
                    dk_out, dv_out, dq_part, B, N, dq, dv, st);
}

template <typename T>
int bwd_wide(const T* q, const T* k, const T* v, const T* dO,
             const float* lse, const float* delta, T* dq_out, T* dk_out,
             T* dv_out, float* dq_part, int B, int N, int dq, int dv,
             cudaStream_t st) {
  const int ny = ((dq > dv ? dq : dv) + DC - 1) / DC;
  return bwd_launch(attn_bwd_wide_kernel<T>, kWideBwdSmem, ny, q, k, v, dO,
                    lse, delta, dq_out, dk_out, dv_out, dq_part, B, N, dq, dv,
                    st);
}

// The forward's route by shape: the wide kernel where the resident one
// does not fit two blocks an SM, else the resident one for dv's chunk.
template <typename T>
int attn_fwd(const T* q, const T* k, const T* v, T* o, float* lse, int B,
             int N, int dq, int dv, cudaStream_t st) {
  const int vt = dv <= 8 ? 1 : (dv <= 16 ? 2 : (dv <= 32 ? 4 : 8));
  if (fwd_smem(dq, vt, false) > kMaxSmem / 2)
    return fwd<T, 8, true>(q, k, v, o, lse, B, N, dq, dv, st);
  if (vt == 1) return fwd<T, 1, false>(q, k, v, o, lse, B, N, dq, dv, st);
  if (vt == 2) return fwd<T, 2, false>(q, k, v, o, lse, B, N, dq, dv, st);
  if (vt == 4) return fwd<T, 4, false>(q, k, v, o, lse, B, N, dq, dv, st);
  return fwd<T, 8, false>(q, k, v, o, lse, B, N, dq, dv, st);
}

// The backward's route by shape, as the forward's.
template <typename T>
int attn_bwd(const T* q, const T* k, const T* v, const T* dO,
             const float* lse, const float* delta, T* dq_out, T* dk_out,
             T* dv_out, float* dq_part, int B, int N, int dq, int dv,
             cudaStream_t st) {
  auto run = [&](auto f) {
    return f(q, k, v, dO, lse, delta, dq_out, dk_out, dv_out, dq_part, B, N,
             dq, dv, st);
  };
  if (bwd_smem(dq, dv) > kMaxSmem / 2) return run(bwd_wide<T>);
  const int qt = dq <= 8 ? 1 : (dq <= 32 ? 4 : 8);
  if (dv <= 16) {
    if (qt == 1) return run(bwd<T, 1, 2>);
    return qt == 4 ? run(bwd<T, 4, 2>) : run(bwd<T, 8, 2>);
  }
  if (qt == 1) return run(bwd<T, 1, 8>);
  return qt == 4 ? run(bwd<T, 4, 8>) : run(bwd<T, 8, 8>);
}

}  // namespace

extern "C" {

// Forward. q, k (B,dq,N), v (B,dv,N). Writes o (B,dv,N) and lse (B,N).
int gcc_attn_fwd(const float* q, const float* k, const float* v, float* o,
                 float* lse, int B, int N, int dq, int dv, void* stream) {
  return attn_fwd(q, k, v, o, lse, B, N, dq, dv,
                  static_cast<cudaStream_t>(stream));
}

// The forward on bf16 q, k, v (o bf16, lse fp32) by the streaming kernel,
// attn_fwd_kernel<bf16, 8, true>: the shapes whose tiles
// flash_attention_bf16.cu's kernel cannot hold (gcc_attn_bf16_serves).
int gcc_attn_fwd_bf16_wide(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int N, int dq, int dv,
                           void* stream) {
  return fwd<bf16, 8, true>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B, N, dq, dv,
      static_cast<cudaStream_t>(stream));
}

// Key-tile groups of gcc_attn_bwd's dq partials for N keys (at most 16).
int gcc_attn_bwd_groups(int N) { return dq_groups(N, nullptr); }

// Backward, one pass: q, k (B,dq,N), v and dO (B,dv,N), lse and
// delta = sum_c dO * O (B,N). Writes dq_out, dk_out (B,dq,N) and dv_out
// (B,dv,N); dq_part is scratch of B * gcc_attn_bwd_groups(N) * dq * N
// floats.
int gcc_attn_bwd(const float* q, const float* k, const float* v,
                 const float* dO, const float* lse, const float* delta,
                 float* dq_out, float* dk_out, float* dv_out, float* dq_part,
                 int B, int N, int dq, int dv, void* stream) {
  return attn_bwd(q, k, v, dO, lse, delta, dq_out, dk_out, dv_out, dq_part,
                  B, N, dq, dv, static_cast<cudaStream_t>(stream));
}

// The backward on bf16 q, k, v and dO by the streaming kernel,
// attn_bwd_wide_kernel<bf16>, for the shapes flash_attention_bf16.cu's
// kernel cannot hold: lse, delta and the dq_part scratch fp32 (its size as
// gcc_attn_bwd's), dq_out, dk_out and dv_out bf16.
int gcc_attn_bwd_bf16_wide(const void* q, const void* k, const void* v,
                           const void* dO, const float* lse,
                           const float* delta, void* dq_out, void* dk_out,
                           void* dv_out, float* dq_part, int B, int N, int dq,
                           int dv, void* stream) {
  return bwd_wide(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
                  lse, delta, static_cast<bf16*>(dq_out),
                  static_cast<bf16*>(dk_out), static_cast<bf16*>(dv_out),
                  dq_part, B, N, dq, dv, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
