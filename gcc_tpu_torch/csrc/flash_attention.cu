// Flash self-attention for SAGAN on Hopper (sm_90a), fp32, one head.
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
//   gcc_attn_fwd  <- _attn_fwd_kernel       (:44,  pallas_call :197)
//   gcc_attn_bwd  <- _attn_bwd_dq_kernel    (:81,  pallas_call :277)
//                  + _attn_bwd_dkv_kernel   (:110, pallas_call :295)
// Backward (FlashAttention-style): p_ij = exp(q_i . k_j - lse_i),
// delta_i = dO_i . O_i (a torch reduction in the wrapper, as the JAX package
// computes it outside its kernel), ds_ij = p_ij (dO_i . v_j - delta_i),
// dq = ds k, dk = ds^T q, dv = p^T dO.
//
// Forward. Per (sample, query, key) pair it does 2(dq + dv) flops and one
// exp; the main path's shapes (N = 1024, dq 8 / dv 64 teacher, dq 2 / dv 16
// student) give 70-150 flops per byte of q/k/v/O, so the work is bound by
// fp32 operations (67 TFLOP/s outside the tensor cores), not by the
// 3.35 TB/s of HBM. No N x N matrix ever reaches device memory.
//  * The TPU kernel carries m, l and the accumulator across a sequential
//    innermost grid axis. CUDA blocks run in no order, so each block owns a
//    64-query tile of O and walks the key tiles itself.
//  * Tiles are 64 x 64 (rows x streamed columns) in shared memory, 256
//    threads, each owning a 4-row x (4 | JW)-column register micro-tile of
//    the score tile and of its output tile, on the fp32 CUDA cores. Features
//    are reduced in chunks of 16 and output widths are covered in chunks of
//    16 * JW columns (JW = 1, 2, 4 by width, extra chunks as a grid axis), so
//    any N, dq and dv run: a ragged key tile is masked by index, rows past N
//    are not written. The TPU's 128-lane padding of dq/dv and its -1e30
//    sentinel feature column (attention.py:155-176) are not carried over, nor
//    the lane-replicated (B, N, 128) lse/delta tiles: they are plain (B, N).
//
// Backward, one pass. Per pair it needs S = q.k, p = exp(S - lse), dP =
// dO.v, ds, and three products into dq, dk, dv: 2(3 dq + 2 dv) flops, one
// exp. Split as the TPU's two kernels are, S and dP are computed twice.
//  * Block (key tile j of 64 keys, output chunk, sample): k_j and v_j are
//    loaded once; the block walks the query tiles i, fetching tile i + 1
//    (q, dO, lse, delta) with cp.async into the second of two shared-memory
//    stages while tile i computes, and keeps dK_j and dV_j in registers.
//    Each product is computed once per pair. dq, a sum over key tiles, is
//    written as per-key-tile partials (B, ceil(N/64), dq, N) and summed in
//    key-tile order by attn_dq_reduce_kernel: no float atomics, so two calls
//    on the same inputs give the same bits.
//  * Every product runs on the tensor cores: mma.sync.aligned.m16n8k8 .tf32,
//    8 warps. Warp w owns keys 16 (w % 4).. and queries 32 (w / 4).. of a
//    tile: 4 m16n8 accumulator fragments each for S^T and dP^T. P^T and dS^T
//    stay in those fragments and are the A operands of dV += P^T dO^T and
//    dK += dS^T q^T (the k index permuted to where the accumulator holds
//    each query); the two warps of a key group sum their dK, dV halves at
//    the end. dS goes through shared memory once for dQ = dS k^T (warps
//    0-3, 16 queries each). [channel][token] tiles have a row stride of 72
//    floats, so every fragment load of a warp hits 32 distinct banks. Eight
//    warps of at most 128 registers (__launch_bounds__(256, 2)) put two
//    blocks, 16 warps, on an SM to hide the latency of the mma chains.
//  * Split-TF32 ("3xTF32"): x = hi + lo, hi = x with the low 13 bits masked,
//    lo = (x - hi) masked the same way; a b = lo*hi + hi*lo + hi*hi in fp32
//    accumulators. Plain TF32 keeps 10 mantissa bits and misses the port's
//    gradient bound of 1e-4 max(|ref|, 1). test_split_tf32_precision
//    (tests/test_torch_attention.py) emulates these products at B 1, N 256,
//    dq 8, dv 64 against float64: dq/dk/dv err 4.7e-3 / 4.6e-3 / 1.1e-3 with
//    TF32 operands (tolerances 1.5e-4 / 1.4e-4 / 1.0e-4), 1.8e-6 / 2.0e-6 /
//    5.2e-7 split, 4.8e-7 / 3.1e-7 / 8.0e-8 fp32. Its rate, a third of the
//    495 TFLOP/s TF32 peak, is 165 TFLOP/s against 67 on the fp32 CUDA
//    cores.
//  * exp is __expf (ex2.approx), less exact than expf in its last bits; the
//    gradients stay far inside their bound (chip_smoke.py phase 6).
//  * Widths: dq and dv are padded with zero rows to multiples of 8 in shared
//    memory (dq 2 runs as 8). dK chunks of 8 QT channels (QT = 1, 4, 8 by
//    dq) and dV chunks of 8 VT (VT = 2, 8 by dv) live in registers; wider
//    outputs take more chunks as a grid axis, whose blocks past the first
//    recompute P (and dS where they hold a dK chunk). Widths whose two
//    stages do not fit in shared memory run with one stage; wider still
//    (dq + dv past about 370) the entry point returns cudaErrorInvalidValue.
//  * Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the
//    instantiations use the 128 registers that two blocks of 256 threads
//    allow (125 for <QT 4, VT 2>). <1, 8> (the teacher's dq 8 / dv 64)
//    spills 76 B of stores to a 40-byte stack frame, <1, 2> (the student's
//    dq 2 / dv 16) 172 B to 176, <8, 8> 392 B to 152; the others do not
//    spill. Dynamic shared memory (bwd_smem): 81,664 B at dq 8 / dv 64 and
//    40,192 B at dq 2 / dv 16, two stages each. The dq reduction uses 32
//    registers.
//
// Every entry point returns cudaGetLastError() as an int; the Python wrapper
// raises when it is not 0. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) = (t / 16, t % 16)
constexpr int BR = 64;         // rows of the block's own output tile
constexpr int BC = 64;         // columns of the streamed tile
constexpr int DK = 16;         // features per reduction chunk

// Max / sum over the 16 threads of one row group (a half-warp). The xor
// butterfly gives every lane the same bits.
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[c * ldd + t] = src[(d0 + c) * N + n0 + t] for c < nd, t < nt: a
// feature-major tile of a (D, N) matrix, zero past D or N.
__device__ __forceinline__ void load_fm(float* dst, int ldd, const float* src,
                                        int N, int D, int d0, int nd, int n0,
                                        int nt) {
  for (int e = threadIdx.x; e < nd * nt; e += kThreads) {
    const int c = e / nt, t = e - c * nt, d = d0 + c, n = n0 + t;
    dst[c * ldd + t] = (d < D && n < N) ? src[(size_t)d * N + n] : 0.f;
  }
}

// dst[t * ldd + c]: the same tile stored token-major (ldd odd, so the
// transposing stores do not collide in shared-memory banks).
__device__ __forceinline__ void load_tm(float* dst, int ldd, const float* src,
                                        int N, int D, int d0, int nd, int n0,
                                        int nt) {
  for (int e = threadIdx.x; e < nd * nt; e += kThreads) {
    const int c = e / nt, t = e - c * nt, d = d0 + c, n = n0 + t;
    dst[t * ldd + c] = (d < D && n < N) ? src[(size_t)d * N + n] : 0.f;
  }
}

// acc[i][j] += sum_{kk < K} A(ty*4 + i, kk) * B[kk * ldb + tx + 16 j], with
// A stored k-major (A[kk * lda + r]) when AK, else row-major (A[r * lda + kk]).
template <int JW, bool AK>
__device__ __forceinline__ void mma(float (&acc)[4][JW], const float* A,
                                    int lda, const float* B, int ldb, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int kk = 0; kk < K; ++kk) {
    float a[4], b[JW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = AK ? A[kk * lda + ty * 4 + i] : A[(ty * 4 + i) * lda + kk];
#pragma unroll
    for (int j = 0; j < JW; ++j) b[j] = B[kk * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JW; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Scores of one (64 x 64) tile: s[i][j] = sum_c a[c, r0 + ty*4 + i] *
// b[c, n0 + tx + 16 j] over the D features of two channel-major matrices.
__device__ __forceinline__ void scores(float (&s)[4][4], float* As, float* Bs,
                                       const float* a, const float* b, int N,
                                       int D, int r0, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DK) {
    const int nd = min(DK, D - d0);
    __syncthreads();  // the previous readers of As/Bs are done
    load_fm(As, BR, a, N, D, d0, nd, r0, BR);
    load_fm(Bs, BC, b, N, D, d0, nd, n0, BC);
    __syncthreads();
    mma<4, true>(s, As, BR, Bs, BC, nd);
  }
}

// Forward. Block (query tile, dv chunk, sample): online softmax over the key
// tiles; O for its dv chunk, and lse from the chunk-0 blocks.
template <int JW>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int N, int dq, int dv) {
  constexpr int W = 16 * JW;
  __shared__ float As[DK * BR], Bs[DK * BC];
  __shared__ float Ps[BR * (BC + 1)], Vs[BC * (W + 1)];
  const int b = blockIdx.z, r0 = blockIdx.x * BR, c0 = blockIdx.y * W;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = q + (size_t)b * dq * N;
  const float* kb = k + (size_t)b * dq * N;
  const float* vb = v + (size_t)b * dv * N;
  float m[4], l[4], acc[4][JW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JW; ++j) acc[i][j] = 0.f;
  }
  for (int n0 = 0; n0 < N; n0 += BC) {
    float s[4][4];
    scores(s, As, Bs, qb, kb, N, dq, r0, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + tx + 16 * j >= N) s[i][j] = -INFINITY;  // ragged key tile
        mx = fmaxf(mx, s[i][j]);
      }
      // key n0 < N is in every tile, so the row max is finite
      const float mn = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < JW; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the previous tile's readers of Ps/Vs are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * (BC + 1) + tx + 16 * j] = s[i][j];
    load_tm(Vs, W + 1, vb, N, dv, c0, W, n0, BC);
    __syncthreads();
    mma<JW, false>(acc, Ps, BC + 1, Vs, W + 1, BC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= N) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < dv) o[((size_t)b * dv + c) * N + r] = acc[i][j] * inv;
    }
    if (blockIdx.y == 0 && tx == 0) lse[(size_t)b * N + r] = m[i] + logf(l[i]);
  }
}

// Columns of a block's output chunk for an output of width w: 16, 32 or 64.
int chunk_jw(int w) { return w <= 16 ? 1 : (w <= 32 ? 2 : 4); }

dim3 grid_of(int N, int w, int jw, int B) {
  return dim3((N + BR - 1) / BR, (w + 16 * jw - 1) / (16 * jw), B);
}

template <int JW>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int N, int dq, int dv, cudaStream_t st) {
  attn_fwd_kernel<JW><<<grid_of(N, dv, JW, B), kThreads, 0, st>>>(
      q, k, v, o, lse, N, dq, dv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: one pass over the (query, key) pairs on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;  // 8 warps, see attn_bwd_kernel
constexpr int BT = 64;            // keys of a block; queries of a streamed tile
constexpr int BH = BT / 2;        // queries of a warp in a tile
constexpr int LDT = BT + 8;       // row stride of a [channel][token] tile
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

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

// A fragment of m16n8k8 (16 x 8, row-major): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4) for lane = 4 g + t.
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// B fragment (8 x 8, column-major): b0 (t, g), b1 (t + 4, g).
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
// dropped), small terms first. The accumulator d (16 x 8): d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

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

// dst[c * LDT + t] = src[c * N + n0 + t] for c < D, t < BT, zero past N:
// 16-byte copies when vec (N % 4 == 0, aligned bases), else 4-byte ones.
__device__ __forceinline__ void cp_tile(float* dst, const float* src, int D,
                                        int N, int n0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < D * (BT / 4); e += kBwdThreads) {
      const int c = e / (BT / 4), t = 4 * (e % (BT / 4)), n = n0 + t;
      cp_async(dst + c * LDT + t, src + (size_t)c * N + (n < N ? n : 0),
               n < N ? 16 : 0, true);
    }
  } else {
    for (int e = threadIdx.x; e < D * BT; e += kBwdThreads) {
      const int c = e / BT, t = e % BT, n = n0 + t;
      cp_async(dst + c * LDT + t, src + (size_t)c * N + (n < N ? n : 0),
               n < N ? 4 : 0, false);
    }
  }
}

__device__ __forceinline__ void zero_rows(float* dst, int from, int to) {
  for (int e = threadIdx.x; e < (to - from) * LDT; e += kBwdThreads)
    dst[from * LDT + e] = 0.f;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Block (key tile j, output chunk y, sample b). Warp w owns keys
// kw = 16 (w % 4) .. kw + 15 of the tile and queries qh = 32 (w / 4) ..
// qh + 31 of each query tile i it walks:
//   S^T = k_j^T q_i,  P^T = exp(S^T - lse_i),  dP^T = v_j^T dO_i,
//   dS^T = P^T (dP^T - delta_i),  dV_j += P^T dO_i^T,  dK_j += dS^T q_i^T,
//   dQ_i^(j) = dS k_j^T  (a partial, to dq_part; attn_dq_reduce_kernel sums
//   it).
// P^T and dS^T stay in the accumulator fragments they were computed in and
// are the A operands of the dV and dK products: the product's k index
// (queries) is permuted so that k column t is query 2t and t + 4 is 2t + 1,
// which is where the accumulator holds them. Chunk y accumulates dK channels
// [8 QT y, 8 QT (y + 1)) and dV channels [8 VT y, 8 VT (y + 1)); only
// blocks with a dK chunk compute dP and dS, and only y = 0 writes dQ. The
// two warps of a key group hold partial dK and dV over their query halves;
// they are summed (w + (w + 4), in that order) at the end.
template <int QT, int VT>
__global__ void __launch_bounds__(kBwdThreads, 2) attn_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_out, float* __restrict__ dv_out,
    float* __restrict__ dq_part, int N, int dq, int dv, int nbuf, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int dqp = (dq + 7) & ~7, dvp = (dv + 7) & ~7;  // zero rows to 8
  const int stage = (dqp + dvp) * LDT + 2 * BT;  // q, dO, lse, delta tiles
  float* Ks = sm;                  // [dqp][LDT] the block's keys, resident
  float* Vs = Ks + dqp * LDT;      // [dvp][LDT]
  float* Ss = Vs + dvp * LDT;      // [BT][LDT] dS[query][key]
  float* st0 = Ss + BT * LDT;      // nbuf stages

  const int b = blockIdx.z, y = blockIdx.y, nkt = gridDim.x;
  const int j0 = blockIdx.x * BT, ck0 = 8 * QT * y, cv0 = 8 * VT * y;
  const bool with_ds = ck0 < dq, with_dv = cv0 < dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, kw = 16 * (warp & 3), qh = BH * (warp >> 2);
  const size_t oq = (size_t)b * dq * N, ov = (size_t)b * dv * N;
  const float* lb = lse + (size_t)b * N;
  const float* db = delta + (size_t)b * N;
  const bool key_lo = j0 + kw + g < N, key_hi = j0 + kw + g + 8 < N;

  zero_rows(Ks, dq, dqp);
  zero_rows(Vs, dv, dvp);
  for (int s = 0; s < nbuf; ++s) {
    zero_rows(st0 + s * stage, dq, dqp);
    zero_rows(st0 + s * stage + dqp * LDT, dv, dvp);
  }
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
  cp_tile(Ks, k + oq, dq, N, j0, vec);
  cp_tile(Vs, v + ov, dv, N, j0, vec);
  fetch(0, 0);
  asm volatile("cp.async.commit_group;\n");

  float dK[QT][4] = {}, dV[VT][4] = {};
  const int nqt = (N + BT - 1) / BT;
  for (int i = 0; i < nqt; ++i) {
    const int s = nbuf == 2 ? (i & 1) : 0, n0 = i * BT;
    if (nbuf == 2 && i + 1 < nqt) {  // fetch tile i + 1 while i computes
      fetch(i + 1, s ^ 1);
      asm volatile("cp.async.commit_group;\n");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* Qs = st0 + s * stage;
    const float* Os = Qs + dqp * LDT;
    const float* Ls = Os + dvp * LDT;
    const float* Ds = Ls + BT;

    // P^T (16 keys x 32 queries a warp): fragment nt holds queries qh + 8 nt..
    float P[4][4] = {};
    for (int c0 = 0; c0 < dqp; c0 += 8) {
      const float* kr = Ks + (c0 + t) * LDT + kw + g;
      const FragA a = frag_a(kr[0], kr[8], kr[4 * LDT], kr[4 * LDT + 8]);
      const float* qr = Qs + (c0 + t) * LDT + qh + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma3(P[nt], a, frag_b(qr[8 * nt], qr[4 * LDT + 8 * nt]));
    }
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

    if (with_dv) {  // dV += P^T dO^T, k = the tile's queries
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const FragA a = frag_a(P[kk][0], P[kk][2], P[kk][1], P[kk][3]);
#pragma unroll
        for (int nt = 0; nt < VT; ++nt) {
          if (cv0 + 8 * nt >= dvp) break;
          const float2 o =
              ld2(Os + (cv0 + 8 * nt + g) * LDT + qh + 8 * kk + 2 * t);
          mma3(dV[nt], a, frag_b(o.x, o.y));
        }
      }
    }

    if (with_ds) {
      float G[4][4] = {};  // dP^T, then dS^T
      for (int c0 = 0; c0 < dvp; c0 += 8) {
        const float* vr = Vs + (c0 + t) * LDT + kw + g;
        const FragA a = frag_a(vr[0], vr[8], vr[4 * LDT], vr[4 * LDT + 8]);
        const float* orow = Os + (c0 + t) * LDT + qh + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma3(G[nt], a, frag_b(orow[8 * nt], orow[4 * LDT + 8 * nt]));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int qi = qh + 8 * nt + 2 * t;
        const float2 d = ld2(Ds + qi);
        G[nt][0] = P[nt][0] * (G[nt][0] - d.x);
        G[nt][1] = P[nt][1] * (G[nt][1] - d.y);
        G[nt][2] = P[nt][2] * (G[nt][2] - d.x);
        G[nt][3] = P[nt][3] * (G[nt][3] - d.y);
        float* sr = Ss + qi * LDT + kw + g;  // dS[query][key]
        sr[0] = G[nt][0];
        sr[LDT] = G[nt][1];
        sr[8] = G[nt][2];
        sr[LDT + 8] = G[nt][3];
      }
      // dK += dS^T q^T, k = the tile's queries
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const FragA a = frag_a(G[kk][0], G[kk][2], G[kk][1], G[kk][3]);
#pragma unroll
        for (int nt = 0; nt < QT; ++nt) {
          if (ck0 + 8 * nt >= dqp) break;
          const float2 x =
              ld2(Qs + (ck0 + 8 * nt + g) * LDT + qh + 8 * kk + 2 * t);
          mma3(dK[nt], a, frag_b(x.x, x.y));
        }
      }
      __syncthreads();  // dS of all eight warps is in Ss

      // dQ_i^(j) = dS k^T: warp w < 4 takes queries 16w.., k = the block's
      // keys (permuted as above: k column t is key 2t, t + 4 is 2t + 1)
      if (y == 0 && warp < 4) {
        const int qw = 16 * warp;
        for (int cq0 = 0; cq0 < dqp; cq0 += 8 * QT) {
          float acc[QT][4] = {};
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const float2 r0 = ld2(Ss + (qw + g) * LDT + 8 * kk + 2 * t);
            const float2 r1 = ld2(Ss + (qw + g + 8) * LDT + 8 * kk + 2 * t);
            const FragA a = frag_a(r0.x, r1.x, r0.y, r1.y);
#pragma unroll
            for (int nt = 0; nt < QT; ++nt) {
              if (cq0 + 8 * nt >= dqp) break;
              const float2 x = ld2(Ks + (cq0 + 8 * nt + g) * LDT + 8 * kk + 2 * t);
              mma3(acc[nt], a, frag_b(x.x, x.y));
            }
          }
          float* out = dq_part + ((size_t)b * nkt + blockIdx.x) * dq * N;
#pragma unroll
          for (int nt = 0; nt < QT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = cq0 + 8 * nt + 2 * t + (r & 1);
              const int n = n0 + qw + g + 8 * (r >> 1);
              if (c < dq && n < N) out[(size_t)c * N + n] = acc[nt][r];
            }
        }
      }
    }
    __syncthreads();  // readers of stage s and of Ss are done
    if (nbuf == 1 && i + 1 < nqt) {
      fetch(i + 1, 0);
      asm volatile("cp.async.commit_group;\n");
    }
  }

  // dK and dV of warp w + 4 to shared memory (free now), then added to
  // warp w's
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
  // rows are keys: (kw + g, kw + g + 8), columns channels (2t, 2t + 1)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) dK[nt][r] += red[(nt * 4 + r) * 32];
#pragma unroll
    for (int nt = 0; nt < VT; ++nt) dV[nt][r] += red[((QT + nt) * 4 + r) * 32];
    const int key = j0 + kw + g + 8 * (r >> 1);
    if (key >= N) continue;
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) {
      const int c = ck0 + 8 * nt + 2 * t + (r & 1);
      if (with_ds && c < dq) dk_out[oq + (size_t)c * N + key] = dK[nt][r];
    }
#pragma unroll
    for (int nt = 0; nt < VT; ++nt) {
      const int c = cv0 + 8 * nt + 2 * t + (r & 1);
      if (with_dv && c < dv) dv_out[ov + (size_t)c * N + key] = dV[nt][r];
    }
  }
}

// dq[b, c, n] = sum_j dq_part[b, j, c, n], j in order: no float atomics.
__global__ void __launch_bounds__(256) attn_dq_reduce_kernel(
    const float* __restrict__ dq_part, float* __restrict__ dq_out, int nkt,
    int dqn, int total) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  const int b = e / dqn;
  const float* p = dq_part + (size_t)b * nkt * dqn + (e - b * dqn);
  float s = 0.f;
  for (int j = 0; j < nkt; ++j) s += p[(size_t)j * dqn];
  dq_out[e] = s;
}

// Shared memory of attn_bwd_kernel with nbuf stages, in bytes.
size_t bwd_smem(int dq, int dv, int nbuf) {
  const size_t rows = ((dq + 7) & ~7) + ((dv + 7) & ~7);
  return 4 * (rows * LDT * (1 + nbuf) + 2 * BT * nbuf + BT * LDT);
}

template <int QT, int VT>
int bwd(const float* q, const float* k, const float* v, const float* dO,
        const float* lse, const float* delta, float* dq_out, float* dk_out,
        float* dv_out, float* dq_part, int B, int N, int dq, int dv,
        cudaStream_t st) {
  const int nbuf = bwd_smem(dq, dv, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = bwd_smem(dq, dv, nbuf);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_kernel<QT, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)dO;
  const int vec = N % 4 == 0 && bases % 16 == 0;
  const int nkt = (N + BT - 1) / BT;
  const int nyk = (dq + 8 * QT - 1) / (8 * QT), nyv = (dv + 8 * VT - 1) / (8 * VT);
  attn_bwd_kernel<QT, VT><<<dim3(nkt, nyk > nyv ? nyk : nyv, B), kBwdThreads,
                            smem, st>>>(
      q, k, v, dO, lse, delta, dk_out, dv_out, dq_part, N, dq, dv, nbuf, vec);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  const int total = B * dq * N;
  attn_dq_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      dq_part, dq_out, nkt, dq * N, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward. q, k (B,dq,N), v (B,dv,N). Writes o (B,dv,N) and lse (B,N).
int gcc_attn_fwd(const float* q, const float* k, const float* v, float* o,
                 float* lse, int B, int N, int dq, int dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk_jw(dv)) {
    case 1: return fwd<1>(q, k, v, o, lse, B, N, dq, dv, st);
    case 2: return fwd<2>(q, k, v, o, lse, B, N, dq, dv, st);
    default: return fwd<4>(q, k, v, o, lse, B, N, dq, dv, st);
  }
}

// Backward, one pass: q, k (B,dq,N), v and dO (B,dv,N), lse and
// delta = sum_c dO * O (B,N). Writes dq_out, dk_out (B,dq,N) and dv_out
// (B,dv,N); dq_part is scratch of B * ceil(N / 64) * dq * N floats.
int gcc_attn_bwd(const float* q, const float* k, const float* v,
                 const float* dO, const float* lse, const float* delta,
                 float* dq_out, float* dk_out, float* dv_out, float* dq_part,
                 int B, int N, int dq, int dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qt = dq <= 8 ? 1 : (dq <= 32 ? 4 : 8);
  auto run = [&](auto f) {
    return f(q, k, v, dO, lse, delta, dq_out, dk_out, dv_out, dq_part, B, N,
             dq, dv, st);
  };
  if (dv <= 16) {
    if (qt == 1) return run(bwd<1, 2>);
    return qt == 4 ? run(bwd<4, 2>) : run(bwd<8, 2>);
  }
  if (qt == 1) return run(bwd<1, 8>);
  return qt == 4 ? run(bwd<4, 8>) : run(bwd<8, 8>);
}

}  // extern "C"
