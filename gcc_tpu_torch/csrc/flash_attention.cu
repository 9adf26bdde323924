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
//   gcc_attn_fwd      <- _attn_fwd_kernel      (:44,  pallas_call :197)
//   gcc_attn_bwd_dq   <- _attn_bwd_dq_kernel   (:81,  pallas_call :277)
//   gcc_attn_bwd_dkv  <- _attn_bwd_dkv_kernel  (:110, pallas_call :295)
// Backward (FlashAttention-style): p_ij = exp(q_i . k_j - lse_i),
// delta_i = dO_i . O_i (a torch reduction in the wrapper, as the JAX package
// computes it outside its kernel), ds_ij = p_ij (dO_i . v_j - delta_i),
// dq = ds k, dk = ds^T q, dv = p^T dO.
//
// What bounds it on the card. Per (sample, query, key) pair the forward does
// 2(dq + dv) flops and one exp; the main path's shapes (N = 1024, dq 8 / dv 64
// teacher, dq 2 / dv 16 student) give 70-150 flops per byte of q/k/v/O, so
// the work is bound by fp32 operations (67 TFLOP/s outside the tensor cores),
// not by the 3.35 TB/s of HBM. No N x N matrix ever reaches device memory.
//
// What the design does about it, and where it leaves the TPU design:
//  * The TPU kernels carry accumulators across a sequential innermost grid
//    axis. CUDA blocks run in no order, so each block owns a 64-row tile of
//    its output and loops over the reduced axis itself: forward and dq walk
//    the key tiles, dk and dv walk the query tiles. No float atomics: two
//    calls on the same inputs give the same bits.
//  * Tiles are 64 x 64 (rows x streamed columns) in shared memory, 256
//    threads, each owning a 4-row x (4 | JW)-column register micro-tile of
//    the score tile and of its output tile. Features are reduced in chunks of
//    16 and output widths are covered in chunks of 16 * JW columns
//    (JW = 1, 2, 4 by width, extra chunks as a grid axis), so any N, dq and dv
//    run: a ragged key tile is masked by index, rows past N are not written.
//    The TPU's 128-lane padding of dq/dv and its -1e30 sentinel feature
//    column (attention.py:155-176) are not carried over, nor the
//    lane-replicated (B, N, 128) lse/delta tiles: they are plain (B, N).
//  * gcc_attn_bwd_dkv issues two launches: dv blocks (scores and p^T dO) and
//    dk blocks (scores, dO v^T and ds^T q), so neither keeps both outputs'
//    accumulators; the dk blocks share one template with the dq kernel.
//  * All products run on the fp32 CUDA cores; TF32 would break the parity
//    bounds. wgmma/TMA tiles and a single fused backward are later work.
//
// Every entry point returns cudaGetLastError() as an int; the Python wrapper
// raises when it is not 0. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>

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

// ds-side backward, one template for dq and dk. With QROWS the block's rows
// are queries and it walks the key tiles:
//   dq[:, chunk] = sum_j ds_ij k_j,   ds_ij = p_ij (dO_i . v_j - delta_i);
// without, its rows are keys and it walks the query tiles:
//   dk[:, chunk] = sum_i ds_ij q_i.
// Block (row tile, dq chunk, sample).
template <int JW, bool QROWS>
__global__ void __launch_bounds__(kThreads) attn_ds_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ out, int N, int dq, int dv) {
  constexpr int W = 16 * JW;
  __shared__ float As[DK * BR], Bs[DK * BC];
  __shared__ float Ps[BR * (BC + 1)], Cs[BC * (W + 1)];
  const int b = blockIdx.z, r0 = blockIdx.x * BR, c0 = blockIdx.y * W;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t oq = (size_t)b * dq * N, ov = (size_t)b * dv * N;
  // rows x columns: (q, k) and (dO, v) for dq; (k, q) and (v, dO) for dk
  const float* s_a = QROWS ? q + oq : k + oq;
  const float* s_b = QROWS ? k + oq : q + oq;
  const float* t_a = QROWS ? dO + ov : v + ov;
  const float* t_b = QROWS ? v + ov : dO + ov;
  const float* cm = QROWS ? k + oq : q + oq;  // the product's right operand
  const float* lb = lse + (size_t)b * N;
  const float* db = delta + (size_t)b * N;
  float lrow[4], drow[4], acc[4][JW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    lrow[i] = (QROWS && r < N) ? lb[r] : 0.f;
    drow[i] = (QROWS && r < N) ? db[r] : 0.f;
#pragma unroll
    for (int j = 0; j < JW; ++j) acc[i][j] = 0.f;
  }
  for (int n0 = 0; n0 < N; n0 += BC) {
    float s[4][4], t[4][4];
    scores(s, As, Bs, s_a, s_b, N, dq, r0, n0);
    scores(t, As, Bs, t_a, t_b, N, dv, r0, n0);
    __syncthreads();  // the previous tile's readers of Ps/Cs are done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const bool ok = n < N;
      const float lc = (!QROWS && ok) ? lb[n] : 0.f;
      const float dc = (!QROWS && ok) ? db[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lv = QROWS ? lrow[i] : lc, de = QROWS ? drow[i] : dc;
        Ps[(ty * 4 + i) * (BC + 1) + tx + 16 * j] =
            ok ? expf(s[i][j] - lv) * (t[i][j] - de) : 0.f;
      }
    }
    load_tm(Cs, W + 1, cm, N, dq, c0, W, n0, BC);
    __syncthreads();
    mma<JW, false>(acc, Ps, BC + 1, Cs, W + 1, BC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < dq) out[oq + (size_t)c * N + r] = acc[i][j];
    }
  }
}

// dv = p^T dO. Block (key tile, dv chunk, sample), walking the query tiles.
template <int JW>
__global__ void __launch_bounds__(kThreads) attn_dv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ dO, const float* __restrict__ lse,
    float* __restrict__ dv_out, int N, int dq, int dv) {
  constexpr int W = 16 * JW;
  __shared__ float As[DK * BR], Bs[DK * BC];
  __shared__ float Ps[BR * (BC + 1)], Gs[BC * (W + 1)];
  const int b = blockIdx.z, r0 = blockIdx.x * BR, c0 = blockIdx.y * W;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t oq = (size_t)b * dq * N, ov = (size_t)b * dv * N;
  const float* lb = lse + (size_t)b * N;
  float acc[4][JW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JW; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += BC) {
    float s[4][4];
    scores(s, As, Bs, k + oq, q + oq, N, dq, r0, n0);
    __syncthreads();  // the previous tile's readers of Ps/Gs are done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const float lc = n < N ? lb[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ps[(ty * 4 + i) * (BC + 1) + tx + 16 * j] =
            n < N ? expf(s[i][j] - lc) : 0.f;
    }
    load_tm(Gs, W + 1, dO + ov, N, dv, c0, W, n0, BC);
    __syncthreads();
    mma<JW, false>(acc, Ps, BC + 1, Gs, W + 1, BC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < dv) dv_out[ov + (size_t)c * N + r] = acc[i][j];
    }
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

template <int JW, bool QROWS>
int ds(const float* q, const float* k, const float* v, const float* dO,
       const float* lse, const float* delta, float* out, int B, int N, int dq,
       int dv, cudaStream_t st) {
  attn_ds_kernel<JW, QROWS><<<grid_of(N, dq, JW, B), kThreads, 0, st>>>(
      q, k, v, dO, lse, delta, out, N, dq, dv);
  return (int)cudaGetLastError();
}

template <bool QROWS>
int ds_any(const float* q, const float* k, const float* v, const float* dO,
           const float* lse, const float* delta, float* out, int B, int N,
           int dq, int dv, cudaStream_t st) {
  switch (chunk_jw(dq)) {
    case 1: return ds<1, QROWS>(q, k, v, dO, lse, delta, out, B, N, dq, dv, st);
    case 2: return ds<2, QROWS>(q, k, v, dO, lse, delta, out, B, N, dq, dv, st);
    default: return ds<4, QROWS>(q, k, v, dO, lse, delta, out, B, N, dq, dv, st);
  }
}

template <int JW>
int dv_grad(const float* q, const float* k, const float* dO, const float* lse,
            float* dv_out, int B, int N, int dq, int dv, cudaStream_t st) {
  attn_dv_kernel<JW><<<grid_of(N, dv, JW, B), kThreads, 0, st>>>(
      q, k, dO, lse, dv_out, N, dq, dv);
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

// Backward for q. dO (B,dv,N) is d(loss)/dO; lse and delta = sum_c dO * O
// are (B,N). Writes dq_out (B,dq,N).
int gcc_attn_bwd_dq(const float* q, const float* k, const float* v,
                    const float* dO, const float* lse, const float* delta,
                    float* dq_out, int B, int N, int dq, int dv, void* stream) {
  return ds_any<true>(q, k, v, dO, lse, delta, dq_out, B, N, dq, dv,
                      static_cast<cudaStream_t>(stream));
}

// Backward for k and v: two launches (dv blocks, then dk blocks). Writes
// dk_out (B,dq,N) and dv_out (B,dv,N).
int gcc_attn_bwd_dkv(const float* q, const float* k, const float* v,
                     const float* dO, const float* lse, const float* delta,
                     float* dk_out, float* dv_out, int B, int N, int dq,
                     int dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e;
  switch (chunk_jw(dv)) {
    case 1: e = dv_grad<1>(q, k, dO, lse, dv_out, B, N, dq, dv, st); break;
    case 2: e = dv_grad<2>(q, k, dO, lse, dv_out, B, N, dq, dv, st); break;
    default: e = dv_grad<4>(q, k, dO, lse, dv_out, B, N, dq, dv, st); break;
  }
  if (e) return e;
  return ds_any<false>(q, k, v, dO, lse, delta, dk_out, B, N, dq, dv, st);
}

}  // extern "C"
