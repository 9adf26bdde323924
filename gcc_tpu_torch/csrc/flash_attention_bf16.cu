// Flash self-attention on bf16 q, k, v and dO for Hopper (sm_90a), one
// head: kernel B1 in the JAX package's default --compute_dtype bfloat16.
//
//   O = softmax(q k^T) v  with UNSCALED logits (SAGAN.py:97-103)
//   lse_i = log sum_j exp(q_i . k_j)
//
// Replaces, for bf16 inputs, the three Pallas kernels of
// gcc_tpu/ops/pallas/attention.py:
//   gcc_attn_fwd_bf16  <- _attn_fwd_kernel       (:44,  pallas_call :197)
//   gcc_attn_bwd_bf16  <- _attn_bwd_dq_kernel    (:81,  pallas_call :277)
//                       + _attn_bwd_dkv_kernel   (:110, pallas_call :295)
// Layout as flash_attention.cu: channel-major q, k (B, dq, N), v, O, dO
// (B, dv, N) in bf16; lse and delta (B, N) fp32.
//
// Arithmetic, as the TPU kernels' (attention.py:54-70, :89-103, :119-135):
// products of bf16 values are exact in fp32 and summed in fp32. S = q^T k
// and dP = dO v^T have two bf16 operands: one bf16 mma.sync each (m16n8k16,
// m16n8k8 for a last 8 channels). P and dS are fp32 and meet a bf16
// operand in P V^T, dV = P^T dO, dK = dS^T q and dQ = dS k: each is split
// as hi = bf16(x), lo = bf16(x - hi), 16 significant bits, two bf16 mma a
// product (lo first), at the cost of one TF32 mma.
// tests/test_torch_attention_bf16_split.py emulates these steps: two terms
// hold the port's bf16 rule against the plain versions
// (flash_attention.BF16_ULPS, BF16_SHARE), one term does not. O, dq, dk
// and dv round to bf16 once, on their store.
//
// Shared memory holds bf16 tiles, [channel][token] with a row stride of
// LDT = 72 (144 bytes: the eight rows of an ldmatrix land on distinct
// banks). They arrive by 16-byte cp.async (bf16mma::cp_async16) into a ring
// of three stages, so tile j + 1 and j + 2 are in flight while tile j
// computes; one __syncthreads a tile. Where N % 8 != 0 or a base is not 16-
// byte aligned the copies are synchronous, 2 bytes each. The mma fragments
// come from ldmatrix: .trans reads the A and B operands whose k index is
// the channel (q, k, v, dO against channels) straight from the channel-
// major tiles, the plain form those whose k index is the token.
//
// Forward (FlashAttention-2). Block (128 queries, a chunk of 8 VT channels
// of v, sample); warp w owns queries 16 w.. and walks the 64-key tiles:
//  * S (16 x 64 a warp) = q^T k on the bf16 tensor cores (mma.sync), q's
//    fragments from the resident [dq][136] q tile. dq is zero-padded to a
//    multiple of 8 (dq 2 runs as 8; dq <= 8 is a compile-time 8).
//  * Online softmax on the accumulators: row max and sum over the quad,
//    p = 2^(s log2 e - m log2 e) by ex2.approx.
//  * O = alpha O + P V^T: P goes from the S accumulators into the A
//    operand with no shared-memory round trip (two n8 accumulator tiles
//    are one m16n8k16 A fragment). At dv chunks of 64 (VT 8, the teacher)
//    each warpgroup (warps 0-3, 4-7: 64 queries) issues the tile's product
//    as 8 wgmma m64n64k16 with A from registers and V by descriptor from a
//    core-matrix copy of the v tile (8 channels x 8 keys, 128 contiguous
//    bytes, one 16-byte cp.async of each of 8 rows: conflict-free); narrower
//    chunks take mma.sync with V's B fragments by ldmatrix, two channel
//    tiles at a time. The tile's product goes into a zeroed partial added
//    to O in fp32 with the rescale: the tensor cores truncate what they
//    accumulate, and summed into O the truncations of 16 tiles lean one way.
//  * Bound: per (query, key) 2 (dq + dv) flops and one exp; at the
//    teacher's B 64, N 1024, dq 8, dv 64, 9.7 GFLOP take 9.8 us at 989
//    TFLOP/s, the 67 M exps ~16 us at 16 a clock an SM: the exps bound it.
//    The kernel issues 2 (dq' + 2 dv) flops a pair (dq' = dq padded; P's
//    hi/lo), ~2x the function's at the teacher's widths. What holds it
//    back on the H100 is latency, not a unit's rate: with P V^T taken out
//    (a timing probe), S, the softmax's chains of max, exp and sum and the
//    loads alone took 60 % of the kernel's time (PERF.md).
//
// Backward, one pass, as flash_attention.cu's. Block (key-tile group,
// output chunk, sample); per 64-key tile of its group k and v are resident
// and the block walks the 64-query tiles, q, dO, lse and delta streamed
// through the ring. Warp w owns keys 16 (w % 4).. and queries
// 32 (w / 4).. of a tile:
//  * S^T = k^T q and dP^T = v^T dO on the bf16 tensor cores, each 16
//    channels into a zeroed partial added in fp32 (as flash_attention.cu's
//    bf16 kernels: at wide_logit and long_n a running sum's truncations
//    lean one way).
//  * P^T = exp(S^T - lse) (__expf), dS^T = P^T (dP^T - delta).
//  * dV += P^T dO^T and dK += dS^T q^T with P^T and dS^T, split hi/lo,
//    straight from the accumulators; each query tile's product into a
//    zeroed partial added to the register sums in fp32. At dq <= 8 and dv
//    chunks of 64 (the teacher) dV is 4 wgmma m64n64k16 a warpgroup (its
//    64 keys x 64 channels over its 32 queries), dO staged in the
//    core-matrix layout (dP reads it there too); else mma.sync.
//  * dS^T goes to shared memory as its bf16 hi and lo (two buffers, so one
//    __syncthreads a tile orders its writes and reads); warps 0-3 form
//    dQ = dS k (hi, lo against k) for 16 queries each and add it to their
//    key-tile group's fp32 partial (B, G, dq, N); attn_dq_reduce_bf16_kernel
//    sums the G partials in group order, dq's old partial loaded before
//    the products so its latency hides behind them. No float atomics: the
//    same inputs give the same bits.
//  * G, the number of key-tile groups, is sized so that the grid holds
//    about two blocks an SM (at most 64 groups, at least 1 key tile each):
//    G = 4 at the teacher's and student's B 64, N 1024, where the partials
//    take 8.4 MB a pass instead of 16 groups' 33.5 MB; 64 at B 1, N 16384
//    (64 blocks, not 16). The scratch stays under (2 SMs + B ny) dq N
//    floats whatever B is (gcc_attn_bwd_bf16_groups).
//  * Widths: dK in chunks of 8 QT channels (QT 1 or 8 by dq), dV of 8 VT
//    (VT 2 or 8 by dv); more chunks are a grid axis whose blocks recompute
//    P (and dS for a dK chunk).
//  * Bound: per pair 2 (3 dq + 2 dv) flops and one exp: 20.4 GFLOP, 21 us
//    at the teacher's shape, set by the operations. The kernel issues
//    2 (5 dq' + 3 dv') a pair (P and dS hi/lo); timing probes with parts
//    taken out (before dV moved to wgmma) put two thirds of its time
//    outside the dV, dK and dQ products: S, dP, the exps and the two
//    __syncthreads a query tile, latency with 16 warps an SM.
//
// Routes. A shape whose tiles fit one block's 227 KB (fwd_smem, bwd_smem:
// the forward up to dq 288, the backward up to dq + dv 336 after padding)
// runs here; __launch_bounds__(256, 2) keeps two blocks an SM where their
// shared memory fits. Wider (chip_smoke.py's wide_q dq 320 / dv 320 and,
// in the backward, SAGAN D's attn2 at dq 64 / dv 512) runs flash_attention.
// cu's streaming kernels on bf16 (gcc_attn_{fwd,bwd}_bf16_wide), which
// widen each tile to fp32 as they load it. gcc_attn_bf16_serves says which;
// the Python wrapper asks it. No width is refused.
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8; chip_smoke.py
// phase 18 (a) prints them), 256 threads and __launch_bounds__(256, 2):
//   attn_fwd_bf16_kernel<VT, Q8, VEC>: <8, *, *> 125-128 registers, the
//   main path's <8, true, true> spills 28 B of stores, <8, true, false> 4 B;
//   <4> 110-114, <2> 100-106, <1> 91-95, no spills.
//   attn_bwd_bf16_kernel<QT, VT, VEC>: the teacher's <1, 8, *> 128
//   without spills, the student's <1, 2, true> 128 with 32 B of spill
//   stores, <1, 2, false> 117; <8, 2> 128 with 176-184 B, <8, 8> 128 with
//   440-460 B (dq > 8, off the main path).
//   attn_dq_reduce_bf16_kernel: 32 registers.
// Dynamic shared memory (fwd_smem, bwd_smem; gcc_attn_bf16_smem): 33,280 B
// forward and 79,872 B backward at the teacher's dq 8 / dv 64, 12,544 B and
// 52,224 B at the student's dq 2 / dv 16: two blocks an SM.
//
// Every entry point returns cudaGetLastError() as an int (the wrapper
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16mma::cp_async16;
using bf16mma::mma;  // m16n8k16
using tf32x3::cp_commit;
using tf32x3::cp_wait;

constexpr int kThreads = 256;     // 8 warps, every kernel but the reduction
constexpr int BT = 64;            // keys (forward) or queries (backward) of
                                  // a streamed tile, keys of a backward block
constexpr int BQ = 128;           // queries of a forward block
constexpr int LDT = BT + 8;       // row stride of a [channel][token] tile
constexpr int LDQ = BQ + 8;       // row stride of the forward's q tile
constexpr int kStages = 3;        // the ring of streamed tiles
constexpr int kDqGroups = 64;     // most key-tile groups of the dq partials
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad8(int d) { return (d + 7) & ~7; }

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

// d += a b, one 16 x 8 x 8 product of bf16 operands: a0 (g, 2t..2t+1),
// a1 (g + 8, 2t..2t+1), b (2t..2t+1, g)
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[2],
                                     uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma(d, a, b);
}

// wgmma (sm_90a): a warpgroup's (4 warps') 64 x 64 x 16 product, A from
// registers (each warp's m16n8k16 A fragment of its 16 rows), B from shared
// memory by a matrix descriptor: no swizzle, core matrices of 8 rows x 16
// bytes, 128 contiguous bytes each, lbo bytes apart along K and sbo along N.
// D: a warp's 16 rows, d[4 i + r] as the m16n8 accumulator tile i.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d = a b + (acc ? d : 0)
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// The wgmma issued since the last fence, committed and done: d may be read
// (the empty asm keeps the compiler from reading it earlier).
__device__ __forceinline__ void wg_done(float (&d)[32]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi): x in
// the low halves
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (rows g, g + 8; k16 step kk over the n8 tiles 2 kk and
// 2 kk + 1) of a warp's accumulator tiles X[2 K][4], split hi/lo.
template <int K>
__device__ __forceinline__ void split_frags(const float (&X)[2 * K][4],
                                            uint32_t (&hi)[K][4],
                                            uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    split2(X[2 * kk][0], X[2 * kk][1], hi[kk][0], lo[kk][0]);
    split2(X[2 * kk][2], X[2 * kk][3], hi[kk][1], lo[kk][1]);
    split2(X[2 * kk + 1][0], X[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split2(X[2 * kk + 1][2], X[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// dst[c * LD + t] = src[c * N + n0 + t] for c < D, t < TW, zero past N:
// 16-byte cp.async where VEC (N % 8 == 0, 16-byte aligned bases), else
// synchronous 2-byte copies.
template <int TW, int LD, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int D,
                                          int N, int n0) {
  if (VEC) {
    for (int e = threadIdx.x; e < D * (TW / 8); e += kThreads) {
      const int c = e / (TW / 8), t = 8 * (e % (TW / 8)), n = n0 + t;
      cp_async16(dst + c * LD + t, src + (size_t)c * N + (n < N ? n : 0),
                 n < N ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < D * TW; e += kThreads) {
      const int c = e / TW, t = e % TW, n = n0 + t;
      dst[c * LD + t] =
          n < N ? src[(size_t)c * N + n] : __float2bfloat16_rn(0.f);
    }
  }
}

// A [rows][64] tile (rows a multiple of 64; rows c < D copied, the others
// left as they are) in wgmma's core-matrix layout: (channel c, token n) at
// ((c / 8) * 8 + n / 8) * 64 + (c % 8) * 8 + n % 8. Eight consecutive
// threads copy one 128-byte core matrix (no bank conflict), four such
// groups 64 contiguous bytes of each of 8 rows.
template <bool VEC>
__device__ __forceinline__ void load_core(bf16* dst, const bf16* src,
                                          int rows, int D, int N, int n0) {
  if (VEC) {
    for (int e = threadIdx.x; e < rows * 8; e += kThreads) {
      const int c = (e & 7) + 8 * (e >> 6), kb = (e >> 3) & 7, n = n0 + 8 * kb;
      if (c < D)
        cp_async16(dst + ((c >> 3) * 8 + kb) * 64 + (c & 7) * 8,
                   src + (size_t)c * N + (n < N ? n : 0), n < N ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < D * 64; e += kThreads) {
      const int c = e >> 6, t = e & 63, n = n0 + t;
      dst[((c >> 3) * 8 + (t >> 3)) * 64 + (c & 7) * 8 + (t & 7)] =
          n < N ? src[(size_t)c * N + n] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int LD>
__device__ __forceinline__ void zero_rows(bf16* dst, int from, int to) {
  for (int e = threadIdx.x; e < (to - from) * LD; e += kThreads)
    dst[from * LD + e] = __float2bfloat16_rn(0.f);
}

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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// S (16 queries qw.. x 64 keys a warp; n8 tile nt holds keys 8 nt..) +=
// q^T k over the dqp channels of the [dqp][LDQ] q tile and a [dqp][LDT] k
// tile.
__device__ __forceinline__ void s_product(float (&S)[8][4], const bf16* Qs,
                                          const bf16* Ks, int dqp, int qw,
                                          int lane) {
  const int r = lane & 7, i = lane >> 3;
  for (int c = 0; c < dqp; c += 16) {
    if (c + 16 <= dqp) {
      uint32_t a[4];  // matrix i: channels c + 8 (i / 2).., queries + 8 (i % 2)
      ldsm_x4_t(a, Qs + (c + r + 8 * (i >> 1)) * LDQ + qw + 8 * (i & 1));
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // key tiles 2 np, 2 np + 1
        uint32_t b[4];  // matrix i: channels c + 8 (i % 2).., keys + 8 (i / 2)
        ldsm_x4_t(b, Ks + (c + r + 8 * (i & 1)) * LDT + 16 * np + 8 * (i >> 1));
        mma16(S[2 * np], a, b[0], b[1]);
        mma16(S[2 * np + 1], a, b[2], b[3]);
      }
    } else {  // the last 8 channels
      uint32_t a[2];
      ldsm_x2_t(a, Qs + (c + r) * LDQ + qw + 8 * (i & 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // key tiles 4 h + i
        uint32_t b[4];
        ldsm_x4_t(b, Ks + (c + r) * LDT + 32 * h + 8 * i);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma8(S[4 * h + e], a, b[e]);
      }
    }
  }
}

// Block (query tile of BQ, dv chunk y of 8 VT channels, sample b). Lane
// (g, t) of warp w holds rows qw + g (m[0], l[0], O[nt][0..1]) and
// qw + g + 8 (m[1], l[1], O[nt][2..3]) of the block's queries.
// Q8: dq <= 8 (dqp = 8 at compile time); VEC: 16-byte copies.
template <int VT, bool Q8, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) attn_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int N, int dq, int dv) {
  constexpr int CW = 8 * VT;   // channels of a chunk
  constexpr bool WG = VT == 8;  // P V^T by wgmma
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqp = Q8 ? 8 : pad8(dq);
  const int stage = (dqp + CW) * LDT;  // k tile [dqp][LDT], v tile [CW][LDT]
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [dqp][LDQ], resident
  bf16* st0 = Qs + dqp * LDQ;                // kStages stages

  const int b = blockIdx.z, c0 = blockIdx.y * CW, r0 = blockIdx.x * BQ;
  const int cw = min(CW, dv - c0);  // channels of the chunk that exist
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, qw = 16 * warp;
  const bf16* qb = q + (size_t)b * dq * N;
  const bf16* kb = k + (size_t)b * dq * N;
  const bf16* vb = v + ((size_t)b * dv + c0) * N;
  const int nkt = (N + BT - 1) / BT;

  // zero rows past dq and cw (the core-matrix layout, all of it): the
  // copies never write them
  zero_rows<LDQ>(Qs, dq, dqp);
  for (int s = 0; s < kStages; ++s) {
    zero_rows<LDT>(st0 + s * stage, dq, dqp);
    zero_rows<LDT>(st0 + s * stage + dqp * LDT, WG ? 0 : cw, CW);
  }
  load_tile<BQ, LDQ, VEC>(Qs, qb, dq, N, r0);
  auto fetch = [&](int j) {
    bf16* Ks = st0 + (j % kStages) * stage;
    load_tile<BT, LDT, VEC>(Ks, kb, dq, N, j * BT);
    if (WG)
      load_core<VEC>(Ks + dqp * LDT, vb, CW, cw, N, j * BT);
    else
      load_tile<BT, LDT, VEC>(Ks + dqp * LDT, vb, cw, N, j * BT);
  };
  fetch(0);
  cp_commit();
  if (nkt > 1) fetch(1);
  cp_commit();

  float O[VT][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // Tile j (landed, synchronised): S = q^T k_j, the online softmax's update
  // of m and l, P's hi and lo A fragments over the tile's 4 k16 steps of
  // keys, and the rows' rescale factors alpha in al.
  auto softmax_tile = [&](int j, uint32_t(&ph)[4][4], uint32_t(&pl)[4][4],
                          float(&al)[2]) {
    const bf16* Ks = st0 + (j % kStages) * stage;
    const int n0 = j * BT;
    float S[8][4] = {};
    s_product(S, Qs, Ks, dqp, qw, lane);
    if (n0 + BT > N) {  // ragged key tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = n0 + 8 * nt + 2 * t;
        if (key >= N) S[nt][0] = S[nt][2] = -INFINITY;
        if (key + 1 >= N) S[nt][1] = S[nt][3] = -INFINITY;
      }
    }
    // key n0 < N is in every tile, so the row max is finite
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(S[nt][0], S[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(S[nt][2], S[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
    al[0] = ex2(fmaf(m[0], kLog2e, -ml0));  // 0 on the first tile
    al[1] = ex2(fmaf(m[1], kLog2e, -ml1));
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
    l[0] = l[0] * al[0] + quad_sum(ps0);
    l[1] = l[1] * al[1] + quad_sum(ps1);
    m[0] = mx0;
    m[1] = mx1;
    split_frags<4>(S, ph, pl);
  };
  auto rescale_add = [&](const float(&al)[2], int nt, const float* tp) {
    O[nt][0] = fmaf(O[nt][0], al[0], tp[0]);
    O[nt][1] = fmaf(O[nt][1], al[0], tp[1]);
    O[nt][2] = fmaf(O[nt][2], al[1], tp[2]);
    O[nt][3] = fmaf(O[nt][3], al[1], tp[3]);
  };

  for (int j = 0; j < nkt; ++j) {
    cp_wait<1>();  // this thread's copies of tile j have landed
    // ... and are visible to wgmma's (async proxy) reads
    if (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's have; stage (j + 2) % 3 is read by no one
    if (j + 2 < nkt) fetch(j + 2);
    cp_commit();  // one group an iteration, empty or not
    const bf16* Vs = st0 + (j % kStages) * stage + dqp * LDT;
    uint32_t ph[4][4], pl[4][4];
    float al[2];
    softmax_tile(j, ph, pl, al);
    // P V^T, lo first, into a zeroed partial (per 8 channels), then
    // O = alpha O + partial in fp32
    if constexpr (WG) {
      // the warpgroup's 64 queries x 64 channels: 8 wgmma, V by descriptor
      // (K = keys: core matrices 128 bytes apart, N = channels: 1024)
      float Tp[32];
      const uint32_t vs = smem_addr(Vs);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = wg_desc(vs + 256 * kk, 128, 1024);
        wgmma64(Tp, pl[kk], d, kk > 0);
        wgmma64(Tp, ph[kk], d, 1);
      }
      wg_done(Tp);
#pragma unroll
      for (int nt = 0; nt < VT; ++nt) rescale_add(al, nt, Tp + 4 * nt);
    } else {
      // mma.sync, two channel tiles at a time (two independent chains), V's
      // B fragments (channel 8 nt + g, keys 16 kk + 2t..) by ldmatrix
      constexpr int NG = VT < 2 ? VT : 2;
#pragma unroll
      for (int n1 = 0; n1 < VT; n1 += NG) {
        if (8 * n1 >= cw) break;
        float Tp[NG][4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // keys 32 h.. : k16 steps 2 h, 2 h + 1
          uint32_t bv[NG][4];
#pragma unroll
          for (int u = 0; u < NG; ++u)
            ldsm_x4(bv[u], Vs + (8 * (n1 + u) + (lane & 7)) * LDT + 32 * h +
                               8 * (lane >> 3));
#pragma unroll
          for (int u = 0; u < NG; ++u) {
            mma16(Tp[u], pl[2 * h], bv[u][0], bv[u][1]);
            mma16(Tp[u], ph[2 * h], bv[u][0], bv[u][1]);
          }
#pragma unroll
          for (int u = 0; u < NG; ++u) {
            mma16(Tp[u], pl[2 * h + 1], bv[u][2], bv[u][3]);
            mma16(Tp[u], ph[2 * h + 1], bv[u][2], bv[u][3]);
          }
        }
#pragma unroll
        for (int u = 0; u < NG; ++u) rescale_add(al, n1 + u, Tp[u]);
      }
    }
  }

  // rows qw + g (r < 2) and qw + g + 8, channels 8 nt + 2t + (r & 1)
  const int n_lo = r0 + qw + g, n_hi = n_lo + 8;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  bf16* ob = o + ((size_t)b * dv + c0) * N;
#pragma unroll
  for (int nt = 0; nt < VT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 8 * nt + 2 * t + (r & 1), n = r < 2 ? n_lo : n_hi;
      if (c < cw && n < N)
        ob[(size_t)c * N + n] =
            __float2bfloat16_rn(O[nt][r] * (r < 2 ? inv0 : inv1));
    }
  if (blockIdx.y == 0 && t == 0) {
    if (n_lo < N) lse[(size_t)b * N + n_lo] = m[0] + logf(l[0]);
    if (n_hi < N) lse[(size_t)b * N + n_hi] = m[1] + logf(l[1]);
  }
}

int fwd_vt(int dv) { return dv <= 8 ? 1 : (dv <= 16 ? 2 : (dv <= 32 ? 4 : 8)); }

// Shared memory of attn_fwd_bf16_kernel<vt, ...>, in bytes.
size_t fwd_smem(int dq, int vt) {
  return 2 * ((size_t)pad8(dq) * LDQ +
              (size_t)kStages * (pad8(dq) + 8 * vt) * LDT);
}

// whole 8-element groups along N from 16-byte aligned bases
bool vec_ok(int N, uintptr_t bases) { return N % 8 == 0 && bases % 16 == 0; }

template <int VT, bool Q8, bool VEC>
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
               float* lse, int B, int N, int dq, int dv, cudaStream_t st) {
  const auto kernel = attn_fwd_bf16_kernel<VT, Q8, VEC>;
  const size_t smem = fwd_smem(dq, VT);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + BQ - 1) / BQ, (dv + 8 * VT - 1) / (8 * VT), B);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, o, lse, N, dq, dv);
  return (int)cudaGetLastError();
}

template <int VT>
int fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
        int B, int N, int dq, int dv, cudaStream_t st) {
  const bool vec = vec_ok(N, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v);
  if (dq <= 8)
    return vec ? fwd_launch<VT, true, true>(q, k, v, o, lse, B, N, dq, dv, st)
               : fwd_launch<VT, true, false>(q, k, v, o, lse, B, N, dq, dv, st);
  return vec ? fwd_launch<VT, false, true>(q, k, v, o, lse, B, N, dq, dv, st)
             : fwd_launch<VT, false, false>(q, k, v, o, lse, B, N, dq, dv, st);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// A[nt] += X^T Y over rows [0, n) (n a multiple of 8) of two [n][LDT]
// tiles: X's columns kw.. (keys) are the product's 16 rows, Y's columns
// qh + 8 nt.. (queries) its columns; each 16 channels into a zeroed partial
// added to A in fp32. S^T from k and q, dP^T from v and dO. YC: Y in the
// core-matrix layout of load_core.
template <bool YC = false>
__device__ __forceinline__ void kq_product(float (&A)[4][4], const bf16* X,
                                           const bf16* Y, int n, int kw,
                                           int qh, int lane) {
  const int r = lane & 7, i = lane >> 3;
  for (int c = 0; c < n; c += 16) {
    float p[4][4] = {};
    if (c + 16 <= n) {
      uint32_t a[4];  // matrix i: channels c + 8 (i / 2).., keys + 8 (i % 2)
      ldsm_x4_t(a, X + (c + r + 8 * (i >> 1)) * LDT + kw + 8 * (i & 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // query tiles 2 h, 2 h + 1
        uint32_t b[4];  // matrix i: channels c + 8 (i % 2).., queries + 8 (i / 2)
        ldsm_x4_t(b, YC ? Y + ((((c >> 3) + (i & 1)) * 8 + (qh >> 3) + 2 * h +
                               (i >> 1)) * 64 + r * 8)
                        : Y + (c + r + 8 * (i & 1)) * LDT + qh + 16 * h +
                              8 * (i >> 1));
        mma16(p[2 * h], a, b[0], b[1]);
        mma16(p[2 * h + 1], a, b[2], b[3]);
      }
    } else {  // the last 8 channels
      uint32_t a[2], b[4];
      ldsm_x2_t(a, X + (c + r) * LDT + kw + 8 * (i & 1));
      ldsm_x4_t(b, YC ? Y + (((c >> 3) * 8 + (qh >> 3) + i) * 64 + r * 8)
                      : Y + (c + r) * LDT + qh + 8 * i);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma8(p[nt], a, b[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) A[nt][e] += p[nt][e];
  }
}

// P^T = exp(S^T - lse) in place; 0 for keys or queries past N.
__device__ __forceinline__ void softmax_p(float (&P)[4][4], const float* Ls,
                                          int n0, int N, int qh, int t,
                                          bool key_lo, bool key_hi) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int qi = qh + 8 * nt + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(Ls + qi);
    const bool q0 = n0 + qi < N, q1 = n0 + qi + 1 < N;
    P[nt][0] = key_lo && q0 ? __expf(P[nt][0] - l.x) : 0.f;
    P[nt][1] = key_lo && q1 ? __expf(P[nt][1] - l.y) : 0.f;
    P[nt][2] = key_hi && q0 ? __expf(P[nt][2] - l.x) : 0.f;
    P[nt][3] = key_hi && q1 ? __expf(P[nt][3] - l.y) : 0.f;
  }
}

// D[nt] += A R^T for the channels 8 nt.. (8 nt < n) of R, a [channel][LDT]
// tile over the query tile, A (P^T or dS^T, 16 keys x 32 queries qh..)
// given by its hi and lo A fragments; each 8 channels through a zeroed
// partial of this query tile, added to D in fp32. dV from dO, dK from q.
template <int C>
__device__ __forceinline__ void pt_accumulate(float (&D)[C][4],
                                              const uint32_t (&hi)[2][4],
                                              const uint32_t (&lo)[2][4],
                                              const bf16* R, int n, int qh,
                                              int lane) {
#pragma unroll
  for (int nt = 0; nt < C; ++nt) {
    if (8 * nt >= n) break;
    uint32_t b[4];  // matrix i: channels 8 nt.., queries qh + 8 i..
    ldsm_x4(b, R + (8 * nt + (lane & 7)) * LDT + qh + 8 * (lane >> 3));
    float p[4] = {};
    mma16(p, lo[0], b[0], b[1]);
    mma16(p, hi[0], b[0], b[1]);
    mma16(p, lo[1], b[2], b[3]);
    mma16(p, hi[1], b[2], b[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) D[nt][e] += p[e];
  }
}

// Warp w < 4: dQ of the tile's queries 16 w.. for channels c0 + 8 nt..
// (below dqp) = dS k^T over the block's 64 keys, dS from its hi and lo
// [key][query] tiles, k's rows from Kr (a [channel][LDT] tile whose row 0
// is channel c0). Written into the group's partial on the group's first key
// tile, added to it on the others (the old values loaded before the
// products, so their latency hides behind them).
template <int QT>
__device__ __forceinline__ void dq_chunk(const bf16* Sh, const bf16* Sl,
                                         const bf16* Kr, int c0, int dqp,
                                         int dq, float* part, int n0, int N,
                                         bool first, int warp, int lane) {
  const int qw = 16 * warp, r = lane & 7, i = lane >> 3, g = lane >> 2,
            t = lane & 3;
  float acc[QT][4] = {}, prev[QT][4] = {};
  if (!first) {
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * nt + 2 * t + (e & 1);
        const int n = n0 + qw + g + 8 * (e >> 1);
        if (c < dq && n < N) prev[nt][e] = part[(size_t)c * N + n];
      }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk..
    uint32_t ah[4], al[4];  // matrix i: keys 16 kk + 8 (i / 2).., queries + 8 (i % 2)
    const int off = (16 * kk + r + 8 * (i >> 1)) * LDT + qw + 8 * (i & 1);
    ldsm_x4_t(ah, Sh + off);
    ldsm_x4_t(al, Sl + off);
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) {
      if (c0 + 8 * nt >= dqp) break;
      uint32_t b[2];  // matrix i: channels 8 nt.., keys 16 kk + 8 i..
      ldsm_x2(b, Kr + (8 * nt + r) * LDT + 16 * kk + 8 * (i & 1));
      mma16(acc[nt], al, b[0], b[1]);
      mma16(acc[nt], ah, b[0], b[1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < QT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * nt + 2 * t + (e & 1);
      const int n = n0 + qw + g + 8 * (e >> 1);
      if (c < dq && n < N)
        part[(size_t)c * N + n] = first ? acc[nt][e] : prev[nt][e] + acc[nt][e];
    }
}

// The two warps of a key group hold dK and dV over their query halves:
// warp w + 4's go through shared memory at sm (free when this is called)
// and are added to warp w's, which write keys key0 and key0 + 8 of dK
// channels ck0.. and dV channels cv0.., rounded to bf16.
template <int QT, int VT>
__device__ __forceinline__ void write_dkdv(
    float (&dK)[QT][4], float (&dV)[VT][4], float* sm, bf16* dk_out,
    bf16* dv_out, int key0, int ck0, int cv0, int dq, int dv, int N,
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
      if (with_ds && c < dq)
        dk_out[(size_t)c * N + key] = __float2bfloat16_rn(dK[nt][r]);
    }
#pragma unroll
    for (int nt = 0; nt < VT; ++nt) {
      const int c = cv0 + 8 * nt + 2 * t + (r & 1);
      if (with_dv && c < dv)
        dv_out[(size_t)c * N + key] = __float2bfloat16_rn(dV[nt][r]);
    }
  }
}

// Block (key-tile group x, output chunk y, sample b). For each key tile of
// its group, warp w owns keys kw = 16 (w % 4).. of the tile and queries
// qh = 32 (w / 4).. of each query tile i:
//   S^T = k^T q_i,  P^T = exp(S^T - lse_i),  dP^T = v^T dO_i,
//   dS^T = P^T (dP^T - delta_i),  dV += P^T dO_i^T,  dK += dS^T q_i^T,
//   dQ_i += dS k^T  (into the group's partial).
// Chunk y accumulates dK channels [8 QT y, 8 QT (y + 1)) and dV channels
// [8 VT y, 8 VT (y + 1)); only blocks with a dK chunk compute dP and dS,
// and only y = 0 writes dQ. QT = 1 means dq <= 8 (dqp = 8 at compile
// time); VEC: 16-byte copies.
template <int QT, int VT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) attn_bwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
    float* __restrict__ dq_part, int N, int dq, int dv, int per) {
  // WG: dV = P^T dO^T by wgmma, each warpgroup's 64 keys x 64 channels
  // over its 32 queries, dO in the core-matrix layout (its rows padded to a
  // whole chunk of 64)
  constexpr bool WG = QT == 1 && VT == 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqp = QT == 1 ? 8 : pad8(dq), dvp = pad8(dv);
  const int dvo = WG ? (dv + 63) & ~63 : dvp;  // dO rows of a stage
  // a stage: q [dqp][LDT], dO [dvo][LDT], lse [BT], delta [BT] (fp32)
  const int stage = (dqp + dvo) * LDT + 4 * BT;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [dqp][LDT], resident
  bf16* Vs = Ks + dqp * LDT;                 // [dvp][LDT], resident
  bf16* Ss = Vs + dvp * LDT;  // 2 buffers x {hi, lo} [BT keys][LDT] dS^T
  bf16* st0 = Ss + 4 * BT * LDT;  // kStages stages

  const int b = blockIdx.z, y = blockIdx.y, ck0 = 8 * QT * y, cv0 = 8 * VT * y;
  const bool with_ds = ck0 < dq, with_dv = cv0 < dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3, kw = 16 * (warp & 3), qh = 32 * (warp >> 2);
  const size_t oq = (size_t)b * dq * N, ov = (size_t)b * dv * N;
  const float* lb = lse + (size_t)b * N;
  const float* db = delta + (size_t)b * N;
  const int nkt = (N + BT - 1) / BT, j_first = blockIdx.x * per;
  float* part = dq_part + ((size_t)b * gridDim.x + blockIdx.x) * dq * N;

  auto fetch = [&](int i) {
    bf16* Qs = st0 + (i % kStages) * stage;
    bf16* Os = Qs + dqp * LDT;
    float* Ls = reinterpret_cast<float*>(Os + dvo * LDT);
    const int n0 = i * BT, n = n0 + (threadIdx.x & (BT - 1));
    load_tile<BT, LDT, VEC>(Qs, q + oq, dq, N, n0);
    if (WG)
      load_core<VEC>(Os, dO + ov, dvo, dv, N, n0);
    else
      load_tile<BT, LDT, VEC>(Os, dO + ov, dv, N, n0);
    if (threadIdx.x < 2 * BT)
      tf32x3::cp_async(Ls + threadIdx.x,
                       (threadIdx.x < BT ? lb : db) + (n < N ? n : 0),
                       n < N ? 4 : 0, false);
  };

  for (int jt = j_first; jt < min(nkt, j_first + per); ++jt) {
    const int j0 = jt * BT;
    const bool key_lo = j0 + kw + g < N, key_hi = j0 + kw + g + 8 < N;
    zero_rows<LDT>(Ks, dq, dqp);
    zero_rows<LDT>(Vs, dv, dvp);
    for (int s = 0; s < kStages; ++s) {
      zero_rows<LDT>(st0 + s * stage, dq, dqp);
      zero_rows<LDT>(st0 + s * stage + dqp * LDT, WG ? 0 : dv, dvo);
    }
    load_tile<BT, LDT, VEC>(Ks, k + oq, dq, N, j0);
    load_tile<BT, LDT, VEC>(Vs, v + ov, dv, N, j0);
    fetch(0);
    cp_commit();
    if (nkt > 1) fetch(1);
    cp_commit();

    float dK[QT][4] = {}, dV[VT][4] = {};
    for (int i = 0; i < nkt; ++i) {
      cp_wait<1>();
      // this thread's copies are visible to wgmma's (async proxy) reads
      if (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // tile i is in; stage (i + 2) % 3 is read by no one
      if (i + 2 < nkt) fetch(i + 2);
      cp_commit();
      const bf16* Qs = st0 + (i % kStages) * stage;
      const bf16* Os = Qs + dqp * LDT;
      const float* Ls = reinterpret_cast<const float*>(Os + dvo * LDT);
      const float* Ds = Ls + BT;
      bf16* Sh = Ss + (i & 1) * 2 * BT * LDT;  // written two tiles apart
      bf16* Sl = Sh + BT * LDT;
      const int n0 = i * BT;

      // P^T (16 keys x 32 queries a warp): n8 tile nt holds queries qh + 8 nt..
      float P[4][4] = {};
      kq_product(P, Ks, Qs, dqp, kw, qh, lane);
      softmax_p(P, Ls, n0, N, qh, t, key_lo, key_hi);
      uint32_t hi[2][4], lo[2][4];
      split_frags<2>(P, hi, lo);
      if (with_dv) {
        if constexpr (WG) {
          // K = the warpgroup's 32 queries (core matrices 128 bytes apart),
          // N = channels cv0.. (1024 bytes apart); lo first
          float Tp[32];
          const uint32_t ob =
              smem_addr(Os) + (cv0 >> 3) * 1024 + (qh >> 3) * 128;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint64_t d = wg_desc(ob + 256 * kk, 128, 1024);
            wgmma64(Tp, lo[kk], d, kk > 0);
            wgmma64(Tp, hi[kk], d, 1);
          }
          wg_done(Tp);
#pragma unroll
          for (int nt = 0; nt < VT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dV[nt][e] += Tp[4 * nt + e];
        } else {
          pt_accumulate<VT>(dV, hi, lo, Os + cv0 * LDT, dvp - cv0, qh, lane);
        }
      }
      if (with_ds) {
        float G[4][4] = {};  // dP^T, then dS^T
        kq_product<WG>(G, Vs, Os, dvp, kw, qh, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 d =
              *reinterpret_cast<const float2*>(Ds + qh + 8 * nt + 2 * t);
          G[nt][0] = P[nt][0] * (G[nt][0] - d.x);
          G[nt][1] = P[nt][1] * (G[nt][1] - d.y);
          G[nt][2] = P[nt][2] * (G[nt][2] - d.x);
          G[nt][3] = P[nt][3] * (G[nt][3] - d.y);
        }
        split_frags<2>(G, hi, lo);
        // fragment e of step kk: key kw + g + 8 (e % 2), queries
        // qh + 16 kk + 8 (e / 2) + 2t..
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int at = (kw + g + 8 * (e & 1)) * LDT + qh + 16 * kk +
                           8 * (e >> 1) + 2 * t;
            *reinterpret_cast<uint32_t*>(Sh + at) = hi[kk][e];
            *reinterpret_cast<uint32_t*>(Sl + at) = lo[kk][e];
          }
        pt_accumulate<QT>(dK, hi, lo, Qs + ck0 * LDT, dqp - ck0, qh, lane);
        __syncthreads();  // dS of all eight warps is in Sh, Sl
        if (y == 0 && warp < 4)
          for (int cq0 = 0; cq0 < dqp; cq0 += 8 * QT)
            dq_chunk<QT>(Sh, Sl, Ks + cq0 * LDT, cq0, dqp, dq, part, n0, N,
                         jt == j_first, warp, lane);
      }
    }
    cp_wait<0>();
    __syncthreads();  // every copy is in and every reader is done: sm is free
    write_dkdv<QT, VT>(dK, dV, reinterpret_cast<float*>(smem), dk_out + oq,
                       dv_out + ov, j0 + kw + g, ck0, cv0, dq, dv, N, with_ds,
                       with_dv);
    __syncthreads();  // the next key tile's loads overwrite sm
  }
}

// dq[b, c, n] = sum_x dq_part[b, x, c, n] over the groups x in order: no
// float atomics; rounded once to bf16.
__global__ void __launch_bounds__(256) attn_dq_reduce_bf16_kernel(
    const float* __restrict__ dq_part, bf16* __restrict__ dq_out, int ng,
    int dqn, int total) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  const int b = e / dqn;
  const float* p = dq_part + (size_t)b * ng * dqn + (e - b * dqn);
  float s = 0.f;
  for (int j = 0; j < ng; ++j) s += p[(size_t)j * dqn];
  dq_out[e] = __float2bfloat16_rn(s);
}

// dK chunks of 8 qt channels, dV chunks of 8 vt, and the grid's y extent
int bwd_tiles(int dq, int dv, int* qt, int* vt) {
  *qt = dq <= 8 ? 1 : 8;
  *vt = dv <= 16 ? 2 : 8;
  const int nyk = (dq + 8 * *qt - 1) / (8 * *qt);
  const int nyv = (dv + 8 * *vt - 1) / (8 * *vt);
  return nyk > nyv ? nyk : nyv;
}

// The key-tile groups of the dq partials: about two blocks an SM over the
// grid (B, ny), at most min(key tiles, kDqGroups); per = consecutive key
// tiles a group. Returns the number of groups.
int dq_groups(int B, int N, int ny, int* per) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nkt = (N + BT - 1) / BT;
  const int cap = nkt < kDqGroups ? nkt : kDqGroups;
  int want = (2 * sms + B * ny - 1) / (B * ny);
  want = want < 1 ? 1 : (want > cap ? cap : want);
  const int p = (nkt + want - 1) / want;
  if (per) *per = p;
  return (nkt + p - 1) / p;
}

// Shared memory of attn_bwd_bf16_kernel, in bytes (write_dkdv's scratch,
// at most 4 x 16 x 128 floats, fits in the dS buffers alone).
size_t bwd_smem(int dq, int dv) {
  int qt, vt;
  bwd_tiles(dq, dv, &qt, &vt);
  const size_t dvo = qt == 1 && vt == 8 ? (dv + 63) & ~63 : pad8(dv);
  return 2 * ((pad8(dq) + pad8(dv)) * LDT +
              kStages * ((pad8(dq) + dvo) * LDT + 4 * BT) + 4 * BT * LDT);
}

template <int QT, int VT, bool VEC>
int bwd_launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dO,
               const float* lse, const float* delta, bf16* dq_out,
               bf16* dk_out, bf16* dv_out, float* dq_part, int B, int N,
               int dq, int dv, int ny, cudaStream_t st) {
  const auto kernel = attn_bwd_bf16_kernel<QT, VT, VEC>;
  const size_t smem = bwd_smem(dq, dv);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  int per;
  const int ng = dq_groups(B, N, ny, &per);
  kernel<<<dim3(ng, ny, B), kThreads, smem, st>>>(
      q, k, v, dO, lse, delta, dk_out, dv_out, dq_part, N, dq, dv, per);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  const int total = B * dq * N;
  attn_dq_reduce_bf16_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      dq_part, dq_out, ng, dq * N, total);
  return (int)cudaGetLastError();
}

template <int QT, int VT>
int bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dO,
        const float* lse, const float* delta, bf16* dq_out, bf16* dk_out,
        bf16* dv_out, float* dq_part, int B, int N, int dq, int dv, int ny,
        cudaStream_t st) {
  const bool vec = vec_ok(N, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                 (uintptr_t)dO);
  return (vec ? bwd_launch<QT, VT, true> : bwd_launch<QT, VT, false>)(
      q, k, v, dO, lse, delta, dq_out, dk_out, dv_out, dq_part, B, N, dq, dv,
      ny, st);
}

bool serves(int dq, int dv, bool backward) {
  if (dq < 1 || dv < 1) return false;
  return backward ? bwd_smem(dq, dv) <= (size_t)kMaxSmem
                  : fwd_smem(dq, fwd_vt(dv)) <= (size_t)kMaxSmem;
}

}  // namespace

extern "C" {

// 1 where this library's kernels take (dq, dv) (the forward's, or the
// backward's with backward != 0), else 0: flash_attention.cu's
// gcc_attn_{fwd,bwd}_bf16_wide take those shapes.
int gcc_attn_bf16_serves(int dq, int dv, int backward) {
  return serves(dq, dv, backward != 0) ? 1 : 0;
}

// Bytes of dynamic shared memory the forward's (backward != 0: the
// backward's) kernel takes for (dq, dv): more than a block has where it
// does not serve the shape.
int gcc_attn_bf16_smem(int dq, int dv, int backward) {
  return (int)(backward ? bwd_smem(dq, dv) : fwd_smem(dq, fwd_vt(dv)));
}

// Forward on bf16 q, k (B,dq,N), v (B,dv,N): o (B,dv,N) bf16, lse (B,N)
// fp32. cudaErrorInvalidValue for a shape it does not serve.
int gcc_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int N, int dq, int dv, void* stream) {
  if (!serves(dq, dv, false)) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fwd_vt(dv)) {
    case 1: return fwd<1>(qb, kb, vb, ob, lse, B, N, dq, dv, st);
    case 2: return fwd<2>(qb, kb, vb, ob, lse, B, N, dq, dv, st);
    case 4: return fwd<4>(qb, kb, vb, ob, lse, B, N, dq, dv, st);
    default: return fwd<8>(qb, kb, vb, ob, lse, B, N, dq, dv, st);
  }
}

// Key-tile groups of gcc_attn_bwd_bf16's dq partials (at most 64).
int gcc_attn_bwd_bf16_groups(int B, int N, int dq, int dv) {
  int qt, vt;
  return dq_groups(B, N, bwd_tiles(dq, dv, &qt, &vt), nullptr);
}

// Backward, one pass, on bf16 q, k (B,dq,N), v, dO (B,dv,N), fp32 lse and
// delta = sum_c dO * O (B,N). Writes bf16 dq_out, dk_out (B,dq,N), dv_out
// (B,dv,N); dq_part is fp32 scratch of
// B * gcc_attn_bwd_bf16_groups(B, N, dq, dv) * dq * N floats.
int gcc_attn_bwd_bf16(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq_out, void* dk_out, void* dv_out,
                      float* dq_part, int B, int N, int dq, int dv,
                      void* stream) {
  if (!serves(dq, dv, true)) return (int)cudaErrorInvalidValue;
  int qt, vt;
  const int ny = bwd_tiles(dq, dv, &qt, &vt);
  auto run = [&](auto f) {
    return f(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse,
             delta, static_cast<bf16*>(dq_out), static_cast<bf16*>(dk_out),
             static_cast<bf16*>(dv_out), dq_part, B, N, dq, dv, ny,
             static_cast<cudaStream_t>(stream));
  };
  if (qt == 1) return vt == 2 ? run(bwd<1, 2>) : run(bwd<1, 8>);
  return vt == 2 ? run(bwd<8, 2>) : run(bwd<8, 8>);
}

}  // extern "C"
