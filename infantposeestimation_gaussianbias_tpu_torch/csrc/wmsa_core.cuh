// The W-MSA attention of one (window, head) on the tensor cores: the
// forward (`attention_fwd`: S, the row softmax, O = P v), shared by K1 and
// K1-hm (csrc/window_msa.cu, which replace `window_attention_pallas_qkv`
// and `window_attention_pallas_hm` of
// infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py:222 and
// :50), by K4's forward (csrc/fused_attn.cu, which replaces
// `_attn_half_fwd_kernel` of ops/pallas/fused_block.py:511) and by the
// backward's recompute, and the backward (`attention_bwd`), shared by K2
// (csrc/window_msa_bwd.cu, which replaces `_qkv_vjp_bwd` of
// ops/pallas/window_msa.py:422) and by K4's backward (`_attn_half_bwd` of
// fused_block.py:590).  The forward's bf16(o) and the backward's
// recomputed one come from the same code, bit for bit.  A caller stages
// its q, k, v (and dO) as the operand tiles below; only that staging
// differs between callers (K1, K1-hm and K2 through csrc/wmsa_stage.cuh).
//
// Contract, for N <= 64 tokens and a head dim hd <= 64, with q, k, v and dO
// (N, hd) operands in shared memory and scale = hd^-0.5:
//   S  = scale * q k^T + bias;  P = softmax(S) by rows;  O = P v
//   dP = dO v^T;  dS = P o (dP - rowsum(dP o P))
//   dQ = scale * dS k;  dK = scale * dS^T q;  dV = P^T dO
//   dbias += dS (float32, summed by the caller over its windows).
//
// What bounded the float32 versions it replaces: one thread per output
// element, every FMA with two shared-memory reads, ~10 N^2 hd FMAs per
// (window, head) on the CUDA cores (the forward ~2 N^2 hd, one block per
// window walking all heads): shared-memory bandwidth set the pace.
// Here the products are bf16 `mma.sync.m16n8k16` with float32
// accumulation on 64 x 48 tiles (N padded to a multiple of 16, hd to a
// multiple of 16), their operands loaded with `ldmatrix` (plain or
// transposed: one instruction per 16 x 16 fragment).  The padding is zero
// (columns stored as zeros, rows >= N read from a zero row), -inf in the
// softmax, and reaches no output.  One warp holds 16 rows of S in its
// accumulators, takes the row softmax there with quad shuffles and feeds
// P straight back as the A operand of O = P v (FlashAttention-2's
// forward); the backward does the same with dP and dS for dQ.  dV and dK
// sum over the rows, which four warps hold: P and then dS go through one
// shared bf16 exchange tile pair (their two terms; never a float32 tile,
// never device memory), and each warp reads its 16 columns back
// transposed.
//
// Numerics: the float32 semantics of the plain versions.  A float32
// operand is split into bf16 terms x = t0 + t1 (+ t2), each product of
// terms is exact in float32 and accumulated in float32; the products keep
// the term pairs (i, j) with i + j < L.  Inputs exact in bf16 (K2's q, k,
// v, dO in a bf16 model) take one term.  K2's float32 inputs take three
// (S and dP keep 6 pairs, L = 3: S to ~2^-24, so dbias, summed over
// thousands of windows, holds 1e-4); K1's and K4's float32 q, k, v (and
// K4's dO, forward and backward) take two (3 pairs).  P and dS take two
// terms (2^-17 relative) and their products L = 2: three pairs.  The
// softmax takes __expf (relative error ~2^-21) and one reciprocal per row.
// tests/test_torch_wmsa_bwd_core.py, tests/test_torch_wmsa_fwd_core.py and
// tests/test_torch_k1_core.py hold the emulations of these products
// (kernels/window_msa.py) against the plain versions' float32 maths.
//
// Layout: a block of kThreads = 128 threads (4 warps) runs the core on one
// (window, head) at a time, warp w on rows 16 w ..; the caller
// synchronises before it (its operands written).  `attention_bwd` ends
// past a barrier (its shared memory free); `attention_fwd` only reads
// shared memory, and the caller synchronises before it overwrites the
// operands.  S and dP are computed one after the other (the softmax
// between) so that one product's fragments are live at a time.  Every sum
// runs in a fixed order, so the result is deterministic and does not
// depend on which other heads or windows share the launch.
#pragma once

#include <cstdint>

#include <math_constants.h>

#include "ipe_common.cuh"

namespace {
namespace wcore {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 64;          // tokens: 4 slabs of 16 rows, one per warp
constexpr int kMaxHd = 64;
constexpr int kXLd = kMaxN + 8;    // bf16 row stride of the exchange tiles
constexpr int kZeroRow = kXLd;     // bf16 zeros that rows >= N read

// Row strides are multiples of 8 bf16 (16-byte rows for ldmatrix) and an
// odd number of 16-byte units (the 8 rows of a matrix in different banks).
__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ __forceinline__ int operand_ld(int hd) { return pad16(hd) + 8; }

// Shared memory of the exchange: P (then dS) as two bf16 terms, N rows.
__host__ __device__ __forceinline__ size_t exchange_bytes(int N) {
  return 2 * sizeof(bf16) * (size_t)N * kXLd;
}

// NT bf16 term tiles of one (N, hd) operand: term t's element (r, c) at
// p[t * term + r * ld + c], ld = operand_ld(hd); columns hd .. pad16(hd)
// hold zeros.  16-byte aligned.
struct Operand {
  const bf16* p;
  int ld, term;
};

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane l of an x4 ldmatrix addresses row (l & 7) of matrix l >> 3.  The
// four loaders below give, for a tile stored row-major with row stride ld
// (rows >= `rows` read as zeros):
//   a_rows: the A fragment of rows m0 .. m0+15, depth k0 .. k0+15;
//   b_rows: the B fragments (b0, b1 of n tile n0; b0, b1 of n0 + 8) of a
//           tile stored (n, k), depth k0;
//   b_cols: the same of a tile stored (k, n) (transposed load);
//   a_cols: the A fragment of X^T, rows m0.. of X^T = columns of X, depth
//           k0.. = rows of X, of a tile X stored (k, m) (transposed load).
__device__ __forceinline__ const bf16* row_ptr(const bf16* p, int r, int ld, int rows,
                                               const bf16* zrow) {
  return r < rows ? p + r * ld : zrow;
}

__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* p, int ld, int rows,
                                       const bf16* zrow, int m0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm(a, row_ptr(p, m0 + (l & 7) + 8 * (mi & 1), ld, rows, zrow) + k0 + 8 * (mi >> 1));
}

__device__ __forceinline__ void b_rows(uint32_t (&b)[4], const bf16* p, int ld, int rows,
                                       const bf16* zrow, int n0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm(b, row_ptr(p, n0 + (l & 7) + 8 * (mi >> 1), ld, rows, zrow) + k0 + 8 * (mi & 1));
}

__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* p, int ld, int rows,
                                       const bf16* zrow, int n0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm_t(b, row_ptr(p, k0 + (l & 7) + 8 * (mi & 1), ld, rows, zrow) + n0 + 8 * (mi >> 1));
}

__device__ __forceinline__ void a_cols(uint32_t (&a)[4], const bf16* p, int ld, int rows,
                                       const bf16* zrow, int m0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm_t(a, row_ptr(p, k0 + (l & 7) + 8 * (mi >> 1), ld, rows, zrow) + m0 + 8 * (mi & 1));
}

// x and y (a pair's lower and upper element) as NT bf16-pair terms.
template <int NT>
__device__ __forceinline__ void split(float x, float y, uint32_t (&o)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    o[i] = *reinterpret_cast<const uint32_t*>(&v);
    x -= __low2float(v);
    y -= __high2float(v);
  }
}

// acc0 (n tile n0) and acc1 (n0 + 8) += A B over the term pairs i + j < L;
// b[j] holds B term j's fragments of both tiles as b_rows / b_cols load them.
template <int NA, int NB, int L>
__device__ __forceinline__ void mma_pair(float (&acc0)[4], float (&acc1)[4],
                                         const uint32_t (&a)[NA][4],
                                         const uint32_t (&b)[NB][4]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < L) {
        mma(acc0, a[i], b[j][0], b[j][1]);
        mma(acc1, a[i], b[j][2], b[j][3]);
      }
}

// The A fragment of a 16-row slab X from its accumulators x[n8 tile][4]
// (tiles 2kk and 2kk + 1, X's columns, are depth step kk of the next
// product), as two bf16 terms.
__device__ __forceinline__ void a_from_acc(const float (&x)[8][4], int kk, uint32_t (&a)[2][4]) {
  uint32_t u[4][2];
  split<2>(x[2 * kk][0], x[2 * kk][1], u[0]);
  split<2>(x[2 * kk][2], x[2 * kk][3], u[1]);
  split<2>(x[2 * kk + 1][0], x[2 * kk + 1][1], u[2]);
  split<2>(x[2 * kk + 1][2], x[2 * kk + 1][3], u[3]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int s = 0; s < 4; ++s) a[i][s] = u[s][i];
}

// acc (16 rows x pad16(hd) columns) = A B over `steps` k16 steps of
// tokens; B(token, d) = terms 0 .. NB-1 of operand b; afrag(kk, a) gives
// A's two terms at step kk.
template <int NB, class AF>
__device__ __forceinline__ void tokens_product(float (&acc)[8][4], int steps, int dsteps,
                                               int N, const Operand& b, const bf16* zrow,
                                               AF afrag) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxN / 16; ++kk) {
    if (kk < steps) {
      uint32_t a[2][4];
      afrag(kk, a);
#pragma unroll
      for (int np = 0; np < kMaxHd / 16; ++np) {
        if (np < dsteps) {
          uint32_t bb[NB][4];
#pragma unroll
          for (int t = 0; t < NB; ++t)
            b_cols(bb[t], b.p + t * b.term, b.ld, N, zrow, np * 16, kk * 16);
          mma_pair<2, NB, 2>(acc[2 * np], acc[2 * np + 1], a, bb);
        }
      }
    }
  }
}

// out(row, col, x0, x1, two) for the valid element pairs (col even; x1 at
// col + 1 when `two`) of a 16-row accumulator slab, scaled by mul; colsum
// (when not null): this warp's column sums added to colsum[col].
template <class OF>
__device__ __forceinline__ void emit(const float (&acc)[8][4], int m0, int rows, int cols,
                                     int ntd, float mul, float* colsum, OF out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt < ntd) {
      const int c = nt * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + g + 8 * r;
        if (m < rows && c < cols)
          out(m, c, mul * acc[nt][2 * r], mul * acc[nt][2 * r + 1], c + 1 < cols);
      }
      if (colsum) {
        // Column sums of this slab: rows g and g + 8, then over g (lanes
        // 4 apart) in a fixed butterfly order.
        float s0 = m0 + g < rows ? mul * acc[nt][0] : 0.f;
        float s1 = m0 + g < rows ? mul * acc[nt][1] : 0.f;
        s0 += m0 + g + 8 < rows ? mul * acc[nt][2] : 0.f;
        s1 += m0 + g + 8 < rows ? mul * acc[nt][3] : 0.f;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (g == 0) {
          if (c < cols) colsum[c] += s0;
          if (c + 1 < cols) colsum[c + 1] += s1;
        }
      }
    }
  }
}

// x0 (and x1 when `two`) to p[0] (and p[1]) in T, rounded to nearest even:
// one 4- or 8-byte store where p is aligned for it.
__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (two) p[1] = __float2bfloat16(x1);
  }
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (two) p[1] = x1;
  }
}

// Both terms of a 16-row accumulator slab x into the exchange (rows < N).
__device__ __forceinline__ void to_exchange(const float (&x)[8][4], bf16* xch, int i0, int N,
                                            int ntn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt < ntn) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < N) {
          uint32_t u[2];
          split<2>(x[nt][2 * r], x[nt][2 * r + 1], u);
          const int at = i * kXLd + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(xch + at) = u[0];
          *reinterpret_cast<uint32_t*>(xch + N * kXLd + at) = u[1];
        }
      }
    }
  }
}

// A register dbias accumulator ([nt][e] as add_ds gives them) into dst
// (N, N): the rows of this warp.
__device__ __forceinline__ void store_dbias(const float (&dbias)[8][4], int N, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = warp * 16 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
      if (i < N && j < N) dst[i * N + j] = dbias[nt][e];
    }
}

// What attention_fwd computes.  kAttend: the attention (every caller but
// K8).  K8's phase ablation (csrc/window_msa_ablate.cu, the TPU probe's
// bodies) compiles parts of it out: kGemmOnly, the two products alone (P
// = 0.01 scale q k^T, no bias, no softmax); kSoftOnly, the softmax alone
// (S = q[i][0] + bias(i, j), unscaled, no product; O = q * rowsum(P)).
constexpr int kAttend = 0, kGemmOnly = 1, kSoftOnly = 2;

// The forward of one (window, head) on this warp's 16 rows i0 = 16 warp
// (an active warp: i0 < N); see the header.  NI: bf16 terms of the q, k, v
// operands.  bias(i, j): the float32 bias of S.  Leaves P in s (the
// accumulator layout [n8 tile][e]: rows i0 + g, i0 + g + 8, columns
// nt * 8 + 2t (+1); zero where masked).  kWithO: O = P v, P taken from s
// as two bf16 terms (never through shared memory) and v in min(NI, 2),
// and out(row, col, x0, x1, two) for O's valid element pairs as emit
// gives them.  Reads shared memory only.  kMode: see above.
template <int NI, bool kWithO, int kMode = kAttend, class BF, class OF>
__device__ __forceinline__ void attention_fwd(const Operand& q, const Operand& k,
                                              const Operand& v, int N, int hd, float scale,
                                              BF bias, const bf16* zrow, float (&s)[8][4],
                                              OF out) {
  constexpr int NB = NI < 2 ? NI : 2;  // v's terms in the product with P
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (N + 15) >> 4;    // k16 steps over the tokens
  const int ntn = 2 * steps;          // n8 tiles over the tokens
  const int dsteps = pad16(hd) >> 4;  // k16 steps over the head dim
  const int i0 = warp * 16;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  // q's element (i, c): the sum of its terms.
  auto q_at = [&](int i, int c) {
    float x = 0.f;
#pragma unroll
    for (int n = 0; n < NI; ++n) x += __bfloat162float(q.p[n * q.term + i * q.ld + c]);
    return x;
  };
  if constexpr (kMode == kSoftOnly) {
    // S = q[i][0] broadcast over the keys.
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = i0 + g + 4 * e;
      const float x = i < N ? q_at(i, 0) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][e] = s[nt][e + 1] = x;
    }
  } else {
    // S = q k^T over the head dim.
    for (int kk = 0; kk < dsteps; ++kk) {
      uint32_t aq[NI][4];
#pragma unroll
      for (int x = 0; x < NI; ++x) a_rows(aq[x], q.p + x * q.term, q.ld, N, zrow, i0, kk * 16);
#pragma unroll
      for (int np = 0; np < kMaxN / 16; ++np) {
        if (np < steps) {
          uint32_t bk[NI][4];
#pragma unroll
          for (int x = 0; x < NI; ++x)
            b_rows(bk[x], k.p + x * k.term, k.ld, N, zrow, np * 16, kk * 16);
          mma_pair<NI, NI, NI>(s[2 * np], s[2 * np + 1], aq, bk);
        }
      }
    }
  }
  if constexpr (kMode == kGemmOnly) {
    // P = 0.01 scale S, zero where masked.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = (nt < ntn && i < N && j < N) ? 0.01f * (scale * s[nt][e]) : 0.f;
      }
  } else {
    // Row softmax on rows i0 + g (e < 2) and i0 + g + 8 (e >= 2); a row is
    // held by the 4 lanes of a quad.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
        const float x = (nt < ntn && i < N && j < N)
                            ? (kMode == kSoftOnly ? s[nt][e] : scale * s[nt][e]) + bias(i, j)
                            : -CUDART_INF_F;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e] == -CUDART_INF_F ? 0.f : __expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = x;
        sum[e >> 1] += x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sum[r] = sum[r] > 0.f ? 1.f / sum[r] : 0.f;  // a row of padding has none
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= sum[e >> 1];
  }
  if constexpr (kWithO && kMode == kSoftOnly) {
    // O = q * rowsum(P), no product.
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[e >> 1] += s[nt][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
    }
    for (int c = 2 * t; c < hd; c += 8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        const bool two = c + 1 < hd;
        if (i < N) out(i, c, q_at(i, c) * ps[r], two ? q_at(i, c + 1) * ps[r] : 0.f, two);
      }
  } else if constexpr (kWithO) {
    float acc[8][4];
    tokens_product<NB>(acc, steps, dsteps, N, v, zrow,
                       [&](int kk, uint32_t (&a)[2][4]) { a_from_acc(s, kk, a); });
    emit(acc, i0, N, hd, 2 * dsteps, 1.f, nullptr, out);
  }
}

// The core on one (window, head); see the header.  NI: bf16 terms of the
// q, k, v, dO operands.  bias(i, j): the float32 bias of S.  add_ds(nt, e,
// i, j, x): adds dS[i][j] = x, accumulator element [nt][e] of this thread,
// to the caller's dbias (each (i, j) comes from one thread only, every
// window: registers, as store_dbias writes them, or shared memory).  xch: exchange_bytes(N) of shared memory; zrow:
// kZeroRow bf16 zeros.  out(kind, row, col, x0, x1, two), kind 0 dQ, 1 dK,
// 2 dV, 3 O, for the valid element pairs as emit gives them; colsum (when not null): float
// [kWarps][3][kMaxHd], warp w adds the column sums of its rows of dQ, dK,
// dV to colsum[w][kind].  Starts with the operands written and
// synchronised; ends past a barrier.
template <int NI, bool kWithO, class BF, class DF, class OF>
__device__ void attention_bwd(const Operand& q, const Operand& k, const Operand& v,
                              const Operand& dO, int N, int hd, float scale, BF bias,
                              DF add_ds, bf16* xch, const bf16* zrow, float* colsum, OF out) {
  constexpr int NB = NI < 2 ? NI : 2;  // operand terms the P / dS products read
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (N + 15) >> 4;    // k16 steps (and slabs) over the tokens
  const int ntn = 2 * steps;          // n8 tiles over the tokens
  const int dsteps = pad16(hd) >> 4;  // k16 steps over the head dim
  const int ntd = 2 * dsteps;         // n8 tiles over the head dim
  float* my_colsum = colsum ? colsum + warp * 3 * kMaxHd : nullptr;
  const bool active = warp < steps;
  const int i0 = warp * 16;  // this warp's rows (row phase) and columns (column phase)
  float s[8][4], dp[8][4], acc[8][4];

  if (active) {
    // S, the row softmax and (K4) O = P v, then dP = dO v^T: one product's
    // fragments live at a time.
    attention_fwd<NI, kWithO>(q, k, v, N, hd, scale, bias, zrow, s,
                              [&](int m, int c, float x0, float x1, bool two) {
                                out(3, m, c, x0, x1, two);
                              });
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
    for (int kk = 0; kk < dsteps; ++kk) {
      uint32_t ad[NI][4];
#pragma unroll
      for (int x = 0; x < NI; ++x)
        a_rows(ad[x], dO.p + x * dO.term, dO.ld, N, zrow, i0, kk * 16);
#pragma unroll
      for (int np = 0; np < kMaxN / 16; ++np) {
        if (np < steps) {
          uint32_t bv[NI][4];
#pragma unroll
          for (int x = 0; x < NI; ++x)
            b_rows(bv[x], v.p + x * v.term, v.ld, N, zrow, np * 16, kk * 16);
          mma_pair<NI, NI, NI>(dp[2 * np], dp[2 * np + 1], ad, bv);
        }
      }
    }
    // D = rowsum(dP o P).
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e >> 1] = fmaf(s[nt][e], dp[nt][e], d[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
    }
    // dS (in dp) and its dbias share.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
        const float ds = s[nt][e] * (dp[nt][e] - d[e >> 1]);
        dp[nt][e] = ds;
        if (i < N && j < N) add_ds(nt, e, i, j, ds);
      }
    to_exchange(s, xch, i0, N, ntn);
    // dQ = scale dS k from the accumulators.
    tokens_product<NB>(acc, steps, dsteps, N, k, zrow,
                       [&](int kk, uint32_t (&a)[2][4]) { a_from_acc(dp, kk, a); });
    emit(acc, i0, N, hd, ntd, scale, my_colsum,
         [&](int m, int c, float x0, float x1, bool two) { out(0, m, c, x0, x1, two); });
  }
  __syncthreads();  // P in the exchange

  // Column products: this warp's 16 columns j of P, then of dS, summed
  // over every row i: dV = P^T dO, dK = scale dS^T q.
  if (active) {
    tokens_product<NB>(acc, steps, dsteps, N, dO, zrow, [&](int kk, uint32_t (&a)[2][4]) {
      a_cols(a[0], xch, kXLd, N, zrow, i0, kk * 16);
      a_cols(a[1], xch + N * kXLd, kXLd, N, zrow, i0, kk * 16);
    });
    emit(acc, i0, N, hd, ntd, 1.f, my_colsum ? my_colsum + 2 * kMaxHd : nullptr,
         [&](int m, int c, float x0, float x1, bool two) { out(2, m, c, x0, x1, two); });
  }
  __syncthreads();  // every warp done with P
  if (active) to_exchange(dp, xch, i0, N, ntn);
  __syncthreads();  // dS in the exchange
  if (active) {
    tokens_product<NB>(acc, steps, dsteps, N, q, zrow, [&](int kk, uint32_t (&a)[2][4]) {
      a_cols(a[0], xch, kXLd, N, zrow, i0, kk * 16);
      a_cols(a[1], xch + N * kXLd, kXLd, N, zrow, i0, kk * 16);
    });
    emit(acc, i0, N, hd, ntd, scale, my_colsum ? my_colsum + kMaxHd : nullptr,
         [&](int m, int c, float x0, float x1, bool two) { out(1, m, c, x0, x1, two); });
  }
  __syncthreads();  // the exchange and the operands are free again
}

}  // namespace wcore
}  // namespace
