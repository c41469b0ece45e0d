// K4: the fused HRFormer attention half-block, forward and backward, for
// Hopper.
//
// Replaces the TPU kernels `fused_attn_half` (forward body
// `_attn_half_fwd_kernel`, call fused_block.py:562) and its custom-VJP
// backward `_attn_half_bwd` (body `_attn_half_bwd_kernel`, call :608) in
// infantposeestimation_gaussianbias_tpu/ops/pallas/fused_block.py.
//
// Contract (kernels/fused_block.py), on nW windows of N tokens, width C,
// H heads of hd = C / H, from an (Himg, Wimg) map cut in ws x ws windows:
//   qkv = valid ? bf16(LN(x)) Wqkv^T + bqkv : bqkv       (per token)
//   o   = softmax((scale q) k^T + rpe[h]) v              (per head, float32)
//   y   = x + dp[w / nwin] * (bf16(o) Wproj^T + bproj)
//   x, y, dy, dx (nW, N, C) in T (float or bf16); Wqkv (3C, C) and Wproj
//   (C, C) in T, the nn.Linear (out, in) layout; gamma, beta, bqkv, bproj,
//   rpe (H, N, N), dp float32.  valid: the token's pixel lies inside the
//   map.  The backward is the TPU kernel's: P recomputed; dv = P^T do,
//   dS = P (dP - rowsum(dP P)), dq = scale dS k, dk = scale dS^T q (q
//   unscaled), drpe = sum of dS over windows, dbqkv = sum of dqkv over
//   every token, dWqkv = lnb^T bf16(dqkv valid), dln = bf16(dqkv valid)
//   Wqkv, dWproj = bf16(o)^T bf16(dpo), do = bf16(dpo) Wproj with
//   dpo = dp * dy, then the LayerNorm backward.
//
// What bounds it: qkv and proj are 8 * N * C^2 FLOPs per window and the
// attention core 4 * H * N^2 * hd more, against 2 * N * C * sizeof(T) bytes
// of rows: ~4C FLOP per byte in bf16, above the H100's ridge for bf16
// tensor cores (~295) at every hrformer_base width but C = 78.  Every
// product runs on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32):
// the qkv, proj and gradient products, and the attention core of both
// directions (wmsa_core.cuh).
//
// Forward.  A first version ran it in one block per window that walked
// the H heads in turn, its qkv and proj products on fused_common.cuh's
// unstaged `mma_tile` and its attention core in float32 FMAs on the CUDA
// cores: 1.10 ms at hrformer_base b0 (bf16, b = 64), and at b3 64-128
// blocks of 16 heads each for 132 SMs (an NVIDIA H100, PERF.md).  Now
// three stages, each parallel over what it needs:
//   (a) one block per window: the LayerNorm into bf16 ln rows of width Cp
//       (C rounded up to 8, zero-padded; K5's LayerNorm stage);
//   (b) one block of 4 warps per (chunk of windows, head), the chunks as
//       the backward's stage (b) sizes them: per window, q, k and v of the
//       head as one staged tile product (mlp_gemm.cuh) of the window's ln
//       rows with the head's 3 hd rows of Wqkv, plus the bias (only the
//       bias for a pad token), stored as two bf16 terms; then the forward
//       core (wmsa_core.cuh `attention_fwd`: S, the softmax and O = P v on
//       the tensor cores, P in registers) writes bf16(o) to the head's
//       columns of ob (M, Cp);
//   (c) y = x + dp * (ob Wproj^T + bproj) over (row tile x column tile):
//       K5's fc2 stage (fused_common.cuh `mlp_fc2_kernel`).
// The weights go to the products as bf16 rows of width Cp once per call
// (attn_weights_kernel): Wqkv's rows head-major, so that a head's q, k
// and v rows are one operand, and a float32 weight as its three bf16 terms.
//
// Backward.  A first version ran it in one block per window that walked
// the H heads in turn with the float32 attention core on the CUDA cores:
// that kernel was 2.24 of 2.52 ms of device time at hrformer_base b0 (bf16,
// b = 32) and at b3 gave 64 blocks for 132 SMs, each 16 heads long (an
// NVIDIA H100, PERF.md).  Now four stages, each parallel over what it
// needs:
//   (a) one block per window: the LayerNorm recompute (bf16 ln rows, each
//       row's mean and rstd), dpob = bf16(dp * dy) and the dbproj partial;
//   (b) one block of 4 warps per (chunk of windows, head), as K2's grid:
//       per window, q, k, v and do_h by tensor-core products from the ln
//       and dpob rows, split into two bf16 terms in shared memory; then the
//       shared core (csrc/wmsa_core.cuh) on the tensor cores, which
//       writes bf16(o) and bf16(dqkv valid) and keeps dS's drpe share and
//       the dbqkv column sums on chip for the whole chunk: one partial row
//       per chunk instead of a (6C + H N^2) vector per window;
//   (c) dln = bf16(dqkv valid) Wqkv as 64 x 64 output tiles over all rows,
//       then one block per window for the LayerNorm backward (dx, dgamma
//       and dbeta partials);
//   (d) dWqkv = bf16(dqkv valid)^T lnb and dWproj = dpob^T ob by a tile
//       product over the rows, in a bounded number of row chunks added in
//       a fixed order; the per-window and per-chunk partial rows summed in
//       a fixed order.  No atomics: deterministic.
// Float32 weights are split into their three bf16 terms once per call
// (split_weights_kernel), not by every warp that reads them; stage (b)
// runs the q, k and v products in one loop over C (three independent
// accumulator chains on one A operand).


#include <math_constants.h>

#include "fused_common.cuh"
#include "wmsa_core.cuh"

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxHd = 64;

struct Geometry {
  int N, C, H, hd, Himg, Wimg, ws, nwin, nww;
};

__host__ Geometry make_geometry(int N, int C, int H, int Himg, int Wimg, int ws) {
  Geometry g;
  g.N = N; g.C = C; g.H = H; g.hd = C / H; g.Himg = Himg; g.Wimg = Wimg; g.ws = ws;
  g.nww = (Wimg + ws - 1) / ws;
  g.nwin = g.nww * ((Himg + ws - 1) / ws);
  return g;
}

// Per window: 1 if token t's pixel lies inside the map, else 0.
__device__ void valid_tokens(const Geometry& g, int w, float* valid) {
  const int wl = w % g.nwin;
  const int wr = wl / g.nww, wc = wl % g.nww;
  for (int t = threadIdx.x; t < g.N; t += kThreads) {
    const int row = wr * g.ws + t / g.ws;
    const int col = wc * g.ws + t % g.ws;
    valid[t] = (row < g.Himg && col < g.Wimg) ? 1.f : 0.f;
  }
}

// The weights as the forward's products read them, bf16 rows of width Cp
// (columns C .. Cp zero), NT = Terms<T>::n terms: out = [Wqkv's 3C rows,
// head-major (row h 3hd + part hd + d holds Wqkv row part C + h hd + d),
// term t at t * 3C * Cp | Wproj's C rows, term t at 3 NT C Cp + t C Cp].
// wqkv (3C, C) and wproj (C, C) in the (out, in) layout.  One thread per
// element, along the rows: both sides coalesce.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_weights_kernel(const T* __restrict__ wqkv, const T* __restrict__ wproj, int C, int Cp,
                    int hd, bf16* __restrict__ out) {
  constexpr int NT = Terms<T>::n;
  const int r = blockIdx.y, c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= Cp) return;
  const bool qkv = r < 3 * C;
  const int rr = qkv ? r : r - 3 * C;
  const int h = rr / (3 * hd), j = rr - h * 3 * hd, part = j / hd;
  const T* src = qkv ? wqkv + (size_t)(part * C + h * hd + j - part * hd) * C : wproj + (size_t)rr * C;
  const size_t rows = qkv ? 3 * C : C;
  bf16* dst = (qkv ? out : out + (size_t)NT * 3 * C * Cp) + (size_t)rr * Cp + c;
  float x = c < C ? to_f32(src[c]) : 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const bf16 b = __float2bfloat16(x);
    dst[t * rows * Cp] = b;
    x -= bf(b);
  }
}

// Stage (b)'s qkv product: the window's N <= 64 ln rows x the head's 3 hd
// <= BN rows of Wqkv, 4 warps as 2 x 2 (the core's 4 warps), k slices of
// 64 (bf16) or 32 (float32 weights: three terms a slice) in a ring of 2.
template <int BN, int NB>
using QkvTile = mg::Cfg<64, BN, NB == 1 ? 64 : 32, 2, 2, 2>;
static_assert(QkvTile<128, 1>::threads == wcore::kThreads, "the core's warps run the product");

// f(integral_constant<BN>) for the least qkv tile width that holds 3 hd.
template <class F>
cudaError_t with_qkv_width(int hd, F f) {
  if (3 * hd <= 128) return f(std::integral_constant<int, 128>{});
  if (3 * hd <= 192) return f(std::integral_constant<int, 192>{});
  return cudaErrorInvalidValue;
}

// Blocks of stage (b) an SM may hold by shared memory (fwd_core_smem): 4
// for the bf16 128-wide tile, 3 for the others but float32's 192-wide
// one (2); the registers are capped to let as many run.
template <int BN, int NB>
constexpr int fwd_core_blocks() {
  return BN == 128 && NB == 1 ? 4 : 3;
}

// Stage (b)'s shared memory: the product's ring, which q, k and v (two
// bf16 terms each, (N, operand_ld)) reuse once it is done | zero row |
// per column j of the product's tile, where its q, k or v element goes
// in that operand area (or -1) and its bias.
template <int BN, int NB>
__host__ __device__ size_t fwd_core_operands_bytes(const Geometry& g) {
  const size_t ring = mg::ring_bytes<QkvTile<BN, NB>, RowOp<1>, RowOp<NB>>();
  const size_t opnd = sizeof(bf16) * 3 * 2 * (size_t)g.N * wcore::operand_ld(g.hd);
  return ring > opnd ? ring : opnd;
}

template <int BN, int NB>
size_t fwd_core_smem(const Geometry& g) {
  return fwd_core_operands_bytes<BN, NB>(g) + sizeof(bf16) * wcore::kZeroRow +
         (sizeof(short) + sizeof(float)) * BN;
}

// Stage (b), block (chunk, h) over the windows [chunk*wpb, (chunk+1)*wpb):
// per window, q, k, v = lnb Wqkv_h^T + bqkv (the bias row for a pad token)
// as two bf16 terms each, then the forward core writes bf16(o) to this
// head's columns of ob_g (row stride Cp); the blocks of the last head also
// zero ob's columns C .. Cp.  wqkv: the head-major rows of
// attn_weights_kernel, term stride wterm.
template <int BN, int NB>
__global__ void __launch_bounds__(wcore::kThreads, (fwd_core_blocks<BN, NB>()))
attn_fwd_core_kernel(const bf16* __restrict__ lnb_g, const bf16* __restrict__ wqkv,
                     long long wterm, const float* __restrict__ bqkv,
                     const float* __restrict__ rpe, bf16* __restrict__ ob_g, Geometry g, int Cp,
                     float scale, int nW, int wpb) {
  using CF = QkvTile<BN, NB>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = g.N, C = g.C, hd = g.hd, H = g.H, hd3 = 3 * hd;
  const int ld = wcore::operand_ld(hd), term = N * ld, pd = wcore::pad16(hd);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* opnd = ring;  // q, k, v once the product is done with the ring
  bf16* zrow = reinterpret_cast<bf16*>(smem + fwd_core_operands_bytes<BN, NB>(g));
  float* col_bias = reinterpret_cast<float*>(zrow + wcore::kZeroRow);  // (BN)
  short* col_at = reinterpret_cast<short*>(col_bias + BN);              // (BN)
  const int chunk = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const float* rpe_h = rpe + (size_t)h * N * N;
  const bf16* w_h = wqkv + (size_t)h * hd3 * Cp;
  for (int i = tid; i < wcore::kZeroRow; i += wcore::kThreads) zrow[i] = __float2bfloat16(0.f);
  for (int j = tid; j < BN; j += wcore::kThreads) {
    const int part = j / hd, d = j - part * hd;
    col_at[j] = j < hd3 ? part * 2 * term + d : -1;
    col_bias[j] = j < hd3 ? bqkv[part * C + h * hd + d] : 0.f;
  }
  // This thread's accumulator rows (tokens) as (row, column) in a window.
  int tok_r[CF::MT][2], tok_c[CF::MT][2];
#pragma unroll
  for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mg::acc_row<CF>(mi, 2 * hh);
      tok_r[mi][hh] = r / g.ws;
      tok_c[mi][hh] = r - tok_r[mi][hh] * g.ws;
    }

  const int w_end = min(nW, (chunk + 1) * wpb);
  for (int w = chunk * wpb; w < w_end; ++w) {
    const size_t row0 = (size_t)w * N;
    mg::Acc<CF> acc;
    mg::tile_product<CF>(acc, RowOp<1>{lnb_g + row0 * Cp, Cp, 0, N, Cp},
                         RowOp<NB>{w_h, Cp, wterm, hd3, Cp}, Cp, 0, 0, ring);
    // The head dim's padding columns [hd, pd) of q's and k's terms: zero
    // (S sums over them; O's columns past hd, which v's feed, are not
    // stored).
    for (int i = tid; i < 4 * N; i += wcore::kThreads) {
      bf16* row = opnd + (i / N) * term + (i % N) * ld;
      int c = hd;
      for (; c < pd && c % 8; ++c) row[c] = __float2bfloat16(0.f);
      for (; c < pd; c += 8) *reinterpret_cast<uint4*>(row + c) = make_uint4(0, 0, 0, 0);
    }
    // q, k, v = the product + bias (the bias alone for a pad token), as
    // two bf16 terms each.
    const int wl = w % g.nwin, wr = wl / g.nww;
    const int y0 = wr * g.ws, x0 = (wl - wr * g.nww) * g.ws;
#pragma unroll
    for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = mg::acc_row<CF>(mi, 2 * hh);
        if (r >= N) continue;
        const bool in = y0 + tok_r[mi][hh] < g.Himg && x0 + tok_c[mi][hh] < g.Wimg;
#pragma unroll
        for (int ni = 0; ni < CF::NT8; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = mg::acc_col<CF>(ni, e), at = col_at[j];
            if (at >= 0) {
              const float x = in ? acc.v[mi][ni][2 * hh + e] + col_bias[j] : col_bias[j];
              const bf16 t0 = __float2bfloat16(x);
              opnd[at + r * ld] = t0;
              opnd[at + term + r * ld] = __float2bfloat16(x - bf(t0));
            }
          }
      }
    __syncthreads();
    if (threadIdx.x >> 5 < (N + 15) >> 4) {
      auto operand = [&](int part) { return wcore::Operand{opnd + part * 2 * term, ld, term}; };
      bf16* ob_w = ob_g + row0 * Cp + h * hd;
      float s[8][4];
      wcore::attention_fwd<2, true>(
          operand(0), operand(1), operand(2), N, hd, scale,
          [&](int i, int j) { return __ldg(rpe_h + i * N + j); }, zrow, s,
          [&](int i, int d, float x0, float x1, bool two) {
            wcore::store_pair(ob_w + (size_t)i * Cp + d, x0, x1, two);
          });
    }
    if (h == H - 1)
      for (int i = tid; i < N * (Cp - C); i += wcore::kThreads)
        ob_g[(row0 + i / (Cp - C)) * Cp + C + i % (Cp - C)] = __float2bfloat16(0.f);
    __syncthreads();  // the operands read before the next window's product
  }
}

// The backward, stage (a), one block per window: the LayerNorm recompute
// (bf16 ln rows, each row's mean and rstd), dpob = bf16(dp * dy) and this
// window's dbproj partial.  rows_part: per window [dgamma C | dbeta C |
// dbproj C]; stage (c) fills the first two.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ dp,
                   const T* __restrict__ dy, bf16* __restrict__ lnb_g,
                   bf16* __restrict__ dpob_g, float* __restrict__ mean_g,
                   float* __restrict__ rstd_g, float* __restrict__ rows_part, Geometry g) {
  const int N = g.N, C = g.C, w = blockIdx.x;
  const size_t base = (size_t)w * N * C;
  const float scale_w = dp[w / g.nwin];
  layernorm_rows(x + base, N, C, gamma, beta, lnb_g + base, nullptr, mean_g + (size_t)w * N,
                 rstd_g + (size_t)w * N);
  float* pv = rows_part + (size_t)w * 3 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sum = 0.f;
    for (int m = 0; m < N; ++m) {
      const float d = scale_w * to_f32(dy[base + (size_t)m * C + c]);
      dpob_g[base + (size_t)m * C + c] = __float2bfloat16(d);
      sum += d;
    }
    pv[2 * C + c] = sum;
  }
}

// P products sharing A, 16 rows (m0 ...) x ntiles n8 tiles each, over
// depth K on one warp: acc[p] = A B_p; pa(m, k) the bf16 pair A(m, k),
// A(m, k + 1); pb(p, n, k, o) the NW terms of B_p(k, n), B_p(k + 1, n).
// The P products' accumulator chains are independent, so their mma and
// loads overlap.
template <int NW, int P, class PA, class PB>
__device__ __forceinline__ void slab_product(float (&acc)[P][8][4], int m0, int ntiles, int K,
                                             PA pa, PB pb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int ka = k0 + 2 * t;
    const uint32_t a[4] = {pa(m0 + g, ka), pa(m0 + g + 8, ka), pa(m0 + g, ka + 8),
                           pa(m0 + g + 8, ka + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < ntiles) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          uint32_t b0[NW], b1[NW];
          pb(p, nt * 8 + g, ka, b0);
          pb(p, nt * 8 + g, ka + 8, b1);
#pragma unroll
          for (int i = 0; i < NW; ++i) wcore::mma(acc[p][nt], a, b0[i], b1[i]);
        }
      }
    }
  }
}

// A weight as the backward's products read it: NW bf16 term arrays, term
// t of element e at p[t * stride + e].  A bf16 weight is its own single
// term; a float32 one is split once per call by split_weights_kernel (the
// split of fused_common.cuh, exact in sum), not again by every warp that
// reads it.
struct WTerms {
  const bf16* p;
  size_t stride;
};

template <int NW>
__device__ __forceinline__ void tpair_row(const WTerms& w, int row, int ld, int k, int K,
                                          uint32_t (&o)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) o[i] = pair_row(w.p + i * w.stride, row, ld, k, K);
}

// Stage (b)'s shared memory: the core's exchange | zero row | q, k, v, dO
// as two bf16 terms each (N, operand_ld) | column sums [warps][3][kMaxHd] |
// valid (kMaxN) | drpe (N, N).
__host__ __device__ size_t core_operands_offset(const Geometry& g) {
  return wcore::exchange_bytes(g.N) + sizeof(bf16) * wcore::kZeroRow;
}

size_t core_smem(const Geometry& g) {
  return core_operands_offset(g) + sizeof(bf16) * 4 * 2 * (size_t)g.N * wcore::operand_ld(g.hd) +
         sizeof(float) * (wcore::kWarps * 3 * wcore::kMaxHd + wcore::kMaxN + (size_t)g.N * g.N);
}

// Stage (b), block (chunk, h) over the windows [chunk*wpb, (chunk+1)*wpb):
// per window, q, k, v = lnb Wqkv_h^T + bqkv (the bias row for a pad token)
// and do_h = dpob Wproj[:, head h] on the tensor cores, one warp per 16
// rows, stored as two bf16 terms each; then the core (csrc/wmsa_core.cuh)
// writes bf16(o) and bf16(dqkv valid) to this head's columns of ob_g and
// dqkvv_g and adds dS to the chunk's drpe.  Last, the chunk's partial
// row, chunk_part[chunk] = [dbqkv 3C | drpe H*N*N], gets this head's
// columns of dbqkv (the float32 dqkv summed over every token) and its drpe
// tile.
template <typename T>
__global__ void __launch_bounds__(wcore::kThreads)
attn_bwd_core_kernel(WTerms wqkv, const float* __restrict__ bqkv,
                     const float* __restrict__ rpe, WTerms wproj_io,
                     const bf16* __restrict__ lnb_g, const bf16* __restrict__ dpob_g,
                     bf16* __restrict__ ob_g, bf16* __restrict__ dqkvv_g,
                     float* __restrict__ chunk_part, Geometry g, float scale, int nW,
                     int wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NW = Terms<T>::n;
  constexpr int kWarps = wcore::kWarps, kMaxHd = wcore::kMaxHd;
  const int N = g.N, C = g.C, hd = g.hd, H = g.H;
  const int ld = wcore::operand_ld(hd);
  const int term = N * ld;
  bf16* xch = reinterpret_cast<bf16*>(smem);
  bf16* zrow = reinterpret_cast<bf16*>(smem + wcore::exchange_bytes(N));
  bf16* opnd = reinterpret_cast<bf16*>(smem + core_operands_offset(g));  // q, k, v, dO
  float* colsum = reinterpret_cast<float*>(opnd + 4 * 2 * term);         // [warps][3][kMaxHd]
  float* valid = colsum + kWarps * 3 * kMaxHd;                           // (kMaxN)
  float* drpe = valid + wcore::kMaxN;                                    // (N, N)
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int ntd = (hd + 7) >> 3;
  const float* rpe_h = rpe + (size_t)h * N * N;

  // Zeros: the zero row, the operands' padding columns, the column sums.
  for (int i = tid; i < wcore::kZeroRow + 4 * 2 * term; i += wcore::kThreads)
    zrow[i] = __float2bfloat16(0.f);
  for (int i = tid; i < kWarps * 3 * kMaxHd; i += wcore::kThreads) colsum[i] = 0.f;
  for (int i = tid; i < N * N; i += wcore::kThreads) drpe[i] = 0.f;

  const int w_end = min(nW, (chunk + 1) * wpb);
  for (int w = chunk * wpb; w < w_end; ++w) {
    const size_t base = (size_t)w * N * C;
    const bf16* lnb_w = lnb_g + base;
    const bf16* dpob_w = dpob_g + base;
    valid_tokens(g, w, valid);
    __syncthreads();
    const int m0 = warp * 16;
    if (m0 < N) {
      // One operand tile as two bf16 terms, a column pair (d, d + 1) per
      // store; columns >= hd stay zero.  q, k and v get the qkv bias, or
      // only it for a pad token.
      auto store = [&](int part, const float (&acc)[8][4]) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(opnd + part * 2 * term);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int d = nt * 8 + 2 * t;
          if (nt < ntd && d < hd) {
            const bool two = d + 1 < hd;
            float b0 = 0.f, b1 = 0.f;
            if (part < 3) {
              b0 = bqkv[part * C + h * hd + d];
              b1 = two ? bqkv[part * C + h * hd + d + 1] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int m = m0 + gq + 8 * r;
              if (m < N) {
                float x0 = acc[nt][2 * r], x1 = two ? acc[nt][2 * r + 1] : 0.f;
                if (part < 3) {
                  const bool in = valid[m] != 0.f;
                  x0 = in ? x0 + b0 : b0;
                  x1 = in ? x1 + b1 : b1;
                }
                uint32_t u[2];
                wcore::split<2>(x0, x1, u);
                dst[(m * ld + d) / 2] = u[0];
                dst[(term + m * ld + d) / 2] = u[1];
              }
            }
          }
        }
      };
      {
        float acc[3][8][4];  // q, k, v from lnb
        slab_product<NW, 3>(
            acc, m0, ntd, C,
            [&](int m, int kk) { return pair_row(lnb_w, m < N ? m : -1, C, kk, C); },
            [&](int part, int n, int kk, uint32_t (&o)[NW]) {
              tpair_row<NW>(wqkv, n < hd ? part * C + h * hd + n : -1, C, kk, C, o);
            });
#pragma unroll
        for (int part = 0; part < 3; ++part) store(part, acc[part]);
      }
      float acc[1][8][4];  // do_h from dpob
      slab_product<NW, 1>(
          acc, m0, ntd, C,
          [&](int m, int kk) { return pair_row(dpob_w, m < N ? m : -1, C, kk, C); },
          [&](int, int n, int kk, uint32_t (&o)[NW]) {
            tpair_row<NW>(wproj_io, n < hd ? h * hd + n : -1, C, kk, C, o);
          });
      store(3, acc[0]);
    }
    __syncthreads();
    auto operand = [&](int part) { return wcore::Operand{opnd + part * 2 * term, ld, term}; };
    bf16* ob_w = ob_g + base + h * hd;
    bf16* dq_w = dqkvv_g + (size_t)w * N * 3 * C + h * hd;
    wcore::attention_bwd<2, true>(
        operand(0), operand(1), operand(2), operand(3), N, hd, scale,
        [&](int i, int j) { return __ldg(rpe_h + i * N + j); },
        [&](int, int, int i, int j, float x) { drpe[i * N + j] += x; }, xch, zrow, colsum,
        [&](int kind, int i, int d, float x0, float x1, bool two) {
          if (kind == 3)
            wcore::store_pair(ob_w + (size_t)i * C + d, x0, x1, two);
          else
            wcore::store_pair(dq_w + (size_t)i * 3 * C + kind * C + d, valid[i] * x0,
                              valid[i] * x1, two);
        });
  }

  float* row = chunk_part + (size_t)chunk * (3 * C + H * N * N);
  for (int idx = tid; idx < 3 * hd; idx += wcore::kThreads) {
    const int part = idx / hd, d = idx - part * hd;
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += colsum[(i * 3 + part) * kMaxHd + d];
    row[part * C + h * hd + d] = s;
  }
  for (int idx = tid; idx < N * N; idx += wcore::kThreads)
    row[3 * C + (size_t)h * N * N + idx] = drpe[idx];
}

// Stage (c1): dln = bf16(dqkv valid) Wqkv on the tensor cores, one 64-row
// x 64-column tile of the (M, C) output per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dln_kernel(WTerms wqkv_io, const bf16* __restrict__ dqkvv_g,
                    float* __restrict__ dln_g, int M, int C) {
  constexpr int NW = Terms<T>::n;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * kBN;
  const int rows = min(64, M - m0);
  const bf16* a = dqkvv_g + (size_t)m0 * 3 * C;
  float acc[4][kTN];
  mma_tile<64, NW>(
      acc, 3 * C, [&](int m, int kk) { return pair_row(a, m < rows ? m : -1, 3 * C, kk, 3 * C); },
      [&](int n, int kk, uint32_t (&o)[NW]) {
        tpair_row<NW>(wqkv_io, n0 + n < C ? n0 + n : -1, 3 * C, kk, 3 * C, o);
      });
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = tile_row<64>(i);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tile_col(j);
      if (m < rows && n < C) dln_g[(size_t)(m0 + m) * C + n] = acc[i][j];
    }
  }
}

// Stage (c2), one block per window: the LayerNorm backward, dx, and this
// window's dgamma and dbeta partials into rows_part.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_lnb_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ gamma, const float* __restrict__ dln_g,
                    const float* __restrict__ mean_g, const float* __restrict__ rstd_g,
                    T* __restrict__ dx, float* __restrict__ rows_part, Geometry g) {
  const int N = g.N, C = g.C, w = blockIdx.x;
  const size_t base = (size_t)w * N * C;
  float* pv = rows_part + (size_t)w * 3 * C;
  layernorm_bwd_rows(x + base, dy + base, dln_g + base, mean_g + (size_t)w * N,
                     rstd_g + (size_t)w * N, gamma, N, C, dx + base, pv, pv + C);
}

// The forward: (1) the weights' rows, (a) LayerNorm, (b) attention per
// (chunk, head), (c) proj + residual.  Scratch on the card: lnb, ob (M, Cp)
// bf16, wterms NT * 4C * Cp bf16.  tile: the plan's tile id of stage (c).
template <typename T>
cudaError_t fwd(const T* x, const float* gamma, const float* beta, const T* wqkv,
                const float* bqkv, const float* rpe, const T* wproj, const float* bproj,
                const float* dp, T* y, bf16* lnb, bf16* ob, bf16* wterms, int nW,
                const Geometry& g, int Cp, float scale, int wpb, int tile,
                cudaStream_t stream) {
  constexpr int NB = Terms<T>::n;
  const int M = nW * g.N, C = g.C;
  attn_weights_kernel<T><<<dim3(tiles(Cp, kThreads), 4 * C), kThreads, 0, stream>>>(
      wqkv, wproj, C, Cp, g.hd, wterms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = with_ln_width(Cp, [&](auto nv) {
    mlp_ln_kernel<T, false, decltype(nv)::value><<<nW, kThreads, 0, stream>>>(
        x, gamma, beta, nullptr, nullptr, lnb, nullptr, nullptr, nullptr, nullptr, M, C, Cp, 1,
        g.N);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  err = with_qkv_width(g.hd, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    const size_t smem = fwd_core_smem<BN, NB>(g);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t opt = allow_smem(attn_fwd_core_kernel<BN, NB>, smem);
    if (opt != cudaSuccess) return opt;
    attn_fwd_core_kernel<BN, NB><<<dim3(tiles(nW, wpb), g.H), wcore::kThreads, smem, stream>>>(
        lnb, wterms, (long long)3 * C * Cp, bqkv, rpe, ob, g, Cp, scale, nW, wpb);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const bf16* wproj_terms = wterms + (size_t)NB * 3 * C * Cp;
  return with_tile(tile, [&](auto cf) {
    using CF = decltype(cf);
    return launch_tiles<CF>(mlp_fc2_kernel<CF, NB, T>, fc_smem<CF, NB>(), M, C, stream,
                            (const bf16*)ob, wproj_terms, bproj, x, dp, y, M, C, Cp,
                            g.N * g.nwin);
  });
}

template <typename T>
cudaError_t bwd(const void* x, const float* gamma, const float* beta, const void* wqkv,
                const void* wqkv_io, const float* bqkv, const float* rpe,
                const void* wproj_io, const float* dp, const void* dy, void* dx, float* vec,
                float* dwqkv, float* dwproj, bf16* lnb, bf16* ob, bf16* dpob, bf16* dqkvv,
                float* dln, float* stats, float* rows_part, float* chunk_part,
                float* atb_part, bf16* wterms, int nW, const Geometry& g, float scale,
                int wpb, int s1, int s2, cudaStream_t stream) {
  const size_t smem = core_smem(g);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_bwd_core_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int M = nW * g.N, C = g.C;
  // The weights as bf16 terms: Wqkv (3C, C), Wproj (in, out) and Wqkv
  // (in, out), split into wterms when float32.
  const void* src[3] = {wqkv, wproj_io, wqkv_io};
  const size_t sizes[3] = {(size_t)3 * C * C, (size_t)C * C, (size_t)3 * C * C};
  WTerms wt[3];
  for (int i = 0; i < 3; ++i) {
    if (sizeof(T) == 2) {
      wt[i] = WTerms{static_cast<const bf16*>(src[i]), 0};
    } else {
      // each weight is contiguous: sizes[i] / C rows of C
      err = launch_split_weights(static_cast<const float*>(src[i]), C, 1, (int)(sizes[i] / C),
                                 C, C, wterms, stream);
      if (err != cudaSuccess) return err;
      wt[i] = WTerms{wterms, sizes[i]};
      wterms += 3 * sizes[i];
    }
  }
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  float* mean = stats;
  float* rstd = stats + M;
  attn_bwd_ln_kernel<T><<<nW, kThreads, 0, stream>>>(xt, gamma, beta, dp, dyt, lnb, dpob,
                                                     mean, rstd, rows_part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = (nW + wpb - 1) / wpb;
  attn_bwd_core_kernel<T><<<dim3(chunks, g.H), wcore::kThreads, smem, stream>>>(
      wt[0], bqkv, rpe, wt[1], lnb, dpob, ob, dqkvv, chunk_part, g, scale, nW, wpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dln_kernel<T><<<dim3((M + 63) / 64, (C + kBN - 1) / kBN), kThreads, 0, stream>>>(
      wt[2], dqkvv, dln, M, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_lnb_kernel<T><<<nW, kThreads, 0, stream>>>(xt, dyt, gamma, dln, mean, rstd,
                                                      static_cast<T*>(dx), rows_part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dWqkv (3C, C) = dqkvv^T lnb;  dWproj (C, C) = dpob^T ob
  err = launch_atb(dqkvv, 3 * C, lnb, C, dwqkv, atb_part, M, 3 * C, C, s1, stream);
  if (err != cudaSuccess) return err;
  err = launch_atb(dpob, C, ob, C, dwproj, atb_part, M, C, C, s2, stream);
  if (err != cudaSuccess) return err;
  // vec = [dgamma | dbeta | dbproj] over windows, then [dbqkv | drpe] over chunks
  err = launch_colsum(rows_part, vec, nW, 3 * C, stream);
  if (err != cudaSuccess) return err;
  return launch_colsum(chunk_part, vec + 3 * C, chunks, 3 * C + g.H * g.N * g.N, stream);
}

bool bad_shape(int nW, int N, int C, int H, int Himg, int Wimg, int ws) {
  if (nW <= 0 || N <= 0 || N > kMaxN || C <= 0 || H <= 0 || C % H || C / H > kMaxHd ||
      ws <= 0 || ws * ws != N || Himg <= 0 || Wimg <= 0)
    return true;
  const Geometry g = make_geometry(N, C, H, Himg, Wimg, ws);
  return nW % g.nwin != 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, y and the weights).  wqkv (3C, C)
// and wproj (C, C) in the (out, in) layout.  Scratch on the card: lnb, ob
// (nW * N, Cp) bf16 and wterms (3 for float32, else 1) * 4C * Cp bf16, Cp
// = C rounded up to 8.  wpb: windows per block of stage (b); tile: the
// tile id (0-2) of stage (c).  scale is hd^-0.5 rounded to float32 by the
// caller.  Returns the launches' cudaError_t.
int ipe_fused_attn_fwd(const void* x, const void* gamma, const void* beta, const void* wqkv,
                       const void* bqkv, const void* rpe, const void* wproj, const void* bproj,
                       const void* dp, void* y, void* lnb, void* ob, void* wterms, int nW,
                       int N, int C, int H, int Himg, int Wimg, int ws, int Cp, int wpb,
                       int tile, float scale, int dtype, void* stream) {
  if (bad_shape(nW, N, C, H, Himg, Wimg, ws) || C % 2 || Cp < C || Cp % 8 ||
      Cp > kMaxLnWidth || wpb <= 0 || tile < 0 || tile > 2 || tiles(nW * N, TileS::BM) > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(N, C, H, Himg, Wimg, ws);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return fwd<T>(static_cast<const T*>(x), static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), static_cast<const T*>(wqkv),
                  static_cast<const float*>(bqkv), static_cast<const float*>(rpe),
                  static_cast<const T*>(wproj), static_cast<const float*>(bproj),
                  static_cast<const float*>(dp), static_cast<T*>(y), static_cast<bf16*>(lnb),
                  static_cast<bf16*>(ob), static_cast<bf16*>(wterms), nW, g, Cp, scale, wpb,
                  tile, static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

// wqkv (3C, C) as in the forward; wqkv_io (C, 3C) and wproj_io (C, C): the
// weights in the (in, out) layout.  Scratch, all on the card (M = nW * N
// rows, chunks = ceil(nW / wpb)): lnb, ob, dpob (M, C) and dqkvv (M, 3C)
// bf16; dln (M, C), stats (2, M) (each row's LayerNorm mean, rstd),
// rows_part (nW, 3C), chunk_part (chunks, 3C + H*N*N) and atb_part
// max(3 * s1, s2) * C * C float32; wterms (float32 weights only, else
// unused) 3 * 7 * C * C bf16.  Outputs: dx in the dtype; vec =
// [dgamma C | dbeta C | dbproj C | dbqkv 3C | drpe H*N*N], dwqkv (3C, C),
// dwproj (C, C) float32.  wpb: windows per block of the core stage; s1,
// s2: row chunks of the dWqkv and dWproj reductions.
int ipe_fused_attn_bwd(const void* x, const void* gamma, const void* beta, const void* wqkv,
                       const void* wqkv_io, const void* bqkv, const void* rpe,
                       const void* wproj_io, const void* dp, const void* dy, void* dx,
                       void* vec, void* dwqkv, void* dwproj, void* lnb, void* ob, void* dpob,
                       void* dqkvv, void* dln, void* stats, void* rows_part, void* chunk_part,
                       void* atb_part, void* wterms, int nW, int N, int C, int H, int Himg,
                       int Wimg, int ws,
                       float scale, int wpb, int s1, int s2, int dtype, void* stream) {
  if (bad_shape(nW, N, C, H, Himg, Wimg, ws) || wpb <= 0 || s1 <= 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(N, C, H, Himg, Wimg, ws);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return bwd<T>(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), wqkv,
                  wqkv_io, static_cast<const float*>(bqkv), static_cast<const float*>(rpe),
                  wproj_io, static_cast<const float*>(dp), dy, dx, static_cast<float*>(vec),
                  static_cast<float*>(dwqkv), static_cast<float*>(dwproj),
                  static_cast<bf16*>(lnb), static_cast<bf16*>(ob), static_cast<bf16*>(dpob),
                  static_cast<bf16*>(dqkvv), static_cast<float*>(dln),
                  static_cast<float*>(stats), static_cast<float*>(rows_part),
                  static_cast<float*>(chunk_part), static_cast<float*>(atb_part),
                  static_cast<bf16*>(wterms), nW, g, scale, wpb, s1, s2,
                  static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
