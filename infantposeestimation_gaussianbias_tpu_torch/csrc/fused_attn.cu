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
// tensor cores (~295) at every hrformer_base width but C = 78.  The qkv,
// proj and gradient products run on the tensor cores (mma.sync m16n8k16,
// bf16 x bf16 -> f32, fused_common.cuh); the attention core stays float32
// FMAs on CUDA cores, as the TPU kernel keeps it float32.  The design moves
// each window's rows once in and once out, and keeps ln, o and one head's
// q, k, v, scores and gradients in shared memory: a whole window's float32
// qkv (49 x 1,872 x 4 B = 367 KB at C = 624) would not fit in a block's
// 227 KB, so the heads are streamed.
//
// Design:
//   * forward: one block per window; LN per row by one warp into a bf16 ln
//     tile; per head, the (N, 3 hd) qkv slice by a tile product, the
//     masked bias rows, scores, softmax by one warp per row and P v into a
//     bf16 o tile; then proj + bias + DropPath residual straight to y.
//   * backward, windows: one block per window recomputes LN, writes the
//     bf16 ln and dpo rows to scratch, and per head recomputes q, k, v and
//     P, computes do_h from dpo, dS, dq, dk, dv, writes bf16(o) and
//     bf16(dqkv valid) to scratch and its sums of dqkv and dS to its
//     partial vector; then dln = bf16(dqkv valid) Wqkv and the LayerNorm
//     backward.
//   * backward, reductions: dWqkv = bf16(dqkv valid)^T lnb and
//     dWproj = dpob^T ob by a tile product over the rows, in a bounded
//     number of row chunks added in a fixed order; the per-window partial
//     vectors (dgamma, dbeta, dbqkv, dbproj, drpe) summed over windows in a
//     fixed order.  No atomics: deterministic.

#include <math_constants.h>

#include "fused_common.cuh"

namespace {

using ipe::odd_stride;

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

// The (N, 3 hd) qkv slice of head h into q, k, v (row stride ldq): the
// tile product of the bf16 ln rows with rows j*C + h*hd + d of Wqkv, plus
// bias; an invalid token gets the bias row.  q is scaled when q_scale != 1.
template <typename T>
__device__ void head_qkv(const Geometry& g, int h, const bf16* ln, const T* __restrict__ wqkv,
                         const float* __restrict__ bqkv, const float* valid, float q_scale,
                         float* q, float* k, float* v, int ldq) {
  constexpr int NW = Terms<T>::n;
  const int N = g.N, C = g.C, hd = g.hd;
  float acc[4][kTN];
  for (int n0 = 0; n0 < 3 * hd; n0 += kBN) {
    mma_tile<64, NW>(
        acc, C, [&](int m, int kk) { return pair_row(ln, m < N ? m : -1, C, kk, C); },
        [&](int n, int kk, uint32_t (&o)[NW]) {
          const int j = n0 + n;
          const int part = j / hd;
          wpair_row(wqkv, j < 3 * hd ? part * C + h * hd + j - part * hd : -1, C, kk, C, o);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tile_row<64>(i);
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) {
        const int j = n0 + tile_col(jj);
        if (m < N && j < 3 * hd) {
          const int part = j / hd, d = j - part * hd;
          const float b = bqkv[part * C + h * hd + d];
          const float val = valid[m] != 0.f ? acc[i][jj] + b : b;
          if (part == 0) q[m * ldq + d] = val * q_scale;
          else if (part == 1) k[m * ldq + d] = val;
          else v[m * ldq + d] = val;
        }
      }
    }
  }
  __syncthreads();
}

// s[i][j] = sum_d q_scale * q[i][d] * k[j][d] + rpe_h[i][j] (and, when dp_out is
// not null, dp_out[i][j] = sum_d dO[i][d] v[j][d]).
__device__ void scores(int N, int hd, const float* q, const float* k, const float* v,
                       const float* dO, int ldq, float q_scale, const float* __restrict__ rpe_h,
                       float* s, float* dp_out, int lds) {
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, j = idx - (idx / N) * N;
    const float* qi = q + i * ldq;
    const float* kj = k + j * ldq;
    float a = 0.f;
    for (int d = 0; d < hd; ++d) a = fmaf(qi[d] * q_scale, kj[d], a);
    s[i * lds + j] = a + rpe_h[idx];
    if (dp_out) {
      const float* gi = dO + i * ldq;
      const float* vj = v + j * ldq;
      float b = 0.f;
      for (int d = 0; d < hd; ++d) b = fmaf(gi[d], vj[d], b);
      dp_out[i * lds + j] = b;
    }
  }
  __syncthreads();
}

// Row softmax in place, one warp per row: p = exp(s - max) / sum.
__device__ void softmax_rows(int N, float* s, int lds) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < N; i += kThreads / 32) {
    float* si = s + i * lds;
    float m = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, si[j]);
    m = ipe::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(si[j] - m);
      si[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) si[j] = si[j] / sum;
  }
  __syncthreads();
}

// Bytes of shared memory before the float32 tiles: `tiles` bf16 (N, C)
// tiles, rounded up to 16 bytes.
__host__ __device__ size_t float_offset(const Geometry& g, int tiles) {
  return ((size_t)tiles * g.N * g.C * sizeof(bf16) + 15) / 16 * 16;
}

size_t fwd_smem(const Geometry& g) {
  const int ldq = odd_stride(g.hd), lds = odd_stride(g.N);
  return float_offset(g, 2) + sizeof(float) * ((size_t)3 * g.N * ldq + (size_t)g.N * lds + g.N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ wqkv,
                const float* __restrict__ bqkv, const float* __restrict__ rpe,
                const T* __restrict__ wproj, const float* __restrict__ bproj,
                const float* __restrict__ dp, T* __restrict__ y, Geometry g, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = g.N, C = g.C, hd = g.hd;
  const int ldq = odd_stride(hd), lds = odd_stride(N);
  constexpr int NW = Terms<T>::n;
  bf16* ln = reinterpret_cast<bf16*>(smem);                          // (N, C)
  bf16* ob = ln + (size_t)N * C;                                     // (N, C)
  float* q = reinterpret_cast<float*>(smem + float_offset(g, 2));    // (N, ldq) each
  float* k = q + N * ldq;
  float* v = k + N * ldq;
  float* s = v + N * ldq;                                            // (N, lds)
  float* valid = s + N * lds;                                        // (N)
  const int w = blockIdx.x;
  const size_t base = (size_t)w * N * C;

  valid_tokens(g, w, valid);
  layernorm_rows(x + base, N, C, gamma, beta, ln, nullptr, nullptr, nullptr);
  __syncthreads();

  for (int h = 0; h < g.H; ++h) {
    head_qkv(g, h, ln, wqkv, bqkv, valid, scale, q, k, v, ldq);
    scores(N, hd, q, k, v, nullptr, ldq, 1.f, rpe + (size_t)h * N * N, s, nullptr, lds);
    softmax_rows(N, s, lds);
    for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {  // o = P v
      const int i = idx / hd, d = idx - (idx / hd) * hd;
      const float* pi = s + i * lds;
      float a = 0.f;
      for (int j = 0; j < N; ++j) a = fmaf(pi[j], v[j * ldq + d], a);
      ob[i * C + h * hd + d] = __float2bfloat16(a);
    }
    __syncthreads();
  }

  const float scale_w = dp[w / g.nwin];
  float acc[4][kTN];
  for (int n0 = 0; n0 < C; n0 += kBN) {  // y = x + dp * (ob Wproj^T + bproj)
    mma_tile<64, NW>(
        acc, C, [&](int m, int kk) { return pair_row(ob, m < N ? m : -1, C, kk, C); },
        [&](int n, int kk, uint32_t (&o)[NW]) {
          wpair_row(wproj, n0 + n < C ? n0 + n : -1, C, kk, C, o);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tile_row<64>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tile_col(j);
        if (m < N && n < C) {
          const size_t o = base + (size_t)m * C + n;
          y[o] = from_f32<T>(to_f32(x[o]) + scale_w * (acc[i][j] + bproj[n]));
        }
      }
    }
  }
}

size_t bwd_smem(const Geometry& g) {
  const int ldq = odd_stride(g.hd), lds = odd_stride(g.N);
  // ln (N, C) bf16; q, k, v, dO, dq, dk, dv; P, dS; mean, rstd, valid
  return float_offset(g, 1) +
         sizeof(float) * ((size_t)7 * g.N * ldq + (size_t)2 * g.N * lds + 3 * g.N);
}

// The window stage of the backward.  wqkv (3C, C) is the weight the
// forward reads; wqkv_io (C, 3C) and wproj_io (C, C) are the weights in the
// (in, out) layout, whose rows are the columns the backward's products
// need.  part: this window's partial vector,
// [dgamma C | dbeta C | dbqkv 3C | dbproj C | drpe H*N*N].  Scratch rows
// (window w at rows w*N ...): lnb_g, ob_g, dpob_g (nW*N, C) and dqkvv_g
// (nW*N, 3C) bf16, dln_g (nW*N, C) float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_window_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const T* __restrict__ wqkv,
                       const T* __restrict__ wqkv_io, const float* __restrict__ bqkv,
                       const float* __restrict__ rpe, const T* __restrict__ wproj_io,
                       const float* __restrict__ dp,
                       const T* __restrict__ dy, T* dx, bf16* lnb_g, bf16* ob_g, bf16* dpob_g,
                       bf16* dqkvv_g, float* dln_g, float* part, Geometry g, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = g.N, C = g.C, hd = g.hd, H = g.H;
  const int ldq = odd_stride(hd), lds = odd_stride(N);
  constexpr int NW = Terms<T>::n;
  bf16* ln = reinterpret_cast<bf16*>(smem);                          // (N, C)
  float* q = reinterpret_cast<float*>(smem + float_offset(g, 1));    // (N, ldq) each
  float* k = q + N * ldq;
  float* v = k + N * ldq;
  float* dO = v + N * ldq;
  float* dq = dO + N * ldq;
  float* dk = dq + N * ldq;
  float* dv = dk + N * ldq;
  float* p = dv + N * ldq;                                           // (N, lds) each
  float* ds = p + N * lds;
  float* mean = ds + N * lds;
  float* rstd = mean + N;
  float* valid = rstd + N;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t base = (size_t)w * N * C;
  float* pv = part + (size_t)w * (6 * C + H * N * N);
  const float scale_w = dp[w / g.nwin];
  const bf16* dpob_w = dpob_g + base;                  // this window's rows
  const bf16* dqkvv_w = dqkvv_g + (size_t)w * N * 3 * C;

  valid_tokens(g, w, valid);
  layernorm_rows(x + base, N, C, gamma, beta, ln, lnb_g + base, mean, rstd);
  for (int c = tid; c < C; c += kThreads) {  // dpo = dp * dy, bf16 rows, dbproj
    float sum = 0.f;
    for (int m = 0; m < N; ++m) {
      const float d = scale_w * to_f32(dy[base + (size_t)m * C + c]);
      dpob_g[base + (size_t)m * C + c] = __float2bfloat16(d);
      sum += d;
    }
    pv[5 * C + c] = sum;
  }
  __syncthreads();

  float acc[4][kTN];
  for (int h = 0; h < H; ++h) {
    head_qkv(g, h, ln, wqkv, bqkv, valid, 1.f, q, k, v, ldq);
    // do_h = dpob Wproj[:, h*hd : (h+1)*hd]
    mma_tile<64, NW>(
        acc, C, [&](int m, int kk) { return pair_row(dpob_w, m < N ? m : -1, C, kk, C); },
        [&](int n, int kk, uint32_t (&o)[NW]) {
          wpair_row(wproj_io, n < hd ? h * hd + n : -1, C, kk, C, o);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tile_row<64>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = tile_col(j);
        if (m < N && n < hd) dO[m * ldq + n] = acc[i][j];
      }
    }
    __syncthreads();
    scores(N, hd, q, k, v, dO, ldq, scale, rpe + (size_t)h * N * N, p, ds, lds);
    // One warp per row: P = softmax(S), r = rowsum(dP P), dS = P (dP - r),
    // which is also this window's share of drpe.
    for (int i = tid >> 5; i < N; i += kThreads / 32) {
      float* pi = p + i * lds;
      float* di = ds + i * lds;
      float m = -CUDART_INF_F;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, pi[j]);
      m = ipe::warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(pi[j] - m);
        pi[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float r = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float pij = pi[j] / sum;
        pi[j] = pij;
        r = fmaf(pij, di[j], r);
      }
      r = warp_sum(r);
      float* drpe = pv + 6 * C + ((size_t)h * N + i) * N;
      for (int j = lane; j < N; j += 32) {
        const float dsij = pi[j] * (di[j] - r);
        di[j] = dsij;
        drpe[j] = dsij;
      }
    }
    __syncthreads();
    // o = P v; dq = scale dS k; dk = scale dS^T q; dv = P^T dO.
    for (int idx = tid; idx < N * hd; idx += kThreads) {
      const int i = idx / hd, d = idx - (idx / hd) * hd;
      float ao = 0.f, aq = 0.f, ak = 0.f, av = 0.f;
      for (int j = 0; j < N; ++j) {
        ao = fmaf(p[i * lds + j], v[j * ldq + d], ao);
        aq = fmaf(ds[i * lds + j], k[j * ldq + d], aq);
        ak = fmaf(ds[j * lds + i], q[j * ldq + d], ak);
        av = fmaf(p[j * lds + i], dO[j * ldq + d], av);
      }
      ob_g[base + (size_t)i * C + h * hd + d] = __float2bfloat16(ao);
      dq[i * ldq + d] = scale * aq;
      dk[i * ldq + d] = scale * ak;
      dv[i * ldq + d] = av;
    }
    __syncthreads();
    // dbqkv over every token; bf16(dqkv valid) rows for dWqkv and dln.
    for (int j = tid; j < 3 * hd; j += kThreads) {
      const int part_ = j / hd, d = j - part_ * hd;
      const float* src = part_ == 0 ? dq : (part_ == 1 ? dk : dv);
      const int col = part_ * C + h * hd + d;
      float sum = 0.f;
      for (int i = 0; i < N; ++i) {
        const float val = src[i * ldq + d];
        sum += val;
        dqkvv_g[((size_t)w * N + i) * 3 * C + col] = __float2bfloat16(valid[i] * val);
      }
      pv[2 * C + col] = sum;
    }
    __syncthreads();
  }

  for (int n0 = 0; n0 < C; n0 += kBN) {  // dln = bf16(dqkv valid) Wqkv
    mma_tile<64, NW>(
        acc, 3 * C,
        [&](int m, int kk) { return pair_row(dqkvv_w, m < N ? m : -1, 3 * C, kk, 3 * C); },
        [&](int n, int kk, uint32_t (&o)[NW]) {
          wpair_row(wqkv_io, n0 + n < C ? n0 + n : -1, 3 * C, kk, 3 * C, o);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tile_row<64>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tile_col(j);
        if (m < N && n < C) dln_g[base + (size_t)m * C + n] = acc[i][j];
      }
    }
  }
  __syncthreads();

  layernorm_bwd_rows(x + base, dy + base, dln_g + base, mean, rstd, gamma, N, C, dx + base, pv,
                     pv + C);
}

template <typename T>
cudaError_t fwd(const void* x, const float* gamma, const float* beta, const void* wqkv,
                const float* bqkv, const float* rpe, const void* wproj, const float* bproj,
                const float* dp, void* y, int nW, const Geometry& g, float scale,
                cudaStream_t stream) {
  const size_t smem = fwd_smem(g);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T><<<nW, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(wqkv), bqkv, rpe,
      static_cast<const T*>(wproj), bproj, dp, static_cast<T*>(y), g, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const float* gamma, const float* beta, const void* wqkv,
                const void* wqkv_io, const float* bqkv, const float* rpe,
                const void* wproj_io, const float* dp, const void* dy, void* dx, float* vec,
                float* dwqkv, float* dwproj, bf16* lnb, bf16* ob, bf16* dpob, bf16* dqkvv,
                float* dln, float* vec_part, float* atb_part, int nW, const Geometry& g,
                float scale, int s1, int s2, cudaStream_t stream) {
  const size_t smem = bwd_smem(g);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_bwd_window_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_window_kernel<T><<<nW, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(wqkv),
      static_cast<const T*>(wqkv_io), bqkv, rpe, static_cast<const T*>(wproj_io), dp,
      static_cast<const T*>(dy), static_cast<T*>(dx), lnb, ob, dpob, dqkvv, dln, vec_part, g,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = nW * g.N, C = g.C;
  // dWqkv (3C, C) = dqkvv^T lnb;  dWproj (C, C) = dpob^T ob
  err = launch_atb(dqkvv, 3 * C, lnb, C, dwqkv, atb_part, M, 3 * C, C, s1, stream);
  if (err != cudaSuccess) return err;
  err = launch_atb(dpob, C, ob, C, dwproj, atb_part, M, C, C, s2, stream);
  if (err != cudaSuccess) return err;
  return launch_colsum(vec_part, vec, nW, 6 * C + g.H * g.N * g.N, stream);
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

// dtype: 0 = float32, 1 = bfloat16 (x, y and the weights).  scale is
// hd^-0.5 rounded to float32 by the caller.  Returns the launch's
// cudaError_t.
int ipe_fused_attn_fwd(const void* x, const void* gamma, const void* beta, const void* wqkv,
                       const void* bqkv, const void* rpe, const void* wproj, const void* bproj,
                       const void* dp, void* y, int nW, int N, int C, int H, int Himg, int Wimg,
                       int ws, float scale, int dtype, void* stream) {
  if (bad_shape(nW, N, C, H, Himg, Wimg, ws)) return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(N, C, H, Himg, Wimg, ws);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return fwd<T>(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), wqkv,
                  static_cast<const float*>(bqkv), static_cast<const float*>(rpe), wproj,
                  static_cast<const float*>(bproj), static_cast<const float*>(dp), y, nW, g,
                  scale, static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

// wqkv (3C, C) as in the forward; wqkv_io (C, 3C) and wproj_io (C, C): the
// weights in the (in, out) layout.  Scratch, all on the card (M = nW * N
// rows): lnb, ob, dpob (M, C) and dqkvv (M, 3C) bf16; dln (M, C) float32;
// vec_part (nW, 6C + H*N*N) float32; atb_part max(3 * s1, s2) * C * C
// float32.  Outputs: dx in the dtype; vec = [dgamma C | dbeta C | dbqkv 3C
// | dbproj C | drpe H*N*N], dwqkv (3C, C), dwproj (C, C) float32.  s1, s2:
// row chunks of the dWqkv and dWproj reductions.
int ipe_fused_attn_bwd(const void* x, const void* gamma, const void* beta, const void* wqkv,
                       const void* wqkv_io, const void* bqkv, const void* rpe,
                       const void* wproj_io, const void* dp, const void* dy, void* dx,
                       void* vec, void* dwqkv, void* dwproj, void* lnb, void* ob, void* dpob,
                       void* dqkvv, void* dln, void* vec_part, void* atb_part, int nW, int N,
                       int C, int H, int Himg, int Wimg, int ws, float scale, int s1, int s2,
                       int dtype, void* stream) {
  if (bad_shape(nW, N, C, H, Himg, Wimg, ws) || s1 <= 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(N, C, H, Himg, Wimg, ws);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return bwd<T>(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), wqkv,
                  wqkv_io, static_cast<const float*>(bqkv), static_cast<const float*>(rpe),
                  wproj_io,
                  static_cast<const float*>(dp), dy, dx, static_cast<float*>(vec),
                  static_cast<float*>(dwqkv), static_cast<float*>(dwproj),
                  static_cast<bf16*>(lnb), static_cast<bf16*>(ob), static_cast<bf16*>(dpob),
                  static_cast<bf16*>(dqkvv), static_cast<float*>(dln),
                  static_cast<float*>(vec_part), static_cast<float*>(atb_part), nW, g, scale,
                  s1, s2, static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
