// K5: the fused HRFormer MLP half-block, forward and backward, for Hopper.
//
// Replaces the TPU kernels `fused_mlp_half` (forward body
// `_mlp_half_fwd_kernel`, call fused_block.py:220) and its custom-VJP
// backward `_mlp_half_bwd` (body `_mlp_half_bwd_kernel`, call :260) in
// infantposeestimation_gaussianbias_tpu/ops/pallas/fused_block.py.
//
// Contract (kernels/fused_block.py), on M token rows of width C, hidden Hd:
//   y = x + dp[r / tps] * (gelu_tanh(bf16(LN(x)) W1 + b1) rounded to bf16) W2 + b2
//   x, y, dy, dx (M, C) in T (float or bf16); W1 (Hd, C) and W2 (C, Hd) in T,
//   the nn.Linear (out, in) layout; gamma, beta, b1, b2, dp float32.
//   Backward, as the TPU kernel: dw2 = gb^T dob, db2 = sum do,
//   dh = (dob W2^T) * gelu'(h), dw1 = lnb^T dhb, db1 = sum dh,
//   dln = dhb W1^T, dgamma = sum dln * xhat, dbeta = sum dln,
//   dx = dy + LN backward; do = dp * dy; lnb, gb, dob, dhb are the bf16
//   roundings of ln, g, do, dh.  All sums over rows in float32.
//
// What bounds it: the two products are 16 * M * C^2 FLOPs forward
// (hidden = 4C) against 2 * M * C * sizeof(T) bytes of rows, ~4C FLOP per
// byte in bf16 (~310 at C = 78, ~2,500 at C = 624): above the H100's ridge
// for bf16 tensor cores (~295 FLOP/byte), so bound by operations.  The
// products run on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
// f32, fused_common.cuh), the operands read straight from shared memory
// and L1/L2 without staging; the design keeps every intermediate of a row
// tile (ln, the (rows, Hd) hidden) in shared memory and moves each row
// once in and once out.
//
// Design:
//   * forward: one block per tile of BM rows (64, or 32 when the bf16 ln
//     and hidden tiles of 64 rows do not fit in shared memory); LN per
//     row by one warp; fc1 + bias + GELU tile by tile into a bf16 hidden
//     tile in shared memory; fc2 + bias + DropPath residual straight to y.
//   * backward, rows: one block per tile of 64 rows recomputes LN and h,
//     writes the bf16 operands of the weight gradients (lnb, dob, gb, dhb)
//     to scratch, computes dh and dln, and takes the LayerNorm backward;
//     its sums over rows of db1, db2, dgamma and dbeta go to one partial
//     vector per block.
//   * backward, reductions: dW1 = dhb^T lnb and dW2 = dob^T gb by a tile
//     product over the rows, in a bounded number of row chunks whose
//     partials are added in a fixed order; the partial vectors are summed
//     over blocks in a fixed order.  No atomics: the result does not
//     depend on block scheduling.

#include "fused_common.cuh"

namespace {

template <int BM>
size_t fwd_smem(int C, int Hd) {
  return (size_t)BM * (C + Hd) * sizeof(bf16);
}

constexpr int kBwdRows = 64;

size_t bwd_smem(int C) {
  // lnb and dob tiles, mean and rstd, the column sums of the two row halves
  return (size_t)kBwdRows * C * 2 * sizeof(bf16) + kBwdRows * 2 * sizeof(float) +
         2 * kBN * sizeof(float);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ dp, T* __restrict__ y,
               int M, int C, int Hd, int tps) {
  constexpr int TM = BM / 16, NW = Terms<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ln = reinterpret_cast<bf16*>(smem);  // (BM, C)
  bf16* g = ln + (size_t)BM * C;             // (BM, Hd)
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);

  layernorm_rows(x + (size_t)row0 * C, rows, C, gamma, beta, ln, nullptr, nullptr, nullptr);
  __syncthreads();

  float acc[TM][kTN];
  for (int n0 = 0; n0 < Hd; n0 += kBN) {  // g = gelu(ln W1^T + b1)
    mma_tile<BM, NW>(
        acc, C, [&](int m, int k) { return pair_row(ln, m < rows ? m : -1, C, k, C); },
        [&](int n, int k, uint32_t (&o)[NW]) {
          wpair_row(w1, n0 + n < Hd ? n0 + n : -1, C, k, C, o);
        });
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tile_row<BM>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tile_col(j);
        if (m < rows && n < Hd) g[m * Hd + n] = __float2bfloat16(gelu_tanh(acc[i][j] + b1[n]));
      }
    }
  }
  __syncthreads();
  for (int n0 = 0; n0 < C; n0 += kBN) {  // y = x + dp * (g W2^T + b2)
    mma_tile<BM, NW>(
        acc, Hd, [&](int m, int k) { return pair_row(g, m < rows ? m : -1, Hd, k, Hd); },
        [&](int n, int k, uint32_t (&o)[NW]) {
          wpair_row(w2, n0 + n < C ? n0 + n : -1, Hd, k, Hd, o);
        });
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tile_row<BM>(i);
      const int r = row0 + m;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tile_col(j);
        if (m < rows && n < C) {
          const size_t o = (size_t)r * C + n;
          y[o] = from_f32<T>(to_f32(x[o]) + dp[r / tps] * (acc[i][j] + b2[n]));
        }
      }
    }
  }
}

// The row stage of the backward.  w1 is the (Hd, C) weight the forward
// reads; w1_io (C, Hd) and w2_io (Hd, C) are the weights in the (in, out)
// layout, whose rows are the columns the backward's products need.
// part: this block's partial vector,
// [dgamma C | dbeta C | db1 Hd | db2 C].  lnb_g, dob_g (M, C), gb_g, dhb_g
// (M, Hd) bf16 and dln_g (M, C) float32 are scratch this kernel writes and
// (dhb_g, dln_g) reads back.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ w1,
                    const T* __restrict__ w1_io, const float* __restrict__ b1,
                    const T* __restrict__ w2_io, const float* __restrict__ dp,
                    const T* __restrict__ dy, T* dx, bf16* lnb_g, bf16* dob_g, bf16* gb_g,
                    bf16* dhb_g, float* dln_g, float* part, int M, int C, int Hd, int tps) {
  constexpr int BM = kBwdRows, TM = BM / 16, NW = Terms<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* lnb = reinterpret_cast<bf16*>(smem);  // (BM, C)
  bf16* dob = lnb + (size_t)BM * C;           // (BM, C)
  float* mean = reinterpret_cast<float*>(dob + (size_t)BM * C);
  float* rstd = mean + BM;
  float* red = rstd + BM;  // (2, kBN): column sums of the two row halves
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pv = part + (size_t)blockIdx.x * (3 * C + Hd);
  const size_t base = (size_t)row0 * C;
  const size_t hbase = (size_t)row0 * Hd;
  bf16* dhb_t = dhb_g + hbase;

  layernorm_rows(x + base, rows, C, gamma, beta, lnb, lnb_g + base, mean, rstd);
  // do = dp * dy, its bf16 rounding, and db2 over this block's rows.
  for (int c = tid; c < C; c += kThreads) {
    float s = 0.f;
    for (int m = 0; m < rows; ++m) {
      const int r = row0 + m;
      const float d = dp[r / tps] * to_f32(dy[(size_t)r * C + c]);
      const bf16 b = __float2bfloat16(d);
      dob[m * C + c] = b;
      dob_g[(size_t)r * C + c] = b;
      s += d;
    }
    pv[2 * C + Hd + c] = s;
  }
  __syncthreads();

  float ah[TM][kTN], ad[TM][kTN];
  for (int n0 = 0; n0 < Hd; n0 += kBN) {
    // h = lnb W1^T + b1 and dg = dob W2 on the same (rows, 64) tile
    mma_tile<BM, NW>(
        ah, C, [&](int m, int k) { return pair_row(lnb, m < rows ? m : -1, C, k, C); },
        [&](int n, int k, uint32_t (&o)[NW]) {
          wpair_row(w1, n0 + n < Hd ? n0 + n : -1, C, k, C, o);
        });
    mma_tile<BM, NW>(
        ad, C, [&](int m, int k) { return pair_row(dob, m < rows ? m : -1, C, k, C); },
        [&](int n, int k, uint32_t (&o)[NW]) {
          wpair_row(w2_io, n0 + n < Hd ? n0 + n : -1, C, k, C, o);
        });
    float cs[kTN] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tile_row<BM>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tile_col(j);
        if (m < rows && n < Hd) {
          const float h = ah[i][j] + b1[n];
          const float dh = ad[i][j] * gelu_tanh_grad(h);
          gb_g[hbase + (size_t)m * Hd + n] = __float2bfloat16(gelu_tanh(h));
          dhb_t[(size_t)m * Hd + n] = __float2bfloat16(dh);
          cs[j] += dh;
        }
      }
    }
    // db1: this thread's rows, then the 8 row groups of the warp in a fixed
    // shuffle tree, then the two row halves in order.
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 4);
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 8);
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
      if ((lane >> 2) == 0) red[(warp & 1) * kBN + tile_col(j)] = cs[j];
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < Hd) pv[2 * C + n0 + tid] = red[tid] + red[kBN + tid];
    __syncthreads();
  }

  for (int n0 = 0; n0 < C; n0 += kBN) {  // dln = dhb W1
    mma_tile<BM, NW>(
        ah, Hd, [&](int m, int k) { return pair_row(dhb_t, m < rows ? m : -1, Hd, k, Hd); },
        [&](int n, int k, uint32_t (&o)[NW]) {
          wpair_row(w1_io, n0 + n < C ? n0 + n : -1, Hd, k, Hd, o);
        });
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tile_row<BM>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tile_col(j);
        if (m < rows && n < C) dln_g[base + (size_t)m * C + n] = ah[i][j];
      }
    }
  }
  __syncthreads();

  layernorm_bwd_rows(x + base, dy + base, dln_g + base, mean, rstd, gamma, rows, C, dx + base,
                     pv, pv + C);
}

template <typename T, int BM>
cudaError_t launch_fwd(const void* x, const float* gamma, const float* beta, const void* w1,
                       const float* b1, const void* w2, const float* b2, const float* dp,
                       void* y, int M, int C, int Hd, int tps, cudaStream_t stream) {
  const size_t smem = fwd_smem<BM>(C, Hd);
  cudaError_t err = allow_smem(mlp_fwd_kernel<T, BM>, smem);
  if (err != cudaSuccess) return err;
  mlp_fwd_kernel<T, BM><<<(M + BM - 1) / BM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, dp, static_cast<T*>(y), M, C, Hd, tps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const float* gamma, const float* beta, const void* w1,
                const float* b1, const void* w2, const float* b2, const float* dp, void* y, int M,
                int C, int Hd, int tps, cudaStream_t stream) {
  if (fwd_smem<64>(C, Hd) <= (size_t)kMaxSmem)
    return launch_fwd<T, 64>(x, gamma, beta, w1, b1, w2, b2, dp, y, M, C, Hd, tps, stream);
  if (fwd_smem<32>(C, Hd) <= (size_t)kMaxSmem)
    return launch_fwd<T, 32>(x, gamma, beta, w1, b1, w2, b2, dp, y, M, C, Hd, tps, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd(const void* x, const float* gamma, const float* beta, const void* w1,
                const void* w1_io, const float* b1, const void* w2_io, const float* dp,
                const void* dy, void* dx,
                float* vec, float* dw1, float* dw2, bf16* lnb, bf16* dob, bf16* gb, bf16* dhb,
                float* dln, float* vec_part, float* atb_part, int M, int C, int Hd, int tps,
                int s1, int s2, cudaStream_t stream) {
  const size_t smem = bwd_smem(C);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kBwdRows - 1) / kBwdRows;
  mlp_bwd_rows_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w1),
      static_cast<const T*>(w1_io), b1, static_cast<const T*>(w2_io), dp,
      static_cast<const T*>(dy), static_cast<T*>(dx), lnb, dob, gb, dhb, dln, vec_part, M, C,
      Hd, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dW1 (Hd, C) = dhb^T lnb;  dW2 (C, Hd) = dob^T gb
  err = launch_atb(dhb, Hd, lnb, C, dw1, atb_part, M, Hd, C, s1, stream);
  if (err != cudaSuccess) return err;
  err = launch_atb(dob, C, gb, Hd, dw2, atb_part, M, C, Hd, s2, stream);
  if (err != cudaSuccess) return err;
  return launch_colsum(vec_part, vec, blocks, 3 * C + Hd, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, y and the weights).  Returns the
// launch's cudaError_t.
int ipe_fused_mlp_fwd(const void* x, const void* gamma, const void* beta, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* dp, void* y,
                      int M, int C, int Hd, int tps, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || Hd <= 0 || tps <= 0) return (int)cudaErrorInvalidValue;
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return fwd<T>(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), w1,
                  static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
                  static_cast<const float*>(dp), y, M, C, Hd, tps,
                  static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

// Rows per block of the backward's row stage (the partial vectors are one
// per block), or 0 when a (C, Hd) does not fit in shared memory.
int ipe_fused_mlp_bwd_rows_per_block(int C, int Hd) {
  return (C > 0 && Hd > 0 && bwd_smem(C) <= (size_t)kMaxSmem) ? kBwdRows : 0;
}

// w1 (Hd, C) as in the forward; w1_io (C, Hd) and w2_io (Hd, C): the
// weights in the (in, out) layout.  Scratch, all on the card: lnb, dob
// (M, C) and gb, dhb (M, Hd) bf16; dln (M, C) float32; vec_part
// (ceil(M / rows_per_block), 3C + Hd) float32; atb_part max(s1, s2) * Hd * C
// float32.  Outputs: dx (M, C) in the dtype; vec = [dgamma C | dbeta C |
// db1 Hd | db2 C], dw1 (Hd, C), dw2 (C, Hd) float32.  s1, s2: row chunks of
// the dW1 and dW2 reductions.
int ipe_fused_mlp_bwd(const void* x, const void* gamma, const void* beta, const void* w1,
                      const void* w1_io, const void* b1, const void* w2_io, const void* dp,
                      const void* dy, void* dx, void* vec, void* dw1, void* dw2, void* lnb,
                      void* dob, void* gb, void* dhb, void* dln, void* vec_part, void* atb_part,
                      int M, int C, int Hd, int tps, int s1, int s2, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || Hd <= 0 || tps <= 0 || s1 <= 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return bwd<T>(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), w1,
                  w1_io, static_cast<const float*>(b1), w2_io, static_cast<const float*>(dp),
                  dy, dx,
                  static_cast<float*>(vec), static_cast<float*>(dw1), static_cast<float*>(dw2),
                  static_cast<bf16*>(lnb), static_cast<bf16*>(dob), static_cast<bf16*>(gb),
                  static_cast<bf16*>(dhb), static_cast<float*>(dln),
                  static_cast<float*>(vec_part), static_cast<float*>(atb_part), M, C, Hd, tps,
                  s1, s2, static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
