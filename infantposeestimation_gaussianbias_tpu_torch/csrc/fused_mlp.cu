// K5: the fused HRFormer MLP half-block, forward and backward, for Hopper.
//
// Replaces the TPU kernels `fused_mlp_half` (forward body
// `_mlp_half_fwd_kernel`, call fused_block.py:220) and its custom-VJP
// backward `_mlp_half_bwd` (body `_mlp_half_bwd_kernel`, call :260) in
// infantposeestimation_gaussianbias_tpu/ops/pallas/fused_block.py.
//
// Contract (kernels/fused_block.py), on M token rows of width C, hidden Hd:
//   y = x + dp[r / tps] * (gelu_tanh(bf16(LN(x)) W1 + b1) rounded to bf16) W2 + b2
//   x, y, dy, dx (M, C) in T (float or bf16); gamma, beta, b1, b2, dp
//   float32; the products read W1 (Hd, Cp) and W2 (C, Hd) in the nn.Linear
//   (out, in) layout as NT bf16 terms, W1's rows zero-padded from C to
//   Cp = C rounded up to 8 (16-byte rows): a bf16 weight is one term, which
//   the wrapper pads (kernels/fused_block.py `mlp_weight_rows`); a float32
//   weight, in any layout, is split here once per call into three exact
//   terms (fused_common.cuh `split_weights_kernel`).
//   Backward, as the TPU kernel: dw2 = gb^T dob, db2 = sum do,
//   dh = (dob W2^T) * gelu'(h), dw1 = lnb^T dhb, db1 = sum dh,
//   dln = dhb W1^T, dgamma = sum dln * xhat, dbeta = sum dln,
//   dx = dy + LN backward; do = dp * dy; lnb, gb, dob, dhb are the bf16
//   roundings of ln, g, do, dh.  dln and every sum over rows in float32.
//
// What bounds it: the two products are 4 * M * C * Hd FLOPs forward
// (hidden = 4C) against 2 * M * C * sizeof(T) bytes of rows, ~4C FLOP per
// byte in bf16: above the H100's ridge for bf16 tensor cores (~295
// FLOP/byte) at every hrformer_base width, so bound by operations.
//
// The first version ran each direction in one block per 64 rows
// that walked every hidden and output tile, its operands fetched unstaged
// from L1/L2: at b = 32 it lost to the stock PyTorch chain by 1.2-2.5x
// forward at C >= 156 and 1.1-1.9x backward at C >= 312 (grids of 49-147
// blocks for 132 SMs; PERF.md).  Now every product is the staged
// tensor-core tile product of mlp_gemm.cuh (cp.async ring, ldmatrix,
// mma.sync), one output tile of 64 or 128 rows by 64 or 128 columns per
// block (fused_common.cuh TileS/M/L, the plan's choice), so each stage is
// parallel over rows and columns; bf16 output tiles leave through shared
// memory as 16-byte rows; bf16 intermediates go through device memory,
// where the contract rounds them anyway:
//   forward  (1) LayerNorm, one warp per row: lnb (M, Cp);
//            (2) fc1 + b1 + GELU over (row tile x hidden tile): g (M, Hd);
//            (3) fc2 + b2 + DropPath residual over (row tile x column
//                tile): y, written once;
//   backward (a) LayerNorm recompute: lnb, dob = bf16(dp dy) (M, Cp), each
//                row's mean and rstd, db2 partials;
//            (b) h = lnb W1^T + b1 and dg = dob W2 over (row tile x hidden
//                tile), W2 read transposed from its one staged copy: gb,
//                dhb (M, Hd), db1 partials per row tile;
//            (c) dln = dhb W1 over (row tile x column tile), W1 read
//                transposed; then the LayerNorm backward per row: dx,
//                dgamma and dbeta partials;
//            (d) dW1 = dhb^T lnb, dW2 = dob^T gb by `atb` (fused_common.cuh,
//                on the same staged product) in row chunks added in a
//                fixed order; the partial rows summed in a fixed order.
// In float32 at C <= 160 the forward keeps the first version's
// single-block form (mlp_fwd_f32_rows_kernel), as fast there as the
// staged stages or faster.  The
// tiles, the LayerNorm stages' rows per block and the form come from the
// host plan (kernels/fused_block.py `mlp_plan`).  No atomics: every sum
// over rows runs in a fixed order, independent of block scheduling.

#include "fused_common.cuh"

namespace {

// Shared memory of each product stage: fc1 and fc2 read both operands
// k-contiguous (fc_smem, fused_common.cuh); dln reads W1 transposed; the
// hidden stage runs one product of each kind on one ring.
template <class CF, int NB>
constexpr size_t t_smem() {
  return mg::ring_bytes<CF, RowOp<1>, ColOp<NB>>();
}

template <class CF, int NB>
constexpr size_t hidden_smem() {
  return fc_smem<CF, NB>() > t_smem<CF, NB>() ? fc_smem<CF, NB>() : t_smem<CF, NB>();
}

// Every stage of every tile fits the shared memory a block may have (the
// hidden stage's ring is the larger of the two kinds).
template <class CF>
constexpr bool fits() {
  return hidden_smem<CF, 1>() <= kMaxSmem && hidden_smem<CF, 3>() <= kMaxSmem;
}
static_assert(fits<TileS>() && fits<TileM>() && fits<TileL>(),
              "a product tile's ring exceeds the shared memory a block may have");

// Forward at narrow widths in float32 (the plan's choice at C <= 160):
// the first version's single-block form, one block per BM rows, LayerNorm
// into a bf16 tile, fc1 + GELU hidden tile by hidden tile into a bf16 g
// tile, fc2 + residual to y; the float32 weights, small enough to stay
// in L1/L2, are read from there and split into their bf16 terms in
// registers (fused_common.cuh `mma_tile`, `wpair_row`), so no term arrays
// are staged.  At C = 78 on an NVIDIA H100 it takes 0.35 ms of device time
// (b = 32) where the staged three-stage form, three weight terms per slice
// at one block per SM, took 0.41 (PERF.md).
template <int BM>
size_t f32_rows_smem(int C, int Hd) {
  return (size_t)BM * (C + Hd) * sizeof(bf16);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_f32_rows_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ b2, const float* __restrict__ dp,
                        float* __restrict__ y, int M, int C, int Hd, int tps) {
  constexpr int TM = BM / 16, NW = 3;
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
          y[o] = x[o] + dp[r / tps] * (acc[i][j] + b2[n]);
        }
      }
    }
  }
}

// Forward (2): g = bf16(gelu(lnb W1^T + b1)), one (BM, BN) tile of the
// (M, Hd) output per block.
template <class CF, int NB>
__global__ void __launch_bounds__(CF::threads)
mlp_fc1_kernel(const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
               const float* __restrict__ b1, bf16* __restrict__ g, int M, int Cp, int Hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * CF::BN, m0 = blockIdx.y * CF::BM;
  mg::Acc<CF> acc;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  mg::tile_product<CF>(acc, RowOp<1>{lnb, Cp, 0, M, Cp},
                       RowOp<NB>{w1, Cp, (long long)Hd * Cp, Hd, Cp}, Cp, m0, n0, ring);
  mg::store_tile(acc, ring, g + (size_t)m0 * Hd + n0, Hd, M - m0, Hd - n0,
                 [&](int, int c, float v0, float v1) {
                   const int n = min(n0 + c, Hd - 2);  // columns past Hd are not stored
                   return make_float2(gelu_tanh(v0 + b1[n]), gelu_tanh(v1 + b1[n + 1]));
                 });
}

// Backward (b): h = lnb W1^T + b1 and dg = dob W2 on one (BM, BN) tile of
// the (M, Hd) hidden; gb = bf16(gelu(h)), dh = dg * gelu'(h), dhb =
// bf16(dh); this row tile's db1 partial, dh summed over its rows, into
// part_hid[blockIdx.y][n0 ..): per thread over its rows, then over the 8
// row groups of the warp in a fixed shuffle tree, then over the WM row
// groups of warps in order.
template <class CF, int NB>
__global__ void __launch_bounds__(CF::threads)
mlp_bwd_hidden_kernel(const bf16* __restrict__ lnb, const bf16* __restrict__ dob,
                      const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                      const float* __restrict__ b1, bf16* __restrict__ gb,
                      bf16* __restrict__ dhb, float* __restrict__ part_hid, int M, int C,
                      int Cp, int Hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  constexpr int BN = CF::BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * CF::BM;
  mg::Acc<CF> ah, ad;
  mg::tile_product<CF>(ah, RowOp<1>{lnb, Cp, 0, M, Cp},
                       RowOp<NB>{w1, Cp, (long long)Hd * Cp, Hd, Cp}, Cp, m0, n0, ring);
  // W2 (C, Hd) as B (k = its row, n = its column): read transposed.
  mg::tile_product<CF>(ad, RowOp<1>{dob, Cp, 0, M, Cp},
                       ColOp<NB>{w2, Hd, (long long)C * Hd, Hd, C}, Cp, m0, n0, ring);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // ad becomes dh = dg * gelu'(h), ah becomes gelu(h); then both tiles go
  // out through the free ring, and dh's column sums through red.
#pragma unroll
  for (int ni = 0; ni < CF::NT8; ++ni) {
    const int n = min(n0 + mg::acc_col<CF>(ni, 0), Hd - 2);  // past Hd: not stored
#pragma unroll
    for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hv = ah.v[mi][ni][e] + b1[n + (e & 1)];
        ah.v[mi][ni][e] = gelu_tanh(hv);
        ad.v[mi][ni][e] *= gelu_tanh_grad(hv);
      }
  }
  const auto same = [](int, int, float v0, float v1) { return make_float2(v0, v1); };
  mg::store_tile(ah, ring, gb + (size_t)m0 * Hd + n0, Hd, M - m0, Hd - n0, same);
  mg::store_tile(ad, ring, dhb + (size_t)m0 * Hd + n0, Hd, M - m0, Hd - n0, same);
  float* red = reinterpret_cast<float*>(smem);  // [WM][BN]
#pragma unroll
  for (int ni = 0; ni < CF::NT8; ++ni) {
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (m0 + mg::acc_row<CF>(mi, 2 * h) < M) {
          cs[0] += ad.v[mi][ni][2 * h];
          cs[1] += ad.v[mi][ni][2 * h + 1];
        }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 4);
      cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 8);
      cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
      if ((lane >> 2) == 0) red[(warp % CF::WM) * BN + mg::acc_col<CF>(ni, e)] = cs[e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += CF::threads) {
    if (n0 + c < Hd) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < CF::WM; ++w) s += red[w * BN + c];
      part_hid[(size_t)blockIdx.y * Hd + n0 + c] = s;
    }
  }
}

// Backward (c), first half: dln = dhb W1 (float32), one (BM, BN) tile of
// the (M, C) output per block; W1 (Hd, Cp) as B (k = its row): read
// transposed.
template <class CF, int NB>
__global__ void __launch_bounds__(CF::threads)
mlp_bwd_dln_kernel(const bf16* __restrict__ dhb, const bf16* __restrict__ w1,
                   float* __restrict__ dln, int M, int C, int Cp, int Hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * CF::BN, m0 = blockIdx.y * CF::BM;
  mg::Acc<CF> acc;
  mg::tile_product<CF>(acc, RowOp<1>{dhb, Hd, 0, M, Hd},
                       ColOp<NB>{w1, Cp, (long long)Hd * Cp, Cp, Hd}, Hd, m0, n0,
                       reinterpret_cast<bf16*>(smem));
#pragma unroll
  for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < CF::NT8; ++ni) {
      const int n = n0 + mg::acc_col<CF>(ni, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mg::acc_row<CF>(mi, 2 * h);
        if (m < M && n < C)
          mg::store2(dln + (size_t)m * C + n, acc.v[mi][ni][2 * h], acc.v[mi][ni][2 * h + 1]);
      }
    }
}

// Backward (c), second half, rows [blockIdx.x * rpb, ...): the LayerNorm
// backward, dx, and this block's dgamma and dbeta partials into
// part[blockIdx.x][0 .. 2C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_ln_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ dln,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  T* __restrict__ dx, float* __restrict__ part, int M, int C, int rpb) {
  const int row0 = blockIdx.x * rpb;
  const size_t base = (size_t)row0 * C;
  float* pv = part + (size_t)blockIdx.x * 3 * C;
  layernorm_bwd_rows(x + base, dy + base, dln + base, mean + row0, rstd + row0, gamma,
                     min(rpb, M - row0), C, dx + base, pv, pv + C);
}

// A weight as the caller passes it: element (r, c) of its (out, in) view
// at p[r * sr + c * sc].
struct Weight {
  const void* p;
  int sr, sc;
};

// W1 and W2 as the products read them, (Hd, Cp) and (C, Hd) term arrays
// (term stride Hd * Cp and C * Hd): a bf16 weight as the wrapper staged it
// (contiguous, W1's rows padded); a float32 one split into wterms, three
// (Hd, Cp) terms of W1 then three (C, Hd) of W2.
template <typename T>
cudaError_t stage_weights(const Weight& w1, const Weight& w2, int C, int Cp, int Hd,
                          bf16* wterms, const bf16*& w1s, const bf16*& w2s,
                          cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (w1.sr != Cp || w1.sc != 1 || w2.sr != Hd || w2.sc != 1) return cudaErrorInvalidValue;
    w1s = static_cast<const bf16*>(w1.p);
    w2s = static_cast<const bf16*>(w2.p);
    return cudaSuccess;
  } else {
    w1s = wterms;
    w2s = wterms + 3 * (size_t)Hd * Cp;
    const cudaError_t err = launch_split_weights(static_cast<const float*>(w1.p), w1.sr, w1.sc,
                                                 Hd, C, Cp, wterms, stream);
    if (err != cudaSuccess) return err;
    return launch_split_weights(static_cast<const float*>(w2.p), w2.sr, w2.sc, C, Hd, Hd,
                                wterms + 3 * (size_t)Hd * Cp, stream);
  }
}

// tile: the plan's tile ids of (fc1, fc2) forward, (hidden, dln) backward;
// single: the float32 single-block form in place of the three stages.
template <typename T>
cudaError_t fwd(const T* x, const float* gamma, const float* beta, const Weight& w1_in,
                const float* b1, const Weight& w2_in, const float* b2, const float* dp, T* y,
                bf16* lnb, bf16* g, bf16* wterms, int M, int C, int Cp, int Hd, int tps,
                int rpb, const int (&tile)[2], bool single, cudaStream_t stream) {
  constexpr int NB = Terms<T>::n;
  if constexpr (sizeof(T) == 4) {
    if (single) {  // the float32 weights as they are, (Hd, C) and (C, Hd) contiguous
      const size_t smem = f32_rows_smem<64>(C, Hd);
      if (smem > (size_t)kMaxSmem || w1_in.sr != C || w1_in.sc != 1 || w2_in.sr != Hd ||
          w2_in.sc != 1)
        return cudaErrorInvalidValue;
      const cudaError_t opt = allow_smem(mlp_fwd_f32_rows_kernel<64>, smem);
      if (opt != cudaSuccess) return opt;
      mlp_fwd_f32_rows_kernel<64><<<tiles(M, 64), kThreads, smem, stream>>>(
          x, gamma, beta, static_cast<const float*>(w1_in.p), b1,
          static_cast<const float*>(w2_in.p), b2, dp, y, M, C, Hd, tps);
      return cudaGetLastError();
    }
  } else if (single) {
    return cudaErrorInvalidValue;
  }
  const bf16 *w1, *w2;
  cudaError_t err = stage_weights<T>(w1_in, w2_in, C, Cp, Hd, wterms, w1, w2, stream);
  if (err != cudaSuccess) return err;
  err = with_ln_width(Cp, [&](auto nv) {
    mlp_ln_kernel<T, false, decltype(nv)::value><<<tiles(M, rpb), kThreads, 0, stream>>>(
        x, gamma, beta, nullptr, nullptr, lnb, nullptr, nullptr, nullptr, nullptr, M, C, Cp, 1,
        rpb);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  err = with_tile(tile[0], [&](auto cf) {
    using CF = decltype(cf);
    return launch_tiles<CF>(mlp_fc1_kernel<CF, NB>, fc_smem<CF, NB>(), M, Hd, stream,
                                   (const bf16*)lnb, w1, b1, g, M, Cp, Hd);
  });
  if (err != cudaSuccess) return err;
  return with_tile(tile[1], [&](auto cf) {
    using CF = decltype(cf);
    return launch_tiles<CF>(mlp_fc2_kernel<CF, NB, T>, fc_smem<CF, NB>(), M, C, stream,
                            (const bf16*)g, w2, b2, x, dp, y, M, C, Hd, tps);
  });
}

template <typename T>
cudaError_t bwd(const T* x, const float* gamma, const float* beta, const Weight& w1_in,
                const float* b1, const Weight& w2_in, const float* dp, const T* dy, T* dx,
                float* vec, float* dw1, float* dw2, bf16* lnb, bf16* dob, bf16* gb, bf16* dhb,
                float* dln, float* stats, float* part_rows, float* part_hid, float* atb_part,
                bf16* wterms, int M, int C, int Cp, int Hd, int tps, int rpb,
                const int (&tile)[2], int s1, int s2, cudaStream_t stream) {
  constexpr int NB = Terms<T>::n;
  float* mean = stats;
  float* rstd = stats + M;
  const int blocks = tiles(M, rpb);
  const bf16 *w1, *w2;
  cudaError_t err = stage_weights<T>(w1_in, w2_in, C, Cp, Hd, wterms, w1, w2, stream);
  if (err != cudaSuccess) return err;
  err = with_ln_width(Cp, [&](auto nv) {
    mlp_ln_kernel<T, true, decltype(nv)::value><<<blocks, kThreads, 0, stream>>>(
        x, gamma, beta, dp, dy, lnb, dob, mean, rstd, part_rows, M, C, Cp, tps, rpb);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  int hidden_rows = 0;  // rows of the hidden stage's tiles: part_hid's row count
  err = with_tile(tile[0], [&](auto cf) {
    using CF = decltype(cf);
    hidden_rows = CF::BM;
    return launch_tiles<CF>(mlp_bwd_hidden_kernel<CF, NB>, hidden_smem<CF, NB>(), M, Hd,
                            stream, (const bf16*)lnb, (const bf16*)dob, w1, w2, b1, gb, dhb,
                            part_hid, M, C, Cp, Hd);
  });
  if (err != cudaSuccess) return err;
  err = with_tile(tile[1], [&](auto cf) {
    using CF = decltype(cf);
    return launch_tiles<CF>(mlp_bwd_dln_kernel<CF, NB>, t_smem<CF, NB>(), M, C, stream,
                            (const bf16*)dhb, w1, dln, M, C, Cp, Hd);
  });
  if (err != cudaSuccess) return err;
  mlp_bwd_ln_kernel<T><<<blocks, kThreads, 0, stream>>>(x, dy, gamma, dln, mean, rstd, dx,
                                                        part_rows, M, C, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dW1 (Hd, C) = dhb^T lnb;  dW2 (C, Hd) = dob^T gb
  err = launch_atb(dhb, Hd, lnb, Cp, dw1, atb_part, M, Hd, C, s1, stream);
  if (err != cudaSuccess) return err;
  err = launch_atb(dob, Cp, gb, Hd, dw2, atb_part, M, C, Hd, s2, stream);
  if (err != cudaSuccess) return err;
  // vec = [dgamma | dbeta | db2] over row blocks, then db1 over row tiles
  err = launch_colsum(part_rows, vec, blocks, 3 * C, stream);
  if (err != cudaSuccess) return err;
  return launch_colsum(part_hid, vec + 3 * C, tiles(M, hidden_rows), Hd, stream);
}

bool bad_shape(int M, int C, int Cp, int Hd, int tps, int rpb) {
  return M <= 0 || C <= 0 || C % 2 || Cp < C || Cp % 8 || Cp > kMaxLnWidth || Hd <= 0 ||
         Hd % 8 || tps <= 0 || rpb <= 0 || tiles(M, TileS::BM) > 65535;
}

bool bad_tile(const int (&tile)[2]) {
  return tile[0] < 0 || tile[0] > 2 || tile[1] < 0 || tile[1] > 2;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, y).  w1, w2: the weights in their
// (out, in) views, (Hd, C) and (C, Hd), element (r, c) at p[r * sr + c *
// sc]: bf16 ones as the wrapper stages them, contiguous with W1's rows
// padded to Cp (sr = Cp, Hd; sc = 1); float32 ones in any layout, split
// into wterms (3 * (Hd * Cp + C * Hd) bf16 on the card), or, for the
// single-block form, contiguous (sr = C, Hd; sc = 1) and read as they are.
// Scratch on the card: lnb (M, Cp), g (M, Hd) bf16 (unused by the
// single-block form, as is wterms).  rpb: rows per block of the LayerNorm
// stage; tile1, tile2: the tile ids (0-2) of fc1 and fc2; single: 1 for
// the float32 single-block form.  Returns the launches' cudaError_t.
int ipe_fused_mlp_fwd(const void* x, const void* gamma, const void* beta, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* dp, void* y,
                      void* lnb, void* g, void* wterms, int M, int C, int Cp, int Hd, int tps,
                      int rpb, int tile1, int tile2, int single, int w1_sr, int w1_sc,
                      int w2_sr, int w2_sc, int dtype, void* stream) {
  const int tile[2] = {tile1, tile2};
  if (bad_shape(M, C, Cp, Hd, tps, rpb) || bad_tile(tile)) return (int)cudaErrorInvalidValue;
  const Weight wa{w1, w1_sr, w1_sc}, wb{w2, w2_sr, w2_sc};
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return fwd<T>(static_cast<const T*>(x), static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), wa, static_cast<const float*>(b1), wb,
                  static_cast<const float*>(b2), static_cast<const float*>(dp),
                  static_cast<T*>(y), static_cast<bf16*>(lnb), static_cast<bf16*>(g),
                  static_cast<bf16*>(wterms), M, C, Cp, Hd, tps, rpb, tile, single != 0,
                  static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

// w1, w2 (with their strides) and wterms as in the forward.  Scratch, all
// on the card: lnb, dob (M, Cp) and gb, dhb (M, Hd) bf16; dln (M, C),
// stats (2, M) (each row's LayerNorm mean, rstd), part_rows (ceil(M /
// rpb), 3C), part_hid (row tiles of stage (b), Hd) and atb_part max(s1,
// s2) * Hd * C float32.  Outputs: dx (M, C) in the dtype; vec = [dgamma C
// | dbeta C | db2 C | db1 Hd], dw1 (Hd, C), dw2 (C, Hd) float32.  rpb:
// rows per block of the LayerNorm stages; tileh, tiled: the tile ids of
// stages (b) and (c); s1, s2: row chunks of the dW1 and dW2 reductions.
int ipe_fused_mlp_bwd(const void* x, const void* gamma, const void* beta, const void* w1,
                      const void* b1, const void* w2, const void* dp, const void* dy, void* dx,
                      void* vec, void* dw1, void* dw2, void* lnb, void* dob, void* gb, void* dhb,
                      void* dln, void* stats, void* part_rows, void* part_hid, void* atb_part,
                      void* wterms, int M, int C, int Cp, int Hd, int tps, int rpb, int tileh,
                      int tiled, int s1, int s2, int w1_sr, int w1_sc, int w2_sr, int w2_sc,
                      int dtype, void* stream) {
  const int tile[2] = {tileh, tiled};
  if (bad_shape(M, C, Cp, Hd, tps, rpb) || bad_tile(tile) || s1 <= 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  const Weight wa{w1, w1_sr, w1_sc}, wb{w2, w2_sr, w2_sc};
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return bwd<T>(static_cast<const T*>(x), static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), wa, static_cast<const float*>(b1), wb,
                  static_cast<const float*>(dp), static_cast<const T*>(dy), static_cast<T*>(dx),
                  static_cast<float*>(vec), static_cast<float*>(dw1), static_cast<float*>(dw2),
                  static_cast<bf16*>(lnb), static_cast<bf16*>(dob), static_cast<bf16*>(gb),
                  static_cast<bf16*>(dhb), static_cast<float*>(dln), static_cast<float*>(stats),
                  static_cast<float*>(part_rows), static_cast<float*>(part_hid),
                  static_cast<float*>(atb_part), static_cast<bf16*>(wterms), M, C, Cp, Hd, tps,
                  rpb, tile, s1, s2, static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return (int)f(float{});
  if (dtype == 1) return (int)f(bf16{});
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
