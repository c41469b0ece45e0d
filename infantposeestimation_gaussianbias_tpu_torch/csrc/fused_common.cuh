// Device pieces shared by the fused half-block kernels (csrc/fused_mlp.cu,
// csrc/fused_attn.cu): a block-level tile product on the tensor cores,
// LayerNorm forward and backward over a block's rows, the tanh GELU, the
// split of float32 weights into bf16 terms once per call, the row stages
// of K5 that K4's forward runs too (LayerNorm rows, the staged product
// with a residual epilogue), and the two
// deterministic reductions of the backward (weight gradients as
// A^T B over the rows, on the staged tile product of mlp_gemm.cuh, and
// fixed-order sums of per-block partial vectors).
//
// Numerics, as the TPU kernels (ops/pallas/fused_block.py): every product
// takes its activation operand rounded to bf16 (the callers store those
// operands as bf16) and its weight as it is, and accumulates in float32.
// The products run as bf16 x bf16 -> f32 `mma.sync` on the tensor cores:
// exactly the TPU kernel's products for bf16 weights.  A float32 weight is
// split into three bf16 terms whose sum is the weight exactly (8 + 8 + 8
// significant bits), and the product takes one mma per term: each partial
// product is exact in float32, so this too is the TPU kernel's
// bf16 x f32 -> f32 product up to summation order.
//
// Everything here lives in an anonymous namespace: each .cu file that
// includes it gets its own copy, so the objects link side by side.
#pragma once

#include <cstdint>
#include <type_traits>

#include "ipe_common.cuh"
#include "mlp_gemm.cuh"

namespace {

using ipe::allow_smem;
using ipe::kMaxSmem;
using ipe::from_f32;
using ipe::to_f32;
using ipe::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // every fused kernel runs 256 threads: 8 warps
constexpr int kBN = 64;              // columns of one output tile
constexpr int kTN = 4;               // accumulators per thread and row pair
constexpr float kLnEps = 1e-5f;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kGeluC3 = 0.134145f;  // 3 * 0.044715, rounded to float as in the JAX kernel

// bf16 terms per weight element in the tensor-core products.
template <typename T> struct Terms { static constexpr int n = 1; };
template <> struct Terms<float> { static constexpr int n = 3; };

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) { return bf(__float2bfloat16(x)); }

__device__ __forceinline__ float gelu_tanh(float h) {
  const float u = kSqrt2OverPi * (h + kGeluC * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float u = kSqrt2OverPi * (h + kGeluC * h * h * h);
  const float t = tanhf(u);
  const float du = kSqrt2OverPi * (1.f + kGeluC3 * h * h);
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
}

// Two bf16 values (lo at the lower address / smaller k) in one register.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bits(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Operand pairs for the tile product: the elements (k, k + 1) of one row
// of A or one column of B, as bf16 pairs; zero outside (row < 0, k >= K).
// A row-major bf16 matrix read along its rows (k even, row stride even):
// one 32-bit load.
__device__ __forceinline__ uint32_t pair_row(const bf16* p, int row, int ld, int k, int K) {
  return (row >= 0 && k < K) ? *reinterpret_cast<const uint32_t*>(p + (size_t)row * ld + k)
                             : 0u;
}

// The same for a weight, in terms: a bf16 weight is one pair, a float one
// three (hi, mid, lo bf16 parts, exact in sum).
__device__ __forceinline__ void split(float lo, float hi, uint32_t (&o)[3]) {
  const float l1 = round_bf16(lo), h1 = round_bf16(hi);
  const float l2 = round_bf16(lo - l1), h2 = round_bf16(hi - h1);
  o[0] = pack(l1, h1);
  o[1] = pack(l2, h2);
  o[2] = pack(lo - l1 - l2, hi - h1 - h2);
}

__device__ __forceinline__ void wpair_row(const bf16* p, int row, int ld, int k, int K,
                                          uint32_t (&o)[1]) {
  o[0] = pair_row(p, row, ld, k, K);
}

__device__ __forceinline__ void wpair_row(const float* p, int row, int ld, int k, int K,
                                          uint32_t (&o)[3]) {
  const float2 v = (row >= 0 && k < K)
                       ? *reinterpret_cast<const float2*>(p + (size_t)row * ld + k)
                       : make_float2(0.f, 0.f);
  split(v.x, v.y, o);
}

__device__ __forceinline__ void mma_16816(float& d0, float& d1, float& d2, float& d3,
                                          const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where accumulator acc[i][j] of the tile product below lies in its tile.
template <int BM>
__device__ __forceinline__ int tile_row(int i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp & 1) * (BM / 2) + (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2);
}

__device__ __forceinline__ int tile_col(int j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp >> 1) * 16 + (j >> 1) * 8 + 2 * (lane & 3) + (j & 1);
}

// One BM x kBN output tile on the tensor cores: acc = A B over k < K
// (acc += with kAccumulate), with the 8 warps as 2 (rows) x 4 (columns),
// each warp BM/2 rows x 16 columns in m16n8k16 products.  pa(m, k) returns
// the bf16 pair A(m, k), A(m, k+1) (0 outside the caller's range);
// pb(n, k, o) fills o[NW] with the bf16 pair(s) of B(k, n), B(k+1, n).
// acc[i][j] holds the output at (tile_row<BM>(i), tile_col(j)).  Ends with
// the whole block past a barrier; the caller synchronises before it if A
// was written by other threads.
template <int BM, int NW, bool kAccumulate = false, class PA, class PB>
__device__ __forceinline__ void mma_tile(float (&acc)[BM / 16][kTN], int K, PA pa, PB pb) {
  constexpr int MT = BM / 32;  // m16 tiles per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * (BM / 2) + g;
  const int n0 = (warp >> 1) * 16 + g;
  if (!kAccumulate) {
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int ka = k0 + 2 * t;
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = m0 + mi * 16;
      a[mi][0] = pa(m, ka);
      a[mi][1] = pa(m + 8, ka);
      a[mi][2] = pa(m, ka + 8);
      a[mi][3] = pa(m + 8, ka + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      uint32_t b0[NW], b1[NW];
      pb(n0 + ni * 8, ka, b0);
      pb(n0 + ni * 8, ka + 8, b1);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mma_16816(acc[2 * mi][2 * ni], acc[2 * mi][2 * ni + 1], acc[2 * mi + 1][2 * ni],
                    acc[2 * mi + 1][2 * ni + 1], a[mi], b0[w], b1[w]);
    }
  }
  __syncthreads();
}

// LayerNorm of `rows` rows of x (row stride C), one warp per row, float32
// statistics: ln = bf16((x - mu) * rstd * gamma + beta) into ln_s (row
// stride C) and, where not null, ln_g; the row's mu and rstd into mean and
// rstd where not null.
template <typename T>
__device__ void layernorm_rows(const T* x, int rows, int C, const float* gamma,
                               const float* beta, bf16* ln_s, bf16* ln_g, float* mean,
                               float* rstd) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const T* xr = x + (size_t)r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f32(xr[c]) - mu;
      v = fmaf(d, d, v);
    }
    const float rs = rsqrtf(warp_sum(v) / C + kLnEps);
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f32(xr[c]) - mu) * rs;
      const bf16 l = __float2bfloat16(xhat * gamma[c] + beta[c]);
      ln_s[r * C + c] = l;
      if (ln_g) ln_g[(size_t)r * C + c] = l;
    }
    if (lane == 0 && mean) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// LayerNorm backward over `rows` rows (pointers at the block's first row):
// dx = dy + (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd with
// dxhat = dln * gamma, one warp per row; then this block's partial sums
// over its rows, in row order, of dln * xhat (dgamma) and dln (dbeta).
// dln is float32 that this kernel wrote earlier (not read-only).
template <typename T>
__device__ void layernorm_bwd_rows(const T* x, const T* dy, const float* dln,
                                   const float* mean, const float* rstd, const float* gamma,
                                   int rows, int C, T* dx, float* dgamma_part,
                                   float* dbeta_part) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const size_t o = (size_t)r * C;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f32(x[o + c]) - mu) * rs;
      const float dxhat = dln[o + c] * gamma[c];
      s1 += dxhat;
      s2 = fmaf(dxhat, xhat, s2);
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f32(x[o + c]) - mu) * rs;
      const float dxhat = dln[o + c] * gamma[c];
      dx[o + c] = from_f32<T>(to_f32(dy[o + c]) + (dxhat - m1 - xhat * m2) * rs);
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t o = (size_t)r * C + c;
      const float d = dln[o];
      sg = fmaf(d, (to_f32(x[o]) - mean[r]) * rstd[r], sg);
      sb += d;
    }
    dgamma_part[c] = sg;
    dbeta_part[c] = sb;
  }
}


// A float32 weight as the three bf16 term arrays of the tensor-core
// products: out[t][r][c] (3 x R x width) is the bf16 rounding of what
// terms 0 .. t-1 left of w(r, c) = w[r * sr + c * sc] for c < K, and zero
// for K <= c < width (rows padded to 16 bytes).  The terms sum to the
// weight exactly (8 + 8 + 8 significant bits).  One 32 x 32 tile per
// block through shared memory, read along whichever of w's strides is 1
// and written along the rows, so that both coalesce for either layout.
__global__ void __launch_bounds__(kThreads)
split_weights_kernel(const float* __restrict__ w, int sr, int sc, int R, int K, int width,
                     bf16* __restrict__ out) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const bool along_r = sc != 1;
  for (int i = ty; i < 32; i += kThreads / 32) {
    const int rl = along_r ? tx : i, cl = along_r ? i : tx;
    const int r = r0 + rl, c = c0 + cl;
    tile[rl][cl] = r < R && c < K ? w[(size_t)r * sr + (size_t)c * sc] : 0.f;
  }
  __syncthreads();
  const size_t n = (size_t)R * width;
  for (int i = ty; i < 32; i += kThreads / 32) {
    const int r = r0 + i, c = c0 + tx;
    if (r >= R || c >= width) continue;
    float x = tile[i][tx];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const bf16 b = __float2bfloat16(x);
      out[t * n + (size_t)r * width + c] = b;
      x -= bf(b);
    }
  }
}

cudaError_t launch_split_weights(const float* w, int sr, int sc, int R, int K, int width,
                                 bf16* out, cudaStream_t stream) {
  split_weights_kernel<<<dim3((width + 31) / 32, (R + 31) / 32), kThreads, 0, stream>>>(
      w, sr, sc, R, K, width, out);
  return cudaGetLastError();
}

// The row stages that K5 (csrc/fused_mlp.cu) and K4's forward
// (csrc/fused_attn.cu) share: the LayerNorm of rows into bf16 rows padded
// to 16 bytes, and the staged tile product with a DropPath residual
// epilogue (K5's fc2; K4's proj: y = x + dp * (ob Wproj^T + bproj)).

// The product tiles the host plan chooses from, per stage (plan ids 0-2):
// rows x columns x k slice, warps as rows x columns, slices in flight.
using TileS = mg::Cfg<64, 64, 64, 2, 2, 3>;    // 4 warps of 32 x 32
using TileM = mg::Cfg<64, 128, 64, 2, 4, 3>;   // 8 warps of 32 x 32
using TileL = mg::Cfg<128, 128, 64, 2, 4, 3>;  // 8 warps of 64 x 32

// f(CF{}) for the tile of plan id `tile`.
template <class F>
cudaError_t with_tile(int tile, F f) {
  if (tile == 0) return f(TileS{});
  if (tile == 1) return f(TileM{});
  if (tile == 2) return f(TileL{});
  return cudaErrorInvalidValue;
}

template <int NB>
using RowOp = mg::Operand<true, NB, 8>;  // k-contiguous, 16-byte rows
template <int NB>
using ColOp = mg::Operand<false, NB, 8>;  // i-contiguous, 16-byte rows

template <class CF, int NB>
constexpr size_t fc_smem() {
  return mg::ring_bytes<CF, RowOp<1>, RowOp<NB>>();
}


int tiles(int n, int t) { return (n + t - 1) / t; }

// LayerNorm of one row xr, by one warp, float32 statistics: out[c] =
// bf16((x - mu) * rstd * gamma + beta) for c < C, zero for C <= c < width
// (C, width <= 32 NV).  The row is read once, into NV registers a lane, and
// its sums taken from there.  Returns (mu, rstd).
template <int NV, typename T>
__device__ __forceinline__ float2 ln_row(const T* __restrict__ xr, int C,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta, bf16* out, int width) {
  const int lane = threadIdx.x & 31;
  float v[NV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float d = v[i] - mu;
    if (lane + 32 * i < C) var = fmaf(d, d, var);
  }
  const float rs = rsqrtf(warp_sum(var) / C + kLnEps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < width)
      out[c] = __float2bfloat16(c < C ? (v[i] - mu) * rs * gamma[c] + beta[c] : 0.f);
  }
  return make_float2(mu, rs);
}

// Rows up to kMaxLnWidth; f(std::integral_constant<int, NV>{}) with NV, the
// registers a lane of ln_row, the least of 4, 8, 12, 20 that holds width.
constexpr int kMaxLnWidth = 640;

template <class F>
cudaError_t with_ln_width(int width, F f) {
  if (width <= 128) return f(std::integral_constant<int, 4>{});
  if (width <= 256) return f(std::integral_constant<int, 8>{});
  if (width <= 384) return f(std::integral_constant<int, 12>{});
  return f(std::integral_constant<int, kMaxLnWidth / 32>{});
}

// LayerNorm of rows [blockIdx.x * rpb, ...) of x, one warp per row: lnb
// at row stride Cp, columns C .. Cp zero.  kBwd: also each row's mean and
// rstd, dob = bf16(dp * dy) (row stride Cp, zero-padded), and this block's
// db2 partial, the float32 do summed over its rows in row order, into
// part[blockIdx.x][2C .. 3C).
template <typename T, bool kBwd, int NV>
__global__ void __launch_bounds__(kThreads)
mlp_ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ dp,
              const T* __restrict__ dy, bf16* __restrict__ lnb, bf16* __restrict__ dob,
              float* __restrict__ mean, float* __restrict__ rstd, float* __restrict__ part,
              int M, int C, int Cp, int tps, int rpb) {
  const int row0 = blockIdx.x * rpb;
  const int rows = min(rpb, M - row0);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const int row = row0 + r;
    const float2 st =
        ln_row<NV>(x + (size_t)row * C, C, gamma, beta, lnb + (size_t)row * Cp, Cp);
    if constexpr (kBwd) {
      const float scale = dp[row / tps];
      const T* dr = dy + (size_t)row * C;
      bf16* dor = dob + (size_t)row * Cp;
      for (int c = lane; c < Cp; c += 32)
        dor[c] = __float2bfloat16(c < C ? scale * to_f32(dr[c]) : 0.f);
      if (lane == 0) {
        mean[row] = st.x;
        rstd[row] = st.y;
      }
    }
  }
  if constexpr (kBwd) {
    float* pv = part + (size_t)blockIdx.x * 3 * C + 2 * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int row = row0 + r;
        s += dp[row / tps] * to_f32(dy[(size_t)row * C + c]);
      }
      pv[c] = s;
    }
  }
}

// Forward (3): y = x + dp[r / tps] * (g W2^T + b2), one (BM, BN) tile of
// the (M, C) output per block.
template <class CF, int NB, typename T>
__global__ void __launch_bounds__(CF::threads)
mlp_fc2_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const T* __restrict__ x,
               const float* __restrict__ dp, T* __restrict__ y, int M, int C, int Hd, int tps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * CF::BN, m0 = blockIdx.y * CF::BM;
  mg::Acc<CF> acc;
  mg::tile_product<CF>(acc, RowOp<1>{g, Hd, 0, M, Hd},
                       RowOp<NB>{w2, Hd, (long long)C * Hd, C, Hd}, Hd, m0, n0,
                       reinterpret_cast<bf16*>(smem));
#pragma unroll
  for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < CF::NT8; ++ni) {
      const int n = n0 + mg::acc_col<CF>(ni, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mg::acc_row<CF>(mi, 2 * h);
        if (m < M && n < C) {
          const size_t o = (size_t)m * C + n;
          const float s = dp[m / tps];
          mg::store2(y + o, to_f32(x[o]) + s * (acc.v[mi][ni][2 * h] + b2[n]),
                     to_f32(x[o + 1]) + s * (acc.v[mi][ni][2 * h + 1] + b2[n + 1]));
        }
      }
    }
}


// Launch kernel on a (column tiles, row tiles) grid of the tile CF with
// smem bytes of shared memory.
template <class CF, class K, class... Args>
cudaError_t launch_tiles(K kernel, size_t smem, int rows, int cols, cudaStream_t stream,
                         Args... args) {
  const cudaError_t opt = allow_smem(kernel, smem);
  if (opt != cudaSuccess) return opt;
  kernel<<<dim3(tiles(cols, CF::BN), tiles(rows, CF::BM)), CF::threads, smem, stream>>>(args...);
  return cudaGetLastError();
}


// out[e] = sum over r < rows of part[r * width + e], for e < width, in a
// fixed order: thread (ry, cx) of a block sums rows ry, ry + 8, ... of
// column 32 * blockIdx.x + cx, then the 8 sums are added in ry order.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* part, float* out, int rows, int width) {
  __shared__ float red[8][33];
  const int cx = threadIdx.x & 31;
  const int ry = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + cx;
  float s = 0.f;
  if (e < width)
    for (int r = ry; r < rows; r += 8) s += part[(size_t)r * width + e];
  red[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && e < width) {
    float t = 0.f;
    for (int i = 0; i < 8; ++i) t += red[i][cx];
    out[e] = t;
  }
}

cudaError_t launch_colsum(const float* part, float* out, int rows, int width,
                          cudaStream_t stream) {
  colsum_kernel<<<(width + 31) / 32, kThreads, 0, stream>>>(part, out, rows, width);
  return cudaGetLastError();
}

// partial[z][p][q] = sum over rows m of chunk z of A[m][p] * B[m][q]
// (A: M x P, row stride lda; B: M x Q, row stride ldb; both bf16, P, Q,
// lda and ldb even): one 128 x 128 output tile and one chunk of rows per
// block, the rows being the product's k.  Both operands are i-contiguous
// operands of the staged product (mlp_gemm.cuh): 64-row slices staged by
// cp.async (16-byte where both row strides and pointers allow it, else
// 4-byte) in a ring, their fragments read with `ldmatrix.trans`.
using AtbCfg = mg::Cfg<128, 128, 64, 2, 4, 3>;

template <int VEC>
__global__ void __launch_bounds__(AtbCfg::threads)
atb_kernel(const bf16* A, int lda, const bf16* B, int ldb, float* partial, int M, int P,
           int Q, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Op = mg::Operand<false, 1, VEC>;
  const int p0 = blockIdx.x * AtbCfg::BM;
  const int q0 = blockIdx.y * AtbCfg::BN;
  const int m0 = blockIdx.z * chunk;
  const int mlen = max(0, min(chunk, M - m0));
  const Op a{A + (size_t)min(m0, M) * lda, lda, 0, P, mlen};
  const Op b{B + (size_t)min(m0, M) * ldb, ldb, 0, Q, mlen};
  mg::Acc<AtbCfg> acc;
  mg::tile_product<AtbCfg>(acc, a, b, mlen, p0, q0, reinterpret_cast<bf16*>(smem));
  float* out = partial + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int mi = 0; mi < acc.MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < acc.NT8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + mg::acc_row<AtbCfg>(mi, 2 * h);
        const int q = q0 + mg::acc_col<AtbCfg>(ni, 0);
        if (p < P && q < Q)
          mg::store2(out + (size_t)p * Q + q, acc.v[mi][ni][2 * h], acc.v[mi][ni][2 * h + 1]);
      }
}

template <int VEC>
cudaError_t launch_atb_kernel(dim3 grid, const bf16* A, int lda, const bf16* B, int ldb,
                              float* partial, int M, int P, int Q, int chunk,
                              cudaStream_t stream) {
  using Op = mg::Operand<false, 1, VEC>;
  constexpr size_t smem = mg::ring_bytes<AtbCfg, Op, Op>();
  static_assert(smem <= kMaxSmem, "atb's ring exceeds the shared memory a block may have");
  const cudaError_t opt = allow_smem(atb_kernel<VEC>, smem);
  if (opt != cudaSuccess) return opt;
  atb_kernel<VEC><<<grid, AtbCfg::threads, smem, stream>>>(A, lda, B, ldb, partial, M, P, Q,
                                                            chunk);
  return cudaGetLastError();
}

// out[e] = sum over z < chunks of part[z * n + e], in z order, one thread
// per element.
__global__ void __launch_bounds__(kThreads)
chunksum_kernel(const float* part, float* out, int chunks, size_t n) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[(size_t)z * n + e];
  out[e] = s;
}

// out (P x Q) = A^T B over all M rows: `splits` chunks of rows summed by
// atb_kernel into `partial` (splits * P * Q floats), then added in chunk
// order (one chunk: straight into out).  Deterministic: no sum depends on
// the order blocks run in.
cudaError_t launch_atb(const bf16* A, int lda, const bf16* B, int ldb, float* out,
                       float* partial, int M, int P, int Q, int splits, cudaStream_t stream) {
  int chunk = (M + splits - 1) / splits;
  chunk = (chunk + AtbCfg::BK - 1) / AtbCfg::BK * AtbCfg::BK;
  const dim3 grid((P + AtbCfg::BM - 1) / AtbCfg::BM, (Q + AtbCfg::BN - 1) / AtbCfg::BN, splits);
  const bool wide = lda % 8 == 0 && ldb % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(B) % 16 == 0;
  float* dst = splits == 1 ? out : partial;
  cudaError_t err = wide ? launch_atb_kernel<8>(grid, A, lda, B, ldb, dst, M, P, Q, chunk, stream)
                         : launch_atb_kernel<2>(grid, A, lda, B, ldb, dst, M, P, Q, chunk, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)P * Q;
  chunksum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partial, out, splits, n);
  return cudaGetLastError();
}

}  // namespace
