// K7: the fused HRNet residual chain (BasicBlocks, inference), for Hopper.
//
// Replaces the TPU kernel `fused_residual_chain` (body `_chain_kernel`,
// call residual_block.py:87) in
// infantposeestimation_gaussianbias_tpu/ops/pallas/residual_block.py.
//
// Contract (kernels/residual_block.py), on x (B, H, W, C) NHWC in T (float
// or bf16), weights (2n, 9C, C) in WT (float or bf16; taps in (dy, dx, c)
// order, the im2col layout) and affines (2n, 2, C) float32, the TPU
// kernel's arithmetic:
//   xf = float(x)
//   for each block b:  y  = relu(conv3x3(WT(xf), w[2b]) * a + b)        f32
//                      xf = relu(conv3x3(WT(y), w[2b+1]) * a + b + xf)  f32
//   out = T(xf)
// Every conv is SAME (zero padding) and stride 1; its products take both
// operands in WT and accumulate in float32.
//
// What bounds it: 8 convs of 2 * (B*H*W) * 9C * C FLOPs per chain against
// the chain's input and output maps (its weights besides): at C = 32 the
// work is ~9C/2 = 144 FLOP per byte of bf16 map, below the H100's ridge
// (~295), so bytes and operations come close; at C >= 64 operations bound
// it.  The TPU kept a whole image's chain in VMEM; on the card a branch-0
// map (64 x 48 x 32, 393 KB in float32) does not fit a block's 227 KB of
// shared memory and 32 images would not fill 132 SMs.  So each conv is its
// own launch of a tiled implicit GEMM (M = B*H*W pixels, N = C, K = 9C):
// one block per 64 pixels x 64 output channels, the im2col operand gathered
// with its zero padding into shared memory chunk by chunk (each pixel's
// (h, w) worked out once per block, each thread's tap once per chunk), products on the
// tensor cores (mma.sync bf16 x bf16 -> f32, fused_common.cuh) for bf16
// weights and float32 FMAs for float32 ones.  The float32 carry and the
// block-internal y live in device scratch between launches (12.6 + 6.3 MB
// at branch 0, b = 32: they stay in the 50 MB L2), and the BN affine,
// ReLU and residual run in each conv's epilogue.

#include <type_traits>

#include "fused_common.cuh"

namespace {

constexpr int kBM = 64;          // pixels per output tile
constexpr int kKC = 64;          // k (tap, channel) per staged chunk
constexpr int kPairs = kKC / 2;  // k pairs per staged row
constexpr int kLd = kKC + 8;     // bf16 row stride of the staged chunks
constexpr int kLdF = kKC + 1;    // float row stride of the staged A chunk

struct Geom {
  int B, H, W, C;
};

// The block's pixels: their (h, w) and index m (-1 past the last pixel),
// so that staging needs no division per element.
struct Pixels {
  int h[kBM], w[kBM], m[kBM];
};

__device__ __forceinline__ void load_pixels(Pixels& px, const Geom g, int m0) {
  if (threadIdx.x < kBM) {
    const int m = m0 + threadIdx.x;
    const int hw = g.H * g.W;
    const bool in = m < g.B * hw;
    const int r = m % hw;
    px.m[threadIdx.x] = in ? m : -1;
    px.h[threadIdx.x] = r / g.W;
    px.w[threadIdx.x] = r % g.W;
  }
  __syncthreads();
}

// Where a thread's k (one (tap, channel) pair, k even, C even) reads: the
// tap's shift and the element offset from a pixel's (h, w, 0) element;
// dh = -2 marks k past K = 9C.
struct Tap {
  int dh, dw, delta;
};

__device__ __forceinline__ Tap tap_of(const Geom g, int k) {
  const int tap = k / g.C;
  if (tap >= 9) return Tap{-2, 0, 0};
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  return Tap{dh, dw, (dh * g.W + dw) * g.C + (k - tap * g.C)};
}

// The im2col pair (k, k + 1) of the block's pixel r, as floats; zero in
// the padding, past the last pixel and past K.
template <typename TA>
__device__ __forceinline__ float2 im2col_pair(const TA* src, const Geom g, const Pixels& px,
                                              int r, Tap t) {
  const int h = px.h[r] + t.dh, w = px.w[r] + t.dw;
  if (t.dh < -1 || px.m[r] < 0 || h < 0 || h >= g.H || w < 0 || w >= g.W)
    return make_float2(0.f, 0.f);
  const TA* p = src + (size_t)px.m[r] * g.C + t.delta;
  return make_float2(to_f32(p[0]), to_f32(p[1]));
}

// One 3x3 conv of the chain: dst = epilogue(conv(src, w) * a + b).  With
// `res` null (a block's first conv): dst = relu(.); else dst = relu(. +
// res).  res and dst may be the same buffer: each element is read and then
// written by one thread, and no other reads it in this launch.
template <typename TA, typename WT, typename TR, typename TO>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const TA* __restrict__ src, const WT* __restrict__ w,
            const float* __restrict__ ab, const TR* res, TO* dst, Geom g) {
  const int M = g.B * g.H * g.W, C = g.C, K = 9 * g.C;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* a = ab;
  const float* bb = ab + C;
  auto emit = [&](int ml, int nl, float v) {
    const int m = m0 + ml, n = n0 + nl;
    if (m >= M || n >= C) return;
    const size_t o = (size_t)m * C + n;
    v = __fadd_rn(__fmul_rn(v, a[n]), bb[n]);
    if (res) v = __fadd_rn(v, to_f32(res[o]));
    dst[o] = from_f32<TO>(fmaxf(v, 0.f));
  };

  __shared__ Pixels px;
  load_pixels(px, g, m0);
  // each thread stages one k pair of rows r0, r0 + kRowStep, ... of A
  const int kp = (threadIdx.x % kPairs) * 2, r0 = threadIdx.x / kPairs;
  constexpr int kRowStep = kThreads / kPairs;

  if constexpr (std::is_same<WT, bf16>::value) {
    __shared__ __align__(16) bf16 sa[kBM][kLd];   // im2col chunk, pixel x k
    __shared__ __align__(16) bf16 sb[kBN][kLd];   // weight chunk, n x k
    float acc[kBM / 16][kTN];
#pragma unroll
    for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      const Tap t = tap_of(g, k0 + kp);
#pragma unroll
      for (int r = r0; r < kBM; r += kRowStep) {
        const float2 v = im2col_pair(src, g, px, r, t);
        *reinterpret_cast<uint32_t*>(&sa[r][kp]) = pack(v.x, v.y);
      }
      for (int e = threadIdx.x; e < kBN * kPairs; e += kThreads) {
        const int n = e % kBN, kq = (e / kBN) * 2, k = k0 + kq;
        const bool in = n0 + n < C;
        const bf16 lo = in && k < K ? w[(size_t)k * C + n0 + n] : __float2bfloat16(0.f);
        const bf16 hi = in && k + 1 < K ? w[(size_t)(k + 1) * C + n0 + n] : __float2bfloat16(0.f);
        *reinterpret_cast<uint32_t*>(&sb[n][kq]) = pack_bits(lo, hi);
      }
      __syncthreads();
      mma_tile<kBM, 1, true>(
          acc, kKC, [&](int m, int k) { return *reinterpret_cast<const uint32_t*>(&sa[m][k]); },
          [&](int n, int k, uint32_t (&o)[1]) {
            o[0] = *reinterpret_cast<const uint32_t*>(&sb[n][k]);
          });
    }
#pragma unroll
    for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) emit(tile_row<kBM>(i), tile_col(j), acc[i][j]);
  } else {
    // float32 weights: float32 x float32 products in FMAs, 4 x 4 outputs a
    // thread (pixels ty*4.., channels tx*4..).
    __shared__ float sa[kBM][kLdF];
    __shared__ __align__(16) float sb[kKC][kBN];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kKC) {
      const Tap t = tap_of(g, k0 + kp);
#pragma unroll
      for (int r = r0; r < kBM; r += kRowStep) {
        const float2 v = im2col_pair(src, g, px, r, t);
        sa[r][kp] = v.x;
        sa[r][kp + 1] = v.y;
      }
      for (int e = threadIdx.x; e < kKC * kBN; e += kThreads) {
        const int kk = e / kBN, n = e % kBN, k = k0 + kk;
        sb[kk][n] = (k < K && n0 + n < C) ? to_f32(w[(size_t)k * C + n0 + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = sa[ty * 4 + i][kk];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) emit(ty * 4 + i, tx * 4 + j, acc[i][j]);
  }
}

template <typename TA, typename WT, typename TR, typename TO>
cudaError_t launch_conv(const TA* src, const WT* w, const float* ab, const TR* res, TO* dst,
                        Geom g, cudaStream_t stream) {
  const int M = g.B * g.H * g.W;
  dim3 grid((M + kBM - 1) / kBM, (g.C + kBN - 1) / kBN);
  conv_kernel<TA, WT, TR, TO><<<grid, kThreads, 0, stream>>>(src, w, ab, res, dst, g);
  return cudaGetLastError();
}

// The chain: per block a first conv (x or the carry -> y) and a second
// (y -> the carry, or the output after the last block).
template <typename T, typename WT>
cudaError_t run_chain(const T* x, const WT* w, const float* ab, T* out, float* carry, WT* y,
                      Geom g, int nblocks, cudaStream_t s) {
  const size_t wsz = (size_t)9 * g.C * g.C, asz = (size_t)2 * g.C;
  const float* none = nullptr;
  cudaError_t err = cudaSuccess;
  for (int blk = 0; blk < nblocks && err == cudaSuccess; ++blk) {
    const WT* w1 = w + (2 * blk) * wsz;
    const WT* w2 = w + (2 * blk + 1) * wsz;
    const float* ab1 = ab + (2 * blk) * asz;
    const float* ab2 = ab + (2 * blk + 1) * asz;
    const bool first = blk == 0, last = blk == nblocks - 1;
    err = first ? launch_conv(x, w1, ab1, none, y, g, s)
                : launch_conv(static_cast<const float*>(carry), w1, ab1, none, y, g, s);
    if (err != cudaSuccess) break;
    const WT* yc = y;
    if (first && last) err = launch_conv(yc, w2, ab2, x, out, g, s);
    else if (first) err = launch_conv(yc, w2, ab2, x, carry, g, s);
    else if (last) err = launch_conv(yc, w2, ab2, static_cast<const float*>(carry), out, g, s);
    else err = launch_conv(yc, w2, ab2, static_cast<const float*>(carry), carry, g, s);
  }
  return err;
}

}  // namespace

// x_code / w_code: 0 float32, 1 bf16.  carry: B*H*W*C floats; y: B*H*W*C
// elements of the weights' type.  Returns the first launch error.
extern "C" int ipe_residual_chain(const void* x, const void* w, const float* ab, void* out,
                                  float* carry, void* y, int B, int H, int W, int C,
                                  int nblocks, int x_code, int w_code, void* stream) {
  const Geom g{B, H, W, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_code == 0 && w_code == 0)
    err = run_chain(static_cast<const float*>(x), static_cast<const float*>(w), ab,
                    static_cast<float*>(out), carry, static_cast<float*>(y), g, nblocks, s);
  else if (x_code == 0)
    err = run_chain(static_cast<const float*>(x), static_cast<const bf16*>(w), ab,
                    static_cast<float*>(out), carry, static_cast<bf16*>(y), g, nblocks, s);
  else if (w_code == 0)
    err = run_chain(static_cast<const bf16*>(x), static_cast<const float*>(w), ab,
                    static_cast<bf16*>(out), carry, static_cast<float*>(y), g, nblocks, s);
  else
    err = run_chain(static_cast<const bf16*>(x), static_cast<const bf16*>(w), ab,
                    static_cast<bf16*>(out), carry, static_cast<bf16*>(y), g, nblocks, s);
  return static_cast<int>(err);
}
