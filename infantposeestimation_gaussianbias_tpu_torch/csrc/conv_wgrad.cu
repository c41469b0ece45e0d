// K6: the weight gradient of a SAME stride-1 3x3 NHWC convolution, for
// Hopper.
//
// Replaces the TPU kernel `conv3x3_wgrad` (body `_wgrad_kernel`, call
// conv_wgrad.py:106) in
// infantposeestimation_gaussianbias_tpu/ops/pallas/conv_wgrad.py.
//
// Contract (kernels/conv_wgrad.py): x (B, H, W, Ci) and dy (B, H, W, Co),
// both in T (float or bf16) ->
//   dW[dh][dw][ci][co] = sum over (b, h, w) of x[b, h+dh-1, w+dw-1, ci] * dy[b, h, w, co]
// in float32 (zero outside the map), the (3, 3, Ci, Co) layout: as a matrix,
// dW = A^T dy over the M = B*H*W pixels, A (M, 9Ci) the im2col of x.
//
// What bounds it: 2 * M * 9 * Ci * Co FLOPs against one read of x and dy
// (M * (Ci + Co) elements): ~9 Ci Co / (Ci + Co) FLOP per byte in bf16,
// 72 at Ci = Co = 32 (bytes bound it) and 576 at 256 (operations bound
// it).  The TPU kernel carried dW across a sequential grid in its output
// block and built the dy shifts as offset windows of a flattened padded
// row space.  On the card blocks run in parallel, so the M-long reduction
// is cut into `splits` chunks of rows: one block per (64 x 64 tile of dW,
// chunk) sums its chunk into its own partial, and a second kernel adds the
// partials in chunk order (fused_common.cuh `launch_colsum`):
// deterministic, no atomics.  Within a block, slices of 64 pixels of the
// im2col of x (gathered with its zero padding) and of dy are staged in
// shared memory; the products run on the tensor cores (mma.sync bf16 x
// bf16 -> f32) for bf16 inputs and in float32 FMAs for float32 ones.

#include <type_traits>

#include "fused_common.cuh"

namespace {

constexpr int kRows = 64;          // pixels per staged slice
constexpr int kLdS = 64 + 8;       // bf16 row stride of the staged slices
constexpr int kLdF = 64 + 4;       // float row stride (keeps float4 alignment)

struct Geom {
  int B, H, W, Ci, Co;
};

// partial[z][p][q] = sum over the pixels m of chunk z of A[m][p] * dy[m][q],
// A the im2col of x; P = 9 Ci rows, Q = Co columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial,
             Geom g, int chunk) {
  const int M = g.B * g.H * g.W, P = 9 * g.Ci, Q = g.Co, hw = g.H * g.W;
  const int p0 = blockIdx.x * 64, q0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * chunk;
  const int mlen = max(0, min(chunk, M - m0));
  float* out = partial + (size_t)blockIdx.z * P * Q;
  // Each thread stages one column pair c of both slices, the same in every
  // slice: its tap (of x's im2col) and its offset from a pixel's (h, w, 0)
  // element are worked out once; each slice's pixels' (h, w) once a slice.
  const int c = (threadIdx.x & 31) * 2, r0 = threadIdx.x >> 5;
  const bool pin = p0 + c < P, qin = q0 + c < Q;
  const int tap = (p0 + c) / g.Ci;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const int delta = (dh * g.W + dw) * g.Ci + (p0 + c - tap * g.Ci);
  __shared__ int sh[kRows], sw[kRows];
  auto slice_pixels = [&](int k0) {
    if (threadIdx.x < kRows) {
      const int r = (m0 + k0 + threadIdx.x) % hw;
      sh[threadIdx.x] = r / g.W;
      sw[threadIdx.x] = r % g.W;
    }
    __syncthreads();
  };
  // x's im2col pair and dy's pair at row r of the slice at k0, as floats
  auto pairs = [&](int k0, int r, float2& a, float2& d) {
    a = d = make_float2(0.f, 0.f);
    if (k0 + r >= mlen) return;
    const size_t m = (size_t)m0 + k0 + r;
    const int h = sh[r] + dh, w = sw[r] + dw;
    if (pin && h >= 0 && h < g.H && w >= 0 && w < g.W) {
      const T* q = x + m * g.Ci + delta;
      a = make_float2(to_f32(q[0]), to_f32(q[1]));
    }
    if (qin) {
      const T* q = dy + m * Q + q0 + c;
      d = make_float2(to_f32(q[0]), to_f32(q[1]));
    }
  };

  if constexpr (std::is_same<T, bf16>::value) {
    __shared__ __align__(16) bf16 sa[kRows][kLdS];
    __shared__ __align__(16) bf16 sb[kRows][kLdS];
    float acc[4][kTN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < mlen; k0 += kRows) {
      slice_pixels(k0);
#pragma unroll
      for (int r = r0; r < kRows; r += kThreads / 32) {
        float2 a, d;
        pairs(k0, r, a, d);
        *reinterpret_cast<uint32_t*>(&sa[r][c]) = pack(a.x, a.y);
        *reinterpret_cast<uint32_t*>(&sb[r][c]) = pack(d.x, d.y);
      }
      __syncthreads();
      mma_tile<64, 1, true>(
          acc, kRows, [&](int p, int k) { return pack_bits(sa[k][p], sa[k + 1][p]); },
          [&](int q, int k, uint32_t (&o)[1]) { o[0] = pack_bits(sb[k][q], sb[k + 1][q]); });
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tile_row<64>(i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int q = q0 + tile_col(j);
        if (p < P && q < Q) out[(size_t)p * Q + q] = acc[i][j];
      }
    }
  } else {
    // float32: 4 x 4 outputs a thread (rows p ty*4.., columns q tx*4..)
    __shared__ __align__(16) float sa[kRows][kLdF];
    __shared__ __align__(16) float sb[kRows][kLdF];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < mlen; k0 += kRows) {
      slice_pixels(k0);
#pragma unroll
      for (int r = r0; r < kRows; r += kThreads / 32) {
        float2 a, d;
        pairs(k0, r, a, d);
        sa[r][c] = a.x;
        sa[r][c + 1] = a.y;
        sb[r][c] = d.x;
        sb[r][c + 1] = d.y;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kRows; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(ar[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(ar[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(ar[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(ar[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + tx * 4 + j;
        if (p < P && q < Q) out[(size_t)p * Q + q] = acc[i][j];
      }
    }
  }
}

template <typename T>
cudaError_t run_wgrad(const T* x, const T* dy, float* out, float* partial, Geom g, int splits,
                      cudaStream_t stream) {
  const int M = g.B * g.H * g.W, P = 9 * g.Ci, Q = g.Co;
  int chunk = (M + splits - 1) / splits;
  chunk = (chunk + kRows - 1) / kRows * kRows;
  dim3 grid((P + 63) / 64, (Q + kBN - 1) / kBN, splits);
  wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(x, dy, partial, g, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, out, splits, P * Q, stream);
}

}  // namespace

// code: 0 float32, 1 bf16.  out: 9 * Ci * Co floats, the (3, 3, Ci, Co)
// layout; partial: splits * 9 * Ci * Co floats.  Returns the first launch
// error.
extern "C" int ipe_conv3x3_wgrad(const void* x, const void* dy, float* out, float* partial,
                                 int B, int H, int W, int Ci, int Co, int splits, int code,
                                 void* stream) {
  const Geom g{B, H, W, Ci, Co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      code == 0 ? run_wgrad(static_cast<const float*>(x), static_cast<const float*>(dy), out,
                            partial, g, splits, s)
                : run_wgrad(static_cast<const bf16*>(x), static_cast<const bf16*>(dy), out,
                            partial, g, splits, s);
  return static_cast<int>(err);
}
