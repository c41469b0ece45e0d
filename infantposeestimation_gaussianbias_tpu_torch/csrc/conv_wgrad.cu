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
// it).  The TPU kernel staged each padded image once and took all nine
// taps from that one copy as row offsets, carrying dW across a sequential
// grid.  On the card blocks run in parallel, so the M-long reduction is
// cut into `splits` chunks of pixel bands, each chunk's partial dW is
// written, and fused_common.cuh `launch_colsum` adds the partials in
// chunk order: deterministic, no atomics.
//
// bf16 (the record dtype), `wgrad_band_kernel`: a block takes one
// (kTCi x TCO) tile of (Ci, Co) for all nine taps and a chunk of bands, a
// band being R pixel rows of one image.  Per band it stages, once, by
// cp.async into shared memory, the x rows of the band plus a one-row
// halo above and below and a one-column halo left and right, and the dy
// rows of the band; the halo and everything outside the map or past Ci,
// Co are zero-filled (source size 0).  Warp t (of nine) takes tap t =
// (dh, dw): its A fragments (the tile's channels x 16 pixels) come with
// `ldmatrix.trans` from the staged x rows at the tap's shift, one row
// address per lane, its B fragments from the staged dy rows, and its
// (kTCi x TCO) sums stay in registers over the whole chunk, products on
// the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32).  The next
// band is staged while this one is multiplied (two buffers).  So x is
// read once per band and (Ci, Co) tile, plus the halo, where the first
// version gathered it from device memory once per tap and per 64-wide
// tile of dW.  Shapes where a channel count is not a multiple of 8 stage
// with 4-byte cp.async.  The host plan (kernels/conv_wgrad.py
// `wgrad_plan`) picks R, TCO and the splits.
//
// float32, `wgrad_f32_kernel`: the first version's CUDA-core route (64 x
// 64 tiles of dW, 64-pixel slices of the im2col gathered into shared
// memory, float32 FMAs), which keeps the float32 products exact without
// bf16 terms.

#include "fused_common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kBandThreads = 32 * kTaps;  // one warp per tap
constexpr int kTCi = 32;                  // input channels of a tile
constexpr int kZeros = 64;                // bf16 zeros that padded pixels read

struct Geom {
  int B, H, W, Ci, Co;
};

// The bf16 kernel's shared memory: two buffers of [x rows (R+2) x (W+2),
// row stride kTCi + 8 | dy rows R x W, row stride TCO + 8], then the zeros.
__host__ __device__ constexpr int x_ld() { return kTCi + 8; }
__host__ __device__ constexpr int d_ld(int tco) { return tco + 8; }

__host__ __device__ size_t band_buffer_elems(int R, int W, int tco) {
  return (size_t)(R + 2) * (W + 2) * x_ld() + (size_t)R * W * d_ld(tco);
}

size_t band_smem(int R, int W, int tco) {
  return sizeof(bf16) * (2 * band_buffer_elems(R, W, tco) + kZeros);
}

// partial[z] (9 Ci x Co) = the chunk z of bands' share of dW, this block's
// (ci0.., co0..) tile of every tap.  Band b (0 <= b < B * nb) is rows
// [(b % nb) R, ...) of image b / nb; chunk z holds bands [z bpc, (z+1) bpc).
template <int TCO, int VEC>
__global__ void __launch_bounds__(kBandThreads, 2)
wgrad_band_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  float* __restrict__ partial, Geom g, int R, int bpc) {
  constexpr int MT = kTCi / 16, NT8 = TCO / 8;
  constexpr int XLD = x_ld(), DLD = d_ld(TCO);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);
  const int W = g.W, WP = W + 2, nb = (g.H + R - 1) / R, nci = (g.Ci + kTCi - 1) / kTCi;
  const size_t belems = band_buffer_elems(R, W, TCO);
  bf16* zeros = buf + 2 * belems;
  const int ci0 = (blockIdx.x % nci) * kTCi, co0 = (blockIdx.x / nci) * TCO;
  const int b_first = blockIdx.y * bpc, b_end = min(g.B * nb, b_first + bpc);
  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int dh = tap / 3, dw = tap % 3;
  for (int i = tid; i < kZeros; i += kBandThreads) zeros[i] = __float2bfloat16(0.f);

  // Band b into buffer s: every element written (data or zero).
  auto stage = [&](int b, bf16* s) {
    const int img = b / nb, r0 = (b % nb) * R;
    const size_t img0 = (size_t)img * g.H * W;
    constexpr int XV = kTCi / VEC, DV = TCO / VEC;
    for (int v = tid; v < (R + 2) * WP * XV; v += kBandThreads) {
      const int cell = v / XV, c = (v - cell * XV) * VEC;
      const int pi = cell / WP, pj = cell - pi * WP;
      const int row = r0 + pi - 1, col = pj - 1;
      const bool ok = row >= 0 && row < g.H && col >= 0 && col < W && ci0 + c < g.Ci;
      const bf16* src = ok ? x + ((img0 + (size_t)row * W + col) * g.Ci + ci0 + c) : x;
      mg::cp_async<VEC>(s + cell * XLD + c, src, ok);
    }
    bf16* sd = s + (size_t)(R + 2) * WP * XLD;
    for (int v = tid; v < R * W * DV; v += kBandThreads) {
      const int p = v / DV, c = (v - p * DV) * VEC;
      const int row = r0 + p / W;
      const bool ok = row < g.H && co0 + c < g.Co;
      const bf16* src =
          ok ? dy + ((img0 + (size_t)r0 * W + p) * g.Co + co0 + c) : dy;
      mg::cp_async<VEC>(sd + p * DLD + c, src, ok);
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // Lane l's pixels of a k16 step: A (ldmatrix.trans of x) rows pa, B
  // (of dy) rows pb, offsets from the step's first pixel.
  const int pa = (lane & 7) + 8 * (lane >> 4), pb = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ca = 8 * ((lane >> 3) & 1), cb = 8 * (lane >> 4);
  if (b_first < b_end) stage(b_first, buf);
  mg::cp_commit();
  for (int b = b_first; b < b_end; ++b) {
    const int slot = (b - b_first) & 1;
    if (b + 1 < b_end) stage(b + 1, buf + (1 - slot) * belems);
    mg::cp_commit();
    mg::cp_wait<1>();
    __syncthreads();  // band b landed for every thread
    const bf16* sx = buf + slot * belems;
    const bf16* sd = sx + (size_t)(R + 2) * WP * XLD;
    const int npix = min(R, g.H - (b % nb) * R) * W;
    // (ia, ja): pixel pa's row and column in the band, advanced 16 a step
    int ia = pa / W, ja = pa - (pa / W) * W;
    for (int k0 = 0; k0 < npix; k0 += 16) {
      const bf16* xa = k0 + pa < npix ? sx + ((ia + dh) * WP + ja + dw) * XLD + ca : zeros + ca;
      const bf16* db = k0 + pb < npix ? sd + (k0 + pb) * DLD + cb : zeros + cb;
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mg::ldsm_t(a[mi], xa + mi * 16);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t bb[4];
        mg::ldsm_t(bb, db + np * 16);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mg::mma(acc[mi][2 * np], a[mi], bb[0], bb[1]);
          mg::mma(acc[mi][2 * np + 1], a[mi], bb[2], bb[3]);
        }
      }
      ja += 16;
      while (ja >= W) {
        ja -= W;
        ++ia;
      }
    }
    __syncthreads();  // every warp done with band b's buffer
  }
  mg::cp_wait<0>();

  // This tap's tile: rows tap * Ci + ci, columns co.
  float* out = partial + (size_t)blockIdx.y * kTaps * g.Ci * g.Co;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + mi * 16 + gq + 8 * h, co = co0 + ni * 8 + 2 * tq;
        if (ci < g.Ci && co < g.Co)
          mg::store2(out + ((size_t)tap * g.Ci + ci) * g.Co + co, acc[mi][ni][2 * h],
                     acc[mi][ni][2 * h + 1]);
      }
}

// float32: partial[z][p][q] = sum over the pixels m of chunk z of A[m][p] *
// dy[m][q], A the im2col of x; P = 9 Ci rows, Q = Co columns; 4 x 4
// outputs a thread (rows p ty*4.., columns q tx*4..).
constexpr int kRows = 64;     // pixels per staged slice
constexpr int kLdF = 64 + 4;  // float row stride (keeps float4 alignment)

__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ partial, Geom g, int chunk) {
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
  __shared__ __align__(16) float sa[kRows][kLdF];
  __shared__ __align__(16) float sb[kRows][kLdF];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < mlen; k0 += kRows) {
    if (threadIdx.x < kRows) {
      const int r = (m0 + k0 + threadIdx.x) % hw;
      sh[threadIdx.x] = r / g.W;
      sw[threadIdx.x] = r % g.W;
    }
    __syncthreads();
#pragma unroll
    for (int r = r0; r < kRows; r += kThreads / 32) {
      // x's im2col pair and dy's pair at row r of the slice
      float2 a = make_float2(0.f, 0.f), d = make_float2(0.f, 0.f);
      if (k0 + r < mlen) {
        const size_t m = (size_t)m0 + k0 + r;
        const int h = sh[r] + dh, w = sw[r] + dw;
        if (pin && h >= 0 && h < g.H && w >= 0 && w < g.W)
          a = *reinterpret_cast<const float2*>(x + m * g.Ci + delta);
        if (qin) d = *reinterpret_cast<const float2*>(dy + m * Q + q0 + c);
      }
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

// The bf16 kernel for (TCO, VEC) on grid, into dst.
template <int TCO, int VEC>
cudaError_t launch_band(const bf16* x, const bf16* dy, float* dst, Geom g, int R, int bpc,
                        dim3 grid, cudaStream_t stream) {
  const size_t smem = band_smem(R, g.W, TCO);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t opt = allow_smem(wgrad_band_kernel<TCO, VEC>, smem);
  if (opt != cudaSuccess) return opt;
  wgrad_band_kernel<TCO, VEC><<<grid, kBandThreads, smem, stream>>>(x, dy, dst, g, R, bpc);
  return cudaGetLastError();
}

// bf16: R band rows, tco output channels a tile (32 or 64), bpc bands a
// chunk; float32: chunk pixels a chunk.  splits partials are summed into
// out (one: written there straight).
cudaError_t run_bf16(const bf16* x, const bf16* dy, float* out, float* partial, Geom g, int R,
                     int tco, int bpc, cudaStream_t stream) {
  const int nb = (g.H + R - 1) / R, bands = g.B * nb;
  const int splits = (bands + bpc - 1) / bpc;
  const dim3 grid(((g.Ci + kTCi - 1) / kTCi) * ((g.Co + tco - 1) / tco), splits);
  const bool wide = g.Ci % 8 == 0 && g.Co % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  float* dst = splits == 1 ? out : partial;
  cudaError_t err;
  if (tco == 32)
    err = wide ? launch_band<32, 8>(x, dy, dst, g, R, bpc, grid, stream)
               : launch_band<32, 2>(x, dy, dst, g, R, bpc, grid, stream);
  else if (tco == 64)
    err = wide ? launch_band<64, 8>(x, dy, dst, g, R, bpc, grid, stream)
               : launch_band<64, 2>(x, dy, dst, g, R, bpc, grid, stream);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return launch_colsum(partial, out, splits, kTaps * g.Ci * g.Co, stream);
}

cudaError_t run_f32(const float* x, const float* dy, float* out, float* partial, Geom g,
                    int splits, cudaStream_t stream) {
  const int M = g.B * g.H * g.W, P = 9 * g.Ci, Q = g.Co;
  int chunk = (M + splits - 1) / splits;
  chunk = (chunk + kRows - 1) / kRows * kRows;
  dim3 grid((P + 63) / 64, (Q + kBN - 1) / kBN, splits);
  wgrad_f32_kernel<<<grid, kThreads, 0, stream>>>(x, dy, partial, g, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, out, splits, P * Q, stream);
}

}  // namespace

// code: 0 float32, 1 bf16.  out: 9 * Ci * Co floats, the (3, 3, Ci, Co)
// layout; partial: splits * 9 * Ci * Co floats.  bf16 (the plan's
// choice): R band rows, tco (32 or 64) output channels a tile, bpc bands
// a chunk, splits = ceil(B ceil(H / R) / bpc); float32: splits chunks of
// pixels (R, tco, bpc unused).  Returns the first launch error.
extern "C" int ipe_conv3x3_wgrad(const void* x, const void* dy, float* out, float* partial,
                                 int B, int H, int W, int Ci, int Co, int splits, int R,
                                 int tco, int bpc, int code, void* stream) {
  const Geom g{B, H, W, Ci, Co};
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Ci % 2 || Co % 2 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code == 0)
    return (int)run_f32(static_cast<const float*>(x), static_cast<const float*>(dy), out,
                        partial, g, splits, s);
  if (code != 1 || R <= 0 || bpc <= 0 || (B * ((H + R - 1) / R) + bpc - 1) / bpc != splits)
    return (int)cudaErrorInvalidValue;
  return (int)run_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(dy), out, partial,
                       g, R, tco, bpc, s);
}
