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
// shared memory and 32 images would not fill 132 SMs, so each conv is its
// own launch and the float32 carry, its bf16 rounding and the block-
// internal y live in device scratch between launches (at branch 0, b = 32:
// 12.6 + 6.3 + 6.3 MB, which stay in the 50 MB L2).
//
// bf16 weights (the record route), `conv_tc_kernel<TCO, WHOLE>`: one
// block of 4 warps per (pixel tile, slab of TCO output channels), the
// tiles from the host plan (kernels/residual_block.py `chain_plan`).  A
// pixel tile is R whole rows of one image (a band; the last band of an
// image may be shorter) or whole images; its input rows are staged once,
// with a one-pixel halo, into shared memory by 16-byte cp.async (4-byte
// where C % 8 != 0), the halo, everything off the map and the channels
// from C to C rounded up to 16 zero-filled (source size 0).  The nine taps
// read their A fragments from that one copy with `ldmatrix`, one row
// address per lane at the tap's shift (a tile of whole images holds row
// addresses into each staged image).  The weights' (9C, TCO) slab is
// staged whole where it fits beside the tile (C <= 64), else as a
// cp.async ring of 64-row k slices that loads the next slices while this
// one is multiplied.  K covers 9C exactly (C a multiple of 16; otherwise
// each tap is padded to the next 16).  Where whole rows would leave too
// few tiles to fill the card (b3's 8 x 6 maps, where a one-image tile of
// 64 channels streams 295 KB of weights for 48 pixels), the plan takes
// larger tiles and cuts the input channels into `parts` ranges, one block
// each (K split: each stages only its channels of the tile and its rows of
// the slab); the parts' float32 sums meet in device scratch and the tile's
// last block adds them in part order, so the result does not depend on
// which block finishes last.  Products are mma.sync m16n8k16,
// bf16 x bf16 -> float32; the epilogue keeps the TPU kernel's order
// (__fmul_rn, __fadd_rn, the residual, then ReLU) and stores element
// pairs as one 8-byte (float32) or 4-byte (bf16) store.  A block's second
// conv writes the float32 carry and its bf16 rounding WT(xf), which the
// next block's first conv stages by cp.async, so the float32 carry is read
// only as the residual (the rounding is the same round-to-nearest-even,
// done once, so the bits are those of the rounding at the next conv).
// What the first version lost, and this design removes: half of the
// tensor work at C = 32 multiplied zeros (64-wide output tiles); each input
// element was gathered from device memory as 4-byte pairs, with a bounds
// test per element, once per tap and output tile; every block restaged
// the weights with 2-byte loads; staging and products did not overlap;
// fragments came from scalar shared loads; b3's 96 blocks left a third of
// the SMs idle.
//
// float32 weights, `conv_f32_kernel`: the first version's CUDA-core route
// (64 x 64 tiles of an implicit GEMM, the im2col gathered into shared
// memory chunk by chunk, float32 FMAs), which keeps the float32 products
// exact.

#include <algorithm>
#include <type_traits>

#include "fused_common.cuh"

namespace {

struct Geom {
  int B, H, W, C;
};

// ---------------------------------------------------------------------------
// bf16 weights: the halo-staged tensor-core conv.

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kBK = 64;      // weight rows (k) per staged slice
constexpr int kStages = 4;   // slices in flight in the ring

// The warps of a TCO-wide slab: WM (pixel slabs) x WN (channel groups);
// each warp holds MTW m16 slabs x NTW n8 tiles of accumulators, slab s of
// the tile going to warp row s % WM.  BM: the most pixels a tile holds.
template <int TCO>
struct TcCfg;
template <> struct TcCfg<16> { static constexpr int WN = 1, MTW = 4; };
template <> struct TcCfg<32> { static constexpr int WN = 1, MTW = 4; };
template <> struct TcCfg<48> { static constexpr int WN = 1, MTW = 3; };
template <> struct TcCfg<64> { static constexpr int WN = 2, MTW = 4; };
template <> struct TcCfg<96> { static constexpr int WN = 2, MTW = 3; };
template <> struct TcCfg<128> { static constexpr int WN = 4, MTW = 4; };

template <int TCO>
struct Tc {
  static constexpr int WN = TcCfg<TCO>::WN, MTW = TcCfg<TCO>::MTW;
  static constexpr int WM = kTcWarps / WN;
  static constexpr int NTW = TCO / (8 * WN);
  static constexpr int BM = 16 * WM * MTW;
  static constexpr int WLD = TCO + 8;  // bf16 row stride of a weight slice
  static_assert(NTW % 2 == 0, "B fragments two n8 tiles at a time");
};

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// The plan's grid: pixel tiles of `slots` bands of `rows` rows
// (bands_per_image of them per image, the last maybe shorter; slots > 1
// only for whole images, rows == H), `tiles` of them, and the input
// channels (C rounded up to 16) cut into `parts` ranges, one block each,
// whose partial sums the tile's last block adds.
struct Tiling {
  int rows, slots, bands_per_image, tiles, parts;
};

// Input channels of one part (a multiple of 16) and the staged row stride.
__host__ __device__ inline int part_ch(const Geom& g, const Tiling& t) {
  return pad16(g.C) / t.parts;
}

__host__ __device__ inline size_t tile_elems(const Geom& g, const Tiling& t) {
  return (size_t)t.slots * (t.rows + 2) * (g.W + 2) * (part_ch(g, t) + 8);
}

__host__ __device__ inline int k_slices(const Geom& g, const Tiling& t) {
  return (9 * part_ch(g, t) + kBK - 1) / kBK;
}

template <int TCO, bool WHOLE>
__host__ __device__ inline size_t tc_smem(const Geom& g, const Tiling& t) {
  const size_t ring = (size_t)(WHOLE ? k_slices(g, t) : kStages) * kBK * Tc<TCO>::WLD;
  return sizeof(bf16) * (tile_elems(g, t) + ring);
}

// What a conv's epilogue reads and writes, per element (m, n) of its
// (B*H*W, C) output: v = acc * a[n] + b[n] (rounded after each op), plus
// res[m, n] where a residual is given, then ReLU; stored to every
// destination given (float32, bf16).
struct Epilogue {
  const float* ab;       // (2, C): a, then b
  const float* res_f;    // float32 residual, or null
  const bf16* res_h;     // bf16 residual, or null
  float* out_f;          // float32 destination, or null
  bf16* out_h;           // bf16 destination, or null
};

// The residual pair at offset o = m * C + n (zeros without one).
__device__ __forceinline__ float2 residual(const Epilogue& ep, size_t o) {
  if (ep.res_f) return *reinterpret_cast<const float2*>(ep.res_f + o);
  if (ep.res_h) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(ep.res_h + o);
    return make_float2(__low2float(r), __high2float(r));
  }
  return make_float2(0.f, 0.f);
}

// The epilogue of the element pair (n, n + 1) at offset o = m * C + n, r
// its residual pair.
__device__ __forceinline__ void finish_pair(const Epilogue& ep, int C, size_t o, int n,
                                            float v0, float v1, float2 r) {
  const float2 av = *reinterpret_cast<const float2*>(ep.ab + n);
  const float2 bv = *reinterpret_cast<const float2*>(ep.ab + C + n);
  v0 = __fadd_rn(__fmul_rn(v0, av.x), bv.x);
  v1 = __fadd_rn(__fmul_rn(v1, av.y), bv.y);
  if (ep.res_f || ep.res_h) {
    v0 = __fadd_rn(v0, r.x);
    v1 = __fadd_rn(v1, r.y);
  }
  v0 = fmaxf(v0, 0.f);
  v1 = fmaxf(v1, 0.f);
  if (ep.out_f) mg::store2(ep.out_f + o, v0, v1);
  if (ep.out_h) mg::store2(ep.out_h + o, v0, v1);
}

// One piece (8 bf16 when `wide`, else 2) from src to shared dst, or zeros.
__device__ __forceinline__ void cp_piece(bool wide, bf16* dst, const bf16* src, bool ok) {
  if (wide)
    mg::cp_async<8>(dst, src, ok);
  else
    mg::cp_async<2>(dst, src, ok);
}

// dst = epilogue(conv3x3(src, w)) on the (pixel tile blockIdx.x, channel
// slab blockIdx.y) of the output, over input channel part blockIdx.z; src
// (B, H, W, C) bf16, w (9C, C) bf16.  `wide`: 16-byte copies (C % 8 == 0,
// pointers 16-byte aligned), else 4-byte ones.  With tl.parts > 1 each
// part writes its float32 sums to `partial` (parts x B*H*W x C) and counts
// itself in counters[tile, slab] (zero before the launch, zero again
// after it); the part that counts last adds the parts' sums in part order
// and runs the epilogue.  Dynamic shared memory: tc_smem<TCO, WHOLE>.
// Registers are bounded for 4 blocks per SM at TCO <= 32 (b0's tiles of 32
// channels) and for 3 above, which ran faster there (4 spilled).
template <int TCO, bool WHOLE>
__global__ void __launch_bounds__(kTcThreads, TCO <= 32 ? 4 : 3)
conv_tc_kernel(const bf16* __restrict__ src, const bf16* __restrict__ w, Epilogue ep, Geom g,
               Tiling tl, bool wide, float* partial, int* counters) {
  using CF = Tc<TCO>;
  constexpr int MTW = CF::MTW, NTW = CF::NTW, WM = CF::WM, WLD = CF::WLD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem);
  const int C = g.C, W = g.W, WP = W + 2;
  const int Cq = part_ch(g, tl), ld = Cq + 8, Kq = 9 * Cq, cb = blockIdx.z * Cq;
  bf16* ring = sx + tile_elems(g, tl);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn0 = (warp / WM) * (TCO / CF::WN);
  const int co0 = blockIdx.y * TCO;

  // This tile: bands [band0, band0 + nslots) of the B * bands_per_image
  // (image-major), first pixel m0, valid pixels P.
  const int band0 = blockIdx.x * tl.slots;
  const int img0 = band0 / tl.bands_per_image;
  const int y0 = (band0 - img0 * tl.bands_per_image) * tl.rows;
  const int nslots = min(tl.slots, g.B - img0);
  const int rows_here = min(tl.rows, g.H - y0);  // rows of each slot's band
  const int P = (nslots - 1) * tl.rows * W + rows_here * W;
  const size_t m0 = ((size_t)img0 * g.H + y0) * W;

  // The input tile: slot s, staged row i (image row y0 - 1 + i of image
  // img0 + s), column j (image column j - 1), channels cb.. of this part,
  // every element written.
  {
    const int V = wide ? 8 : 2, pieces = Cq / V, srows = rows_here + 2;
    const int n = nslots * srows * WP * pieces;
    for (int v = tid; v < n; v += kTcThreads) {
      const int cell = v / pieces, c = (v - cell * pieces) * V;
      const int s = cell / (srows * WP), rc = cell - s * srows * WP;
      const int i = rc / WP, j = rc - i * WP;
      const int y = y0 - 1 + i, x = j - 1;
      const bool ok = y >= 0 && y < g.H && x >= 0 && x < W && cb + c < C;
      const bf16* p =
          ok ? src + ((((size_t)img0 + s) * g.H + y) * W + x) * C + cb + c : src;
      cp_piece(wide, sx + ((size_t)s * (tl.rows + 2) + i) * WP * ld + j * ld + c, p, ok);
    }
  }
  // k slice kt of this part's weights (rows kt * kBK .. of the (9 Cq, TCO)
  // slab, row tap * Cq + c holding the weight row tap * C + cb + c) into
  // ring slot `slot`.
  auto stage_w = [&](int kt, int slot) {
    const int V = wide ? 8 : 2, pieces = TCO / V;
    bf16* dst = ring + (size_t)slot * kBK * WLD;
    for (int v = tid; v < kBK * pieces; v += kTcThreads) {
      const int r = v / pieces, c = (v - r * pieces) * V;
      const int k = kt * kBK + r, tap = k / Cq, ci = cb + k - tap * Cq;
      const bool ok = k < Kq && ci < C && co0 + c < C;
      const bf16* p = ok ? w + ((size_t)tap * C + ci) * C + co0 + c : w;
      cp_piece(wide, dst + r * WLD + c, p, ok);
    }
  };

  const int KT = k_slices(g, tl);
  if constexpr (WHOLE) {
    for (int kt = 0; kt < KT; ++kt) stage_w(kt, kt);
    mg::cp_commit();
  } else {
    stage_w(0, 0);
    mg::cp_commit();  // the tile and slice 0
#pragma unroll
    for (int s = 1; s < kStages - 1; ++s) {
      if (s < KT) stage_w(s, s);
      mg::cp_commit();
    }
  }

  // Lane l's A rows: pixel 16 * slab + (l & 7) + 8 * ((l >> 3) & 1) of
  // each of its slabs, as an element offset of its centre cell (tap (1,
  // 1)) plus the lane's 8-channel half; a pixel past P reads cell 0 (a
  // halo cell, zero) at every tap.
  const int nslabs = (P + 15) >> 4;
  int aoff[MTW];
  unsigned valid = 0;
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
    const int p = 16 * (mi * WM + wm) + (lane & 7) + 8 * ((lane >> 3) & 1);
    aoff[mi] = 8 * (lane >> 4);
    if (p < P) {
      const int s = p / (tl.rows * W), r = p - s * tl.rows * W, yl = r / W, x = r - yl * W;
      aoff[mi] += ((s * (tl.rows + 2) + yl + 1) * WP + x + 1) * ld;
      valid |= 1u << mi;
    }
  }
  const bool busy = wm < nslabs;  // this warp has a slab of the tile

  float acc[MTW][NTW][4];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  int tap = 0, c0 = 0, shift = (-WP - 1) * ld;  // tap (0, 0): one row up, one column left
  for (int kt = 0; kt < KT; ++kt) {
    if constexpr (WHOLE) {
      if (kt == 0) {
        mg::cp_wait<0>();
        __syncthreads();  // the tile and every slice landed
      }
    } else {
      mg::cp_wait<kStages - 2>();
      __syncthreads();  // slice kt landed (and the tile); slice kt - 1's reads done
      const int next = kt + kStages - 1;
      if (next < KT) stage_w(next, next % kStages);
      mg::cp_commit();
    }
    const bf16* sw = ring + (size_t)(WHOLE ? kt : kt % kStages) * kBK * WLD;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kt * kBK + kk * 16 < Kq) {
        if (busy) {
          uint32_t a[MTW][4];
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            if (mi * WM + wm < nslabs)
              mg::ldsm(a[mi], sx + aoff[mi] + ((valid >> mi) & 1 ? shift : 0) + c0);
#pragma unroll
          for (int np = 0; np < NTW / 2; ++np) {
            uint32_t b[4];
            mg::ldsm_t(b, sw + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * WLD + wn0 +
                              np * 16 + 8 * (lane >> 4));
#pragma unroll
            for (int mi = 0; mi < MTW; ++mi)
              if (mi * WM + wm < nslabs) {
                mg::mma(acc[mi][2 * np], a[mi], b[0], b[1]);
                mg::mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
              }
          }
        }
        c0 += 16;
        if (c0 == Cq) {  // next tap
          c0 = 0;
          ++tap;
          shift = ((tap / 3 - 1) * WP + tap % 3 - 1) * ld;
        }
      }
    }
  }
  mg::cp_wait<0>();

  // Each accumulator pair: pixel p = 16 * slab + g (+ 8), channels n, n + 1,
  // a slab at a time: `load(o)` of every pair of the slab first (so that
  // the loads are in flight together: the residual is the carry that the
  // same thread then overwrites, which keeps the compiler from moving a
  // load above an earlier store), then f(o, n, v0, v1, loaded).
  const int gq = lane >> 2, tq = lane & 3;
  auto each_pair = [&](auto load, auto f) {
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi) {
      if (mi * WM + wm >= nslabs) continue;
      decltype(load(size_t(0))) got[NTW][2];
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = co0 + wn0 + ni * 8 + 2 * tq, p = 16 * (mi * WM + wm) + gq + 8 * h;
          if (n < C && p < P) got[ni][h] = load((m0 + p) * C + n);
        }
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = co0 + wn0 + ni * 8 + 2 * tq, p = 16 * (mi * WM + wm) + gq + 8 * h;
          if (n < C && p < P)
            f((m0 + p) * C + n, n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], got[ni][h]);
        }
    }
  };
  auto res = [&](size_t o) { return residual(ep, o); };
  if (tl.parts == 1) {
    each_pair(res, [&](size_t o, int n, float v0, float v1, float2 r) {
      finish_pair(ep, C, o, n, v0, v1, r);
    });
    return;
  }
  // Split over input channels: this part's sums, then the last part's
  // epilogue over all of them, in part order (whatever part came last).
  const size_t MC = (size_t)g.B * g.H * W * C;
  each_pair([](size_t) { return 0; }, [&](size_t o, int, float v0, float v1, int) {
    mg::store2(partial + blockIdx.z * MC + o, v0, v1);
  });
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* count = counters + blockIdx.x * gridDim.y + blockIdx.y;
  if (tid == 0) last = atomicAdd(count, 1) == tl.parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The sums replace the accumulators, then the epilogue as above.
  for (int q = 0; q < tl.parts; ++q)
    each_pair(
        [&](size_t o) { return __ldcg(reinterpret_cast<const float2*>(partial + q * MC + o)); },
        [&](size_t, int, float& v0, float& v1, float2 u) {
          v0 = q ? v0 + u.x : u.x;
          v1 = q ? v1 + u.y : u.y;
        });
  each_pair(res, [&](size_t o, int n, float v0, float v1, float2 r) {
    finish_pair(ep, C, o, n, v0, v1, r);
  });
  if (tid == 0) *count = 0;  // for the next launch
}

// The bf16 rounding of a float32 map (x of a float32 chain with bf16
// weights: the first conv's staged operand).
__global__ void round_kernel(const float* __restrict__ x, bf16* __restrict__ out, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(x[i]);
}

// Where a split conv's parts meet: their sums and the tiles' counters.
struct Split {
  float* partial;
  int* counters;
};

template <int TCO, bool WHOLE>
cudaError_t launch_tc_cfg(const bf16* src, const bf16* w, const Epilogue& ep, Geom g,
                          Tiling tl, bool wide, Split sp, cudaStream_t stream) {
  if (tl.slots * tl.rows * g.W > Tc<TCO>::BM) return cudaErrorInvalidValue;
  const size_t smem = tc_smem<TCO, WHOLE>(g, tl);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t opt = allow_smem(conv_tc_kernel<TCO, WHOLE>, smem);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(tl.tiles, (g.C + TCO - 1) / TCO, tl.parts);
  conv_tc_kernel<TCO, WHOLE><<<grid, kTcThreads, smem, stream>>>(src, w, ep, g, tl, wide,
                                                                  sp.partial, sp.counters);
  return cudaGetLastError();
}

template <bool WHOLE>
cudaError_t launch_tc_whole(int tco, const bf16* src, const bf16* w, const Epilogue& ep,
                            Geom g, Tiling tl, bool wide, Split sp, cudaStream_t s) {
  switch (tco) {
    case 16: return launch_tc_cfg<16, WHOLE>(src, w, ep, g, tl, wide, sp, s);
    case 32: return launch_tc_cfg<32, WHOLE>(src, w, ep, g, tl, wide, sp, s);
    case 48: return launch_tc_cfg<48, WHOLE>(src, w, ep, g, tl, wide, sp, s);
    case 64: return launch_tc_cfg<64, WHOLE>(src, w, ep, g, tl, wide, sp, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tc(int tco, bool whole, const bf16* src, const bf16* w, const Epilogue& ep,
                      Geom g, Tiling tl, Split sp, cudaStream_t s) {
  const bool wide = g.C % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (whole) return launch_tc_whole<true>(tco, src, w, ep, g, tl, wide, sp, s);
  switch (tco) {
    case 96: return launch_tc_cfg<96, false>(src, w, ep, g, tl, wide, sp, s);
    case 128: return launch_tc_cfg<128, false>(src, w, ep, g, tl, wide, sp, s);
    default: return launch_tc_whole<false>(tco, src, w, ep, g, tl, wide, sp, s);
  }
}

// The chain with bf16 weights: per block a first conv (the bf16 carry xw,
// or x itself in block 0 -> y) and a second (y -> the float32 carry and
// xw, or the output after the last block), the residual x in block 0 and
// the carry after it.  In place: the carry is read and written by the same
// thread, element by element (by the last part's block where the conv is
// split).
template <typename T>
cudaError_t run_chain_tc(const T* x, const bf16* w, const float* ab, T* out, float* carry,
                         bf16* xw, bf16* y, Geom g, int nblocks, Tiling tl, int tco, bool whole,
                         Split sp, cudaStream_t s) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const size_t wsz = (size_t)9 * g.C * g.C, asz = (size_t)2 * g.C;
  const size_t n = (size_t)g.B * g.H * g.W * g.C;
  const bf16* in;
  if constexpr (kBf16) {
    in = x;
  } else {
    const unsigned blocks = (unsigned)std::min<size_t>((n + 255) / 256, 4096);
    round_kernel<<<blocks, 256, 0, s>>>(x, xw, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in = xw;
  }
  for (int blk = 0; blk < nblocks; ++blk) {
    const bool first = blk == 0, last = blk == nblocks - 1;
    const Epilogue e1{ab + (2 * blk) * asz, nullptr, nullptr, nullptr, y};
    cudaError_t err = launch_tc(tco, whole, in, w + (2 * blk) * wsz, e1, g, tl, sp, s);
    if (err != cudaSuccess) return err;
    Epilogue e2{ab + (2 * blk + 1) * asz, nullptr, nullptr, nullptr, nullptr};
    if (!first) e2.res_f = carry;
    else if constexpr (kBf16) e2.res_h = x;
    else e2.res_f = x;
    if (!last) {
      e2.out_f = carry;
      e2.out_h = xw;
    } else if constexpr (kBf16) {
      e2.out_h = out;
    } else {
      e2.out_f = out;
    }
    err = launch_tc(tco, whole, y, w + (2 * blk + 1) * wsz, e2, g, tl, sp, s);
    if (err != cudaSuccess) return err;
    in = xw;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// float32 weights: the CUDA-core implicit GEMM.

constexpr int kBM = 64;          // pixels per output tile
constexpr int kKC = 64;          // k (tap, channel) per staged chunk
constexpr int kPairs = kKC / 2;  // k pairs per staged row
constexpr int kLdF = kKC + 1;    // float row stride of the staged A chunk

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

// One 3x3 conv of the chain with float32 weights: dst = epilogue(conv(src,
// w) * a + b).  With `res` null (a block's first conv): dst = relu(.);
// else dst = relu(. + res).  res and dst may be the same buffer: each
// element is read and then written by one thread, and no other reads it in
// this launch.  4 x 4 outputs a thread (pixels ty*4.., channels tx*4..).
template <typename TA, typename TR, typename TO>
__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const TA* __restrict__ src, const float* __restrict__ w,
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
      sb[kk][n] = (k < K && n0 + n < C) ? w[(size_t)k * C + n0 + n] : 0.f;
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

template <typename TA, typename TR, typename TO>
cudaError_t launch_f32(const TA* src, const float* w, const float* ab, const TR* res, TO* dst,
                       Geom g, cudaStream_t stream) {
  const int M = g.B * g.H * g.W;
  dim3 grid((M + kBM - 1) / kBM, (g.C + kBN - 1) / kBN);
  conv_f32_kernel<TA, TR, TO><<<grid, kThreads, 0, stream>>>(src, w, ab, res, dst, g);
  return cudaGetLastError();
}

// The chain with float32 weights: per block a first conv (x or the carry
// -> y) and a second (y -> the carry, or the output after the last block).
template <typename T>
cudaError_t run_chain_f32(const T* x, const float* w, const float* ab, T* out, float* carry,
                          float* y, Geom g, int nblocks, cudaStream_t s) {
  const size_t wsz = (size_t)9 * g.C * g.C, asz = (size_t)2 * g.C;
  const float* none = nullptr;
  cudaError_t err = cudaSuccess;
  for (int blk = 0; blk < nblocks && err == cudaSuccess; ++blk) {
    const float* w1 = w + (2 * blk) * wsz;
    const float* w2 = w + (2 * blk + 1) * wsz;
    const float* ab1 = ab + (2 * blk) * asz;
    const float* ab2 = ab + (2 * blk + 1) * asz;
    const bool first = blk == 0, last = blk == nblocks - 1;
    err = first ? launch_f32(x, w1, ab1, none, y, g, s)
                : launch_f32(static_cast<const float*>(carry), w1, ab1, none, y, g, s);
    if (err != cudaSuccess) break;
    const float* yc = y;
    if (first && last) err = launch_f32(yc, w2, ab2, x, out, g, s);
    else if (first) err = launch_f32(yc, w2, ab2, x, carry, g, s);
    else if (last) err = launch_f32(yc, w2, ab2, static_cast<const float*>(carry), out, g, s);
    else err = launch_f32(yc, w2, ab2, static_cast<const float*>(carry), carry, g, s);
  }
  return err;
}

}  // namespace

// x_code / w_code: 0 float32, 1 bf16.  carry: B*H*W*C floats; y: B*H*W*C
// elements of the weights' type; xw: B*H*W*C bf16 (the carry's rounding;
// unused with float32 weights).  bf16 weights take the plan of
// kernels/residual_block.py `chain_plan`: bands of `rows` rows, `slots`
// bands a tile (> 1 only with rows == H), `tco` output channels a slab
// (16, 32, 48, 64, 96 or 128), `whole` (the weight slab staged whole; tco
// <= 64), `parts` ranges of input channels (C rounded up to 16 divides
// into parts multiples of 16); with parts > 1, partial: parts*B*H*W*C
// floats and counters: one int per (tile, slab), zero (and zero again
// after the call).  Returns the first launch error.
extern "C" int ipe_residual_chain(const void* x, const void* w, const float* ab, void* out,
                                  float* carry, void* xw, void* y, float* partial,
                                  int* counters, int B, int H, int W, int C, int nblocks,
                                  int x_code, int w_code, int rows, int slots, int tco,
                                  int whole, int parts, void* stream) {
  const Geom g{B, H, W, C};
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 2 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_code == 0) {
    if (x_code == 0)
      return (int)run_chain_f32(static_cast<const float*>(x), static_cast<const float*>(w), ab,
                                static_cast<float*>(out), carry, static_cast<float*>(y), g,
                                nblocks, s);
    return (int)run_chain_f32(static_cast<const bf16*>(x), static_cast<const float*>(w), ab,
                              static_cast<bf16*>(out), carry, static_cast<float*>(y), g,
                              nblocks, s);
  }
  if (rows <= 0 || rows > H || slots <= 0 || (slots > 1 && rows != H) || parts <= 0 ||
      pad16(C) % (16 * parts) || (parts > 1 && (!partial || !counters)))
    return (int)cudaErrorInvalidValue;
  const int bands = (H + rows - 1) / rows;
  const Tiling tl{rows, slots, bands, (B * bands + slots - 1) / slots, parts};
  const Split sp{partial, counters};
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* xwb = static_cast<bf16*>(xw);
  bf16* yb = static_cast<bf16*>(y);
  if (x_code == 0)
    return (int)run_chain_tc(static_cast<const float*>(x), wb, ab, static_cast<float*>(out),
                             carry, xwb, yb, g, nblocks, tl, tco, whole != 0, sp, s);
  return (int)run_chain_tc(static_cast<const bf16*>(x), wb, ab, static_cast<bf16*>(out), carry,
                           xwb, yb, g, nblocks, tl, tco, whole != 0, sp, s);
}
