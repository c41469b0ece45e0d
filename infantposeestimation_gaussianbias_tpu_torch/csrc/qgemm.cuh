// K9, the int8 conv of int8 PTQ serving: its kernel and launch, for Hopper
// (the design and what bounds it: csrc/qgemm.cu).  `qconv_run<PHASES>`
// checks a packed argument struct and launches the kernel its plan names,
// with the phases PHASES compiled in: kPhaseAll in serving (csrc/qgemm.cu
// `ipe_qconv`); staging, the products or the epilogue alone in the
// measurement variants (csrc/qgemm_ablate_*.cu), whose outputs are
// meaningless.
#pragma once

#include "ipe_common.cuh"
#include "qgemm_common.cuh"

// K9's arguments (kernels/quant.py `qconv` and its plan `conv_plan`),
// packed by the wrapper in one struct (a single ctypes argument).  bn, wg:
// the tile (32, 64, 128 or 256 output channels; 1 or 2 warpgroups of 64
// pixels); byte_route: 1 stages byte by byte (any C; stages 2), 0 by
// 16-byte copies (C % 16 == 0, x and w 16-byte aligned); stages: the
// ring's slices, 4, or 2 where no split has more than two slices.  x (B,
// H, W, C), output (B, Ho, Wo, N), kernel kh x kw (K = kh kw C), stride,
// pad.  res_kind: 0 none, 1 int8 (res_scale), 2 float32; out_kind: 0
// float32, 1 int8 (out_scale); relu; vec_out: the output and the residual
// take 4-value accesses (N % 4 == 0, 16-byte aligned).  splits slices of
// per_split depth slices each; when splits > 1, ws holds (tiles, splits,
// BM * BN) int32 and counters (tiles,) zeros.
struct QconvArgs {
  const void *x, *w, *x_scale, *col_scale, *col_bias, *res, *res_scale, *out_scale;
  void *out, *ws, *counters, *stream;
  int bn, wg, byte_route, stages, M, N, K, H, W, C, Ho, Wo, kw, stride, pad, res_kind, out_kind, relu,
      vec_out, splits, per_split;
};

namespace {

using namespace qg;

struct ConvParams {
  const int8_t* x;         // (B, H, W, C) int8
  const int8_t* w;         // (N, K) int8, K contiguous
  const float* x_scale;    // 0-d
  const float* col_scale;  // (N,) eff_scale
  const float* col_bias;   // (N,) eff_bias
  const void* res;         // (M, N) int8 or float32, or null
  const float* res_scale;  // the int8 residual's scale, 0-d
  const float* out_scale;  // the requantize scale, 0-d (int8 out)
  void* out;               // (M, N) int8 or float32
  int* ws;                 // split-K partials: (tiles, splits, BM * BN) int32
  int* counters;           // (tiles,) int32, zero between launches
  int M, N, K, H, W, C, Ho, Wo, kw, stride, pad;
  int res_kind, out_kind, relu, vec_out, res_smem;
  int slices, per_split, splits;
};

constexpr int kEpiBatch = 4;  // epilogue rows a thread has in flight, at most

// Shared memory: the ring of STAGES slices of A and B, or the epilogue's
// int32 tile (BN + 8 columns a row) where that is larger (they take turns),
// then the column scale and bias and a flag; plus alignment slack.  A
// launch with a residual adds its tile (BM x BN, 1 or 4 bytes) where that
// fits without costing a block an SM (res_smem).
template <int BN, int WG, int STAGES>
__host__ __device__ constexpr int conv_tiles() {
  return STAGES * (64 * WG + BN) * kSlice > 64 * WG * (BN + 8) * 4 ? STAGES * (64 * WG + BN) * kSlice
                                                                   : 64 * WG * (BN + 8) * 4;
}
template <int BN, int WG, int STAGES>
__host__ __device__ constexpr int conv_smem() {
  return 1024 + conv_tiles<BN, WG, STAGES>() + 2 * BN * 4 + 16;
}

// One BM x BN tile of (M, N) over the depth slices of split blockIdx.z.
// Thread t stages chunk t % 8 of A rows t / 8 + j NT / 8 (j < 4) and of B
// rows t / 8 + j NT / 8 (j < BN / (16 WG)).  STAGES: 4, or 2 where a split
// has at most two slices (both staged before the first product).  PHASES:
// the phases compiled in (kPhaseAll in serving).
template <int BN, int WG, bool BYTE, int STAGES, int PHASES>
__global__ void __launch_bounds__(128 * WG, 2 * conv_smem<BN, WG, STAGES>() <= ipe::kMaxSmem ? 2 : 1)
    qconv_kernel(const ConvParams p) {
  constexpr int BM = 64 * WG, NT = 128 * WG, LD = BN + 8;
  constexpr int A_BYTES = BM * kSlice, STAGE = (BM + BN) * kSlice;
  constexpr int BROWS = BN / (16 * WG);
  static_assert(BN % (16 * WG) == 0, "B rows per thread");
  static_assert(STAGES == 2 || STAGES == 4, "ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_scale = reinterpret_cast<float*>(smem + conv_tiles<BN, WG, STAGES>());
  float* s_bias = s_scale + BN;
  int* s_last = reinterpret_cast<int*>(s_bias + BN);
  uint8_t* s_res = reinterpret_cast<uint8_t*>(s_last + 4);  // BM x BN x (1 or 4) bytes

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int s_begin = blockIdx.z * p.per_split;
  const int ns = min(p.slices, s_begin + p.per_split) - s_begin;
  const int chunk = tid & 7, row0 = tid >> 3;

  for (int i = tid; i < BN; i += NT) {
    const int n = n0 + i;
    s_scale[i] = n < p.N ? __fmul_rn(*p.x_scale, p.col_scale[n]) : 0.f;
    s_bias[i] = n < p.N ? p.col_bias[n] : 0.f;
  }

  // The output pixels of this thread's four A rows: the input offset of
  // their top-left tap and its (ih, iw); a row past M never lies inside.
  int64_t a_off[4];
  int a_ih[4], a_iw[4];
  const int hw = p.Ho * p.Wo;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + row0 + j * (NT / 8);
    if (m < p.M) {
      const int b = m / hw, r = m - b * hw;
      const int oh = r / p.Wo, ow = r - oh * p.Wo;
      a_ih[j] = oh * p.stride - p.pad;
      a_iw[j] = ow * p.stride - p.pad;
      a_off[j] = ((static_cast<int64_t>(b) * p.H + a_ih[j]) * p.W + a_iw[j]) * p.C;
    } else {
      a_ih[j] = -(1 << 29);
      a_iw[j] = 0;
      a_off[j] = 0;
    }
  }

  // Depth of this thread's chunk in the next slice to stage, and its tap
  // (tr, ts) and channel tc.
  int k_cur = s_begin * kSlice + 16 * chunk;
  int tr, ts, tc;
  {
    const int tap = k_cur / p.C;
    tc = k_cur - tap * p.C;
    tr = tap / p.kw;
    ts = tap - tr * p.kw;
  }

  auto stage = [&](int buf) {
    uint8_t* As = smem + buf * STAGE;
    uint8_t* Bs = As + A_BYTES;
    {  // every chunk, zeros past K: the products read all four steps
      const bool kin = k_cur < p.K;
      if constexpr (!BYTE) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ih = a_ih[j] + tr, iw = a_iw[j] + ts;
          const bool ok = kin && static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
          const int8_t* src =
              ok ? p.x + a_off[j] + (static_cast<int64_t>(tr) * p.W + ts) * p.C + tc : p.x;
          cp_async16(As + sw128(row0 + j * (NT / 8), chunk), src, ok);
        }
#pragma unroll
        for (int j = 0; j < BROWS; ++j) {
          const int nr = row0 + j * (NT / 8), n = n0 + nr;
          const bool ok = kin && n < p.N;
          cp_async16(Bs + sw128(nr, chunk), ok ? p.w + static_cast<int64_t>(n) * p.K + k_cur : p.w,
                     ok);
        }
      }
    }
    if constexpr (BYTE) {
      // Byte by byte, in groups of four bytes: thread t takes bytes
      // 4 (t % 8) + 32 pass of the slice, for its four A rows and its B
      // rows; the taps of the four bytes are found once for all rows.
      const int base = k_cur - 16 * chunk;
#pragma unroll 1
      for (int pass = 0; pass < kSlice / 32; ++pass) {
        const int b0 = 32 * pass + 4 * chunk, k0 = base + b0;
        if (k0 >= p.K) {  // zeros: the products read every step
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = row0 + j * (NT / 8);
            *reinterpret_cast<uint32_t*>(As + row * kSlice + ((((b0 >> 4) ^ (row & 7)) << 4) | (b0 & 15))) = 0u;
          }
#pragma unroll
          for (int j = 0; j < BROWS; ++j) {
            const int nr = row0 + j * (NT / 8);
            *reinterpret_cast<uint32_t*>(Bs + nr * kSlice + ((((b0 >> 4) ^ (nr & 7)) << 4) | (b0 & 15))) = 0u;
          }
          continue;
        }
        int dr[4], ds[4], off[4];
        bool kin[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + i, tap = k / p.C, c = k - tap * p.C;
          kin[i] = k < p.K;
          dr[i] = tap / p.kw;
          ds[i] = tap - dr[i] * p.kw;
          off[i] = (dr[i] * p.W + ds[i]) * p.C + c;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = row0 + j * (NT / 8);
          uint32_t v = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ih = a_ih[j] + dr[i], iw = a_iw[j] + ds[i];
            if (kin[i] && static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                static_cast<unsigned>(iw) < static_cast<unsigned>(p.W))
              v |= static_cast<uint32_t>(static_cast<uint8_t>(p.x[a_off[j] + off[i]])) << (8 * i);
          }
          *reinterpret_cast<uint32_t*>(As + row * kSlice + ((((b0 >> 4) ^ (row & 7)) << 4) | (b0 & 15))) = v;
        }
#pragma unroll
        for (int j = 0; j < BROWS; ++j) {
          const int nr = row0 + j * (NT / 8), n = n0 + nr;
          uint32_t v = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n < p.N && kin[i])
              v |= static_cast<uint32_t>(static_cast<uint8_t>(p.w[static_cast<int64_t>(n) * p.K + k0 + i])) << (8 * i);
          *reinterpret_cast<uint32_t*>(Bs + nr * kSlice + ((((b0 >> 4) ^ (nr & 7)) << 4) | (b0 & 15))) = v;
        }
      }
    }
    k_cur += kSlice;
    tc += kSlice;
    while (tc >= p.C) {
      tc -= p.C;
      if (++ts == p.kw) {
        ts = 0;
        ++tr;
      }
    }
  };

  constexpr bool kStageOn = PHASES & kPhaseStage, kProductOn = PHASES & kPhaseProduct;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // The residual tile, prefetched behind the products (its own group, the
  // oldest: slice 0's wait covers it).
  if (p.res_smem) {
    const int rb = p.res_kind == kResF32 ? 4 : 1, chunks = BN * rb / 16;
    for (int e = tid; e < BM * chunks; e += NT) {
      const int r = e / chunks, b = (e - r * chunks) * 16, m = m0 + r;
      const bool ok = m < p.M && n0 + b / rb < p.N;
      const uint8_t* src = static_cast<const uint8_t*>(p.res) +
                           (ok ? (static_cast<int64_t>(m) * p.N + n0) * rb + b : 0);
      cp_async16(s_res + r * BN * rb + b, src, ok);
    }
  }
  cp_commit();
  if constexpr (kStageOn) stage(0);
  cp_commit();
  if constexpr (kStageOn)
    if (ns > 1) stage(1);
  cp_commit();
  for (int i = 0; i < ns; ++i) {
    // Slice i has landed; every warpgroup is past slice i - 2's products,
    // so its buffer takes slice i + 2 (STAGES == 4; with 2, ns <= 2 and
    // both slices are staged already).
    cp_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if constexpr (kStageOn && STAGES == 4)
      if (i + 2 < ns) stage((i + 2) % STAGES);
    cp_commit();
    if constexpr (kProductOn) {
      const uint8_t* As = smem + (i % STAGES) * STAGE;
      const uint64_t da = sw128_desc(As + wg * 64 * kSlice), db = sw128_desc(As + A_BYTES);
      acc_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / kStep; ++kk) Wgmma<BN>::run(acc, da + 2 * kk, db + 2 * kk, 1);
      wg_commit();
      wg_wait<1>();
    }
  }
  wg_wait<0>();
  acc_fence(acc);
  cp_wait<0>();
  __syncthreads();

  // The accumulators into the int32 tile Cs (row stride 4 BN + 32 bytes:
  // a warp's eight rows fall in distinct banks).
  int* Cs = reinterpret_cast<int*>(smem);
  {
    const int r = wg * 64 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<int2*>(Cs + r * LD + 8 * j + c) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(Cs + (r + 8) * LD + 8 * j + c) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();

  if (p.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* part = p.ws + (static_cast<int64_t>(tile) * p.splits + blockIdx.z) * (BM * BN);
    for (int e = tid; e < BM * BN / 4; e += NT) {
      const int r = e / (BN / 4), c = (e - r * (BN / 4)) * 4;
      *reinterpret_cast<int4*>(part + 4 * e) = *reinterpret_cast<const int4*>(Cs + r * LD + c);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!*s_last) return;
    __threadfence();
    const int* parts = p.ws + static_cast<int64_t>(tile) * p.splits * (BM * BN);
    for (int e = tid; e < BM * BN / 4; e += NT) {
      const int r = e / (BN / 4), c = (e - r * (BN / 4)) * 4;
      int4 t = make_int4(0, 0, 0, 0);
      for (int z = 0; z < p.splits; ++z) {
        const int4 u = __ldcg(reinterpret_cast<const int4*>(parts + z * (BM * BN) + 4 * e));
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      *reinterpret_cast<int4*>(Cs + r * LD + c) = t;
    }
    if (tid == 0) p.counters[tile] = 0;
    __syncthreads();
  }
  if constexpr (!(PHASES & kPhaseEpilogue)) return;

  // Epilogue: eight columns of one row a thread (8-byte int8 or 2 x
  // 16-byte float32 loads and stores), consecutive threads along the row;
  // a thread's columns are the same in every row it takes (NT is a
  // multiple of BN / 8), so their scale and bias sit in registers.  Odd
  // threads read their two 16-byte halves of Cs in the other order, so
  // that a warp's reads fall in all banks.  The residual comes from its
  // tile in shared memory where it was prefetched, else EB rows of it are
  // loaded before any is finished.
  const float rs = p.res_kind == kResInt8 ? *p.res_scale : 0.f;
  const float inv_out = p.out_kind == kOutInt8 ? __frcp_rn(*p.out_scale) : 0.f;
  constexpr int TPR = BN / 8, RSTEP = NT / TPR;  // threads a row, rows a pass
  constexpr int EB = BN / 16 < kEpiBatch ? BN / 16 : kEpiBatch;  // rows a batch
  static_assert(NT % TPR == 0 && BM % (RSTEP * EB) == 0, "whole passes");
  const int c = (tid % TPR) * 8, n = n0 + c, cnt = min(8, p.N - n), odd = tid & 1;
  float cs[8], cb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cs[i] = s_scale[c + i];
    cb[i] = s_bias[c + i];
  }
  const bool vec = p.vec_out && cnt == 8;
  const int rb = p.res_kind == kResF32 ? 4 : 1;
  for (int r0 = tid / TPR; r0 < BM && cnt > 0; r0 += RSTEP * EB) {
    uint4 raw[EB][2];  // int8: raw[u][0].x, .y; float32: 8 floats
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int r = r0 + u * RSTEP, m = m0 + r;
      raw[u][0] = raw[u][1] = make_uint4(0u, 0u, 0u, 0u);
      if (m >= p.M || !vec || p.res_kind == kResNone) continue;
      const uint8_t* src = p.res_smem ? s_res + (r * BN + c) * rb
                                      : static_cast<const uint8_t*>(p.res) + (static_cast<int64_t>(m) * p.N + n) * rb;
      if (p.res_kind == kResInt8) {
        const uint2 t = *reinterpret_cast<const uint2*>(src);
        raw[u][0].x = t.x;
        raw[u][0].y = t.y;
      } else {
        raw[u][0] = *reinterpret_cast<const uint4*>(src);
        raw[u][1] = *reinterpret_cast<const uint4*>(src + 16);
      }
    }
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int r = r0 + u * RSTEP, m = m0 + r;
      if (m >= p.M) continue;
      const int4 first = *reinterpret_cast<const int4*>(Cs + r * LD + c + 4 * odd);
      const int4 second = *reinterpret_cast<const int4*>(Cs + r * LD + c + 4 * (odd ^ 1));
      const int4 lo = odd ? second : first, hi = odd ? first : second;
      const int acc8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = affine(acc8[i], cs[i], cb[i]);
      const int64_t o = static_cast<int64_t>(m) * p.N + n;
      if (vec) {
        const uint32_t w[8] = {raw[u][0].x, raw[u][0].y, raw[u][0].z, raw[u][0].w,
                               raw[u][1].x, raw[u][1].y, raw[u][1].z, raw[u][1].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (p.res_kind == kResInt8) {
            v[i] = __fadd_rn(v[i], __fmul_rn(__int2float_rn(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3)))), rs));
          } else if (p.res_kind == kResF32) {
            v[i] = __fadd_rn(v[i], __uint_as_float(w[i]));
          }
          if (p.relu) v[i] = fmaxf(v[i], 0.f);
        }
        if (p.out_kind == kOutInt8) {  // one 8-byte store
          uint32_t q[2] = {0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            q[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(sat_int8(__fmul_rn(v[i], inv_out))))
                         << (8 * (i & 3));
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) = make_uint2(q[0], q[1]);
        } else {
          float* dst = static_cast<float*>(p.out) + o;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
      } else {
        for (int i = 0; i < cnt; ++i) {
          float y = v[i];
          if (p.res_kind == kResInt8) {
            y = __fadd_rn(y, __fmul_rn(__int2float_rn(static_cast<const int8_t*>(p.res)[o + i]), rs));
          } else if (p.res_kind == kResF32) {
            y = __fadd_rn(y, static_cast<const float*>(p.res)[o + i]);
          }
          if (p.relu) y = fmaxf(y, 0.f);
          if (p.out_kind == kOutInt8) {
            static_cast<int8_t*>(p.out)[o + i] = sat_int8(__fmul_rn(y, inv_out));
          } else {
            static_cast<float*>(p.out)[o + i] = y;
          }
        }
      }
    }
  }
}

template <int BN, int WG, bool BYTE, int STAGES, int PHASES>
cudaError_t launch_conv(ConvParams p, cudaStream_t s) {
  constexpr int base = conv_smem<BN, WG, STAGES>();
  static_assert(base <= ipe::kMaxSmem, "shared memory");
  const int res_bytes = p.res_kind == kResNone ? 0 : 64 * WG * BN * (p.res_kind == kResF32 ? 4 : 1);
  // prefetched where the tile fits and costs no block an SM could hold
  p.res_smem = p.vec_out && res_bytes && base + res_bytes <= ipe::kMaxSmem &&
               (2 * (base + res_bytes) <= ipe::kMaxSmem || 2 * base > ipe::kMaxSmem);
  const int smem = base + (p.res_smem ? res_bytes : 0);
  auto kernel = qconv_kernel<BN, WG, BYTE, STAGES, PHASES>;
  // A launch above 48 KB opts the kernel in to the most any launch of it
  // may take, not to its own bytes: the setting is the kernel's, and two
  // host threads launching it with different bytes would race between
  // setting and launching.
  if (smem > 48 * 1024) {
    const cudaError_t e = ipe::allow_smem(kernel, ipe::kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.M + 64 * WG - 1) / (64 * WG), (p.N + BN - 1) / BN, p.splits);
  kernel<<<grid, 128 * WG, smem, s>>>(p);
  return cudaGetLastError();
}

template <int BN, int WG, int PHASES>
cudaError_t launch_vec(const ConvParams& p, int stages, cudaStream_t s) {
  return stages == 2 ? launch_conv<BN, WG, false, 2, PHASES>(p, s) : launch_conv<BN, WG, false, 4, PHASES>(p, s);
}


// Checks the arguments and launches; returns the launch's error.
template <int PHASES>
int qconv_run(const QconvArgs* a) {
  const int bn = a->bn, wg = a->wg, byte_route = a->byte_route, stages = a->stages;
  const int M = a->M, N = a->N, K = a->K, H = a->H, W = a->W, C = a->C, Ho = a->Ho, Wo = a->Wo;
  const int kw = a->kw, stride = a->stride, pad = a->pad, res_kind = a->res_kind;
  const int out_kind = a->out_kind, relu = a->relu, vec_out = a->vec_out, splits = a->splits;
  const int per_split = a->per_split;
  const void *x = a->x, *w = a->w, *x_scale = a->x_scale, *col_scale = a->col_scale;
  const void *col_bias = a->col_bias, *res = a->res, *res_scale = a->res_scale, *out_scale = a->out_scale;
  void *out = a->out, *ws = a->ws, *counters = a->counters, *stream = a->stream;
  const int slices = (K + kSlice - 1) / kSlice;
  if (M <= 0 || N <= 0 || K <= 0 || C <= 0 || kw <= 0 || stride <= 0 || K % C ||
      (!byte_route && C % 16) || res_kind < 0 || res_kind > 2 ||
      (out_kind != kOutF32 && out_kind != kOutInt8) || splits < 1 || per_split < 1 ||
      (splits - 1) * per_split >= slices || splits * per_split < slices ||
      (splits > 1 && (!ws || !counters)) || (stages != 2 && stages != 4) ||
      (stages == 2 && per_split > 2))
    return (int)cudaErrorInvalidValue;
  const ConvParams p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                     static_cast<const float*>(x_scale), static_cast<const float*>(col_scale),
                     static_cast<const float*>(col_bias), res, static_cast<const float*>(res_scale),
                     static_cast<const float*>(out_scale), out, static_cast<int*>(ws),
                     static_cast<int*>(counters), M, N, K, H, W, C, Ho, Wo, kw, stride, pad,
                     res_kind, out_kind, relu, vec_out, 0, slices, per_split, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (byte_route) {
    if (bn != 64 || stages != 2) return (int)cudaErrorInvalidValue;
    return (int)(wg == 2 ? launch_conv<64, 2, true, 2, PHASES>(p, s) : launch_conv<64, 1, true, 2, PHASES>(p, s));
  }
  switch (bn * 4 + wg) {
    case 32 * 4 + 1: return (int)launch_vec<32, 1, PHASES>(p, stages, s);
    case 32 * 4 + 2: return (int)launch_vec<32, 2, PHASES>(p, stages, s);
    case 64 * 4 + 1: return (int)launch_vec<64, 1, PHASES>(p, stages, s);
    case 64 * 4 + 2: return (int)launch_vec<64, 2, PHASES>(p, stages, s);
    case 128 * 4 + 1: return (int)launch_vec<128, 1, PHASES>(p, stages, s);
    case 128 * 4 + 2: return (int)launch_vec<128, 2, PHASES>(p, stages, s);
    case 256 * 4 + 1: return (int)launch_vec<256, 1, PHASES>(p, stages, s);
    case 256 * 4 + 2: return (int)launch_vec<256, 2, PHASES>(p, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
