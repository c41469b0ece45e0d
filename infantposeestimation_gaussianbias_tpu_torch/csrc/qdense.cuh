// K10, the int8 Dense of int8 PTQ serving: its kernel and launch, for
// Hopper (the design and what bounds it: csrc/qdense.cu).
// `qdense_run<PHASES>` checks a packed argument struct and launches, with
// the phases PHASES compiled in: kPhaseAll in serving (csrc/qdense.cu
// `ipe_qdense`); staging, the products or the epilogue alone in the
// measurement variants (csrc/qgemm_ablate_*.cu), whose outputs are
// meaningless.
#pragma once

#include "ipe_common.cuh"
#include "qgemm_common.cuh"

// K10's arguments (kernels/quant.py `qdense` and its plan `dense_plan`),
// packed by the wrapper in one struct (a single ctypes argument).  wg: 1
// or 2 warpgroups (64 or 128 rows a block); src_bf16: x is bf16 (else
// float32); w: the padded weights (ceil(N / 128) * 128, Kp), Kp = K
// rounded up to 128; n_split blocks over the N tiles, per_split tiles
// each; out_bf16: the output's type; vec_in: 4, rows readable 4 elements at
// a time (K % 4 == 0, x 16-byte aligned for float32, 8 for bf16), or 8
// (bf16 rows, K % 8 == 0, 16-byte aligned), else 0;
// out_align: 16, 8, 4 or 2, the bytes every output row start is aligned
// to.
struct QdenseArgs {
  const void *x, *w, *in_scale, *w_scale, *bias;
  void *out, *stream;
  int wg, src_bf16, M, N, K, Kp, n_split, per_split, out_bf16, vec_in, out_align;
};

namespace {

using namespace qg;

constexpr int kBN = 128;
constexpr int kThreads = 256;    // a block: one or two warpgroups of products, the rest help
constexpr int kQuantBatch = 8;   // row groups a thread loads before it quantizes them
constexpr int kWarpBuf = 512;    // bytes of output a warp stages: 16 rows x 32 bytes
enum Src { kF32 = 0, kBf16 = 1 };

struct DenseParams {
  const void* x;           // (M, K) float32 or bf16
  const int8_t* w;         // (n_tiles * 128, Kp) int8, zero-padded, Kp % 128 == 0
  const float* in_scale;   // 0-d
  const float* w_scale;    // (N,)
  const float* bias;       // (N,)
  void* out;               // (M, N) float32 or bf16
  int M, N, K, Kp, slices, n_tiles, per_split;
  int out_bf16, vec_in, out_align;  // vec_in: 0, 4 or 8 elements a load, K % vec_in == 0
};

// The raw load of G consecutive elements: 16 bytes (4 float32 or 8 bf16)
// or 8 (4 bf16).
template <int SRC, int G>
struct RowLoad {
  using T = uint4;
};
template <>
struct RowLoad<kBf16, 4> {
  using T = uint2;
};

template <int SRC, int G>
__device__ __forceinline__ void unpack(const typename RowLoad<SRC, G>::T& t, float (&v)[G]) {
  if constexpr (SRC == kF32) {
    v[0] = __uint_as_float(t.x);
    v[1] = __uint_as_float(t.y);
    v[2] = __uint_as_float(t.z);
    v[3] = __uint_as_float(t.w);
  } else if constexpr (G == 8) {
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(u[j] << 16);
      v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  }
}

// G quantized elements into the resident rows at byte offset dst.
template <int G>
__device__ __forceinline__ void store_q(uint8_t* rows, int dst, const float (&v)[G], int cnt, float inv) {
  uint32_t q[G / 4];
#pragma unroll
  for (int h = 0; h < G / 4; ++h) {
    q[h] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * h + j < cnt)
        q[h] |= static_cast<uint32_t>(static_cast<uint8_t>(sat_int8(__fmul_rn(v[4 * h + j], inv)))) << (8 * j);
  }
  if constexpr (G == 8) {
    *reinterpret_cast<uint2*>(rows + dst) = make_uint2(q[0], q[1]);
  } else {
    *reinterpret_cast<uint32_t*>(rows + dst) = q[0];
  }
}

// The block's BM rows quantized into `rows` (slices x BM x 128 bytes,
// swizzled; zeros past K and past M), in groups of G elements read by one
// load each (rows whose every group is aligned, p.vec_in >= G):
// kQuantBatch loads a thread issued, from a valid address even for a
// group outside the rows, before any is quantized.
template <int SRC, int G, int BM>
__device__ __forceinline__ void quantize_rows(const DenseParams& p, int m0, int tid, uint8_t* rows) {
  using T = typename RowLoad<SRC, G>::T;
  constexpr int EB = SRC == kF32 ? 4 : 2;  // bytes an element
  const float inv = __frcp_rn(*p.in_scale);
  const int groups = p.Kp / G, total = BM * groups;
  const uint8_t* x = static_cast<const uint8_t*>(p.x);
  for (int e0 = tid; e0 < total; e0 += kThreads * kQuantBatch) {
    T raw[kQuantBatch];
    int dst[kQuantBatch], cnt[kQuantBatch];
#pragma unroll
    for (int u = 0; u < kQuantBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / groups, k = (e - r * groups) * G, m = m0 + r;
      cnt[u] = e < total && m < p.M && k < p.K ? G : 0;  // K % G == 0
      dst[u] = e < total ? (k >> 7) * (BM * kSlice) + sw128(r, (k & 127) >> 4) + (k & 15) : -1;
      raw[u] = __ldg(reinterpret_cast<const T*>(x + (cnt[u] ? (static_cast<int64_t>(m) * p.K + k) * EB : 0)));
    }
#pragma unroll
    for (int u = 0; u < kQuantBatch; ++u) {
      if (dst[u] < 0) continue;
      float v[G];
      unpack<SRC, G>(raw[u], v);
      store_q<G>(rows, dst[u], v, cnt[u], inv);
    }
  }
}

// The same element by element, for rows that are not aligned to a group.
template <int SRC, int BM>
__device__ __forceinline__ void quantize_rows_scalar(const DenseParams& p, int m0, int tid, uint8_t* rows) {
  const float inv = __frcp_rn(*p.in_scale);
  const int groups = p.Kp / 4, total = BM * groups;
  for (int e = tid; e < total; e += kThreads) {
    const int r = e / groups, k = (e - r * groups) * 4, m = m0 + r;
    const int cnt = m < p.M ? max(0, min(4, p.K - k)) : 0;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = static_cast<int64_t>(m) * p.K + k + j;
      if constexpr (SRC == kF32) {
        v[j] = j < cnt ? static_cast<const float*>(p.x)[i] : 0.f;
      } else {
        v[j] = j < cnt ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i]) : 0.f;
      }
    }
    store_q<4>(rows, (k >> 7) * (BM * kSlice) + sw128(r, (k & 127) >> 4) + (k & 15), v, cnt, inv);
  }
}

// Alignment slack, the weight ring, the block's rows, the product warps'
// output buffers.
int dense_smem(int wg, int slices) {
  return 1024 + kStages * kBN * kSlice + slices * 64 * wg * kSlice + 4 * wg * kWarpBuf;
}

// The epilogue of one N tile (columns n_base ...) for a warp's 16 rows
// (wrow ...): the affine of each accumulator pair into the warp's buffer,
// 32 bytes of columns at a time (16 bf16 or 8 float32), then stored as
// whole row segments: 16, 8 or 4 bytes a lane where every row start is
// aligned to that, else element by element.
template <bool BF16>
__device__ __forceinline__ void dense_epilogue(const int (&acc)[kBN / 2], int n_base, int wrow, int lane,
                                               uint8_t* wbuf, float in_s, const float* __restrict__ w_scale,
                                               const float* __restrict__ bias, uint8_t* __restrict__ out,
                                               int M, int N, int out_align) {
  constexpr int OB = BF16 ? 2 : 4, CW = 32 / OB, JPC = CW / 8;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n_base + 8 * j + q2;
    const bool in0 = col < N, in1 = col + 1 < N;
    const float cs0 = in0 ? __fmul_rn(in_s, __ldg(w_scale + col)) : 0.f;
    const float cb0 = in0 ? __ldg(bias + col) : 0.f;
    const float cs1 = in1 ? __fmul_rn(in_s, __ldg(w_scale + col + 1)) : 0.f;
    const float cb1 = in1 ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = affine(acc[4 * j + 2 * h], cs0, cb0), v1 = affine(acc[4 * j + 2 * h + 1], cs1, cb1);
      uint8_t* dst = wbuf + (g + 8 * h) * 32 + (8 * (j % JPC) + q2) * OB;
      if constexpr (BF16) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      }
    }
    if (j % JPC != JPC - 1) continue;
    __syncwarp();
    const int c0 = n_base + 8 * (j + 1 - JPC), ncols = min(CW, N - c0);
    if (ncols == CW && out_align >= 16) {
      const int lr = lane >> 1, m = wrow + lr, b = (lane & 1) * 16;
      if (m < M)
        *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(m) * N + c0) * OB + b) =
            *reinterpret_cast<const uint4*>(wbuf + lr * 32 + b);
    } else if (ncols == CW && out_align >= 8) {
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int lr = 8 * pass + (lane >> 2), m = wrow + lr, b = (lane & 3) * 8;
        if (m < M)
          *reinterpret_cast<uint2*>(out + (static_cast<int64_t>(m) * N + c0) * OB + b) =
              *reinterpret_cast<const uint2*>(wbuf + lr * 32 + b);
      }
    } else if (ncols == CW && out_align >= 4) {
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const int lr = 4 * pass + (lane >> 3), m = wrow + lr, b = (lane & 7) * 4;
        if (m < M)
          *reinterpret_cast<uint32_t*>(out + (static_cast<int64_t>(m) * N + c0) * OB + b) =
              *reinterpret_cast<const uint32_t*>(wbuf + lr * 32 + b);
      }
    } else if (ncols > 0) {
      const int lr = lane >> 1, m = wrow + lr;
      if (m < M) {
        for (int e = lane & 1; e < ncols; e += 2) {
          if constexpr (BF16) {
            reinterpret_cast<uint16_t*>(out)[static_cast<int64_t>(m) * N + c0 + e] =
                *reinterpret_cast<const uint16_t*>(wbuf + lr * 32 + 2 * e);
          } else {
            reinterpret_cast<float*>(out)[static_cast<int64_t>(m) * N + c0 + e] =
                *reinterpret_cast<const float*>(wbuf + lr * 32 + 4 * e);
          }
        }
      }
    }
    __syncwarp();
  }
}

// Rows m0 .. m0 + BM of x against N tiles blockIdx.y * per_split ... of w.
// Warpgroups below WG compute; all 256 threads stage.  Thread t stages
// chunk t % 8 of weight rows t / 8 + 32 j.  PHASES: the phases compiled in
// (kPhaseAll in serving; staging is the rows' and the weights').
template <int SRC, int WG, int PHASES>
__global__ void __launch_bounds__(kThreads, 2) qdense_kernel(const DenseParams p) {
  constexpr int BM = 64 * WG, BROWS = kBN / (kThreads / 8);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* rows = ring + kStages * kBN * kSlice;  // slices x BM x 128
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  uint8_t* wbuf = rows + p.slices * BM * kSlice + (tid >> 5) * kWarpBuf;  // product warps'
  const int m0 = blockIdx.x * BM;
  const int nt0 = blockIdx.y * p.per_split;
  const int total = (min(p.n_tiles, nt0 + p.per_split) - nt0) * p.slices;
  const int chunk = tid & 7, row0 = tid >> 3;
  constexpr bool kStageOn = PHASES & kPhaseStage, kProductOn = PHASES & kPhaseProduct;
  constexpr bool kEpilogueOn = PHASES & kPhaseEpilogue;
  const bool computes = wg < WG;

  // Weight slice `step` (N tile step / slices, depth slice step % slices).
  auto stage = [&](int step) {
    const int t = step / p.slices, s = step - t * p.slices;
    uint8_t* Bs = ring + (step % kStages) * kBN * kSlice;
    const int8_t* src = p.w + static_cast<int64_t>((nt0 + t) * kBN + row0) * p.Kp + s * kSlice + 16 * chunk;
#pragma unroll
    for (int j = 0; j < BROWS; ++j)
      cp_async16(Bs + sw128(row0 + j * (kThreads / 8), chunk),
                 src + static_cast<int64_t>(j * (kThreads / 8)) * p.Kp, true);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if constexpr (kStageOn)
      if (i < total) stage(i);
    cp_commit();
  }
  if constexpr (kStageOn) {
    if (SRC == kBf16 && p.vec_in == 8) {
      quantize_rows<SRC, SRC == kBf16 ? 8 : 4, BM>(p, m0, tid, rows);
    } else if (p.vec_in == 4) {
      quantize_rows<SRC, 4, BM>(p, m0, tid, rows);
    } else {
      quantize_rows_scalar<SRC, BM>(p, m0, tid, rows);
    }
  }

  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  const float in_s = *p.in_scale;
  const int wrow = m0 + wg * 64 + warp * 16;
  uint8_t* out = static_cast<uint8_t*>(p.out);

  for (int i = 0; i < total; ++i) {
    // Slice i has landed (and, at i = 0, the rows); every warpgroup is done
    // with slice i - 1, so its buffer takes slice i + 3.
    cp_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if constexpr (kStageOn)
      if (i + kStages - 1 < total) stage(i + kStages - 1);
    cp_commit();
    const int t = i / p.slices, s = i - t * p.slices;
    if (!computes) continue;
    if constexpr (kProductOn) {
      const uint64_t da = sw128_desc(rows + s * (BM * kSlice) + wg * 64 * kSlice);
      const uint64_t db = sw128_desc(ring + (i % kStages) * kBN * kSlice);
      acc_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / kStep; ++kk)
        Wgmma<kBN>::run(acc, da + 2 * kk, db + 2 * kk, (s | kk) != 0);
      wg_commit();
      wg_wait<0>();
      acc_fence(acc);
    }
    if (s != p.slices - 1) continue;
    if constexpr (!kEpilogueOn) {
      // Without the epilogue, one shared store of the accumulators' XOR
      // keeps ptxas from dropping the products as unused.
      int keep = 0;
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) keep ^= acc[j];
      reinterpret_cast<int*>(wbuf)[lane] = keep;
      continue;
    }
    if (p.out_bf16) {
      dense_epilogue<true>(acc, (nt0 + t) * kBN, wrow, lane, wbuf, in_s, p.w_scale, p.bias, out, p.M, p.N,
                           p.out_align);
    } else {
      dense_epilogue<false>(acc, (nt0 + t) * kBN, wrow, lane, wbuf, in_s, p.w_scale, p.bias, out, p.M, p.N,
                            p.out_align);
    }
  }
  cp_wait<0>();
}

template <int SRC, int WG, int PHASES>
cudaError_t launch_dense(const DenseParams& p, int n_split, cudaStream_t s) {
  const int smem = dense_smem(WG, p.slices);
  auto kernel = qdense_kernel<SRC, WG, PHASES>;
  // A launch above 48 KB opts the kernel in to the most any launch of it
  // may take, not to its own bytes: the setting is the kernel's, and two
  // host threads launching it with different bytes would race between
  // setting and launching.
  if (smem > 48 * 1024) {
    const cudaError_t e = ipe::allow_smem(kernel, ipe::kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.M + 64 * WG - 1) / (64 * WG), n_split);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// Checks the arguments and launches; returns the launch's error.
template <int PHASES>
int qdense_run(const QdenseArgs* a) {
  const int wg = a->wg, src_bf16 = a->src_bf16, M = a->M, N = a->N, K = a->K, Kp = a->Kp;
  const int n_split = a->n_split, per_split = a->per_split, out_bf16 = a->out_bf16;
  const int vec_in = a->vec_in, out_align = a->out_align;
  const void *x = a->x, *w = a->w, *in_scale = a->in_scale, *w_scale = a->w_scale, *bias = a->bias;
  void *out = a->out, *stream = a->stream;
  const int slices = Kp / kSlice, n_tiles = (N + kBN - 1) / kBN;
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % kSlice || (wg != 1 && wg != 2) ||
      dense_smem(wg, slices) > ipe::kMaxSmem || n_split < 1 || per_split < 1 ||
      (n_split - 1) * per_split >= n_tiles || n_split * per_split < n_tiles)
    return (int)cudaErrorInvalidValue;
  const DenseParams p{x, static_cast<const int8_t*>(w), static_cast<const float*>(in_scale),
                      static_cast<const float*>(w_scale), static_cast<const float*>(bias), out,
                      M, N, K, Kp, slices, n_tiles, per_split, out_bf16, vec_in, out_align};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_bf16 * 2 + wg - 1) {
    case 0: return (int)launch_dense<kF32, 1, PHASES>(p, n_split, s);
    case 1: return (int)launch_dense<kF32, 2, PHASES>(p, n_split, s);
    case 2: return (int)launch_dense<kBf16, 1, PHASES>(p, n_split, s);
    case 3: return (int)launch_dense<kBf16, 2, PHASES>(p, n_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
