// The CUDA-core body of the W-MSA forward that K8's phase ablation
// (csrc/window_msa_ablate.cu) instantiates: K1's first design, kept
// for K8 only.  K1 and K1-hm themselves now run on the tensor-core core
// (csrc/window_msa.cu, csrc/wmsa_core.cuh), so K8's `full` variant is no
// longer K1's code: it is this body, held against its plain version and
// against K1 within the bf16 bound.
//
// `attend<T, P, WPB>` computes, for WPB consecutive windows of one head,
// out = softmax(hd^-0.5 * q k^T + bias[h]) v in float32 and casts the
// output once to T, reading the (nW, N, 3C) qkv projection in place
// (columns [q heads | k heads | v heads]) and writing (nW, N, C).
// Phase compiles phases of the body out:
//   kFull     the whole body: stage (q pre-scaled), scores + bias, softmax,
//             PV;
//   kEmpty    stage q, k, v unscaled, write out = q;
//   kGemmOnly stage (q pre-scaled), p = 0.01 * q k^T (no bias, no
//             softmax), out = p v;
//   kSoftOnly stage unscaled, s_ij = q_i0 + bias[0]_ij (the probe adds
//             head 0's bias to every head), p = softmax(s),
//             out = q * sum_j p_ij: no products.
// kEmpty and kSoftOnly leave k and v (and most of q) unread after staging;
// nvcc would drop those loads, so their values go into a checksum written
// only when `sink` is not null (the host always passes null).  The loads
// stay; the output does not change.
// WPB windows per block share the block's 128 threads; a window past nW
// is staged as zeros and its output dropped (the TPU pads nW to its block).
// The design: q, k, v as float32 in odd-stride shared rows, one thread per
// score (hd FMAs from shared memory), a warp per softmax row, one thread
// per output element (N FMAs from shared memory).

#pragma once

#include <math_constants.h>

#include "ipe_common.cuh"

namespace ipe {
namespace wmsa {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxHd = 64;

enum class Phase { kFull, kEmpty, kGemmOnly, kSoftOnly };

// Shared memory of one window: q, k, v (N, odd(hd)) and the scores
// (N, odd(N)) as float32, and N per-row scalars.
__host__ __forceinline__ size_t smem_floats_per_window(int N, int hd) {
  return 3 * (size_t)N * odd_stride(hd) + (size_t)N * odd_stride(N) + N;
}

__host__ __forceinline__ size_t smem_bytes(int N, int hd, int wpb) {
  return sizeof(float) * smem_floats_per_window(N, hd) * wpb;
}

// (local window, row, column) of flat index idx over WPB x rows x cols, and
// the index within the window (idx itself when WPB = 1).
template <int WPB>
__device__ __forceinline__ void split3(int idx, int rows, int cols, int& wl,
                                       int& r, int& c, int& rem) {
  if constexpr (WPB == 1) {
    wl = 0;
  } else {
    wl = idx / (rows * cols);
    idx -= wl * rows * cols;
  }
  rem = idx;
  r = idx / cols;
  c = idx - r * cols;
}

// One block: windows blockIdx.x * WPB .. + WPB - 1 of head blockIdx.y of
// the (nW, N, 3C) qkv `a`.
template <typename T, Phase P, int WPB>
__device__ __forceinline__ void attend(const T* __restrict__ a,
                                       const float* __restrict__ bias,
                                       T* __restrict__ out, int nW, int N,
                                       int H, int hd, float scale,
                                       float* sink) {
  constexpr bool kScaled = P == Phase::kFull || P == Phase::kGemmOnly;
  constexpr bool kKeepAlive = P == Phase::kEmpty || P == Phase::kSoftOnly;
  extern __shared__ float smem[];
  const int ldq = odd_stride(hd);
  const int lds = odd_stride(N);
  float* q = smem;                   // (WPB, N, ldq), pre-scaled if kScaled
  float* k = q + WPB * N * ldq;      // (WPB, N, ldq)
  float* v = k + WPB * N * ldq;      // (WPB, N, ldq)
  float* s = v + WPB * N * ldq;      // (WPB, N, lds) scores, then exp(s - max)
  float* row_scale = s + WPB * N * lds;  // (WPB, N) 1 / rowsum, or sum_j p

  const int w0 = blockIdx.x * WPB;
  const int h = blockIdx.y;
  const int C = H * hd;
  const int tid = threadIdx.x;
  float check = 0.f;

  // Stage q/k/v of these windows; neighbouring threads read neighbouring
  // columns of one row.
  const T* base = a + (size_t)w0 * N * 3 * C + h * hd;
  for (int idx = tid; idx < WPB * N * hd; idx += kThreads) {
    int wl, n, d, rem;
    split3<WPB>(idx, N, hd, wl, n, d, rem);
    const int r = wl * N + n;  // row within the block
    if (WPB > 1 && w0 + wl >= nW) {
      q[r * ldq + d] = k[r * ldq + d] = v[r * ldq + d] = 0.f;
      continue;
    }
    const T* row = base + (size_t)r * 3 * C + d;
    const float qf = to_f32(row[0]);
    q[r * ldq + d] = kScaled ? qf * scale : qf;
    const float kf = to_f32(row[C]);
    k[r * ldq + d] = kf;
    const float vf = to_f32(row[2 * C]);
    v[r * ldq + d] = vf;
    if constexpr (kKeepAlive) check += qf + kf + vf;
  }
  if constexpr (kKeepAlive) {
    if (sink) atomicAdd(sink, check);
  }
  __syncthreads();

  if constexpr (P != Phase::kEmpty) {
    // Scores s[i][j]: kFull q_i . k_j + bias[h][i][j]; kGemmOnly
    // 0.01 * q_i . k_j; kSoftOnly q_i0 + bias[0][i][j].
    const float* bias_h =
        bias ? bias + (size_t)(P == Phase::kSoftOnly ? 0 : h) * N * N : nullptr;
    for (int idx = tid; idx < WPB * N * N; idx += kThreads) {
      int wl, i, j, rem;
      split3<WPB>(idx, N, N, wl, i, j, rem);
      const float* qi = q + (wl * N + i) * ldq;
      float acc = 0.f;
      if constexpr (P == Phase::kSoftOnly) {
        acc = qi[0];
      } else {
        const float* kj = k + (wl * N + j) * ldq;
        for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], kj[d], acc);
      }
      if constexpr (P == Phase::kGemmOnly) {
        acc *= 0.01f;
      } else {
        if (bias_h) acc += bias_h[rem];
      }
      s[(wl * N + i) * lds + j] = acc;
    }
    __syncthreads();
  }

  if constexpr (P == Phase::kFull || P == Phase::kSoftOnly) {
    // Row softmax, one warp per row: p = exp(s - max), then row_scale =
    // 1 / sum(p) (kFull) or sum_j p_ij / sum(p) (kSoftOnly).
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int i = warp; i < WPB * N; i += kThreads / 32) {
      float* si = s + i * lds;
      float m = -CUDART_INF_F;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, si[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(si[j] - m);
        si[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if constexpr (P == Phase::kFull) {
        if (lane == 0) row_scale[i] = 1.f / sum;
      } else {
        const float inv = 1.f / sum;
        float psum = 0.f;
        for (int j = lane; j < N; j += 32) psum += si[j] * inv;
        psum = warp_sum(psum);
        if (lane == 0) row_scale[i] = psum;
      }
    }
    __syncthreads();
  }

  // Output row i, column d; neighbouring threads write neighbouring columns
  // of one output row.  kFull: sum_j p_ij v_jd / rowsum; kGemmOnly:
  // sum_j p_ij v_jd; kSoftOnly: q_id * sum_j p_ij; kEmpty: q_id.
  T* obase = out + (size_t)w0 * N * C + h * hd;
  const int ldo = C;
  for (int idx = tid; idx < WPB * N * hd; idx += kThreads) {
    int wl, i, d, rem;
    split3<WPB>(idx, N, hd, wl, i, d, rem);
    const int r = wl * N + i;
    if (WPB > 1 && w0 + wl >= nW) continue;
    if constexpr (P == Phase::kFull || P == Phase::kGemmOnly) {
      const float* pi = s + r * lds;
      const float* vw = v + wl * N * ldq;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(pi[j], vw[j * ldq + d], acc);
      if constexpr (P == Phase::kFull) {
        obase[(size_t)r * ldo + d] = from_f32<T>(acc * row_scale[r]);
      } else {
        obase[(size_t)r * ldo + d] = from_f32<T>(acc);
      }
    } else if constexpr (P == Phase::kSoftOnly) {
      obase[(size_t)r * ldo + d] = from_f32<T>(q[r * ldq + d] * row_scale[r]);
    } else {
      obase[(size_t)r * ldo + d] = from_f32<T>(q[r * ldq + d]);
    }
  }
}

}  // namespace wmsa
}  // namespace ipe
