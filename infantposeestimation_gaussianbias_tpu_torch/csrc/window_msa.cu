// Fused window multi-head self-attention forward (W-MSA core) for Hopper.
//
// Replaces the TPU kernel `window_attention_pallas_qkv` in
// infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py (bodies
// `_attn_qkv_kernel` and `_attn_qkv_kernel_packed`; the packed variant is
// an MXU-shaping device with the same result, so one kernel covers both).
//
// Contract (ops/msa.py `window_attention` on the flat qkv layout):
//   qkv  (nW, N, 3C) in T (float or bf16), columns [q heads | k heads | v heads];
//        head h reads columns h*hd, C + h*hd and 2C + h*hd at row stride 3C.
//   bias (H, N, N) float32, or null for no bias.
//   out  (nW, N, C) in T; head h writes columns h*hd at row stride C.
//   For each (window, head): out = softmax(hd^-0.5 * q k^T + bias[h]) v,
//   all maths in float32, the output cast once to T (round to nearest even).
//
// What bounds it: one (window, head) pair does about 4*N^2*hd FLOPs
// (0.37 MFLOP at N=49, hd=39) against about 4*N*hd*sizeof(T) bytes of
// device traffic (~15 KB in bf16), some 25 FLOP/byte, far under the
// ~295 FLOP/byte at which the H100's bf16 tensor cores become the limit.
// The kernel is bandwidth-bound, so the design reads every qkv byte once,
// keeps the N x N score tile in shared memory and never writes scores to
// device memory.  The bias tile (H*N*N*4 bytes, at most 256 KB) is re-read
// by every window from L2, where it stays resident.
//
// Design (a simple, correct first version):
//   * one thread block per (window, head): grid (nW, H), 128 threads;
//   * q (pre-scaled), k and v of that head loaded once into shared memory
//     as float32, rows padded to an odd stride so that threads reading
//     different rows of one column hit different banks;
//   * scores: one thread per (i, j) entry, dot product over hd;
//   * softmax: one warp per row, max and sum by warp shuffles;
//   * p v: one thread per (i, d) output element, normalised by 1/rowsum.
// N <= 64 and hd <= 64 are runtime values (hd = 39 for HRFormer-Base is
// ragged); the Python wrapper rejects anything larger.

#include <math_constants.h>

#include "ipe_common.cuh"

namespace {

using ipe::from_f32;
using ipe::odd_stride;
using ipe::to_f32;

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxHd = 64;

__host__ __forceinline__ size_t smem_bytes(int N, int hd) {
  return sizeof(float) * (3 * (size_t)N * odd_stride(hd) + (size_t)N * odd_stride(N) + N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_msa_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      T* __restrict__ out, int N, int H, int hd, float scale) {
  extern __shared__ float smem[];
  const int ldq = odd_stride(hd);
  const int lds = odd_stride(N);
  float* q = smem;                 // (N, ldq), pre-scaled
  float* k = q + N * ldq;          // (N, ldq)
  float* v = k + N * ldq;          // (N, ldq)
  float* s = v + N * ldq;          // (N, lds) scores, then exp(scores - max)
  float* inv_sum = s + N * lds;    // (N)

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int C = H * hd;
  const int tid = threadIdx.x;

  // Load q/k/v of this (window, head); neighbouring threads read
  // neighbouring columns of one row.
  const T* base = qkv + (size_t)w * N * 3 * C + h * hd;
  for (int idx = tid; idx < N * hd; idx += kThreads) {
    const int n = idx / hd;
    const int d = idx - n * hd;
    const T* row = base + (size_t)n * 3 * C + d;
    q[n * ldq + d] = to_f32(row[0]) * scale;
    k[n * ldq + d] = to_f32(row[C]);
    v[n * ldq + d] = to_f32(row[2 * C]);
  }
  __syncthreads();

  // Scores s[i][j] = q_i . k_j + bias[h][i][j].
  const float* bias_h = bias ? bias + (size_t)h * N * N : nullptr;
  for (int idx = tid; idx < N * N; idx += kThreads) {
    const int i = idx / N;
    const int j = idx - i * N;
    const float* qi = q + i * ldq;
    const float* kj = k + j * ldq;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], kj[d], acc);
    if (bias_h) acc += bias_h[idx];
    s[i * lds + j] = acc;
  }
  __syncthreads();

  // Row softmax, one warp per row: p = exp(s - max), inv_sum = 1 / sum(p).
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = warp; i < N; i += kThreads / 32) {
    float* si = s + i * lds;
    float m = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, si[j]);
    m = ipe::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(si[j] - m);
      si[j] = e;
      sum += e;
    }
    sum = ipe::warp_sum(sum);
    if (lane == 0) inv_sum[i] = 1.f / sum;
  }
  __syncthreads();

  // out[i][d] = sum_j p[i][j] v[j][d] / sum_i; neighbouring threads write
  // neighbouring columns of one output row.
  T* obase = out + (size_t)w * N * C + h * hd;
  for (int idx = tid; idx < N * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    const float* pi = s + i * lds;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(pi[j], v[j * ldq + d], acc);
    obase[(size_t)i * C + d] = from_f32<T>(acc * inv_sum[i]);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const float* bias, void* out, int nW, int N,
                   int H, int hd, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, hd);
  // Above 48 KB a block may use dynamic shared memory only after opting in;
  // set the attribute once per instantiation.
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    const size_t most = smem_bytes(kMaxN, kMaxHd);
    cudaError_t err = cudaFuncSetAttribute(window_msa_fwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)most);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid(nW, H);
  window_msa_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<T*>(out), N, H, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  scale is hd^-0.5, rounded to float32 by
// the caller as the plain version rounds it.  Returns the launch's cudaError_t.
int ipe_window_msa_fwd(const void* qkv, const void* bias, void* out, int nW, int N,
                       int H, int hd, float scale, int dtype, void* stream) {
  if (nW <= 0 || N <= 0 || N > kMaxN || hd <= 0 || hd > kMaxHd ||
      H <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(qkv, b, out, nW, N, H, hd, scale, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(qkv, b, out, nW, N, H, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ipe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
