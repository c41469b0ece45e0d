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
//
// A head range (K3, the sharded W-MSA of kernels/window_msa.py): the C entry
// takes the model's H heads and a range [h0, h0 + Hl) of them, and launches
// the same kernel over Hl heads at pointers moved by h0 heads (qkv and out
// by h0*hd columns, bias by h0 N x N tiles).  The kernel's row strides stay
// 3C and C of the full width, so it reads this rank's heads of the full
// (nW, N, 3C) qkv in place and writes their columns of a full-width
// (nW, N, C) output: no slice copy, and K1's instantiation is unchanged.
//
// The body lives in window_msa_body.cuh.  This file instantiates it twice:
// K1 on the flat qkv layout, and K1-hm, which replaces
// `window_attention_pallas_hm` (window_msa.py:50, body `_attn_kernel`):
// the same maths on head-major (H, nW, N, hd) q, k, v, read in place, with
// an (H, nW, N, hd) output.  Same grid, same bound.

#include "window_msa_body.cuh"

namespace {

using ipe::wmsa::kMaxHd;
using ipe::wmsa::kMaxN;
using ipe::wmsa::kThreads;
using ipe::wmsa::Layout;
using ipe::wmsa::Phase;
using ipe::wmsa::smem_bytes;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_msa_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      T* __restrict__ out, int N, int H, int hd, float scale) {
  ipe::wmsa::attend<T, Layout::kFlatQkv, Phase::kFull, 1>(
      qkv, nullptr, nullptr, bias, out, gridDim.x, N, H, hd, scale, nullptr);
}

// K1-hm: the same body on head-major (H, nW, N, hd) q, k, v.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_msa_hm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, int N, int H, int hd, float scale) {
  ipe::wmsa::attend<T, Layout::kHeadMajor, Phase::kFull, 1>(
      q, k, v, bias, out, gridDim.x, N, H, hd, scale, nullptr);
}

// Heads [h0, h0 + Hl) of H: grid (nW, Hl) at pointers moved by h0 heads.
template <typename T>
cudaError_t launch(const void* qkv, const float* bias, void* out, int nW, int N,
                   int H, int h0, int Hl, int hd, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N, hd, 1);
  static bool opted_in = false;
  cudaError_t err = ipe::wmsa::opt_in(window_msa_fwd_kernel<T>, smem,
                                      smem_bytes(kMaxN, kMaxHd, 1), opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid(nW, Hl);
  const size_t col = (size_t)h0 * hd;
  window_msa_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv) + col,
      bias ? bias + (size_t)h0 * N * N : nullptr, static_cast<T*>(out) + col,
      N, H, hd, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hm(const void* q, const void* k, const void* v,
                      const float* bias, void* out, int nW, int N, int H,
                      int hd, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, hd, 1);
  static bool opted_in = false;
  cudaError_t err = ipe::wmsa::opt_in(window_msa_hm_fwd_kernel<T>, smem,
                                      smem_bytes(kMaxN, kMaxHd, 1), opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid(nW, H);
  window_msa_hm_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), N, H, hd, scale);
  return cudaGetLastError();
}

bool bad_sizes(int nW, int N, int H, int hd) {
  return nW <= 0 || N <= 0 || N > kMaxN || hd <= 0 || hd > kMaxHd || H <= 0 ||
         H > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  scale is hd^-0.5, rounded to float32 by
// the caller as the plain version rounds it.  Computes heads [h0, h0 + Hl)
// of the H in qkv (h0 = 0, Hl = H: all) and writes only their columns of
// out.  Returns the launch's cudaError_t.
int ipe_window_msa_fwd(const void* qkv, const void* bias, void* out, int nW, int N,
                       int H, int h0, int Hl, int hd, float scale, int dtype,
                       void* stream) {
  if (bad_sizes(nW, N, H, hd) || h0 < 0 || Hl <= 0 || h0 + Hl > H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch<float>(qkv, b, out, nW, N, H, h0, Hl, hd, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(qkv, b, out, nW, N, H, h0, Hl, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K1-hm: q, k, v and out (H, nW, N, hd) contiguous, one dtype; bias as above
// (null: no bias, the same as zeros).
int ipe_window_msa_hm_fwd(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int nW, int N, int H,
                          int hd, float scale, int dtype, void* stream) {
  if (bad_sizes(nW, N, H, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch_hm<float>(q, k, v, b, out, nW, N, H, hd, scale, st);
  if (dtype == 1)
    return (int)launch_hm<__nv_bfloat16>(q, k, v, b, out, nW, N, H, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ipe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
