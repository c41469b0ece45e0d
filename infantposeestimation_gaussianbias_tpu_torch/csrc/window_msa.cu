// K1 and K1-hm: fused window multi-head self-attention forward (W-MSA
// core) for Hopper.
//
// K1 replaces the TPU kernel `window_attention_pallas_qkv` in
// infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py:222
// (bodies `_attn_qkv_kernel` and `_attn_qkv_kernel_packed`; the packed
// variant is an MXU-shaping device with the same result, so one kernel
// covers both).  K1-hm replaces `window_attention_pallas_hm`
// (window_msa.py:50, body `_attn_kernel`): the same maths on head-major
// operands.
//
// Contract (ops/msa.py `window_attention` on the flat qkv layout):
//   qkv  (nW, N, 3C) in T (float or bf16), columns [q heads | k heads | v heads];
//        head h reads columns h*hd, C + h*hd and 2C + h*hd at row stride 3C.
//   bias (H, N, N) float32, or null for no bias (the same as zeros).
//   out  (nW, N, C) in T; head h writes columns h*hd at row stride C.
//   For each (window, head): out = softmax(hd^-0.5 * q k^T + bias[h]) v,
//   float32 accumulation, the output cast once to T (round to nearest
//   even).  K1-hm: q, k, v and out (H, nW, N, hd), read and written in
//   place.
//
// What bounds it: one (window, head) pair does about 4*N^2*hd FLOPs
// (0.37 MFLOP at N=49, hd=39) against about 4*N*hd*sizeof(T) bytes of
// device traffic (~15 KB in bf16), some 25 FLOP/byte, far under the
// ~295 FLOP/byte at which the H100's bf16 tensor cores become the limit:
// device memory bounds it (0.0409 ms at hrformer_base b0, b = 64, bf16).
// The first design (one block per (window, head), q, k, v as float32 in
// shared memory, one thread per score and per output element on the CUDA
// cores) spent most of its time in those products: shared-memory
// bandwidth set its pace, at ~17x its bound.  Now (the kernel itself is
// in csrc/window_msa_fwd.cuh, which K8 instantiates too):
//   * the maths is the tensor-core forward core that K4's forward and
//     the backward's recompute share (csrc/wmsa_core.cuh `attention_fwd`:
//     bf16 `mma.sync` with float32 accumulation, S and the row softmax in
//     registers, P fed back as the A operand of O = P v);
//   * grid (chunks, H), 128 threads: block (c, h) walks the windows
//     [c*wpb, (c+1)*wpb) of head h (wpb from the host plan,
//     kernels/window_msa.py `fwd_plan`: about 4 blocks per SM, as K2),
//     two stages deep: the next window's q, k, v rows stream into a
//     staging buffer as whole 16-byte units (cp.async) while this window
//     computes, and are converted into the core's operand tiles once it
//     is done (csrc/wmsa_stage.cuh, K2's staging);
//   * head h's (N, N) bias tile is staged in shared memory once per
//     block, for all its windows;
//   * O's element pairs go from the accumulators to device memory, cast
//     once to T.
// Numerics: bf16 q, k, v are one exact bf16 term; float32 ones two (S
// keeps the term pairs i + j < 2), P two, and O = P v the pairs i + j < 2:
// within 1e-4 of the plain version's float32 maths at every hrformer
// shape (tests/test_torch_k1_core.py: one term is ~1e-2 off, a third
// changes next to nothing, since P and v keep two).  Every sum of a
// (window, head) runs in a fixed order and reads nothing of another
// window or head, so the result does not depend on wpb, on the chunk or on
// the head range (K3's shard equals K1 bit for bit), and K1-hm equals K1
// bit for bit on the same q, k, v.
// N <= 64 and hd <= 64 are runtime values (hd = 39 for HRFormer-Base is
// ragged); the Python wrapper rejects anything larger.
//
// A head range (K3, the sharded W-MSA of kernels/window_msa.py): the C entry
// takes the model's H heads and a range [h0, h0 + Hl) of them, and launches
// the same kernel over Hl heads at pointers moved by h0 heads (qkv and out
// by h0*hd columns, bias by h0 N x N tiles).  The kernel's row strides stay
// 3C and C of the full width, so it reads this rank's heads of the full
// (nW, N, 3C) qkv in place and writes their columns of a full-width
// (nW, N, C) output: no slice copy.

#include "window_msa_fwd.cuh"

namespace {

// K1: heads [h0, h0 + Hl) of H, at pointers moved by h0 heads.
template <typename T>
cudaError_t launch_flat(const void* qkv, const float* bias, void* out, int nW, int N, int H,
                        int h0, int Hl, int hd, float scale, int wpb, cudaStream_t stream) {
  const int C = H * hd;
  const size_t col = (size_t)h0 * hd;
  const T* x = static_cast<const T*>(qkv);
  return launch<T, Layout::kFlatQkv>(
      x + col, nullptr, nullptr, bias ? bias + (size_t)h0 * N * N : nullptr,
      static_cast<T*>(out) + col, nW, N, C, Hl, hd, scale, wpb, stream);
}

template <typename T>
cudaError_t launch_hm(const void* q, const void* k, const void* v, const float* bias,
                      void* out, int nW, int N, int H, int hd, float scale, int wpb,
                      cudaStream_t stream) {
  return launch<T, Layout::kHeadMajor>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), bias, static_cast<T*>(out), nW,
                                       N, H * hd, H, hd, scale, wpb, stream);
}

bool bad_sizes(int nW, int N, int H, int hd, int wpb) {
  return nW <= 0 || N <= 0 || N > kMaxN || hd <= 0 || hd > kMaxHd || H <= 0 ||
         H > 65535 || wpb <= 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  scale is hd^-0.5, rounded to float32 by
// the caller as the plain version rounds it.  Computes heads [h0, h0 + Hl)
// of the H in qkv (h0 = 0, Hl = H: all) and writes only their columns of
// out.  wpb: windows per block.  Returns the launch's cudaError_t.
int ipe_window_msa_fwd(const void* qkv, const void* bias, void* out, int nW, int N,
                       int H, int h0, int Hl, int hd, float scale, int wpb, int dtype,
                       void* stream) {
  if (bad_sizes(nW, N, H, hd, wpb) || h0 < 0 || Hl <= 0 || h0 + Hl > H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch_flat<float>(qkv, b, out, nW, N, H, h0, Hl, hd, scale, wpb, st);
  if (dtype == 1)
    return (int)launch_flat<bf16>(qkv, b, out, nW, N, H, h0, Hl, hd, scale, wpb, st);
  return (int)cudaErrorInvalidValue;
}

// K1-hm: q, k, v and out (H, nW, N, hd) contiguous, one dtype; bias as above
// (null: no bias, the same as zeros).
int ipe_window_msa_hm_fwd(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int nW, int N, int H,
                          int hd, float scale, int wpb, int dtype, void* stream) {
  if (bad_sizes(nW, N, H, hd, wpb)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch_hm<float>(q, k, v, b, out, nW, N, H, hd, scale, wpb, st);
  if (dtype == 1)
    return (int)launch_hm<bf16>(q, k, v, b, out, nW, N, H, hd, scale, wpb, st);
  return (int)cudaErrorInvalidValue;
}

const char* ipe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
