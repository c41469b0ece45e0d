// Window multi-head self-attention backward (W-MSA core) for Hopper.
//
// Replaces the TPU kernel `_qkv_vjp_bwd`, the backward of
// `window_attention_pallas_qkv_vjp` in
// infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py (bodies
// `_attn_qkv_bwd_kernel` and `_attn_qkv_bwd_kernel_packed`; the packed
// variant is an MXU-shaping device with the same result, so one kernel
// covers both).
//
// Contract, for each window w and head h, with q, k, v and dO read from the
// flat layouts of the forward (csrc/window_msa.cu):
//   S  = scale * q k^T + bias[h];  P = softmax(S)   (recomputed, never stored)
//   dV = P^T dO;  dP = dO v^T;  dS = P o (dP - rowsum(dP o P))
//   dQ = scale * dS k;  dK = scale * dS^T q;  dbias[h] = sum over windows of dS
//   qkv  (nW, N, 3C) in T (float or bf16);  bias (H, N, N) float32;
//   dout (nW, N, C) in T;  dqkv (nW, N, 3C) in T, head h at columns h*hd,
//   C + h*hd and 2C + h*hd;  dbias (H, N, N) float32.
//   All maths in float32; dqkv is cast once to T (round to nearest even).
//
// What bounds it: one (window, head) pair does about 10*N^2*hd FLOPs
// (0.94 MFLOP at N=49, hd=39) against about 8*N*hd*sizeof(T) bytes of
// device traffic (q, k, v, dO read; dq, dk, dv written: ~31 KB in bf16),
// some 30 FLOP/byte.  With its float32 maths on CUDA cores (67 TFLOP/s,
// a ridge of 20 FLOP/byte at 3.35 TB/s) that is bound by operations;
// on bf16 tensor cores (ridge ~295) it would be bound by memory.  So the
// design reads every input byte once, recomputes P in shared memory
// instead of storing it in the forward, and writes no N x N tile to
// device memory except one dbias partial per block.
//
// Design (a simple, correct first version):
//   * grid (chunks, H), 256 threads: block (c, h) walks the windows
//     [c*wpb, (c+1)*wpb) of head h one after the other;
//   * per window: q, k, v, dO of the head loaded once into shared memory as
//     float32 (odd row strides); one thread per (i, j) computes S and dP;
//     one warp per row takes the softmax, rowsum(dP o P) and dS; one
//     thread per (i, d) computes dq, dk and dv and writes them to dqkv;
//   * dbias: the block adds dS of each of its windows into an N x N
//     accumulator in shared memory (each entry owned by one thread, no
//     atomics) and writes it once, as the block's partial, to a scratch
//     (chunks, H, N, N) buffer; a second kernel sums the partials over the
//     chunks in a fixed order.  The result is deterministic: blocks run in
//     no order on the card, but no sum depends on that order.  The wrapper
//     picks wpb so that the grid holds a few blocks per SM, which keeps
//     the scratch at a few MB whatever nW is.
// N <= 64 and hd <= 64 are runtime values (hd = 39 for HRFormer-Base is
// ragged); the Python wrapper rejects anything larger.
//
// A head range (K3, the sharded W-MSA of kernels/window_msa.py): the C entry
// takes the model's H heads and a range [h0, h0 + Hl) of them.  The kernel
// runs over Hl heads at pointers moved by h0 heads (qkv, dout and dqkv by
// h0*hd columns, bias and dbias by h0 N x N tiles) with the full width C as
// its row stride, so it reads this rank's heads of qkv and dout in place,
// writes their columns of a full-width dqkv and their tiles of dbias, and
// keeps (chunks, Hl, N, N) partials.

#include <math_constants.h>

#include "ipe_common.cuh"

namespace {

using ipe::from_f32;
using ipe::odd_stride;
using ipe::to_f32;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kMaxN = 64;
constexpr int kMaxHd = 64;

__host__ __forceinline__ size_t smem_bytes(int N, int hd) {
  // q, k, v, dO: (N, odd hd); P, dP/dS: (N, odd N); dbias accumulator: N*N.
  return sizeof(float) * (4 * (size_t)N * odd_stride(hd) +
                          2 * (size_t)N * odd_stride(N) + (size_t)N * N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_msa_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      const T* __restrict__ dout, T* __restrict__ dqkv,
                      float* __restrict__ partial, int nW, int N, int H, int C,
                      int hd, float scale, int wpb) {
  extern __shared__ float smem[];
  const int ldq = odd_stride(hd);
  const int lds = odd_stride(N);
  float* q = smem;                 // (N, ldq)
  float* k = q + N * ldq;          // (N, ldq)
  float* v = k + N * ldq;          // (N, ldq)
  float* g = v + N * ldq;          // (N, ldq) dO
  float* p = g + N * ldq;          // (N, lds) S, then P
  float* ds = p + N * lds;         // (N, lds) dP, then dS
  float* acc = ds + N * lds;       // (N * N) dbias of this block's windows

  // H: the heads of this launch (gridDim.y); C: the row width of dout, and
  // a third of qkv's and dqkv's.
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bias_h = bias + (size_t)h * N * N;

  for (int idx = tid; idx < N * N; idx += kThreads) acc[idx] = 0.f;

  const int w_end = min(nW, (chunk + 1) * wpb);
  for (int w = chunk * wpb; w < w_end; ++w) {
    // Load q/k/v/dO of this (window, head); neighbouring threads read
    // neighbouring columns of one row.
    const T* base = qkv + (size_t)w * N * 3 * C + h * hd;
    const T* gbase = dout + (size_t)w * N * C + h * hd;
    for (int idx = tid; idx < N * hd; idx += kThreads) {
      const int n = idx / hd;
      const int d = idx - n * hd;
      const T* row = base + (size_t)n * 3 * C + d;
      q[n * ldq + d] = to_f32(row[0]);
      k[n * ldq + d] = to_f32(row[C]);
      v[n * ldq + d] = to_f32(row[2 * C]);
      g[n * ldq + d] = to_f32(gbase[(size_t)n * C + d]);
    }
    __syncthreads();

    // S[i][j] = scale * q_i . k_j + bias[h][i][j];  dP[i][j] = dO_i . v_j.
    for (int idx = tid; idx < N * N; idx += kThreads) {
      const int i = idx / N;
      const int j = idx - i * N;
      const float* qi = q + i * ldq;
      const float* kj = k + j * ldq;
      const float* gi = g + i * ldq;
      const float* vj = v + j * ldq;
      float sq = 0.f, sg = 0.f;
      for (int d = 0; d < hd; ++d) {
        sq = fmaf(qi[d], kj[d], sq);
        sg = fmaf(gi[d], vj[d], sg);
      }
      p[i * lds + j] = scale * sq + bias_h[idx];
      ds[i * lds + j] = sg;
    }
    __syncthreads();

    // One warp per row: P = softmax(S), r = rowsum(dP o P),
    // dS = P o (dP - r), and dS into the dbias accumulator.  Every lane
    // reads back only the entries it wrote itself.
    for (int i = warp; i < N; i += kThreads / 32) {
      float* pi = p + i * lds;
      float* di = ds + i * lds;
      float m = -CUDART_INF_F;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, pi[j]);
      m = ipe::warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(pi[j] - m);
        pi[j] = e;
        sum += e;
      }
      const float inv_sum = 1.f / ipe::warp_sum(sum);
      float r = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float pij = pi[j] * inv_sum;
        pi[j] = pij;
        r = fmaf(pij, di[j], r);
      }
      r = ipe::warp_sum(r);
      for (int j = lane; j < N; j += 32) {
        const float dsij = pi[j] * (di[j] - r);
        di[j] = dsij;
        acc[i * N + j] += dsij;
      }
    }
    __syncthreads();

    // dq[i][d] = scale * sum_j dS[i][j] k[j][d];
    // dk[i][d] = scale * sum_j dS[j][i] q[j][d];
    // dv[i][d] = sum_j P[j][i] dO[j][d].
    T* obase = dqkv + (size_t)w * N * 3 * C + h * hd;
    for (int idx = tid; idx < N * hd; idx += kThreads) {
      const int i = idx / hd;
      const int d = idx - i * hd;
      const float* dsi = ds + i * lds;
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int j = 0; j < N; ++j) {
        aq = fmaf(dsi[j], k[j * ldq + d], aq);
        ak = fmaf(ds[j * lds + i], q[j * ldq + d], ak);
        av = fmaf(p[j * lds + i], g[j * ldq + d], av);
      }
      T* row = obase + (size_t)i * 3 * C + d;
      row[0] = from_f32<T>(scale * aq);
      row[C] = from_f32<T>(scale * ak);
      row[2 * C] = from_f32<T>(av);
    }
    __syncthreads();  // the next window overwrites q, k, v, dO, P and dS
  }

  float* out = partial + ((size_t)chunk * H + h) * N * N;
  for (int idx = tid; idx < N * N; idx += kThreads) out[idx] = acc[idx];
}

// dbias[e] = sum over chunks c, in order, of partial[c][e], for the
// H*N*N entries e; neighbouring threads read neighbouring entries.
__global__ void __launch_bounds__(kReduceThreads)
dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                    int chunks, int entries) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= entries) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * entries + e];
  dbias[e] = s;
}

// Heads [h0, h0 + Hl) of H: pointers moved by h0 heads, Hl heads per chunk.
template <typename T>
cudaError_t launch(const void* qkv, const float* bias, const void* dout, void* dqkv,
                   float* dbias, float* partial, int nW, int N, int H, int h0,
                   int Hl, int hd, float scale, int wpb, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, hd);
  // Above 48 KB a block may use dynamic shared memory only after opting in;
  // set the attribute once per instantiation.
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(window_msa_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes(kMaxN, kMaxHd));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int chunks = (nW + wpb - 1) / wpb;
  const size_t col = (size_t)h0 * hd;
  const size_t tile = (size_t)h0 * N * N;
  window_msa_bwd_kernel<T><<<dim3(chunks, Hl), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv) + col, bias + tile,
      static_cast<const T*>(dout) + col, static_cast<T*>(dqkv) + col, partial,
      nW, N, Hl, H * hd, hd, scale, wpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int entries = Hl * N * N;
  dbias_reduce_kernel<<<(entries + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                        stream>>>(partial, dbias + tile, chunks, entries);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  scale is hd^-0.5, rounded to float32 by
// the caller as the plain version rounds it.  Computes heads [h0, h0 + Hl)
// of the H in qkv (h0 = 0, Hl = H: all): their columns of dqkv and their
// tiles of dbias, nothing else.  partial is float32 scratch of
// ceil(nW / wpb) * Hl * N * N entries.  Returns the launches' cudaError_t.
int ipe_window_msa_bwd(const void* qkv, const void* bias, const void* dout, void* dqkv,
                       void* dbias, void* partial, int nW, int N, int H, int h0, int Hl,
                       int hd, float scale, int wpb, int dtype, void* stream) {
  if (nW <= 0 || N <= 0 || N > kMaxN || hd <= 0 || hd > kMaxHd || H <= 0 ||
      H > 65535 || h0 < 0 || Hl <= 0 || h0 + Hl > H || wpb <= 0 || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* db = static_cast<float*>(dbias);
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    return (int)launch<float>(qkv, b, dout, dqkv, db, part, nW, N, H, h0, Hl, hd, scale,
                              wpb, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(qkv, b, dout, dqkv, db, part, nW, N, H, h0, Hl, hd,
                                      scale, wpb, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
