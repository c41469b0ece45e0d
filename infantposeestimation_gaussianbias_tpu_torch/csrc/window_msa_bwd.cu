// K2: window multi-head self-attention backward (W-MSA core) for Hopper.
//
// Replaces the TPU kernel `_qkv_vjp_bwd`, the backward of
// `window_attention_pallas_qkv_vjp` in
// infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py:422
// (bodies `_attn_qkv_bwd_kernel` and `_attn_qkv_bwd_kernel_packed`; the
// packed variant is an MXU-shaping device with the same result, so one
// kernel covers both).
//
// Contract, for each window w and head h, with q, k, v and dO read from the
// flat layouts of the forward (csrc/window_msa.cu):
//   S  = scale * q k^T + bias[h];  P = softmax(S)   (recomputed, never stored)
//   dV = P^T dO;  dP = dO v^T;  dS = P o (dP - rowsum(dP o P))
//   dQ = scale * dS k;  dK = scale * dS^T q;  dbias[h] = sum over windows of dS
//   qkv  (nW, N, 3C) in T (float or bf16);  bias (H, N, N) float32;
//   dout (nW, N, C) in T;  dqkv (nW, N, 3C) in T, head h at columns h*hd,
//   C + h*hd and 2C + h*hd;  dbias (H, N, N) float32.
//   Float32 inputs and accumulation; the products in split-bf16 terms as
//   csrc/wmsa_core.cuh states (P and dS in two terms, ~2^-17
//   relative), within 1e-4 of the plain version's float32 maths; dqkv is
//   cast once to T (round to nearest even).
//
// What bounds it: per (window, head) ~10 N^2 hd FLOPs (0.94 MFLOP at
// N = 49, hd = 39) against ~7 N hd sizeof(T) bytes of device traffic (q, k,
// v, dO read; dq, dk, dv written): ~34 FLOP/byte in bf16, under the H100's
// bf16 tensor-core ridge (~295), so device memory bounds it (0.0358 ms at
// hrformer_base b0, b = 32).  The float32 version this replaces ran the
// products on the CUDA cores out of shared memory, one thread per output
// element, and shared-memory bandwidth set its pace (0.89 of 0.90 ms of
// device time at b0 was that kernel on an NVIDIA H100, PERF.md).  Now:
//   * the attention maths is the shared tensor-core core
//     (csrc/wmsa_core.cuh), 4 warps on one (window, head);
//   * grid (chunks, H), 128 threads: block (c, h) walks the windows
//     [c*wpb, (c+1)*wpb) of head h, two stages deep: the next window's q,
//     k, v and dO rows stream into a staging buffer with cp.async while
//     this window computes on the operand tiles, and are converted into
//     them (bf16 stays bf16; float32 becomes three bf16 terms) once it is
//     done (csrc/wmsa_stage.cuh, which K1 shares).  A head's columns start
//     at h*hd elements, only 2-byte aligned at hd = 39: a row is copied as
//     the 16-byte units that hold it, and the conversion shifts it to its
//     first element;
//   * registers bounded for 4 blocks (16 warps) per SM in bf16, whose
//     shared memory (~52 KB at b0) allows that many;
//   * dbias: each thread adds dS of the block's windows at its own (i, j)
//     into registers (no atomics) and the block writes them once, as its
//     partial, to a scratch (chunks, H, N, N) buffer; a second kernel sums
//     the partials over the chunks in a fixed order.  Deterministic:
//     blocks run in no order on the card, but no sum depends on that
//     order.
// N <= 64 and hd <= 64 are runtime values; the Python wrapper rejects
// anything larger.
//
// A head range (K3, the sharded W-MSA of kernels/window_msa.py): the C entry
// takes the model's H heads and a range [h0, h0 + Hl) of them.  The kernel
// runs over Hl heads at pointers moved by h0 heads (qkv, dout and dqkv by
// h0*hd columns, bias and dbias by h0 N x N tiles) with the full width C as
// its row stride, so it reads this rank's heads of qkv and dout in place,
// writes their columns of a full-width dqkv and their tiles of dbias, and
// keeps (chunks, Hl, N, N) partials.  A (window, head)'s dq, dk and dv do
// not depend on the other heads or windows of the launch: K3's equal K2's
// bit for bit.

#include <cstdint>

#include "wmsa_stage.cuh"

namespace {

using ipe::from_f32;
using wcore::bf16;
using wcore::kThreads;

constexpr int kReduceThreads = 256;
constexpr int kMaxN = wcore::kMaxN;
constexpr int kMaxHd = wcore::kMaxHd;
using wstage::row_words;

// bf16 terms of the core's operands: a bf16 input is exact in one, a float
// one takes three (csrc/wmsa_core.cuh, Numerics).
template <typename T>
constexpr int kTerms = sizeof(T) == 2 ? 1 : 3;

// exchange | zero row | operands: 4 x kTerms (N, operand_ld) bf16 tiles |
// staging: 4 (N, row_words) word tiles.
__host__ __device__ __forceinline__ size_t operands_offset(int N) {
  return wcore::exchange_bytes(N) + sizeof(wcore::bf16) * wcore::kZeroRow;
}

template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int N, int hd) {
  return operands_offset(N) +
         sizeof(wcore::bf16) * 4 * kTerms<T> * (size_t)N * wcore::operand_ld(hd) +
         sizeof(uint32_t) * 4 * (size_t)N * row_words<T>(hd);
}

// Blocks per SM the registers are bounded for: 4 fit the bf16 kernel's
// shared memory, 2 the float one's.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 4 : 2)
window_msa_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      const T* __restrict__ dout, T* __restrict__ dqkv,
                      float* __restrict__ partial, int nW, int N, int H, int C, int hd,
                      float scale, int wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NI = kTerms<T>;
  bf16* xch = reinterpret_cast<bf16*>(smem);
  bf16* zrow = reinterpret_cast<bf16*>(smem + wcore::exchange_bytes(N));
  bf16* opnd = reinterpret_cast<bf16*>(smem + operands_offset(N));
  const int ld = wcore::operand_ld(hd);
  const int term = N * ld;
  uint32_t* stage = reinterpret_cast<uint32_t*>(opnd + 4 * NI * term);

  // H: the heads of this launch (gridDim.y); C: the row width of dout, and
  // a third of qkv's and dqkv's.
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* bias_h = bias + (size_t)h * N * N;

  // Zeros: the zero row and the operands' padding columns (windows write
  // only the columns < hd).
  for (int i = tid; i < wcore::kZeroRow + 4 * NI * term; i += kThreads)
    zrow[i] = __float2bfloat16(0.f);  // the operands follow the zero row

  // Window w's four tiles (0 q, 1 k, 2 v, 3 dO) of head h in device memory.
  auto tiles = [&](int w, wstage::Tile<T> (&t)[4]) {
#pragma unroll
    for (int s = 0; s < 3; ++s)
      t[s] = {qkv + (size_t)w * N * 3 * C + s * C + h * hd, 3 * (size_t)C};
    t[3] = {dout + (size_t)w * N * C + h * hd, (size_t)C};
  };
  wstage::Tile<T> src[4];

  float dbias[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbias[nt][e] = 0.f;

  const int w_begin = chunk * wpb;
  const int w_end = min(nW, w_begin + wpb);
  tiles(w_begin, src);
  wstage::issue(src, stage, N, hd);
  for (int w = w_begin; w < w_end; ++w) {
    wstage::cp_async_wait_all();
    __syncthreads();  // window w staged (and, the first time, the zeros)
    tiles(w, src);
    wstage::convert<T, NI>(src, stage, opnd, N, hd, ld, term);
    __syncthreads();  // the stage is free, the operands written
    if (w + 1 < w_end) {  // in flight while this window computes
      tiles(w + 1, src);
      wstage::issue(src, stage, N, hd);
    }

    auto operand = [&](int s) { return wcore::Operand{opnd + s * NI * term, ld, term}; };
    T* obase = dqkv + (size_t)w * N * 3 * C + h * hd;
    wcore::attention_bwd<NI, false>(
        operand(0), operand(1), operand(2), operand(3), N, hd, scale,
        [&](int i, int j) { return __ldg(bias_h + i * N + j); },
        [&](int nt, int e, int, int, float x) { dbias[nt][e] += x; }, xch, zrow, nullptr,
        [&](int kind, int i, int d, float x0, float x1, bool two) {
          wcore::store_pair(obase + (size_t)i * 3 * C + kind * C + d, x0, x1, two);
        });
  }
  if (warp < (N + 15) / 16)
    wcore::store_dbias(dbias, N, partial + ((size_t)chunk * H + h) * N * N);
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
  const size_t smem = smem_bytes<T>(N, hd);
  cudaError_t err = ipe::allow_smem(window_msa_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (nW + wpb - 1) / wpb;
  const size_t col = (size_t)h0 * hd;
  const size_t tile = (size_t)h0 * N * N;
  const int C = H * hd;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  window_msa_bwd_kernel<T><<<dim3(chunks, Hl), kThreads, smem, stream>>>(
      q + col, bias + tile, g + col, static_cast<T*>(dqkv) + col, partial, nW, N, Hl, C, hd,
      scale, wpb);
  err = cudaGetLastError();
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
