// The W-MSA forward kernel of K1 and K1-hm (csrc/window_msa.cu) and of
// K8's phase ablation (csrc/window_msa_ablate.cu): one block of 128
// threads per (chunk of windows, head), the head's q, k, v rows staged by
// csrc/wmsa_stage.cuh and the attention computed by the forward core of
// csrc/wmsa_core.cuh.  csrc/window_msa.cu states the design, the numerics
// and what bounds it.  Both files include this one, so K8's `full` is K1's
// own instantiation (the same template and arguments) and equals K1 bit
// for bit; K8's other phases compile parts of it out (`Phase`).
#pragma once

#include <cstdint>

#include "wmsa_stage.cuh"

namespace {

using wcore::bf16;
using wcore::kThreads;

constexpr int kMaxN = wcore::kMaxN;
constexpr int kMaxHd = wcore::kMaxHd;

// Where a window's q, k, v rows of one head lie, and its output's.
//   kFlatQkv:   `a` is the (nW, N, 3C) qkv (moved to the launch's first
//               head), out (nW, N, C);
//   kHeadMajor: `a`, `b`, `c` are q, k, v (H, nW, N, hd), out likewise.
enum class Layout { kFlatQkv, kHeadMajor };

// What the kernel computes of each (window, head): the attention (K1,
// K1-hm, K3, and K8's `full`), or one of K8's phases (csrc/
// window_msa_ablate.cu): the staging alone with out = q, the core's
// products alone, its softmax alone (wcore::attention_fwd's modes).
enum Phase : int { kFull, kEmpty, kGemmOnly, kSoftOnly };

template <int P>
constexpr int kCoreMode = P == kGemmOnly ? wcore::kGemmOnly
                        : P == kSoftOnly ? wcore::kSoftOnly : wcore::kAttend;

// bf16 terms of the core's q, k, v operands (csrc/wmsa_core.cuh, Numerics).
template <typename T>
constexpr int kTerms = sizeof(T) == 2 ? 1 : 2;

// zero row | operands: 3 x kTerms (N, operand_ld) bf16 tiles | staging: 3
// (N, row_words) word tiles | bias (N, N) float32.  The zero row, the
// operands and the staging are whole 16-byte units.
template <typename T>
__host__ __device__ __forceinline__ size_t zeroed_bytes(int N, int hd) {
  return sizeof(bf16) * (wcore::kZeroRow + 3 * kTerms<T> * (size_t)N * wcore::operand_ld(hd));
}

template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(int N, int hd) {
  return sizeof(uint32_t) * 3 * (size_t)N * wstage::row_words<T>(hd);
}

template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int N, int hd) {
  return zeroed_bytes<T>(N, hd) + stage_bytes<T>(N, hd) + sizeof(float) * (size_t)N * N;
}

// Blocks per SM the registers are bounded for: 4 in bf16, whose shared
// memory (~40 KB at hrformer_base b0) allows 5; 3 in float32 (~67 KB).
template <typename T, Layout L, int P = kFull>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 4 : 3)
window_msa_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ c, const float* __restrict__ bias,
                      T* __restrict__ out, int nW, int N, int C, int hd, float scale,
                      int wpb) {
  static_assert(P == kFull || sizeof(T) == 2, "K8's phases take bf16 operands");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NI = kTerms<T>;
  constexpr bool kFlat = L == Layout::kFlatQkv;
  bf16* zrow = reinterpret_cast<bf16*>(smem);
  bf16* opnd = zrow + wcore::kZeroRow;
  const int ld = wcore::operand_ld(hd);
  const int term = N * ld;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + zeroed_bytes<T>(N, hd));
  float* bias_s = reinterpret_cast<float*>(smem + zeroed_bytes<T>(N, hd) + stage_bytes<T>(N, hd));

  // C: the row width of the flat output, and a third of qkv's; h: the
  // head of this block within the launch.
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;

  // Zeros: the zero row and the operands (their padding columns stay zero:
  // windows write the columns < hd), and the bias tile without a bias.
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int units = (int)(zeroed_bytes<T>(N, hd) / 16);
    for (int i = tid; i < units; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (bias)  // softonly: head 0's tile for every head, as the TPU probe
    wstage::issue_words(bias_s, bias + (size_t)(P == kSoftOnly ? 0 : h) * N * N,
                        N * N);  // with window 0's group
  else
    for (int i = tid; i < N * N; i += kThreads) bias_s[i] = 0.f;

  // Window w's q, k and v tiles of head h in device memory, and its output.
  auto tiles = [&](int w, wstage::Tile<T> (&t)[3]) {
    if constexpr (kFlat) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
        t[s] = {a + (size_t)w * N * 3 * C + s * C + h * hd, 3 * (size_t)C};
    } else {
      const size_t at = ((size_t)h * nW + w) * N * hd;
      t[0] = {a + at, (size_t)hd};
      t[1] = {b + at, (size_t)hd};
      t[2] = {c + at, (size_t)hd};
    }
  };
  const int ldo = kFlat ? C : hd;
  wstage::Tile<T> src[3];

  const int w_begin = blockIdx.x * wpb;
  const int w_end = min(nW, w_begin + wpb);
  tiles(w_begin, src);
  wstage::issue(src, stage, N, hd);
  for (int w = w_begin; w < w_end; ++w) {
    wstage::cp_async_wait_all();
    __syncthreads();  // window w staged (the first time: the bias and the zeros too)
    tiles(w, src);
    wstage::convert<T, NI>(src, stage, opnd, N, hd, ld, term);
    __syncthreads();  // the stage is free, the operands written
    if (w + 1 < w_end) {  // in flight while this window computes
      tiles(w + 1, src);
      wstage::issue(src, stage, N, hd);
    }
    if constexpr (P == kEmpty) {  // out = q, from its staged operand
      T* o = kFlat ? out + (size_t)w * N * C + h * hd : out + ((size_t)h * nW + w) * N * hd;
      const int pairs = (hd + 1) / 2;
      for (int i = tid; i < N * pairs; i += kThreads) {
        const int r = i / pairs, d = 2 * (i - r * pairs);
        const bf16* q = opnd + r * ld + d;
        wcore::store_pair(o + (size_t)r * ldo + d, __bfloat162float(q[0]),
                          __bfloat162float(q[1]), d + 1 < hd);
      }
    } else if (warp < (N + 15) / 16) {
      auto operand = [&](int s) { return wcore::Operand{opnd + s * NI * term, ld, term}; };
      T* o = kFlat ? out + (size_t)w * N * C + h * hd : out + ((size_t)h * nW + w) * N * hd;
      float p[8][4];
      wcore::attention_fwd<NI, true, kCoreMode<P>>(
          operand(0), operand(1), operand(2), N, hd, scale,
          [&](int i, int j) { return bias_s[i * N + j]; }, zrow, p,
          [&](int i, int d, float x0, float x1, bool two) {
            wcore::store_pair(o + (size_t)i * ldo + d, x0, x1, two);
          });
    }
    // The next iteration's first barrier keeps its conversion off these
    // operands until every warp has read them.
  }
}

template <typename T, Layout L, int P = kFull>
cudaError_t launch(const T* a, const T* b, const T* c, const float* bias, T* out, int nW,
                   int N, int C, int Hl, int hd, float scale, int wpb, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, hd);
  if (smem > (size_t)ipe::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = ipe::allow_smem(window_msa_fwd_kernel<T, L, P>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (nW + wpb - 1) / wpb;
  window_msa_fwd_kernel<T, L, P><<<dim3(chunks, Hl), kThreads, smem, stream>>>(
      a, b, c, bias, out, nW, N, C, hd, scale, wpb);
  return cudaGetLastError();
}

}  // namespace
