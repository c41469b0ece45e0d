// K8: in-kernel phase ablation of a W-MSA forward body for Hopper.
//
// Replaces the TPU probe's kernels in
// infantposeestimation_gaussianbias_tpu/tools/probe_wmsa_ablate.py
// (`run_variant`'s pallas_call; bodies `_kernel_empty`, `_kernel_gemmonly`,
// `_kernel_softonly`, `_kernel_packslim`, and K1's `_attn_qkv_kernel` as
// `full`).  Each variant streams the same bf16 (nW, N, 3C) qkv through the
// same grid and differs only in the body, so that time differences name
// the phase that sets the body's time.  The body is K1's first, CUDA-core
// design (csrc/window_msa_body.cuh), kept here after K1 moved to the
// tensor cores:
//   0 empty     staging only: q, k, v into shared memory, out = q;
//   1 gemmonly  the two products, no bias, no softmax (p = 0.01 * s);
//   2 softonly  the softmax on a broadcast score tile, no products;
//   3 full      the whole body (K1's maths; no longer K1's code);
//   4 packslim  G windows stacked into G*N rows: all (G*N)^2 scores, the
//               masked packed bias (-1e30 off the diagonal blocks), softmax,
//               (G*N, G*N) x (G*N, hd) PV.
// Variants 0-3 are window_msa_body.cuh's `attend` with phases compiled
// out, at WPB in {1, 2, 4, 8} windows per block (the card's counterpart of
// the TPU probe's GB sweep), one head per block.  What bounds each: the
// same ~137 MB of qkv read and out written at hrformer_base b0 (b = 64),
// 0.041 ms at 3.35 TB/s; the products and softmax are float32 FMAs and
// expf on the CUDA cores (67 TFLOP/s).
//
// packslim keeps q, k, v of its windows in shared memory and computes the
// scores one band of kBand query rows at a time: at hd 32, N 49, G 4 the
// whole 196 x 196 float32 tile (154 KB) with q/k/v (78 KB) would not fit a
// block's 227 KB.  Windows past nW are staged as zeros and their outputs
// dropped, as the TPU pads nW to its block.

#include "window_msa_body.cuh"

namespace {

using ipe::odd_stride;
using ipe::to_f32;
using ipe::wmsa::kMaxHd;
using ipe::wmsa::kMaxN;
using ipe::wmsa::kThreads;
using ipe::wmsa::Phase;
using bf16 = __nv_bfloat16;

constexpr int kBand = 32;     // packslim's query rows per score band
constexpr int kMaxPack = 8;   // packslim's most windows per group

template <Phase P, int WPB>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
              bf16* __restrict__ out, int nW, int N, int H, int hd, float scale,
              float* sink) {
  ipe::wmsa::attend<bf16, P, WPB>(qkv, bias, out, nW, N, H, hd, scale, sink);
}

size_t packslim_smem_bytes(int N, int hd, int wpb, int G) {
  const int GN = G * N;
  return sizeof(float) * (3 * (size_t)wpb * N * odd_stride(hd) +
                          (size_t)kBand * odd_stride(GN) + kBand);
}

// One block: windows blockIdx.x * wpb .. + wpb - 1 (wpb a multiple of G) of
// head blockIdx.y, as wpb / G groups of G stacked windows.
__global__ void __launch_bounds__(kThreads)
packslim_kernel(const bf16* __restrict__ qkv, const float* __restrict__ pbias,
                bf16* __restrict__ out, int nW, int N, int H, int hd,
                float scale, int G, int wpb) {
  extern __shared__ float smem[];
  const int ldq = odd_stride(hd);
  const int GN = G * N;
  const int lds = odd_stride(GN);
  float* q = smem;                 // (wpb * N, ldq), pre-scaled
  float* k = q + wpb * N * ldq;    // (wpb * N, ldq)
  float* v = k + wpb * N * ldq;    // (wpb * N, ldq)
  float* s = v + wpb * N * ldq;    // (kBand, lds)
  float* inv_sum = s + kBand * lds;  // (kBand)

  const int w0 = blockIdx.x * wpb;
  const int h = blockIdx.y;
  const int C = H * hd;
  const int tid = threadIdx.x;
  // Window-stacked rows: row r is token r % N of window w0 + r / N, that is
  // row w0 * N + r of the (nW * N, 3C) qkv.
  const bf16* base = qkv + (size_t)w0 * N * 3 * C + h * hd;
  bf16* obase = out + (size_t)w0 * N * C + h * hd;
  for (int idx = tid; idx < wpb * N * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    float qf = 0.f, kf = 0.f, vf = 0.f;
    if (w0 + r / N < nW) {
      const bf16* row = base + (size_t)r * 3 * C + d;
      qf = to_f32(row[0]);
      kf = to_f32(row[C]);
      vf = to_f32(row[2 * C]);
    }
    q[r * ldq + d] = qf * scale;
    k[r * ldq + d] = kf;
    v[r * ldq + d] = vf;
  }
  __syncthreads();

  const float* pb = pbias + (size_t)h * GN * GN;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int g = 0; g < wpb / G; ++g) {
    const float* qg = q + g * GN * ldq;
    const float* kg = k + g * GN * ldq;
    const float* vg = v + g * GN * ldq;
    for (int r0 = 0; r0 < GN; r0 += kBand) {
      const int rows = min(kBand, GN - r0);
      // Scores of this band against all G*N keys of the group, the
      // cross-window ones included, plus the packed masked bias.
      for (int idx = tid; idx < rows * GN; idx += kThreads) {
        const int i = idx / GN;
        const int j = idx - i * GN;
        const float* qi = qg + (r0 + i) * ldq;
        const float* kj = kg + j * ldq;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], kj[d], acc);
        s[i * lds + j] = acc + pb[(size_t)(r0 + i) * GN + j];
      }
      __syncthreads();
      for (int i = warp; i < rows; i += kThreads / 32) {
        float* si = s + i * lds;
        float m = -CUDART_INF_F;
        for (int j = lane; j < GN; j += 32) m = fmaxf(m, si[j]);
        m = ipe::warp_max(m);
        float sum = 0.f;
        for (int j = lane; j < GN; j += 32) {
          const float e = expf(si[j] - m);
          si[j] = e;
          sum += e;
        }
        sum = ipe::warp_sum(sum);
        if (lane == 0) inv_sum[i] = 1.f / sum;
      }
      __syncthreads();
      for (int idx = tid; idx < rows * hd; idx += kThreads) {
        const int i = idx / hd;
        const int d = idx - i * hd;
        const int r = g * GN + r0 + i;  // row within the block
        if (w0 + r / N >= nW) continue;
        const float* pi = s + i * lds;
        float acc = 0.f;
        for (int j = 0; j < GN; ++j) acc = fmaf(pi[j], vg[j * ldq + d], acc);
        obase[(size_t)r * C + d] = ipe::from_f32<bf16>(acc * inv_sum[i]);
      }
      __syncthreads();
    }
  }
}

// The most shared memory a block may opt in to on the current device
// (232,448 bytes on the H100).
int max_smem() {
  int dev = 0, most = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return most;
}

template <Phase P, int WPB>
cudaError_t launch(const bf16* qkv, const float* bias, bf16* out, int nW,
                   int N, int H, int hd, float scale, float* sink,
                   cudaStream_t stream) {
  const size_t smem = ipe::wmsa::smem_bytes(N, hd, WPB);
  if (smem > (size_t)max_smem()) return cudaErrorInvalidValue;
  cudaError_t err = ipe::allow_smem(ablate_kernel<P, WPB>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nW + WPB - 1) / WPB, H);
  ablate_kernel<P, WPB><<<grid, kThreads, smem, stream>>>(qkv, bias, out, nW, N,
                                                          H, hd, scale, sink);
  return cudaGetLastError();
}

template <Phase P>
cudaError_t launch_wpb(int wpb, const bf16* qkv, const float* bias, bf16* out,
                       int nW, int N, int H, int hd, float scale, float* sink,
                       cudaStream_t st) {
  switch (wpb) {
    case 1: return launch<P, 1>(qkv, bias, out, nW, N, H, hd, scale, sink, st);
    case 2: return launch<P, 2>(qkv, bias, out, nW, N, H, hd, scale, sink, st);
    case 4: return launch<P, 4>(qkv, bias, out, nW, N, H, hd, scale, sink, st);
    case 8: return launch<P, 8>(qkv, bias, out, nW, N, H, hd, scale, sink, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_packslim(const bf16* qkv, const float* pbias, bf16* out,
                            int nW, int N, int H, int hd, float scale, int G,
                            int wpb, cudaStream_t stream) {
  if (G < 1 || G > kMaxPack || wpb < G || wpb % G) return cudaErrorInvalidValue;
  const size_t smem = packslim_smem_bytes(N, hd, wpb, G);
  if (smem > (size_t)max_smem()) return cudaErrorInvalidValue;
  cudaError_t err = ipe::allow_smem(packslim_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nW + wpb - 1) / wpb, H);
  packslim_kernel<<<grid, kThreads, smem, stream>>>(qkv, pbias, out, nW, N, H,
                                                    hd, scale, G, wpb);
  return cudaGetLastError();
}

// Shared memory one block of the variant asks for.
size_t variant_smem_bytes(int variant, int N, int hd, int wpb, int pack) {
  return variant == 4 ? packslim_smem_bytes(N, hd, wpb, pack)
                      : ipe::wmsa::smem_bytes(N, hd, wpb);
}

}  // namespace

extern "C" {

// 1 if one block of the variant at wpb windows per block (packslim: pack
// windows per group) fits the current device's shared memory, else 0.
int ipe_window_msa_ablate_fits(int variant, int N, int hd, int wpb,
                               int pack) {
  return variant_smem_bytes(variant, N, hd, wpb, pack) <= (size_t)max_smem();
}

// variant: 0 empty, 1 gemmonly, 2 softonly, 3 full, 4 packslim.  qkv
// (nW, N, 3C) and out (nW, N, C) bf16, contiguous; bias (H, N, N) float32,
// packslim's (H, G*N, G*N) masked.  wpb: windows per block (1, 2, 4 or 8;
// packslim a multiple of pack).  sink: null, or a float32 that the
// keep-alive checksum of empty and softonly is added to.  Returns the
// launch's cudaError_t.
int ipe_window_msa_ablate(int variant, const void* qkv, const void* bias,
                          void* out, int nW, int N, int H, int hd, float scale,
                          int wpb, int pack, void* sink, void* stream) {
  if (nW <= 0 || N <= 0 || N > kMaxN || hd <= 0 || hd > kMaxHd || H <= 0 ||
      H > 65535 || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  float* sk = static_cast<float*>(sink);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch_wpb<Phase::kEmpty>(wpb, x, b, o, nW, N, H, hd, scale, sk, st);
    case 1: return (int)launch_wpb<Phase::kGemmOnly>(wpb, x, b, o, nW, N, H, hd, scale, sk, st);
    case 2: return (int)launch_wpb<Phase::kSoftOnly>(wpb, x, b, o, nW, N, H, hd, scale, sk, st);
    case 3: return (int)launch_wpb<Phase::kFull>(wpb, x, b, o, nW, N, H, hd, scale, sk, st);
    case 4: return (int)launch_packslim(x, b, o, nW, N, H, hd, scale, pack, wpb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
