// K9 and K10: the int8 tensor-core products of int8 PTQ serving, for
// Hopper.
//
// Neither replaces a TPU kernel.  The JAX package leaves both to XLA
// (infantposeestimation_gaussianbias_tpu/ops/quant.py: `qconv` /
// `qconv_affine`, an int8 `conv_general_dilated` with int32 accumulation,
// and `qdense`, an int8 `dot_general`), and stock PyTorch has no CUDA
// route for either: `F.conv2d` refuses int8 tensors on the card, and
// `torch._int_mm` needs K and N to be multiples of 8, which HRFormer-Base's
// Dense layers (K = 156, N = 468) are not.
//
// K9, the int8 conv (kernels/quant.py `qconv`): an implicit GEMM over NHWC
// int8 activations x (B, H, W, C) and int8 weights w (Co, kh, kw, C),
//   M = B * Ho * Wo output pixels, N = Co, K = kh * kw * C,
// row k of the product's depth being (tap r, s; channel c) in that order,
// with symmetric padding kh / 2 and stride 1 or 2.  The epilogue is fused,
// in this order, each float step rounded on its own (`__fmul_rn` /
// `__fadd_rn`: nvcc must not contract them into FMAs, or the result would
// leave the plain version's bits):
//   y = acc * (x_scale * eff_scale[o]) + eff_bias[o]
//   y = y + res * res_scale   (an int8 residual)   or   y + res (float32)
//   y = max(y, 0)             (relu)
//   out = clamp(rint(y * (1 / out_scale)), -127, 127) as int8, or y as f32.
// K10, the int8 Dense (kernels/quant.py `qdense`): the same core with
// R = S = 1 over rows x (M, K) of float32 or bf16, quantised while they are
// staged (q = clamp(rint(x * (1 / in_scale)), -127, 127)); its epilogue is
//   y = acc * (in_scale * w_scale[o]) + bias[o]
// written as float32 or bf16.  Rounding is half to even everywhere
// (`__float2int_rn`, `__frcp_rn`, `__float2bfloat16_rn`), as XLA's and
// torch's, so both kernels equal their plain versions bit for bit.
//
// What bounds them: 2 M N K integer operations against one read of x, w
// and the residual and one write of the output.  At HRNet-W32's widths
// (K = 288-2,304, N = 32-256) a 3x3 conv does 0.5-1.9 K ops per byte:
// bytes bound the narrow branches, the int8 tensor cores (1,979 TOPS) the
// wide ones.  This first form is simple: one 4-warp block per 64 x 64 tile
// of (M, N), depth slices of 32 staged into a two-slice ring (16-byte
// `cp.async` with zero-fill where C is a multiple of 16, byte by byte
// otherwise: the stem's C = 3, the Dense rows), products on
// `mma.sync.m16n8k32.s8.s8.s32`.  wgmma, TMA and a persistent grid are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
// Shared-memory row of one depth slice: 32 bytes of data and 16 of pad, so
// a warp's fragment reads (rows g, g + 8; words t) fall in 32 distinct
// banks and the 16-byte staging writes stay aligned.
constexpr int kRow = 48;
constexpr int kThreads = 128;

enum ASource { kConvVec = 0, kConvByte = 1, kDenseF32 = 2, kDenseBf16 = 3 };
enum ResKind { kResNone = 0, kResInt8 = 1, kResF32 = 2 };
enum OutKind { kOutF32 = 0, kOutInt8 = 1, kOutBf16 = 2 };

struct Params {
  const void* a;           // conv: int8 NHWC x; Dense: (M, K) float32 or bf16
  const int8_t* w;         // (N, K) int8, K contiguous
  const float* a_scale;    // x's scale (conv) or in_scale (Dense), 0-d
  const float* col_scale;  // (N,) eff_scale or w_scale
  const float* col_bias;   // (N,) eff_bias or bias
  const void* res;         // (M, N) int8 or float32 residual, or null
  const float* res_scale;  // the int8 residual's scale, 0-d
  const float* out_scale;  // the requantize scale, 0-d (int8 out)
  void* out;               // (M, N)
  int M, N, K;
  int H, W, C, Ho, Wo, kw, stride, pad;
  int res_kind, out_kind, relu;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, or 16 zeros when !ok (source size 0: the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t sat_int8(float v) {
  const int q = __float2int_rn(v);
  return static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q));
}

template <int SRC>
__device__ __forceinline__ float dense_elem(const void* a, size_t i) {
  if constexpr (SRC == kDenseF32) {
    return static_cast<const float*>(a)[i];
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i]);
  }
}

// One 64 x 64 tile of (M, N) per block; 4 warps of 32 x 32 (2 m16 x 4 n8
// fragments).  Thread t stages half-row (t & 1) of row t >> 1 of both the A
// and the B slice.
template <int SRC>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int srow = tid >> 1, shalf = tid & 1;

  // The A row this thread stages: an output pixel (conv) or a row (Dense).
  const int am = m0 + srow;
  const bool a_ok = am < p.M;
  size_t a_img = 0;
  int ih0 = 0, iw0 = 0;
  if constexpr (SRC == kConvVec || SRC == kConvByte) {
    if (a_ok) {
      const int hw = p.Ho * p.Wo;
      const int b = am / hw, r = am - b * hw;
      const int oh = r / p.Wo, ow = r - oh * p.Wo;
      a_img = static_cast<size_t>(b) * p.H;
      ih0 = oh * p.stride - p.pad;
      iw0 = ow * p.stride - p.pad;
    }
  }
  float inv_in = 0.f;
  if constexpr (SRC == kDenseF32 || SRC == kDenseBf16) inv_in = __frcp_rn(*p.a_scale);
  const int bn = n0 + srow;
  const bool b_ok = bn < p.N;
  const int8_t* wrow = p.w + static_cast<size_t>(b_ok ? bn : 0) * p.K;

  auto stage = [&](int buf, int kc) {
    const int k0 = kc * kBK + shalf * 16;
    int8_t* adst = &As[buf][srow * kRow + shalf * 16];
    int8_t* bdst = &Bs[buf][srow * kRow + shalf * 16];
    if constexpr (SRC == kConvVec) {
      // C % 16 == 0: the 16 bytes lie in one tap, and K % 16 == 0.
      const bool bok = b_ok && k0 < p.K;
      cp_async16(bdst, bok ? wrow + k0 : p.w, bok);
      const int tap = k0 / p.C, c0 = k0 - tap * p.C;
      const int r = tap / p.kw, s = tap - r * p.kw;
      const int ih = ih0 + r, iw = iw0 + s;
      const bool aok = a_ok && k0 < p.K && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      const int8_t* src = static_cast<const int8_t*>(p.a);
      if (aok) src += ((a_img + ih) * p.W + iw) * p.C + c0;
      cp_async16(adst, src, aok);
    } else {
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + i;
        bdst[i] = (b_ok && k < p.K) ? wrow[k] : static_cast<int8_t>(0);
      }
      if constexpr (SRC == kConvByte) {
        for (int i = 0; i < 16; ++i) {
          const int k = k0 + i;
          int8_t v = 0;
          if (a_ok && k < p.K) {
            const int tap = k / p.C, c = k - tap * p.C;
            const int r = tap / p.kw, s = tap - r * p.kw;
            const int ih = ih0 + r, iw = iw0 + s;
            if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
              v = static_cast<const int8_t*>(p.a)[((a_img + ih) * p.W + iw) * p.C + c];
          }
          adst[i] = v;
        }
      } else {
        const size_t row = static_cast<size_t>(am) * p.K;
        for (int i = 0; i < 16; ++i) {
          const int k = k0 + i;
          adst[i] = (a_ok && k < p.K) ? sat_int8(__fmul_rn(dense_elem<SRC>(p.a, row + k), inv_in))
                                      : static_cast<int8_t>(0);
        }
      }
    }
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tq = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  const int nk = (p.K + kBK - 1) / kBK;
  stage(0, 0);
  cp_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) stage(buf ^ 1, kc + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int8_t* a = As[buf];
    const int8_t* b = Bs[buf];
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm + mi * 16 + g;
      af[mi][0] = ld32(a + row * kRow + tq * 4);
      af[mi][1] = ld32(a + (row + 8) * kRow + tq * 4);
      af[mi][2] = ld32(a + row * kRow + 16 + tq * 4);
      af[mi][3] = ld32(a + (row + 8) * kRow + 16 + tq * 4);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn + ni * 8 + g;
      bf[ni][0] = ld32(b + col * kRow + tq * 4);
      bf[ni][1] = ld32(b + col * kRow + 16 + tq * 4);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  // Epilogue: accumulator i of fragment (mi, ni) is row g (+ 8 for i >= 2),
  // column 2 tq + (i & 1).
  const float as = *p.a_scale;
  const float rs = p.res_kind == kResInt8 ? *p.res_scale : 0.f;
  const float inv_out = p.out_kind == kOutInt8 ? __frcp_rn(*p.out_scale) : 0.f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn + ni * 8 + tq * 2 + j;
      if (col >= p.N) continue;
      const float cs = __fmul_rn(as, p.col_scale[col]);
      const float cb = p.col_bias[col];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mi * 16 + g + 8 * h;
          if (row >= p.M) continue;
          const size_t o = static_cast<size_t>(row) * p.N + col;
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]), cs), cb);
          if (p.res_kind == kResInt8) {
            const int r = static_cast<const int8_t*>(p.res)[o];
            v = __fadd_rn(v, __fmul_rn(__int2float_rn(r), rs));
          } else if (p.res_kind == kResF32) {
            v = __fadd_rn(v, static_cast<const float*>(p.res)[o]);
          }
          if (p.relu) v = fmaxf(v, 0.f);
          if (p.out_kind == kOutInt8) {
            static_cast<int8_t*>(p.out)[o] = sat_int8(__fmul_rn(v, inv_out));
          } else if (p.out_kind == kOutBf16) {
            static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
          } else {
            static_cast<float*>(p.out)[o] = v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// src: 0 conv, C % 16 == 0 and x, w 16-byte aligned; 1 conv, any C; 2
// Dense rows of float32; 3 Dense rows of bf16 (kernels/quant.py picks it).
// Conv geometry: x (B, H, W, C), output (B, Ho, Wo, N), kernel kh x kw
// (K = kh kw C), stride, pad; a Dense passes M rows, K = C, 1 x 1, stride 1,
// pad 0.  res_kind: 0 none, 1 int8 (res_scale), 2 float32; out_kind: 0
// float32, 1 int8 (out_scale), 2 bf16.  Returns the launch's error.
int ipe_qgemm(int src, const void* a, const void* w, const void* a_scale, const void* col_scale,
              const void* col_bias, const void* res, const void* res_scale,
              const void* out_scale, void* out, int M, int N, int K, int H, int W, int C,
              int Ho, int Wo, int kw, int stride, int pad, int res_kind, int out_kind, int relu,
              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || C <= 0 || kw <= 0 || stride <= 0 || K % C ||
      (src == kConvVec && C % 16) || res_kind < 0 || res_kind > 2 || out_kind < 0 ||
      out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const Params p{a, static_cast<const int8_t*>(w), static_cast<const float*>(a_scale),
                 static_cast<const float*>(col_scale), static_cast<const float*>(col_bias), res,
                 static_cast<const float*>(res_scale), static_cast<const float*>(out_scale), out,
                 M, N, K, H, W, C, Ho, Wo, kw, stride, pad, res_kind, out_kind, relu};
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src) {
    case kConvVec: qgemm_kernel<kConvVec><<<grid, kThreads, 0, s>>>(p); break;
    case kConvByte: qgemm_kernel<kConvByte><<<grid, kThreads, 0, s>>>(p); break;
    case kDenseF32: qgemm_kernel<kDenseF32><<<grid, kThreads, 0, s>>>(p); break;
    case kDenseBf16: qgemm_kernel<kDenseBf16><<<grid, kThreads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
