// Helpers shared by the package's CUDA sources.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ipe {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt in to (H100)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Odd row strides keep a warp's column reads across 32 rows bank-conflict free.
__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Opt a kernel in to `bytes` of dynamic shared memory (needed above 48 KB)
// on the current device: before every launch, since the setting belongs to
// the device's context (a per-process flag would leave a second card's
// context without it).
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace ipe
