// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function (no PyTorch headers),
// compiled by nvcc into one shared library and bound with ctypes from
// video_prediction_torch/kernels/_lib.py. Each exported function launches on
// the stream it is given and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define VP_EXPORT extern "C" __attribute__((visibility("default")))

namespace vp {

// dtype codes shared with _lib.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace vp
