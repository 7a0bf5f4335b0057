// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel reads its operands in their storage type (fp32 or bf16),
// computes in fp32 and writes in the storage type. The launchers have a
// plain C interface (nvcc -> shared library -> ctypes) and return
// the cudaError_t of the launch as an int, so the Python wrapper can raise
// on a launch the GPU refused (too many threads or too much shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ditto {

// dtype codes shared with the Python wrappers (kernels.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// value rounded through the storage type and back (the "cast to the
// compute dtype" of a value that then feeds an fp32 accumulation)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// set the dynamic shared-memory cap of a kernel before a launch that needs
// more than the default 48 KB
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ditto
