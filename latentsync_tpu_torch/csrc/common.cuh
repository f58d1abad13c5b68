// Shared helpers for the hand-written Hopper kernels of latentsync_tpu_torch.
//
// Every kernel library entry point is a plain C function that takes raw
// device pointers and the caller's CUDA stream, launches on that stream,
// never synchronises and never allocates, and returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define LS_FULL_MASK 0xffffffffu

static __device__ __forceinline__ float ls_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(LS_FULL_MASK, v, o);
  return v;
}

// Raise the dynamic shared memory cap of `kernel` when a launch needs more
// than the default 48 KB (Hopper allows up to 227 KB per block).
template <typename K>
static inline cudaError_t ls_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
