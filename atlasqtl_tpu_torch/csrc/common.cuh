// Device code shared by the sweep kernels (sweep_fused.cu,
// sweep_missing_fused.cu).  Both sources are linked into one shared library;
// everything here has internal linkage, so each carries its own copy.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr float K_BASE = 10.19f;  // analytic sqrt base of the tail tiles

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// z_row[j] = sum over column slices of part[slice, j], in slice order: the
// per-slice partial row sums of Z reduced without float atomics, so a run
// repeats bit for bit.
__global__ void zrow_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ z_row, int n_slices,
                                   int p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  float s = 0.f;
  for (int sl = 0; sl < n_slices; ++sl) s += part[(size_t)sl * p + j];
  z_row[j] = s;
}

}  // namespace
