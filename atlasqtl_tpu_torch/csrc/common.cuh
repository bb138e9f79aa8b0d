// Device code shared by the sweep kernels (sweep_fused.cu,
// sweep_missing_fused.cu, sweep_inner_gs.cu, sweep_staggered.cu).  All four
// sources are linked into one shared library; everything here has internal
// linkage, so each carries its own copy.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr float K_BASE = 10.19f;  // analytic sqrt base of the tail tiles

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Asynchronous 16-byte copy from device to shared memory (cp.async, L2
// only); the copies of one thread complete in commit-group order.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
// the same copy of 16 bytes if `full`, else 16 zero bytes (src not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst,
                                                 const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
// an asynchronous 4-byte copy (through L1)
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The per-element formulas of the complete-data sweep, shared by B1
// (sweep_fused.cu) and B4 (sweep_staggered.cu) with every rounding written
// out: fmaf, __fmul_rn, __fadd_rn, __fsub_rn and __fdiv_rn are never fused
// or split by the compiler, so the two kernels compute them bit for bit
// alike whatever each one's surrounding code lets the compiler contract.

// the logit tile's analytic base: c_one ? h s_d : c (h s_d), h = u/2,
// s_d = sqrt(u^2 + K_BASE) (ops/interp.py)
__device__ __forceinline__ float logit_base(float u, float c, int c_one) {
  const float hs = __fmul_rn(__fmul_rn(0.5f, u), sqrtf(fmaf(u, u, K_BASE)));
  return c_one ? hs : __fmul_rn(c, hs);
}

// one coordinate's update given its residual r: mu, gam, beta and delta
struct ChainStep {
  float mu, gam, bnew, delta;
};

__device__ __forceinline__ ChainStep chain_step(float ct, float cp, float r,
                                                float ad, float cinv,
                                                float bo) {
  ChainStep s;
  s.mu = __fmul_rn(ct, __fsub_rn(cp, r));
  const float logit = fmaf(__fmul_rn(s.mu, s.mu), cinv, ad);
  s.gam = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-logit)));
  s.bnew = __fmul_rn(s.gam, s.mu);
  s.delta = __fsub_rn(s.bnew, bo);
  return s;
}

// one cell of Z = gam * imrd + imr0u, masked by the response mask qm
__device__ __forceinline__ float z_cell(float u, float gam, float d1,
                                        float d2, float qm, float kz,
                                        int c_one) {
  const float sd = sqrtf(fmaf(u, u, K_BASE));
  const float sz = c_one ? sd : sqrtf(fmaf(u, u, kz));
  const float imrd = __fadd_rn(sz, d1);
  const float imr0u =
      __fsub_rn(__fsub_rn(d2, __fmul_rn(0.5f, sz)), __fmul_rn(0.5f, u));
  return __fmul_rn(fmaf(gam, imrd, imr0u), qm);
}

// z_row[j] = sum over column slices of part[slice, j], in slice order: the
// per-slice partial row sums of Z reduced without float atomics, so a run
// repeats bit for bit.  blockIdx.y is the replica of a batched sweep
// (B1, B2): its partials and its z_row follow the previous replicas'.  B1,
// B2 and B4 launch the float instance, the B3 route float and double.
template <typename T>
__global__ void zrow_reduce_kernel(const T* __restrict__ part,
                                   T* __restrict__ z_row, int n_slices,
                                   int p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  part += (size_t)blockIdx.y * n_slices * p;
  z_row += (size_t)blockIdx.y * p;
  T s = T(0);
  for (int sl = 0; sl < n_slices; ++sl) s += part[(size_t)sl * p + j];
  z_row[j] = s;
}

}  // namespace
