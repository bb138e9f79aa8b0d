// The Gauss-Seidel update of one predictor block's B coordinates, for every
// response column, as one CUDA kernel for Hopper (sm_90a), in float32 and
// float64.
//
// Replaces the TPU kernel atlasqtl_tpu/ops/sweep_pallas.py:_inner_gs_kernel
// (wrapper inner_gs_pallas).  Same function: given r0 = X_b^T F and the exact
// log Phi / log(1 - Phi) tiles computed outside, for i = 0..B-1 in order
//     r_i   = r[i] - beta_old_i * G[i, i]
//     mu_i  = c s2 tau (cp[i] - r_i)
//     logit = c (log_1p[i] - log_p[i] - mu_i^2 / (2 s2) + cst)
//     gam_i = sigmoid(-logit),  delta_i = gam_i mu_i - beta_old_i
//     r    += G[:, i] delta_i
// with cst = -(log tau + log sig2_inv + log s2) / 2; outputs gam, mu, delta.
// The plain version is atlasqtl_tpu_torch/ops/sweep.py:_inner_gs.
//
// What bounds it on an H100: the pushes need only the triangle below the
// diagonal, B^2 q / 2 FMAs (B^2 q FP32 operations, plus ~15 elementwise ones
// per element), against 6 B x q tiles read (r0, cp, gam, mu, log_p, log_1p),
// 3 written (gam, mu, delta) and the Gram: ~B/36 operations per byte in
// float32, under the card's ~20 at 67 TFLOP/s and 3.35 TB/s,
// so moving the bytes bounds it.  The chain itself is strictly sequential
// in i, so the latency of one row's update bounds what one CTA can do.
//
// Design (simple on purpose):
//  - one CTA of 256 threads owns 32 response columns (one lane per column);
//    the columns are independent, so CTAs never communicate;
//  - the block Gram's lower triangle (all the update reads) sits packed in
//    shared memory: 33 KB at B = 128 in float32, 66 KB in float64;
//  - the pushes are left-looking over windows of W = 8 rows: before a
//    window, each of the 8 warps takes one of its rows and adds the
//    corrections of every earlier row of the block (sum_m G[i, m] delta_m),
//    so the push work spreads across the CTA; then warp 0 runs the window's
//    chain with the window's residuals in registers, pushing each delta to
//    the window's later rows.  The TPU kernel's 32-row sub-blocks with a
//    deferred matrix-unit update are a VMEM/MXU device and are not copied.
#include "common.cuh"

namespace {

constexpr int QS = 32;     // response columns per CTA
constexpr int NT = 256;    // threads per CTA
constexpr int W = 8;       // chain window (rows); one warp per row
constexpr int BMAX = 128;  // largest predictor block

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log_t(float v) { return logf(v); }
__device__ __forceinline__ double log_t(double v) { return log(v); }

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

template <typename T>
size_t smem_bytes(int B) {
  return sizeof(T) * ((size_t)tri(B) + (size_t)B * QS + (size_t)W * QS);
}

template <typename T>
__global__ void __launch_bounds__(NT) inner_gs_kernel(
    const T* __restrict__ r0,       // (B, q)
    const T* __restrict__ g,        // (B, B)
    const T* __restrict__ cp,       // (B, q)
    const T* __restrict__ gam_in,   // (B, q)
    const T* __restrict__ mu_in,    // (B, q)
    const T* __restrict__ log_p,    // (B, q)
    const T* __restrict__ log_1p,   // (B, q)
    const T* __restrict__ s2v,      // (q,)
    const T* __restrict__ tauv,     // (q,)
    const T* __restrict__ logtauv,  // (q,)
    const T* __restrict__ scal,     // (2,) c, log sig2_inv
    T* __restrict__ gam_out,        // (B, q)
    T* __restrict__ mu_out,         // (B, q)
    T* __restrict__ delta_out,      // (B, q)
    int q, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* G_s = reinterpret_cast<T*>(smem_raw);  // lower triangle, row i at tri(i)
  T* D_s = G_s + tri(B);                    // B x QS deltas
  T* R_s = D_s + B * QS;                    // W x QS window residuals

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x * QS + lane;
  const bool valid = k < q;
  const T c = scal[0], lsi = scal[1];

  for (int e = tid; e < B * B; e += NT) {
    const int i = e / B, m = e % B;
    if (m <= i) G_s[tri(i) + m] = g[e];
  }
  // chain constants (used by warp 0); a padded lane gets s2 = 1, ct = 0
  T s2 = T(1), ct = T(0), cst = T(0);
  if (valid) {
    s2 = s2v[k];
    ct = c * s2 * tauv[k];
    cst = -(logtauv[k] + lsi + log_t(s2)) / T(2);
  }
  __syncthreads();

  for (int lo = 0; lo < B; lo += W) {
    {  // this window's residuals: r0 plus every earlier row's push
      const int i = lo + warp;
      const T* gi = G_s + tri(i);
      T corr = T(0);
      for (int m = 0; m < lo; ++m) corr += gi[m] * D_s[m * QS + lane];
      R_s[warp * QS + lane] = (valid ? r0[(size_t)i * q + k] : T(0)) + corr;
    }
    __syncthreads();
    if (warp == 0) {
      T rr[W], cpv[W], bo[W], lp[W], l1p[W];
#pragma unroll
      for (int m = 0; m < W; ++m) {
        const size_t off = (size_t)(lo + m) * q + k;
        rr[m] = R_s[m * QS + lane];
        cpv[m] = valid ? cp[off] : T(0);
        bo[m] = valid ? gam_in[off] * mu_in[off] : T(0);
        lp[m] = valid ? log_p[off] : T(0);
        l1p[m] = valid ? log_1p[off] : T(0);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int row = lo + i;
        const T ri = rr[i] - bo[i] * G_s[tri(row) + row];
        const T mu = ct * (cpv[i] - ri);
        const T logit = c * (l1p[i] - lp[i] - mu * mu / (T(2) * s2) + cst);
        const T gam = T(1) / (T(1) + exp_t(logit));
        const T delta = gam * mu - bo[i];
        D_s[row * QS + lane] = delta;
#pragma unroll
        for (int m = i + 1; m < W; ++m) rr[m] += G_s[tri(lo + m) + row] * delta;
        if (valid) {
          const size_t off = (size_t)row * q + k;
          gam_out[off] = gam;
          mu_out[off] = mu;
          delta_out[off] = delta;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* r0, const void* g, const void* cp, const void* gam,
           const void* mu, const void* log_p, const void* log_1p,
           const void* s2, const void* tau, const void* log_tau,
           const void* scal, void* gam_out, void* mu_out, void* delta_out,
           int q, int B, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(B);
  cudaError_t err = cudaFuncSetAttribute(
      inner_gs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  inner_gs_kernel<T><<<(q + QS - 1) / QS, NT, smem, st>>>(
      static_cast<const T*>(r0), static_cast<const T*>(g),
      static_cast<const T*>(cp), static_cast<const T*>(gam),
      static_cast<const T*>(mu), static_cast<const T*>(log_p),
      static_cast<const T*>(log_1p), static_cast<const T*>(s2),
      static_cast<const T*>(tau), static_cast<const T*>(log_tau),
      static_cast<const T*>(scal), static_cast<T*>(gam_out),
      static_cast<T*>(mu_out), static_cast<T*>(delta_out), q, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the inner Gauss-Seidel update of one predictor block on
// `stream`, in float64 when is_f64 is set, else float32.  Returns the CUDA
// error code of the launch (0 on success).
int atlasqtl_inner_gs(int is_f64, const void* r0, const void* g,
                      const void* cp, const void* gam, const void* mu,
                      const void* log_p, const void* log_1p, const void* s2,
                      const void* tau, const void* log_tau, const void* scal,
                      void* gam_out, void* mu_out, void* delta_out, int q,
                      int B, void* stream) {
  if (B <= 0 || B % W != 0 || B > BMAX || q <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(r0, g, cp, gam, mu, log_p, log_1p, s2, tau,
                                 log_tau, scal, gam_out, mu_out, delta_out, q,
                                 B, st)
                : launch<float>(r0, g, cp, gam, mu, log_p, log_1p, s2, tau,
                                log_tau, scal, gam_out, mu_out, delta_out, q,
                                B, st);
}

// CTAs of the inner-update kernel (float64 when is_f64) resident on one SM
// at block B (the occupancy calculator), -1 on error.
int atlasqtl_inner_gs_occupancy(int is_f64, int B) {
  int nb = -1;
  cudaError_t err;
  if (is_f64) {
    const int smem = (int)smem_bytes<double>(B);
    err = cudaFuncSetAttribute(inner_gs_kernel<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, inner_gs_kernel<double>, NT, smem);
  } else {
    const int smem = (int)smem_bytes<float>(B);
    err = cudaFuncSetAttribute(inner_gs_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, inner_gs_kernel<float>, NT, smem);
  }
  return err == cudaSuccess ? nb : -1;
}

}  // extern "C"
