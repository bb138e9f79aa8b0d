// One whole exact-missing Gauss-Seidel sweep of the global-local CAVI
// iteration, as one CUDA kernel for Hopper (sm_90a), plus the fixed-order
// z_row reduction of common.cuh.
//
// Replaces the TPU kernel atlasqtl_tpu/ops/sweep_missing_fused.py:_mis_kernel
// (probe="none", pair products in f32).  Same function, same flat update
// order (k-major, j ascending), so the result depends on the window W only
// through rounding:
//  - the carried statistic is the masked fitted matrix Fm = M * (X beta);
//  - coordinate (j, k) sees r = x_j^T Fm_k - beta_old * x_norm_sq[j, k]
//    (its own contribution taken out with the per-(j, k) Gram diagonal);
//  - den = x_norm_sq + sig2_inv, mu = (cp - r) / den, and
//    logit = ad + (c^2 / 2) tau mu (cp - r), where ad holds c d(u) from the
//    interpolation operands (ops/interp.py; its cst row carries the rank-1
//    part of the logit constant) minus (c / 2) log(den);
//  - inside a window of W predictors the corrections of earlier rows go
//    through the masked pair Grams h[(a, b), k] = sum_n m_nk x_na x_nb,
//    computed on the fly; after the window Fm += M * (x_w delta_w).
//
// What bounds it on an H100: the function needs, per (j, k), the projection
// x_j^T Fm_k (2 n operations) and the masked advance (3 n): about
// p q (5 n) FP32 operations per sweep, 2.6e12 at n=1000, p=50000, q=10000,
// 39 ms at the 67 TFLOP/s non-tensor FP32 peak.  The bytes it must move (x,
// cp, gam, mu, x_norm_sq in; gam, mu out; Fm in and out; the mask) take
// about 4.3 ms at 3.35 TB/s: arithmetic sets the bound.  This kernel's
// windows add the pair Grams, W (W - 1) / 2 products per (n, k) and
// window: about p q (4 n + (W - 1) n + 2 n / W) operations in all, 5.7e12
// (86 ms) with W = 8.  No TF32 (the reference's products are full f32).
//
// Design (simple on purpose; speed is later work):
//  - one CTA of 512 threads (16 warps) owns QS = 32 response columns and
//    walks every predictor block in order; columns are independent given
//    theta/zeta, so CTAs never communicate during the walk.  16 warps
//    rather than 8 took a sweep at (1000, 2048, 10000) from 35.8 to 20.4 ms
//    on an H100 (PERF.md): the pass waits on the L2, and more
//    warps hide more of it;
//  - Fm stays in device memory and is updated in place; the mask is read
//    from device memory on every pass.  A 32-column slice of Fm and of the
//    mask is 2 x 128 KB at n = 1000, more than a CTA's shared memory beside
//    the block tiles, so neither is kept on chip; the 132 resident slices
//    (34 MB) stay in the 50 MB L2.  Thread (warp g, lane l) owns the cells
//    (n = g mod 16, column l) on every pass, so it only ever rereads its own
//    writes and no fence is needed;
//  - one pass over the n samples per window does both the advance of the
//    previous window (Fm += m * (x_prev . delta_prev)) and, on the advanced
//    Fm, this window's projections x_w^T Fm and pair Grams; each warp sums
//    its own samples and the 16 warp partials are added in a fixed order;
//  - the window's chain runs on warp 0, one lane per column, the W
//    projections in registers;
//  - per block, all threads build the logit tile (interpolation product,
//    sqrt base, -(c/2) log(den)) before the chain and the Z tile after it;
//    z_row goes to a (n_slices, p) partial buffer reduced by
//    zrow_reduce_kernel.  No atomics: results repeat from run to run.
#include "common.cuh"

namespace {

constexpr int QS = 32;             // response columns per CTA
constexpr int NT = 512;            // threads per CTA
constexpr int NW = NT / 32;        // warps per CTA
constexpr int W = 8;               // chain window (predictors)
constexpr int NP = W * (W - 1) / 2;  // masked pair Grams per window
constexpr int NRH = W + NP;        // per-column sums of one window pass
constexpr int BMAX = 128;          // largest predictor block
constexpr int RMAX = 48;           // largest interpolation width (r + 2)

size_t smem_bytes(int B, int R) {
  return sizeof(float) * (size_t)(5 * B * QS + B * R + 3 * R * QS + W * QS +
                                  NRH * QS + NW * NRH * QS);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = ld4(p), b = ld4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One pass over the samples: ADV advances Fm by the previous window
// (predictors jadv.., deltas in D_s); PROJ then accumulates this window's
// projections and masked pair Grams (predictors jproj..) on the advanced Fm
// into this warp's slot of PART_s.
template <bool ADV, bool PROJ>
__device__ __forceinline__ void window_pass(
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ x, const float* __restrict__ D_s,
    float* __restrict__ PART_s, int n, int p, int q, int k, bool cvalid,
    int jadv, int jproj, int warp, int lane) {
  float dl[W], ar[W], ah[NP];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    dl[i] = ADV ? D_s[i * QS + lane] : 0.f;
    ar[i] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < NP; ++e) ah[e] = 0.f;
  if (cvalid) {
#pragma unroll 2
    for (int nn = warp; nn < n; nn += NW) {
      const size_t off = (size_t)nn * q + k;
      float f = fm[off];
      const float m = mask[off];
      if (ADV) {
        float xa[W];
        load8(x + (size_t)nn * p + jadv, xa);
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < W; ++i) t += xa[i] * dl[i];
        f += m * t;
        fm[off] = f;
      }
      if (PROJ) {
        float xp[W], mx[W - 1];
        load8(x + (size_t)nn * p + jproj, xp);
#pragma unroll
        for (int i = 0; i < W; ++i) ar[i] += xp[i] * f;
#pragma unroll
        for (int b = 0; b < W - 1; ++b) mx[b] = m * xp[b];
        int e = 0;
#pragma unroll
        for (int a = 1; a < W; ++a)
#pragma unroll
          for (int b = 0; b < a; ++b) ah[e++] += xp[a] * mx[b];
      }
    }
  }
  if (PROJ) {
    float* dst = PART_s + (size_t)warp * NRH * QS + lane;
#pragma unroll
    for (int i = 0; i < W; ++i) dst[i * QS] = ar[i];
#pragma unroll
    for (int e = 0; e < NP; ++e) dst[(W + e) * QS] = ah[e];
  }
}

__global__ void __launch_bounds__(NT, 1) sweep_missing_kernel(
    const float* __restrict__ x,        // (n, p)
    const float* __restrict__ cp,       // (p, q)
    const float* __restrict__ gam_in,   // (p, q)
    const float* __restrict__ mu_in,    // (p, q)
    const float* __restrict__ xns,      // (p, q) x_norm_sq
    const float* __restrict__ mask,     // (n, q) observation pattern
    const float* __restrict__ l_aug,    // (p, R)
    const float* __restrict__ n_stack,  // (3, R, q)
    float* __restrict__ fm,             // (n, q) masked F, advanced in place
    const float* __restrict__ theta,    // (p,)
    const float* __restrict__ p_mask,   // (p,)
    const float* __restrict__ zeta,     // (q,)
    const float* __restrict__ q_mask,   // (q,)
    const float* __restrict__ tauv,     // (q,)
    const float* __restrict__ scal,     // (3,) c, K/c, sig2_inv
    float* __restrict__ gam_out,        // (p, q)
    float* __restrict__ mu_out,         // (p, q)
    float* __restrict__ zrow_part,      // (n_slices, p)
    float* __restrict__ z_col,          // (q,)
    int n, int p, int q, int B, int R) {
  extern __shared__ __align__(16) float smem[];
  float* CP_s = smem;              // B x QS block of X^T Y
  float* BO_s = CP_s + B * QS;     // B x QS pre-sweep beta = gam * mu
  float* XNS_s = BO_s + B * QS;    // B x QS x_norm_sq
  float* AD_s = XNS_s + B * QS;    // B x QS logit constants
  float* GAM_s = AD_s + B * QS;    // B x QS new gam, masked
  float* L_s = GAM_s + B * QS;     // B x R interpolation basis
  float* N_s = L_s + B * R;        // 3 x R x QS node values
  float* D_s = N_s + 3 * R * QS;   // W x QS deltas of the latest window
  float* RH_s = D_s + W * QS;      // NRH x QS sums of the latest pass
  float* PART_s = RH_s + NRH * QS;  // NW x NRH x QS per-warp partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * QS;
  const int k = k0 + lane;
  const bool cvalid = k < q;
  const float c = scal[0], kz = scal[1], sig2_inv = scal[2];
  const float half_c = 0.5f * c, c2_half = 0.5f * c * c;

  for (int e = tid; e < 3 * R * QS; e += NT) {
    const int kk = e % QS, mr = e / QS;
    N_s[e] = (k0 + kk < q) ? n_stack[(size_t)mr * q + k0 + kk] : 0.f;
  }
  // the element mapping of the per-block tiles: rows warp, warp + NW, ...,
  // column lane
  const float zeta_k = cvalid ? zeta[k] : 0.f;
  const float qm_k = cvalid ? q_mask[k] : 0.f;
  const float tau_k = cvalid ? tauv[k] : 1.f;
  float zc = 0.f;

  const int nb = p / B;
  for (int b = 0; b < nb; ++b) {
    const int j0 = b * B;
    __syncthreads();  // the previous block is done with every tile
    for (int e = tid; e < B * R; e += NT) L_s[e] = l_aug[(size_t)j0 * R + e];
    for (int e = tid; e < B * QS / 4; e += NT) {
      const int i = e / (QS / 4), kk = (e % (QS / 4)) * 4;
      const bool ok = k0 + kk < q;
      const size_t off = (size_t)(j0 + i) * q + k0 + kk;
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 g4 = ok ? ld4(gam_in + off) : z4;
      const float4 m4 = ok ? ld4(mu_in + off) : z4;
      *reinterpret_cast<float4*>(CP_s + i * QS + kk) = ok ? ld4(cp + off) : z4;
      *reinterpret_cast<float4*>(XNS_s + i * QS + kk) = ok ? ld4(xns + off) : z4;
      *reinterpret_cast<float4*>(BO_s + i * QS + kk) =
          make_float4(g4.x * m4.x, g4.y * m4.y, g4.z * m4.z, g4.w * m4.w);
    }
    __syncthreads();

    // logit tile: c d(u) from the interpolation product and the sqrt base,
    // minus (c/2) log(x_norm_sq + sig2_inv)
    for (int i = warp; i < B; i += NW) {
      float dot = 0.f;
      for (int rr = 0; rr < R; ++rr) dot += L_s[i * R + rr] * N_s[rr * QS + lane];
      const float u = theta[j0 + i] + zeta_k;
      const float sd = sqrtf(u * u + K_BASE);
      AD_s[i * QS + lane] = c * (0.5f * u * sd) + dot -
                            half_c * logf(XNS_s[i * QS + lane] + sig2_inv);
    }

    for (int lo = 0; lo < B; lo += W) {
      const int jw = j0 + lo;
      // advance by the previous window (if any), project this one
      if (jw > 0)
        window_pass<true, true>(fm, mask, x, D_s, PART_s, n, p, q, k, cvalid,
                                jw - W, jw, warp, lane);
      else
        window_pass<false, true>(fm, mask, x, D_s, PART_s, n, p, q, k, cvalid,
                                 0, jw, warp, lane);
      __syncthreads();
      for (int e = tid; e < NRH * QS; e += NT) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < NW; ++g) s += PART_s[g * NRH * QS + e];
        RH_s[e] = s;
      }
      __syncthreads();

      // ---- the sequential chain of the window, one lane per column ------
      if (warp == 0) {
        float rr[W];
#pragma unroll
        for (int i = 0; i < W; ++i) rr[i] = RH_s[i * QS + lane];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int row = lo + i;
          const int j = j0 + row;
          const float bo = BO_s[row * QS + lane];
          const float xn = XNS_s[row * QS + lane];
          const float r = rr[i] - bo * xn;
          const float ct = 1.f / (xn + sig2_inv);
          const float d = CP_s[row * QS + lane] - r;
          const float mu = ct * d;
          const float logit = AD_s[row * QS + lane] + (c2_half * tau_k) * (mu * d);
          const float gam = 1.f / (1.f + expf(-logit));
          const float delta = gam * mu - bo;
          D_s[i * QS + lane] = delta;
          const float msk = p_mask[j] * qm_k;
          GAM_s[row * QS + lane] = gam * msk;
          if (cvalid) {
            const size_t off = (size_t)j * q + k;
            gam_out[off] = gam * msk;
            mu_out[off] = mu * msk;
          }
#pragma unroll
          for (int a = i + 1; a < W; ++a)
            rr[a] += RH_s[(W + a * (a - 1) / 2 + i) * QS + lane] * delta;
        }
      }
      __syncthreads();
    }

    // ---- Z moments: z = (gam * imrd + imr0u) * mask, row/column sums ----
    for (int i = warp; i < B; i += NW) {
      float d1 = 0.f, d2 = 0.f;
      for (int rr = 0; rr < R; ++rr) {
        const float l = L_s[i * R + rr];
        d1 += l * N_s[(R + rr) * QS + lane];
        d2 += l * N_s[(2 * R + rr) * QS + lane];
      }
      const float pm = p_mask[j0 + i];
      const float u = theta[j0 + i] + zeta_k;
      const float sz = sqrtf(u * u + kz);
      const float imrd = sz + d1;
      const float imr0u = d2 - 0.5f * (sz + u);
      float z = (GAM_s[i * QS + lane] * imrd + imr0u) * (pm * qm_k);
      zc += z;
      z += __shfl_xor_sync(0xffffffffu, z, 16);
      z += __shfl_xor_sync(0xffffffffu, z, 8);
      z += __shfl_xor_sync(0xffffffffu, z, 4);
      z += __shfl_xor_sync(0xffffffffu, z, 2);
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      if (lane == 0) zrow_part[(size_t)blockIdx.x * p + j0 + i] = z;
    }
  }

  // the last window's advance
  window_pass<true, false>(fm, mask, x, D_s, PART_s, n, p, q, k, cvalid,
                           p - W, 0, warp, lane);
  __syncthreads();
  PART_s[warp * QS + lane] = zc;
  __syncthreads();
  if (tid < QS && k0 + tid < q) {
    float s = 0.f;
    for (int g = 0; g < NW; ++g) s += PART_s[g * QS + tid];
    z_col[k0 + tid] = s;
  }
}

}  // namespace

extern "C" {

// Launches one exact-missing sweep (the sweep kernel, then the z_row
// reduction) on `stream`.  Returns the CUDA error code of the launches (0 on
// success).
int atlasqtl_sweep_missing_fused(
    const float* x, const float* cp, const float* gam_in, const float* mu_in,
    const float* xns, const float* mask, const float* l_aug,
    const float* n_stack, float* fm, const float* theta, const float* p_mask,
    const float* zeta, const float* q_mask, const float* tauv,
    const float* scal, float* gam_out, float* mu_out, float* zrow_part,
    float* z_row, float* z_col, int n, int p, int q, int B, int R,
    void* stream) {
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || R <= 0 || R > RMAX ||
      q % 4 != 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, R);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_missing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_missing_kernel<<<n_slices, NT, smem, st>>>(
      x, cp, gam_in, mu_in, xns, mask, l_aug, n_stack, fm, theta, p_mask,
      zeta, q_mask, tauv, scal, gam_out, mu_out, zrow_part, z_col, n, p, q, B,
      R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<(p + 255) / 256, 256, 0, st>>>(zrow_part, z_row,
                                                       n_slices, p);
  return (int)cudaGetLastError();
}

int atlasqtl_sweep_missing_slices(int q) { return (q + QS - 1) / QS; }

int atlasqtl_sweep_missing_window() { return W; }

}  // extern "C"
