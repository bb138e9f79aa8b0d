// One whole complete-data Gauss-Seidel sweep of the global-local CAVI
// iteration, as one CUDA kernel for Hopper (sm_90a), plus a second small
// kernel that reduces the per-slice z_row partials in a fixed order.
//
// Replaces the TPU kernel atlasqtl_tpu/ops/sweep_fused.py:_fused_kernel
// (probe="none").  It computes the same function with one deliberate
// difference: each coordinate's Gram diagonal is the true x_j^T x_j read from
// the Gram block, where the TPU kernel uses n_pad - 1 (wrong whenever the
// sample count is not a multiple of 8).
//
// What bounds it on an H100: the two products r0 = x_b^T F and F += x_b delta
// are 4 n p q FP32 operations per sweep (2e12 at n=1000, p=50000, q=10000,
// 30 ms at the 67 TFLOP/s non-tensor FP32 peak); the bytes it must move (x,
// cp, beta in, beta out, F in and out) take about 2 ms at 3.35 TB/s, so
// arithmetic, not memory, sets the bound.  The products run on the FP32 FMA
// pipes without TF32, because the reference's products are full f32.
//
// Design (simple on purpose; speed is later work):
//  - one CTA of 256 threads owns QS = 32 response columns and walks every
//    predictor block b = 0..nb-1 in order.  The columns are independent given
//    theta/zeta, so CTAs never communicate during the walk; F stays in device
//    memory and each CTA updates its own columns in place;
//  - per block: r0 = x_b^T F and F += x_b delta as shared-memory tiled FMA
//    loops over n (4x4 register tiles); the logit and Mills tiles as the
//    small (B x R) @ (R x QS) interpolation product plus the sqrt base;
//  - the strictly sequential update of the B coordinates (k-major, j
//    ascending) runs in windows of W = 8 rows: all warps first apply the
//    corrections of every earlier row of the block (left-looking, one warp
//    per row), then warp 0 runs the window's chain with one lane per column
//    and the window's residuals in registers, pushing each delta to the
//    window's later rows;
//  - the per-element formulas are common.cuh's, every rounding written
//    out, and the sums are explicit fmaf chains, so the staggered kernel
//    (sweep_staggered.cu) reproduces this kernel's results bit for bit;
//  - column statistics and z_col accumulate in registers across blocks;
//    z_row goes to a (n_slices, p) partial buffer reduced by the second
//    kernel.  No atomics: results are the same from run to run.
#include "common.cuh"

namespace {

constexpr int QS = 32;     // response columns per CTA
constexpr int NT = 256;    // threads per CTA
constexpr int W = 8;       // chain window (rows)
constexpr int BMAX = 128;  // largest predictor block
constexpr int RMAX = 48;   // largest interpolation width (r + 2)
constexpr int NC = 32;     // n-chunk of the projection
constexpr int EN = 128;    // n-chunk of the F advance
constexpr int EK = 32;     // depth chunk of the F advance
constexpr int ALD = EK + 1;  // padded row of the advance's x tile

__host__ __device__ constexpr int stage_floats(int B) {
  return (NC * B + NC * QS) > (EN * ALD) ? (NC * B + NC * QS) : (EN * ALD);
}

size_t smem_bytes(int B, int R) {
  return sizeof(float) *
         (size_t)(B * B + 6 * B * QS + B * R + 3 * R * QS + stage_floats(B));
}

__global__ void __launch_bounds__(NT, 1) sweep_fused_kernel(
    const float* __restrict__ x,        // (n, p)
    const float* __restrict__ cp,       // (p, q)
    const float* __restrict__ gram,     // (p, B) stacked diagonal Gram blocks
    const float* __restrict__ l_aug,    // (p, R)
    const float* __restrict__ n_stack,  // (3, R, q)
    const float* __restrict__ beta_in,  // (p, q)
    float* __restrict__ fitted,         // (n, q), advanced in place
    const float* __restrict__ theta,    // (p,)
    const float* __restrict__ p_mask,   // (p,)
    const float* __restrict__ zeta,     // (q,)
    const float* __restrict__ q_mask,   // (q,)
    const float* __restrict__ s2v,      // (q,) slab variance
    const float* __restrict__ tauv,     // (q,)
    const float* __restrict__ scal,     // (2,) c, K/c
    float* __restrict__ beta_out,       // (p, q)
    float* __restrict__ gam_out,        // (p, q) or null
    float* __restrict__ mu_out,         // (p, q) or null
    float* __restrict__ zrow_part,      // (n_slices, p)
    float* __restrict__ z_col,          // (q,)
    float* __restrict__ gcol,           // (q,)
    float* __restrict__ m2gcol,         // (q,)
    float* __restrict__ b2col,          // (q,)
    int n, int p, int q, int B, int R, int c_one) {
  extern __shared__ __align__(16) float smem[];
  float* G_s = smem;               // B x B Gram block
  float* R_s = G_s + B * B;        // B x QS residual projections
  float* D_s = R_s + B * QS;       // B x QS deltas
  float* AD_s = D_s + B * QS;      // B x QS folded logit constants
  float* GAM_s = AD_s + B * QS;    // B x QS new gam
  float* CP_s = GAM_s + B * QS;    // B x QS block of X^T Y
  float* BO_s = CP_s + B * QS;     // B x QS pre-sweep beta
  float* L_s = BO_s + B * QS;      // B x R interpolation basis
  float* N_s = L_s + B * R;        // 3 x R x QS node values
  float* ST = N_s + 3 * R * QS;    // staging for the two products

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;  // 4x4 tiles: cols tx*4.., rows ty*4..
  const bool trow = ty * 4 < B;
  const int k0 = blockIdx.x * QS;
  const float c = scal[0], kz = scal[1];

  for (int e = tid; e < 3 * R * QS; e += NT) {
    const int kk = e % QS, mr = e / QS;
    N_s[e] = (k0 + kk < q) ? n_stack[(size_t)mr * q + k0 + kk] : 0.f;
  }
  float zeta4[4], qm4[4], zc4[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int k = k0 + tx * 4 + jj;
    zeta4[jj] = k < q ? zeta[k] : 0.f;
    qm4[jj] = k < q ? q_mask[k] : 0.f;
    zc4[jj] = 0.f;
  }
  // chain constants: warp 0, one lane per column
  const int kc = k0 + lane;
  const bool cvalid = kc < q;
  float ct = 0.f, cinv = 0.f, qmc = 0.f;
  if (cvalid) {
    const float s2 = s2v[kc];
    ct = c * s2 * tauv[kc];
    cinv = c * 0.5f / s2;
    qmc = q_mask[kc];
  }
  float gacc = 0.f, m2acc = 0.f, b2acc = 0.f;

  const int nb = p / B;
  for (int b = 0; b < nb; ++b) {
    const int j0 = b * B;
    __syncthreads();  // the previous block is done with every buffer
    for (int e = tid; e < B * B; e += NT) G_s[e] = gram[(size_t)j0 * B + e];
    for (int e = tid; e < B * R; e += NT) L_s[e] = l_aug[(size_t)j0 * R + e];
    for (int e = tid; e < B * QS / 4; e += NT) {
      const int i = e / (QS / 4), kk = (e % (QS / 4)) * 4;
      const bool ok = k0 + kk < q;
      const size_t off = (size_t)(j0 + i) * q + k0 + kk;
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(CP_s + i * QS + kk) = ok ? ld4(cp + off) : z4;
      *reinterpret_cast<float4*>(BO_s + i * QS + kk) =
          ok ? ld4(beta_in + off) : z4;
    }

    // ---- r0 = x_b^T F --------------------------------------------------
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[a][jj] = 0.f;
    float* XS = ST;
    float* FS = ST + NC * B;
    for (int n0 = 0; n0 < n; n0 += NC) {
      __syncthreads();
      for (int e = tid; e < NC * B / 4; e += NT) {
        const int rr = e / (B / 4), c4 = (e % (B / 4)) * 4;
        const int nn = n0 + rr;
        *reinterpret_cast<float4*>(XS + rr * B + c4) =
            nn < n ? ld4(x + (size_t)nn * p + j0 + c4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int e = tid; e < NC * QS / 4; e += NT) {
        const int rr = e / (QS / 4), c4 = (e % (QS / 4)) * 4;
        const int nn = n0 + rr;
        *reinterpret_cast<float4*>(FS + rr * QS + c4) =
            (nn < n && k0 + c4 < q) ? ld4(fitted + (size_t)nn * q + k0 + c4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      if (trow) {
#pragma unroll 8
        for (int kk = 0; kk < NC; ++kk) {
          const float4 av = ld4(XS + kk * B + ty * 4);
          const float4 fv = ld4(FS + kk * QS + tx * 4);
          const float a4[4] = {av.x, av.y, av.z, av.w};
          const float f4[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[a][jj] = fmaf(a4[a], f4[jj], acc[a][jj]);
        }
      }
    }
    __syncthreads();  // CP_s / BO_s staged

    // remove each coordinate's own contribution with the TRUE Gram diagonal;
    // the logit tile ad = base + L_b N_ad
    if (trow) {
      float dot[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[a][jj] = 0.f;
      for (int rr = 0; rr < R; ++rr) {
        const float4 nv = ld4(N_s + rr * QS + tx * 4);
        const float n4[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float l = L_s[(ty * 4 + a) * R + rr];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dot[a][jj] = fmaf(l, n4[jj], dot[a][jj]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        const float d = G_s[i * B + i];
        const float th = theta[j0 + i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kk = tx * 4 + jj;
          R_s[i * QS + kk] = fmaf(-BO_s[i * QS + kk], d, acc[a][jj]);
          AD_s[i * QS + kk] =
              __fadd_rn(logit_base(th + zeta4[jj], c, c_one), dot[a][jj]);
        }
      }
    }
    __syncthreads();

    // ---- the sequential chain, windows of W rows -------------------------
    for (int lo = 0; lo < B; lo += W) {
      if (lo > 0) {
        const int i = lo + warp;
        float corr = 0.f;
        for (int m = 0; m < lo; ++m) corr = fmaf(G_s[i * B + m], D_s[m * QS + lane], corr);
        R_s[i * QS + lane] = __fadd_rn(R_s[i * QS + lane], corr);
        __syncthreads();
      }
      if (warp == 0) {
        float rr[W];
#pragma unroll
        for (int m = 0; m < W; ++m) rr[m] = R_s[(lo + m) * QS + lane];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int row = lo + i;
          const int j = j0 + row;
          const ChainStep st =
              chain_step(ct, CP_s[row * QS + lane], rr[i], AD_s[row * QS + lane],
                         cinv, BO_s[row * QS + lane]);
          D_s[row * QS + lane] = st.delta;
          GAM_s[row * QS + lane] = st.gam;
#pragma unroll
          for (int m = i + 1; m < W; ++m)
            rr[m] = fmaf(G_s[(lo + m) * B + row], st.delta, rr[m]);
          const float pm = p_mask[j];
          if (cvalid) {
            const float msk = __fmul_rn(pm, qmc);
            const size_t off = (size_t)j * q + kc;
            beta_out[off] = __fmul_rn(st.bnew, msk);
            if (gam_out != nullptr) {
              gam_out[off] = __fmul_rn(st.gam, msk);
              mu_out[off] = __fmul_rn(st.mu, msk);
            }
          }
          gacc = fmaf(pm, st.gam, gacc);
          m2acc = fmaf(pm, __fmul_rn(st.bnew, st.mu), m2acc);
          b2acc = fmaf(pm, __fmul_rn(st.bnew, st.bnew), b2acc);
        }
      }
      __syncthreads();
    }

    // ---- Z moments: z = gam * imrd + imr0u, masked row/column sums -------
    {
      float d1[4][4], d2[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) d1[a][jj] = d2[a][jj] = 0.f;
      if (trow) {
        for (int rr = 0; rr < R; ++rr) {
          const float4 v1 = ld4(N_s + (R + rr) * QS + tx * 4);
          const float4 v2 = ld4(N_s + (2 * R + rr) * QS + tx * 4);
          const float n1[4] = {v1.x, v1.y, v1.z, v1.w};
          const float n2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float l = L_s[(ty * 4 + a) * R + rr];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              d1[a][jj] = fmaf(l, n1[jj], d1[a][jj]);
              d2[a][jj] = fmaf(l, n2[jj], d2[a][jj]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        float zr = 0.f, pm = 0.f;
        if (trow) {
          const float th = theta[j0 + i];
          pm = p_mask[j0 + i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float zq = z_cell(th + zeta4[jj], GAM_s[i * QS + tx * 4 + jj],
                                    d1[a][jj], d2[a][jj], qm4[jj], kz, c_one);
            zr = __fadd_rn(zr, zq);
            zc4[jj] = fmaf(pm, zq, zc4[jj]);
          }
        }
        zr += __shfl_xor_sync(0xffffffffu, zr, 1);
        zr += __shfl_xor_sync(0xffffffffu, zr, 2);
        zr += __shfl_xor_sync(0xffffffffu, zr, 4);
        if (trow && tx == 0) zrow_part[(size_t)blockIdx.x * p + j0 + i] = __fmul_rn(pm, zr);
      }
    }

    // ---- F += x_b delta ----------------------------------------------------
    float* AS = ST;
    for (int n0 = 0; n0 < n; n0 += EN) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[a][jj] = 0.f;
      for (int kb = 0; kb < B; kb += EK) {
        __syncthreads();
        for (int e = tid; e < EN * EK / 4; e += NT) {
          const int rr = e / (EK / 4), c4 = (e % (EK / 4)) * 4;
          const int nn = n0 + rr;
          const float4 v = (nn < n && kb + c4 < B)
                               ? ld4(x + (size_t)nn * p + j0 + kb + c4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          float* dst = AS + rr * ALD + c4;
          dst[0] = v.x;
          dst[1] = v.y;
          dst[2] = v.z;
          dst[3] = v.w;
        }
        __syncthreads();
        const int kmax = min(EK, B - kb);
        for (int kk = 0; kk < kmax; ++kk) {
          const float4 dv = ld4(D_s + (kb + kk) * QS + tx * 4);
          const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float xv = AS[(ty * 4 + a) * ALD + kk];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[a][jj] = fmaf(xv, d4[jj], acc[a][jj]);
          }
        }
      }
      if (k0 + tx * 4 < q) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int nn = n0 + ty * 4 + a;
          if (nn < n) {
            float4* fp = reinterpret_cast<float4*>(fitted + (size_t)nn * q + k0 + tx * 4);
            float4 f = *fp;
            f.x = __fadd_rn(f.x, acc[a][0]);
            f.y = __fadd_rn(f.y, acc[a][1]);
            f.z = __fadd_rn(f.z, acc[a][2]);
            f.w = __fadd_rn(f.w, acc[a][3]);
            *fp = f;
          }
        }
      }
    }
  }

  // ---- per-column outputs (fixed-order reduction over the row groups) ----
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) ST[ty * QS + tx * 4 + jj] = zc4[jj];
  __syncthreads();
  if (tid < QS && k0 + tid < q) {
    float s = 0.f;
    for (int g = 0; g < NT / 8; ++g) s += ST[g * QS + tid];
    z_col[k0 + tid] = s;
  }
  if (warp == 0 && cvalid) {
    gcol[kc] = gacc * qmc;
    m2gcol[kc] = m2acc * qmc;
    b2col[kc] = b2acc * qmc;
  }
}

}  // namespace

extern "C" {

// Launches one sweep (the sweep kernel, then the z_row reduction) on
// `stream`.  Returns the CUDA error code of the launches (0 on success).
int atlasqtl_sweep_fused(const float* x, const float* cp, const float* gram,
                         const float* l_aug, const float* n_stack,
                         const float* beta_in, float* fitted,
                         const float* theta, const float* p_mask,
                         const float* zeta, const float* q_mask,
                         const float* s2v, const float* tauv,
                         const float* scal, float* beta_out, float* gam_out,
                         float* mu_out, float* zrow_part, float* z_row,
                         float* z_col, float* gcol, float* m2gcol,
                         float* b2col, int n, int p, int q, int B, int R,
                         int c_one, void* stream) {
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || R <= 0 || R > RMAX ||
      q % 4 != 0 || n <= 0 || (gam_out == nullptr) != (mu_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, R);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_fused_kernel<<<n_slices, NT, smem, st>>>(
      x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, p_mask, zeta,
      q_mask, s2v, tauv, scal, beta_out, gam_out, mu_out, zrow_part, z_col,
      gcol, m2gcol, b2col, n, p, q, B, R, c_one);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<(p + 255) / 256, 256, 0, st>>>(zrow_part, z_row,
                                                       n_slices, p);
  return (int)cudaGetLastError();
}

int atlasqtl_sweep_slices(int q) { return (q + QS - 1) / QS; }

const char* atlasqtl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
