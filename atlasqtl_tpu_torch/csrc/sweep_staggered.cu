// The staggered complete-data sweep: B1's function (csrc/sweep_fused.cu) with
// each CTA's 32 response columns split into two halves of 16, half B lagging
// half A by half a step, so that the chain of one half runs while the other
// half's products run.  One CUDA kernel for Hopper (sm_90a), plus the
// z_row reduction of csrc/common.cuh.
//
// Replaces the TPU kernel atlasqtl_tpu/ops/sweep_staggered.py:_stag_kernel.
// Same function as B1, with B1's deliberate difference from the TPU kernels:
// each coordinate's Gram diagonal is the true x_j^T x_j, not n_pad - 1.
//
// Why: in B1 the strictly sequential chain runs on warp 0 while the other
// warps wait, and the two products (r0 = x_b^T F, F += x_b delta) wait for
// the chain.  The columns of the two halves are independent, so:
//
//   chain warp:    chain_A(b)            chain_B(b)              chain_A(b+1)
//   product warps: Z+adv_B(b-1), r0_B(b) Z+adv_A(b), r0_A(b+1)  Z+adv_B(b), ...
//
// Every operand is ready when used: chain_X(b) waits for r0_X(b); the advance
// of half X for block b waits for chain_X(b).  The hand-offs are named
// barriers (bar.arrive by the producing side, bar.sync by the consuming
// side; ids 2-5), the product warps synchronise among themselves on id 1.
//
// What bounds it on an H100: as B1, the two products, 4 n p q FP32
// operations per sweep (no TF32); the bytes take under a tenth of that.
// The chain warp's work (the window corrections and the chain, for 16
// columns) is a fraction of the products' at n >= 1000, so it hides behind
// them.
//
// Per column every operation is B1's: the same per-element formulas from
// common.cuh with every rounding written out, the same windows of the
// chain.  The sums run in the order B1 had before its redesign (a
// projection pass and an advance pass per block); B1 now sums its products
// in one fused pass per block, so the two kernels agree to f32 tolerance,
// not bit for bit.
//
// Shared memory: the operands of blocks b and b-1 are live at once.  The
// Gram enters as its packed lower triangle (all the sweep reads), double
// buffered (66 KB at B = 128); per half the residuals, deltas, logit tiles
// and new gam (16 KB each); the node values and one staging area.  The
// interpolation basis and the blocks of X^T Y and beta are read from device
// memory (L1/L2), as each is used once per half.  168 KB at B = 128, R = 48.
#include "common.cuh"

namespace {

constexpr int QS = 32;        // response columns per CTA (B1's slice)
constexpr int HQ = 16;        // columns per half
constexpr int NP = 256;       // product threads (8 warps)
constexpr int NT = NP + 32;   // + the chain warp
constexpr int W = 8;          // chain window (rows)
constexpr int BMAX = 128;     // largest predictor block
constexpr int RMAX = 48;      // largest interpolation width (r + 2)
constexpr int NC = 32;        // n-chunk of the projection
constexpr int EN = 128;       // n-chunk of the F advance
constexpr int EK = 32;        // depth chunk of the F advance
constexpr int ALD = EK + 1;   // padded row of the advance's x tile

constexpr int BAR_P = 1;      // the product warps among themselves
constexpr int BAR_READY = 2;  // + half: r0 and logit tile of a half ready
constexpr int BAR_DONE = 4;   // + half: the chain of a half done

__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }
__host__ __device__ constexpr int tri_pad(int B) { return (tri(B) + 3) & ~3; }

__host__ __device__ constexpr int stage_floats(int B) {
  return (NC * B + NC * HQ) > (EN * ALD) ? (NC * B + NC * HQ) : (EN * ALD);
}

size_t smem_bytes(int B, int R) {
  return sizeof(float) * (size_t)(2 * tri_pad(B) + 8 * B * HQ + 3 * R * QS +
                                  stage_floats(B));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__global__ void __launch_bounds__(NT, 1) sweep_staggered_kernel(
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
  float* GB = smem;                     // 2 x packed lower-triangular Gram
  float* HB = GB + 2 * tri_pad(B);      // per half: R, D, AD, GAM (B x HQ)
  float* N_s = HB + 8 * B * HQ;         // 3 x R x QS node values
  float* ST = N_s + 3 * R * QS;         // staging of the products
  auto r_of = [&](int h) { return HB + (4 * h + 0) * B * HQ; };
  auto d_of = [&](int h) { return HB + (4 * h + 1) * B * HQ; };
  auto ad_of = [&](int h) { return HB + (4 * h + 2) * B * HQ; };
  auto gam_of = [&](int h) { return HB + (4 * h + 3) * B * HQ; };

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * QS;
  const float c = scal[0], kz = scal[1];
  const int nb = p / B;

  for (int e = tid; e < 3 * R * QS; e += NT) {
    const int kk = e % QS, mr = e / QS;
    N_s[e] = (k0 + kk < q) ? n_stack[(size_t)mr * q + k0 + kk] : 0.f;
  }
  __syncthreads();

  if (tid >= NP) {
    // ======================= the chain warp =============================
    const int lane = tid - NP;
    const int col = lane & (HQ - 1);
    float ct[2], cinv[2], qmc[2];
    bool cvalid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kc = k0 + h * HQ + col;
      cvalid[h] = kc < q;
      ct[h] = cinv[h] = qmc[h] = 0.f;
      if (cvalid[h]) {
        const float s2 = s2v[kc];
        ct[h] = c * s2 * tauv[kc];
        cinv[h] = c * 0.5f / s2;
        qmc[h] = q_mask[kc];
      }
    }
    float gacc[2] = {0.f, 0.f}, m2acc[2] = {0.f, 0.f}, b2acc[2] = {0.f, 0.f};

    for (int b = 0; b < nb; ++b) {
      const int j0 = b * B;
      const float* G = GB + (b & 1) * tri_pad(B);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* R_s = r_of(h);
        float* D_s = d_of(h);
        const float* AD_s = ad_of(h);
        float* GAM_s = gam_of(h);
        const int kc = k0 + h * HQ + col;
        __syncwarp();
        bar_sync(BAR_READY + h, NT);
        for (int lo = 0; lo < B; lo += W) {
          if (lo > 0) {
            // the corrections of every earlier row of the block, for rows
            // lo + rg*4 .. lo + rg*4 + 3 of this lane's column
            const int rg = lane >> 4;
            float corr[4] = {0.f, 0.f, 0.f, 0.f};
            for (int m = 0; m < lo; ++m) {
              const float dv = D_s[m * HQ + col];
#pragma unroll
              for (int t = 0; t < 4; ++t)
                corr[t] = fmaf(G[tri(lo + rg * 4 + t) + m], dv, corr[t]);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              float* rp = R_s + (lo + rg * 4 + t) * HQ + col;
              *rp = __fadd_rn(*rp, corr[t]);
            }
            __syncwarp();
          }
          if (lane < HQ) {
            float rr[W], cpw[W], bow[W];
#pragma unroll
            for (int m = 0; m < W; ++m) {
              const size_t off = (size_t)(j0 + lo + m) * q + kc;
              rr[m] = R_s[(lo + m) * HQ + col];
              cpw[m] = cvalid[h] ? cp[off] : 0.f;
              bow[m] = cvalid[h] ? beta_in[off] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const int row = lo + i;
              const int j = j0 + row;
              const ChainStep st = chain_step(ct[h], cpw[i], rr[i],
                                              AD_s[row * HQ + col], cinv[h],
                                              bow[i]);
              D_s[row * HQ + col] = st.delta;
              GAM_s[row * HQ + col] = st.gam;
#pragma unroll
              for (int m = i + 1; m < W; ++m)
                rr[m] = fmaf(G[tri(lo + m) + row], st.delta, rr[m]);
              const float pm = p_mask[j];
              if (cvalid[h]) {
                const float msk = __fmul_rn(pm, qmc[h]);
                const size_t off = (size_t)j * q + kc;
                beta_out[off] = __fmul_rn(st.bnew, msk);
                if (gam_out != nullptr) {
                  gam_out[off] = __fmul_rn(st.gam, msk);
                  mu_out[off] = __fmul_rn(st.mu, msk);
                }
              }
              gacc[h] = fmaf(pm, st.gam, gacc[h]);
              m2acc[h] = fmaf(pm, __fmul_rn(st.bnew, st.mu), m2acc[h]);
              b2acc[h] = fmaf(pm, __fmul_rn(st.bnew, st.bnew), b2acc[h]);
            }
          }
          __syncwarp();
        }
        bar_arrive(BAR_DONE + h, NT);
      }
    }
    // the two roles meet on barrier 0 twice more, as the product warps'
    // final reduction needs (bar.sync counts warps, not code locations)
    bar_sync(0, NT);
    if (lane < HQ) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cvalid[h]) {
          const int kc = k0 + h * HQ + col;
          gcol[kc] = gacc[h] * qmc[h];
          m2gcol[kc] = m2acc[h] * qmc[h];
          b2col[kc] = b2acc[h] * qmc[h];
        }
      }
    }
    bar_sync(0, NT);
  } else {
    // ======================= the product warps ==========================
    // each thread owns rows ty*4 .. ty*4+3 and columns tx*2, tx*2+1 of a
    // half; B1's thread (ty, tx') holds columns tx'*4 .. tx'*4+3, i.e. the
    // pair (ty, 2 tx') and (ty, 2 tx' + 1) here
    const int tx = tid & 7, ty = tid >> 3;
    const bool trow = ty * 4 < B;
    float zeta2[2][2], qm2[2][2], zc[2][2], zA[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int k = k0 + h * HQ + tx * 2 + jj;
        zeta2[h][jj] = k < q ? zeta[k] : 0.f;
        qm2[h][jj] = k < q ? q_mask[k] : 0.f;
        zc[h][jj] = 0.f;
      }

    for (int b = 0; b <= nb; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kh = k0 + h * HQ;  // the half's first column
        if (b > 0) {
          // ---- block b-1 of this half: Z moments, then F += x_b delta ----
          const int j0 = (b - 1) * B;
          const float* GAM_s = gam_of(h);
          const float* D_s = d_of(h);
          bar_sync(BAR_DONE + h, NT);
          {
            float d1[4][2], d2[4][2];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) d1[a][jj] = d2[a][jj] = 0.f;
            if (trow) {
              for (int rr = 0; rr < R; ++rr) {
                const float2 v1 = ld2(N_s + (R + rr) * QS + h * HQ + tx * 2);
                const float2 v2 = ld2(N_s + (2 * R + rr) * QS + h * HQ + tx * 2);
                const float n1[2] = {v1.x, v1.y};
                const float n2[2] = {v2.x, v2.y};
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                  const float l = l_aug[(size_t)(j0 + ty * 4 + a) * R + rr];
#pragma unroll
                  for (int jj = 0; jj < 2; ++jj) {
                    d1[a][jj] = fmaf(l, n1[jj], d1[a][jj]);
                    d2[a][jj] = fmaf(l, n2[jj], d2[a][jj]);
                  }
                }
              }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int i = ty * 4 + a;
              float zq2[2] = {0.f, 0.f}, pm = 0.f;
              if (trow) {
                const float th = theta[j0 + i];
                pm = p_mask[j0 + i];
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                  const float zq = z_cell(th + zeta2[h][jj],
                                          GAM_s[i * HQ + tx * 2 + jj],
                                          d1[a][jj], d2[a][jj], qm2[h][jj], kz,
                                          c_one);
                  zq2[jj] = zq;
                  zc[h][jj] = fmaf(pm, zq, zc[h][jj]);
                }
              }
              // B1's per-thread sum over 4 columns, in column order, carried
              // from the even to the odd thread of the pair
              float zr = __fadd_rn(__fadd_rn(0.f, zq2[0]), zq2[1]);
              const float first = __shfl_xor_sync(0xffffffffu, zr, 1);
              if (tx & 1) zr = __fadd_rn(__fadd_rn(first, zq2[0]), zq2[1]);
              // B1's butterfly over its column groups: within a half here,
              // then the two halves' sums added
              zr += __shfl_xor_sync(0xffffffffu, zr, 2);
              zr += __shfl_xor_sync(0xffffffffu, zr, 4);
              if (h == 0) {
                zA[a] = zr;
              } else if (trow && tx == 1) {
                zrow_part[(size_t)blockIdx.x * p + j0 + i] = __fmul_rn(pm, zA[a] + zr);
              }
            }
          }
          {
            float acc[4][2];
            float* AS = ST;
            for (int n0 = 0; n0 < n; n0 += EN) {
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) acc[a][jj] = 0.f;
              for (int kb = 0; kb < B; kb += EK) {
                bar_sync(BAR_P, NP);
                for (int e = tid; e < EN * EK / 4; e += NP) {
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
                bar_sync(BAR_P, NP);
                const int kmax = min(EK, B - kb);
                for (int kk = 0; kk < kmax; ++kk) {
                  const float2 dv = ld2(D_s + (kb + kk) * HQ + tx * 2);
                  const float d2v[2] = {dv.x, dv.y};
#pragma unroll
                  for (int a = 0; a < 4; ++a) {
                    const float xv = AS[(ty * 4 + a) * ALD + kk];
#pragma unroll
                    for (int jj = 0; jj < 2; ++jj) acc[a][jj] = fmaf(xv, d2v[jj], acc[a][jj]);
                  }
                }
              }
              if (kh + tx * 2 < q) {
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                  const int nn = n0 + ty * 4 + a;
                  if (nn < n) {
                    float2* fp = reinterpret_cast<float2*>(fitted + (size_t)nn * q + kh + tx * 2);
                    float2 f = *fp;
                    f.x = __fadd_rn(f.x, acc[a][0]);
                    f.y = __fadd_rn(f.y, acc[a][1]);
                    *fp = f;
                  }
                }
              }
            }
          }
        }
        if (b < nb) {
          // ---- block b of this half: r = x_b^T F - beta_b diag, logit tile ----
          const int j0 = b * B;
          float* Gw = GB + (b & 1) * tri_pad(B);
          if (h == 0) {
            // the chain warp finished with this buffer (block b-2) before
            // it signalled chain_A(b-1) done
            for (int e = tid; e < B * B; e += NP) {
              const int i = e / B, m = e % B;
              if (m <= i) Gw[tri(i) + m] = gram[(size_t)j0 * B + e];
            }
          }
          float* R_s = r_of(h);
          float* AD_s = ad_of(h);
          float acc[4][2];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) acc[a][jj] = 0.f;
          float* XS = ST;
          float* FS = ST + NC * B;
          for (int n0 = 0; n0 < n; n0 += NC) {
            bar_sync(BAR_P, NP);
            for (int e = tid; e < NC * B / 4; e += NP) {
              const int rr = e / (B / 4), c4 = (e % (B / 4)) * 4;
              const int nn = n0 + rr;
              *reinterpret_cast<float4*>(XS + rr * B + c4) =
                  nn < n ? ld4(x + (size_t)nn * p + j0 + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            for (int e = tid; e < NC * HQ / 4; e += NP) {
              const int rr = e / (HQ / 4), c4 = (e % (HQ / 4)) * 4;
              const int nn = n0 + rr;
              *reinterpret_cast<float4*>(FS + rr * HQ + c4) =
                  (nn < n && kh + c4 < q) ? ld4(fitted + (size_t)nn * q + kh + c4)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            bar_sync(BAR_P, NP);
            if (trow) {
#pragma unroll 8
              for (int kk = 0; kk < NC; ++kk) {
                const float4 av = ld4(XS + kk * B + ty * 4);
                const float2 fv = ld2(FS + kk * HQ + tx * 2);
                const float a4[4] = {av.x, av.y, av.z, av.w};
                const float f2[2] = {fv.x, fv.y};
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                  for (int jj = 0; jj < 2; ++jj) acc[a][jj] = fmaf(a4[a], f2[jj], acc[a][jj]);
              }
            }
          }
          if (trow) {
            float dot[4][2];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) dot[a][jj] = 0.f;
            for (int rr = 0; rr < R; ++rr) {
              const float2 nv = ld2(N_s + rr * QS + h * HQ + tx * 2);
              const float n2[2] = {nv.x, nv.y};
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                const float l = l_aug[(size_t)(j0 + ty * 4 + a) * R + rr];
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) dot[a][jj] = fmaf(l, n2[jj], dot[a][jj]);
              }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int i = ty * 4 + a;
              const float d = Gw[tri(i) + i];
              const float th = theta[j0 + i];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int kk = tx * 2 + jj;
                const float bo = kh + kk < q ? beta_in[(size_t)(j0 + i) * q + kh + kk] : 0.f;
                R_s[i * HQ + kk] = fmaf(-bo, d, acc[a][jj]);
                AD_s[i * HQ + kk] =
                    __fadd_rn(logit_base(th + zeta2[h][jj], c, c_one), dot[a][jj]);
              }
            }
          }
          bar_arrive(BAR_READY + h, NT);
        }
      }
    }

    // ---- per-column outputs (B1's fixed-order reduction over row groups) ----
    bar_sync(0, NT);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) ST[ty * QS + h * HQ + tx * 2 + jj] = zc[h][jj];
    bar_sync(0, NT);
    if (tid < QS && k0 + tid < q) {
      float s = 0.f;
      for (int g = 0; g < NP / 8; ++g) s += ST[g * QS + tid];
      z_col[k0 + tid] = s;
    }
  }
}

}  // namespace

extern "C" {

// Launches one staggered sweep (the sweep kernel, then the z_row reduction)
// on `stream`; arguments as atlasqtl_sweep_fused, whose slice width `qs`
// must be this kernel's only one, 32.  Returns the CUDA error code of the
// launches (0 on success).
int atlasqtl_sweep_staggered(const float* x, const float* cp,
                             const float* gram, const float* l_aug,
                             const float* n_stack, const float* beta_in,
                             float* fitted, const float* theta,
                             const float* p_mask, const float* zeta,
                             const float* q_mask, const float* s2v,
                             const float* tauv, const float* scal,
                             float* beta_out, float* gam_out, float* mu_out,
                             float* zrow_part, float* z_row, float* z_col,
                             float* gcol, float* m2gcol, float* b2col, int n,
                             int p, int q, int B, int R, int c_one,
                             int qs, void* stream) {
  if (qs != QS || B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || R <= 0 || R > RMAX ||
      q % 4 != 0 || n <= 0 || (gam_out == nullptr) != (mu_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, R);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_staggered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_staggered_kernel<<<n_slices, NT, smem, st>>>(
      x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, p_mask, zeta,
      q_mask, s2v, tauv, scal, beta_out, gam_out, mu_out, zrow_part, z_col,
      gcol, m2gcol, b2col, n, p, q, B, R, c_one);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<(p + 255) / 256, 256, 0, st>>>(zrow_part, z_row,
                                                       n_slices, p);
  return (int)cudaGetLastError();
}

// CTAs of the staggered kernel resident on one SM at block B and
// interpolation width R (the occupancy calculator), -1 on error.
int atlasqtl_sweep_staggered_occupancy(int B, int R) {
  const int smem = (int)smem_bytes(B, R);
  int nb = -1;
  if (cudaFuncSetAttribute(sweep_staggered_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, sweep_staggered_kernel, NT, smem) != cudaSuccess)
    return -1;
  return nb;
}

}  // extern "C"
