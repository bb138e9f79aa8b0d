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
// Design:
//  - one CTA of 8 QS threads owns QS response columns (a slice) and walks
//    every predictor block in order.  Two widths are built, QS = 32 and 40;
//    the launch plan (ops/sweep_fused.py:fused_launch_plan) takes the one
//    whose slices fill whole waves best: one CTA per SM (its registers and
//    shared memory are sized for one), so at q = 10000 on 132 SMs 32-column
//    slices take 3 waves, the last one 37% full, and 40-column slices 2.  The
//    columns are independent given theta/zeta, so CTAs never communicate; F
//    stays in device memory and each CTA updates its own columns in place;
//  - one pass over the samples per block: chunk by chunk of NCH rows, the F
//    chunk is advanced by the previous block (F += x_{b-1} delta_{b-1}),
//    written back, and projected on this block (r0 += x_b^T F).  The first
//    block only projects; a last pass only advances.  The F chunk and both
//    x chunks are staged by cp.async one chunk ahead of use, and each
//    chunk is projected in the step after its advance, beside the next
//    chunk's advance (three stages of F and of x_b, two of x_{b-1});
//  - shared memory, not the FMA pipes, is what a SIMT product runs out of
//    first: a 16-byte load costs a warp four shared-memory cycles whatever
//    it broadcasts, against four FMA instructions a cycle.  So the
//    projection takes 8 x 8 register tiles (four 16-byte loads per 64 FMAs:
//    the two balance) in four groups of 2 QS threads, one per quarter of
//    each chunk's rows, their sums added in a fixed order after the pass;
//    the advance, whose output per chunk is only NCH x QS, takes 4 x 4 tiles
//    in four groups, one per quarter of the block's depth, the four partial
//    advances added in a fixed order through shared memory by all threads;
//  - the block's lower Gram triangle is kept packed, B (B + 1) / 2 floats,
//    loaded by cp.async during the pass;
//  - the logit-constant tile of the block (before the chain) and its Z tile
//    (after it) are 4 x 4 register-tiled products over all threads, in the
//    pass stages, which are idle between passes; the block's rows of L,
//    p_mask and theta are staged in shared memory too, so that no serial
//    step waits on device memory;
//  - the strictly sequential update of the B coordinates (k-major, j
//    ascending) runs in windows of W = 8 rows on the first QS threads, one
//    per column, with the window's residuals in registers.  Meanwhile the
//    other warps correct the next window's rows by every delta two or more
//    windows back and stage the cp and pre-sweep beta rows of the window
//    after it by cp.async (device memory's latency exceeds a window), so
//    each window ends at one barrier; the chain adds the previous window's
//    corrections itself;
//  - the per-element formulas are common.cuh's, every rounding written out;
//  - column statistics accumulate in the chain threads' registers, z_col in
//    each thread's and then over row groups in order; z_row goes to a
//    (n_slices, p) partial buffer reduced by the second kernel.  No
//    atomics: results are the same from run to run;
//  - annealing replicas (several states swept at one temperature) are a
//    second grid axis: blockIdx.y picks the replica, whose state operands
//    and outputs are its slices of stacked arrays (x, the Gram blocks and
//    the masks are shared).  The per-CTA code is unchanged, so each
//    replica's outputs are those of its own launch in slices of the same
//    width bit for bit; m replicas put m times the CTAs on the card in one
//    launch.
#include "common.cuh"

namespace {

constexpr int W = 8;          // chain window (rows)
constexpr int BMAX = 128;     // largest predictor block
constexpr int RMAX = 48;      // largest interpolation width (r + 2)
constexpr int NCH = 32;       // sample rows per pass chunk
constexpr int NSTAGE = 3;     // F and x_b stages (advanced, projected, landing)
constexpr int NXA = 2;        // x_{b-1} stages (advanced, landing)
constexpr int NG = 4;         // thread groups of the two products
constexpr int NRW = 3;        // window buffers of cp and beta rows (two ahead)
constexpr int SMEM_MAX = 232448;  // shared memory one CTA may take

// the thread layout of a QS-column slice: eight threads per column
template <int QS>
struct Slice {
  static constexpr int NT = 8 * QS;           // threads per CTA
  static constexpr int NW = NT / 32;          // warps
  static constexpr int NCW = (QS + 31) / 32;  // warps that hold the chain
  static constexpr int TC = QS / 4;           // 4-column groups of a row
  static constexpr int PC = QS / 8;           // 8-column groups of a row
  static constexpr int WQ = W * QS;           // one window tile
  static_assert(QS % 8 == 0 && NT == NG * 2 * QS && NCH == NG * 8 &&
                    NT / TC == NCH && BMAX == 16 * 8,
                "tiles: projection 16 x PC threads of 8 x 8 per group, "
                "advance 8 x TC threads of 4 x 4 per group, logit and Z "
                "tiles 32 x TC threads of 4 x 4");
};

constexpr int NCLK = 5;       // phase clock slots of the probe thread

// clock64() cycles of CTA 0's thread 0 (which runs the chain) per phase of
// the latest launch, summed over the blocks: the passes, the projection
// sums and logit tiles, the chain windows, the Z tiles, the whole kernel
// (atlasqtl_sweep_fused_clocks; chip_smoke.py's kernel phase prints them
// beside the eQTL-cut timing)
__device__ long long g_clocks[NCLK];

__host__ __device__ constexpr int xld(int B) { return B + 4; }  // x row
__host__ __device__ constexpr int gp_floats(int B) {  // packed triangle
  return (B * (B + 1) / 2 + 3) & ~3;
}
// the pass stages and the advance partials after them: between passes they
// hold the projection partials, the logit-constant tile and the rows of L
template <int QS>
__host__ __device__ constexpr int pass_floats(int B) {
  return NSTAGE * NCH * QS + (NSTAGE + NXA) * NCH * xld(B) + NG * NCH * QS;
}

// the packed Gram triangle, two B x QS tiles (deltas, projections), the
// pass stages and advance partials, three window tiles (corrections twice,
// cp and pre-sweep beta NRW times), the nodes, the block's p_mask and
// theta, the slice's zeta and q_mask
template <int QS>
size_t smem_bytes(int B, int R) {
  return sizeof(float) * ((size_t)gp_floats(B) + 2 * B * QS +
                          pass_floats<QS>(B) + (2 + 2 * NRW) * W * QS +
                          3 * R * QS + 2 * BMAX + 2 * QS);
}

// the between-pass tiles (three projection partials, the logit-constant
// tile, the rows of L) fit where the pass stages were
template <int QS>
bool overlay_fits(int B, int R) {
  return 4 * B * QS + B * R <= pass_floats<QS>(B);
}

// element (i, m), m <= i, of the packed lower triangle
__device__ __forceinline__ float gp(const float* g, int i, int m) {
  return g[i * (i + 1) / 2 + m];
}

__device__ __forceinline__ void unpack4(const float4 v, float* a) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

template <int QS>
__global__ void __launch_bounds__(Slice<QS>::NT, 1) sweep_fused_kernel(
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
    int n, int p, int q, int B, int R, int c_one, int cp_batched) {
  using S = Slice<QS>;
  // blockIdx.y is the replica: every operand of the state (and X^T Y where
  // cp_batched) and every output is one replica's slice of a stacked array
  {
    const size_t r = blockIdx.y, pq = (size_t)p * q;
    if (cp_batched) cp += r * pq;
    beta_in += r * pq;
    fitted += r * (size_t)n * q;
    l_aug += r * (size_t)p * R;
    n_stack += r * 3 * (size_t)R * q;
    theta += r * p;
    zeta += r * q;
    s2v += r * q;
    tauv += r * q;
    scal += r * 2;
    beta_out += r * pq;
    if (gam_out != nullptr) {
      gam_out += r * pq;
      mu_out += r * pq;
    }
    zrow_part += r * gridDim.x * (size_t)p;
    z_col += r * q;
    gcol += r * q;
    m2gcol += r * q;
    b2col += r * q;
  }
  constexpr int NT = S::NT, NW = S::NW, TC = S::TC, WQ = S::WQ;
  constexpr int H0 = S::NCW * 32;  // the first thread of the helper warps
  extern __shared__ __align__(16) float smem[];
  const int XL = xld(B), BQ = B * QS;
  float* GP_s = smem;                         // packed lower Gram triangle
  float* D_s = GP_s + gp_floats(B);           // B x QS deltas
  float* R_s = D_s + BQ;                      // B x QS projections
  float* F_s = R_s + BQ;                      // NSTAGE x NCH x QS F chunks
  float* XB_s = F_s + NSTAGE * NCH * QS;      // NSTAGE x NCH x XL x_b chunks
  float* XA_s = XB_s + NSTAGE * NCH * XL;     // NXA x NCH x XL x_{b-1}
  float* AP_s = XA_s + NXA * NCH * XL;        // NG x NCH x QS advance
  float* C_s = AP_s + NG * NCH * QS;          // 2 x W x QS corrections
  float* CPW_s = C_s + 2 * WQ;                // NRW x W x QS X^T Y rows
  float* BOW_s = CPW_s + NRW * WQ;            // NRW x W x QS pre-sweep beta
  float* N_s = BOW_s + NRW * WQ;              // 3 x R x QS node values
  float* PM_s = N_s + 3 * R * QS;             // the block's p_mask
  float* TH_s = PM_s + BMAX;                  // the block's theta
  float* ZQ_s = TH_s + BMAX;                  // the slice's zeta, q_mask
  // between passes the stages hold the (NG-1) projection partials, then
  // the new-gam tile in their place, the logit-constant tile (after the
  // chain: the z_row partials) and the rows of L of the block
  float* PP_s = F_s;
  float* GT_s = F_s;
  float* AD_s = F_s + (NG - 1) * BQ;
  float* ZR_s = AD_s;
  float* L_s = AD_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int k0 = blockIdx.x * QS;
  const float c = scal[0], kz = scal[1];
  const int nb = p / B, nwin = B / W;
  // the probe thread adds its cycles straight into g_clocks, so that no
  // other thread holds registers for them
  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;
  long long clk = 0;
  if (probe) {
    clk = clock64();
    for (int e = 0; e < NCLK - 1; ++e) g_clocks[e] = 0;
    g_clocks[NCLK - 1] = -clk;
  }
  auto tick = [&](int slot) {  // the probe's cycles since the last tick
    if (probe) {
      const long long t = clock64();
      g_clocks[slot] += t - clk;
      clk = t;
    }
  };
  const int nch = (n + NCH - 1) / NCH;

  for (int e = tid; e < 3 * R * QS; e += NT) {
    const int kk = e % QS, mr = e / QS;
    N_s[e] = (k0 + kk < q) ? n_stack[(size_t)mr * q + k0 + kk] : 0.f;
  }
  for (int e = tid; e < 2 * QS; e += NT) {
    const int k = k0 + e % QS;
    ZQ_s[e] = k < q ? (e < QS ? zeta : q_mask)[k] : 0.f;
  }
  // the chain thread's column (threads 0 .. QS-1)
  const bool chain = tid < QS;
  const int kc = k0 + tid;
  const bool cvalid = chain && kc < q;
  float ct = 0.f, cinv = 0.f, qmc = 0.f;
  if (cvalid) {
    const float s2 = s2v[kc];
    ct = c * s2 * tauv[kc];
    cinv = c * 0.5f / s2;
    qmc = q_mask[kc];
  }
  float gacc = 0.f, m2acc = 0.f, b2acc = 0.f;
  // the 4 x 4 tiles of the logit and Z tiles: rows ty*4.., columns tx*4..
  const int tx = tid % TC, ty = tid / TC;
  const bool trow = ty * 4 < B;
  float zc4[4] = {0.f, 0.f, 0.f, 0.f};
  // the products' groups of 2 QS threads: the projection's chunk rows
  // g*8.., block rows pi*8.., columns pc..; the advance's depth
  // quarter g (k = 4 (g + 4 m) ..), chunk rows ar*4.., columns ac..
  const int g = tid / (2 * QS), gi = tid % (2 * QS);
  const int pi = gi / S::PC, pc = (gi % S::PC) * 8;
  const bool prow = pi * 8 < B;
  const int ar = gi / TC, ac = (gi % TC) * 4;

  // cp and pre-sweep beta rows j .. j + W of this slice, by threads
  // t0 .. t0 + NT/2 - 1, into window buffer `buf` (missing columns zeroed)
  auto stage_rows = [&](int j, int buf, int t0) {
    const int e = tid - t0;
    if (e < 0 || e >= 2 * W * TC) return;
    const int a = e / (W * TC), i = (e / TC) % W;
    const int kk = (e % TC) * 4;
    const bool ok = k0 + kk < q;
    const float* src = (a == 0 ? cp : beta_in) + (size_t)(j + i) * q + k0 + kk;
    cp_async16_zfill((a == 0 ? CPW_s : BOW_s) + buf * WQ + i * QS + kk,
                     ok ? src : cp, ok);
  };

  for (int b = 0; b <= nb; ++b) {
    const bool adv = b > 0, proj = b < nb;
    const int j0 = b * B;  // the projected block's first predictor

    // ---- one pass over the samples: advance by block b-1, project b -------
    auto stage = [&](int ch) {
      float* fst = F_s + (ch % NSTAGE) * NCH * QS;
      float* xbst = XB_s + (ch % NSTAGE) * NCH * XL;
      float* xast = XA_s + (ch % NXA) * NCH * XL;
      const int n0 = ch * NCH;
      for (int e = tid; e < NCH * TC; e += NT) {
        const int r = e / TC, c4 = (e % TC) * 4;
        const bool ok = n0 + r < n && k0 + c4 < q;
        cp_async16_zfill(fst + r * QS + c4,
                         ok ? fitted + (size_t)(n0 + r) * q + k0 + c4 : fitted,
                         ok);
      }
      for (int e = tid; e < NCH * B / 4; e += NT) {
        const int r = e / (B / 4), c4 = (e % (B / 4)) * 4;
        const bool ok = n0 + r < n;
        const float* row = x + (size_t)(ok ? n0 + r : 0) * p + c4;
        if (adv) cp_async16_zfill(xast + r * XL + c4, row + j0 - B, ok);
        if (proj) cp_async16_zfill(xbst + r * XL + c4, row + j0, ok);
      }
    };
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[a][jj] = 0.f;
    if (proj) {  // the block's lower Gram triangle, packed; p_mask, theta
      for (int i = warp; i < B; i += NW)
        for (int m = tid & 31; m <= i; m += 32)
          cp_async4(GP_s + i * (i + 1) / 2 + m, gram + (size_t)(j0 + i) * B + m);
      for (int e = tid; e < B / 2; e += NT)
        cp_async16(e < B / 4 ? PM_s + 4 * e : TH_s + 4 * (e - B / 4),
                   (e < B / 4 ? p_mask + 4 * e : theta + 4 * (e - B / 4)) + j0);
    }
    stage(0);
    cp_async_commit();
    // chunk ch is advanced in step ch and projected in step ch + 1, so each
    // step ends at one barrier besides the one that hands over the
    // advance's partial sums
    const int last = proj ? nch : nch - 1;
    for (int ch = 0; ch <= last; ++ch) {
      cp_async_wait<0>();  // chunk ch has landed (this thread's)
      __syncthreads();     // ... everyone's; chunk ch-1 is advanced, ch-2
                           // projected, so the stages of ch+1 are free
      if (ch + 1 < nch) stage(ch + 1);
      cp_async_commit();
      float* fs = F_s + (ch % NSTAGE) * NCH * QS;
      const float* xa = XA_s + (ch % NXA) * NCH * XL;
      const bool adv_ch = adv && ch < nch;
      if (adv_ch) {  // this quarter of the depth's part of F += x_{b-1} delta
        float a4[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) a4[r][jj] = 0.f;
        for (int k4 = g; k4 < B / 4; k4 += NG) {
          const int kk = 4 * k4;
          float xr[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            unpack4(ld4(xa + (ar * 4 + r) * XL + kk), xr[r]);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float d[4];
            unpack4(ld4(D_s + (kk + s) * QS + ac), d);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                a4[r][jj] = fmaf(xr[r][s], d[jj], a4[r][jj]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(AP_s + g * NCH * QS + (ar * 4 + r) * QS +
                                     ac) =
              make_float4(a4[r][0], a4[r][1], a4[r][2], a4[r][3]);
      }
      if (proj && prow && ch > 0) {  // r0 += x_b^T F over chunk ch-1
        const float* fp = F_s + ((ch - 1) % NSTAGE) * NCH * QS;
        const float* xp = XB_s + ((ch - 1) % NSTAGE) * NCH * XL;
#pragma unroll(QS == 32 ? 2 : 1)
        for (int r = g * 8; r < g * 8 + 8; ++r) {
          float xv[8], fv[8];
          unpack4(ld4(xp + r * XL + pi * 8), xv);
          unpack4(ld4(xp + r * XL + pi * 8 + 4), xv + 4);
          unpack4(ld4(fp + r * QS + pc), fv);
          unpack4(ld4(fp + r * QS + pc + 4), fv + 4);
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              acc[a][jj] = fmaf(xv[a], fv[jj], acc[a][jj]);
        }
      }
      if (adv_ch) {
        __syncthreads();
        // F + the four quarters, in order: four columns of one row each
        const int row = tid / TC, c4 = (tid % TC) * 4;
        float f[4], t[4];
        unpack4(ld4(fs + row * QS + c4), f);
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          unpack4(ld4(AP_s + h * NCH * QS + row * QS + c4), t);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) f[jj] = __fadd_rn(f[jj], t[jj]);
        }
        const float4 v = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(fs + row * QS + c4) = v;
        const int nr = ch * NCH + row;
        if (nr < n && k0 + c4 < q)
          *reinterpret_cast<float4*>(fitted + (size_t)nr * q + k0 + c4) = v;
      }
    }
    cp_async_wait<0>();  // the Gram triangle has landed (this thread's)
    if (!proj) break;
    __syncthreads();  // every chunk is consumed: the stages are free

    tick(0);

    // ---- r0 = x_b^T F: the four groups' sums in order ---------------------
    for (int e = tid; e < B * R / 4; e += NT)  // the block's rows of L
      cp_async16(L_s + 4 * e, l_aug + (size_t)j0 * R + 4 * e);
    stage_rows(j0, 0, 0);  // window 0's cp and beta rows, threads 0..NT/2-1
    cp_async_commit();
    if (nwin > 1) stage_rows(j0 + W, 1, NT / 2);  // window 1's, the others
    cp_async_commit();
    if (g > 0 && prow)
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(PP_s + (g - 1) * BQ +
                                     (pi * 8 + a) * QS + pc + 4 * h) =
              make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                          acc[a][4 * h + 3]);
    cp_async_wait<1>();  // L and window 0's rows (window 1's may fly on)
    __syncthreads();
    // the logit-constant tile ad = base + L_b N_ad (4 x 4 per thread)
    if (trow) {
      float dot[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[a][jj] = 0.f;
      const float* l0 = L_s + ty * 4 * R;
#pragma unroll 2
      for (int rr = 0; rr < R; ++rr) {
        float nv[4];
        unpack4(ld4(N_s + rr * QS + tx * 4), nv);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float l = l0[a * R + rr];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dot[a][jj] = fmaf(l, nv[jj], dot[a][jj]);
        }
      }
      float zeta4[4];
      unpack4(ld4(ZQ_s + tx * 4), zeta4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        const float th = TH_s[i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          AD_s[i * QS + tx * 4 + jj] =
              __fadd_rn(logit_base(th + zeta4[jj], c, c_one), dot[a][jj]);
      }
    }
    if (g == 0 && prow)
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int e = (pi * 8 + a) * QS + pc + jj;
          float r = acc[a][jj];
#pragma unroll
          for (int h = 0; h < NG - 1; ++h) r = __fadd_rn(r, PP_s[h * BQ + e]);
          R_s[e] = r;
        }
    __syncthreads();  // R_s is whole: the partials' room takes the gam tile

    tick(1);

    // ---- the sequential chain, windows of W rows --------------------------
    float dprev[W];  // chain thread: the previous window's deltas
#pragma unroll
    for (int i = 0; i < W; ++i) dprev[i] = 0.f;
    for (int w = 0; w < nwin; ++w) {
      const int lo = w * W, cur = w & 1, nxt = cur ^ 1, rw = w % NRW;
      if (chain) {
        float rr[W], pm[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int row = lo + i;
          pm[i] = PM_s[row];
          // remove the own contribution with the TRUE Gram diagonal
          float r = fmaf(-BOW_s[rw * WQ + i * QS + tid], gp(GP_s, row, row),
                         R_s[row * QS + tid]);
          if (w > 0) {
            r = __fadd_rn(r, C_s[cur * WQ + i * QS + tid]);
#pragma unroll
            for (int m = 0; m < W; ++m)
              r = fmaf(gp(GP_s, row, lo - W + m), dprev[m], r);
          }
          rr[i] = r;
        }
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int row = lo + i, j = j0 + row;
          const int e = rw * WQ + i * QS + tid;
          const ChainStep st = chain_step(ct, CPW_s[e], rr[i],
                                          AD_s[row * QS + tid], cinv,
                                          BOW_s[e]);
          D_s[row * QS + tid] = st.delta;
          GT_s[row * QS + tid] = st.gam;
          dprev[i] = st.delta;
#pragma unroll
          for (int a = i + 1; a < W; ++a)
            rr[a] = fmaf(gp(GP_s, lo + a, row), st.delta, rr[a]);
          if (cvalid) {
            const float msk = __fmul_rn(pm[i], qmc);
            const size_t off = (size_t)j * q + kc;
            beta_out[off] = __fmul_rn(st.bnew, msk);
            if (gam_out != nullptr) {
              gam_out[off] = __fmul_rn(st.gam, msk);
              mu_out[off] = __fmul_rn(st.mu, msk);
            }
          }
          gacc = fmaf(pm[i], st.gam, gacc);
          m2acc = fmaf(pm[i], __fmul_rn(st.bnew, st.mu), m2acc);
          b2acc = fmaf(pm[i], __fmul_rn(st.bnew, st.bnew), b2acc);
        }
      } else if (warp >= S::NCW && w + 1 < nwin) {
        // meanwhile: the cp/beta rows two windows ahead, and the next
        // window's corrections by every delta two or more windows back
        if (w + 2 < nwin) stage_rows(j0 + lo + 2 * W, (w + 2) % NRW, H0);
        cp_async_commit();
        for (int e = tid - H0; e < WQ; e += NT - H0) {
          const int t = e / QS, col = e % QS;
          const float* gr = GP_s + (lo + W + t) * (lo + W + t + 1) / 2;
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
          for (int m = 0; m < lo; m += 4) {
            s0 = fmaf(gr[m], D_s[m * QS + col], s0);
            s1 = fmaf(gr[m + 1], D_s[(m + 1) * QS + col], s1);
            s2 = fmaf(gr[m + 2], D_s[(m + 2) * QS + col], s2);
            s3 = fmaf(gr[m + 3], D_s[(m + 3) * QS + col], s3);
          }
          C_s[nxt * WQ + e] = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
        }
        cp_async_wait<1>();  // the next window's rows have landed
      }
      __syncthreads();
    }

    tick(2);

    // ---- Z moments: z = gam * imrd + imr0u, masked row/column sums --------
    {
      float d1[4][4], d2[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) d1[a][jj] = d2[a][jj] = 0.f;
      if (trow) {
        const float* l0 = L_s + ty * 4 * R;
#pragma unroll 2
        for (int rr = 0; rr < R; ++rr) {
          float n1[4], n2[4];
          unpack4(ld4(N_s + (R + rr) * QS + tx * 4), n1);
          unpack4(ld4(N_s + (2 * R + rr) * QS + tx * 4), n2);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float l = l0[a * R + rr];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              d1[a][jj] = fmaf(l, n1[jj], d1[a][jj]);
              d2[a][jj] = fmaf(l, n2[jj], d2[a][jj]);
            }
          }
        }
        float zeta4[4], qm4[4];
        unpack4(ld4(ZQ_s + tx * 4), zeta4);
        unpack4(ld4(ZQ_s + QS + tx * 4), qm4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty * 4 + a;
          const float th = TH_s[i], pm = PM_s[i];
          float zr = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float zq = z_cell(th + zeta4[jj], GT_s[i * QS + tx * 4 + jj],
                                    d1[a][jj], d2[a][jj], qm4[jj], kz, c_one);
            zr = __fadd_rn(zr, zq);
            zc4[jj] = fmaf(pm, zq, zc4[jj]);
          }
          ZR_s[i * TC + tx] = zr;
        }
      }
      __syncthreads();
      if (tid < B) {  // each row's TC partial sums, in column order
        float zr = 0.f;
        for (int t = 0; t < TC; ++t) zr = __fadd_rn(zr, ZR_s[tid * TC + t]);
        zrow_part[(size_t)blockIdx.x * p + j0 + tid] = __fmul_rn(PM_s[tid], zr);
      }
    }
    __syncthreads();  // the stages are free for the next pass
    tick(3);
  }

  // ---- per-column outputs (fixed-order reduction over the row groups) -----
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) F_s[ty * QS + tx * 4 + jj] = zc4[jj];
  __syncthreads();
  if (tid < QS && k0 + tid < q) {
    float s = 0.f;
    for (int h = 0; h < NT / TC; ++h) s += F_s[h * QS + tid];
    z_col[k0 + tid] = s;
  }
  if (cvalid) {
    gcol[kc] = gacc * qmc;
    m2gcol[kc] = m2acc * qmc;
    b2col[kc] = b2acc * qmc;
  }
  if (probe) g_clocks[NCLK - 1] += clock64();
}

// the shared-memory bytes of a QS-column launch at (B, R), or 0 where the
// kernel cannot take them
template <int QS>
size_t checked_smem(int B, int R) {
  const size_t smem = smem_bytes<QS>(B, R);
  return smem <= SMEM_MAX && overlay_fits<QS>(B, R) ? smem : 0;
}

template <int QS>
int launch(const float* x, const float* cp, const float* gram,
           const float* l_aug, const float* n_stack, const float* beta_in,
           float* fitted, const float* theta, const float* p_mask,
           const float* zeta, const float* q_mask, const float* s2v,
           const float* tauv, const float* scal, float* beta_out,
           float* gam_out, float* mu_out, float* zrow_part, float* z_row,
           float* z_col, float* gcol, float* m2gcol, float* b2col, int n,
           int p, int q, int B, int R, int c_one, int m, int cp_batched,
           cudaStream_t st) {
  const size_t smem = checked_smem<QS>(B, R);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(sweep_fused_kernel<QS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  sweep_fused_kernel<QS><<<dim3(n_slices, m), Slice<QS>::NT, smem, st>>>(
      x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, p_mask, zeta,
      q_mask, s2v, tauv, scal, beta_out, gam_out, mu_out, zrow_part, z_col,
      gcol, m2gcol, b2col, n, p, q, B, R, c_one, cp_batched);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<dim3((p + 255) / 256, m), 256, 0, st>>>(
      zrow_part, z_row, n_slices, p);
  return (int)cudaGetLastError();
}

template <int QS>
int occupancy(int B, int R) {
  const size_t smem = checked_smem<QS>(B, R);
  int nb = -1;
  if (smem == 0 ||
      cudaFuncSetAttribute(sweep_fused_kernel<QS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, sweep_fused_kernel<QS>, Slice<QS>::NT, smem) != cudaSuccess)
    return -1;
  return nb;
}

}  // namespace

extern "C" {

// Launches the sweeps of m replicas (the sweep kernel on a grid of slices x
// m, then the z_row reduction) on `stream` in slices of `qs` columns, 32 or
// 40: the width that ops/sweep_fused.py:fused_launch_plan picks; the kernel
// sizes the rest of its launch.  The operands of the state and the outputs
// are m stacked arrays (X^T Y too where cp_batched; x, the Gram blocks and
// the masks are shared); zrow_part holds m x ceil(q / qs) rows of p.
// Returns the CUDA error code of the launches (0 on success);
// cudaErrorInvalidValue for a shape or width it does not take.
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
                         int c_one, int qs, int m, int cp_batched,
                         void* stream) {
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || R <= 0 || R > RMAX ||
      q % 4 != 0 || n <= 0 || (gam_out == nullptr) != (mu_out == nullptr) ||
      m < 1 || m > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qs == 32)
    return launch<32>(x, cp, gram, l_aug, n_stack, beta_in, fitted, theta,
                      p_mask, zeta, q_mask, s2v, tauv, scal, beta_out,
                      gam_out, mu_out, zrow_part, z_row, z_col, gcol, m2gcol,
                      b2col, n, p, q, B, R, c_one, m, cp_batched, st);
  if (qs == 40)
    return launch<40>(x, cp, gram, l_aug, n_stack, beta_in, fitted, theta,
                      p_mask, zeta, q_mask, s2v, tauv, scal, beta_out,
                      gam_out, mu_out, zrow_part, z_row, z_col, gcol, m2gcol,
                      b2col, n, p, q, B, R, c_one, m, cp_batched, st);
  return (int)cudaErrorInvalidValue;
}

// The shared-memory bytes of a launch in `qs`-column slices at block B and
// interpolation width R; -1 for a width or shape the kernel does not take
// (the card checks ops/sweep_fused.py:_fused_smem_bytes against it).
long long atlasqtl_sweep_fused_smem(int qs, int B, int R) {
  const size_t smem = qs == 32 ? checked_smem<32>(B, R)
                      : qs == 40 ? checked_smem<40>(B, R)
                                 : 0;
  return smem == 0 ? -1 : (long long)smem;
}

// Copies the probe's NCLK phase clocks of the latest launch to `out`
// (host memory); returns the CUDA error code.
int atlasqtl_sweep_fused_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * NCLK);
}

// CTAs of the sweep kernel in `qs`-column slices resident on one SM at
// block B and interpolation width R (the occupancy calculator), -1 on error.
int atlasqtl_sweep_fused_occupancy(int qs, int B, int R) {
  return qs == 32 ? occupancy<32>(B, R) : qs == 40 ? occupancy<40>(B, R) : -1;
}

const char* atlasqtl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
