// The staggered complete-data sweep: B1's function (csrc/sweep_fused.cu) with
// each CTA's response columns split into two halves, half B lagging half A
// by half a step, so that the sequential chain of one half runs while the
// other half's pass over the samples runs.  One CUDA kernel for Hopper
// (sm_90a), plus the z_row reduction of csrc/common.cuh.
//
// Replaces the TPU kernel atlasqtl_tpu/ops/sweep_staggered.py:_stag_kernel.
// Same function as B1, with B1's deliberate difference from the TPU kernels:
// each coordinate's Gram diagonal is the true x_j^T x_j, not n_pad - 1.
//
// What bounds it on an H100: as B1, the two products r0 = x_b^T F and
// F += x_b delta, 4 n p q FP32 operations per sweep (no TF32: the
// reference's products are full f32); the bytes it must move take under a
// tenth of that time at 3.35 TB/s.  In B1 the chain windows take ~14% of a
// CTA's cycles while the product threads wait; here they overlap.
//
// Design (B1's one-pass structure, with the stagger added):
//  - one CTA of 384 threads per slice of QS = 32 or 40 response columns
//    (ops/sweep_staggered.py:staggered_launch_plan picks the width by B1's
//    waves x width rule: 40 at q = 10000, 250 CTAs in 2 waves), split into
//    halves A and B of H = QS / 2 columns.  Warps 0-3 are the chain role
//    (warp 0's first H lanes run the chain, warps 1-3 correct the next
//    window and stage its rows); warps 4-11 are the pass role.  384 threads
//    cap ptxas at 168 registers, as B1's 320 do (three warps share a
//    sub-partition either way);
//  - the schedule, for half h of block b:  pass_h advances F by block b-1
//    and projects it on block b, then the chain of half h runs block b
//    while the pass role runs the other half's pass:
//        chain role:  chain_A(b)               chain_B(b)
//        pass role:   pass_B(adv b-1, proj b)  pass_A(adv b, proj b+1)
//    The hand-offs are named barriers: the pass role arrives on READY_h when
//    a half's projections and logit tile are in shared memory, the chain
//    role on DONE_h when its deltas and gam are; each side waits (bar.sync)
//    on the other's.  Each role synchronises among itself on its own id;
//  - one fused pass per half per block, as in B1: chunk by chunk of 32
//    sample rows the F chunk (H columns) is advanced by the previous
//    block's deltas, written back, and projected on this block one step
//    later; F and both x chunks are staged by cp.async one chunk ahead.
//    There is one set of pass stages, used by half A's pass and half B's in
//    turn (F three stages of 32 x H; x of each block two stages of 32 x B);
//  - the projection takes 4 x (H / 2) register tiles (4 x 10 at 40
//    columns, 4 x 8 at 32: 14 or 12 floats loaded per 40 or 32 FMAs).  A
//    pair of pass warps covers the B x H output (one warp per half of the
//    block's rows; a 16-byte x load reads contiguous bytes across the
//    warp) over eight of each chunk's 32 rows, so four depth groups; their
//    sums meet after the pass in a fixed order (groups dg + 2, then
//    dg + 1, through thread-major buffers, conflict-free).  8 x 10 tiles,
//    one warp per depth group, needed 80 accumulators and spilled under
//    384 threads' 168 registers.  The advance, whose
//    output per chunk is only 32 x H, takes 4 x 4 tiles in 256 / QS groups,
//    one per slice of the block's depth, summed in order; a tile's four
//    rows are 8 apart, so that a warp's x loads hit distinct banks (rows
//    4 apart, as in B1, put them on two banks of the 132-float x rows);
//  - after a pass the stage area holds the partial sums and two blocks'
//    rows of L (the Z tile's, the logit tile's), loaded by cp.async while
//    the partials meet;
//  - the chain keeps B1's windows of W = 8 rows: the chain thread adds the
//    previous window's corrections itself, the helper warps correct the
//    next window by every delta two or more windows back and stage the cp
//    and beta rows two windows ahead; the block's lower Gram triangle sits
//    packed in shared memory (one buffer: the chain role loads the next
//    block's while it waits for half A's projections) with the block's
//    p_mask rows; the new gam is written over the half's projection tile
//    (each window reads its rows before it writes them), which the pass
//    role reads for the Z tile before it writes the next projections;
//  - per-element formulas are common.cuh's, every rounding written out;
//  - deterministic: no atomics.  z_row goes to a (2 n_slices, p) partial
//    buffer, a row per half, reduced in order by common.cuh's kernel;
//    z_col's partials per tile row in shared memory (not in registers,
//    of which 384 threads leave 168 each), summed over the rows in order;
//    column statistics in the chain thread's registers;
//  - a block over 128 rows arrives as its pieces (ops/sweep_fused.py:
//    sub_block), with their Gram pieces.
#include "common.cuh"

namespace {

constexpr int W = 8;          // chain window (rows)
constexpr int BMAX = 128;     // largest predictor block (piece)
constexpr int RMAX = 48;      // largest interpolation width (r + 2)
constexpr int NCH = 32;       // sample rows per pass chunk
constexpr int NF = 3;         // F chunk stages (projected, advanced, landing)
constexpr int NX = 2;         // stages of each x chunk (in use, landing)
constexpr int NRW = 3;        // window buffers of cp and beta rows per half
constexpr int NCR = 128;      // chain-role threads (warps 0-3)
constexpr int NP = 256;       // pass-role threads (warps 4-11)
constexpr int NT = NCR + NP;  // threads per CTA
constexpr int SMEM_MAX = 232448;  // shared memory one CTA may take

constexpr int BAR_P = 1;      // the pass role among itself
constexpr int BAR_CR = 2;     // the chain role among itself
constexpr int BAR_READY = 3;  // + half: its projections and logit tile ready
constexpr int BAR_DONE = 5;   // + half: its chain done

template <int QS>
struct Half {
  static constexpr int H = QS / 2;      // columns per half
  static constexpr int TW = H / 2;      // projection tile columns
  static constexpr int HC = H / 4;      // 4-column groups of a half row
  static constexpr int NGA = NP / QS;   // advance groups of 2 H threads
  static constexpr int WH = W * H;      // one window tile of a half
  static constexpr int PW = 32 * 4 * TW;  // one warp's thread-major tile
  static_assert(QS % 8 == 0 && H % 4 == 0 && NCH == 4 * 8 && NGA >= 1 &&
                    NCH / 4 * HC == H * 2 && 2 * PW == BMAX * H &&
                    BMAX == 2 * 16 * 4 && NP == 8 * 32,
                "tiles: advance 8 x HC threads of 4 x 4 per group, "
                "projection 16 x 2 threads of 4 x TW per warp, two warps "
                "per block, four depth groups of 8 chunk rows");
};

constexpr int NCLK = 7;  // phase clock slots of the two probe threads

// clock64() cycles of CTA 0's probes per phase of the latest launch, summed
// over the blocks: its chain thread (thread 0) waiting for a half's
// projections and the block's Gram (0) and running the chain (1); its first
// pass thread in the passes (2; of which waiting at the pass's barriers
// for the chunks to land and the other warps to finish: 5), in the partial
// sums and tiles (3), and waiting for a half's deltas (4); the whole
// kernel (6)
// (atlasqtl_sweep_staggered_clocks; chip_smoke.py's stag_kernel phase
// prints them)
__device__ long long g_clocks[NCLK];

__host__ __device__ constexpr int gp_floats(int B) {  // packed triangle
  return (B * (B + 1) / 2 + 3) & ~3;
}

// the stage area: the pass stages and advance partials during a pass, four
// warps' projection partials and two blocks' rows of L after it
template <int QS>
__host__ __device__ constexpr int stage_floats(int B, int R) {
  using S = Half<QS>;
  return NF * NCH * S::H + 2 * NX * NCH * (B + 4) + S::NGA * NCH * S::H >
                 4 * S::PW + 2 * B * R
             ? NF * NCH * S::H + 2 * NX * NCH * (B + 4) + S::NGA * NCH * S::H
             : 4 * S::PW + 2 * B * R;
}

// the packed Gram triangle; per half the projection (later gam), delta and
// logit tiles and the window tiles (corrections twice, cp and beta rows NRW
// times); the nodes; the block's p_mask; the slice's zeta and q_mask; the
// z_col partials of the tile rows; the stage area
template <int QS>
size_t smem_bytes(int B, int R) {
  using S = Half<QS>;
  return sizeof(float) *
         ((size_t)gp_floats(B) + 6 * B * S::H + 2 * (2 + 2 * NRW) * S::WH +
          3 * R * QS + BMAX + 2 * QS + BMAX / 4 * QS +
          stage_floats<QS>(B, R));
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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// signal a barrier without waiting; the writes before it are visible to the
// threads that wait on it
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int QS>
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
    float* __restrict__ zrow_part,      // (2 n_slices, p)
    float* __restrict__ z_col,          // (q,)
    float* __restrict__ gcol,           // (q,)
    float* __restrict__ m2gcol,         // (q,)
    float* __restrict__ b2col,          // (q,)
    int n, int p, int q, int B, int R, int c_one) {
  using S = Half<QS>;
  constexpr int H = S::H, TW = S::TW, HC = S::HC, NGA = S::NGA, WH = S::WH;
  constexpr int PW = S::PW, WT = (2 + 2 * NRW) * WH;
  extern __shared__ __align__(16) float smem[];
  const int XL = B + 4, BH = B * H, HB = B / 2;
  float* GP_s = smem;                     // packed lower Gram triangle
  float* HT_s = GP_s + gp_floats(B);      // per half: R (later gam), D, AD
  float* WT_s = HT_s + 6 * BH;            // per half: C x2, CPW, BOW x NRW
  float* N_s = WT_s + 2 * WT;             // 3 x R x QS node values
  float* PM_s = N_s + 3 * R * QS;         // the block's p_mask
  float* ZQ_s = PM_s + BMAX;              // the slice's zeta, q_mask
  float* ZC_s = ZQ_s + 2 * QS;            // z_col partials, tile row x QS
  float* ST_s = ZC_s + BMAX / 4 * QS;     // the stage area
  // during a pass
  float* F_s = ST_s;                      // NF x NCH x H F chunks
  float* XB_s = F_s + NF * NCH * H;       // NX x NCH x XL x chunks, projected
  float* XA_s = XB_s + NX * NCH * XL;     // NX x NCH x XL x chunks, advanced
  float* AP_s = XA_s + NX * NCH * XL;     // NGA x NCH x H advance partials
  // after a pass
  float* PB_s = ST_s;                     // 4 x PW projection partials
  float* LZ_s = ST_s + 4 * PW;            // rows of L of the Z tile's block
  float* LA_s = LZ_s + B * R;             // rows of L of the logit tile's

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * QS;
  const float c = scal[0], kz = scal[1];
  const int nb = p / B, nwin = B / W;
  const int nch = (n + NCH - 1) / NCH;

  // each probe adds its cycles straight into g_clocks
  const bool probe_c = blockIdx.x == 0 && tid == 0;
  const bool probe_p = blockIdx.x == 0 && tid == NCR;
  long long clk = 0;
  if (probe_c || probe_p) {
    clk = clock64();
    if (probe_c) {
      g_clocks[0] = g_clocks[1] = 0;
      g_clocks[NCLK - 1] = -clk;
    } else {
      g_clocks[2] = g_clocks[3] = g_clocks[4] = g_clocks[5] = 0;
    }
  }
  auto tick = [&](bool probe, int slot) {
    if (probe) {
      const long long t = clock64();
      g_clocks[slot] += t - clk;
      clk = t;
    }
  };

  for (int e = tid; e < 3 * R * QS; e += NT) {
    const int kk = e % QS, mr = e / QS;
    N_s[e] = (k0 + kk < q) ? n_stack[(size_t)mr * q + k0 + kk] : 0.f;
  }
  for (int e = tid; e < 2 * QS; e += NT) {
    const int k = k0 + e % QS;
    ZQ_s[e] = k < q ? (e < QS ? zeta : q_mask)[k] : 0.f;
  }
  for (int e = tid; e < BMAX / 4 * QS; e += NT) ZC_s[e] = 0.f;
  __syncthreads();

  if (tid < NCR) {
    // ============================ the chain role ===========================
    const bool chain = tid < H;
    // the chain thread's statistics of its column in each half
    float gacc[2] = {0.f, 0.f}, m2acc[2] = {0.f, 0.f}, b2acc[2] = {0.f, 0.f};
    float ct[2] = {0.f, 0.f}, cinv[2] = {0.f, 0.f}, qmc[2] = {0.f, 0.f};
    bool cvalid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kc = k0 + h * H + tid;
      cvalid[h] = chain && kc < q;
      if (cvalid[h]) {
        const float s2 = s2v[kc];
        ct[h] = c * s2 * tauv[kc];
        cinv[h] = c * 0.5f / s2;
        qmc[h] = q_mask[kc];
      }
    }
    // cp and pre-sweep beta rows j .. j + W of half h into its window
    // buffer `buf`, by chain-role threads t0 .. t0 + nthr - 1 (missing
    // columns zeroed)
    auto stage_rows = [&](int h, int j, int buf, int t0, int nthr) {
      float* cpw = WT_s + h * WT + 2 * WH;
      float* bow = cpw + NRW * WH;
      for (int e = tid - t0; e >= 0 && e < 2 * W * HC; e += nthr) {
        const int a = e / (W * HC), i = (e / HC) % W, kk = (e % HC) * 4;
        const int k = k0 + h * H + kk;
        const bool ok = k < q;
        const float* src = (a == 0 ? cp : beta_in) + (size_t)(j + i) * q + k;
        cp_async16_zfill((a == 0 ? cpw : bow) + buf * WH + i * H + kk,
                         ok ? src : cp, ok);
      }
    };

    for (int b = 0; b < nb; ++b) {
      const int j0 = b * B;
      // the block's Gram triangle and p_mask rows, both halves' first two
      // windows of rows: loaded while half A's projections are made
      for (int i = warp; i < B; i += NCR / 32)
        for (int m = lane; m <= i; m += 32)
          cp_async4(GP_s + i * (i + 1) / 2 + m,
                    gram + (size_t)(j0 + i) * B + m);
      for (int e = tid; e < B / 4; e += NCR)
        cp_async16(PM_s + 4 * e, p_mask + j0 + 4 * e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        stage_rows(h, j0, 0, 0, NCR);
        if (nwin > 1) stage_rows(h, j0 + W, 1, 0, NCR);
      }
      cp_async_commit();
      // one copy of the chain's code for both halves (not unrolled: the
      // instruction cache holds it beside the pass role's); the half's
      // column constants and statistics in scalars, updated in order
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const float cth = h ? ct[1] : ct[0], cinvh = h ? cinv[1] : cinv[0];
        const float qmh = h ? qmc[1] : qmc[0];
        const bool cvh = h ? cvalid[1] : cvalid[0];
        float g = h ? gacc[1] : gacc[0], m2 = h ? m2acc[1] : m2acc[0];
        float b2 = h ? b2acc[1] : b2acc[0];
        float* R_s = HT_s + 3 * h * BH;   // projections in, gam out
        float* D_s = R_s + BH;
        const float* AD_s = D_s + BH;
        float* C_s = WT_s + h * WT;
        const float* CPW_s = C_s + 2 * WH;
        const float* BOW_s = CPW_s + NRW * WH;
        tick(probe_c, 1);
        __syncwarp();
        bar_sync(BAR_READY + h, NT);
        cp_async_wait<0>();
        __syncwarp();
        bar_sync(BAR_CR, NCR);
        tick(probe_c, 0);

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
              float r = fmaf(-BOW_s[rw * WH + i * H + tid],
                             gp(GP_s, row, row), R_s[row * H + tid]);
              if (w > 0) {
                r = __fadd_rn(r, C_s[cur * WH + i * H + tid]);
#pragma unroll
                for (int m = 0; m < W; ++m)
                  r = fmaf(gp(GP_s, row, lo - W + m), dprev[m], r);
              }
              rr[i] = r;
            }
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const int row = lo + i, j = j0 + row;
              const int e = rw * WH + i * H + tid;
              const ChainStep st = chain_step(cth, CPW_s[e], rr[i],
                                              AD_s[row * H + tid], cinvh,
                                              BOW_s[e]);
              D_s[row * H + tid] = st.delta;
              R_s[row * H + tid] = st.gam;  // the row's projection is read
              dprev[i] = st.delta;
#pragma unroll
              for (int a = i + 1; a < W; ++a)
                rr[a] = fmaf(gp(GP_s, lo + a, row), st.delta, rr[a]);
              if (cvh) {
                const float msk = __fmul_rn(pm[i], qmh);
                const size_t off = (size_t)j * q + k0 + h * H + tid;
                beta_out[off] = __fmul_rn(st.bnew, msk);
                if (gam_out != nullptr) {
                  gam_out[off] = __fmul_rn(st.gam, msk);
                  mu_out[off] = __fmul_rn(st.mu, msk);
                }
              }
              g = fmaf(pm[i], st.gam, g);
              m2 = fmaf(pm[i], __fmul_rn(st.bnew, st.mu), m2);
              b2 = fmaf(pm[i], __fmul_rn(st.bnew, st.bnew), b2);
            }
          } else if (warp > 0 && w + 1 < nwin) {
            // meanwhile: the cp/beta rows two windows ahead, and the next
            // window's corrections by every delta two or more windows back
            if (w + 2 < nwin)
              stage_rows(h, j0 + lo + 2 * W, (w + 2) % NRW, 32, NCR - 32);
            cp_async_commit();
            for (int e = tid - 32; e < WH; e += NCR - 32) {
              const int t = e / H, col = e % H;
              const float* gr = GP_s + (lo + W + t) * (lo + W + t + 1) / 2;
              float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
              for (int m = 0; m < lo; m += 4) {
                s0 = fmaf(gr[m], D_s[m * H + col], s0);
                s1 = fmaf(gr[m + 1], D_s[(m + 1) * H + col], s1);
                s2 = fmaf(gr[m + 2], D_s[(m + 2) * H + col], s2);
                s3 = fmaf(gr[m + 3], D_s[(m + 3) * H + col], s3);
              }
              C_s[nxt * WH + e] = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
            }
            cp_async_wait<1>();  // the next window's rows have landed
          }
          __syncwarp();
          bar_sync(BAR_CR, NCR);
        }
        if (h) {
          gacc[1] = g, m2acc[1] = m2, b2acc[1] = b2;
        } else {
          gacc[0] = g, m2acc[0] = m2, b2acc[0] = b2;
        }
        bar_arrive(BAR_DONE + h, NT);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (cvalid[h]) {
        const int kc = k0 + h * H + tid;
        gcol[kc] = gacc[h] * qmc[h];
        m2gcol[kc] = m2acc[h] * qmc[h];
        b2col[kc] = b2acc[h] * qmc[h];
      }
    }
  } else {
    // ============================ the pass role ============================
    const int ptid = tid - NCR, pw = ptid >> 5;
    // the 4 x 4 tiles of the logit and Z tiles: rows ty*4.., columns tx*4..
    const int tx = ptid % HC, ty = ptid / HC;
    // the advance's groups of QS threads: depth slices k = 4 (NGA-1-ag +
    // NGA m) .., chunk rows ar + 8 r (r < 4; a warp's eight rows one apart, so
    // its x loads fall in distinct banks of the 132-float rows), columns
    // ac..
    const int ag = ptid / QS, agi = ptid % QS;
    const int ar = agi / HC, ac = (agi % HC) * 4;
    // the projection's tiles: depth group dg takes chunk rows dg*8 ..
    // dg*8+7; its two warps (rh) the block rows rh*HB + pi*4 ..; columns
    // pc..
    const int dg = pw >> 1, rh = pw & 1;
    const int pi = lane >> 1, pc = (lane & 1) * TW;
    const bool prow = pi * 4 < HB;
    const bool trow = ty * 4 < B;
    // the rows n0 .. n0 + NCH of x's columns j .. j + B into a stage, 16
    // bytes a copy, the (row, column) stepped without dividing by the
    // runtime B / 4 in the loop
    auto stage_xrows = [&](float* xst, int n0, int j) {
      const int xdr = NP / (B / 4), xdc = (NP % (B / 4)) * 4;
      int r = ptid / (B / 4), c4 = (ptid % (B / 4)) * 4;
      for (int e = ptid; e < NCH * B / 4; e += NP) {
        const bool ok = n0 + r < n;
        cp_async16_zfill(xst + r * XL + c4,
                         x + (size_t)(ok ? n0 + r : 0) * p + j + c4, ok);
        r += xdr;
        c4 += xdc;
        if (c4 >= B) {
          c4 -= B;
          ++r;
        }
      }
    };

    for (int bb = 0; bb <= nb; ++bb) {
      // one copy of the pass's code for both halves (not unrolled: the
      // instruction cache holds it beside the chain role's)
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        // this half's pass: advance by block bb-1, project on block bb
        const bool adv = bb > 0, proj = bb < nb;
        const int ja = (bb - 1) * B, jp = bb * B;
        const int kh = k0 + h * H;
        float* R_s = HT_s + 3 * h * BH;
        const float* D_s = R_s + BH;
        float* AD_s = R_s + 2 * BH;

        auto stage_f = [&](int ch) {  // F chunk ch and x_{bb-1} chunk ch
          float* fst = F_s + (ch % NF) * NCH * H;
          const int n0 = ch * NCH;
          for (int e = ptid; e < NCH * HC; e += NP) {
            const int r = e / HC, c4 = (e % HC) * 4;
            const bool ok = n0 + r < n && kh + c4 < q;
            cp_async16_zfill(fst + r * H + c4,
                             ok ? fitted + (size_t)(n0 + r) * q + kh + c4
                                : fitted, ok);
          }
          if (adv) stage_xrows(XA_s + (ch % NX) * NCH * XL, n0, ja);
        };
        auto stage_x = [&](int ch) {  // x_bb chunk ch
          stage_xrows(XB_s + (ch % NX) * NCH * XL, ch * NCH, jp);
        };

        stage_f(0);
        cp_async_commit();
        tick(probe_p, 3);
        if (adv) bar_sync(BAR_DONE + h, NT);  // this half's deltas of bb-1
        tick(probe_p, 4);

        float acc[4][TW];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int jj = 0; jj < TW; ++jj) acc[a][jj] = 0.f;
        // chunk ch is advanced in step ch and projected in step ch + 1
        const int last = proj ? nch : nch - 1;
        long long t_sync = 0;  // the probe's cycles at the barriers
        for (int ch = 0; ch <= last; ++ch) {
          if (probe_p) t_sync -= clock64();
          cp_async_wait<0>();  // F and x_{bb-1} chunk ch, x_bb chunk ch-1
          bar_sync(BAR_P, NP);  // ... everyone's; ch-1 advanced, ch-2
                                // projected: their stages are free
          if (probe_p) t_sync += clock64();
          if (ch + 1 < nch) stage_f(ch + 1);
          if (proj && ch < nch) stage_x(ch);
          cp_async_commit();
          float* fs = F_s + (ch % NF) * NCH * H;
          const bool adv_ch = adv && ch < nch;
          if (adv_ch && ag < NGA) {  // this depth slice's part of the advance
            const float* xa = XA_s + (ch % NX) * NCH * XL;
            float a4[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) a4[r][jj] = 0.f;
            // group ag takes depth slices NGA-1-ag, +NGA, ..: where B / 4
            // is not a multiple of NGA the extra slices go to the last
            // groups, whose warps have no F sums to add after the advance
#pragma unroll 1
            for (int k4 = NGA - 1 - ag; k4 < B / 4; k4 += NGA) {
              const int kk = 4 * k4;
              float xr[4][4];
#pragma unroll
              for (int r = 0; r < 4; ++r)
                unpack4(ld4(xa + (ar + 8 * r) * XL + kk), xr[r]);
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                float d[4];
                unpack4(ld4(D_s + (kk + s) * H + ac), d);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                  for (int jj = 0; jj < 4; ++jj)
                    a4[r][jj] = fmaf(xr[r][s], d[jj], a4[r][jj]);
              }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
              *reinterpret_cast<float4*>(AP_s + ag * NCH * H +
                                         (ar + 8 * r) * H + ac) =
                  make_float4(a4[r][0], a4[r][1], a4[r][2], a4[r][3]);
          }
          if (proj && prow && ch > 0) {  // r0 += x_bb^T F over chunk ch-1
            const float* fp = F_s + ((ch - 1) % NF) * NCH * H;
            const float* xp = XB_s + ((ch - 1) % NX) * NCH * XL;
#pragma unroll 2
            for (int r = dg * 8; r < dg * 8 + 8; ++r) {
              float xv[4], fv[TW];
              unpack4(ld4(xp + r * XL + rh * HB + pi * 4), xv);
#pragma unroll
              for (int jj = 0; jj < TW; jj += 2) {
                const float2 v =
                    *reinterpret_cast<const float2*>(fp + r * H + pc + jj);
                fv[jj] = v.x;
                fv[jj + 1] = v.y;
              }
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int jj = 0; jj < TW; ++jj)
                  acc[a][jj] = fmaf(xv[a], fv[jj], acc[a][jj]);
            }
          }
          if (adv_ch) {
            if (probe_p) t_sync -= clock64();
            bar_sync(BAR_P, NP);
            if (probe_p) t_sync += clock64();
            // F + the depth slices, in order: four columns of one row each
            if (ptid < NCH * HC) {
              const int row = ptid / HC, c4 = (ptid % HC) * 4;
              float f[4], t[4];
              unpack4(ld4(fs + row * H + c4), f);
              for (int g = 0; g < NGA; ++g) {
                unpack4(ld4(AP_s + g * NCH * H + row * H + c4), t);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) f[jj] = __fadd_rn(f[jj], t[jj]);
              }
              const float4 v = make_float4(f[0], f[1], f[2], f[3]);
              *reinterpret_cast<float4*>(fs + row * H + c4) = v;
              const int nr = ch * NCH + row;
              if (nr < n && kh + c4 < q)
                *reinterpret_cast<float4*>(fitted + (size_t)nr * q + kh + c4) =
                    v;
            }
          }
        }
        cp_async_wait<0>();
        bar_sync(BAR_P, NP);  // every chunk is consumed: the stages are free
        tick(probe_p, 2);
        if (probe_p) g_clocks[5] += t_sync;

        // ---- after the pass: partial sums, Z tile of bb-1, logit tile of bb
        for (int e = ptid; e < B * R / 4; e += NP) {
          if (adv) cp_async16(LZ_s + 4 * e, l_aug + (size_t)ja * R + 4 * e);
          if (proj) cp_async16(LA_s + 4 * e, l_aug + (size_t)jp * R + 4 * e);
        }
        cp_async_commit();
        if (proj) {
          // the four depth groups' sums in a fixed order, thread-major (a
          // thread of group dg meets the same thread of groups dg + 2, then
          // dg + 1); the buffer of (group k, row half rh) is k * 2 + rh
          auto put = [&](float* dst) {
            if (prow)
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int jj = 0; jj < TW; ++jj)
                  dst[(a * TW + jj) * 32 + lane] = acc[a][jj];
          };
          auto add = [&](const float* src) {
            if (prow)
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int jj = 0; jj < TW; ++jj)
                  acc[a][jj] = __fadd_rn(acc[a][jj],
                                         src[(a * TW + jj) * 32 + lane]);
          };
          if (dg >= 2) put(PB_s + ((dg - 2) * 2 + rh) * PW);
          bar_sync(BAR_P, NP);
          if (dg < 2) add(PB_s + (dg * 2 + rh) * PW);
          bar_sync(BAR_P, NP);
          if (dg == 1) put(PB_s + rh * PW);
          bar_sync(BAR_P, NP);
          if (dg == 0) {
            add(PB_s + rh * PW);
            put(PB_s + rh * PW);  // the block's projections, thread-major
          }
        }
        cp_async_wait<0>();  // the rows of L
        bar_sync(BAR_P, NP);

        if (adv) {  // Z moments of block bb-1: z = gam * imrd + imr0u
          float* ZR_s = PB_s + 2 * PW;  // the rows' partial sums
          if (trow) {
            float d1[4][4], d2[4][4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) d1[a][jj] = d2[a][jj] = 0.f;
            const float* l0 = LZ_s + ty * 4 * R;
#pragma unroll 2
            for (int rr = 0; rr < R; ++rr) {
              float n1[4], n2[4];
              unpack4(ld4(N_s + (R + rr) * QS + h * H + tx * 4), n1);
              unpack4(ld4(N_s + (2 * R + rr) * QS + h * H + tx * 4), n2);
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
            float zeta4[4], qm4[4], zc[4];
            unpack4(ld4(ZQ_s + h * H + tx * 4), zeta4);
            unpack4(ld4(ZQ_s + QS + h * H + tx * 4), qm4);
            float* zcp = ZC_s + ty * QS + h * H + tx * 4;
            unpack4(ld4(zcp), zc);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int i = ty * 4 + a;
              const float th = theta[ja + i], pm = p_mask[ja + i];
              float zr = 0.f;
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const float zq = z_cell(th + zeta4[jj], R_s[i * H + tx * 4 + jj],
                                        d1[a][jj], d2[a][jj], qm4[jj], kz,
                                        c_one);
                zr = __fadd_rn(zr, zq);
                zc[jj] = fmaf(pm, zq, zc[jj]);
              }
              ZR_s[i * HC + tx] = zr;
            }
            *reinterpret_cast<float4*>(zcp) =
                make_float4(zc[0], zc[1], zc[2], zc[3]);
          }
          bar_sync(BAR_P, NP);
          if (ptid < B) {  // each row's HC partial sums, in column order
            float zr = 0.f;
            for (int t = 0; t < HC; ++t) zr = __fadd_rn(zr, ZR_s[ptid * HC + t]);
            zrow_part[(size_t)(2 * blockIdx.x + h) * p + ja + ptid] =
                __fmul_rn(p_mask[ja + ptid], zr);
          }
        }
        if (proj) {
          bar_sync(BAR_P, NP);  // the Z tile has read the gam tile
          if (dg == 0 && prow) {  // the projections, in place of gam
            const float* src = PB_s + rh * PW;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int i = rh * HB + pi * 4 + a;
#pragma unroll
              for (int jj = 0; jj < TW; jj += 2)
                *reinterpret_cast<float2*>(R_s + i * H + pc + jj) =
                    make_float2(src[(a * TW + jj) * 32 + lane],
                                src[(a * TW + jj + 1) * 32 + lane]);
            }
          }
          if (trow) {  // the logit-constant tile ad = base + L_bb N_ad
            float dot[4][4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) dot[a][jj] = 0.f;
            const float* l0 = LA_s + ty * 4 * R;
#pragma unroll 2
            for (int rr = 0; rr < R; ++rr) {
              float nv[4];
              unpack4(ld4(N_s + rr * QS + h * H + tx * 4), nv);
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                const float l = l0[a * R + rr];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  dot[a][jj] = fmaf(l, nv[jj], dot[a][jj]);
              }
            }
            float zeta4[4];
            unpack4(ld4(ZQ_s + h * H + tx * 4), zeta4);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int i = ty * 4 + a;
              const float th = theta[jp + i];
              float v[4];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                v[jj] = __fadd_rn(logit_base(th + zeta4[jj], c, c_one),
                                  dot[a][jj]);
              *reinterpret_cast<float4*>(AD_s + i * H + tx * 4) =
                  make_float4(v[0], v[1], v[2], v[3]);
            }
          }
          bar_arrive(BAR_READY + h, NT);
        }
        bar_sync(BAR_P, NP);  // the stage area is free for the next pass
        tick(probe_p, 3);
      }
    }
    // z_col: the tile rows' partials, in row order
    if (ptid < QS && k0 + ptid < q) {
      float s = 0.f;
      for (int t = 0; t < B / 4; ++t) s += ZC_s[t * QS + ptid];
      z_col[k0 + ptid] = s;
    }
  }
  if (probe_c) g_clocks[NCLK - 1] += clock64();
}

// the shared-memory bytes of a QS-column launch at (B, R), or 0 where the
// kernel cannot take them
template <int QS>
size_t checked_smem(int B, int R) {
  const size_t smem = smem_bytes<QS>(B, R);
  return smem <= SMEM_MAX ? smem : 0;
}

template <int QS>
int launch(const float* x, const float* cp, const float* gram,
           const float* l_aug, const float* n_stack, const float* beta_in,
           float* fitted, const float* theta, const float* p_mask,
           const float* zeta, const float* q_mask, const float* s2v,
           const float* tauv, const float* scal, float* beta_out,
           float* gam_out, float* mu_out, float* zrow_part, float* z_row,
           float* z_col, float* gcol, float* m2gcol, float* b2col, int n,
           int p, int q, int B, int R, int c_one, cudaStream_t st) {
  const size_t smem = checked_smem<QS>(B, R);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_staggered_kernel<QS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  sweep_staggered_kernel<QS><<<n_slices, NT, smem, st>>>(
      x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, p_mask, zeta,
      q_mask, s2v, tauv, scal, beta_out, gam_out, mu_out, zrow_part, z_col,
      gcol, m2gcol, b2col, n, p, q, B, R, c_one);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<(p + 255) / 256, 256, 0, st>>>(zrow_part, z_row,
                                                       2 * n_slices, p);
  return (int)cudaGetLastError();
}

template <int QS>
int occupancy(int B, int R) {
  const size_t smem = checked_smem<QS>(B, R);
  int nb = -1;
  if (smem == 0 ||
      cudaFuncSetAttribute(sweep_staggered_kernel<QS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, sweep_staggered_kernel<QS>, NT, smem) != cudaSuccess)
    return -1;
  return nb;
}

}  // namespace

extern "C" {

// Launches one staggered sweep (the sweep kernel, then the z_row reduction)
// on `stream`; arguments as atlasqtl_sweep_fused: slices of `qs` columns,
// 32 or 40 (ops/sweep_staggered.py:staggered_launch_plan picks it), B the
// block piece (at most 128), zrow_part 2 ceil(q / qs) rows of p.  Returns
// the CUDA error code of the launches (0 on success); cudaErrorInvalidValue
// for a shape or width it does not take.
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
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || R <= 0 || R > RMAX ||
      q % 4 != 0 || n <= 0 || (gam_out == nullptr) != (mu_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qs == 32)
    return launch<32>(x, cp, gram, l_aug, n_stack, beta_in, fitted, theta,
                      p_mask, zeta, q_mask, s2v, tauv, scal, beta_out,
                      gam_out, mu_out, zrow_part, z_row, z_col, gcol, m2gcol,
                      b2col, n, p, q, B, R, c_one, st);
  if (qs == 40)
    return launch<40>(x, cp, gram, l_aug, n_stack, beta_in, fitted, theta,
                      p_mask, zeta, q_mask, s2v, tauv, scal, beta_out,
                      gam_out, mu_out, zrow_part, z_row, z_col, gcol, m2gcol,
                      b2col, n, p, q, B, R, c_one, st);
  return (int)cudaErrorInvalidValue;
}

// The shared-memory bytes of a launch in `qs`-column slices at block piece
// B and interpolation width R; -1 for a width or shape the kernel does not
// take (the card checks ops/sweep_staggered.py:_stag_smem_bytes against it).
long long atlasqtl_sweep_staggered_smem(int qs, int B, int R) {
  if (B <= 0 || B % W != 0 || B > BMAX || R <= 0 || R > RMAX) return -1;
  const size_t smem = qs == 32 ? checked_smem<32>(B, R)
                      : qs == 40 ? checked_smem<40>(B, R)
                                 : 0;
  return smem == 0 ? -1 : (long long)smem;
}

// Copies the probes' NCLK phase clocks of the latest launch to `out` (host
// memory); returns the CUDA error code.
int atlasqtl_sweep_staggered_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * NCLK);
}

// CTAs of the staggered kernel in `qs`-column slices resident on one SM at
// block piece B and interpolation width R (the occupancy calculator), -1 on
// error.
int atlasqtl_sweep_staggered_occupancy(int qs, int B, int R) {
  return qs == 32 ? occupancy<32>(B, R) : qs == 40 ? occupancy<40>(B, R) : -1;
}

}  // extern "C"
