// One predictor block of the B3 route (Config(sweep="pallas"),
// Config(use_pallas=True)): everything between the projection r0 = X_b^T F
// and the advance F += X_b delta, as one CUDA kernel for Hopper (sm_90a), in
// float32 and float64.
//
// Replaces the TPU kernel atlasqtl_tpu/ops/sweep_pallas.py:_inner_gs_kernel
// together with the per-block glue of sweep_complete_pallas there
// (:154-202): the probit tiles, the sequential update and the Z sums.  For
// i = 0..B-1 in order, with u = theta_i + zeta_k,
//     log_p, log_1p = log Phi(u), log(1 - Phi(u))
//     r_i   = r[i] - beta_old_i * G[i, i]
//     mu_i  = c s2 tau (cp[i] - r_i)
//     logit = c (log_1p - log_p - mu_i^2 / (2 s2) + cst)
//     gam_i = sigmoid(-logit),  delta_i = gam_i mu_i - beta_old_i
//     r    += G[:, i] delta_i
// with cst = -(log tau + log sig2_inv + log s2) / 2; then the Z cells of
// ops/sweep.py:_z_block_sums at u_z = sqrt(c) u,
//     z = ((g (imr1 - imr0) + imr0) / sqrt(c) + u) pm qm,  g = gam pm qm,
// summed over the block's columns into one partial of z_row per (column
// slice, row) and over its rows into z_col (added in place).  gam and mu go
// straight to the block's rows of the sweep's (p, q) outputs, delta to a
// (B, q) buffer that every block reuses.  The probit tiles are the exact
// special functions (float32: ops/special.py:log_ndtr_both_fast's erfcx
// form; float64: torch.special.log_ndtr's), not B1's interpolated tail.
// A second instance (TILES) reads log_p / log_1p from given tiles and does
// no Z work: the function of the JAX wrapper inner_gs_pallas.
// The plain versions are ops/sweep_pallas.py:block_gs_plain and
// inner_gs_plain.
//
// What bounds it on an H100: 4 B x q tiles in (r0, cp, gam, mu), 3 out
// (gam, mu, delta), the Gram: 7 B q floats, 0.0107 ms at (128, 10000) in
// float32 at 3.35 TB/s.  Its operations (B^2 q for the pushes, ~70-105 per
// cell for the probit tiles, the Mills ratios, the chain and the Z cell)
// take less at 67 TFLOP/s.  What holds one CTA back is the chain: strictly
// sequential in i, one row's update latency after another.
//
// Design:
//  - one CTA of 256 threads (8 warps) owns 32 response columns (one lane
//    per column); the columns are independent, so CTAs never communicate;
//  - windows of W = 8 rows and one barrier per window.  While warp 0 runs
//    window w's chain from shared memory alone (pushing each delta onto
//    the window's later rows and onto window w+1's, in registers), warps
//    1-3 each push a third of the rows before window w onto all 8 rows of
//    window w+1 (per row one delta load and two 16-byte Gram loads: few
//    shared-memory requests, which the chain's own loads queue behind),
//    and warps 4-7 each finish the Z cells of two rows of the window whose
//    gam just landed, compute the same rows of window w+1's operands (r0,
//    cp, beta_old, log(1 - Phi) - log Phi, the Mills-ratio terms of the Z
//    cells; warps 4-5 the window's 8 x 8 Gram) from registers loaded a
//    window earlier, and issue the loads of window w+2.  So no
//    device-memory load, no special function and no push of an earlier
//    window waits on the chain's path: the chain adds r0 and four sums of
//    pushes, then runs;
//  - the Gram sits in shared memory for its first GS_ROWS = 128 rows, row
//    m from its window's first column on (so the pushes of row m onto a
//    later window are 8 contiguous values, two 16-byte loads); a block
//    over 128 rows is an instance of its own (BIG) that reads what lies
//    beyond from device memory (choosing the memory at run time in the
//    small-block instance doubled its registers in an earlier design);
//  - the window operands alternate between two slots: the chain reads one
//    while warps 4-7 read the other's Z terms and then overwrite them,
//    row by row, with the next window's;
//  - z_row partials go to an (n_slices, p) buffer, reduced once per sweep in
//    slice order by zrow_reduce_kernel; the per-warp z_col partials are
//    added in warp order: no float atomics, so a run repeats bit for bit.
#include "common.cuh"

namespace {

constexpr int QS = 32;     // response columns per CTA
constexpr int NT = 256;    // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int W = 8;       // chain window (rows)
constexpr int NCORR = 3;   // push warps (1-3), a third of the rows each
constexpr int ZW0 = 1 + NCORR;  // first Z / operand warp (4-7, 2 rows each)
constexpr int GS_ROWS = 128;  // Gram rows kept in shared memory
constexpr int SMEM_MAX = 232448;  // shared memory one CTA may take
constexpr int NSLOT = 2;   // window operand slots
// the tiles of one slot, each W x QS
enum { T_R, T_CP, T_BO, T_LD, T_DZ, T_I0, T_GAM, NTILE };
constexpr double LOG_SQRT_2PI = 0.9189385332046727417803297364056176;
constexpr int NCLK = 6;  // phase clock slots of the three probe threads

// clock() cycles of CTA 0's probes per phase of the latest launch, summed
// over the windows in the probes' registers and written at the end: the
// chain thread (thread 0) in its chains (the pushes added in first), at
// the barrier; a push thread (thread 32) in the pushes, at the barrier; an
// operand thread (thread 128) in its Z cells, operands and loads, at the
// barrier (atlasqtl_inner_gs_clocks; chip_smoke.py's gs_kernel phase
// prints them)
__device__ long long g_gs_clocks[NCLK];

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log_t(float v) { return logf(v); }
__device__ __forceinline__ double log_t(double v) { return log(v); }
// 1 / v, correctly rounded: the IEEE quotient 1 / v, without the division
__device__ __forceinline__ float rcp_t(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double rcp_t(double v) { return __drcp_rn(v); }
__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float min_t(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double min_t(double a, double b) {
  return fmin(a, b);
}

// 8 consecutive values from a 32-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const double* p, double (&o)[8]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const double2 a = reinterpret_cast<const double2*>(p)[v];
    o[2 * v] = a.x;
    o[2 * v + 1] = a.y;
  }
}

// The shared Gram: row m (m < BS) from its window's first column 8 (m / 8)
// to BS - 1; every row starts 32-byte aligned
__host__ __device__ __forceinline__ int gu_off(int m, int BS) {
  const int v = m / W;
  return W * v * BS - 4 * W * v * (v - 1) + (m - W * v) * (BS - W * v);
}
__host__ __device__ __forceinline__ int gu_size(int BS) {
  const int n = BS / W;
  return W * W * n * (n + 1) / 2;
}

template <typename T>
size_t smem_bytes(int B) {
  return sizeof(T) * ((size_t)gu_size(B < GS_ROWS ? B : GS_ROWS) +
                      (size_t)B * QS + NSLOT * NTILE * W * QS +
                      NSLOT * W * W + NSLOT * 2 * W +
                      NSLOT * NCORR * W * QS + NWARP * QS);
}

// (log Phi(x), log(1 - Phi(x))), float32: ops/special.py:log_ndtr_both_fast
__device__ __forceinline__ void log_ndtr_both(float x, float& lp,
                                              float& l1p) {
  const float ax = fabsf(x);
  const float z = ax * 0.7071067811865476f;
  const float t = 1.f / (1.f + 0.5f * z);
  float poly = 0.17087277f;
  poly = poly * t - 0.82215223f;
  poly = poly * t + 1.48851587f;
  poly = poly * t - 1.13520398f;
  poly = poly * t + 0.27886807f;
  poly = poly * t - 0.18628806f;
  poly = poly * t + 0.09678418f;
  poly = poly * t + 0.37409196f;
  poly = poly * t + 1.00002368f;
  poly = poly * t - 1.26551223f;
  const float lo = -0.5f * ax * ax + (logf(0.5f * t) + poly);
  const float hi = log1pf(-expf(lo));
  lp = x >= 0.f ? hi : lo;
  l1p = x >= 0.f ? lo : hi;
}

// float64: torch.special.log_ndtr at x and at -x
__device__ __forceinline__ double log_ndtr(double x) {
  const double t = x * 0.7071067811865476;
  return x < -1.0 ? log(erfcx(-t) / 2) - t * t : log1p(-erfc(t) / 2);
}
__device__ __forceinline__ void log_ndtr_both(double x, double& lp,
                                              double& l1p) {
  lp = log_ndtr(x);
  l1p = log_ndtr(-x);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// BIG: the block has rows beyond GS_ROWS, read from device memory.  A
// float32 instance for blocks up to GS_ROWS keeps to 80 registers, so that
// three CTAs share an SM.  TILES: log_p / log_1p come from given (B, q)
// tiles and there is no Z work (inner_gs_pallas); else they are computed
// from theta and zeta and the Z sums are fused.  Every (B, q) or block-row
// operand has row stride q.
template <typename T, bool BIG, bool TILES>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 && !BIG ? 3 : 1)
    inner_gs_kernel(
    const T* __restrict__ r0,       // (B, q)
    const T* __restrict__ g,        // (B, B)
    const T* __restrict__ cp,       // (B, q) rows of the block
    const T* __restrict__ gam_in,   // (B, q)
    const T* __restrict__ mu_in,    // (B, q)
    const T* __restrict__ log_p,    // (B, q), TILES only
    const T* __restrict__ log_1p,   // (B, q), TILES only
    const T* __restrict__ theta,    // (B,)
    const T* __restrict__ zeta,     // (q,)
    const T* __restrict__ pmask,    // (B,)
    const T* __restrict__ qmask,    // (q,)
    const T* __restrict__ s2v,      // (q,)
    const T* __restrict__ tauv,     // (q,)
    const T* __restrict__ logtauv,  // (q,)
    const T* __restrict__ scal,     // (4,) c, log sig2_inv, sqrt c, -
    T* __restrict__ gam_out,        // (B, q)
    T* __restrict__ mu_out,         // (B, q)
    T* __restrict__ delta_out,      // (B, q)
    T* __restrict__ z_col,          // (q,), added to
    T* __restrict__ zrow_part,      // (n_slices, zrow_stride), this block's
    int q, int B, int zrow_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int BS = B < GS_ROWS ? B : GS_ROWS;  // the rows kept in Gu_s
  T* Gu_s = reinterpret_cast<T*>(smem_raw);  // row m at gu_off(m, BS)
  T* D_s = Gu_s + gu_size(BS);              // B x QS deltas
  T* S_s = D_s + B * QS;                    // NSLOT x NTILE x W x QS
  T* Gw_s = S_s + NSLOT * NTILE * W * QS;   // NSLOT x W x W window Grams
  T* Row_s = Gw_s + NSLOT * W * W;          // NSLOT x (theta, p_mask) x W
  T* P_s = Row_s + NSLOT * 2 * W;           // NSLOT x NCORR x W x QS pushes
  T* ZC_s = P_s + NSLOT * NCORR * W * QS;   // NWARP x QS z_col partials
  // the 8 Gram values G[m, lo .. lo + 7] of an earlier row m (m < lo)
  auto panel = [&](int m, int lo) -> const T* {
    if constexpr (BIG)
      if (lo >= BS) return g + (size_t)m * B + lo;
    return Gu_s + gu_off(m, BS) + lo - W * (m / W);
  };
  auto tile = [&](int slot, int t, int r) -> T* {
    return S_s + ((slot * NTILE + t) * W + r) * QS;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x * QS + lane;
  const bool valid = k < q;
  const int nw = B / W;
  const T c = scal[0], lsi = scal[1], sqrt_c = scal[2];
  const bool c_one = sqrt_c == T(1);
  // per-lane column constants; a padded lane gets ct = 0, qm = 0
  T inv2s2 = T(0.5), ct = T(0), cst = T(0), zk = T(0), qm = T(0);
  if (valid) {
    const T s2 = s2v[k];
    inv2s2 = T(0.5) / s2;
    ct = c * s2 * tauv[k];
    cst = -(logtauv[k] + lsi + log_t(s2)) / T(2);
    if constexpr (!TILES) {
      zk = zeta[k];
      qm = qmask[k];
    }
  }

  // warps 4-7: the device-memory operands of their two rows of one window
  // (rows warp - 4 and warp), loaded a window ahead of their use
  struct Raw {
    T r0, cp, gam, mu, lp, l1p, th, pm;
  } raw[2];
  T gwv = T(0);
  const int tz = tid - ZW0 * 32;  // tz < W * W: a window Gram entry
  auto zrow = [&](int h) { return warp - ZW0 + h * (NWARP - ZW0); };
  auto load = [&](int w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = w * W + zrow(h);
      const size_t off = (size_t)i * q + k;
      Raw& a = raw[h];
      a.r0 = a.cp = a.gam = a.mu = a.lp = a.l1p = T(0);
      if (valid) {
        a.r0 = r0[off];
        a.cp = cp[off];
        a.gam = gam_in[off];
        a.mu = mu_in[off];
        if constexpr (TILES) {
          a.lp = log_p[off];
          a.l1p = log_1p[off];
        }
      }
      if constexpr (!TILES) {
        a.th = theta[i];
        a.pm = pmask[i];
      }
    }
    if (tz < W * W) gwv = g[(size_t)(w * W + tz / W) * B + w * W + tz % W];
  };
  // warps 4-7: their rows of a window's operands into `slot`
  auto prep = [&](int slot) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = zrow(h);
      const Raw& a = raw[h];
      T lp = a.lp, l1p = a.l1p;
      tile(slot, T_R, r)[lane] = a.r0;
      tile(slot, T_CP, r)[lane] = a.cp;
      tile(slot, T_BO, r)[lane] = a.gam * a.mu;
      if constexpr (!TILES) {
        const T u = a.th + zk;
        log_ndtr_both(u, lp, l1p);
        T uz = u, lpz = lp, l1pz = l1p;
        if (!c_one) {
          uz = sqrt_c * u;
          log_ndtr_both(uz, lpz, l1pz);
        }
        const T e = T(-0.5) * uz * uz - T(LOG_SQRT_2PI);
        const T imr1 = max_t(exp_t(e - lpz), -uz);
        const T imr0 = min_t(-exp_t(e - l1pz), -uz);
        tile(slot, T_DZ, r)[lane] = imr1 - imr0;
        tile(slot, T_I0, r)[lane] = imr0;
        if (lane == 0) {
          Row_s[(slot * 2) * W + r] = a.th;
          Row_s[(slot * 2 + 1) * W + r] = a.pm;
        }
      }
      tile(slot, T_LD, r)[lane] = l1p - lp;
    }
    if (tz < W * W) Gw_s[slot * W * W + tz] = gwv;
  };
  // warps 4-7: the Z cells of their rows of window w (gam in `slot`), into
  // the rows' z_row partials and this warp's z_col partial
  T zc = T(0);
  auto zcells = [&](int w, int slot) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = zrow(h);
      const T th = Row_s[(slot * 2) * W + r];
      const T pm = Row_s[(slot * 2 + 1) * W + r];
      const T gm = tile(slot, T_GAM, r)[lane] * pm * qm;
      T v = gm * tile(slot, T_DZ, r)[lane] + tile(slot, T_I0, r)[lane];
      if (!c_one) v = v / sqrt_c;
      const T z = (v + (th + zk)) * pm * qm;
      zc += z;
      const T zr = warp_sum(z);
      if (lane == 0)
        zrow_part[(size_t)blockIdx.x * zrow_stride + w * W + r] = zr;
    }
  };
  // warps 1-3: the pushes of rows [m0, m1) onto the 8 rows of window w,
  // into this warp's partial in `slot`: per row m one delta and two 16-byte
  // loads of G[m, 8w .. 8w + 7]
  auto pushes = [&](int w, int slot, int m0, int m1) {
    T acc[W];
#pragma unroll
    for (int r = 0; r < W; ++r) acc[r] = T(0);
    for (int m = m0; m < m1; ++m) {
      const T d = D_s[m * QS + lane];
      T gm[W];
      load8(panel(m, w * W), gm);
#pragma unroll
      for (int r = 0; r < W; ++r) acc[r] += gm[r] * d;
    }
    T* P = P_s + ((slot * NCORR) + warp - 1) * W * QS;
#pragma unroll
    for (int r = 0; r < W; ++r) P[r * QS + lane] = acc[r];
  };
  // warp 0, before window w's chain: r0 plus the pushes of the rows before
  // window w - 1 (warps 1-3) plus those of window w - 1 (nxt, summed by the
  // chain itself), from shared memory alone
  T nxt[W];
#pragma unroll
  for (int r = 0; r < W; ++r) nxt[r] = T(0);
  auto chain_in = [&](int slot, T (&rr)[W]) {
    const T* P = P_s + slot * NCORR * W * QS;
#pragma unroll
    for (int m = 0; m < W; ++m) {
      rr[m] = tile(slot, T_R, m)[lane] + nxt[m];
#pragma unroll
      for (int v = 0; v < NCORR; ++v) rr[m] += P[(v * W + m) * QS + lane];
      nxt[m] = T(0);
    }
  };
  // warp 0: window w's 8 updates, each delta pushed onto the window's later
  // rows and onto window w + 1 (nxt), its operands and Gram values from
  // shared memory
  auto chain = [&](int w, int slot, T (&rr)[W]) {
    const int lo = w * W;
    const T* gw = Gw_s + slot * W * W;
    const bool more = w + 1 < nw;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int row = lo + i;
      const T bo = tile(slot, T_BO, i)[lane], cpv = tile(slot, T_CP, i)[lane];
      const T ldv = tile(slot, T_LD, i)[lane];
      // row i of the window Gram: G[lo + i, lo + m] = G[lo + m, lo + i]
      const T* gc = gw + i * W;
      T gm[W];
      if (more) load8(panel(row, lo + W), gm);
      const T ri = rr[i] - bo * gc[i];
      const T mu = ct * (cpv - ri);
      const T logit = c * (ldv - mu * mu * inv2s2 + cst);
      const T gam = rcp_t(T(1) + exp_t(logit));
      const T delta = gam * mu - bo;
#pragma unroll
      for (int m = i + 1; m < W; ++m) rr[m] += gc[m] * delta;
      if (more) {
#pragma unroll
        for (int r = 0; r < W; ++r) nxt[r] += gm[r] * delta;
      }
      D_s[row * QS + lane] = delta;
      if constexpr (!TILES) tile(slot, T_GAM, i)[lane] = gam;
      if (valid) {
        const size_t off = (size_t)row * q + k;
        gam_out[off] = gam;
        mu_out[off] = mu;
        delta_out[off] = delta;
      }
    }
  };

  // a probe's cycles per phase, in 32-bit registers (a launch lasts far
  // fewer than 2^32 cycles; a tick is a clock read and two adds; the sums
  // go to g_gs_clocks once, at the end)
  const bool probe = blockIdx.x == 0 && (tid == 0 || tid == 32 || tid == 128);
  unsigned clk = 0, ck0 = 0, ck1 = 0;  // the probe's work and barrier
  auto tick = [&](unsigned& acc) {  // cycles since the probe's last tick
    if (probe) {
      const unsigned t = (unsigned)clock();
      acc += t - clk;
      clk = t;
    }
  };

  if (warp >= ZW0) load(0);
  for (int e = tid; e < BS * BS; e += NT) {
    const int m = e / BS, j = e % BS, m8 = W * (m / W);
    if (j >= m8) Gu_s[gu_off(m, BS) + j - m8] = g[(size_t)m * B + j];
  }
  for (int e = tid; e < NCORR * W * QS; e += NT) P_s[e] = T(0);
  if (warp >= ZW0) {
    prep(0);
    if (nw > 1) load(1);
  }
  __syncthreads();
  if (probe) clk = (unsigned)clock();

  for (int w = 0; w <= nw; ++w) {
    const int slot = w % NSLOT;
    if (warp == 0) {
      if (w < nw) {
        T rr[W];
        chain_in(slot, rr);
        chain(w, slot, rr);
        tick(ck0);
      }
    } else if (warp < ZW0) {
      if (w + 1 < nw) {  // rows [0, 8w) are final: a third each
        const int L = w * W, h = warp - 1;
        pushes(w + 1, (w + 1) % NSLOT, L * h / NCORR, L * (h + 1) / NCORR);
      }
      tick(ck0);
    } else {
      if constexpr (!TILES)
        if (w >= 1) zcells(w - 1, (w + 1) % NSLOT);
      __syncwarp();  // the slot's Z terms are read before prep rewrites them
      if (w + 1 < nw) prep((w + 1) % NSLOT);
      if (w + 2 < nw) load(w + 2);
      tick(ck0);
    }
    __syncthreads();
    tick(ck1);
  }

  if constexpr (!TILES) {  // z_col += the operand warps' partials, in order
    ZC_s[warp * QS + lane] = zc;
    __syncthreads();
    if (warp == 0 && valid) {
      T s = T(0);
      for (int v = ZW0; v < NWARP; ++v) s += ZC_s[v * QS + lane];
      z_col[k] += s;
    }
  }
  if (probe) {  // slots: chain 0-1, pushes 2-3, operands 4-5
    const int s = tid == 0 ? 0 : tid == 32 ? 2 : 4;
    g_gs_clocks[s] = ck0;
    g_gs_clocks[s + 1] = ck1;
  }
}

template <typename T, bool BIG, bool TILES>
cudaError_t allow_smem() {
  // the largest dynamic shared memory, once per instance: every launch of
  // the instance then takes what it needs
  static cudaError_t err = cudaFuncSetAttribute(
      inner_gs_kernel<T, BIG, TILES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  return err;
}

template <typename T, bool BIG, bool TILES>
int launch(const void* r0, const void* g, const void* cp, const void* gam,
           const void* mu, const void* log_p, const void* log_1p,
           const void* theta, const void* zeta, const void* pmask,
           const void* qmask, const void* s2, const void* tau,
           const void* log_tau, const void* scal, void* gam_out, void* mu_out,
           void* delta_out, void* z_col, void* zrow_part, int q, int B,
           int zrow_stride, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(B);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T, BIG, TILES>();
  if (err != cudaSuccess) return (int)err;
  auto in = [](const void* v) { return static_cast<const T*>(v); };
  auto out = [](void* v) { return static_cast<T*>(v); };
  inner_gs_kernel<T, BIG, TILES><<<(q + QS - 1) / QS, NT, smem, st>>>(
      in(r0), in(g), in(cp), in(gam), in(mu), in(log_p), in(log_1p),
      in(theta), in(zeta), in(pmask), in(qmask), in(s2), in(tau),
      in(log_tau), in(scal), out(gam_out), out(mu_out), out(delta_out),
      out(z_col), out(zrow_part), q, B, zrow_stride);
  return (int)cudaGetLastError();
}

template <typename T, bool BIG, bool TILES>
int occupancy(int B) {
  const size_t smem = smem_bytes<T>(B);
  int nb = -1;
  if (smem > SMEM_MAX || allow_smem<T, BIG, TILES>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, inner_gs_kernel<T, BIG, TILES>, NT, smem) != cudaSuccess)
    return -1;
  return nb;
}

}  // namespace

extern "C" {

// Launches one block of the B3 route on `stream`, in float64 when is_f64 is
// set, else float32; `tiles` selects the instance that reads log_p/log_1p
// and does no Z work (then theta, zeta, pmask, qmask, z_col and zrow_part
// are not read).  zrow_part points at the block's first row of an
// (n_slices, zrow_stride) buffer.  Returns the CUDA error code of the
// launch (0 on success).
int atlasqtl_inner_gs(int is_f64, int tiles, const void* r0, const void* g,
                      const void* cp, const void* gam, const void* mu,
                      const void* log_p, const void* log_1p,
                      const void* theta, const void* zeta, const void* pmask,
                      const void* qmask, const void* s2, const void* tau,
                      const void* log_tau, const void* scal, void* gam_out,
                      void* mu_out, void* delta_out, void* z_col,
                      void* zrow_part, int q, int B, int zrow_stride,
                      void* stream) {
  if (B <= 0 || B % W != 0 || q <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto f) {
    return f(r0, g, cp, gam, mu, log_p, log_1p, theta, zeta, pmask, qmask,
             s2, tau, log_tau, scal, gam_out, mu_out, delta_out, z_col,
             zrow_part, q, B, zrow_stride, st);
  };
  const bool big = B > GS_ROWS;
  if (is_f64) {
    if (tiles) return big ? go(launch<double, true, true>)
                          : go(launch<double, false, true>);
    return big ? go(launch<double, true, false>)
               : go(launch<double, false, false>);
  }
  if (tiles) return big ? go(launch<float, true, true>)
                        : go(launch<float, false, true>);
  return big ? go(launch<float, true, false>)
             : go(launch<float, false, false>);
}

// z_row[j] = sum over slices of part[slice, j], in slice order (float64
// when is_f64); the CUDA error code of the launch.
int atlasqtl_zrow_reduce(int is_f64, const void* part, void* z_row,
                         int n_slices, int p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    zrow_reduce_kernel<double><<<(p + 255) / 256, 256, 0, st>>>(
        static_cast<const double*>(part), static_cast<double*>(z_row),
        n_slices, p);
  else
    zrow_reduce_kernel<float><<<(p + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(z_row), n_slices,
        p);
  return (int)cudaGetLastError();
}

// Copies the probes' NCLK phase clocks of the latest launch to `out` (host
// memory); the CUDA error code.
int atlasqtl_inner_gs_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_gs_clocks, sizeof(long long) * NCLK);
}

// The shared-memory bytes of a launch at block B (float64 when is_f64), -1
// for a block the kernel does not take.
int atlasqtl_inner_gs_smem(int is_f64, int B) {
  if (B <= 0 || B % W != 0) return -1;
  const size_t smem = is_f64 ? smem_bytes<double>(B) : smem_bytes<float>(B);
  return smem > SMEM_MAX ? -1 : (int)smem;
}

// CTAs of the block kernel (the TILES instance when `tiles`; float64 when
// is_f64) resident on one SM at block B (the occupancy calculator), -1 on
// error.
int atlasqtl_inner_gs_occupancy(int is_f64, int tiles, int B) {
  const bool big = B > GS_ROWS;
  if (is_f64) {
    if (tiles) return big ? occupancy<double, true, true>(B)
                          : occupancy<double, false, true>(B);
    return big ? occupancy<double, true, false>(B)
               : occupancy<double, false, false>(B);
  }
  if (tiles) return big ? occupancy<float, true, true>(B)
                        : occupancy<float, false, true>(B);
  return big ? occupancy<float, true, false>(B)
             : occupancy<float, false, false>(B);
}

}  // extern "C"
