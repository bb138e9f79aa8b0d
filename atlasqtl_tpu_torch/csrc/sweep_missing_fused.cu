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
// (86 ms) with W = 8, so it cannot pass 45% of the bound.  No TF32 (the
// reference's products are full f32).
//
// Design:
//  - a CTA of 256 threads (8 warps) owns QS = 32 response columns and walks
//    every window of W predictors in flat order; columns are independent
//    given theta/zeta, so slices never communicate.  Thread (warp g, lane l)
//    owns column l of the rows g, g + 8, ... of its CTA;
//  - on-chip branch (FM_ON_CHIP): the CTA loads its rows of the Fm slice
//    into shared memory once, packs its rows of the observation pattern
//    into one 32-bit word per row, and writes Fm back once at the end, so a
//    window pass touches shared memory only.  The rows are split over a
//    thread-block cluster of CS CTAs (the launch plan picks CS from n and q:
//    ops/sweep_missing_fused.py:missing_launch_plan) so that two CTAs fit on
//    an SM and one's chain overlaps the other's pass: each CTA sums its
//    rows' projections and pair Grams, the CS partial sums are added through
//    distributed shared memory in rank order 0..CS-1 (every CTA gets
//    bit-identical sums), and every CTA runs the same chain and advances
//    its own rows.  No delta is broadcast and no atomics are used: results
//    repeat from run to run;
//  - device-memory branch (!FM_ON_CHIP, chosen by the plan where even the
//    largest cluster cannot hold the slice): Fm stays in device memory,
//    updated in place, and the mask and x are read from device memory on
//    every pass;
//  - one pass over the rows per window does both the advance of the
//    previous window (Fm += m * (x_prev . delta_prev)) and, on the advanced
//    Fm, this window's projections and pair Grams, two rows per warp step
//    so that their shared-memory loads and FMA chains overlap; the warp
//    partials are added in a fixed order into three slots, then summed;
//  - everything a window's chain reads is built per window, not per
//    predictor block: cp, gam, mu and x_norm_sq of the next window arrive
//    by cp.async during the current pass (with, on chip, the next window's
//    x, and with the window's p_mask, theta and rows of L, so that no
//    serial step waits on device memory); after each window's cluster
//    barrier every thread gathers its share of the cluster's sums through
//    distributed shared memory (ranks in order) into local shared memory,
//    so that the chain starts on local values; while warp 0 runs the chain
//    (one lane per column) warps 1-4 turn the next window's staged tiles
//    into its chain operands, two rows each (the logit constant from the
//    interpolation product, 1/den, cp + beta_old x_norm_sq), and warps 5-7
//    build the previous window's Z rows that this rank emits (the rows are
//    split over the cluster's ranks), each warp all of its rows at once so
//    that every node value feeds independent sums; z_row
//    goes to a (n_slices, p) partial buffer reduced by zrow_reduce_kernel,
//    z_col is summed over warps, then ranks, in order;
//  - annealing replicas are a second grid axis: blockIdx.y picks the
//    replica (the cluster stays along x), whose state operands and outputs
//    are its slices of stacked arrays (x, X^T Y, x_norm_sq and the masks
//    are shared).  The per-CTA code is unchanged, so each replica's outputs
//    are those of its own launch with the same cluster bit for bit.
//
// The pair_bf16 instances (SUB = 2, 4, ..., 128; SUB = 0 is the float32 one)
// are the TPU kernel's mis_pair_bf16 mode at its window sub = SUB
// (atlasqtl_tpu/ops/sweep_missing_fused.py:100-215): windows of SUB
// predictors, each projected against Fm as of its start, every pair a > b
// inside one through the masked pair Gram sum_n m_nk bf16(x_na x_nb), Fm
// advanced once per window.  A rounded pair product is formed in f32
// (__fmul_rn, so that it is never contracted into an FMA), rounded to
// bf16 (nearest even) and added under the exact mask in f32; the rounded
// products do not depend on the column.  The kernel keeps its chain
// windows of W = 8, and the windows only decide which pairs are rounded:
//  - SUB <= 8: the pairs of an 8-window inside one SUB-aligned group are
//    rounded, the others keep the f32 pair Gram, which is the f32 advance
//    of the JAX kernel's windows up to rounding;
//  - SUB = 16: each odd 8-window (the second of its 16-window, blocks
//    start at multiples of 16) projects Fm from before the pass's advance
//    by the even one, which is the 16-window's start, and adds
//    sum_n m_nk sum_b bf16(x_na x_nb) delta_b over that window's b
//    (cross_row_update); one row per warp step there, for registers;
//  - SUB = 32, 64, 128 (DEEP): Fm stays as of the SUB-window's start for
//    its SUB / 8 chain windows, the deltas of the whole SUB-window stay in
//    shared memory (SUB x 32 floats), and each chain window j projects Fm
//    as it stands and adds the rounded cross pairs with every earlier chain
//    window 0 .. j-1 of the SUB-window; the next SUB-window's first pass
//    (or the tail) advances Fm by all SUB deltas (deep_pass).  The x rows
//    of the earlier chain windows are read from device memory, where x (n,
//    p) is L2-resident at a block's width: on chip, beside the CTA's Fm
//    rows, they do not fit (nloc x SUB floats).  The pair work per row
//    grows as SUB (8 SUB / 2 rounded products per predictor on average).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int QS = 32;               // response columns per CTA
constexpr int NT = 256;              // threads per CTA
constexpr int NW = NT / 32;          // warps per CTA
constexpr int NSLOT = 2;             // partial slots besides the sum buffer
constexpr int W = 8;                 // chain window (predictors)
constexpr int NP = W * (W - 1) / 2;  // masked pair Grams per window
constexpr int NRH = W + NP;          // per-column sums of one window pass
constexpr int NWT = 4;               // chain operand tiles per window
constexpr int NWS = 3;               // window scalar sets (p_mask, theta, L)
constexpr int BMAX = 128;            // largest predictor block
constexpr int RMAX = 48;             // largest interpolation width (r + 2)
constexpr int SMEM_MAX = 232448;     // shared memory one CTA may take
constexpr int MAX_CLUSTER = 8;       // largest portable cluster (any size 1..8)
constexpr int NCLK = 10;             // phase clock slots of the probe CTA
constexpr int CLKF = (2 * NCLK + 3) & ~3;  // their floats, kept 16-byte whole
constexpr int NOPW = 4;              // warps that build a window's operands
constexpr int ROP = W / NOPW;        // window rows per operand warp
constexpr int NZW = NW - 1 - NOPW;   // warps that build this rank's Z rows
constexpr int RZ = (W + NZW - 1) / NZW;  // most Z rows per warp
static_assert(W % NOPW == 0 && NZW >= 1 && RZ == 3,
              "the chain warp, operand warps and Z warps share the CTA");

// clock64() cycles of CTA 0's thread 0 (rank 0 of slice 0, which runs the
// chain) per phase of the latest launch: the prologue, its own share of the
// window passes, the partial reduction (with the wait for the other warps'
// passes), the cluster barrier, the gather of the cluster's sums, the
// chain, the wait for the next window's x, the wait at the window's last
// barrier for the other warps' tiles, the tail, the whole kernel
// (atlasqtl_sweep_missing_clocks;
// chip_smoke.py's mis_kernel phase prints them beside the eQTL-cut timing)
__device__ long long g_clocks[NCLK];

// floats of one window's scalars: p_mask, theta and the W rows of the
// interpolation basis L
__host__ __device__ constexpr int ws_floats(int R) { return 2 * W + W * R; }

// the deltas a CTA keeps: those of its window, or under a DEEP pair_bf16
// window (SUB > 2 W) those of the whole SUB-window
__host__ __device__ constexpr int delta_rows(int sub) {
  return sub > 2 * W ? sub : W;
}

// shared memory of one CTA: two sets of window operand tiles, two windows
// of masked gam, the deltas (delta_rows), two cluster-visible sum buffers,
// the partial slots, the phase clocks, three sets of window scalars, the
// slice's interpolation nodes; on chip also nloc rows of Fm, two x slots of
// W per row and one mask word per row
size_t smem_bytes(bool on_chip, int nloc, int R, int sub) {
  return sizeof(float) *
         ((size_t)2 * NWT * W * QS + 2 * W * QS + (size_t)delta_rows(sub) * QS +
          2 * NRH * QS +
          NSLOT * NRH * QS + CLKF + NWS * ws_floats(R) + 3 * R * QS +
          (on_chip ? (size_t)nloc * (QS + 2 * W + 1) : 0));
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = ld4(p), b = ld4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Stage x[row0 .. row0 + nr, j .. j + W) into one x slot (W floats per row).
__device__ __forceinline__ void stage_x(float* dst, const float* __restrict__ x,
                                        int row0, int nr, int p, int j,
                                        int tid) {
  for (int e = tid; e < 2 * nr; e += NT) {
    const int t = e >> 1, h = (e & 1) * 4;
    cp_async16(dst + t * W + h, x + (size_t)(row0 + t) * p + j + h);
  }
}

// Stage rows j .. j + W of cp, gam, mu and x_norm_sq for this slice's
// columns into the four tiles of one operand set (one 16-byte copy per
// thread; a ragged slice's missing columns are zeroed), and the window's
// p_mask, theta and rows of L into one scalar set `ws`.
__device__ __forceinline__ void stage_tiles(
    float* wt, float* ws, const float* __restrict__ cp,
    const float* __restrict__ gam_in, const float* __restrict__ mu_in,
    const float* __restrict__ xns, const float* __restrict__ p_mask,
    const float* __restrict__ theta, const float* __restrict__ l_aug, int j,
    int R, int k0, int q, int tid) {
  static_assert(NWT * W * QS / 4 == NT, "one 16-byte copy per thread");
  static_assert(W == 8, "p_mask and theta rows of a window: two copies each");
  if (tid < 4)
    cp_async16(ws + 4 * tid, (tid < 2 ? p_mask : theta) + j + 4 * (tid & 1));
  for (int e = tid; e < W * R / 4; e += NT)
    cp_async16(ws + 2 * W + 4 * e, l_aug + (size_t)j * R + 4 * e);
  const int a = tid / (W * QS / 4), e = tid % (W * QS / 4);
  const int i = e / (QS / 4), kk = (e % (QS / 4)) * 4;
  const float* src = a == 0 ? cp : a == 1 ? gam_in : a == 2 ? mu_in : xns;
  float* dst = wt + a * W * QS + i * QS + kk;
  if (k0 + kk < q)
    cp_async16(dst, src + (size_t)(j + i) * q + k0 + kk);
  else
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The masked pair sums of one row of a window (its x in xv, mask m) into
// v[W ..]: the products of a and b in one RW-aligned group ((a ^ b) < RW)
// rounded to bf16, the others in f32 (RW = 0: none rounded, the float32
// instance).
template <int RW>
__device__ __forceinline__ void pair_sums(const float* xv, float m,
                                          float* v) {
  if constexpr (RW == W) {
    float pr[NP];
    int e = 0;
#pragma unroll
    for (int a = 1; a < W; ++a)
#pragma unroll
      for (int b = 0; b < a; ++b, ++e) pr[e] = __fmul_rn(xv[a], xv[b]);
    static_assert(NP % 2 == 0, "pair products rounded two at a time");
#pragma unroll
    for (int e2 = 0; e2 < NP; e2 += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(pr[e2], pr[e2 + 1]);
      v[W + e2] = fmaf(m, __low2float(h), v[W + e2]);
      v[W + e2 + 1] = fmaf(m, __high2float(h), v[W + e2 + 1]);
    }
  } else {
    float mx[W - 1];
#pragma unroll
    for (int b = 0; b < W - 1; ++b) mx[b] = m * xv[b];
    int e = W;
#pragma unroll
    for (int a = 1; a < W; ++a)
#pragma unroll
      for (int b = 0; b < a; ++b, ++e) {
        if ((a ^ b) < RW)
          v[e] = fmaf(m, __bfloat162float(__float2bfloat16_rn(
                             __fmul_rn(xv[a], xv[b]))), v[e]);
        else
          v[e] = fmaf(xv[a], mx[b], v[e]);
      }
  }
}

// One row of a window pass: ADV advances f by the previous window (x row
// xa, deltas dl: f += m * (xa . dl)); PROJ then adds this window's
// projections and masked pair Grams of the advanced f (x row xp) into v,
// the pair products rounded as pair_sums<RW>.  Returns the new f.
template <bool ADV, bool PROJ, int RW>
__device__ __forceinline__ float row_update(float f, float m,
                                            const float* xa, const float* xp,
                                            const float* dl, float* v) {
  if (ADV) {
    float xv[W];
    load8(xa, xv);
    float s = xv[0] * dl[0];
#pragma unroll
    for (int i = 1; i < W; ++i) s = fmaf(xv[i], dl[i], s);
    f = fmaf(m, s, f);
  }
  if (PROJ) {
    float xv[W];
    load8(xp, xv);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = fmaf(xv[i], f, v[i]);
    pair_sums<RW>(xv, m, v);
  }
  return f;
}

// One row of the pass of an odd 8-window under SUB = 16: advance f by the
// previous (even) window as row_update does, but project this window (x
// row xp) against f from before that advance, the 16-window's start, and
// add the rounded cross pairs with the even window (x row xa, deltas dl),
// m sum_b bf16(x_a x_b) delta_b, beside this window's own rounded pairs.
// Returns the advanced f.
__device__ __forceinline__ float cross_row_update(float f, float m,
                                                  const float* xa,
                                                  const float* xp,
                                                  const float* dl, float* v) {
  float xb[W], xv[W];
  load8(xa, xb);
  float s = xb[0] * dl[0];
#pragma unroll
  for (int i = 1; i < W; ++i) s = fmaf(xb[i], dl[i], s);
  load8(xp, xv);
#pragma unroll
  for (int a = 0; a < W; ++a) {
    float t = 0.f;
#pragma unroll
    for (int b = 0; b < W; b += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          __fmul_rn(xv[a], xb[b]), __fmul_rn(xv[a], xb[b + 1]));
      t = fmaf(__low2float(h), dl[b], t);
      t = fmaf(__high2float(h), dl[b + 1], t);
    }
    v[a] = fmaf(m, t, fmaf(xv[a], f, v[a]));
  }
  pair_sums<W>(xv, m, v);
  return fmaf(m, s, f);
}

// One pass over this CTA's rows under a DEEP pair_bf16 window (SUB > 2 W).
// jadv >= 0: first advance Fm by the SUB deltas in D_s of the SUB-window
// that starts at predictor jadv (f += m * sum_b x_b delta_b, x from device
// memory).  proj: then add this chain window's projections (x in xp, as
// window_pass) of Fm as it stands, the start of its SUB-window (first
// predictor jS), the rounded cross pairs with the ncross earlier chain
// windows of that SUB-window (m sum_b bf16(x_a x_b) delta_b, x from device
// memory, deltas in D_s) and its own rounded pairs into v.  One row per
// warp step, for registers.
template <bool ON_CHIP, int SUB>
__device__ __forceinline__ void deep_pass(
    float* __restrict__ fm_s, const unsigned* __restrict__ mb_s,
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ x, const float* __restrict__ xp,
    const float* __restrict__ D_s, float* __restrict__ v, int row0, int nr,
    int p, int q, int k, bool cvalid, int warp, int lane, int jadv,
    bool proj, int jS, int ncross) {
  static_assert(SUB > 2 * W && SUB % W == 0, "a DEEP pair_bf16 window");
#pragma unroll
  for (int e = 0; e < NRH; ++e) v[e] = 0.f;
  if (!ON_CHIP && !cvalid) return;
  const size_t xs = ON_CHIP ? W : (size_t)p;  // row stride of the x window
  for (int t = warp; t < nr; t += NW) {
    float& fr = ON_CHIP ? fm_s[t * QS + lane] : fm[(size_t)t * q + k];
    const float m = ON_CHIP ? ((mb_s[t] >> lane) & 1u ? 1.f : 0.f)
                            : mask[(size_t)t * q + k];
    const float* xrow = x + (size_t)(row0 + t) * p;
    float f = fr;
    if (jadv >= 0) {
      float s = 0.f;
#pragma unroll 1
      for (int c = 0; c < SUB; c += W) {
        float xb[W];
        load8(xrow + jadv + c, xb);
#pragma unroll
        for (int i = 0; i < W; ++i) s = fmaf(xb[i], D_s[(c + i) * QS + lane], s);
      }
      f = fmaf(m, s, f);
      fr = f;
    }
    if (!proj) continue;
    float xv[W], tt[W];
    load8(xp + t * xs, xv);
#pragma unroll
    for (int a = 0; a < W; ++a) tt[a] = 0.f;
#pragma unroll 1
    for (int c = 0; c < ncross * W; c += W) {
      float xb[W], dl[W];
      load8(xrow + jS + c, xb);
#pragma unroll
      for (int b = 0; b < W; ++b) dl[b] = D_s[(c + b) * QS + lane];
#pragma unroll
      for (int a = 0; a < W; ++a)
#pragma unroll
        for (int b = 0; b < W; b += 2) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              __fmul_rn(xv[a], xb[b]), __fmul_rn(xv[a], xb[b + 1]));
          tt[a] = fmaf(__low2float(h), dl[b], tt[a]);
          tt[a] = fmaf(__high2float(h), dl[b + 1], tt[a]);
        }
    }
#pragma unroll
    for (int a = 0; a < W; ++a) v[a] = fmaf(m, tt[a], fmaf(xv[a], f, v[a]));
    pair_sums<W>(xv, m, v);
  }
}

// One pass over this CTA's rows: ADV advances Fm by the previous window
// (x in xa, deltas in D_s); PROJ then accumulates this window's projections
// and masked pair Grams (x in xp) on the advanced Fm into v (CROSS: the
// rows of cross_row_update).  On chip, xa and xp are x slots and Fm lives
// in fm_s; otherwise they point into x at the windows' first columns and Fm
// is the device slice at fm.  Each warp takes two rows per step, both read
// before either is written back, so their loads and FMA chains overlap
// (CROSS: one).
template <bool ON_CHIP, bool ADV, bool PROJ, int RW, bool CROSS = false>
__device__ __forceinline__ void window_pass(
    float* __restrict__ fm_s, const unsigned* __restrict__ mb_s,
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ xa, const float* __restrict__ xp,
    const float* __restrict__ D_s, float* __restrict__ v, int nr, int p,
    int q, int k, bool cvalid, int warp, int lane) {
  float dl[W];
#pragma unroll
  for (int i = 0; i < W; ++i) dl[i] = ADV ? D_s[i * QS + lane] : 0.f;
#pragma unroll
  for (int e = 0; e < NRH; ++e) v[e] = 0.f;
  if (!ON_CHIP && !cvalid) return;
  const size_t xs = ON_CHIP ? W : (size_t)p;  // row stride of the x windows
  auto fm_at = [&](int t) -> float& {
    return ON_CHIP ? fm_s[t * QS + lane] : fm[(size_t)t * q + k];
  };
  auto m_at = [&](int t) {
    return ON_CHIP ? ((mb_s[t] >> lane) & 1u ? 1.f : 0.f)
                   : mask[(size_t)t * q + k];
  };
  int t = warp;
  if constexpr (CROSS) {
    static_assert(ADV && PROJ && RW == W, "a cross pass advances, projects "
                  "and rounds its 8-window's pairs");
    for (; t < nr; t += NW)
      fm_at(t) = cross_row_update(fm_at(t), m_at(t), xa + t * xs,
                                  xp + t * xs, dl, v);
    return;
  }
  for (; t + NW < nr; t += 2 * NW) {
    const int u = t + NW;
    float f0 = fm_at(t), f1 = fm_at(u);
    const float m0 = m_at(t), m1 = m_at(u);
    f0 = row_update<ADV, PROJ, RW>(f0, m0, xa + t * xs, xp + t * xs, dl, v);
    f1 = row_update<ADV, PROJ, RW>(f1, m1, xa + u * xs, xp + u * xs, dl, v);
    if (ADV) {
      fm_at(t) = f0;
      fm_at(u) = f1;
    }
  }
  if (t < nr) {
    const float f = row_update<ADV, PROJ, RW>(fm_at(t), m_at(t), xa + t * xs,
                                              xp + t * xs, dl, v);
    if (ADV) fm_at(t) = f;
  }
}

// What the chain reads of one window, built by the warps that do not run
// it, NR rows per warp (rows i0 .. i0 + NR of the window, its scalars in
// ws): in place of the staged (cp, gam, mu, x_norm_sq) of row i, for this
// thread's column, (cp + beta_old x_norm_sq, beta_old, 1 / den, ad), ad
// being c d(u) + (L_j . N_ad) - (c/2) log(den).  Each node value feeds the
// NR rows' independent sums.
template <int NR>
__device__ __forceinline__ void chain_operands(
    float* wt, const float* __restrict__ N_s, const float* __restrict__ ws,
    int i0, int R, int lane, float zeta_k, float c, float half_c,
    float sig2_inv) {
  float dot[NR];
#pragma unroll
  for (int a = 0; a < NR; ++a) dot[a] = 0.f;
  const float* l0 = ws + 2 * W + i0 * R;
#pragma unroll 2
  for (int rr = 0; rr < R; ++rr) {
    const float nv = N_s[rr * QS + lane];
#pragma unroll
    for (int a = 0; a < NR; ++a) dot[a] = fmaf(l0[a * R + rr], nv, dot[a]);
  }
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int e = (i0 + a) * QS + lane;
    const float bo = wt[W * QS + e] * wt[2 * W * QS + e];
    const float xn = wt[3 * W * QS + e];
    const float den = xn + sig2_inv;
    const float u = ws[W + i0 + a] + zeta_k;
    const float sd = sqrtf(u * u + K_BASE);
    wt[e] = wt[e] + bo * xn;
    wt[W * QS + e] = bo;
    wt[2 * W * QS + e] = __frcp_rn(den);
    wt[3 * W * QS + e] = c * (0.5f * u * sd) + dot[a] - half_c * __logf(den);
  }
}

// NR rows of Z = (gam * imrd + imr0u) * mask, rows i0, i0 + step, ... of
// the window (gam in gw, scalars in ws, predictors j0 ..): the cell of this
// thread's column (added to zc) and, from lane 0, the row's sum over the
// slice.  Each node value feeds the NR rows' independent sums.
template <int NR>
__device__ __forceinline__ void z_rows(
    const float* __restrict__ gw, const float* __restrict__ N_s,
    const float* __restrict__ ws, float* __restrict__ zrow_part, int j0,
    int i0, int step, int R, int p, int slice, int lane, float zeta_k,
    float qm_k, float kz, float& zc) {
  float d1[NR], d2[NR];
#pragma unroll
  for (int a = 0; a < NR; ++a) d1[a] = d2[a] = 0.f;
  const float* l0 = ws + 2 * W + i0 * R;
#pragma unroll 2
  for (int rr = 0; rr < R; ++rr) {
    const float n1 = N_s[(R + rr) * QS + lane];
    const float n2 = N_s[(2 * R + rr) * QS + lane];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const float l = l0[a * step * R + rr];
      d1[a] = fmaf(l, n1, d1[a]);
      d2[a] = fmaf(l, n2, d2[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int i = i0 + a * step;
    const float u = ws[W + i] + zeta_k;
    const float sz = sqrtf(u * u + kz);
    const float imrd = sz + d1[a];
    const float imr0u = d2[a] - 0.5f * (sz + u);
    float z = (gw[i * QS + lane] * imrd + imr0u) * (ws[i] * qm_k);
    zc += z;
    z += __shfl_xor_sync(0xffffffffu, z, 16);
    z += __shfl_xor_sync(0xffffffffu, z, 8);
    z += __shfl_xor_sync(0xffffffffu, z, 4);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    if (lane == 0) zrow_part[(size_t)slice * p + j0 + i] = z;
  }
}

// The Z rows this rank emits (i % cs == rank), dealt over the NZW Z warps:
// warp h takes the h-th, (h + NZW)-th, ... of them, so that no warp sums a
// row another rank emits.
__device__ __forceinline__ void z_rows_of_rank(
    int h, const float* __restrict__ gw, const float* __restrict__ N_s,
    const float* __restrict__ ws, float* __restrict__ zrow_part, int j0,
    int cs, int rank, int R, int p, int slice, int lane, float zeta_k,
    float qm_k, float kz, float& zc) {
  const int i0 = rank + cs * h, step = cs * NZW;
  if (i0 >= W) return;
  const int nr = (W - 1 - i0) / step + 1;
  if (nr == 1)
    z_rows<1>(gw, N_s, ws, zrow_part, j0, i0, step, R, p, slice, lane,
              zeta_k, qm_k, kz, zc);
  else if (nr == 2)
    z_rows<2>(gw, N_s, ws, zrow_part, j0, i0, step, R, p, slice, lane,
              zeta_k, qm_k, kz, zc);
  else
    z_rows<RZ>(gw, N_s, ws, zrow_part, j0, i0, step, R, p, slice, lane,
               zeta_k, qm_k, kz, zc);
}

// SUB: 0 for the float32 instance, else the pair_bf16 window (2, 4, ..., 128)
template <bool FM_ON_CHIP, int SUB>
__global__ void __launch_bounds__(NT, 2) sweep_missing_kernel(
    const float* __restrict__ x,        // (n, p)
    const float* __restrict__ cp,       // (p, q)
    const float* __restrict__ gam_in,   // (p, q)
    const float* __restrict__ mu_in,    // (p, q)
    const float* __restrict__ xns,      // (p, q) x_norm_sq
    const float* __restrict__ mask,     // (n, q) observation pattern, 0/1
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
    int n, int p, int q, int R, int nloc) {
  static_assert(SUB == 0 || SUB == 2 || SUB == 4 || SUB == W || SUB == 2 * W ||
                    SUB == 4 * W || SUB == 8 * W || SUB == 16 * W,
                "the float32 instance or a pair_bf16 window");
  // pairs rounded within RW-aligned groups of an 8-window; CROSS: odd
  // 8-windows take the cross pass; DEEP: chain windows of a SUB-window
  // take deep_pass, J of them
  constexpr int RW = SUB < W ? SUB : W;
  constexpr bool CROSS = SUB == 2 * W;
  constexpr bool DEEP = SUB > 2 * W;
  constexpr int J = DEEP ? SUB / W : 1;
  extern __shared__ __align__(16) float smem[];
  float* WT_s = smem;                       // 2 x NWT x W x QS window tiles
  float* GW_s = WT_s + 2 * NWT * W * QS;    // 2 x W x QS masked new gam
  float* D_s = GW_s + 2 * W * QS;           // deltas: latest window (DEEP:
                                            // its SUB-window), x QS
  float* RH_s = D_s + delta_rows(SUB) * QS; // 2 x NRH x QS this CTA's sums
  float* PART_s = RH_s + 2 * NRH * QS;      // NSLOT x NRH x QS warp partials
  long long* CLK_s = reinterpret_cast<long long*>(PART_s + NSLOT * NRH * QS);
  float* WS_s = PART_s + NSLOT * NRH * QS + CLKF;  // NWS window scalars
  float* N_s = WS_s + NWS * ws_floats(R);   // 3 x R x QS interpolation nodes
  float* FM_s = N_s + 3 * R * QS;           // nloc x QS Fm rows
  float* XS_s = FM_s + nloc * QS;                      // 2 x nloc x W x
  unsigned* MB_s = reinterpret_cast<unsigned*>(XS_s + 2 * nloc * W);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // blockIdx.y is the replica: every operand of the state and every output
  // is one replica's slice of a stacked array
  {
    const size_t r = blockIdx.y, pq = (size_t)p * q;
    gam_in += r * pq;
    mu_in += r * pq;
    l_aug += r * (size_t)p * R;
    n_stack += r * 3 * (size_t)R * q;
    fm += r * (size_t)n * q;
    theta += r * p;
    zeta += r * q;
    tauv += r * q;
    scal += r * 3;
    gam_out += r * pq;
    mu_out += r * pq;
    zrow_part += r * (gridDim.x / cs) * (size_t)p;
    z_col += r * q;
  }
  const int slice = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = slice * QS;
  const int k = k0 + lane;
  const bool cvalid = k < q;
  const int row0 = FM_ON_CHIP ? rank * nloc : 0;
  const int nr = FM_ON_CHIP ? max(0, min(n, row0 + nloc) - row0) : n;
  const float c = scal[0], kz = scal[1], sig2_inv = scal[2];
  const float half_c = 0.5f * c;
  const float zeta_k = cvalid ? zeta[k] : 0.f;
  const float qm_k = cvalid ? q_mask[k] : 0.f;
  const float c2tau = 0.5f * c * c * (cvalid ? tauv[k] : 1.f);
  float* fm_rows = fm + (size_t)row0 * q;
  const float* mask_rows = mask + (size_t)row0 * q;
  const int nwin = p / W;
  const int WSF = ws_floats(R);

  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;
  if (probe)
    for (int e = 0; e < NCLK; ++e) CLK_s[e] = 0;
  const long long clk0 = clock64();
  long long clk = clk0;
  auto tick = [&](int slot) {  // the probe thread's cycles since the last tick
    if (probe) {
      const long long t = clock64();
      CLK_s[slot] += t - clk;
      clk = t;
    }
  };

  // ---- prologue: nodes, Fm rows and mask bits, window 0's operands ------
  for (int e = tid; e < 3 * R * QS; e += NT) {
    const int kk = e % QS, mr = e / QS;
    N_s[e] = (k0 + kk < q) ? n_stack[(size_t)mr * q + k0 + kk] : 0.f;
  }
  if (FM_ON_CHIP) {
    for (int t = warp; t < nr; t += NW) {
      const size_t off = (size_t)t * q + k;
      FM_s[t * QS + lane] = cvalid ? fm_rows[off] : 0.f;
      const unsigned bits =
          __ballot_sync(0xffffffffu, cvalid && mask_rows[off] != 0.f);
      if (lane == 0) MB_s[t] = bits;
    }
    stage_x(XS_s, x, row0, nr, p, 0, tid);
  }
  stage_tiles(WT_s, WS_s, cp, gam_in, mu_in, xns, p_mask, theta, l_aug, 0, R,
              k0, q, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp < NOPW)
    chain_operands<ROP>(WT_s, N_s, WS_s, ROP * warp, R, lane, zeta_k, c,
                        half_c, sig2_inv);
  float zc = 0.f;
  float v[NRH];
  tick(0);

  for (int w = 0; w < nwin; ++w) {
    const int jw = w * W;
    float* wt = WT_s + (w & 1) * NWT * W * QS;        // this window's
    float* wt_next = WT_s + ((w + 1) & 1) * NWT * W * QS;
    // this window's, the next's and the previous window's scalar sets
    const float* ws = WS_s + (w % NWS) * WSF;
    float* ws_next = WS_s + ((w + 1) % NWS) * WSF;
    const float* ws_prev = WS_s + ((w + NWS - 1) % NWS) * WSF;
    // the next window's cp, gam, mu, x_norm_sq (its set was last read by
    // the previous window's chain) and scalars (last read two windows ago)
    if (w + 1 < nwin)
      stage_tiles(wt_next, ws_next, cp, gam_in, mu_in, xns, p_mask, theta,
                  l_aug, jw + W, R, k0, q, tid);
    cp_async_commit();

    // advance by the previous window (if any), project this one
    const float* xa = FM_ON_CHIP ? XS_s + ((w + 1) & 1) * nloc * W
                                 : x + (jw - W);
    const float* xp = FM_ON_CHIP ? XS_s + (w & 1) * nloc * W : x + jw;
    if constexpr (DEEP) {
      const int j = w % J;  // this chain window's place in its SUB-window
      deep_pass<FM_ON_CHIP, SUB>(FM_s, MB_s, fm_rows, mask_rows, x, xp, D_s,
                                 v, row0, nr, p, q, k, cvalid, warp, lane,
                                 j == 0 && w > 0 ? jw - SUB : -1, true,
                                 jw - j * W, j);
    } else if (w == 0) {
      window_pass<FM_ON_CHIP, false, true, RW>(FM_s, MB_s, fm_rows,
                                               mask_rows, xa, xp, D_s, v, nr,
                                               p, q, k, cvalid, warp, lane);
    } else if constexpr (CROSS) {
      if (w & 1)
        window_pass<FM_ON_CHIP, true, true, RW, true>(
            FM_s, MB_s, fm_rows, mask_rows, xa, xp, D_s, v, nr, p, q, k,
            cvalid, warp, lane);
      else
        window_pass<FM_ON_CHIP, true, true, RW>(
            FM_s, MB_s, fm_rows, mask_rows, xa, xp, D_s, v, nr, p, q, k,
            cvalid, warp, lane);
    } else {
      window_pass<FM_ON_CHIP, true, true, RW>(FM_s, MB_s, fm_rows, mask_rows,
                                              xa, xp, D_s, v, nr, p, q, k,
                                              cvalid, warp, lane);
    }
    tick(1);
    // the warps' sums in a fixed order into three slots, the two partial
    // slots and this window's sum buffer (its peers last read it two
    // windows ago): warps 5-7 write, warps 2-4 add, warps 0-1 add
    float* rh = RH_s + (w & 1) * NRH * QS;
    {
      const int sl = warp >= 5 ? warp - 5 : warp >= 2 ? warp - 2 : warp;
      float* dst = (sl == NSLOT ? rh : PART_s + sl * NRH * QS) + lane;
      if (warp >= 5)
#pragma unroll
        for (int e = 0; e < NRH; ++e) dst[e * QS] = v[e];
      __syncthreads();
      // the next window's x goes to the slot this pass advanced from
      if (FM_ON_CHIP && w + 1 < nwin)
        stage_x(XS_s + ((w + 1) & 1) * nloc * W, x, row0, nr, p, jw + W, tid);
      cp_async_commit();
      cp_async_wait<1>();  // the next window's tiles have landed
      if (warp >= 2 && warp < 5)
#pragma unroll
        for (int e = 0; e < NRH; ++e) dst[e * QS] = v[e] + dst[e * QS];
      __syncthreads();
      if (warp < 2)
#pragma unroll
        for (int e = 0; e < NRH; ++e) dst[e * QS] = v[e] + dst[e * QS];
      __syncthreads();
    }
    for (int e = tid; e < NRH * QS; e += NT)
      rh[e] = (PART_s[e] + PART_s[NRH * QS + e]) + rh[e];
    tick(2);
    // every CTA of the cluster has its sums; the other buffer is free
    // because every CTA read it before arriving here
    cluster.sync();
    tick(3);
    // the cluster's sums value by value, ranks in order (bit-identical in
    // every CTA), gathered by every thread, its loads of all ranks in flight
    // together, into the first partial slot (free until the next window's
    // reduction)
    {
      constexpr int NV = (NRH * QS + NT - 1) / NT;  // values per thread
      float sum[NV];
      const float* r0 = cluster.map_shared_rank(rh, 0);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = tid + i * NT;
        sum[i] = e < NRH * QS ? r0[e] : 0.f;
      }
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r) {
        if (r < cs) {
          const float* src = cluster.map_shared_rank(rh, r);
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int e = tid + i * NT;
            if (e < NRH * QS) sum[i] += src[e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = tid + i * NT;
        if (e < NRH * QS) PART_s[e] = sum[i];
      }
    }
    __syncthreads();
    tick(4);

    if (warp == 0) {
      // ---- the sequential chain of the window, one lane per column ------
      float rr[W], hh[NP];
#pragma unroll
      for (int e = 0; e < NRH; ++e) {
        const float sum = PART_s[e * QS + lane];
        if (e < W)
          rr[e] = sum;
        else
          hh[e - W] = sum;
      }
      float* gw = GW_s + (w & 1) * W * QS;
      // DEEP: this window's rows of the SUB-window's deltas
      float* dw = D_s + (DEEP ? (w % J) * W * QS : 0);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int e = i * QS + lane;
        const float bo = wt[W * QS + e];
        const float d = wt[e] - rr[i];  // cp - (r - beta_old x_norm_sq)
        const float mu = wt[2 * W * QS + e] * d;
        const float logit = wt[3 * W * QS + e] + c2tau * (mu * d);
        const float gam = __fdividef(1.f, 1.f + __expf(-logit));
        const float delta = gam * mu - bo;
        dw[e] = delta;
#pragma unroll
        for (int a = i + 1; a < W; ++a)
          rr[a] += hh[a * (a - 1) / 2 + i] * delta;
        const float msk = ws[i] * qm_k;
        gw[e] = gam * msk;
        if (cvalid && rank == 0) {
          const size_t off = (size_t)(jw + i) * q + k;
          gam_out[off] = gam * msk;
          mu_out[off] = mu * msk;
        }
      }
      tick(5);
    } else {
      // ---- meanwhile: the next window's operands (warps 1 .. NOPW, ROP
      // rows each), this rank's Z rows of the last window (the others) ----
      if (warp <= NOPW) {
        if (w + 1 < nwin)
          chain_operands<ROP>(wt_next, N_s, ws_next, ROP * (warp - 1), R,
                              lane, zeta_k, c, half_c, sig2_inv);
      } else if (w > 0) {
        z_rows_of_rank(warp - 1 - NOPW, GW_s + ((w + 1) & 1) * W * QS, N_s,
                       ws_prev, zrow_part, jw - W, cs, rank, R, p, slice,
                       lane, zeta_k, qm_k, kz, zc);
      }
    }
    cp_async_wait<0>();  // the next window's x has landed
    tick(6);
    __syncthreads();
    tick(7);
  }

  // ---- tail: the last window's Z and advance, Fm back, z_col ------------
  if (warp < NZW)
    z_rows_of_rank(warp, GW_s + ((nwin - 1) & 1) * W * QS, N_s,
                   WS_s + ((nwin - 1) % NWS) * WSF, zrow_part, p - W, cs,
                   rank, R, p, slice, lane, zeta_k, qm_k, kz, zc);
  if constexpr (DEEP)
    deep_pass<FM_ON_CHIP, SUB>(FM_s, MB_s, fm_rows, mask_rows, x, nullptr,
                               D_s, v, row0, nr, p, q, k, cvalid, warp, lane,
                               p - SUB, false, 0, 0);
  else
    window_pass<FM_ON_CHIP, true, false, RW>(
        FM_s, MB_s, fm_rows, mask_rows,
        FM_ON_CHIP ? XS_s + ((nwin - 1) & 1) * nloc * W : x + (p - W),
        nullptr, D_s, v, nr, p, q, k, cvalid, warp, lane);
  if (FM_ON_CHIP && cvalid)
    for (int t = warp; t < nr; t += NW)
      fm_rows[(size_t)t * q + k] = FM_s[t * QS + lane];
  PART_s[warp * QS + lane] = zc;
  __syncthreads();
  if (tid < QS) {  // this CTA's column sums, warps in order
    float s = 0.f;
    for (int g = 0; g < NW; ++g) s += PART_s[g * QS + tid];
    D_s[tid] = s;
  }
  cluster.sync();
  if (rank == 0 && tid < QS && k0 + tid < q) {  // ranks in order
    float s = 0.f;
    for (int r = 0; r < cs; ++r) s += cluster.map_shared_rank(D_s, r)[tid];
    z_col[k0 + tid] = s;
  }
  tick(8);
  if (probe) {
    CLK_s[NCLK - 1] = clock64() - clk0;
    for (int e = 0; e < NCLK; ++e) g_clocks[e] = CLK_s[e];
  }
  cluster.sync();  // no CTA leaves while a peer may still read its sums
}

template <bool FM_ON_CHIP, int SUB>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(sweep_missing_kernel<FM_ON_CHIP, SUB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// sets the instance's shared memory and launches it on the config
template <bool FM_ON_CHIP, int SUB, typename... Args>
cudaError_t launch_instance(const cudaLaunchConfig_t& cfg, Args... args) {
  const cudaError_t err = set_smem<FM_ON_CHIP, SUB>(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, sweep_missing_kernel<FM_ON_CHIP, SUB>,
                            args...);
}

// the instance of (fm_on_chip, sub) launched on the config
template <typename... Args>
cudaError_t launch_sub(bool on_chip, int sub, const cudaLaunchConfig_t& cfg,
                       Args... args) {
#define ATLASQTL_MIS_SUB(S)                                        \
  case S:                                                          \
    return on_chip ? launch_instance<true, S>(cfg, args...)        \
                   : launch_instance<false, S>(cfg, args...)
  switch (sub) {
    ATLASQTL_MIS_SUB(0);
    ATLASQTL_MIS_SUB(2);
    ATLASQTL_MIS_SUB(4);
    ATLASQTL_MIS_SUB(W);
    ATLASQTL_MIS_SUB(2 * W);
    ATLASQTL_MIS_SUB(4 * W);
    ATLASQTL_MIS_SUB(8 * W);
    ATLASQTL_MIS_SUB(16 * W);
    default:
      return cudaErrorInvalidValue;
  }
#undef ATLASQTL_MIS_SUB
}

cudaLaunchConfig_t launch_config(int grid, int m, int smem, int cluster,
                                 cudaLaunchAttribute* attr, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, m);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the shared-memory bytes of a CTA of the instance `sub` under the plan
// (cluster, fm_on_chip) at n samples and interpolation width R, or -1 where
// the kernel cannot take it
int plan_smem(int n, int cluster, int fm_on_chip, int R, int sub) {
  if (n <= 0 || R <= 0 || R > RMAX || cluster < 1 || cluster > MAX_CLUSTER ||
      (!fm_on_chip && cluster != 1))
    return -1;
  const int nloc = fm_on_chip ? (n + cluster - 1) / cluster : 0;
  const size_t smem = smem_bytes(fm_on_chip != 0, nloc, R, sub);
  return smem <= SMEM_MAX ? (int)smem : -1;
}

}  // namespace

extern "C" {

// Launches the exact-missing sweeps of m replicas (the sweep kernel on a
// grid of (slices x cluster) x m, then the z_row reduction) on `stream`
// with the decisions of ops/sweep_missing_fused.py:missing_launch_plan: the
// cluster size and whether Fm is on chip; the kernel derives its rows per
// CTA, grid and shared memory from them.  The operands of the state and the
// outputs are m stacked arrays; x, X^T Y, x_norm_sq, the mask and the
// p/q masks are shared.  sub = 0 launches the float32 instance, sub = 2,
// 4, ..., 128 the pair_bf16 instance at that window (B, and so p, a
// multiple of it).
// Returns the CUDA error code of the launches (0 on success);
// cudaErrorInvalidValue for a shape, plan or window it does not take.
int atlasqtl_sweep_missing_fused(
    const float* x, const float* cp, const float* gam_in, const float* mu_in,
    const float* xns, const float* mask, const float* l_aug,
    const float* n_stack, float* fm, const float* theta, const float* p_mask,
    const float* zeta, const float* q_mask, const float* tauv,
    const float* scal, float* gam_out, float* mu_out, float* zrow_part,
    float* z_row, float* z_col, int n, int p, int q, int B, int R,
    int cluster, int fm_on_chip, int m, int sub, void* stream) {
  const int n_slices = (q + QS - 1) / QS;
  const int nloc = fm_on_chip ? (n + cluster - 1) / cluster : 0;
  const int grid = n_slices * cluster;
  const int smem = plan_smem(n, cluster, fm_on_chip, R, sub);
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || q % 4 != 0 ||
      smem < 0 || m < 1 || m > 65535 || sub < 0 || (sub && B % sub != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(grid, m, smem, cluster, attr, st);
  cudaError_t err = launch_sub(fm_on_chip != 0, sub, cfg, x, cp, gam_in,
                               mu_in, xns, mask, l_aug, n_stack, fm, theta,
                               p_mask, zeta, q_mask, tauv, scal, gam_out,
                               mu_out, zrow_part, z_col, n, p, q, R, nloc);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<dim3((p + 255) / 256, m), 256, 0, st>>>(
      zrow_part, z_row, n_slices, p);
  return (int)cudaGetLastError();
}

int atlasqtl_sweep_missing_window() { return W; }

// Copies the probe's NCLK phase clocks of the latest launch to `out`
// (host memory); returns the CUDA error code.
int atlasqtl_sweep_missing_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * NCLK);
}

// The shared-memory bytes of one CTA of the instance `sub` under the plan
// (cluster, fm_on_chip) at n samples and interpolation width R; -1 for a
// plan the kernel does not take (the card checks
// ops/sweep_missing_fused.py:_mis_smem_bytes against it).
int atlasqtl_sweep_missing_smem(int n, int cluster, int fm_on_chip, int R,
                                int sub) {
  return plan_smem(n, cluster, fm_on_chip, R, sub);
}

// CTAs of the sweep kernel resident on one SM and clusters resident on the
// card under the plan (cluster, fm_on_chip) at n samples and interpolation
// width R, at the shared memory of the instance `sub` (the occupancy
// calculator, on the float32 instance: every instance keeps to the same
// register bound), each -1 on error.
int atlasqtl_sweep_missing_occupancy(int n, int cluster, int fm_on_chip,
                                     int R, int sub, int* clusters) {
  *clusters = -1;
  const int smem = plan_smem(n, cluster, fm_on_chip, R, sub);
  if (smem < 0) return -1;
  cudaError_t err = fm_on_chip ? set_smem<true, 0>(smem)
                               : set_smem<false, 0>(smem);
  int nb = -1;
  if (err == cudaSuccess)
    err = fm_on_chip ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &nb, sweep_missing_kernel<true, 0>, NT, smem)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &nb, sweep_missing_kernel<false, 0>, NT, smem);
  if (err != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster * 64, 1, smem, cluster, attr, nullptr);
  err = fm_on_chip ? cudaOccupancyMaxActiveClusters(
                         clusters, sweep_missing_kernel<true, 0>, &cfg)
                   : cudaOccupancyMaxActiveClusters(
                         clusters, sweep_missing_kernel<false, 0>, &cfg);
  if (err != cudaSuccess) *clusters = -1;
  return nb;
}

}  // extern "C"
