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
// inside one through the masked pair Gram H[(a, b), k] = sum_n m_nk
// bf16(x_na x_nb), Fm advanced once per window.  A rounded pair product is
// formed in f32 (__fmul_rn, never contracted into an FMA) and rounded to
// bf16 (nearest even); the mask is exact in bf16.  Under the mode the pair
// Grams are the function's largest term, (SUB - 1) n p q operations per
// sweep, which the JAX kernel takes as one MXU product (_pair_dot,
// :127-145).  The kernel keeps its chain windows of W = 8:
//  - SUB = 2, 4: only the pairs of one SUB-aligned group of an 8-window are
//    rounded, the others keep the f32 pair Gram (the f32 advance of the JAX
//    kernel's windows up to rounding); these keep the float32 instance's
//    SIMT pair sums, each lane rounding its own products (pair_sums);
//  - SUB >= 8 (TC): every pair of an 8-window is rounded, and the pair
//    Grams run on the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32:
//    A is 16 pairs x 16 samples of rounded products, B 16 samples x 8
//    columns of the exact mask (built from the packed mask bits on chip,
//    from the mask rows in device memory), the slice's 32 columns four n8
//    tiles.  The warps split the samples (chunks of KC = 16 rows, dealt
//    round robin), so each rounded product is formed once per CTA, straight
//    into its A fragment, and the warp partials are added in the fixed slot
//    order of the f32 sums.  The 28 pairs of the 8-window (window_grams)
//    feed the chain through the cluster sum, as the f32 pair sums do; each
//    thread's A rows pair its own x_g with a partner, and its B columns
//    are four adjacent mask bits (the n8 tiles' columns are permuted), so
//    that a fragment costs few loads.  The window's pair sums go through
//    the slots in phases of their own, before the cross pairs, so that
//    their 32 accumulators are dead by then (128 registers: two CTAs per
//    SM; in device memory from SUB = 16 on, with more 64-bit addresses
//    live, one CTA per SM);
//  - SUB = 16: each odd 8-window (the second of its 16-window; blocks start
//    at multiples of 16) projects Fm from before the pass's advance by the
//    even one, the 16-window's start, and needs its cross pairs with the
//    even window only as sum_b H[(a, b), k] delta_bk.  Those deltas are
//    known before the pass, so each warp contracts its partial H tiles with
//    them in f32 registers (cross_grams) and adds the result to its
//    projections, which ride the cluster sum: no cross-pair tile is kept in
//    shared memory;
//  - SUB = 32, 64, 128 (DEEP): Fm stays as of the SUB-window's start for
//    its SUB / 8 chain windows, whose deltas stay in shared memory (SUB x 32
//    floats); chain window j projects Fm as it stands and contracts its
//    cross pairs with every earlier chain window of the SUB-window as
//    above; the next SUB-window's first pass (or the tail) advances Fm by
//    all SUB deltas in f32 (deep_rows, x from device memory).  The cross
//    pairs need the earlier windows' x in f32 for the CTA's rows, nloc x
//    SUB floats (128 KB at nloc 250 and SUB 128), which do not fit beside
//    Fm.  Each warp stages them by cp.async, KC rows x 8 predictors at a
//    time, through a two-stage ring in the x slot that the deep pass does
//    not read (the previous window's, made at least RING_ROWS rows): one
//    stage lands while the other is multiplied.  A larger cluster would
//    hold fewer rows per CTA but repeat the chain in more CTAs, so the
//    cluster stays the plan's.
// The float32 parts (the projections, the masked advance, the chain, the Z
// rows) stay in f32 on the FP32 pipe: the JAX kernel's products there are
// f32 under the mode.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

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
constexpr int NCLK = 11;             // phase clock slots of the probe CTA
// their floats with the probe's start and latest tick, kept 16-byte whole
constexpr int CLKF = (2 * (NCLK + 2) + 3) & ~3;
constexpr int NOPW = 4;              // warps that build a window's operands
constexpr int ROP = W / NOPW;        // window rows per operand warp
constexpr int NZW = NW - 1 - NOPW;   // warps that build this rank's Z rows
constexpr int RZ = (W + NZW - 1) / NZW;  // most Z rows per warp
static_assert(W % NOPW == 0 && NZW >= 1 && RZ == 3,
              "the chain warp, operand warps and Z warps share the CTA");
constexpr int KC = 16;                   // samples per tensor-core step
constexpr int RING_ROWS = NW * 2 * KC;   // x rows of the DEEP warps' rings
constexpr unsigned BF16_ONE = 0x3F80u;   // 1.0 in bf16

// clock64() cycles of CTA 0's thread 0 (rank 0 of slice 0, which runs the
// chain) per phase of the latest launch: the prologue, its own share of the
// window passes (TC: their f32 rows), the partial reduction (with the wait
// for the other warps' passes), the cluster barrier, the gather of the
// cluster's sums, the chain, the wait for the next window's x, the wait at
// the window's last barrier for the other warps' tiles, the tail, its
// share of the tensor-core pair Grams (TC), the whole kernel
// (atlasqtl_sweep_missing_clocks;
// chip_smoke.py's mis_kernel phase prints them beside the eQTL-cut timing)
__device__ long long g_clocks[NCLK];

// floats of one window's scalars: p_mask, theta and the W rows of the
// interpolation basis L
__host__ __device__ constexpr int ws_floats(int R) { return 2 * W + W * R; }

// a probe's window off the 8-row grid: neither a divisor of W nor a
// multiple of it (3, 5, 6, 12, ...: a window starts inside a chain window)
__host__ __device__ constexpr bool off_grid(int pwin) {
  return pwin > 0 && W % pwin != 0 && pwin % W != 0;
}

// the deltas a CTA keeps: those of its window, or under a DEEP pair_bf16
// window (SUB > 2 W) those of the whole SUB-window
__host__ __device__ constexpr int delta_rows(int sub) {
  return sub > 2 * W ? sub : W;
}

// the float32 probe instance's deltas beside them, in a region of their own
// at the end of shared memory (so that every other offset is the float32
// instance's), under the probe code pcode at its window pwin: off the grid a
// ring of whole chain windows over the latest pwin + 7 rows
// (probe_off_rows); else none (the exact sweep runs B2's own schedule; on
// the grid a window's deltas for its end term go to a workspace in device
// memory, MisProbe::dws)
__host__ __device__ constexpr int probe_rows(int pcode, int pwin) {
  return pcode != 3 && off_grid(pwin) ? (pwin + 2 * W - 2) / W * W : 0;
}

// the rows of one x slot: the CTA's rows (none in device memory), under a
// DEEP window at least the warps' rings
__host__ __device__ constexpr int x_rows(int rows, int sub) {
  return sub > 2 * W && rows < RING_ROWS ? RING_ROWS : rows;
}

// shared memory of one CTA: two sets of window operand tiles, two windows
// of masked gam, the deltas (delta_rows), two cluster-visible sum buffers,
// the partial slots, the phase clocks, three sets of window scalars, the
// slice's interpolation nodes; on chip also nloc rows of Fm and one mask
// word per row; two x slots of W per row of x_rows; the float32 probe
// instance's prows (probe_rows), from a 16-byte boundary after the mask
// words
size_t smem_bytes(bool on_chip, int nloc, int R, int sub, int prows = 0) {
  const size_t rows = on_chip ? nloc : 0;
  return sizeof(float) *
         ((size_t)2 * NWT * W * QS + 2 * W * QS + (size_t)delta_rows(sub) * QS +
          2 * NRH * QS +
          NSLOT * NRH * QS + CLKF + NWS * ws_floats(R) + 3 * R * QS +
          rows * (QS + 1) + (size_t)2 * x_rows((int)rows, sub) * W +
          (prows ? ((rows + 3) & ~(size_t)3) - rows + (size_t)prows * QS
                 : 0));
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
// instance; RW = W, every pair rounded: the tensor cores sum them,
// window_grams, so none here).  MWX, a probe's: the f32 pairs of a and b
// with (a ^ b) >= mw (in two windows of mw predictors) without the mask
// (noadvmask's advance between windows under 8).
template <int RW, bool MWX = false>
__device__ __forceinline__ void pair_sums(const float* xv, float m,
                                          float* v, int mw = W) {
  if constexpr (RW < W) {
    if constexpr (MWX) {
      if (mw < W) {  // a probe's pairs across two windows of mw
        int e = W;
#pragma unroll
        for (int a = 1; a < W; ++a)
#pragma unroll
          for (int b = 0; b < a; ++b, ++e) {
            if ((a ^ b) < RW)
              v[e] = fmaf(m, __bfloat162float(__float2bfloat16_rn(
                                 __fmul_rn(xv[a], xv[b]))), v[e]);
            else
              v[e] = fmaf(__fmul_rn(xv[a], xv[b]), (a ^ b) < mw ? m : 1.f,
                          v[e]);
          }
        return;
      }
    }
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
// projections (x row xp) of the advanced f (PRE: of f from before the
// advance) and masked pair sums (pair_sums<RW>) into v.  Returns the new f.
// PRB, the probe instance (ops/sweep_missing_fused.py:MIS_PROBES): f
// advances by the rule `rule` (1: masked; 2: without the mask, noadvmask);
// `pre` in place of PRE; the pair sums only under PAIRS (none under
// noseq), under MWX those across two windows of mw < W without the mask
// (pair_sums).  lcode >= 0: the pass of the last chain window of a probe's
// window on the 8-row grid, whose f, f0, holds the window's start advanced
// by the probe's rule through its chain windows before the previous one:
// it projects f0 (noseq, lcode 0) or f0 + m s (noadv, noadvmask: the
// running masked advance) and stores f0 + m s (noseq), f0 (noadv) or f0 +
// s (noadvmask), to which window_edge then adds the window's end term.
// The probe's choices are selects, so that the two rows of a step still
// overlap.
template <bool ADV, bool PROJ, int RW, bool PRE = false, bool PRB = false,
          bool PAIRS = true, bool MWX = false>
__device__ __forceinline__ float row_update(float f, float m,
                                            const float* xa, const float* xp,
                                            const float* dl, float* v,
                                            int rule = 1, bool pre = false,
                                            int mw = W, int lcode = -1) {
  const float f0 = f;
  float s = 0.f;
  if (ADV) {
    float xv[W];
    load8(xa, xv);
    s = xv[0] * dl[0];
#pragma unroll
    for (int i = 1; i < W; ++i) s = fmaf(xv[i], dl[i], s);
    if constexpr (PRB)
      f = fmaf(rule == 1 ? m : 1.f, s, f);
    else
      f = fmaf(m, s, f);
  }
  float fp = !(PRB ? pre : PRE) ? f : f0;
  if constexpr (PRB && ADV) {  // f: the running masked advance (rule 1)
    fp = lcode == 0 ? f0 : fp;
    f = lcode == 1 ? f0 : lcode == 2 ? __fadd_rn(f0, s) : f;
  }
  if (PROJ) {
    float xv[W];
    load8(xp, xv);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = fmaf(xv[i], fp, v[i]);
    if constexpr (PAIRS) pair_sums<RW, MWX>(xv, m, v, mw);
  }
  return f;
}

// One f32 pass over this CTA's rows under a DEEP window (SUB > 2 W):
// jadv >= 0 first advances Fm by the SUB deltas in D_s of the SUB-window
// that starts at predictor jadv (f += m * sum_b x_b delta_b, x from device
// memory); proj then adds this chain window's projections (x in xp, as
// window_pass) of Fm as it stands, its SUB-window's start, into v.  Its
// pair Grams are the tensor cores' (window_grams, cross_grams).  PRB, the
// probe instance: the advance by the rule arule (row_update's; noadv
// passes jadv = -1).
template <bool ON_CHIP, int SUB, bool PRB = false>
__device__ __forceinline__ void deep_rows(
    float* __restrict__ fm_s, const unsigned* __restrict__ mb_s,
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ x, const float* __restrict__ xp,
    const float* __restrict__ D_s, float* __restrict__ v, int row0, int nr,
    int p, int q, int k, bool cvalid, int warp, int lane, int jadv,
    bool proj, int arule = 1) {
  static_assert(SUB > 2 * W && SUB % W == 0, "a DEEP pair_bf16 window");
#pragma unroll
  for (int e = 0; e < NRH; ++e) v[e] = 0.f;
  if (!ON_CHIP && !cvalid) return;
  const size_t xs = ON_CHIP ? W : (size_t)p;  // row stride of the x window
  for (int t = warp; t < nr; t += NW) {
    float& fr = ON_CHIP ? fm_s[t * QS + lane] : fm[(size_t)t * q + k];
    const float m = ON_CHIP ? ((mb_s[t] >> lane) & 1u ? 1.f : 0.f)
                            : mask[(size_t)t * q + k];
    float f = fr;
    if (jadv >= 0) {
      const float* xrow = x + (size_t)(row0 + t) * p + jadv;
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < SUB; c += W) {
        float xb[W];
        load8(xrow + c, xb);
#pragma unroll
        for (int i = 0; i < W; ++i) s = fmaf(xb[i], D_s[(c + i) * QS + lane], s);
      }
      f = !PRB || arule == 1 ? fmaf(m, s, f) : __fadd_rn(f, s);
      fr = f;
    }
    if (!proj) continue;
    float xv[W];
    load8(xp + t * xs, xv);
#pragma unroll
    for (int a = 0; a < W; ++a) v[a] = fmaf(xv[a], f, v[a]);
  }
}

// Off the grid, for the chain window of predictors jw .. jw + W: bit e of
// the pair (a, b) of pair_sums' order (e = a (a - 1) / 2 + b, b < a) where
// rows jw + a and jw + b share a window of pwin.
__device__ __forceinline__ unsigned off_same(int jw, int pwin) {
  int wid[W];
#pragma unroll
  for (int i = 0; i < W; ++i) wid[i] = (jw + i) / pwin;
  unsigned bits = 0u;
  int e = 0;
#pragma unroll
  for (int a = 1; a < W; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b, ++e)
      if (wid[a] == wid[b]) bits |= 1u << e;
  return bits;
}

// the pairs whose pair sums go without the mask: across two windows under
// noadvmask (arule 2)
__device__ __forceinline__ unsigned off_unmasked(int jw, int pwin,
                                                 int arule) {
  return arule == 2 ? ~off_same(jw, pwin) & ((1u << NP) - 1u) : 0u;
}

// the pairs the chain pushes: in one window where the probe keeps the
// pushes (pcode != 0), across two where it keeps the advance (arule != 0)
__device__ __forceinline__ unsigned off_pushed(int jw, int pwin, int pcode,
                                               int arule) {
  const unsigned same = off_same(jw, pwin);
  return (pcode != 0 ? same : 0u) |
         (arule != 0 ? ~same & ((1u << NP) - 1u) : 0u);
}

// the same on the 8-row grid, where rows a and b of a chain window share a
// window of pwin if (a ^ b) < pwin
__device__ __forceinline__ unsigned grid_pushed(int pwin, int pcode,
                                                int arule) {
  unsigned bits = 0u;
  int e = 0;
#pragma unroll
  for (int a = 1; a < W; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b, ++e)
      if ((a ^ b) < pwin ? pcode != 0 : arule != 0) bits |= 1u << e;
  return bits;
}

// The float32 probe instance's pass under a probe's window pwin off the
// 8-row grid (off_grid), with Fm as of the start P of the window of pwin
// that holds this chain window's first predictor jw (advanced, by the
// probe's rule arule, through every earlier window): the deltas of rows r
// in a ring of DR rows at D_s, at row r % DR.  ja0 < ja1 first advances Fm
// by rows [ja0, ja1) by the rule (the windows completed since the last
// pass; noadv passes none); proj then adds this chain window's projections
// (x in xp, as window_pass): its first nhead rows, still in window P, of
// Fm plus, where `inc`, the masked increment of rows [P, jw) (the pushes
// of their masked pair Grams), the others, in windows that start inside
// this chain window, of Fm advanced by rows [P, jw) by the rule (the rows
// of the chain window before their start come in through the chain's
// pushes); and the window's f32 pair sums, with the mask (a pair in one
// window, or across two under the masked advance) or without it (across
// two under noadvmask: bit e of `unmasked` for pair e of pair_sums).
template <bool ON_CHIP>
__device__ __forceinline__ void probe_off_rows(
    float* __restrict__ fm_s, const unsigned* __restrict__ mb_s,
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ x, const float* __restrict__ xp,
    const float* __restrict__ D_s, float* __restrict__ v, int row0, int nr,
    int p, int q, int k, bool cvalid, int warp, int lane, int DR, int ja0,
    int ja1, int arule, bool proj, bool inc, int P, int jw, int nhead,
    unsigned unmasked) {
#pragma unroll
  for (int e = 0; e < NRH; ++e) v[e] = 0.f;
  if (!ON_CHIP && !cvalid) return;
  const size_t xs = ON_CHIP ? W : (size_t)p;  // row stride of the x window
  for (int t = warp; t < nr; t += NW) {
    float& fr = ON_CHIP ? fm_s[t * QS + lane] : fm[(size_t)t * q + k];
    const float m = ON_CHIP ? ((mb_s[t] >> lane) & 1u ? 1.f : 0.f)
                            : mask[(size_t)t * q + k];
    const float* xrow = x + (size_t)(row0 + t) * p;
    // sum_r x_r delta_r over rows [j0, j1), deltas from the ring
    auto xdot = [&](int j0, int j1) {
      float s = 0.f;
      for (int r = j0, slot = j0 % DR; r < j1; ++r) {
        s = fmaf(xrow[r], D_s[slot * QS + lane], s);
        slot = slot + 1 == DR ? 0 : slot + 1;
      }
      return s;
    };
    float f = fr;
    if (ja0 < ja1) {
      const float s = xdot(ja0, ja1);
      f = arule == 1 ? fmaf(m, s, f) : __fadd_rn(f, s);
      fr = f;
    }
    if (!proj) continue;
    const float s = xdot(P, jw);
    const float fh = inc ? fmaf(m, s, f) : f;
    const float ft = arule == 1 ? fmaf(m, s, f)
                     : arule == 2 ? __fadd_rn(f, s)
                                  : f;
    float xv[W];
    load8(xp + t * xs, xv);
#pragma unroll
    for (int a = 0; a < W; ++a) v[a] = fmaf(xv[a], a < nhead ? fh : ft, v[a]);
    int e = W;
#pragma unroll
    for (int a = 1; a < W; ++a)
#pragma unroll
      for (int b = 0; b < a; ++b, ++e)
        v[e] = fmaf(__fmul_rn(xv[a], xv[b]),
                    (unmasked >> (e - W)) & 1u ? 1.f : m, v[e]);
  }
}

// One pass over this CTA's rows: ADV advances Fm by the previous window
// (x in xa, deltas in D_s); PROJ then accumulates this window's projections
// (PRE: of Fm from before the advance) and pair sums (pair_sums<RW>; x in
// xp) into v.  On chip, xa and xp are x slots and Fm lives in fm_s;
// otherwise they point into x at the windows' first columns and Fm is the
// device slice at fm.  Each warp takes two rows per step, both read before
// either is written back, so their loads and FMA chains overlap.  PRB: the
// probe instance's rows (row_update's PAIRS, MWX, rule, pre, mw, lcode).
template <bool ON_CHIP, bool ADV, bool PROJ, int RW, bool PRE = false,
          bool PRB = false, bool PAIRS = true, bool MWX = false>
__device__ __forceinline__ void window_pass(
    float* __restrict__ fm_s, const unsigned* __restrict__ mb_s,
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ xa, const float* __restrict__ xp,
    const float* __restrict__ D_s, float* __restrict__ v, int nr, int p,
    int q, int k, bool cvalid, int warp, int lane, int rule = 1,
    bool pre = false, int mw = W, int lcode = -1) {
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
  for (; t + NW < nr; t += 2 * NW) {
    const int u = t + NW;
    float f0 = fm_at(t), f1 = fm_at(u);
    const float m0 = m_at(t), m1 = m_at(u);
    f0 = row_update<ADV, PROJ, RW, PRE, PRB, PAIRS, MWX>(
        f0, m0, xa + t * xs, xp + t * xs, dl, v, rule, pre, mw, lcode);
    f1 = row_update<ADV, PROJ, RW, PRE, PRB, PAIRS, MWX>(
        f1, m1, xa + u * xs, xp + u * xs, dl, v, rule, pre, mw, lcode);
    if (ADV) {
      fm_at(t) = f0;
      fm_at(u) = f1;
    }
  }
  if (t < nr) {
    const float f = row_update<ADV, PROJ, RW, PRE, PRB, PAIRS, MWX>(
        fm_at(t), m_at(t), xa + t * xs, xp + t * xs, dl, v, rule, pre, mw,
        lcode);
    if (ADV) fm_at(t) = f;
  }
}

constexpr int ER = NSLOT * NRH * QS / NW / (2 * W);  // rows of a stage

// The end of a probe's window on the 8-row grid, after the pass of its last
// chain window (row_update's lcode), over the rows that this warp's passes
// own (so no CTA barrier): noadv restores Fm as the launch received it (fo:
// this thread's column of the CTA's rows); noseq and noadvmask add the end
// term of the window's first nc chain windows, e = sum_b x_b delta_b,
// masked (noseq) or where the mask is 0 (noadvmask), two chain windows at
// a time (a last odd one with the next chain window's x and no delta), the
// deltas from dw (W x QS each, device memory).  Their x (from xe, the
// window's first predictor, row stride p) is staged by cp.async, ER rows
// at a time, into this warp's part of the partial slots (xs; free until
// the cluster's sums are gathered), so that a warp has ER rows' loads in
// flight and reads each row back by broadcast (no x slot is free: the next
// pass advances from this chain window's).
template <bool ON_CHIP>
__device__ __forceinline__ void window_edge(
    float* __restrict__ fm_s, const unsigned* __restrict__ mb_s,
    float* __restrict__ fm, const float* __restrict__ mask,
    const float* __restrict__ xe, float* __restrict__ xs,
    const float* __restrict__ dw, const float* __restrict__ fo, int nr,
    int p, int q, int k, bool cvalid, int warp, int lane, int lcode,
    int nc) {
  auto fm_at = [&](int t) -> float& {
    return ON_CHIP ? fm_s[t * QS + lane] : fm[(size_t)t * q + k];
  };
  // in device memory a column past q has no Fm; its lane still stages x
  const bool mine = ON_CHIP || cvalid;
  if (lcode == 1) {
    if (!mine) return;
#pragma unroll 4
    for (int t = warp; t < nr; t += NW)
      fm_at(t) = cvalid ? fo[(size_t)t * q] : 0.f;
    return;
  }
  const int rows = (nr - warp + NW - 1) / NW;  // this warp's, t = warp + NW i
  for (int c = 0; c < nc; c += 2) {
    float dl[2 * W];
#pragma unroll
    for (int i = 0; i < 2 * W; ++i)
      dl[i] = c + i / W < nc ? dw[(c * W + i) * QS + lane] : 0.f;
    for (int g = 0; g < rows; g += ER) {
      const int nrow = min(ER, rows - g);
      for (int e = lane; e < 4 * nrow; e += 32) {
        const int h = 4 * (e & 3);
        cp_async16(xs + (e >> 2) * 2 * W + h,
                   xe + (size_t)(warp + NW * (g + (e >> 2))) * p + c * W + h);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
#pragma unroll 2
      for (int r = 0; r < nrow; ++r) {
        float xv[W], xu[W];
        load8(xs + r * 2 * W, xv);
        load8(xs + r * 2 * W + W, xu);
        float s = xv[0] * dl[0], su = xu[0] * dl[W];
#pragma unroll
        for (int i = 1; i < W; ++i) {
          s = fmaf(xv[i], dl[i], s);
          su = fmaf(xu[i], dl[W + i], su);
        }
        s += su;
        const int t = warp + NW * (g + r);
        if (mine) {
          const float m = ON_CHIP ? ((mb_s[t] >> lane) & 1u ? 1.f : 0.f)
                                  : mask[(size_t)t * q + k];
          fm_at(t) = fmaf(lcode == 0 ? m : 1.f - m, s, fm_at(t));
        }
      }
      __syncwarp();  // read before the next stage lands
    }
  }
}

// ---- the pair Grams on the tensor cores (the TC instances, SUB >= W) ----
// Thread (g = lane / 4, t = lane % 4) of a warp holds, in a chunk of KC
// samples from row r0, the fragment samples r0 + 2t, 2t + 1, 2t + 8, 2t + 9
// (frag_row i = 0..3; mma_bf16 in common.cuh).  Column c of n8 tile j is
// the slice's column 4 c + j, so that the thread's B columns are 4 g .. 4 g
// + 3 (four adjacent mask bits) and its D columns 8 t .. 8 t + 3 (d[0],
// d[2] of tiles j = 0..3) and 8 t + 4 .. 8 t + 7 (d[1], d[3]).

__device__ __forceinline__ int frag_row(int r0, int lane, int i) {
  return r0 + 2 * (lane & 3) + (i & 1) + 8 * (i >> 1);
}

// two floats rounded to bf16 (nearest even) in one register, lo in the low
// half
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The B fragments of the chunk from row r0: the exact 0/1 mask, KC samples
// x 8 columns per n8 tile j (bf[j]; from the mask words on chip, else from
// the mask rows), 0 at rows past nr and at columns past q.
template <bool ON_CHIP>
__device__ __forceinline__ void mask_frags(unsigned (&bf)[4][2],
                                           const unsigned* __restrict__ mb_s,
                                           const float* __restrict__ mask,
                                           int r0, int nr, int q, int k0,
                                           int lane) {
  const int c4 = 4 * (lane >> 2);
  unsigned u[4];  // bit j: fragment sample i's mask at column c4 + j
  if constexpr (ON_CHIP) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = frag_row(r0, lane, i);
      u[i] = s < nr ? (mb_s[s] >> c4) & 0xFu : 0u;
    }
  } else {
    // one sample's float4 at a time (in device memory, for registers)
    u[0] = u[1] = u[2] = u[3] = 0u;
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int s = frag_row(r0, lane, i);
      unsigned b = 0u;
      if (s < nr && k0 + c4 < q) {  // q % 4 == 0: all four or none
        const float4 m = ld4(mask + (size_t)s * q + k0 + c4);
        b = (m.x != 0.f) | (m.y != 0.f) << 1 | (m.z != 0.f) << 2 |
            (m.w != 0.f) << 3;
      }
      u[0] = i == 0 ? b : u[0];
      u[1] = i == 1 ? b : u[1];
      u[2] = i == 2 ? b : u[2];
      u[3] = i == 3 ? b : u[3];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned z = u[2 * h] | u[2 * h + 1] << 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j][h] = (z >> j & 0x10001u) * BF16_ONE;
  }
}

// The pair of A row (k = 2 mt + h, g) of window_grams: g and its partner
// (g + k + 1) % 8.  Rows k = 0, 1, 2 hold the pairs at distance k + 1 and
// 7 - k, row 3 those at distance 4 (g < 4; g >= 4 repeats them): the 28
// pairs once each, and every product has the thread's own x_g as a factor.
__device__ __forceinline__ int partner(int g, int k) { return (g + k + 1) & 7; }

// The masked pair Grams of this window's 28 pairs, summed over this warp's
// chunks (warp, warp + NW, ...): acc[mt][j] is the 16 x 8 tile of A rows
// (2 mt, g) and (2 mt + 1, g) (d[0..1], d[2..3]) at n8 tile j.  The
// window's x is at xw, row stride xs; each rounded product is formed once,
// in its A fragment.
template <bool ON_CHIP>
__device__ __forceinline__ void window_grams(
    float (&acc)[2][4][4], const float* __restrict__ xw, size_t xs,
    const unsigned* __restrict__ mb_s, const float* __restrict__ mask,
    int nr, int q, int k0, int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const int g = lane >> 2;
  for (int r0 = warp * KC; r0 < nr; r0 += NW * KC) {
    unsigned bf[4][2];
    mask_frags<ON_CHIP>(bf, mb_s, mask, r0, nr, q, k0, lane);
    float xg[4];  // x_g at the fragment samples
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = frag_row(r0, lane, i);
      xg[i] = s < nr ? xw[(size_t)s * xs + g] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float p0[4], p1[4];  // A rows (2 mt, g), (2 mt + 1, g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = frag_row(r0, lane, i);
        const float* xr = xw + (size_t)s * xs;
        p0[i] = s < nr ? __fmul_rn(xg[i], xr[partner(g, 2 * mt)]) : 0.f;
        p1[i] = s < nr ? __fmul_rn(xg[i], xr[partner(g, 2 * mt + 1)]) : 0.f;
      }
      const unsigned a[4] = {bf16x2(p0[0], p0[1]), bf16x2(p1[0], p1[1]),
                             bf16x2(p0[2], p0[3]), bf16x2(p1[2], p1[3])};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
    }
  }
}

// The cross pairs of this window (a = 0..7; x at xw, row stride xs) with
// nb earlier 8-windows of its SUB-window (block jb: its deltas in rows
// 8 jb .. of D_s, its x at predictor jb0 + 8 jb), needed only as
// sum_b H[(a, b), k] delta_bk: cacc[j][0] (cacc[j][1]) += that sum at
// a = g and column 8 t + j (8 t + 4 + j), over this warp's (chunk, block)
// steps (warp, warp + NW, ... of chunk-major steps), each contracted in
// f32 as soon as its tensor-core tile is done.  The tile of block jb's m16
// tile i holds rows (b = 2 i, a = g) and (b = 2 i + 1, a = g).  RING
// (DEEP): each block's x comes by cp.async from x in device memory (rows
// from row0, stride p) through this warp's two-stage ring (KC x W floats a
// stage); else (SUB = 16) block 0 is the previous window's x at xb, row
// stride xs.
template <bool ON_CHIP, bool RING>
__device__ __forceinline__ void cross_grams(
    float (&cacc)[4][2], const float* __restrict__ xw,
    const float* __restrict__ xb, size_t xs, const float* __restrict__ x,
    float* __restrict__ ring, int row0, int p, int jb0,
    const float* __restrict__ D_s, int nb, const unsigned* __restrict__ mb_s,
    const float* __restrict__ mask, int nr, int q, int k0, int warp,
    int lane) {
  const int g = lane >> 2, t8 = 8 * (lane & 3);
  const int steps = (nr + KC - 1) / KC * nb;
  // step it's KC x W block of x into ring stage st, 16 bytes per lane
  // (zeros past nr)
  auto stage = [&](int it, int st) {
    const int c = it / nb, row = c * KC + (lane >> 1);
    const bool ok = row < nr;
    cp_async16_zfill(ring + (st * KC + (lane >> 1)) * W + 4 * (lane & 1),
                     x + (size_t)(row0 + (ok ? row : 0)) * p + jb0 +
                         (it - c * nb) * W + 4 * (lane & 1),
                     ok);
  };
  if constexpr (RING) {
    if (warp < steps) stage(warp, 0);
    cp_async_commit();
    if (warp + NW < steps) stage(warp + NW, 1);
    cp_async_commit();
  }
  int cur = -1;
  unsigned bf[4][2];
  float xa[4];  // x_g at this thread's fragment samples
  int u = 0;    // this warp's steps so far
  for (int it = warp; it < steps; it += NW, ++u) {
    const int c = it / nb, jb = it - c * nb, r0 = c * KC;
    if (c != cur) {
      cur = c;
      mask_frags<ON_CHIP>(bf, mb_s, mask, r0, nr, q, k0, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = frag_row(r0, lane, i);
        xa[i] = s < nr ? xw[(size_t)s * xs + g] : 0.f;
      }
    }
    if constexpr (RING) {
      cp_async_wait<1>();  // this step's stage has landed
      __syncwarp();
    }
    // m16 tile i4 of block jb: its products, four n8 tiles and their
    // contraction; two tiles at a time on chip under a ring, else one (for
    // registers: the others hold more addresses)
    auto m_tile = [&](int i4) {
      float p0[4], p1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = frag_row(r0, lane, i);
        const float* src =
            RING ? ring + ((u & 1) * KC + s - r0) * W : xb + (size_t)s * xs;
        const float2 xv = s < nr
                              ? *reinterpret_cast<const float2*>(src + 2 * i4)
                              : make_float2(0.f, 0.f);
        p0[i] = __fmul_rn(xa[i], xv.x);
        p1[i] = __fmul_rn(xa[i], xv.y);
      }
      const unsigned a[4] = {bf16x2(p0[0], p0[1]), bf16x2(p1[0], p1[1]),
                             bf16x2(p0[2], p0[3]), bf16x2(p1[2], p1[3])};
      // the deltas of b = 2 i4 (e0) and 2 i4 + 1 (e1) at this thread's
      // columns 8 t + j (a) and 8 t + 4 + j (b), two tiles j at a time
      const float* d0 = D_s + (jb * W + 2 * i4) * QS + t8;
#pragma unroll
      for (int j2 = 0; j2 < 4; j2 += 2) {
        const float2 e0a = ld2(d0 + j2), e0b = ld2(d0 + 4 + j2);
        const float2 e1a = ld2(d0 + QS + j2), e1b = ld2(d0 + QS + 4 + j2);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j2 + jj;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, a, bf[j][0], bf[j][1]);
          cacc[j][0] = fmaf(d[2], jj ? e1a.y : e1a.x,
                            fmaf(d[0], jj ? e0a.y : e0a.x, cacc[j][0]));
          cacc[j][1] = fmaf(d[3], jj ? e1b.y : e1b.x,
                            fmaf(d[1], jj ? e0b.y : e0b.x, cacc[j][1]));
        }
      }
    };
    if constexpr (RING && ON_CHIP) {
#pragma unroll 2
      for (int i4 = 0; i4 < 4; ++i4) m_tile(i4);
    } else {
#pragma unroll 1
      for (int i4 = 0; i4 < 4; ++i4) m_tile(i4);
    }
    if constexpr (RING) {
      __syncwarp();  // every lane has read the stage before it is refilled
      if (it + 2 * NW < steps) stage(it + 2 * NW, u & 1);
      cp_async_commit();
    }
  }
  if constexpr (RING) cp_async_wait<0>();
}

// four values at 16-byte aligned shared memory: stored (first) or added
__device__ __forceinline__ void put4(float* dst, float4 v, bool first) {
  if (!first) {
    const float4 o = ld4(dst);
    v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
  }
  *reinterpret_cast<float4*>(dst) = v;
}

// The slot this warp's partial sums go to: warps 5-7 write slots 0, 1, 2
// (the two partial slots, then the window's sum buffer rh), warps 2-4 add
// to them, warps 0-1 to the two partial slots.
__device__ __forceinline__ float* partial_slot(float* part, float* rh,
                                               int warp) {
  const int sl = warp >= 5 ? warp - 5 : warp >= 2 ? warp - 2 : warp;
  return sl == NSLOT ? rh : part + sl * NRH * QS;
}

// This warp's pair Grams of the window into rows W + e of its partial
// slot (first: stored, else added).
__device__ __forceinline__ void put_pairs(float* slot,
                                          const float (&acc)[2][4][4],
                                          bool first, int lane) {
  const int g = lane >> 2, t8 = 8 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * mt + h, o = partner(g, k);
      if (k < 3 || g < 4) {
        const int a = max(g, o), b = min(g, o);
        float* row = slot + (W + a * (a - 1) / 2 + b) * QS + t8;
        const float (&c)[4][4] = acc[mt];
        put4(row, make_float4(c[0][2 * h], c[1][2 * h], c[2][2 * h],
                              c[3][2 * h]), first);
        put4(row + 4, make_float4(c[0][2 * h + 1], c[1][2 * h + 1],
                                  c[2][2 * h + 1], c[3][2 * h + 1]), first);
      }
    }
}

// This warp's contraction of the cross pairs (cross_grams) added to its
// projections, rows 0 .. W - 1 of its slot, after its own f32 sums there.
__device__ __forceinline__ void put_cross(float* slot,
                                          const float (&cacc)[4][2],
                                          int lane) {
  __syncwarp();
  float* row = slot + (lane >> 2) * QS + 8 * (lane & 3);
  put4(row, make_float4(cacc[0][0], cacc[1][0], cacc[2][0], cacc[3][0]),
       false);
  put4(row + 4, make_float4(cacc[0][1], cacc[1][1], cacc[2][1], cacc[3][1]),
       false);
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

// The probe instance's runtime arguments, one more kernel argument (PP).
struct MisProbe {
  int code;          // 0 noseq and noh, 1 noadv, 2 noadvmask, 3 exact
  int win;           // its window (the float32 instance's; pair_bf16: SUB)
  const float* fm0;  // noadv in device memory on the grid over 2 W (else
                     // null): (n, q) Fm as the launch received it, stacked
  float* dws;        // noseq, noadvmask on the grid over 2 W: per CTA the
                     // deltas of a window's first win / W - 2 chain windows
};

// SUB: 0 for the float32 instance, else the pair_bf16 window (2, 4, ...,
// 128).  Two CTAs per SM (128 registers), but in device memory from SUB =
// 16 on one (its cross pairs' 64-bit addresses do not fit 128 registers
// without spilling; missing_launch_plan counts on one there).  PRB: the
// probe instance of SUB (the JAX kernel's probes,
// atlasqtl_tpu/ops/sweep_missing_fused.py:155, 197, 207-213), whose
// runtime `pcode` is 0 (noseq, noh: no pairs and no pushes inside a
// window), 1 (noadv: Fm never advances), 2 (noadvmask: Fm advances
// without the mask) or 3 (every part kept: the exact function, to time the
// others against), in windows of pwin predictors, any that divides p (the
// pair_bf16 probe instances: pwin = SUB).
//
// The float32 probe instance (SUB = 0) runs B2's own schedule: the exact
// sweep (pcode 3) takes the float32 instance's passes, chain and layout,
// at every window (the window does not change the exact function).  A
// probe's function in windows of S = pwin = J W predictors on the 8-row
// grid projects chain window j of a window against Fm_start + m sum_{b<j}
// x_b delta_b (but under noseq Fm_start): the running masked advance of
// the float32 instance, which its passes keep.  So each probe departs from
// that schedule only in how a pass advances Fm:
//  - inside a window (chain windows 1 .. J - 2) masked, as B2 does (noseq:
//    not at all);
//  - the pass of its last chain window (lcode, row_update) and, for J > 2,
//    a short pass after it (window_edge) store the window's end but for
//    that chain window: noadv restores Fm as the launch received it (fm0;
//    where J = 2 Fm never moved), noseq and noadvmask add the end term of
//    the window's first J - 2 chain windows, sum_b x_b delta_b (their
//    deltas kept in a workspace in device memory, dws; x staged in the
//    free partial slots), masked (noseq) or where the mask is 0
//    (noadvmask);
//  - at the next window's start by the probe's rule (noseq masked, noadv
//    not at all, noadvmask without the mask).
// What bounds it is B2's pass: the end term adds S - 2 W FMAs per row and
// window against about 7 S of B2's passes (none at 16); every probe on the
// grid keeps B2's layout and plan (its deltas are not in shared memory,
// which B2's plan fills at the eQTL cut) and B2's rows wherever a pass
// advances masked or not at all (the probe's choices are compile-time
// there, selects elsewhere).  No other recomputation remains.  Under 8
// (1, 2, 4) the pairs of an 8-window in one window of pwin are pushed where
// the probe keeps the pushes, those across two where it keeps the advance,
// without the mask under noadvmask; off the 8-row grid (3, 6, 12, ...: a
// window starts inside a chain window) the float32 one keeps Fm as of the
// start of the window that holds each chain window's first row and the
// latest deltas in a ring (probe_off_rows), and pushes per pair of rows.
// Under pair_bf16 at 16 the second 8-window of each 16-window projects Fm
// from before the first's advance and takes its pairs with the first
// through the rounded cross pairs; over 16 (the DEEP instances, SUB =
// pwin) every 8-window projects Fm as of its window's start and takes the
// rounded cross pairs with the window's earlier 8-windows, Fm advancing
// by the probe's rule at the window's end.  The float32 probe instance's
// deltas beyond W sit at the end of shared memory (DP_s, probe_rows).  The
// probe instance alone takes a MisProbe (its code, window, Fm as the
// launch received it and the deltas' workspace) as one more argument (PP),
// so that the others keep their parameters.
template <bool FM_ON_CHIP, int SUB, bool PRB = false, typename... PP>
__global__ void __launch_bounds__(NT, FM_ON_CHIP || SUB < 2 * W ? 2 : 1)
    sweep_missing_kernel(
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
    int n, int p, int q, int R, int nloc,
    PP... probe_args) {                 // PRB: one MisProbe
  static_assert(SUB == 0 || SUB == 2 || SUB == 4 || SUB == W || SUB == 2 * W ||
                    SUB == 4 * W || SUB == 8 * W || SUB == 16 * W,
                "the float32 instance or a pair_bf16 window");
  static_assert(PRB == (sizeof...(PP) == 1), "PRB: one MisProbe");
  // pairs rounded within RW-aligned groups of an 8-window; TC: every pair
  // of an 8-window rounded, its pair Grams on the tensor cores; CROSS: odd
  // 8-windows project the 16-window's start and add its cross pairs; DEEP:
  // chain windows of a SUB-window take deep_rows, J of them
  constexpr int RW = SUB < W ? SUB : W;
  constexpr bool TC = SUB >= W;
  constexpr bool CROSS = SUB == 2 * W;
  constexpr bool DEEP = SUB > 2 * W;
  constexpr int J = DEEP ? SUB / W : 1;
  int pcode = 0, pwin = W;
  if constexpr (PRB) {
    const MisProbe pa{probe_args...};
    pcode = pa.code;
    pwin = SUB != 0 ? SUB : pa.win;  // a pair_bf16 probe: its own window
  }
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
  // 2 x xr x W x (DEEP: the other one's rows from 0 also the warps' rings)
  const int xr = x_rows(FM_ON_CHIP ? nloc : 0, SUB);
  float* XS_s = FM_s + nloc * QS;
  unsigned* MB_s = reinterpret_cast<unsigned*>(XS_s + 2 * xr * W);
  // PRB: probe_rows(pcode, pwin) x QS deltas of the float32 probe
  // instance (only it reads and writes them), after the mask words
  auto DP_s = [&] {
    return reinterpret_cast<float*>(MB_s) +
           (((FM_ON_CHIP ? nloc : 0) + 3) & ~3);
  };
  // PRB: this CTA's kept deltas in device memory (MisProbe::dws)
  auto dws_cta = [&] {
    const MisProbe pa{probe_args...};
    return pa.dws + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                        (pwin - 2 * W) * QS;
  };

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
  // PRB: Fm's advance rule at a probe's window's start (row_update's rule;
  // 0: none), whether a window forms its pairs (a pair_bf16 probe instance
  // runs noadv and noadvmask only; under noseq a window under 8 needs those
  // across its windows)
  const int arule = pcode == 1 ? 0 : pcode == 2 ? 2 : 1;
  const bool pairs = SUB != 0 || pcode != 0 || pwin < W;
  // the float32 probe instance's exact sweep, which runs B2's schedule; a
  // probe's window off the 8-row grid (probe_off_rows); on it, of PJ chain
  // windows (the float32 instance: the running masked advance with its
  // window's end in the last chain window's pass, row_update's lcode), and
  // whether the chain keeps the deltas of its first PJ - 2 (noseq,
  // noadvmask: the end term)
  const bool exact = PRB && SUB == 0 && pcode == 3;
  const bool off = PRB && !exact && off_grid(pwin);
  const int PJ = pwin / W;
  const bool grid = PRB && SUB == 0 && !exact && pwin % W == 0;
  const bool keep = grid && PJ > 2 && pcode != 1;

  // the probe thread keeps its start and latest tick in CLK_s[NCLK ..],
  // not in registers
  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;
  if (probe) {
    for (int e = 0; e < NCLK; ++e) CLK_s[e] = 0;
    CLK_s[NCLK] = CLK_s[NCLK + 1] = clock64();
  }
  auto tick = [&](int slot) {  // the probe thread's cycles since the last tick
    if (probe) {
      const long long t = clock64();
      CLK_s[slot] += t - CLK_s[NCLK + 1];
      CLK_s[NCLK + 1] = t;
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

    // the x of this window and the previous one, and their row stride
    const float* xa = FM_ON_CHIP ? XS_s + ((w + 1) & 1) * xr * W
                                 : x + (jw - W);
    const float* xp = FM_ON_CHIP ? XS_s + (w & 1) * xr * W : x + jw;
    const size_t xs = FM_ON_CHIP ? W : (size_t)p;
    // advance by the previous window (if any), project this one
    bool cross = false;  // TC: this pass contracts cross pairs
    int edge = -1;       // PRB: the probe's window ends here (window_edge)
    if constexpr (DEEP) {
      const int j = w % J;  // this chain window's place in its SUB-window
      deep_rows<FM_ON_CHIP, SUB, PRB>(
          FM_s, MB_s, fm_rows, mask_rows, x, xp, D_s, v, row0, nr, p, q, k,
          cvalid, warp, lane, j == 0 && w > 0 && arule != 0 ? jw - SUB : -1,
          true, arule);
      cross = j > 0;
    } else if constexpr (PRB) {
      if (exact) {  // B2's own passes
        if (w == 0)
          window_pass<FM_ON_CHIP, false, true, RW>(
              FM_s, MB_s, fm_rows, mask_rows, xa, xp, D_s, v, nr, p, q, k,
              cvalid, warp, lane);
        else
          window_pass<FM_ON_CHIP, true, true, RW>(
              FM_s, MB_s, fm_rows, mask_rows, xa, xp, D_s, v, nr, p, q, k,
              cvalid, warp, lane);
      } else if (off) {
        // the window of jw, the previous chain window's, and the rows of
        // this chain window still in the first
        const int P = jw - jw % pwin;
        const int Pp = w > 0 ? (jw - W) - (jw - W) % pwin : P;
        probe_off_rows<FM_ON_CHIP>(
            FM_s, MB_s, fm_rows, mask_rows, x, xp, DP_s(), v, row0, nr, p, q,
            k, cvalid, warp, lane, probe_rows(pcode, pwin), Pp,
            arule != 0 ? P : Pp, arule, true,
            pcode != 0, P, jw, min(P + pwin, jw + W) - jw,
            off_unmasked(jw, pwin, arule));
      } else {
        // the advance of this pass (0: none): by the probe's rule at a
        // window's start (under 8 and under pair_bf16 at every pass); on
        // the grid inside a window masked (noseq: none), and in the pass of
        // its last chain window (j = PJ - 1 > 0) the window's end but for
        // that chain window (lcode, then window_edge)
        int rule = w == 0 ? 0 : arule, lcode = -1;
        const int j = grid ? w % PJ : 0;
        if (grid && j > 0) {
          rule = pcode != 0 || j == PJ - 1 ? 1 : 0;
          if (j == PJ - 1) lcode = pcode;
        }
        // pair_bf16 at 16: the second 8-window of a 16-window projects its
        // start and takes the rounded cross pairs
        const bool pre = CROSS && (w & 1);
        const int mw = arule == 2 ? pwin : W;
        // the pass of (ADV, PRB, PAIRS, MWX), so that no probe test sits in
        // its rows: one that advances masked or not at all takes B2's rows
        // (PRB false), the others row_update's selects
        auto pass = [&](auto adv, auto prb, auto prs, auto mwx) {
          window_pass<FM_ON_CHIP, decltype(adv)::value, true, RW, false,
                      decltype(prb)::value, decltype(prs)::value,
                      decltype(mwx)::value>(
              FM_s, MB_s, fm_rows, mask_rows, xa, xp, D_s, v, nr, p, q, k,
              cvalid, warp, lane, rule, pre, mw, lcode);
        };
        auto by_pairs = [&](auto adv, auto prb) {
          if (!pairs)
            pass(adv, prb, std::false_type{}, std::false_type{});
          else if (mw < W)
            pass(adv, std::true_type{}, std::true_type{}, std::true_type{});
          else
            pass(adv, prb, std::true_type{}, std::false_type{});
        };
        if (rule == 0)
          by_pairs(std::false_type{}, std::false_type{});
        else if (rule == 1 && !pre && lcode < 0)
          by_pairs(std::true_type{}, std::false_type{});
        else
          by_pairs(std::true_type{}, std::true_type{});
        // the window's end term follows the warps' partial sums (none in a
        // window of two chain windows)
        if (PJ > 2) edge = lcode;
        cross = pre;
      }
    } else if (w == 0) {
      window_pass<FM_ON_CHIP, false, true, RW>(FM_s, MB_s, fm_rows,
                                               mask_rows, xa, xp, D_s, v, nr,
                                               p, q, k, cvalid, warp, lane);
    } else if constexpr (CROSS) {
      cross = w & 1;
      if (cross)
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
    // the warps' sums in a fixed order into three slots (partial_slot):
    // warps 5-7 write, warps 2-4 add, warps 0-1 add.  TC: the window's pair
    // Grams (acc, rows W ..) first, in phases of their own, so that acc is
    // dead before the cross pairs' contraction (cacc); then the projections
    // with the contraction added (rows 0 .. W - 1)
    float* rh = RH_s + (w & 1) * NRH * QS;  // this window's sum buffer
    {
      float* slot = partial_slot(PART_s, rh, warp);
      float cacc[4][2];
      if constexpr (TC) {
        {
          float acc[2][4][4];
          window_grams<FM_ON_CHIP>(acc, xp, xs, MB_s, mask_rows, nr, q, k0,
                                   warp, lane);
          tick(9);
          if (warp >= 5) put_pairs(slot, acc, true, lane);
          __syncthreads();
          if (warp >= 2 && warp < 5) put_pairs(slot, acc, false, lane);
          __syncthreads();
          if (warp < 2) put_pairs(slot, acc, false, lane);
        }
        tick(2);
#pragma unroll
        for (int j = 0; j < 4; ++j) cacc[j][0] = cacc[j][1] = 0.f;
        if (cross) {
          if constexpr (DEEP) {
            const int j = w % J;
            cross_grams<FM_ON_CHIP, true>(
                cacc, xp, nullptr, xs, x,
                XS_s + ((w + 1) & 1) * xr * W + warp * 2 * KC * W, row0, p,
                jw - j * W, D_s, j, MB_s, mask_rows, nr, q, k0, warp, lane);
          } else {
            cross_grams<FM_ON_CHIP, false>(cacc, xp, xa, xs, x, nullptr,
                                           row0, p, 0, D_s, 1, MB_s,
                                           mask_rows, nr, q, k0, warp, lane);
          }
        }
        tick(9);
      }
      // this warp's f32 sums into its slot (store, else added); TC: the
      // projections, then the cross pairs' contraction
      auto put = [&](bool store) {
        constexpr int NV = TC ? W : NRH;
#pragma unroll
        for (int e = 0; e < NV; ++e)
          slot[e * QS + lane] = store ? v[e] : v[e] + slot[e * QS + lane];
        if constexpr (TC)
          if (cross) put_cross(slot, cacc, lane);
      };
      if (warp >= 5) put(true);
      __syncthreads();
      // the next window's x goes to the slot this pass advanced from (DEEP:
      // the warps' rings, read by every warp's cross pairs before that
      // barrier)
      if (FM_ON_CHIP && w + 1 < nwin)
        stage_x(XS_s + ((w + 1) & 1) * xr * W, x, row0, nr, p, jw + W, tid);
      cp_async_commit();
      cp_async_wait<1>();  // the next window's tiles have landed
      if (warp >= 2 && warp < 5) put(false);
      __syncthreads();
      if (warp < 2) put(false);
      __syncthreads();
    }
    for (int e = tid; e < NRH * QS; e += NT)
      rh[e] = (PART_s[e] + PART_s[NRH * QS + e]) + rh[e];
    if constexpr (PRB) {
      // the end of a probe's window, once the pass's sums are out of
      // registers and the partial slots are read; noadv's Fm as received:
      // on chip the device slice, not written before the tail, else the
      // launch's own (MisProbe::fm0)
      if (edge >= 0) {
        const MisProbe pa{probe_args...};
        __syncthreads();
        tick(2);
        window_edge<FM_ON_CHIP>(
            FM_s, MB_s, fm_rows, mask_rows,
            x + (size_t)row0 * p + (jw + W - pwin),
            PART_s + warp * ER * 2 * W,
            dws_cta(),
            (FM_ON_CHIP ? fm_rows : pa.fm0 + blockIdx.y * (size_t)n * q) +
                k,
            nr, p, q, k, cvalid, warp, lane, edge, pwin / W - 2);
        tick(1);
      }
    }
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
      // DEEP (a probe's window over 2 W): this window's rows of the
      // SUB-window's (pwin-window's) deltas
      float* dw = DEEP ? D_s + (w % J) * W * QS : D_s;
      // PRB: off the grid the ring's rows; on it the deltas of a window's
      // first PJ - 2 chain windows also kept for its end term (keep, in
      // device memory; else stored twice)
      float* dk = dw;
      if constexpr (PRB && !DEEP) {
        if (off)
          dw = dk = DP_s() + (w % (probe_rows(pcode, pwin) / W)) * W * QS;
        else if (keep && w % PJ < PJ - 2)
          dk = dws_cta() + (w % PJ) * W * QS;
      }
      // a probe pushes pair e of rows (a, i) where they share a window of
      // pwin and it keeps the pushes, or lie in two and it keeps the advance
      // (bit e of off_pushed, grid_pushed); the others' sums are set to 0,
      // so that the chain pushes every pair, as B2's does (the pair_bf16
      // probes from 8 on, noadv and noadvmask, push every pair)
      if constexpr (PRB && SUB < W) {
        if (off || pwin < W || pcode == 0) {
          const unsigned pushed = off ? off_pushed(jw, pwin, pcode, arule)
                                      : grid_pushed(pwin, pcode, arule);
#pragma unroll
          for (int e = 0; e < NP; ++e)
            if (!((pushed >> e) & 1u)) hh[e] = 0.f;
        }
      }
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
        if constexpr (PRB) dk[e] = delta;
        // (a test that always holds: the pair_bf16 probes from 8 on are
        // noadv and noadvmask; it keeps ptxas from spilling the DEEP ones)
        if (!PRB || SUB < W || pcode != 0) {
#pragma unroll
          for (int a = i + 1; a < W; ++a)
            rr[a] += hh[a * (a - 1) / 2 + i] * delta;
        }
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
  if constexpr (DEEP) {
    deep_rows<FM_ON_CHIP, SUB, PRB>(FM_s, MB_s, fm_rows, mask_rows, x,
                                    nullptr, D_s, v, row0, nr, p, q, k, cvalid,
                                    warp, lane, arule != 0 ? p - SUB : -1,
                                    false, arule);
  } else if constexpr (PRB) {
    const float* xl =
        FM_ON_CHIP ? XS_s + ((nwin - 1) & 1) * xr * W : x + (p - W);
    if (exact) {
      window_pass<FM_ON_CHIP, true, false, RW>(FM_s, MB_s, fm_rows, mask_rows,
                                               xl, nullptr, D_s, v, nr, p, q,
                                               k, cvalid, warp, lane);
    } else if (arule == 0) {
      // noadv: no last advance
    } else if (off) {  // the windows since the last chain window's start
      const int jl = p - W;
      probe_off_rows<FM_ON_CHIP>(FM_s, MB_s, fm_rows, mask_rows, x, nullptr,
                                 DP_s(), v, row0, nr, p, q, k, cvalid, warp,
                                 lane, probe_rows(pcode, pwin), jl - jl % pwin,
                                 p, arule, false, false, 0, 0, 0, 0u);
    } else {  // the last chain window by the probe's rule
      window_pass<FM_ON_CHIP, true, false, RW, false, true>(
          FM_s, MB_s, fm_rows, mask_rows, xl, nullptr, D_s, v, nr, p, q, k,
          cvalid, warp, lane, arule);
    }
  } else
    window_pass<FM_ON_CHIP, true, false, RW>(
        FM_s, MB_s, fm_rows, mask_rows,
        FM_ON_CHIP ? XS_s + ((nwin - 1) & 1) * xr * W : x + (p - W),
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
    CLK_s[NCLK - 1] = clock64() - CLK_s[NCLK];
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

// sets the instance's shared memory and launches it on the config (PRB:
// the probe instance, the probe's code and window last in args)
template <bool FM_ON_CHIP, int SUB, bool PRB, typename... Args>
cudaError_t launch_instance(const cudaLaunchConfig_t& cfg, Args... args) {
  cudaError_t err;
  if constexpr (PRB)
    err = cudaFuncSetAttribute(
        sweep_missing_kernel<FM_ON_CHIP, SUB, true, MisProbe>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
  else
    err = set_smem<FM_ON_CHIP, SUB>(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  if constexpr (PRB)
    return cudaLaunchKernelEx(
        &cfg, sweep_missing_kernel<FM_ON_CHIP, SUB, true, MisProbe>, args...);
  else
    return cudaLaunchKernelEx(&cfg, sweep_missing_kernel<FM_ON_CHIP, SUB>,
                              args...);
}

// f(on_chip, sub) for the instance (or the probe instance) of
// (fm_on_chip, sub), both passed as compile-time constants
// (std::integral_constant)
template <typename F>
cudaError_t with_instance(bool on_chip, int sub, F f) {
#define ATLASQTL_MIS_SUB(S)                                     \
  case S:                                                       \
    return on_chip ? f(std::true_type{}, std::integral_constant<int, S>{}) \
                   : f(std::false_type{}, std::integral_constant<int, S>{})
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

// the shared-memory bytes of a CTA of the instance `sub` (under the probe
// of code probe >= 0 at window pwin, else probe -1) under the plan
// (cluster, fm_on_chip) at n samples and interpolation width R, or -1 where
// the kernel cannot take it
int plan_smem(int n, int cluster, int fm_on_chip, int R, int sub,
              int probe = -1, int pwin = 0) {
  if (n <= 0 || R <= 0 || R > RMAX || cluster < 1 || cluster > MAX_CLUSTER ||
      (!fm_on_chip && cluster != 1))
    return -1;
  const int nloc = fm_on_chip ? (n + cluster - 1) / cluster : 0;
  const size_t smem =
      smem_bytes(fm_on_chip != 0, nloc, R, sub,
                 probe >= 0 && sub == 0 ? probe_rows(probe, pwin) : 0);
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
// multiple of it).  probe >= 0 launches the probe instance of sub (0, or
// the pair_bf16 window pwin but under noseq) with that probe (0 noseq, 1
// noadv, 2 noadvmask, 3 every part kept) in windows of pwin predictors,
// any that divides p (the float32 probe instance keeps more deltas at
// some, its probe_rows: its shared memory counts them; the pair_bf16 probe
// instances are those of pwin = sub).  The float32 probe instance at a
// window of 3 or more chain windows on the grid reads, under noadv with Fm
// in device memory, fm0, Fm as the launch receives it (fm before the
// launch, which noadv restores), and under noseq and noadvmask writes dws,
// its deltas' workspace (m x grid x (pwin - 2 W) x 32 floats); elsewhere
// they may be null.
// Returns the CUDA error code of the launches (0 on success);
// cudaErrorInvalidValue for a shape, plan or window it does not take.
int atlasqtl_sweep_missing_fused(
    const float* x, const float* cp, const float* gam_in, const float* mu_in,
    const float* xns, const float* mask, const float* l_aug,
    const float* n_stack, float* fm, const float* theta, const float* p_mask,
    const float* zeta, const float* q_mask, const float* tauv,
    const float* scal, float* gam_out, float* mu_out, float* zrow_part,
    float* z_row, float* z_col, int n, int p, int q, int B, int R,
    int cluster, int fm_on_chip, int m, int sub, int probe, int pwin,
    const float* fm0, float* dws, void* stream) {
  const int n_slices = (q + QS - 1) / QS;
  const int nloc = fm_on_chip ? (n + cluster - 1) / cluster : 0;
  const int grid = n_slices * cluster;
  const int smem = plan_smem(n, cluster, fm_on_chip, R, sub, probe, pwin);
  // the float32 probe instance's window ends in window_edge
  const bool edge = sub == 0 && pwin % W == 0 && pwin > 2 * W;
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || q % 4 != 0 ||
      smem < 0 || m < 1 || m > 65535 || sub < 0 || (sub && B % sub != 0) ||
      (probe >= 0 &&
       (probe > 3 || pwin <= 0 || p % pwin != 0 ||
        (edge && probe == 1 && !fm_on_chip && !fm0) ||
        (edge && (probe == 0 || probe == 2) && !dws) ||
        (sub != 0 && (sub != pwin || probe == 0)))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(grid, m, smem, cluster, attr, st);
  auto run = [&](auto on, auto s, auto prb, auto... probe_args) {
    return launch_instance<decltype(on)::value, decltype(s)::value,
                           decltype(prb)::value>(
        cfg, x, cp, gam_in, mu_in, xns, mask, l_aug, n_stack, fm, theta,
        p_mask, zeta, q_mask, tauv, scal, gam_out, mu_out, zrow_part, z_col,
        n, p, q, R, nloc, probe_args...);
  };
  cudaError_t err = with_instance(fm_on_chip != 0, sub, [&](auto on, auto s) {
    return probe >= 0 ? run(on, s, std::true_type{},
                            MisProbe{probe, pwin, fm0, dws})
                      : run(on, s, std::false_type{});
  });
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

// The shared-memory bytes of one CTA of the instance `sub` (under the
// probe of code probe >= 0 at window pwin, else probe -1) under the plan
// (cluster, fm_on_chip) at n samples and interpolation width R; -1 for a
// plan the kernel does not take (the card checks
// ops/sweep_missing_fused.py:_mis_smem_bytes against it).
int atlasqtl_sweep_missing_smem(int n, int cluster, int fm_on_chip, int R,
                                int sub, int probe, int pwin) {
  return plan_smem(n, cluster, fm_on_chip, R, sub, probe, pwin);
}

// CTAs of the sweep kernel's instance `sub` resident on one SM and
// clusters resident on the card under the plan (cluster, fm_on_chip) at n
// samples and interpolation width R (the occupancy calculator), each -1 on
// error.
int atlasqtl_sweep_missing_occupancy(int n, int cluster, int fm_on_chip,
                                     int R, int sub, int* clusters) {
  *clusters = -1;
  const int smem = plan_smem(n, cluster, fm_on_chip, R, sub);
  if (smem < 0) return -1;
  int nb = -1;
  const cudaError_t err =
      with_instance(fm_on_chip != 0, sub, [&](auto on, auto s) {
        constexpr bool ON = decltype(on)::value;
        constexpr int S = decltype(s)::value;
        cudaError_t e = set_smem<ON, S>(smem);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &nb, sweep_missing_kernel<ON, S>, NT, smem);
        if (e != cudaSuccess) return e;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg =
            launch_config(cluster * 64, 1, smem, cluster, attr, nullptr);
        if (cudaOccupancyMaxActiveClusters(
                clusters, sweep_missing_kernel<ON, S>, &cfg) != cudaSuccess)
          *clusters = -1;
        return cudaSuccess;
      });
  return err == cudaSuccess ? nb : -1;
}

}  // extern "C"
