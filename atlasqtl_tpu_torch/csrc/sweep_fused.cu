// One whole complete-data Gauss-Seidel sweep of the global-local CAVI
// iteration, as one CUDA kernel for Hopper (sm_90a), plus a second small
// kernel that reduces the per-slice z_row partials in a fixed order; the
// lookahead schedule of the bf16 mode over whole blocks has a kernel of
// its own (sweep_lookahead_kernel, further down).
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
//
// The bf16 instance (BF = true) is the TPU kernel's mxu_bf16 mode
// (atlasqtl_tpu/ops/sweep_fused.py:151-160, 366-371): the two products
// take bfloat16 operands and accumulate in float32, here on the tensor
// cores (mma.sync m16n8k16 bf16 x bf16 -> f32, fed by ldmatrix), where the
// FP32 SIMT products took 74% of CTA 0's cycles.  What bounds it: the
// products' 4 n p q operations at the bf16 dense tensor rate (989
// TFLOP/s) take 2 ms per eQTL sweep, so the chain and the FP32 rest come
// first.  Its pass (bf16_pass, redesigned for the H100) is its own:
//  - chunks are NCHB = 64 sample rows (16 at n = 1000), and a step holds
//    ONE CTA barrier: step ch waits on its mbarrier for its copies, passes
//    the barrier, then advances chunk ch and projects chunk ch-1; thread 0
//    meanwhile stores F chunk ch-1 and loads chunk ch+1's F and x_{b-1}
//    and chunk ch's x_b into buffers last read in step ch-1;
//  - the copies are TMA tensor copies (6 at block 128: F's box of QS x 64
//    floats each way, x in 64 x 64 bf16 tiles): cp.async of 16 bytes a
//    thread, as the float32 instance stages, took half of each 64-row step
//    just to issue (CTA 0 at the eQTL cut on an H100: ~3,100 of ~6,200
//    cycles), one 1-D bulk copy per row longer still (~50 cycles each).  x
//    tiles take TMA's 128-byte swizzle (16-byte units XORed across 8 rows),
//    so that ldmatrix reads them without bank conflicts; F's 128-byte rows
//    at 32 columns take it too (the float2 fragment accesses conflict two
//    ways, not four), its 160-byte rows at 40 columns need none.  Rows past
//    n and columns past q or p arrive as zeros and are not stored back;
//  - the warps have two roles.  The last NAW = 4 warps advance, each its 16
//    chunk rows across the whole slice (QS/8 tiles of 16 x 8, one f32
//    accumulator each, over the block's depth in k order: QS/8 independent
//    chains of mma.sync m16n8k16 bf16 x bf16 -> f32, fed by ldmatrix);
//    each x_{b-1} fragment is read once per chunk.  Their B operand,
//    delta_{b-1} rounded to bf16, stays in registers for the pass at 32
//    columns (16 per column tile at B = 128); at 40 the 10 warps cap
//    ptxas at 168 registers and 80 more spill the chain's, so there it is
//    read from the delta tile each chunk.  A warp adds its accumulators to
//    F in the fragment layout (the one __fadd_rn per element, as before)
//    in F's stage, whence the TMA store takes it, and writes the bf16 copy
//    (rounded from the same f32 values) that the next step projects: no
//    advance partial goes through shared memory and no second barrier
//    hands it over.  The other warps (4 at QS = 32, 6 at 40) project,
//    each its one or two 16-row tiles of the block across the slice
//    (tiles w and w + 4 where fewer than 8 warps; at QS = 40 the two warps
//    with a second tile sit on the two schedulers that hold two warps, so
//    every scheduler issues 80 of the 320 mma of a 64-row step at B =
//    128), accumulated over the chunk's rows in row order across the pass:
//    each x_b fragment is read once per chunk; what is re-read is the small
//    bf16 F chunk (64 x QS).  The accumulation orders are the first
//    version's (32-row chunks, one warp per 16 x 8 tile), so the outputs
//    are its bit for bit;
//  - the pass is a function of its own, not inlined, so that ptxas
//    allocates its registers apart from the chain's;
//  - delta is rounded to bf16 once per block into its own tile (rows of
//    40 bf16, zero rows up to a multiple of 32); the chain keeps f32 delta;
//  - shared memory at QS = 40, B = 128, r + 2 = 42 (smem_bytes<40, true>):
//    the Gram triangle 8256 floats, the delta and projection tiles 10240,
//    the stages 24320 (256 for the 1024-byte boundary, F 2 x 64 x 40 =
//    5120, x 4 x 2 tiles of 64 x 64 bf16 = 16384, bf16 F 2 x 64 x 40 bf16
//    = 2560), the window tiles 2560, the nodes 5040, p_mask and theta 256,
//    zeta and q_mask 80, two mbarriers 4, the bf16 delta tile 2560: 53316
//    floats, 213264 bytes (the first version 185088);
//  - a block over BMAX (Bfull rows, walked in pieces of B) is the JAX
//    kernel's block: every piece is projected against the bf16 F of the
//    block's start, and sees the block's earlier pieces' deltas through
//    the float32 Gram, not through F.  The first piece's pass writes its
//    bf16 F chunks to a workspace (n x the slices' columns) as it makes
//    them; a later piece's pass stages them back by cp.async in place of
//    making them from the advanced F (F itself still advances piece by
//    piece, in f32).  Each piece but the last writes its f32 deltas to a
//    second workspace ((Bfull - B) rows), and before a later piece's chain
//    all threads add G[piece, earlier rows] x those deltas to its
//    projections (f32 FMAs in 4 x 4 register tiles, the Gram rows read
//    from the (p, Bfull) blocks).
// The bf16 instance's lookahead variant is the TPU kernel's
// one-block-lookahead schedule under mxu_bf16 (atlasqtl_tpu/ops/
// sweep_fused.py:166-184, 378-388), another function there: block b
// projects the bf16 F from before block b-1's advance and takes block
// b-1's float32 deltas through the float32 off-diagonal Gram goff[b-1] =
// x_b^T x_{b-1} ((p, Bfull) stacked, rows of block b).  Whole blocks run
// sweep_lookahead_kernel below, whose pass runs under the previous
// block's chain.  A block in pieces runs this kernel's LA = true instance,
// a serial schedule: every piece of block b projects the bf16 F of block
// b-1's start and takes all of block b-1's deltas, so both workspaces are
// kept two deep, by the block's parity: the bf16 F of each block's start
// (written by its first piece's pass, after the advance; read back by
// cp.async by every piece of the next block) and every piece's f32
// deltas (Bfull rows per block); after the pass and before the chain all
// threads add goff[b-1] x delta_{b-1} to the projections in f32 4 x 4
// register tiles, as the pieces' cross-Gram.
// The probe instances (PR != 0) are the TPU kernel's perf probes
// (atlasqtl_tpu/ops/sweep_fused.py:116-433, 509-519, Config.sweep_probe):
// the float32 instance with one part of the sweep dropped, in its plan
// (32 or 40 columns).  Every part is decided once per block, around a
// whole phase, never in the row loop: the pass drops its advance or its
// projection or reads block 0's x (dmalite), the logit and Z tiles their
// interpolation products, r takes X^T Y's rows without the projection.
// The chain is B1's own code, pushes and helper warps included: the
// pushes inside a window of the probe's window (any divisor of the block,
// on the 8-row grid or off it) and the corrections across windows that a
// probe drops, and the diagonal where it drops it, are zeros in the
// block's Gram triangle, written in place of the cp.async as it lands.
// Where a probe drops every term across chain windows of W rows (norank
// at a window that divides W, the Jacobi probes at any), the chain's
// shape skips them (PRI_NOCORR), and the pushes inside a chain window too
// where it drops those (the Jacobi probes: PRI_NOPUSH), so that the probe
// saves their time.  The clipped logit (nosig), bf16 x (under mxu_bf16: F
// and delta rounded at the products), dmalite's pin and the chain's shape
// are template bits (PrInst), so that no instance carries a runtime test
// in its products or its chain: at 40
// columns B1's f32 code takes 167 of ptxas's 168 registers, and a runtime
// pin spilled it.  The probe with every part kept is B1 and launches B1's
// float32 instance.  A block over BMAX (the 32-column instances only,
// PRI_PIECES: the pieces' code spilled at 40) is the JAX kernel's whole
// block: each piece projects the block-start F, the earlier pieces'
// deltas come through the f32 Gram per row, and the block advances after
// its last piece (the earlier pieces by scalar FMAs over device memory,
// before the next pass).
// Conversions use __float2bfloat16_rn (round to nearest even, as JAX's
// astype and torch's .to(bfloat16)); no TF32 anywhere.
#include <cuda.h>  // CUtensorMap (the TMA descriptors; no driver link)
#include <cuda_bf16.h>

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
constexpr int NCHB = 64;      // bf16 instance: sample rows per pass chunk
constexpr int NAW = 4;        // bf16 instance: advance warps, 16 rows each
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
// beside the eQTL-cut timing).  The lookahead kernel's overlapped schedule
// (sweep_lookahead_kernel) also writes the last three slots: the busy
// cycles of its first pass thread in the passes that run beside a chain,
// how many of them fall inside the chain thread's span, and the chain
// thread's wait for the helpers at the end of its windows.
__device__ long long g_clocks[NCLK + 3];

__host__ __device__ constexpr int xld(int B) { return B + 4; }  // x row
__host__ __device__ constexpr int gp_floats(int B) {  // packed triangle
  return (B * (B + 1) / 2 + 3) & ~3;
}
// the bf16 instance: a row of w bf16 padded to an odd number of 16-byte
// units, so that the 8 rows an ldmatrix reads fall in distinct banks
__host__ __device__ constexpr int ld16(int w) {
  return (w / 8) % 2 ? w : w + 8;
}
__host__ __device__ constexpr int b16(int B) { return (B + 15) & ~15; }
__host__ __device__ constexpr int xl16(int B) { return ld16(b16(B)); }
constexpr int HLD = 40;  // bf16 row of an F chunk or the delta tile
__host__ __device__ constexpr int kd32(int B) { return (B + 31) & ~31; }
// the bf16 instance's stages come by TMA: F in boxes of the slice's QS
// columns by NCHB rows, x in tiles of xw(B) columns (16, 32 or 64: a row of
// at most the 128 bytes of TMA's widest swizzle, which the 64-column tiles
// take, so that ldmatrix reads them without bank conflicts) by NCHB rows,
// nxt(B) across the block
__host__ __device__ constexpr int xw(int B) {
  return b16(B) <= 16 ? 16 : b16(B) <= 32 ? 32 : 64;
}
__host__ __device__ constexpr int nxt(int B) {
  return (b16(B) + xw(B) - 1) / xw(B);
}
// the pass stages and the advance partials after them (the bf16 instance:
// from the first 1024-byte boundary, the 128-byte swizzle's, two f32 F
// chunks, two x chunks each of x_{b-1} and x_b, two bf16 F chunks, all of
// NCHB rows, and no partials): between passes they hold the projection
// partials, the logit-constant tile and the rows of L
template <int QS, bool BF>
__host__ __device__ constexpr int pass_floats(int B) {
  return BF ? 256 + NCHB * (2 * QS + HLD) + 4 * nxt(B) * NCHB * xw(B) / 2
            : NSTAGE * NCH * QS + (NSTAGE + NXA) * NCH * xld(B) +
                  NG * NCH * QS;
}

// the packed Gram triangle, two B x QS tiles (deltas, projections), the
// pass stages and advance partials, three window tiles (corrections twice,
// cp and pre-sweep beta NRW times), the nodes, the block's p_mask and
// theta, the slice's zeta and q_mask; the bf16 instance's two mbarriers
// and bf16 delta tile
template <int QS, bool BF>
size_t smem_bytes(int B, int R) {
  return sizeof(float) * ((size_t)gp_floats(B) + 2 * B * QS +
                          pass_floats<QS, BF>(B) + (2 + 2 * NRW) * W * QS +
                          3 * R * QS + 2 * BMAX + 2 * QS +
                          (BF ? 4 + kd32(B) * HLD / 2 : 0));
}

// the between-pass tiles (the projection partials, none in the bf16
// instance, the new-gam tile in their place, the logit-constant tile, the
// rows of L) fit where the pass stages were
template <int QS, bool BF>
bool overlay_fits(int B, int R) {
  return (BF ? 2 : 4) * B * QS + B * R <= pass_floats<QS, BF>(B);
}

// ldmatrix: four 8 x 8 b16 matrices, thread t giving the address of row
// t % 8 of matrix t / 8 (16 contiguous bytes); .trans delivers each
// transposed
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
// the bf16 pass's staging: a TMA copy of one box of a tensor map (2-D: x;
// 3-D: F with its replica axis) into shared memory, completing on an
// mbarrier; the box's elements outside the tensor arrive as zeros
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c0, int c1,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(tm)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c0, int c1, int c2,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(tm)), "r"(c0), "r"(c1),
      "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
// the one arrival of a phase, which also expects `bytes` of copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// a TMA store of one box of shared memory to a 3-D tensor map (the box's
// elements outside the tensor are not written), in a bulk group of this
// thread's; commit the groups, wait until they have read their shared
// memory, or until they are done
__device__ __forceinline__ void tma_store(const void* src,
                                          const CUtensorMap* tm, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<unsigned long long>(tm)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// order this thread's generic-proxy accesses before later async-proxy
// ones (the TMA copies) to the same memory: all of it, or shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// two 8 x 8 b16 matrices, transposed: threads 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_t(unsigned* r, const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}
// four floats rounded to bf16 (nearest even) into 8 bytes of shared memory
__device__ __forceinline__ void st_bf16x4(__nv_bfloat16* dst, const float* f) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(f[0], f[1]);
  d[1] = __floats2bfloat162_rn(f[2], f[3]);
}

// the same four as one 8-byte value
__device__ __forceinline__ uint2 bf16x4(const float* f) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]),
                         __floats2bfloat162_rn(f[2], f[3])};
  return *reinterpret_cast<const uint2*>(h);
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

// The probe instances (PR != 0; ops/sweep_fused.py:Probe, PROBES): the
// runtime code has one bit per part of the sweep kept, then the diagonal's
// bit and bf16 x (Probe.code).  The sigmoid's bit, bf16 x, dmalite's pin
// and the chain's shape pick the instance (PrInst: PR's bits); the others
// are read once per block.
enum PrBits : int {
  PR_TILES = 1, PR_PROJ = 2, PR_PUSHES = 4, PR_CORR = 8, PR_SIGMOID = 16,
  PR_ADVANCE = 32, PR_MILLS = 64, PR_PIN = 128, PR_DIAG = 256, PR_XBF = 512
};
enum PrInst : int {
  PRI_ON = 1, PRI_CLIP = 2, PRI_XBF = 4, PRI_PIECES = 8, PRI_PIN = 16,
  PRI_NOPUSH = 32, PRI_NOCORR = 64
};

// f rounded to bf16 (nearest even) and back
__device__ __forceinline__ float bf16r(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// the four bf16 values of a staged x row (XL floats holding B bf16) from
// column k, as floats: the probe instances under bf16 x
__device__ __forceinline__ void ldh4(const float* row, int k, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(
      reinterpret_cast<const char*>(row) + 2 * k);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// the probe instance's update of one coordinate under nosig: chain_step
// with the logit clipped to [0, 1] in place of its sigmoid
__device__ __forceinline__ ChainStep clip_step(float ct, float cp, float r,
                                               float ad, float cinv,
                                               float bo) {
  ChainStep s;
  s.mu = __fmul_rn(ct, __fsub_rn(cp, r));
  const float logit = fmaf(__fmul_rn(s.mu, s.mu), cinv, ad);
  s.gam = fminf(fmaxf(logit, 0.f), 1.f);
  s.bnew = __fmul_rn(s.gam, s.mu);
  s.delta = __fsub_rn(s.bnew, bo);
  return s;
}

// One pass of the bf16 instance over the samples: F += x_{b-1} delta_{b-1}
// (adv), r0 = x_b^T F into R_s (proj).  Its own function, so that ptxas
// allocates its registers (the advance warps hold delta's fragments, 16 per
// column tile) apart from the rest of the kernel's, whose live values the
// call saves once per pass; returns the mbarriers' next parities.
struct BfPass {
  __nv_bfloat16* fh_ws;  // the block-start bf16 F workspace, this replica's
  const CUtensorMap* tm_x;
  const CUtensorMap* tm_f;
  float* R_s;                  // B x QS projections
  float* stages;               // the pass stages
  unsigned long long* MB;      // the two mbarriers, then the bf16 deltas
  int n, k0, B, j0, nch, qsw, par, par_prev;
  bool adv, proj, from_ws, to_ws;
};

template <int QS>
__device__ __noinline__ unsigned bf16_pass(const BfPass a,
                                           unsigned mb_phase) {
  using S = Slice<QS>;
  constexpr int NW = S::NW, NTL = QS / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  __nv_bfloat16* const fh_ws = a.fh_ws;
  const CUtensorMap* const tm_x = a.tm_x;
  const CUtensorMap* const tm_f = a.tm_f;
  float* const R_s = a.R_s;
  unsigned long long* const MB = a.MB;
  const int n = a.n, k0 = a.k0, B = a.B, j0 = a.j0, nch = a.nch;
  // the stages: from the first 1024-byte boundary (the 128-byte swizzle's),
  // 2 x NCHB x QS f32 F chunks, four x chunks (x_{b-1} twice, then x_b
  // twice) of nxt(B) tiles of NCHB x xw(B) bf16, 2 x NCHB x HLD bf16 F
  // chunks; after the mbarriers the kd32(B) x HLD bf16 deltas of the
  // latest block
  float* const FA_s =
      a.stages + ((1024 - (smem_u32(a.stages) & 1023)) & 1023) / 4;
  char* const XT_s = reinterpret_cast<char*>(FA_s + 2 * NCHB * QS);
  __nv_bfloat16* const FH_h =
      reinterpret_cast<__nv_bfloat16*>(XT_s + 8 * nxt(B) * NCHB * xw(B));
  const __nv_bfloat16* const DH_h =
      reinterpret_cast<const __nv_bfloat16*>(MB + 2);
  const int qsw = a.qsw, par = a.par, par_prev = a.par_prev;
  const bool adv = a.adv, proj = a.proj, from_ws = a.from_ws,
             to_ws = a.to_ws;
  const int B16 = b16(B);
  // chunk ch (NCHB rows) is advanced in step ch (of 0 .. nch) by the last
  // NAW warps, each its 16 rows across the slice, and projected in step
  // ch + 1 by the others, each its one or two 16-row tiles of the block
  // across the slice: x_{b-1} and x_b are each read by one warp.  In step
  // ch thread 0 stores the advanced F chunk ch-1 and loads chunk ch+1's F
  // and x_{b-1} and chunk ch's x_b, by TMA (6 tensor copies at block 128),
  // into buffers last read in step ch-1 (F's once the store has read it);
  // the loads complete on mbarrier (ch+1) & 1, so each step starts at its
  // wait and the one barrier
  constexpr int NPW = NW - NAW;
  // the byte offset of (row, col) in an F chunk of rows of QS floats, col
  // even: at 32 columns 16-byte units swizzled across 8 rows (TMA's
  // 128-byte swizzle), at 40 (160-byte rows, whose float2 accesses by a
  // half-warp, rows gr .. gr + 3, fall in distinct banks) as they are
  auto foff = [](int row, int col) {
    return QS == 32 ? row * 128 + ((((col >> 2) ^ (row & 7)) << 4) |
                                   ((col & 3) << 2))
                    : (row * QS + col) * 4;
  };
  const int XW = xw(B), XS = XW == 64 ? 6 : XW == 32 ? 5 : 4;
  const int XRB = 2 * XW, XCH = nxt(B) * NCHB * XRB;  // bytes
  // the byte offset of (row, col) in an x chunk, col a multiple of 8:
  // 16-byte units swizzled across 8 rows in 128-byte tile rows
  auto xoff = [&](int row, int col) {
    const int u = (col & (XW - 1)) >> 3;
    return (col >> XS) * (NCHB * XRB) + row * XRB +
           ((XW == 64 ? u ^ (row & 7) : u) << 4);
  };
  auto issue = [&](int ch) {  // thread 0, in step ch (-1: before it)
    const bool store = adv && ch >= 1;
    if (store) {  // F chunk ch-1, advanced; rows past n, columns past q
      // are not written
      tma_store(FA_s + ((ch - 1) & 1) * NCHB * QS, tm_f, k0, (ch - 1) * NCHB,
                blockIdx.y);
      bulk_commit();
    }
    if (ch == nch) return;
    const int cf = ch + 1;  // the copies step cf reads
    const bool fnext = cf < nch, xnext = proj && ch >= 0;
    unsigned long long* bar = MB + (cf & 1);
    mbar_expect(bar, (fnext ? NCHB * QS * 4 + (adv ? XCH : 0) : 0) +
                         (xnext ? XCH : 0));
    if (xnext)
      for (int t = 0; t < nxt(B); ++t)
        tma_load(XT_s + (2 + (ch & 1)) * XCH + t * NCHB * XRB, tm_x,
                 j0 + t * XW, ch * NCHB, bar);
    if (fnext) {
      if (adv)
        for (int t = 0; t < nxt(B); ++t)
          tma_load(XT_s + (cf & 1) * XCH + t * NCHB * XRB, tm_x,
                   j0 - B + t * XW, cf * NCHB, bar);
      if (store) bulk_wait_read();  // the store has read F's buffer
      tma_load(FA_s + (cf & 1) * NCHB * QS, tm_f, k0, cf * NCHB, blockIdx.y,
               bar);
    }
  };
  auto sync_step = [&](int ch) {  // step ch's copies; the one barrier
    mbar_wait(MB + (ch & 1), (mb_phase >> (ch & 1)) & 1);
    mb_phase ^= 1u << (ch & 1);
    cp_async_wait<0>();  // this thread's copies have landed
    __syncthreads();     // ... everyone's; step ch-1's reads are done
  };
  cp_async_commit();  // the Gram triangle, p_mask and theta
  if (tid == 0) issue(-1);
  if (warp >= NPW) {
    // ---- the advance: F += x_{b-1} delta_{b-1} on chunk rows a16..,
    // one accumulator per 8-column tile, each over the depth in k
    // order; added to F in the fragments, rounded to bf16 there.  At 32
    // columns delta's B fragments stay in registers for the pass (8 warps
    // leave ptxas 255 registers); at 40 the 10 warps cap it at 168, where
    // 80 more would spill the chain's, so they come from the delta tile
    // each chunk (4 ldmatrix per 16 x 8 tile)
    constexpr bool DREG = QS == 32;
    const int a16 = (warp - NPW) * 16, nks = B16 / 16;
    unsigned dr[DREG ? BMAX / 16 : 1][NTL][2];  // delta's B fragments
    if (DREG && adv)
#pragma unroll
      for (int ks = 0; ks < BMAX / 16; ks += 2)
        if (ks < nks)
#pragma unroll
          for (int t = 0; t < NTL; ++t) {
            unsigned bq[4];
            ldsm_x4_t(bq, DH_h + (ks * 16 + lane) * HLD + t * 8);
            dr[ks][t][0] = bq[0];
            dr[ks][t][1] = bq[1];
            dr[ks + 1][t][0] = bq[2];
            dr[ks + 1][t][1] = bq[3];
          }
    for (int ch = 0; ch <= nch; ++ch) {
      sync_step(ch);
      if (ch == nch || ch * NCHB + a16 >= n) continue;
      float d[NTL][4];
#pragma unroll
      for (int t = 0; t < NTL; ++t)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) d[t][jj] = 0.f;
      if (adv) {
        const char* xa = XT_s + (ch & 1) * XCH;
        const int row = a16 + (lane & 15), c8 = (lane >> 4) * 8;
        if constexpr (DREG) {
#pragma unroll
          for (int ks = 0; ks < BMAX / 16; ++ks)
            if (ks < nks) {
              unsigned a[4];
              ldsm_x4(a, xa + xoff(row, ks * 16 + c8));
#pragma unroll
              for (int t = 0; t < NTL; ++t)
                mma_bf16(d[t], a, dr[ks][t][0], dr[ks][t][1]);
            }
        } else {
          for (int ks = 0; ks < nks; ks += 2) {
            unsigned a0[4], a1[4];
            ldsm_x4(a0, xa + xoff(row, ks * 16 + c8));
            if (ks + 1 < nks) ldsm_x4(a1, xa + xoff(row, ks * 16 + 16 + c8));
#pragma unroll
            for (int t = 0; t < NTL; ++t) {
              unsigned bq[4];
              ldsm_x4_t(bq, DH_h + (ks * 16 + lane) * HLD + t * 8);
              mma_bf16(d[t], a0, bq[0], bq[1]);
              if (ks + 1 < nks) mma_bf16(d[t], a1, bq[2], bq[3]);
            }
          }
        }
      }
      // F (b > 0: + the advance, the one f32 add, back into its stage
      // for the store), its bf16 copy that the next step projects (unless
      // the workspace's), the block-start F of the workspace (LA: for the
      // next block only)
      char* fs = reinterpret_cast<char*>(FA_s + (ch & 1) * NCHB * QS);
      __nv_bfloat16* fh = FH_h + (ch & 1) * NCHB * HLD;
#pragma unroll
      for (int t = 0; t < NTL; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = a16 + gr + 8 * h, col = t * 8 + 2 * tq;
          const int nr = ch * NCHB + row;
          float2* fp = reinterpret_cast<float2*>(fs + foff(row, col));
          float2 f = *fp;
          if (adv) {
            f.x = __fadd_rn(f.x, d[t][2 * h]);
            f.y = __fadd_rn(f.y, d[t][2 * h + 1]);
            *fp = f;
          }
          if (proj && (!from_ws || to_ws)) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
            if (!from_ws)
              *reinterpret_cast<__nv_bfloat162*>(fh + row * HLD + col) = v;
            if (to_ws && nr < n)
              *reinterpret_cast<__nv_bfloat162*>(
                  fh_ws + ((size_t)par * n + nr) * qsw + k0 + col) = v;
          }
        }
      if (adv) fence_proxy_async_smem();  // before the TMA store reads it
    }
  } else {
    // ---- the projection: r0 += x_b^T F on the block's 16-row tiles
    // mt0 = warp and, where the warps are fewer than the tiles, mt1 =
    // warp + 4, over the chunk's rows in order, 16 at a time
    const int mt0 = warp, mt1 = warp + 4;
    const bool two = mt1 >= NPW && mt1 < BMAX / 16 && mt1 * 16 < B16;
    const bool one = mt0 * 16 < B16;
    float pr[2][NTL][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < NTL; ++t)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) pr[i][t][jj] = 0.f;
    const int mi = lane >> 3, r8 = lane & 7;
    for (int ch = 0; ch <= nch; ++ch) {
      sync_step(ch);
      if (tid == 0) issue(ch);
      if (from_ws && ch < nch) {  // the block-start bf16 F chunk ch
        for (int e = tid; e < NCHB * QS / 8; e += NPW * 32) {
          const int r = e / (QS / 8), c8 = (e % (QS / 8)) * 8;
          const bool ok = ch * NCHB + r < n;
          cp_async16_zfill(
              FH_h + (ch & 1) * NCHB * HLD + r * HLD + c8,
              fh_ws + ((size_t)par_prev * n + (ok ? ch * NCHB + r : 0)) *
                          qsw + k0 + c8,
              ok);
        }
        cp_async_commit();
      }
      if (!proj || ch == 0 || !one) continue;
      const int c = ch - 1;
      const __nv_bfloat16* fh = FH_h + (c & 1) * NCHB * HLD;
      const char* xp = XT_s + (2 + (c & 1)) * XCH;
#pragma unroll
      for (int kh = 0; kh < NCHB / 32; ++kh) {
        if (c * NCHB + kh * 32 >= n) break;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k16 = kh * 32 + ks * 16;  // the chunk's rows k16..
          if (c * NCHB + k16 >= n) break;
          unsigned a[2][4];  // x_b's A fragments of the warp's tiles
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i == 0 || two)
              ldsm_x4_t(a[i], xp + xoff(k16 + (mi >> 1) * 8 + r8,
                                        (i ? mt1 : mt0) * 16 + (mi & 1) * 8));
#pragma unroll
          for (int t = 0; t < NTL; ++t) {
            unsigned b[2];  // F's B fragment: rows k16.., columns t*8..
            ldsm_x2_t(b, fh + (k16 + (lane & 15)) * HLD + t * 8);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (i == 0 || two) mma_bf16(pr[i][t], a[i], b[0], b[1]);
          }
        }
      }
    }
    if (proj && one)  // the tiles are whole: into R_s
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i == 0 || two)
#pragma unroll
          for (int t = 0; t < NTL; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = (i ? mt1 : mt0) * 16 + gr + 8 * h;
              if (row < B)
                *reinterpret_cast<float2*>(R_s + row * QS + t * 8 +
                                           2 * tq) =
                    make_float2(pr[i][t][2 * h], pr[i][t][2 * h + 1]);
            }
  }
  if (tid == 0) bulk_wait();  // the stores are done: the next pass loads F
  return mb_phase;
}

// A probe instance's template flags (PrInst) but its clipped logit and
// bf16 x: whether it takes a block over BMAX in pieces (its 32-column
// instances), pins x and X^T Y to block 0 (dmalite), and its chain's
// shape: without the terms across chain windows (the chain's own of the
// previous window and the helper warps' of the earlier ones), and then
// also without the pushes inside a chain window, where the probe drops
// every such term at its window (the launch decides).  At 40 columns B1's
// f32 code takes 167 of ptxas's 168 registers: the pieces' runtime count
// and workspace, or the pin's offsets as runtime values, spill it.  They
// live here, not among the kernel's locals: a local added to or dropped
// from sweep_fused_kernel moves the machine code of its bf16 instances
// (tools/sass_diff), though they never read it.
template <int PR> struct PrShape {
  static constexpr bool PIECES = PR & PRI_PIECES, PIN = PR & PRI_PIN,
                        NOPUSH = PR & PRI_NOPUSH, NOCORR = PR & PRI_NOCORR;
};

template <int QS, bool BF, bool LA, int PR = 0>
__global__ void __launch_bounds__(Slice<QS>::NT, 1) sweep_fused_kernel(
    const void* __restrict__ x_any,     // (n, p), float (bf16 if BF)
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
    const float* __restrict__ gram_full,  // bf16, PR, Bfull > B: (p, Bfull)
    const float* __restrict__ goff,       // LA: (p, Bfull)
    __nv_bfloat16* __restrict__ fh_ws,  // bf16, Bfull > B: ([2,] n, slices
                                        // x QS), two if LA
    float* __restrict__ dw_ws,          // bf16, Bfull > B: (Bfull - B, ..),
                                        // LA (2 Bfull, ..)
    int n, int p, int q, int B, int R, int c_one, int cp_batched, int Bfull,
    const __grid_constant__ CUtensorMap tm_x,   // bf16: x, boxes of xw(B)
                                                // x NCHB; PR: code, window
    const __grid_constant__ CUtensorMap tm_f) {  // bf16: fitted (m, n, q),
                                                 // boxes of QS x NCHB
  static_assert(BF || !LA, "lookahead: a variant of the bf16 instance");
  static_assert(!PR || (!BF && !LA), "the probe instance: the f32 schedule");
  // the probe's clipped logit (nosig) and bf16 x (mxu_bf16); its other
  // template flags are PS's
  constexpr bool CLIP = PR & PRI_CLIP, XBF = PR & PRI_XBF;
  using PS = PrShape<PR>;
  using S = Slice<QS>;
  // the bf16 instance's workspaces: row stride of all slices' columns
  const int qsw = gridDim.x * QS;
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
    if (fh_ws != nullptr) {
      fh_ws += r * (LA ? 2 : 1) * (size_t)n * qsw;
      dw_ws += r * (size_t)(LA ? 2 * Bfull : Bfull - B) * qsw;
    }
    if constexpr (PS::PIECES)  // its deltas of a block's earlier pieces
      if (dw_ws != nullptr) dw_ws += r * (size_t)(Bfull - B) * qsw;
  }
  constexpr int NT = S::NT, NW = S::NW, TC = S::TC, WQ = S::WQ;
  constexpr int H0 = S::NCW * 32;  // the first thread of the helper warps
  static_assert(!BF || (NW > NAW && NW - NAW <= BMAX / 16 &&
                         2 * (NW - NAW) >= BMAX / 16 && NAW * 16 == NCHB),
                "bf16: NAW advance warps of 16 chunk rows; the projection's "
                "16-row tiles of the block, one or two per other warp");
  extern __shared__ __align__(16) float smem[];
  const float* __restrict__ x = static_cast<const float*>(x_any);
  const int XL = xld(B), BQ = B * QS;
  float* GP_s = smem;                         // packed lower Gram triangle
  float* D_s = GP_s + gp_floats(B);           // B x QS deltas
  float* R_s = D_s + BQ;                      // B x QS projections
  float* F_s = R_s + BQ;                      // NSTAGE x NCH x QS F chunks
  float* XB_s = F_s + NSTAGE * NCH * QS;      // NSTAGE x NCH x XL x_b chunks
  float* XA_s = XB_s + NSTAGE * NCH * XL;     // NXA x NCH x XL x_{b-1}
  float* AP_s = XA_s + NXA * NCH * XL;        // NG x NCH x QS advance
  float* C_s = AP_s + NG * NCH * QS;          // 2 x W x QS corrections
  // bf16: the stages of bf16_pass
  if constexpr (BF) C_s = F_s + pass_floats<QS, BF>(B);
  float* CPW_s = C_s + 2 * WQ;                // NRW x W x QS X^T Y rows
  float* BOW_s = CPW_s + NRW * WQ;            // NRW x W x QS pre-sweep beta
  float* N_s = BOW_s + NRW * WQ;              // 3 x R x QS node values
  float* PM_s = N_s + 3 * R * QS;             // the block's p_mask
  float* TH_s = PM_s + BMAX;                  // the block's theta
  float* ZQ_s = TH_s + BMAX;                  // the slice's zeta, q_mask
  // bf16: the two mbarriers of the pass's TMA copies (steps by parity),
  // then kd32(B) x HLD bf16 deltas of the latest block
  auto MB = [&] {
    return reinterpret_cast<unsigned long long*>(ZQ_s + 2 * QS);
  };
  // between passes the stages hold the (NG-1) projection partials (none in
  // the bf16 instance), then the new-gam tile in their place, the
  // logit-constant tile (after the chain: the z_row partials) and the rows
  // of L of the block
  float* PP_s = F_s;
  float* GT_s = F_s;
  float* AD_s = F_s + (BF ? 1 : NG - 1) * BQ;
  float* ZR_s = AD_s;
  float* L_s = AD_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int k0 = blockIdx.x * QS;
  const float c = scal[0], kz = scal[1];
  // a probe instance's code (PrBits) and window ride in tm_x's first 8
  // bytes, which only the bf16 instance reads: read as a kernel parameter
  // they cost no register, and the production instances keep their
  // signature
  int pcode = 0, psub = W;
  if constexpr (PR) {
    pcode = (int)(tm_x.opaque[0] & 0xffffffffu);
    psub = (int)(tm_x.opaque[0] >> 32);
  }
  const int nb = p / B, nwin = B / W;
  const int npc = BF || PS::PIECES ? Bfull / B : 1;  // pieces of a block
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
  const int nch = BF ? (n + NCHB - 1) / NCHB : (n + NCH - 1) / NCH;
  // the probe instance's parts (PrBits; every other instance keeps all),
  // each decided once per block around a whole phase: the tiles, the
  // projection, the pushes inside a window of psub rows and the
  // corrections across windows, the advance, the Mills tiles, the diagonal
  // taken off r.  The chain is B1's:
  // a probe's dropped pushes, corrections and diagonal are zeros in the
  // block's Gram triangle, which B1's chain, pushes and helper warps read;
  // the pin is PS::PIN in the pass, k_pin in the pieces' advance
  const bool k_tiles = !PR || (pcode & PR_TILES),
             k_proj = !PR || (pcode & PR_PROJ),
             k_push = !PR || (pcode & PR_PUSHES),
             k_corr = !PR || (pcode & PR_CORR),
             k_adv = !PR || (pcode & PR_ADVANCE),
             k_mills = !PR || (pcode & PR_MILLS),
             k_pin = PR && (pcode & PR_PIN),
             k_diag = !PR || (pcode & PR_DIAG);
  const __nv_bfloat16* __restrict__ xh =
      static_cast<const __nv_bfloat16*>(x_any);  // XBF
  const float* const cp0 = cp;  // PR: X^T Y (dmalite reads block 0's rows)

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
  unsigned mb_phase = 0;  // bf16: the parity of each mbarrier's next phase
  if constexpr (BF) {
    if (tid == 0) {
      mbar_init(MB());
      mbar_init(MB() + 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
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
    // bf16, a block in pieces: piece kp of its whole block bb; the first
    // piece's pass saves the block-start bf16 F, a later piece's projects
    // it (LA: every piece of block bb projects block bb-1's, so the first
    // piece's pass of a block after the first projects it too)
    const int kp = b % npc, bb = b / npc;
    const bool to_ws = BF && npc > 1 && proj && kp == 0;
    const bool from_ws = BF && npc > 1 && proj && (kp > 0 || (LA && bb > 0));
    // LA: the workspaces by the block's parity: this block's start F and
    // deltas in the one, the previous block's in the other (kept as two
    // parities, not four pointers, for the registers)
    const int par = LA ? bb & 1 : 0, par_prev = LA && bb > 0 ? par ^ 1 : 0;
    // the x columns this pass projects and advances by, and whether it
    // does each: the probe instance drops either by its code, pins x and
    // X^T Y to block 0 under dmalite, and advances a block in pieces once,
    // after its last piece (a later piece projects the block-start F, the
    // earlier pieces come in through the Gram): this pass by the last
    // piece, the loop below by the others first
    const int jxp = PS::PIN ? kp * B : j0;
    const int jxa = PS::PIN ? ((b + npc - 1) % npc) * B : j0 - B;
    const bool dadv = PR ? adv && k_adv && kp == 0 : adv;
    const bool dproj = PR ? proj && k_proj : proj;
    if constexpr (PR) {
      if constexpr (PS::PIN) cp = cp0 + (ptrdiff_t)(jxp - j0) * q;
    }
    if constexpr (PS::PIECES) {
      if (dadv && npc > 1) {
        // F += x_e delta_e for the previous block's pieces e < npc - 1
        // (deltas from the workspace into R_s, x rows into the x_{b-1}
        // stage as f32, F in device memory), one chunk of rows at a time
        const int jcol = k_pin ? 0 : j0 - Bfull;
        for (int e = 0; e < npc - 1; ++e) {
          for (int t = tid; t < BQ; t += NT) {
            const float d =
                dw_ws[(size_t)(e * B + t / QS) * qsw + k0 + t % QS];
            R_s[t] = XBF ? bf16r(d) : d;
          }
          for (int n0 = 0; n0 < n; n0 += NCH) {
            for (int t = tid; t < NCH * B; t += NT) {
              const int r = t / B, k = t % B;
              const size_t o = (size_t)(n0 + r) * p + jcol + e * B + k;
              XA_s[r * XL + k] = n0 + r >= n ? 0.f
                                 : XBF      ? __bfloat162float(xh[o])
                                            : x[o];
            }
            __syncthreads();
            for (int t = tid; t < NCH * QS; t += NT) {
              const int r = t / QS, col = t % QS;
              if (n0 + r >= n || k0 + col >= q) continue;
              float s = 0.f;
              for (int k = 0; k < B; ++k)
                s = fmaf(XA_s[r * XL + k], R_s[k * QS + col], s);
              float* f = fitted + (size_t)(n0 + r) * q + k0 + col;
              *f = __fadd_rn(*f, s);
            }
            __syncthreads();
          }
        }
      }
    }

    // ---- one pass over the samples: advance by block b-1, project b -------
    // the projection's accumulators (f32: 8 x 8 register tiles; the bf16
    // pass keeps its own)
    constexpr int AM = 8, AN = 8;
    float acc[AM][AN];
#pragma unroll
    for (int a = 0; a < AM; ++a)
#pragma unroll
      for (int jj = 0; jj < AN; ++jj) acc[a][jj] = 0.f;
    if (proj) {  // the block's lower Gram triangle, packed; p_mask, theta
      for (int i = warp; i < B; i += NW) {
        if constexpr (PR) {
          // the probe's Gram: row m's delta reaches row i (block rows kp B
          // + m, kp B + i) as a push where both lie in one window of psub,
          // else as a correction; the entries of what it drops are zeros
          const int ws = (kp * B + i) / psub * psub - kp * B;
          for (int m = tid & 31; m <= i; m += 32) {
            if (m == i ? k_diag : m >= ws ? k_push : k_corr)
              cp_async4(GP_s + i * (i + 1) / 2 + m,
                        gram + (size_t)(j0 + i) * B + m);
            else
              GP_s[i * (i + 1) / 2 + m] = 0.f;
          }
        } else {
          for (int m = tid & 31; m <= i; m += 32)
            cp_async4(GP_s + i * (i + 1) / 2 + m,
                      gram + (size_t)(j0 + i) * B + m);
        }
      }
      for (int e = tid; e < B / 2; e += NT)
        cp_async16(e < B / 4 ? PM_s + 4 * e : TH_s + 4 * (e - B / 4),
                   (e < B / 4 ? p_mask + 4 * e : theta + 4 * (e - B / 4)) + j0);
    }
    const int last = proj ? nch : nch - 1;
    if (PR && !dadv && !dproj) {
      // the probe drops both products: no pass
    } else if constexpr (BF) {
      mb_phase = bf16_pass<QS>(
          BfPass{fh_ws, &tm_x, &tm_f, R_s, F_s, MB(), n, k0, B, j0, nch, qsw,
                 par, par_prev, adv, proj, from_ws, to_ws},
          mb_phase);
    } else {
      auto stage = [&](int ch) {
        float* fst = F_s + (ch % NSTAGE) * NCH * QS;
        float* xbst = XB_s + (ch % NSTAGE) * NCH * XL;
        float* xast = XA_s + (ch % NXA) * NCH * XL;
        const int n0 = ch * NCH;
        for (int e = tid; e < NCH * TC; e += NT) {
          const int r = e / TC, c4 = (e % TC) * 4;
          const bool ok = n0 + r < n && k0 + c4 < q;
          cp_async16_zfill(
              fst + r * QS + c4,
              ok ? fitted + (size_t)(n0 + r) * q + k0 + c4 : fitted, ok);
        }
        if constexpr (XBF) {  // the probe under bf16 x: B values of a row
          for (int e = tid; e < NCH * B / 8; e += NT) {
            const int r = e / (B / 8), c8 = (e % (B / 8)) * 8;
            const bool ok = n0 + r < n;
            const __nv_bfloat16* row = xh + (size_t)(ok ? n0 + r : 0) * p + c8;
            if (dadv)
              cp_async16_zfill(
                  reinterpret_cast<__nv_bfloat16*>(xast + r * XL) + c8,
                  row + jxa, ok);
            if (dproj)
              cp_async16_zfill(
                  reinterpret_cast<__nv_bfloat16*>(xbst + r * XL) + c8,
                  row + jxp, ok);
          }
        } else {
          for (int e = tid; e < NCH * B / 4; e += NT) {
            const int r = e / (B / 4), c4 = (e % (B / 4)) * 4;
            const bool ok = n0 + r < n;
            const float* row = x + (size_t)(ok ? n0 + r : 0) * p + c4;
            if (dadv)
              cp_async16_zfill(xast + r * XL + c4,
                               PR ? row + jxa : row + j0 - B, ok);
            if (dproj)
              cp_async16_zfill(xbst + r * XL + c4, PR ? row + jxp : row + j0,
                               ok);
          }
        }
      };
      stage(0);
      cp_async_commit();
      // chunk ch is advanced in step ch and projected in step ch + 1, so each
      // step ends at one barrier besides the one that hands over the
      // advance's partial sums
      for (int ch = 0; ch <= last; ++ch) {
        cp_async_wait<0>();  // chunk ch has landed (this thread's)
        __syncthreads();     // ... everyone's; chunk ch-1 is advanced, ch-2
                             // projected, so the stages of ch+1 are free
        if (ch + 1 < nch) stage(ch + 1);
        cp_async_commit();
        float* fs = F_s + (ch % NSTAGE) * NCH * QS;
        const float* xa = XA_s + (ch % NXA) * NCH * XL;
        const bool adv_ch = dadv && ch < nch;
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
              if constexpr (XBF)
                ldh4(xa + (ar * 4 + r) * XL, kk, xr[r]);
              else
                unpack4(ld4(xa + (ar * 4 + r) * XL + kk), xr[r]);
  #pragma unroll
            for (int s = 0; s < 4; ++s) {
              float d[4];
              unpack4(ld4(D_s + (kk + s) * QS + ac), d);
              if constexpr (XBF) {
  #pragma unroll
                for (int jj = 0; jj < 4; ++jj) d[jj] = bf16r(d[jj]);
              }
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
        if (dproj && prow && ch > 0) {  // r0 += x_b^T F over chunk ch-1
          const float* fp = F_s + ((ch - 1) % NSTAGE) * NCH * QS;
          const float* xp = XB_s + ((ch - 1) % NSTAGE) * NCH * XL;
  #pragma unroll(QS == 32 ? 2 : 1)
          for (int r = g * 8; r < g * 8 + 8; ++r) {
            float xv[8], fv[8];
            if constexpr (XBF) {
              ldh4(xp + r * XL, pi * 8, xv);
              ldh4(xp + r * XL, pi * 8 + 4, xv + 4);
            } else {
              unpack4(ld4(xp + r * XL + pi * 8), xv);
              unpack4(ld4(xp + r * XL + pi * 8 + 4), xv + 4);
            }
            unpack4(ld4(fp + r * QS + pc), fv);
            unpack4(ld4(fp + r * QS + pc + 4), fv + 4);
            if constexpr (XBF) {
  #pragma unroll
              for (int a = 0; a < 8; ++a) fv[a] = bf16r(fv[a]);
            }
  #pragma unroll
            for (int a = 0; a < AM; ++a)
  #pragma unroll
              for (int jj = 0; jj < AN; ++jj)
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
    if (!BF && g > 0 && prow) {  // (the bf16 pass wrote R_s itself)
#pragma unroll
      for (int a = 0; a < AM; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(PP_s + (g - 1) * BQ +
                                     (pi * 8 + a) * QS + pc + 4 * h) =
              make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                          acc[a][4 * h + 3]);
    }
    cp_async_wait<1>();  // L and window 0's rows (window 1's may fly on)
    __syncthreads();
    // the logit-constant tile ad = base + L_b N_ad (4 x 4 per thread); a
    // probe without the tiles takes u = theta + zeta
    if (PR && trow && !k_tiles) {
      float zeta4[4];
      unpack4(ld4(ZQ_s + tx * 4), zeta4);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          AD_s[(ty * 4 + a) * QS + tx * 4 + jj] =
              __fadd_rn(TH_s[ty * 4 + a], zeta4[jj]);
    } else if (trow) {
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
    if (!BF && g == 0 && prow)
#pragma unroll
      for (int a = 0; a < AM; ++a)
#pragma unroll
        for (int jj = 0; jj < AN; ++jj) {
          const int e = (pi * 8 + a) * QS + pc + jj;
          float r = acc[a][jj];
#pragma unroll
          for (int h = 0; h < NG - 1; ++h) r = __fadd_rn(r, PP_s[h * BQ + e]);
          R_s[e] = r;
        }
    __syncthreads();  // R_s is whole: the partials' room takes the gam tile
    // R_s rows ty*4.., columns tx*4.. += G d over `depth` rows, G's rows
    // from g0 (stride Bfull), d's from d0 (stride dld): f32 4 x 4 tiles
    auto cross_add = [&](const float* g0, const float* d0, size_t dld,
                         int m0, int depth) {
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[a][jj] = 0.f;
      for (int m = m0; m < depth; m += 4) {
        float gv[4][4], dv[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          unpack4(*reinterpret_cast<const float4*>(g0 + a * Bfull + m), gv[a]);
          unpack4(*reinterpret_cast<const float4*>(d0 + (size_t)(m + a) * dld),
                  dv[a]);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              s[a][jj] = fmaf(gv[a][t], dv[t][jj], s[a][jj]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float* r = R_s + (ty * 4 + a) * QS + tx * 4 + jj;
          *r = __fadd_rn(*r, s[a][jj]);
        }
    };
    // LA: block bb-1's f32 deltas through goff[bb-1], from the previous
    // block's workspace
    const bool la_corr = LA && bb > 0;
    if (la_corr && trow)
      cross_add(goff + (size_t)(j0 + ty * 4 - Bfull) * Bfull,
                dw_ws + (size_t)par_prev * Bfull * qsw + k0 + tx * 4, qsw, 0,
                Bfull);
    // the block's earlier pieces' deltas through the f32 cross-Gram (the
    // probe instance: those it keeps, per row)
    const bool c7 = (BF || PS::PIECES) && npc > 1 && kp > 0;
    if (c7 && trow && !PR)
      cross_add(gram_full + (size_t)(j0 + ty * 4) * Bfull,
                dw_ws + (size_t)par * Bfull * qsw + k0 + tx * 4, qsw, 0,
                kp * B);
    if constexpr (PS::PIECES) {
      if (c7 && trow) {
        // row a of the tile (block row rb): corrections from the earlier
        // pieces' rows before its window's start, pushes from the rest,
        // the Gram row in f32, in row order as cross_add sums
#pragma unroll 1
        for (int a = 0; a < 4; ++a) {
          const int rb = kp * B + ty * 4 + a;
          const int ms = min(kp * B, rb / psub * psub);
          const int m0 = k_corr ? 0 : ms, m1 = k_push ? kp * B : ms;
          const float* gr = gram_full + (size_t)(j0 + ty * 4 + a) * Bfull;
          const float* d0 = dw_ws + k0 + tx * 4;
          float sa[4] = {0.f, 0.f, 0.f, 0.f};
          for (int m = m0; m < m1; ++m) {
            float d[4];
            unpack4(ld4(d0 + (size_t)m * qsw), d);
            const float gv = gr[m];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) sa[jj] = fmaf(gv, d[jj], sa[jj]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float* r = R_s + (ty * 4 + a) * QS + tx * 4 + jj;
            *r = __fadd_rn(*r, sa[jj]);
          }
        }
      }
    }
    if constexpr (PR) {
      if (!k_proj && trow) {  // no projection: r = X^T Y (+ the pieces')
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int k = k0 + tx * 4 + jj;
            float* r = R_s + (ty * 4 + a) * QS + tx * 4 + jj;
            *r = __fadd_rn(
                k < q ? cp[(size_t)(j0 + ty * 4 + a) * q + k] : 0.f, *r);
          }
      }
    }
    if (la_corr || c7 || (PR && !k_proj)) __syncthreads();

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
          if constexpr (!PS::NOCORR) {
            if (w > 0) {
              r = __fadd_rn(r, C_s[cur * WQ + i * QS + tid]);
#pragma unroll
              for (int m = 0; m < W; ++m)
                r = fmaf(gp(GP_s, row, lo - W + m), dprev[m], r);
            }
          }
          rr[i] = r;
        }
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int row = lo + i, j = j0 + row;
          const int e = rw * WQ + i * QS + tid;
          const ChainStep st =
              CLIP ? clip_step(ct, CPW_s[e], rr[i], AD_s[row * QS + tid],
                               cinv, BOW_s[e])
                   : chain_step(ct, CPW_s[e], rr[i], AD_s[row * QS + tid],
                                cinv, BOW_s[e]);
          D_s[row * QS + tid] = st.delta;
          GT_s[row * QS + tid] = st.gam;
          dprev[i] = st.delta;
          if constexpr (!PS::NOPUSH) {
#pragma unroll
            for (int a = i + 1; a < W; ++a)
              rr[a] = fmaf(gp(GP_s, lo + a, row), st.delta, rr[a]);
          }
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
        if constexpr (!PS::NOCORR) {
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
            C_s[nxt * WQ + e] =
                __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
          }
        }
        cp_async_wait<1>();  // the next window's rows have landed
      }
      __syncthreads();
    }

    tick(2);

    if constexpr (PS::PIECES)  // the deltas of a block's earlier pieces
      if (npc > 1 && kp < npc - 1)
        for (int e = tid; e < BQ; e += NT)
          dw_ws[(size_t)(kp * B + e / QS) * qsw + k0 + e % QS] = D_s[e];
    if constexpr (BF) {  // delta rounded to bf16 once for the next advance
      __nv_bfloat16* DH_h = reinterpret_cast<__nv_bfloat16*>(MB() + 2);
      for (int e = tid; e < kd32(B) * QS / 2; e += NT) {
        const int row = e / (QS / 2), c2 = (e % (QS / 2)) * 2;
        const float2 v =
            row < B ? *reinterpret_cast<const float2*>(D_s + row * QS + c2)
                    : make_float2(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(DH_h + row * HLD + c2) =
            __floats2bfloat162_rn(v.x, v.y);
      }
      if (npc > 1 && (LA || kp < npc - 1))  // for the block's later
        // pieces (LA: and the next block's)
        for (int e = tid; e < BQ; e += NT)
          dw_ws[(size_t)(par * Bfull + kp * B + e / QS) * qsw + k0 + e % QS] =
              D_s[e];
    }

    // ---- Z moments: z = gam * imrd + imr0u, masked row/column sums --------
    {
      float d1[4][4], d2[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) d1[a][jj] = d2[a][jj] = 0.f;
      if (PR && trow && !k_mills) {  // a probe without the Mills: z = gam
        float qm4[4];
        unpack4(ld4(ZQ_s + QS + tx * 4), qm4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty * 4 + a;
          const float pm = PM_s[i];
          float zr = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float zq = __fmul_rn(GT_s[i * QS + tx * 4 + jj], qm4[jj]);
            zr = __fadd_rn(zr, zq);
            zc4[jj] = fmaf(pm, zq, zc4[jj]);
          }
          ZR_s[i * TC + tx] = zr;
        }
      } else if (trow) {
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
    if constexpr (BF) fence_proxy_async();  // before the next bulk copies
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

// ---------------------------------------------------------------------------
// The lookahead variant's overlapped schedule, for whole blocks (Bfull == B;
// a block in pieces keeps the serial schedule of sweep_fused_kernel<QS,
// true, true> above).  Under the lookahead block b+1's projection,
//   r_{b+1} = bf16(x_{b+1})^T bf16(F_{<=b-1}) + goff[b] delta_b,
// needs nothing of block b but delta_b, which comes in through the f32
// off-diagonal Gram.  So a CTA of 512 threads runs a software pipeline in
// two roles, at step s:
//   chain role:  chain(s-1)
//   pass role:   pass: advance F by x_{s-2} delta_{s-2}, project block s
//                (bf16 x_s against the bf16 of the advanced F chunk)
// and then, between the chains:
//   1. the pass role moves the projections of block s from its
//      accumulators to their tile and adds goff[s-1] delta_{s-1} in f32
//      (4 x 4 register tiles, the depth in order), the goff rows staged
//      into shared memory by cp.async as its pass ends; the chain role
//      rounds delta_{s-1} to bf16 for the next advance and stages block s's
//      Gram triangle and first two windows of rows;
//   2. the pass role runs block s-1's Z tile and block s's logit-constant
//      tile, their rows of L staged where the goff rows were (with block
//      s's p_mask and theta);
//   3. block s's chain starts, beside the next pass.
// Step 0 only projects block 0; step 1 projects block 1 on the same F (no
// advance); the last two steps only advance.  F is advanced by the same
// tensor-core tiles and rounded to bf16 from the same f32 values as in the
// serial schedule, and the goff sum, the chain and the tiles keep their
// orders, so the outputs are the serial schedule's bit for bit.
//  - the pass is the first version of B1's bf16 pass (8 QS threads, 32-row
//    chunks, one warp per 16 x 8 advance tile: its tensor-core tiling),
//    but for its staging: each chunk's F and x come two chunks ahead, in
//    stages last read two steps before (the nodes, which only the tiles
//    between the chains read, are staged with them there to make room);
//  - roles: the pass role is B1's bf16 CTA, the last warps; the chain role the first 512 - 8 QS threads (8 warps
//    at QS = 32, 6 at 40): the first QS run the chain, the warps after the
//    chain's correct the next window and stage its rows, as the helper
//    warps of the serial schedule.  Each role loops on its own, so that
//    neither carries the other's registers; they meet at named barrier 3
//    (all 512) twice a step, each synchronises among itself on its own (1,
//    2).  512 threads leave ptxas 128 registers (four warps on each of the
//    four schedulers' register files, as 14 would); to stay within them,
//    and to keep the chain's steps short, the chain thread reads the
//    previous window's deltas back from the delta tile and leaves mu over
//    the logit tile's element it has read; the chain role writes the
//    block's masked beta, gam and mu and its column statistics (rows in
//    order) between the chains, before the logit tile of the next block
//    takes the room;
//  - shared memory, as the pass and the chain run at once, holds both:
//    the Gram triangle, four B x QS tiles (deltas, projections, the logit
//    tile, gam), the window tiles, two blocks' p_mask and theta, zeta and
//    q_mask, the bf16 delta tile, and the stages: during the pass its
//    chunks (F three stages, x_s four, x_{s-2} three, the advance partial,
//    two bf16 F chunks), between the chains the goff rows (B rows of B + 4
//    floats), then the nodes, two blocks' rows of L and the z_row
//    partials; the pass threads' z_col partials have 32 x QS of their own.
//    Every buffer is sized for B = 128 and R = 48 (LaSmem), at QS = 40:
//    8256 + 4 x 5120 + 2560 + 512 + 80 + 2560 + 1280 + max(21632, 16896,
//    19328) = 57360 floats, 229440 bytes of 232448 (at QS = 32: 51456
//    floats).  The projections of the next block stay in the pass
//    warps' accumulators (16 registers) until the chain ends;
constexpr int LA_NXB = 4;  // x_s stages: chunks come two steps ahead
constexpr int LA_NXA = 3;  // x_{s-2} stages
// The layout is sized for the largest block and interpolation width, so
// that every buffer sits at a constant offset: at 512 threads ptxas has 128
// registers, and the chain's addresses need none of them
constexpr int LA_XLH = xl16(BMAX);  // a bf16 x row of the stages
constexpr int LA_GOL = BMAX + 4;    // a goff row
template <int QS>
struct LaSmem {  // offsets in floats
  static constexpr int BQ = BMAX * QS, WQ = W * QS;
  static constexpr int D = gp_floats(BMAX), R = D + BQ, AD = R + BQ,
                       GT = AD + BQ, C = GT + BQ, CPW = C + 2 * WQ,
                       BOW = CPW + NRW * WQ, PM = BOW + NRW * WQ,
                       TH = PM + 2 * BMAX, ZQ = TH + 2 * BMAX,
                       DH = ZQ + 2 * QS, ZC = DH + kd32(BMAX) * HLD / 2,
                       PS = ZC + 32 * QS;
  // the stages: the pass's, then the goff rows, then the nodes, two
  // blocks' rows of L and the z_row partials
  static constexpr int XB = NSTAGE * NCH * QS,  // (bf16 from here)
      XA = XB + LA_NXB * NCH * LA_XLH / 2, AP = XA + LA_NXA * NCH * LA_XLH / 2,
      FH = AP + NCH * QS, PASS = FH + NCH * HLD;
  static constexpr int L0 = 3 * RMAX * QS, L1 = L0 + BMAX * RMAX,
                       ZR = L1 + BMAX * RMAX, TILES = ZR + BMAX * (QS / 4);
  static constexpr int GO = BMAX * LA_GOL;
  static constexpr int STAGES =
      PASS > GO ? (PASS > TILES ? PASS : TILES) : (GO > TILES ? GO : TILES);
  static constexpr int FLOATS = PS + STAGES;
  static_assert(D % 4 == 0 && PS % 4 == 0 && XA % 4 == 0 && AP % 4 == 0 &&
                    FH % 4 == 0 && L0 % 4 == 0 && ZR % 4 == 0 && ZC % 4 == 0,
                "16-byte aligned buffers");
};
template <int QS>
size_t la_smem_bytes() {
  return sizeof(float) * (size_t)LaSmem<QS>::FLOATS;
}

constexpr int LA_NT = 512;                  // threads of the lookahead CTA
constexpr int BAR_CHAIN = 1, BAR_PASS = 2, BAR_ALL = 3;  // named barriers
constexpr int NCLK_LA = NCLK + 3;           // its phase clock slots

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int QS>
__global__ void __launch_bounds__(LA_NT, 1) sweep_lookahead_kernel(
    const __nv_bfloat16* __restrict__ xh,  // (n, p) bf16
    const float* __restrict__ cp, const float* __restrict__ gram,
    const float* __restrict__ l_aug, const float* __restrict__ n_stack,
    const float* __restrict__ beta_in, float* __restrict__ fitted,
    const float* __restrict__ theta, const float* __restrict__ p_mask,
    const float* __restrict__ zeta, const float* __restrict__ q_mask,
    const float* __restrict__ s2v, const float* __restrict__ tauv,
    const float* __restrict__ scal, float* __restrict__ beta_out,
    float* __restrict__ gam_out, float* __restrict__ mu_out,
    float* __restrict__ zrow_part, float* __restrict__ z_col,
    float* __restrict__ gcol, float* __restrict__ m2gcol,
    float* __restrict__ b2col,
    const float* __restrict__ goff,  // (p, B)
    int n, int p, int q, int B, int R, int c_one, int cp_batched) {
  using S = Slice<QS>;
  {  // blockIdx.y is the replica, as in sweep_fused_kernel
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
  constexpr int NTP = S::NT;          // the pass role: B1's CTA
  constexpr int NTC = LA_NT - NTP;    // the chain role
  constexpr int TC = S::TC, WQ = S::WQ;
  constexpr int H0 = S::NCW * 32;     // the first helper thread
  constexpr int NTL = QS / 8;
  static_assert(NTC % 32 == 0 && H0 < NTC, "helper warps beside the chain");
  using L = LaSmem<QS>;
  extern __shared__ __align__(16) float smem[];
  // the probes' clocks: the chain thread's latest tick, its chain's span,
  // the pass thread's pass span
  __shared__ long long pclk[5];
  const int B16 = b16(B);
  constexpr int XLH = LA_XLH, GOL = LA_GOL;
  float* const GP_s = smem;             // packed lower Gram triangle
  float* const D_s = smem + L::D;       // B x QS f32 deltas
  float* const R_s = smem + L::R;       // B x QS projections
  float* const AD_s = smem + L::AD;     // B x QS logit-constant tile
  float* const GT_s = smem + L::GT;     // B x QS new gam
  float* const C_s = smem + L::C;       // 2 x W x QS corrections
  float* const CPW_s = smem + L::CPW;   // NRW x W x QS X^T Y rows
  float* const BOW_s = smem + L::BOW;   // NRW x W x QS pre-sweep beta
  float* const PM_s = smem + L::PM;     // 2 x BMAX p_mask, by parity
  float* const TH_s = smem + L::TH;     // 2 x BMAX theta, by parity
  float* const ZQ_s = smem + L::ZQ;     // the slice's zeta, q_mask
  // kd32(B) x HLD bf16 deltas
  __nv_bfloat16* const DH_h = reinterpret_cast<__nv_bfloat16*>(smem + L::DH);
  // the pass threads' z_col partials, 32 rows of QS (each thread's four)
  float* const ZC_s = smem + L::ZC;
  float* const PS = smem + L::PS;       // the stages

  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * QS;
  const int nb = p / B, nwin = B / W;
  const bool cta0 = blockIdx.x == 0 && blockIdx.y == 0;
  const int nch = (n + NCH - 1) / NCH;
  // the chain probe's cycles since its last tick into `slot`
  auto tick = [&](int slot) {
    const long long t = clock64();
    g_clocks[slot] += t - pclk[0];
    pclk[0] = t;
  };
  if (cta0 && tid == 0) {
    pclk[0] = clock64();
    for (int e = 0; e < NCLK_LA; ++e) g_clocks[e] = 0;
    g_clocks[NCLK - 1] = -pclk[0];
  }
  for (int e = tid; e < 2 * QS; e += LA_NT) {
    const int k = k0 + e % QS;
    ZQ_s[e] = k < q ? (e < QS ? zeta : q_mask)[k] : 0.f;
  }

  if (tid < NTC) {
    // ================= the chain role =====================================
    const bool probe = cta0 && tid == 0;
    const bool chain = tid < QS;
    const int kc = k0 + tid;
    const bool cvalid = chain && kc < q;
    float ct = 0.f, cinv = 0.f, qmc = 0.f;
    if (cvalid) {
      const float c = scal[0], s2 = s2v[kc];
      ct = c * s2 * tauv[kc];
      cinv = c * 0.5f / s2;
      qmc = q_mask[kc];
    }
    float gacc = 0.f, m2acc = 0.f, b2acc = 0.f;
    // cp and pre-sweep beta rows j .. j + W of this slice into window
    // buffer `buf`, by the threads e0, e0 + stride, ...
    auto stage_rows = [&](int j, int buf, int e0, int stride) {
      for (int e = e0; e < 2 * W * TC; e += stride) {
        const int a = e / (W * TC), i = (e / TC) % W;
        const int kk = (e % TC) * 4;
        const bool ok = k0 + kk < q;
        const float* src =
            (a == 0 ? cp : beta_in) + (size_t)(j + i) * q + k0 + kk;
        cp_async16_zfill((a == 0 ? CPW_s : BOW_s) + buf * WQ + i * QS + kk,
                         ok ? src : cp, ok);
      }
    };
    for (int s = 0; s <= nb; ++s) {
      if (s >= 1) {  // ---- the chain of block s-1 ------------------------
        const int j0 = (s - 1) * B;
        if (probe) pclk[1] = clock64();
        for (int w = 0; w < nwin; ++w) {
          const int lo = w * W, cur = w & 1, nxt = cur ^ 1, rw = w % NRW;
          if (chain) {
            float rr[W];
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const int row = lo + i;
              // remove the own contribution with the TRUE Gram diagonal
              float r = fmaf(-BOW_s[rw * WQ + i * QS + tid],
                             gp(GP_s, row, row), R_s[row * QS + tid]);
              if (w > 0) {  // the previous window's deltas, its own
                r = __fadd_rn(r, C_s[cur * WQ + i * QS + tid]);
#pragma unroll
                for (int m = 0; m < W; ++m)
                  r = fmaf(gp(GP_s, row, lo - W + m),
                           D_s[(lo - W + m) * QS + tid], r);
              }
              rr[i] = r;
            }
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const int row = lo + i;
              const int e = rw * WQ + i * QS + tid;
              const ChainStep st = chain_step(ct, CPW_s[e], rr[i],
                                              AD_s[row * QS + tid], cinv,
                                              BOW_s[e]);
              D_s[row * QS + tid] = st.delta;
              GT_s[row * QS + tid] = st.gam;
              // mu over the logit tile's element, which this step read
              AD_s[row * QS + tid] = st.mu;
#pragma unroll
              for (int a = i + 1; a < W; ++a)
                rr[a] = fmaf(gp(GP_s, lo + a, row), st.delta, rr[a]);
            }
          } else if (tid >= H0 && w + 1 < nwin) {
            // the helpers: the cp/beta rows two windows ahead, and the next
            // window's corrections by every delta two or more windows back
            if (w + 2 < nwin)
              stage_rows(j0 + lo + 2 * W, (w + 2) % NRW, tid - H0, NTC - H0);
            cp_async_commit();
            for (int e = tid - H0; e < WQ; e += NTC - H0) {
              const int t = e / QS, col = e % QS;
              const float* gr = GP_s + (lo + W + t) * (lo + W + t + 1) / 2;
              float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
              for (int m = 0; m < lo; m += 4) {
                s0 = fmaf(gr[m], D_s[m * QS + col], s0);
                s1 = fmaf(gr[m + 1], D_s[(m + 1) * QS + col], s1);
                s2 = fmaf(gr[m + 2], D_s[(m + 2) * QS + col], s2);
                s3 = fmaf(gr[m + 3], D_s[(m + 3) * QS + col], s3);
              }
              C_s[nxt * WQ + e] =
                  __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
            }
            cp_async_wait<1>();  // the next window's rows have landed
          }
          // the chain thread's wait for the helpers (one barrier
          // instruction for all: bar.sync is warp-aligned)
          const long long t_w = probe ? clock64() : 0;
          bar_sync(BAR_CHAIN, NTC);
          if (probe) g_clocks[NCLK + 2] += clock64() - t_w;
        }
        if (probe) {
          tick(2);
          pclk[2] = pclk[0];
        }
      }
      bar_sync(BAR_ALL, LA_NT);  // the chain and the pass of step s are done
      if (probe) {  // the pass beyond the chain, and its part in the chain's
        tick(0);
        if (s >= 1) {
          const long long cs = pclk[1], ce = pclk[2], ps = pclk[3],
                          pe = pclk[4];
          const long long lo = ps > cs ? ps : cs, hi = pe < ce ? pe : ce;
          g_clocks[NCLK] += pe - ps;
          g_clocks[NCLK + 1] += hi > lo ? hi - lo : 0;
        }
      }
      if (s >= 1)  // delta_{s-1} rounded to bf16 for the next advance
        for (int e = tid; e < kd32(B) * QS / 2; e += NTC) {
          const int row = e / (QS / 2), c2 = (e % (QS / 2)) * 2;
          const float2 v =
              row < B ? *reinterpret_cast<const float2*>(D_s + row * QS + c2)
                      : make_float2(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(DH_h + row * HLD + c2) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      if (s < nb) {  // block s's Gram triangle and windows 0 and 1
        const int jn = s * B;
        for (int i = tid >> 5; i < B; i += NTC / 32)
          for (int m = lane; m <= i; m += 32)
            cp_async4(GP_s + i * (i + 1) / 2 + m,
                      gram + (size_t)(jn + i) * B + m);
        stage_rows(jn, 0, tid, NTC);
        if (nwin > 1) stage_rows(jn + W, 1, tid, NTC);
      }
      cp_async_commit();
      if (s >= 1) {  // block s-1's masked outputs, from gam and mu
        const int j0 = (s - 1) * B, pm_off = ((s - 1) & 1) * BMAX;
        for (int e = tid; e < B * QS; e += NTC) {
          const int row = e / QS, col = e % QS;
          if (k0 + col < q) {
            const float g = GT_s[e], mu = AD_s[e];
            const float msk = __fmul_rn(PM_s[pm_off + row], ZQ_s[QS + col]);
            const size_t off = (size_t)(j0 + row) * q + k0 + col;
            beta_out[off] = __fmul_rn(__fmul_rn(g, mu), msk);
            if (gam_out != nullptr) {
              gam_out[off] = __fmul_rn(g, msk);
              mu_out[off] = __fmul_rn(mu, msk);
            }
          }
        }
        if (chain)  // the column statistics, rows in order
          for (int row = 0; row < B; ++row) {
            const float pm = PM_s[pm_off + row], g = GT_s[row * QS + tid],
                        mu = AD_s[row * QS + tid], bnew = __fmul_rn(g, mu);
            gacc = fmaf(pm, g, gacc);
            m2acc = fmaf(pm, __fmul_rn(bnew, mu), m2acc);
            b2acc = fmaf(pm, __fmul_rn(bnew, bnew), b2acc);
          }
      }
      bar_sync(BAR_ALL, LA_NT);  // mu is read: the logit tile may be written
      cp_async_wait<0>();
      bar_sync(BAR_ALL, LA_NT);  // block s's tiles are whole: its chain
      if (probe) pclk[0] = clock64();  // the pass probe counts between
    }
    bar_sync(BAR_ALL, LA_NT);  // the last pass is done
    if (probe) tick(0);
    bar_sync(BAR_ALL, LA_NT);  // the z_col partials are whole
    if (tid < QS && k0 + tid < q) {
      float sz = 0.f;
      for (int h = 0; h < NTP / TC; ++h) sz += ZC_s[h * QS + tid];
      z_col[k0 + tid] = sz;
    }
    if (cvalid) {
      gcol[kc] = gacc * qmc;
      m2gcol[kc] = m2acc * qmc;
      b2col[kc] = b2acc * qmc;
    }
    if (probe) g_clocks[NCLK - 1] += clock64();
    return;
  }

  // ================= the pass role ========================================
  const int pt = tid - NTC, pw = pt >> 5;
  const bool pprobe = cta0 && pt == 0;
  // the 4 x 4 tiles: rows ty*4.., columns tx*4..
  const int tx = pt % TC, ty = pt / TC;
  const bool trow = ty * 4 < B;
  // this thread's z_col partials, in shared memory (the registers are
  // the chain's and the pass's)
  float* const zc4 = ZC_s + ty * QS + tx * 4;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) zc4[jj] = 0.f;
  // warp (wm, wn): the projection's rows wm*64.. (four 16-row tiles) and
  // the advance's chunk rows wm*16.., both at columns wn*8..; lane's
  // fragment rows gr, gr + 8, columns 2 tq, 2 tq + 1
  const int wm = pw / NTL, wn = pw % NTL, gr = lane >> 2, tq = lane & 3;
  float* const F_s = PS;  // NSTAGE F chunks
  // LA_NXB x_s and LA_NXA x_{s-2} bf16 chunks, one advance partial, two
  // bf16 F chunks
  __nv_bfloat16* const XB_h = reinterpret_cast<__nv_bfloat16*>(PS + L::XB);
  __nv_bfloat16* const XA_h = reinterpret_cast<__nv_bfloat16*>(PS + L::XA);
  float* const AP_s = PS + L::AP;
  __nv_bfloat16* const FH_h = reinterpret_cast<__nv_bfloat16*>(PS + L::FH);
  float* const N_s = PS;          // 3 x R x QS node values
  float* const L0_s = PS + L::L0;  // block s-1's rows of L (its Z tile)
  float* const L1_s = PS + L::L1;  // block s's (its logit tile)
  float* const ZR_s = PS + L::ZR;
  for (int s = 0; s <= nb + 1; ++s) {
    // ---- the pass: advance F by block s-2, project block s --------------
    const bool adv = s >= 2, proj = s < nb;
    const int ja = (s - 2) * B, jp = s * B;
    if (pprobe) pclk[3] = clock64();
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[a][jj] = 0.f;
    if (adv || proj) {
      // chunk ch's F (from device memory) and x (from L2) come two steps
      // ahead, in one commit group: step ch waits for all but chunk ch+1's
      auto stage = [&](int ch) {
        if (ch < nch) {
          float* fst = F_s + (ch % NSTAGE) * NCH * QS;
          const int n0 = ch * NCH;
          for (int e = pt; e < NCH * TC; e += NTP) {
            const int r = e / TC, c4 = (e % TC) * 4;
            const bool ok = n0 + r < n && k0 + c4 < q;
            cp_async16_zfill(
                fst + r * QS + c4,
                ok ? fitted + (size_t)(n0 + r) * q + k0 + c4 : fitted, ok);
          }
          __nv_bfloat16* xbst_h = XB_h + (ch % LA_NXB) * NCH * XLH;
          __nv_bfloat16* xast_h = XA_h + (ch % LA_NXA) * NCH * XLH;
          for (int e = pt; e < NCH * B16 / 8; e += NTP) {
            const int r = e / (B16 / 8), c8 = (e % (B16 / 8)) * 8;
            const bool ok = n0 + r < n && c8 < B;
            const __nv_bfloat16* row =
                xh + (size_t)(n0 + r < n ? n0 + r : 0) * p + (c8 < B ? c8 : 0);
            if (adv) cp_async16_zfill(xast_h + r * XLH + c8, row + ja, ok);
            if (proj) cp_async16_zfill(xbst_h + r * XLH + c8, row + jp, ok);
          }
        }
        cp_async_commit();
      };
      stage(0);
      stage(1);
      // chunk ch is advanced in step ch and projected in step ch + 1; the
      // stages that chunk ch + 2 takes were last read in step ch - 1
      const int last = proj ? nch : nch - 1;
      for (int ch = 0; ch <= last; ++ch) {
        cp_async_wait<1>();       // chunk ch has landed (this thread's)
        bar_sync(BAR_PASS, NTP);  // ... everyone's
        stage(ch + 2);
        float* fs = F_s + (ch % NSTAGE) * NCH * QS;
        const bool adv_ch = adv && ch < nch;
        if (adv_ch) {  // this warp's 16 x 8 tile of x_{s-2} delta
          const __nv_bfloat16* xa_h = XA_h + (ch % LA_NXA) * NCH * XLH;
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          const int nks = B16 / 16;
          for (int ks = 0; ks < nks; ks += 2) {
            unsigned bq[4], a[4];
            ldsm_x4_t(bq, DH_h + (ks * 16 + lane) * HLD + wn * 8);
            ldsm_x4(a, xa_h + (wm * 16 + (lane & 15)) * XLH + ks * 16 +
                           (lane >> 4) * 8);
            mma_bf16(d4, a, bq[0], bq[1]);
            if (ks + 1 < nks) {
              ldsm_x4(a, xa_h + (wm * 16 + (lane & 15)) * XLH + ks * 16 +
                             16 + (lane >> 4) * 8);
              mma_bf16(d4, a, bq[2], bq[3]);
            }
          }
          float* ap = AP_s + (wm * 16 + gr) * QS + wn * 8 + 2 * tq;
          *reinterpret_cast<float2*>(ap) = make_float2(d4[0], d4[1]);
          *reinterpret_cast<float2*>(ap + 8 * QS) = make_float2(d4[2], d4[3]);
        }
        if (proj && ch > 0) {  // r += x_s^T F over chunk ch-1, 4 tiles
          const __nv_bfloat16* fh = FH_h + ((ch - 1) & 1) * NCH * HLD;
          const __nv_bfloat16* xp = XB_h + ((ch - 1) % LA_NXB) * NCH * XLH;
          unsigned bq[4];
          ldsm_x4_t(bq, fh + lane * HLD + wn * 8);
          const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int mt = wm * 4 + i;
            if (mt * 16 < B16) {
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                unsigned a[4];
                ldsm_x4_t(a, xp + (ks * 16 + (mi >> 1) * 8 + r8) * XLH +
                                 mt * 16 + (mi & 1) * 8);
                mma_bf16(acc[i], a, bq[2 * ks], bq[2 * ks + 1]);
              }
            }
          }
        }
        const int row = pt / TC, c4 = (pt % TC) * 4;
        if (!adv && proj && ch < nch) {  // F as staged (no advance)
          float f[4];
          unpack4(ld4(fs + row * QS + c4), f);
          st_bf16x4(FH_h + (ch & 1) * NCH * HLD + row * HLD + c4, f);
        }
        if (adv_ch) {
          bar_sync(BAR_PASS, NTP);
          float f[4], t[4];
          unpack4(ld4(fs + row * QS + c4), f);
          unpack4(ld4(AP_s + row * QS + c4), t);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) f[jj] = __fadd_rn(f[jj], t[jj]);
          const float4 v = make_float4(f[0], f[1], f[2], f[3]);
          *reinterpret_cast<float4*>(fs + row * QS + c4) = v;
          if (proj)  // the bf16 copy of the advanced F that ch+1 projects
            *reinterpret_cast<uint2*>(FH_h + (ch & 1) * NCH * HLD +
                                      row * HLD + c4) = bf16x4(f);
          const int nr = ch * NCH + row;
          if (nr < n && k0 + c4 < q)
            *reinterpret_cast<float4*>(fitted + (size_t)nr * q + k0 + c4) = v;
        }
      }
      cp_async_wait<0>();
      bar_sync(BAR_PASS, NTP);  // every chunk is consumed
    }
    if (proj && s >= 1)  // goff[s-1]'s rows (block s's), in the stages
      for (int e = pt; e < B * B / 4; e += NTP) {
        const int i = e / (B / 4), m4 = (e % (B / 4)) * 4;
        cp_async16(PS + i * GOL + m4,
                   goff + (size_t)(jp - B + i) * B + m4);
      }
    cp_async_commit();
    if (pprobe) pclk[4] = clock64();
    if (s == nb + 1) break;  // the last step only advances

    // ---- between the chains: prepare block s, finish block s-1 ----------
    bar_sync(BAR_ALL, LA_NT);  // the chain and the pass of step s are done
    long long pc = 0;  // the pass probe's cycles of the goff and the tiles
    if (pprobe) pc = clock64();
    if (proj)  // each warp's four tiles are whole: into R_s
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wm * 4 + i) * 16 + gr + 8 * h;
          if (row < B)
            *reinterpret_cast<float2*>(R_s + row * QS + wn * 8 + 2 * tq) =
                make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
        }
    cp_async_wait<0>();  // the goff rows
    bar_sync(BAR_PASS, NTP);
    if (proj && s >= 1 && trow) {  // R_s += goff[s-1] delta_{s-1}, f32
      float sa[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sa[a][jj] = 0.f;
      for (int m = 0; m < B; m += 4) {
        float gv[4][4], dv[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          unpack4(ld4(PS + (ty * 4 + a) * GOL + m), gv[a]);
          unpack4(ld4(D_s + (m + a) * QS + tx * 4), dv[a]);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sa[a][jj] = fmaf(gv[a][t], dv[t][jj], sa[a][jj]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float* r = R_s + (ty * 4 + a) * QS + tx * 4 + jj;
          *r = __fadd_rn(*r, sa[a][jj]);
        }
    }
    bar_sync(BAR_PASS, NTP);  // the goff rows are consumed
    if (pprobe) {
      const long long t = clock64();
      g_clocks[1] += t - pc;
      pc = t;
    }
    for (int e = pt; e < 3 * R * QS / 4; e += NTP) {  // the nodes
      const int mr = e / (QS / 4), kk = (e % (QS / 4)) * 4;
      const bool ok = k0 + kk < q;
      cp_async16_zfill(N_s + 4 * e,
                       ok ? n_stack + (size_t)mr * q + k0 + kk : n_stack, ok);
    }
    if (s >= 1)
      for (int e = pt; e < B * R / 4; e += NTP)
        cp_async16(L0_s + 4 * e, l_aug + (size_t)(s - 1) * B * R + 4 * e);
    if (proj) {  // block s's rows of L, p_mask and theta (its parity)
      for (int e = pt; e < B * R / 4; e += NTP)
        cp_async16(L1_s + 4 * e, l_aug + (size_t)s * B * R + 4 * e);
      const int par = s & 1;
      for (int e = pt; e < B / 2; e += NTP)
        cp_async16(e < B / 4 ? PM_s + par * BMAX + 4 * e
                             : TH_s + par * BMAX + 4 * (e - B / 4),
                   (e < B / 4 ? p_mask + 4 * e : theta + 4 * (e - B / 4)) +
                       jp);
    }
    cp_async_commit();
    cp_async_wait<0>();
    bar_sync(BAR_PASS, NTP);
    if (trow && s >= 1) {  // block s-1's Z moments
      const int par = (s - 1) & 1;
      float d1[4][4], d2[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) d1[a][jj] = d2[a][jj] = 0.f;
      const float* l0 = L0_s + ty * 4 * R;
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
        const float th = TH_s[par * BMAX + i], pm = PM_s[par * BMAX + i];
        float zr = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float zq = z_cell(th + zeta4[jj], GT_s[i * QS + tx * 4 + jj],
                                  d1[a][jj], d2[a][jj], qm4[jj], scal[1],
                                  c_one);
          zr = __fadd_rn(zr, zq);
          zc4[jj] = fmaf(pm, zq, zc4[jj]);
        }
        ZR_s[i * TC + tx] = zr;
      }
    }
    bar_sync(BAR_ALL, LA_NT);  // the chain role has read mu from AD_s
    if (trow && proj) {  // block s's logit-constant tile
      const int par = s & 1;
      float dot[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[a][jj] = 0.f;
      const float* l0 = L1_s + ty * 4 * R;
#pragma unroll 2
      for (int rr = 0; rr < R; ++rr) {
        float nv[4];
        unpack4(ld4(N_s + rr * QS + tx * 4), nv);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float l = l0[a * R + rr];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            dot[a][jj] = fmaf(l, nv[jj], dot[a][jj]);
        }
      }
      float zeta4[4];
      unpack4(ld4(ZQ_s + tx * 4), zeta4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        const float th = TH_s[par * BMAX + i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          AD_s[i * QS + tx * 4 + jj] = __fadd_rn(
              logit_base(th + zeta4[jj], scal[0], c_one), dot[a][jj]);
      }
    }
    bar_sync(BAR_ALL, LA_NT);  // block s's tiles are whole: its chain
    if (pprobe) g_clocks[3] += clock64() - pc;
    if (s >= 1) {  // block s-1's z_row partials, then the stages are free
      if (pt < B) {
        const int par = (s - 1) & 1;
        float zr = 0.f;
        for (int t = 0; t < TC; ++t) zr = __fadd_rn(zr, ZR_s[pt * TC + t]);
        zrow_part[(size_t)blockIdx.x * p + (s - 1) * B + pt] =
            __fmul_rn(PM_s[par * BMAX + pt], zr);
      }
      bar_sync(BAR_PASS, NTP);
    }
  }
  // ---- z_col: the partials reduced in a fixed order by the chain role ---
  bar_sync(BAR_ALL, LA_NT);  // the last pass is done
  bar_sync(BAR_ALL, LA_NT);
}

// the shared-memory bytes of a QS-column launch at (B, R), or 0 where the
// kernel cannot take them
template <int QS, bool BF>
size_t checked_smem(int B, int R) {
  const size_t smem = smem_bytes<QS, BF>(B, R);
  return smem <= SMEM_MAX && overlay_fits<QS, BF>(B, R) ? smem : 0;
}

// cuTensorMapEncodeTiled, found through the runtime (no link against the
// driver library); null where the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                   cudaEnableDefault, &got) == cudaSuccess &&
                   got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// the bf16 instance's tensor maps: x (n, p) bf16 in boxes of xw(B) x NCHB
// (64-column boxes with the 128-byte swizzle), fitted (m, n, q) f32 in
// boxes of qs x NCHB x 1 (the swizzle at 32 columns, rows of 128 bytes);
// false where the driver refuses them
bool tensor_maps(CUtensorMap* tx, CUtensorMap* tf, const void* x,
                 float* fitted, int n, int p, int q, int m, int B, int qs) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t xd[2] = {(cuuint64_t)p, (cuuint64_t)n};
  const cuuint64_t xs[1] = {(cuuint64_t)p * 2};
  const cuuint64_t fd[3] = {(cuuint64_t)q, (cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t fs[2] = {(cuuint64_t)q * 4, (cuuint64_t)n * q * 4};
  const cuuint32_t xb[2] = {(cuuint32_t)xw(B), NCHB};
  const cuuint32_t fb[3] = {(cuuint32_t)qs, NCHB, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
             xd, xs, xb, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             xw(B) == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         enc(tf, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, fitted, fd, fs, fb, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             qs == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QS, bool BF, bool LA, int PR = 0>
int launch(const void* x, const float* cp, const float* gram,
           const float* l_aug, const float* n_stack, const float* beta_in,
           float* fitted, const float* theta, const float* p_mask,
           const float* zeta, const float* q_mask, const float* s2v,
           const float* tauv, const float* scal, float* beta_out,
           float* gam_out, float* mu_out, float* zrow_part, float* z_row,
           float* z_col, float* gcol, float* m2gcol, float* b2col,
           const float* gram_full, const float* goff, void* fh_ws,
           float* dw_ws, int n, int p, int q, int B, int R, int c_one, int m,
           int cp_batched, int Bfull, int probe, int psub, cudaStream_t st) {
  const size_t smem = checked_smem<QS, BF>(B, R);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx{}, tf{};  // (the f32 instance takes none)
  if (BF && !tensor_maps(&tx, &tf, x, fitted, n, p, q, m, B, QS))
    return (int)cudaErrorInvalidValue;
  if (PR)  // the probe's code and window, in tm_x's first 8 bytes
    tx.opaque[0] = (cuuint64_t)(unsigned)probe | (cuuint64_t)psub << 32;
  cudaError_t err =
      cudaFuncSetAttribute(sweep_fused_kernel<QS, BF, LA, PR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  sweep_fused_kernel<QS, BF, LA, PR>
      <<<dim3(n_slices, m), Slice<QS>::NT, smem, st>>>(
          x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, p_mask, zeta,
          q_mask, s2v, tauv, scal, beta_out, gam_out, mu_out, zrow_part,
          z_col, gcol, m2gcol, b2col, gram_full, goff,
          static_cast<__nv_bfloat16*>(fh_ws), dw_ws, n, p, q, B, R, c_one,
          cp_batched, Bfull, tx, tf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<dim3((p + 255) / 256, m), 256, 0, st>>>(
      zrow_part, z_row, n_slices, p);
  return (int)cudaGetLastError();
}

// the lookahead kernel's bytes at (B, R), 0 where it cannot take them
// (its static shared memory counts against the limit too)
template <int QS>
size_t checked_la_smem(int B, int R) {
  const size_t smem = la_smem_bytes<QS>();
  return B <= BMAX && R <= RMAX && smem + 5 * sizeof(long long) <= SMEM_MAX
             ? smem
             : 0;
}

template <int QS>
int launch_la(const __nv_bfloat16* x, const float* cp, const float* gram,
              const float* l_aug, const float* n_stack, const float* beta_in,
              float* fitted, const float* theta, const float* p_mask,
              const float* zeta, const float* q_mask, const float* s2v,
              const float* tauv, const float* scal, float* beta_out,
              float* gam_out, float* mu_out, float* zrow_part, float* z_row,
              float* z_col, float* gcol, float* m2gcol, float* b2col,
              const float* goff, int n, int p, int q, int B, int R,
              int c_one, int m, int cp_batched, cudaStream_t st) {
  const size_t smem = checked_la_smem<QS>(B, R);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_lookahead_kernel<QS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (q + QS - 1) / QS;
  sweep_lookahead_kernel<QS>
      <<<dim3(n_slices, m), LA_NT, smem, st>>>(
          x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, p_mask, zeta,
          q_mask, s2v, tauv, scal, beta_out, gam_out, mu_out, zrow_part,
          z_col, gcol, m2gcol, b2col, goff, n, p, q, B, R, c_one,
          cp_batched);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zrow_reduce_kernel<<<dim3((p + 255) / 256, m), 256, 0, st>>>(
      zrow_part, z_row, n_slices, p);
  return (int)cudaGetLastError();
}

template <int QS, bool BF>
int occupancy(int B, int R) {
  const size_t smem = checked_smem<QS, BF>(B, R);
  int nb = -1;
  if (smem == 0 ||
      cudaFuncSetAttribute(sweep_fused_kernel<QS, BF, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, sweep_fused_kernel<QS, BF, false>, Slice<QS>::NT, smem) !=
          cudaSuccess)
    return -1;
  return nb;
}

// the dynamic shared-memory bytes a launch of `kernel` last set (its
// cudaFuncAttributeMaxDynamicSharedMemorySize), -1 on error
template <class K>
long long set_smem(K kernel) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess
             ? (long long)a.maxDynamicSharedSizeBytes
             : -1;
}

}  // namespace

extern "C" {

// Launches the sweeps of m replicas (the sweep kernel on a grid of slices x
// m, then the z_row reduction) on `stream` in slices of `qs` columns, 32 or
// 40: the width that ops/sweep_fused.py:fused_launch_plan picks; the kernel
// sizes the rest of its launch.  The operands of the state and the outputs
// are m stacked arrays (X^T Y too where cp_batched; x, the Gram blocks and
// the masks are shared); zrow_part holds m x ceil(q / qs) rows of p.
// bf16 != 0 launches the bf16 instance (mxu_bf16), whose x is the (n, p)
// bf16 copy of x; B is the piece of a block of Bfull rows (a multiple of
// B), which only the bf16 instance reads: where Bfull > B it takes the
// (p, Bfull) Gram blocks `gram_full` and the workspaces fh_ws (m x n x
// ceil(q / qs) qs bf16) and dw_ws (m x (Bfull - B) x ceil(q / qs) qs
// floats).  lookahead != 0 (with bf16 only) launches that instance's
// lookahead variant, which reads the (p, Bfull) off-diagonal Gram blocks
// `goff` and, where Bfull > B, takes workspaces twice as deep: fh_ws m x 2
// x n x ceil(q / qs) qs bf16, dw_ws m x 2 Bfull x ceil(q / qs) qs floats.
// probe >= 0 (not with lookahead) launches a probe instance with that
// code (PrBits; bf16 x under its PR_XBF bit, bf16 then 0) in chain windows
// of psub rows (any divisor of Bfull): the one of its sigmoid bit and bf16
// x (PrInst), at either width; where Bfull > B (qs 32 only) it reads
// gram_full and takes dw_ws (m x (Bfull - B) x ceil(q / qs) qs floats;
// fh_ws null).
// Returns the CUDA error code of the launches (0 on success);
// cudaErrorInvalidValue for a shape or width it does not take.
int atlasqtl_sweep_fused(const void* x, const float* cp, const float* gram,
                         const float* l_aug, const float* n_stack,
                         const float* beta_in, float* fitted,
                         const float* theta, const float* p_mask,
                         const float* zeta, const float* q_mask,
                         const float* s2v, const float* tauv,
                         const float* scal, float* beta_out, float* gam_out,
                         float* mu_out, float* zrow_part, float* z_row,
                         float* z_col, float* gcol, float* m2gcol,
                         float* b2col, int n, int p, int q, int B, int R,
                         int c_one, int qs, int m, int cp_batched, int bf16,
                         int lookahead, int Bfull, int probe, int psub,
                         const float* gram_full, const float* goff,
                         void* fh_ws, float* dw_ws, void* stream) {
  if (B <= 0 || B % W != 0 || B > BMAX || p % B != 0 || R <= 0 || R > RMAX ||
      q % 4 != 0 || n <= 0 || (gam_out == nullptr) != (mu_out == nullptr) ||
      m < 1 || m > 65535 || Bfull < B || Bfull % B != 0 || p % Bfull != 0 ||
      (bf16 && Bfull > B &&
       (gram_full == nullptr || fh_ws == nullptr || dw_ws == nullptr)) ||
      (lookahead && (!bf16 || goff == nullptr)) ||
      (probe >= 0 &&
       (bf16 || lookahead || psub <= 0 || Bfull % psub != 0 ||
        (!(probe & PR_SIGMOID) && (probe & PR_PIN)) ||
        (Bfull > B && (gram_full == nullptr || dw_ws == nullptr)))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATLASQTL_LAUNCH(QS, BF, LA, PR)                                      \
  launch<QS, BF, LA, PR>(x, cp, gram, l_aug, n_stack, beta_in, fitted, theta, \
                         p_mask, zeta, q_mask, s2v, tauv, scal, beta_out,     \
                         gam_out, mu_out, zrow_part, z_row, z_col, gcol,      \
                         m2gcol, b2col, gram_full, goff, fh_ws, dw_ws, n, p,  \
                         q, B, R, c_one, m, cp_batched, Bfull, probe, psub,   \
                         st)
  // the lookahead variant of whole blocks: the overlapped schedule
#define ATLASQTL_LAUNCH_LA(QS)                                                \
  launch_la<QS>(static_cast<const __nv_bfloat16*>(x), cp, gram, l_aug,        \
                n_stack, beta_in, fitted, theta, p_mask, zeta, q_mask, s2v,   \
                tauv, scal, beta_out, gam_out, mu_out, zrow_part, z_row,      \
                z_col, gcol, m2gcol, b2col, goff, n, p, q, B, R, c_one, m,    \
                cp_batched, st)
  // a probe's instance (PrInst): its clipped logit, its pin, or its
  // chain's shape (no probe takes two of them), bf16 x or not; the
  // 32-column ones (P = PRI_PIECES) also take a block over BMAX.  The
  // chain skips the terms across chain windows where the probe drops
  // every one of them at its window (the corrections, and the pushes too
  // unless the window divides W), and then the pushes inside a chain
  // window too where it drops those (the Jacobi probes); elsewhere a
  // dropped term is a zero of the Gram
#define ATLASQTL_PROBE_X(QS, P)                                               \
  (pinst & PRI_XBF ? ATLASQTL_LAUNCH(QS, false, false, PRI_ON | PRI_XBF | P)  \
                   : ATLASQTL_LAUNCH(QS, false, false, PRI_ON | P))
#define ATLASQTL_PROBE(QS, P)                                                 \
  (pinst & PRI_CLIP  ? ATLASQTL_PROBE_X(QS, PRI_CLIP | P)                     \
   : pinst & PRI_PIN ? ATLASQTL_PROBE_X(QS, PRI_PIN | P)                      \
   : pinst & PRI_NOPUSH ? ATLASQTL_PROBE_X(QS, PRI_NOPUSH | PRI_NOCORR | P)    \
   : pinst & PRI_NOCORR ? ATLASQTL_PROBE_X(QS, PRI_NOCORR | P)                \
                        : ATLASQTL_PROBE_X(QS, P))
  const bool kpush = probe & PR_PUSHES, kcorr = probe & PR_CORR;
  const bool nocorr = !kcorr && (!kpush || W % psub == 0);
  const int pinst =
      probe < 0 ? 0
                : PRI_ON | (probe & PR_SIGMOID ? 0 : PRI_CLIP) |
                      (probe & PR_XBF ? PRI_XBF : 0) |
                      (probe & PR_PIN ? PRI_PIN : 0) |
                      (nocorr ? PRI_NOCORR : 0) |
                      (nocorr && !kpush ? PRI_NOPUSH : 0);
  const bool overlap = lookahead && Bfull == B;
  if (qs == 32)
    return overlap     ? ATLASQTL_LAUNCH_LA(32)
           : lookahead ? ATLASQTL_LAUNCH(32, true, true, 0)
           : bf16      ? ATLASQTL_LAUNCH(32, true, false, 0)
           : pinst     ? ATLASQTL_PROBE(32, PRI_PIECES)
                       : ATLASQTL_LAUNCH(32, false, false, 0);
  if (qs == 40 && !(pinst && Bfull > B))
    return overlap     ? ATLASQTL_LAUNCH_LA(40)
           : lookahead ? ATLASQTL_LAUNCH(40, true, true, 0)
           : bf16      ? ATLASQTL_LAUNCH(40, true, false, 0)
           : pinst     ? ATLASQTL_PROBE(40, 0)
                       : ATLASQTL_LAUNCH(40, false, false, 0);
#undef ATLASQTL_PROBE
#undef ATLASQTL_PROBE_X
#undef ATLASQTL_LAUNCH
#undef ATLASQTL_LAUNCH_LA
  return (int)cudaErrorInvalidValue;
}

// The shared-memory bytes of a launch in `qs`-column slices at block B and
// interpolation width R (of the bf16 instance if bf16 != 0; of the
// lookahead variant's overlapped kernel, which takes whole blocks, if
// lookahead != 0); -1 for a width or shape the kernel does not take (the
// card checks ops/sweep_fused.py:_fused_smem_bytes against it).
long long atlasqtl_sweep_fused_smem(int qs, int B, int R, int bf16,
                                    int lookahead) {
  const size_t smem =
      qs == 32 ? (lookahead ? checked_la_smem<32>(B, R)
                  : bf16    ? checked_smem<32, true>(B, R)
                            : checked_smem<32, false>(B, R))
      : qs == 40 ? (lookahead ? checked_la_smem<40>(B, R)
                    : bf16    ? checked_smem<40, true>(B, R)
                              : checked_smem<40, false>(B, R))
                 : 0;
  return smem == 0 ? -1 : (long long)smem;
}

// The dynamic shared-memory bytes that the latest launch in `qs`-column
// slices of the sweep kernel (its bf16 instance if bf16 != 0) set for it,
// -1 on error (before a first launch: 0)
long long atlasqtl_sweep_fused_launch_smem(int qs, int bf16) {
  if (qs == 32) return bf16 ? set_smem(sweep_fused_kernel<32, true, false>)
                            : set_smem(sweep_fused_kernel<32, false, false>);
  if (qs == 40) return bf16 ? set_smem(sweep_fused_kernel<40, true, false>)
                            : set_smem(sweep_fused_kernel<40, false, false>);
  return -1;
}

// Copies the probes' NCLK + 3 phase clocks to `out` (host memory): the
// first NCLK of the latest launch, the last two of the latest launch of
// the lookahead kernel; returns the CUDA error code.
int atlasqtl_sweep_fused_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks,
                                   sizeof(long long) * (NCLK + 3));
}

// CTAs of the sweep kernel (its bf16 instance if bf16 != 0) in
// `qs`-column slices resident on one SM at block B and interpolation width
// R (the occupancy calculator), -1 on error.
int atlasqtl_sweep_fused_occupancy(int qs, int B, int R, int bf16) {
  if (qs == 32) return bf16 ? occupancy<32, true>(B, R)
                            : occupancy<32, false>(B, R);
  if (qs == 40) return bf16 ? occupancy<40, true>(B, R)
                            : occupancy<40, false>(B, R);
  return -1;
}

const char* atlasqtl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
