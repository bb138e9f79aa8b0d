"""The launch plans of the sweep kernels B1 (ops/sweep_fused.py:
fused_launch_plan), B2 (ops/sweep_missing_fused.py:missing_launch_plan) and
B4 (ops/sweep_staggered.py:staggered_launch_plan), plain Python that the
CPU can check: for every shape the wrappers take, the plan's shared memory
fits one CTA (and two where it counts on two per SM), its cluster divides
the grid, its slices cover the q columns and its CTAs the n rows; B1's and
B4's slice widths fill whole waves best.  The card holds the
plans' shared-memory arithmetic to the kernels' own
(tests/test_torch_cuda.py, chip_smoke.py)."""
import pytest

import chip_smoke
from atlasqtl_tpu_torch.ops import sweep_fused as sf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
from atlasqtl_tpu_torch.ops import sweep_staggered as ss

SMEM_MAX = 232448          # shared memory one CTA may take on an H100
MAX_CLUSTER = 16           # the largest cluster an H100 allows at all
R_AUG = 42                 # interp_r = 40, the default, plus 2

# (n, q, block): the card phases' shapes, the eQTL shape, bench.py's
# pod_slice n and q, ragged n and q, block 80, and n large enough that B2
# keeps Fm in device memory
SHAPES = sorted({(n, q, 128 if p >= 128 else 80)
                 for n, p, q in chip_smoke.KERNEL_SHAPES
                 + chip_smoke.STAG_SHAPES}
                | {(n, q, 128 if p >= 128 else 80)
                   for n, p, q, _ in chip_smoke.MIS_SHAPES}
                | {(n, chip_smoke.SCALE_PQ[1], 128)
                   for n in chip_smoke.SCALE_NS}
                | {(1000, 10000, 128), (5000, 1024, 128), (333, 4, 128),
                   (1001, 10004, 128), (77, 36, 80), (300, 500, 80),
                   (8000, 256, 128), (20000, 10000, 128), (1, 4, 8)})


def _check_common(plan, n, q):
    assert plan["smem_bytes"] <= SMEM_MAX
    if plan["ctas_per_sm"] == 2:
        assert plan["smem_bytes"] <= sf.SMEM_TWO_PER_SM
    cs = plan["cluster"]
    assert 1 <= cs <= MAX_CLUSTER and plan["grid"] % cs == 0
    slices = plan["grid"] // cs
    w = plan["slice_width"]
    assert slices * w >= q > (slices - 1) * w


@pytest.mark.parametrize("n,q,block", SHAPES)
def test_missing_plan_fits_and_covers(n, q, block):
    plan = sm.missing_launch_plan(n, q, block, R_AUG)
    _check_common(plan, n, q)
    assert plan["rows_per_cta"] * plan["cluster"] >= n
    assert plan["grid"] == -(-q // sm.MIS_QS) * plan["cluster"]
    if not plan["fm_on_chip"]:
        assert plan["cluster"] == 1 and plan["rows_per_cta"] == n


@pytest.mark.parametrize("n,q,block", SHAPES)
def test_fused_plan_fits_and_covers(n, q, block):
    plan = sf.fused_launch_plan(n, q, block, R_AUG)
    _check_common(plan, n, q)
    assert plan["cluster"] == 1 and plan["ctas_per_sm"] == 1
    assert plan["waves"] == -(-plan["grid"] // sf.H100_SMS)
    # every width built fits, and none fills the waves better
    for w in sf.FUSED_WIDTHS:
        assert sf._fused_smem_bytes(w, block, 48) <= SMEM_MAX
        waves = -(-(-(-q // w)) // sf.H100_SMS)
        assert waves * w >= plan["waves"] * plan["slice_width"]


# (n, q, slice width, waves) of B1's plans at block 128
FUSED_WAVES = [(1000, 10000, 40, 2), (1000, 2048, 32, 1), (300, 500, 32, 1),
               (100, 4804, 40, 1), (5000, 1024, 32, 1), (1000, 20000, 32, 5)]


@pytest.mark.parametrize("n,q,width,waves", FUSED_WAVES)
def test_fused_plan_fills_the_waves(n, q, width, waves):
    """At the eQTL q (10000) 32-column slices take 3 waves of 132 SMs, the
    last one 37% full, and 40-column ones 2; the narrower width wins a tie
    (q = 20000: 5 waves of 32 columns or 4 of 40)."""
    plan = sf.fused_launch_plan(n, q, 128, R_AUG)
    assert (plan["slice_width"], plan["waves"]) == (width, waves)


@pytest.mark.parametrize("n,q,width,waves", FUSED_WAVES)
def test_fused_probe_plan_is_b1s(n, q, width, waves):
    """The probe instances run B1's float32 schedule in B1's plan, 40
    columns included: at the eQTL q (10000) 40 columns in 2 waves, not 32
    in 3 (one replica or two).  A block over 128 (in pieces) keeps 32
    columns, and the plan's `widths` says so."""
    for m in (1, 2):
        plan = sf.fused_launch_plan(n, q, 128, R_AUG, m=m, probe=True)
        assert plan == sf.fused_launch_plan(n, q, 128, R_AUG, m=m)
        assert plan["widths"] == sf.FUSED_WIDTHS
        piece = sf.fused_launch_plan(n, q, 256, R_AUG, m=m, probe=True)
        b1 = sf.fused_launch_plan(n, q, 256, R_AUG, m=m)
        assert piece["widths"] == sf.FUSED_PROBE_PIECE_WIDTHS == (32,)
        assert piece["slice_width"] == 32 and piece["grid"] == -(-q // 32)
        assert piece["smem_bytes"] == sf._fused_smem_bytes(32, 128, R_AUG)
        assert piece["sub_block"] == b1["sub_block"] == 128
    plan = sf.fused_launch_plan(n, q, 128, R_AUG, probe=True)
    assert (plan["slice_width"], plan["waves"]) == (width, waves)


def test_missing_plan_branches():
    """The eQTL shape keeps Fm on chip with two CTAs per SM; the deep-n
    card shape takes one CTA per SM; a few slices spread over a cluster;
    n = 8000 keeps Fm in device memory, two CTAs per SM up to the
    pair_bf16 window 8 and one from 16 on (the instances' launch bounds)."""
    eqtl = sm.missing_launch_plan(1000, 10000, 128, R_AUG)
    assert eqtl["fm_on_chip"] and eqtl["ctas_per_sm"] == 2
    deep = sm.missing_launch_plan(4000, 1024, 128, R_AUG)
    assert deep["fm_on_chip"] and deep["ctas_per_sm"] == 1
    few = sm.missing_launch_plan(300, 500, 128, R_AUG)
    assert few["cluster"] > 1
    for window, ctas in ((0, 2), (8, 2), (16, 1), (128, 1)):
        plan = sm.missing_launch_plan(8000, 256, 128, R_AUG, window=window)
        assert not plan["fm_on_chip"] and plan["ctas_per_sm"] == ctas


@pytest.mark.parametrize("plan_fn", [sm.missing_launch_plan,
                                     sf.fused_launch_plan,
                                     ss.staggered_launch_plan])
def test_every_shape_the_wrappers_take_is_planned(plan_fn):
    """The wrappers take any n, q % 4 == 0, block % 8 == 0 and r + 2 up to
    48 (ops/sweep_missing_fused.py, ops/sweep_fused.py:fused_launch); each
    such shape gets a plan that fits, blocks over 128 in pieces of at most
    128 rows."""
    for n in (1, 7, 80, 299, 1000, 3999, 4000, 7777, 7800, 50000):
        for q in (4, 36, 500, 10000, 10004):
            for block in (8, 80, 120, 128, 200, 256):
                for r_aug in (1, 42, 48):
                    plan = plan_fn(n, q, block, r_aug)
                    _check_common(plan, n, q)


@pytest.mark.parametrize("plan_fn", [sm.missing_launch_plan,
                                     sf.fused_launch_plan])
@pytest.mark.parametrize("n,q,block,r_aug", [
    (100, 6, 128, 42), (100, 8, 260, 42), (100, 8, 12, 42), (100, 8, 128, 49),
    (0, 8, 128, 42)])
def test_plans_reject_what_the_kernels_cannot_take(plan_fn, n, q, block,
                                                   r_aug):
    with pytest.raises(ValueError, match="unsupported shape"):
        plan_fn(n, q, block, r_aug)


@pytest.mark.parametrize("n,q,block", SHAPES)
def test_staggered_plan_fits_and_covers(n, q, block):
    plan = ss.staggered_launch_plan(n, q, block, R_AUG)
    _check_common(plan, n, q)
    assert plan["cluster"] == 1 and plan["ctas_per_sm"] == 1
    assert plan["zrow_parts"] == 2
    assert plan["waves"] == -(-plan["grid"] // sf.H100_SMS)
    for w in ss.STAG_WIDTHS:
        assert ss._stag_smem_bytes(w, min(block, 128), 48) <= SMEM_MAX
        waves = -(-(-(-q // w)) // sf.H100_SMS)
        assert waves * w >= plan["waves"] * plan["slice_width"]


@pytest.mark.parametrize("n,q,width,waves", [
    (1000, 10000, 40, 2), (1000, 2048, 32, 1), (300, 500, 32, 1),
    (100, 4804, 40, 1), (5000, 1024, 32, 1), (1000, 20000, 32, 5)])
def test_staggered_plan_fills_the_waves(n, q, width, waves):
    """B4 takes B1's widths by B1's rule: at q = 10000, 40 columns in 2
    waves of 132 SMs, not 32 in 3."""
    plan = ss.staggered_launch_plan(n, q, 128, R_AUG)
    assert (plan["slice_width"], plan["waves"]) == (width, waves)


@pytest.mark.parametrize("width,block,r_aug,expected", [
    (40, 128, 42, 221440), (40, 128, 48, 224320), (32, 128, 42, 201472),
    (32, 8, 1, 45328), (40, 80, 42, 153760)])
def test_staggered_smem_arithmetic(width, block, r_aug, expected):
    """The kernel's layout (csrc/sweep_staggered.cu:smem_bytes), counted
    by hand at the eQTL cut's 40 columns: the packed Gram 8256 floats,
    three 128 x 20 tiles per half 15360, the window tiles 2560, the nodes
    3 x 42 x 40 = 5040, p_mask 128, zeta and q_mask 80, the z_col partials
    32 x 40 = 1280, and the stage area 22656 (F 3 x 32 x 20, four x chunks
    of 32 x 132, six advance partials of 32 x 20), which after a pass holds
    four warps' partials of 32 x 4 x 10 and two 128 x 42 blocks of L
    (15872): 55360 floats."""
    got = ss._stag_smem_bytes(width, block, r_aug)
    assert got == expected and got <= SMEM_MAX


@pytest.mark.parametrize("width,block,r_aug,expected", [
    (40, 128, 42, 213264), (32, 128, 42, 194832), (32, 120, 48, 191104),
    (40, 8, 1, 57280)])
def test_fused_bf16_smem_arithmetic(width, block, r_aug, expected):
    """B1's bf16 instance (csrc/sweep_fused.cu:smem_bytes<QS, true>),
    counted by hand at the eQTL cut's 40 columns: the packed Gram 8256
    floats, the delta and projection tiles 10240, the stage area 24320 of
    64-row chunks (256 floats for a 1024-byte boundary; F 2 x 64 x 40 =
    5120, the TMA box of the slice; four bf16 x chunks, two of
    x_{b-1} and two of x_b, of two 64 x 64 tiles, 16384 floats; two bf16 F
    chunks of 64 x 40 bf16, 2560), the window tiles 2560, the nodes 3 x 42
    x 40 = 5040, p_mask and theta 256, zeta and q_mask 80, two 8-byte
    mbarriers, the bf16 delta tile 128 x 40 bf16 (2560): 53316 floats.  At 32 columns the F chunks are 64 x 32; block 120 is padded
    to 128 columns, block 8 to one tile of 16 columns.  Every case fits
    one CTA and takes less than the float32 instance."""
    got = sf._fused_smem_bytes(width, block, r_aug, bf16=True)
    assert got == expected and got <= SMEM_MAX
    assert got < sf._fused_smem_bytes(width, block, r_aug)


@pytest.mark.parametrize("width,block,r_aug,expected", [
    (40, 128, 48, 229440), (40, 64, 42, 229440), (32, 128, 48, 205824),
    (32, 8, 1, 205824)])
def test_fused_lookahead_smem_arithmetic(width, block, r_aug, expected):
    """The lookahead variant's overlapped kernel (csrc/sweep_fused.cu:
    LaSmem), counted by hand at 40 columns, whatever the block and r + 2
    (every buffer sized for block 128 and r + 2 = 48): the packed Gram
    8256 floats, four tiles of 128 x 40 (20480), the window tiles 2560,
    two blocks' p_mask and theta 512, zeta and q_mask 80, the bf16 delta
    tile 2560, the pass threads' z_col partials 32 x 40, and the stages:
    the largest of the pass (F 3 x 32 x 40, seven bf16 x chunks of 32 x
    136, 15232 floats, the advance partial and two bf16 F chunks: 21632),
    the goff rows (128 x 132) and the nodes with two blocks' rows of L and
    the z_row partials (19328): 57360 floats.  One CTA fits; a block over 128 goes in pieces through the
    bf16 instance's serial schedule, whose plan it keeps."""
    got = sf._fused_smem_bytes(width, block, r_aug, True, True)
    assert got == expected and got <= SMEM_MAX
    plan = sf.fused_launch_plan(1000, 10000, block, r_aug, bf16=True,
                                lookahead=True)
    assert plan["smem_bytes"] == sf._fused_smem_bytes(
        plan["slice_width"], block, r_aug, True, True)
    piece = sf.fused_launch_plan(1000, 10000, 256, r_aug, bf16=True,
                                 lookahead=True)
    assert piece["smem_bytes"] == sf._fused_smem_bytes(
        piece["slice_width"], 128, r_aug, True)


@pytest.mark.parametrize("n,q,block", SHAPES)
def test_fused_bf16_plan_matches_f32_plan(n, q, block):
    """The bf16 instance's plan takes the float32 plan's width, grid and
    waves (one CTA per SM), with its own shared memory."""
    plan = sf.fused_launch_plan(n, q, block, R_AUG, bf16=True)
    f32 = sf.fused_launch_plan(n, q, block, R_AUG)
    assert {k: v for k, v in plan.items() if k != "smem_bytes"} == \
        {k: v for k, v in f32.items() if k != "smem_bytes"}
    assert plan["smem_bytes"] == sf._fused_smem_bytes(
        plan["slice_width"], plan["sub_block"], R_AUG, True) <= SMEM_MAX


@pytest.mark.parametrize("on_chip,nloc,r_aug,window,expected", [
    (True, 334, 42, 0, 115624), (True, 334, 42, 16, 115624),
    (True, 250, 42, 32, 102616), (True, 250, 42, 128, 114904),
    (True, 300, 42, 64, 116128), (False, 0, 42, 16, 50160),
    (False, 0, 42, 128, 81904)])
def test_missing_pair_bf16_smem_arithmetic(on_chip, nloc, r_aug, window,
                                           expected):
    """B2's layout (csrc/sweep_missing_fused.cu:smem_bytes) per pair_bf16
    window, counted by hand at r + 2 = 42: the window tiles 2048 floats,
    two windows of gam 512, the sum buffers and partial slots 4608, the
    phase clocks with the probe's two ticks 28, the window scalars
    3 x (16 + 8 x 42) = 1056, the nodes 3 x 42 x 32 = 4032, and the
    deltas, 8 x 32 up to window 16 (its cross
    pairs are contracted in registers, never kept) and window x 32 over
    it; on chip 33 floats per row (Fm, the mask word); two x slots of 8
    floats per row, over 16 of at least 256 rows (the warps' cp.async
    rings, in device memory too).  At the eQTL cut (nloc 334, cluster 3)
    windows up to 16 take the float32 instance's bytes."""
    got = sm._mis_smem_bytes(on_chip, nloc, r_aug, window)
    assert got == expected and got <= SMEM_MAX
    if window <= 2 * sm.MIS_W:
        assert got == sm._mis_smem_bytes(on_chip, nloc, r_aug)


@pytest.mark.parametrize("n,p,q,sub,ms,by", [
    (1000, 2048, 10000, 16, 1.6053874626865672, "operations"),
    (1000, 2048, 10000, 8, 1.6053874626865672, "operations"),
    (1000, 2048, 10000, 128, 127e-9 * 2048 * 10000 / 989e-3, "operations"),
    (300, 2000, 500, 64, 0.026149253731343285, "operations"),
    (1, 2048, 10000, 128, 4e3 * (2048 + 7 * 2048 * 10000 + 3 * 10000
                                 + 2048 * 42 + 3 * 42 * 10000) / 3.35e12,
     "bytes")])
def test_mis_bf16_bound_arithmetic(n, p, q, sub, ms, by):
    """The pair_bf16 instance's bound (chip_smoke.mis_bf16_bound_ms) is the
    largest of the rounded pair Grams, (sub - 1) n p q operations at 989
    TFLOP/s, the float32 bound's FP32 operations at 67 TFLOP/s and its
    bytes at 3.35 TB/s: the float32 bound (1.61 ms at the eQTL cut) up to
    mis_sub 64 there, the pair Grams (2.63 ms) at 128, the bytes at n = 1."""
    got, got_by = chip_smoke.mis_bf16_bound_ms(n, p, q, R_AUG, sub)
    assert got == pytest.approx(ms, rel=1e-12) and got_by == by
    f32 = chip_smoke.mis_bound_ms(n, p, q, R_AUG)[0]
    assert got >= f32


@pytest.mark.parametrize("on_chip,nloc,probe,probe_window,rows,ws", [
    (True, 334, "noseq", 32, 0, 16), (True, 334, "noadvmask", 128, 0, 112),
    (True, 333, "noadv", 12, 24, 0), (True, 250, "noseq", 3, 16, 0),
    (False, 0, "noadvmask", 25, 32, 0), (False, 0, "noh", 200, 0, 184),
    (True, 334, "noseq", 16, 0, 0), (True, 334, "noadvmask", 4, 0, 0),
    (True, 334, "noadv", 128, 0, 0), (True, 334, "exact", 12, 0, 0)])
def test_missing_probe_smem_arithmetic(on_chip, nloc, probe, probe_window,
                                       rows, ws):
    """B2's float32 probe instance keeps B2's layout but off the 8-row grid,
    where its deltas sit in a ring of whole chain windows over its latest
    window + 7 rows (12: 24, 3: 16, 25: 32), from a 16-byte boundary after
    the mask words; the exact sweep (B2's own schedule) keeps none.  On the
    grid noseq (noh) and noadvmask at a window of J > 2 chain windows keep
    those of its first J - 2 in device memory instead (32: 16, 128: 112,
    200: 184 rows of 32 per CTA), so that B2's plan holds; noadv keeps none
    (it restores Fm from the launch's input)."""
    base = sm._mis_smem_bytes(on_chip, nloc, 42)
    got = sm._mis_smem_bytes(on_chip, nloc, 42, probe=probe,
                             probe_window=probe_window)
    pad = (-(-nloc // 4) * 4 - nloc) if rows else 0
    assert got == base + 4 * (pad + rows * sm.MIS_QS)
    assert sm._delta_workspace(probe, probe_window) == ws * sm.MIS_QS
    plan = sm.missing_launch_plan(8000, 256, 128, 42, probe=probe,
                                  probe_window=probe_window)
    assert (plan["probe"], plan["probe_window"]) == (probe, probe_window)
    assert plan["smem_bytes"] == sm._mis_smem_bytes(
        plan["fm_on_chip"], plan["rows_per_cta"] if plan["fm_on_chip"] else 0,
        42, probe=probe, probe_window=probe_window)
    # the pair_bf16 probe instances keep none beside their own
    assert sm._mis_smem_bytes(on_chip, nloc, 42, 16, probe,
                              probe_window) == sm._mis_smem_bytes(
        on_chip, nloc, 42, 16)


@pytest.mark.parametrize("probe,sub,adv", [
    ("noseq", 128, 3.0), ("noh", 32, 3.0), ("noadv", 8, 2.625),
    ("noadv", 16, 2.8125), ("noadvmask", 32, 3.9375),
    ("noadv", 128, 2.9765625), ("noadvmask", 1, 2.0), ("noadv", 1, 0.0),
    ("noadvmask", 12, 11 / 3 + 1 / 6)])
def test_missing_probe_bound_counts_the_window(probe, sub, adv):
    """B2's probe bound (chip_smoke.mis_probe_bound_ms) at (1000, 2048,
    10000, r + 2 = 42) counts the projection (2 n per (j, k)), the tiles
    (6 (r + 2)) and Fm's advance as the probe's function needs it at its
    window of S predictors, a masked advance at 3 n, f = (S - 1) / S: noseq
    and noh 3 n, noadv the running masked advance inside a window, 3 n f,
    noadvmask 3 n f plus its unmasked remainder n f and the last
    predictor's unmasked advance 2 n / S."""
    n, p, q = 1000, 2048, 10000
    ops = p * q * ((2 + adv) * n + 6 * R_AUG)
    got, by = chip_smoke.mis_probe_bound_ms(n, p, q, R_AUG, probe, sub)
    if by == "operations":
        assert got == pytest.approx(1e3 * ops / chip_smoke.FP32_PEAK)
    else:
        assert got >= 1e3 * ops / chip_smoke.FP32_PEAK
