"""The launch plans of the two sweep kernels B1 (ops/sweep_fused.py:
fused_launch_plan) and B2 (ops/sweep_missing_fused.py:missing_launch_plan),
plain Python that the CPU can check: for every shape the wrappers take, the
plan's shared memory fits one CTA (and two where it counts on two per SM),
its cluster divides the grid, its slices cover the q columns and its CTAs
the n rows; B1's slice width fills whole waves best.  The card holds the
plans' shared-memory arithmetic to the kernels' own
(tests/test_torch_cuda.py, chip_smoke.py)."""
import pytest

import chip_smoke
from atlasqtl_tpu_torch.ops import sweep_fused as sf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

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


@pytest.mark.parametrize("n,q,width,waves", [
    (1000, 10000, 40, 2), (1000, 2048, 32, 1), (300, 500, 32, 1),
    (100, 4804, 40, 1), (5000, 1024, 32, 1), (1000, 20000, 32, 5)])
def test_fused_plan_fills_the_waves(n, q, width, waves):
    """At the eQTL q (10000) 32-column slices take 3 waves of 132 SMs, the
    last one 37% full, and 40-column ones 2; the narrower width wins a tie
    (q = 20000: 5 waves of 32 columns or 4 of 40)."""
    plan = sf.fused_launch_plan(n, q, 128, R_AUG)
    assert (plan["slice_width"], plan["waves"]) == (width, waves)


def test_missing_plan_branches():
    """The eQTL shape keeps Fm on chip with two CTAs per SM; the deep-n
    card shape takes one CTA per SM; a few slices spread over a cluster;
    n = 8000 keeps Fm in device memory."""
    eqtl = sm.missing_launch_plan(1000, 10000, 128, R_AUG)
    assert eqtl["fm_on_chip"] and eqtl["ctas_per_sm"] == 2
    deep = sm.missing_launch_plan(4000, 1024, 128, R_AUG)
    assert deep["fm_on_chip"] and deep["ctas_per_sm"] == 1
    few = sm.missing_launch_plan(300, 500, 128, R_AUG)
    assert few["cluster"] > 1
    assert not sm.missing_launch_plan(8000, 256, 128, R_AUG)["fm_on_chip"]


@pytest.mark.parametrize("plan_fn", [sm.missing_launch_plan,
                                     sf.fused_launch_plan])
def test_every_shape_the_wrappers_take_is_planned(plan_fn):
    """The wrappers take any n, q % 4 == 0, block % 8 == 0 up to 128 and
    r + 2 up to 48 (ops/sweep_missing_fused.py, ops/sweep_fused.py:
    fused_launch); each such shape gets a plan that fits."""
    for n in (1, 7, 80, 299, 1000, 3999, 4000, 7777, 7800, 50000):
        for q in (4, 36, 500, 10000, 10004):
            for block in (8, 80, 120, 128):
                for r_aug in (1, 42, 48):
                    plan = plan_fn(n, q, block, r_aug)
                    _check_common(plan, n, q)


@pytest.mark.parametrize("plan_fn", [sm.missing_launch_plan,
                                     sf.fused_launch_plan])
@pytest.mark.parametrize("n,q,block,r_aug", [
    (100, 6, 128, 42), (100, 8, 136, 42), (100, 8, 12, 42), (100, 8, 128, 49),
    (0, 8, 128, 42)])
def test_plans_reject_what_the_kernels_cannot_take(plan_fn, n, q, block,
                                                   r_aug):
    with pytest.raises(ValueError, match="unsupported shape"):
        plan_fn(n, q, block, r_aug)
