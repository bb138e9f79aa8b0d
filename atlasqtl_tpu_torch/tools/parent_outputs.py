"""Run B1's bf16 instance, its lookahead variant and its float32 instance
on the same seeded operands in this checkout and in another (a parent
commit unpacked with ``git archive``), on the card, and compare their
outputs bit for bit.

    python -m atlasqtl_tpu_torch.tools.parent_outputs OTHER_ROOT

The operands are built once, here (``chip_smoke.kernel_inputs`` at
(300, 2048, 500), blocks 128 and 256, c = 1 and 0.5), and saved; each
checkout then runs in a subprocess of its own, its package first on
sys.path and its kernels built from its own sources, through
``ops/sweep_fused.py:fused_launch`` with arguments both checkouts take, at
32- and 40-column slices (block 256: the serial lookahead instance in
pieces).  Prints one JSON object: per case, whether every output is equal
(``torch.equal``), and each run's seconds.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_RUN = r"""
import sys, torch
root, ops_path, out_path = sys.argv[1:4]
sys.path.insert(0, root)
from atlasqtl_tpu_torch.ops import sweep_fused as sf
cases = torch.load(ops_path)
out = {}
for key, case in cases.items():
    ops = [t.cuda() if torch.is_tensor(t) else t for t in case["ops"]]
    x16, goff = case["x16"].cuda(), case["goff"].cuda()
    for w in (32, 40):
        kw = dict(block_size=case["block"], emit_gam_mu=True,
                  c_one=case["c"] == 1.0, slice_width=w)
        runs = {"f32": lambda: sf.fused_launch("atlasqtl_sweep_fused", *ops,
                                               **kw),
                "bf16": lambda: sf.fused_launch(
                    "atlasqtl_sweep_fused", x16, *ops[1:], **kw, bf16=True),
                "lookahead": lambda: sf.fused_launch(
                    "atlasqtl_sweep_fused", x16, *ops[1:], goff, **kw,
                    bf16=True, lookahead=True)}
        for name, run in runs.items():
            res = run()
            flat = list(res[:6]) + list(res[6])
            out[f"{name}_{key}_w{w}"] = [t.cpu() for t in flat]
torch.cuda.synchronize()
torch.save(out, out_path)
"""


def _operands(path):
    """The cases' operands, built by this checkout's chip_smoke.py and
    saved on the CPU."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    cases = {}
    for block in (128, 256):
        for c in (1.0, 0.5):
            ops, blk = cs.kernel_inputs(300, 2048, 500, c, block=block)
            cases[f"b{blk}_c{c}"] = dict(
                ops=[t.cpu() if torch.is_tensor(t) else t for t in ops],
                x16=sf.bf16_operand(ops[0]).cpu(),
                goff=sf.lookahead_gram(ops[0], blk).cpu(), block=blk, c=c)
    torch.save(cases, path)


def compare(other_root: Path) -> dict:
    import torch
    here = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        _operands(work / "ops.pt")
        procs, t0 = {}, time.perf_counter()
        for name, root in (("here", here), ("there", Path(other_root))):
            env = dict(os.environ, PYTHONPATH=str(root))
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", _RUN, str(root), str(work / "ops.pt"),
                 str(work / f"{name}.pt")], cwd=str(root), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        secs = {}
        for name, proc in procs.items():
            err = proc.communicate()[1]
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"the {name} checkout failed: {err}")
        a = torch.load(work / "here.pt")
        b = torch.load(work / "there.pt")
    if set(a) != set(b):
        raise RuntimeError("the checkouts ran different cases")
    equal = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
             for k in sorted(a)}
    return dict(equal=equal, all_equal=all(equal.values()), seconds=secs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", type=Path)
    print(json.dumps(compare(ap.parse_args().other_root.resolve())))


if __name__ == "__main__":
    main()
