"""Compare the machine code of this checkout's CUDA kernels with another
checkout's: each source of csrc/ is compiled for sm_90a with the flags the
package builds with, in both trees at once, and every kernel function's
SASS (``cuobjdump -sass``) and resources (``cuobjdump -res-usage``) are set
side by side, by mangled name (the anonymous namespace's per-checkout tag
left out; an instance whose template gained a last parameter that defaults
to false is set beside the other checkout's instance without it, and one
whose last template argument went from `false` to the int 0 beside the
other's `false`).  A kernel whose SASS is identical computes what it computed
before, bit for bit, on the same arguments.

    python -m atlasqtl_tpu_torch.tools.sass_diff OTHER_ROOT [--out FILE]

OTHER_ROOT is the root of the other checkout (for example a parent commit
unpacked with ``git archive``).  Prints one JSON object: for each source,
the functions found in both trees with identical SASS and resources
(``same``), those that differ (``differ``, with both resource lines, the
count of differing lines and the first few pairs), and
those in one tree only (``only_here``, ``only_there``).  Needs the CUDA
toolkit (nvcc, cuobjdump), no GPU.
"""
import argparse
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ..ops.sweep_fused import _NVCC_FLAGS, _SOURCES, _nvcc

_FUNC = re.compile(r"\s*Function : (\S+)")
_RES = re.compile(r"\s*Function (\S+):\s*(.*)")
# the anonymous namespace's tag in a mangled name, which differs between
# two checkouts of the same source (it hashes the path)
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


# a kernel template's last argument `false` (and an empty pack after it)
# before the closing of its arguments and the void return, and the pack's
# expansion that ends the parameters: where this checkout added a template
# parameter that defaults to false (or a pack), its instance is the
# other's without it
_LAST_FALSE = re.compile(r"Lb0E(?:JE)?(E+v)")
# a last template argument that was `false` and is the int 0 here
_LAST_INT0 = re.compile(r"Li0E(E+v)")
_PACK = re.compile(r"DpT\d*_$")


def _plain(text):
    return _ANON.sub("_GLOBAL__N__", text)


def _counterpart(name, there):
    """The other checkout's function for this one's `name`: the same
    name, the name without an added last template argument `false`, or
    the name with its last template argument 0 as `false`."""
    if name in there:
        return name
    for other in (_PACK.sub("", _LAST_FALSE.sub(r"\1", name, count=1)),
                  _LAST_INT0.sub(r"Lb0E\1", name, count=1)):
        if other != name and other in there:
            return other
    return None


def _compile(srcs, work):
    """{(tree, source stem): cubin path} of srcs {(tree, source stem):
    source path}, all nvcc runs started together."""
    nvcc = _nvcc()
    flags = [f for f in _NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    procs = {}
    for key, src in srcs.items():
        cubin = work / f"{key[0]}.{key[1]}.cubin"
        procs[key] = (cubin, subprocess.Popen(
            [nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for key, (cubin, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}: {err}")
        out[key] = cubin
    return out


def _functions(cubin, cuobjdump):
    """({function: SASS text}, {function: resource line}) of one cubin."""
    sass, cur = {}, None
    text = _plain(subprocess.run([cuobjdump, "-sass", str(cubin)],
                                 check=True, capture_output=True,
                                 text=True).stdout)
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            sass[cur] = []
        elif cur is not None:
            # cuobjdump pads each instruction to a column that depends on
            # the cubin's widest line, not on the function: compare the
            # tokens
            sass[cur].append(" ".join(line.split()))
    res = {}
    text = _plain(subprocess.run([cuobjdump, "-res-usage", str(cubin)],
                                 check=True, capture_output=True,
                                 text=True).stdout)
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = _RES.match(line)
        if m:
            res[m.group(1)] = (m.group(2) or
                               (lines[i + 1].strip() if i + 1 < len(lines)
                                else ""))
    return {k: "\n".join(v) for k, v in sass.items()}, res


def compare(other_root: Path) -> dict:
    other = Path(other_root) / "atlasqtl_tpu_torch" / "csrc"
    srcs = {}
    for src in _SOURCES:
        srcs[("here", src.stem)] = src
        if (other / src.name).exists():
            srcs[("there", src.stem)] = other / src.name
    cuobjdump = str(Path(_nvcc()).parent / "cuobjdump")
    with tempfile.TemporaryDirectory() as work:
        cubins = _compile(srcs, Path(work))
        funcs = {key: _functions(c, cuobjdump) for key, c in cubins.items()}
    report = {}
    for src in _SOURCES:
        here = funcs[("here", src.stem)]
        there = funcs.get(("there", src.stem), ({}, {}))
        pairs = {f: _counterpart(f, there[0]) for f in here[0]}
        pairs = {f: g for f, g in pairs.items() if g is not None}
        same, differ = [], {}
        for f, g in sorted(pairs.items()):
            if (here[0][f].replace(f, g) == there[0][g]
                    and here[1].get(f) == there[1].get(g)):
                same.append(f)
            else:
                a = here[0][f].replace(f, g).splitlines()
                b = there[0][g].splitlines()
                diff = [(x, y) for x, y in zip(a, b) if x != y]
                differ[f] = {"there": g, "res_here": here[1].get(f),
                             "res_there": there[1].get(g),
                             "sass_lines": [len(a), len(b)],
                             "lines_differing": len(diff),
                             "first_differing": diff[:4]}
        report[src.name] = {
            "same": same, "differ": differ,
            "only_here": sorted(set(here[0]) - set(pairs)),
            "only_there": sorted(set(there[0]) - set(pairs.values()))}
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON object to this file")
    a = ap.parse_args()
    report = compare(a.other_root)
    text = json.dumps(report)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(report, indent=1))
    n_diff = sum(len(r.get("differ", {})) for r in report.values())
    print(text)
    print(json.dumps({"identical": sum(len(r.get("same", []))
                                       for r in report.values()),
                      "differ": n_diff}))


if __name__ == "__main__":
    main()
