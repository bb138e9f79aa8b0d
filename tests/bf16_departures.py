"""Print, as one JSON line, how far the port's two bf16 modes stand from
the JAX package's, each beside the mode's own distance from float32 in
JAX, on the CPU problems of tests/test_torch_bf16.py (the JAX kernels in
interpret mode):

- c7: `Config(mxu_bf16=True, block_size=256)`, one B1 sweep, where the
  kernel walks the block in two pieces of 128;
- c6: `Config(mis_pair_bf16=True)` at mis_sub = 16 (the default), 8 and
  4, one B2 sweep at c = 1 and 0.5, the port and JAX at the same mis_sub
  (ROADMAP.md C6, repaired: the port takes JAX's windows).

Per output, (mean, max) of |port - JAX bf16| ("port_vs_jax") and of |JAX
f32 - JAX bf16| ("mode"; for c6 at mis_sub = 16); for c7 also of the two
packages' float32 sweeps ("f32_port_vs_jax").

    JAX_PLATFORMS=cpu python tests/bf16_departures.py
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_bf16 as tb  # noqa: E402


def main():
    out = dict(c7=tb.c7_departure()[2],
               c6={str(c): tb.c6_distances(c) for c in (1.0, 0.5)})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
