#!/usr/bin/env python3
"""Host seconds of ``solver.build_coeffs`` in one or more checkouts, for
an A/B of the coefficient build on the same machine.

    python3 scripts/coeff_times.py [--size N] [--reps R] [PATH ...]

For each checkout at ``PATH`` (default: this one), in a process of its
own, builds the static setup of two configurations at ``--same-size N``
(default 256) and times ``build_coeffs`` ``R`` times (default 3):
``Examples/sphere3D_mie.txt`` with its eps sphere scaled to the grid,
and the double-negative sphere of ``chip_smoke.dng_flags`` (eps, Drude
J and magnetic Drude K spheres). Prints one JSON object a checkout with
the best and the worst time of each. Needs no GPU. An older checkout's
full-grid build holds several f64 grids of N^3 cells at once.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from fdtd3d_torch import solver
n, reps = int(sys.argv[2]), int(sys.argv[3])
h = str(n // 2)
mie = ["--same-size", str(n), "--eps-sphere-center-x", h,
       "--eps-sphere-center-y", h, "--eps-sphere-center-z", h,
       "--eps-sphere-radius", str(n // 8)]
out = {"path": sys.argv[1], "size": n}
for label, cfg in (("mie", cs.config(cs.MIE, mie)),
                   ("dng", cs.config(cs.MIE, cs.dng_flags(n, 10)))):
    static = solver.build_static(cfg)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solver.build_coeffs(static)
        times.append(time.perf_counter() - t0)
    out[label + "_s"] = [min(times), max(times)]
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    default=[os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    for path in args.paths:
        out = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.abspath(path),
             str(args.size), str(args.reps)],
            capture_output=True, text=True, env=dict(os.environ,
                                                     CUDA_VISIBLE_DEVICES=""))
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
