#!/usr/bin/env python3
"""Wall of the supervised main path of one checkout, for an A/B of two
commits on the same card.

Runs the CLI of the checkout at ``PATH`` (default: this one) in a child
process (its kernels built in that checkout) on
``Examples/vacuum3D_tfsf.txt --same-size 256`` for 150 steps with
``--supervise --checkpoint-every 10`` and NaNs at t = 20, 40, 60, 80
(``FDTD3D_FAULT_PLAN``): the run of ``chip_smoke.py`` phase 26 (c), whose
finite check reads the health pass every chunk. Prints one JSON object:
the stepping wall of the closing ``done:`` line, the child's wall, the
supervisor's closing line, and the card's name and power limit.

Compare two commits within one call, in turns (parent, change, change,
parent), each in its own process: unpack the other commit into a
gitignored directory (``mkdir -p build/parent && git archive <commit> |
tar -x -C build/parent``), then ``python3 scripts/supervised_wall.py
build/parent; python3 scripts/supervised_wall.py`` twice. Needs a CUDA
device.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

PLAN = "nan@t=20; nan@t=40; nan@t=60; nan@t=80"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args()
    root = os.path.abspath(args.path)
    save = tempfile.mkdtemp(prefix="supervised_wall_", dir=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build"))
    argv = ["--cmd-from-file", os.path.join(root, "Examples",
                                            "vacuum3D_tfsf.txt"),
            "--same-size", str(args.size), "--supervise",
            "--checkpoint-every", "10", "--save-res", "150", "--save-dir",
            save]
    env = dict(os.environ, FDTD3D_FAULT_PLAN=PLAN, PYTHONPATH=root)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "fdtd3d_torch.cli"]
                          + argv, cwd=root, env=env, capture_output=True,
                          text=True, timeout=900, check=False)
    wall = time.time() - t0
    shutil.rmtree(save, ignore_errors=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        return proc.returncode
    done = re.search(r"done: \d+ steps in ([0-9.]+)s", proc.stdout)
    sup = [ln for ln in proc.stdout.splitlines()
           if ln.startswith("supervisor:")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False, timeout=60)
    rec = {"checkout": root, "size": args.size, "plan": PLAN,
           "stepping_s": float(done.group(1)) if done else None,
           "process_s": wall, "supervisor": sup,
           "card": smi.stdout.strip()}
    sys.stdout.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
