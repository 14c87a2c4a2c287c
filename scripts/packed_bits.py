#!/usr/bin/env python3
"""The packed step's bits of one checkout, for an A/B of two commits.

``python3 scripts/packed_bits.py run PATH OUT.npz`` imports the port
from the checkout at ``PATH``, builds its kernels there, seeds E and H
of ``Examples/vacuum3D_tfsf.txt`` at ``--same-size 256`` from a torch
generator on the card (seed 7, 0.01 sigma) and runs ``--steps`` packed
steps (``FDTD3D_NO_TEMPORAL``: the two launches of
``csrc/packed_eh.cu`` and the patches), then saves E, H and psi to
``OUT.npz``. ``python3 scripts/packed_bits.py compare A.npz B.npz``
prints, per leaf, the largest absolute difference, its ratio to the
leaf's largest value and how many cells differ, as one JSON object.
Each ``run`` in its own process (two checkouts do not share one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def run(path: str, out: str, steps: int) -> None:
    sys.path.insert(0, os.path.abspath(path))
    os.environ["FDTD3D_NO_TEMPORAL"] = "1"
    import numpy as np
    import torch

    from fdtd3d_torch import cli, convert
    from fdtd3d_torch.sim import Simulation
    example = os.path.join(path, "Examples", "vacuum3D_tfsf.txt")
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        cli.read_cmd_file(example) + ["--same-size", "256"]))
    dev = torch.device("cuda", 0)
    sim = Simulation(cfg, device=dev)
    if sim.step_kind != "packed_cuda":
        raise SystemExit(f"ran {sim.step_kind}, not packed_cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    for key in ("E", "H"):
        sim._carry[key].copy_(0.01 * torch.randn(
            sim._carry[key].shape, generator=g, device=dev))
    sim.run(steps)
    sim.block_until_ready()
    st = sim.state
    flat = {}
    for grp in ("E", "H", "psi_E", "psi_H"):
        for k, v in st[grp].items():
            flat[f"{grp}/{k}"] = convert.to_host(v)
    np.savez(out, **flat)
    print(json.dumps({"path": path, "steps": steps, "out": out}))


def compare(a: str, b: str) -> None:
    import numpy as np
    za, zb = np.load(a), np.load(b)
    rec = {}
    for k in sorted(za.files):
        x = za[k].astype(np.float64)
        y = zb[k].astype(np.float64)
        d = np.abs(x - y)
        scale = float(np.abs(x).max())
        rec[k] = {"max_abs": float(d.max()),
                  "rel": float(d.max()) / scale if scale else 0.0,
                  "cells_differ": int((d > 0).sum())}
    print(json.dumps(rec))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("path")
    r.add_argument("out")
    r.add_argument("--steps", type=int, default=150)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.path, args.out, args.steps)
    else:
        compare(args.a, args.b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
