#!/usr/bin/env python3
"""CUDA-event times of the solo f32 kernels of one checkout, for an A/B
of two commits on the same card.

Imports the port from the checkout at ``PATH`` (default: this one),
builds its kernels there, runs ``Examples/vacuum3D_tfsf.txt`` at
``--same-size 256`` for 150 steps (the main path's state), then times
one temporal-blocked pass, one ``e_update`` and one ``h_update`` launch
over 50 launches each, twice, and prints one JSON object. With
``--lanes B`` it also times the lane-capable tb pass and the lane-capable
``e_update`` and ``h_update`` (one launch for every lane) on B lanes of
``Examples/sphere3D_mie.txt`` as it stands (512^3, eps-sphere 2, 4, 6,
9, ... by lane) after 20 steps (a checkout that has
``fdtd3d_torch.batch``). Needs a CUDA device. Compare two commits within one call, in turns (parent,
change, change, parent), each in its own process: unpack the other
commit into a directory that ``.gitignore`` lists (``git archive``) and
pass it as ``PATH``.

    python3 scripts/solo_kernel_times.py [PATH] [--lanes 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=HERE)
    ap.add_argument("--lanes", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.path)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("solo_kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fdtd3d_torch.ops import build, packed, packed_tb
    from fdtd3d_torch.sim import Simulation
    build.build_many(["packed_eh", "packed_tb"])
    dev = torch.device("cuda", 0)
    cfg = cs.config(cs.EXAMPLE, ["--same-size", "256"])
    sim = Simulation(cfg, device=dev)
    sim.advance(150)
    carry = sim._carry
    cc = packed.make_packed_step(sim.static, dev).prepare(sim.coeffs)
    tcc = packed_tb.make_packed_tb_step(sim.static, dev).prepare(sim.coeffs)
    spare = {k: cs.clone_carry(v) for k, v in carry.items()
             if k in ("E", "H", "J", "psE", "psH")}
    _, terms, drive = packed_tb.generation_terms(sim.static, tcc["tb"],
                                                 carry["inc"], carry["t"])
    out = {"checkout": args.path,
           "card": torch.cuda.get_device_name(0)}
    for rep in range(2):
        out[f"tb_ms_{rep}"] = cs.timed(lambda: packed_tb.tb_pass(
            carry, spare, tcc["tb"], terms, drive), 50)
        out[f"e_ms_{rep}"] = cs.timed(lambda: packed.e_update(
            carry["E"], carry["H"], carry.get("J"), carry["psE"], cc["E"]),
            50)
        out[f"h_ms_{rep}"] = cs.timed(lambda: packed.h_update(
            carry["H"], carry["E"], carry["psH"], cc["H"]), 50)
    if args.lanes:
        del sim, carry, spare
        torch.cuda.empty_cache()
        from fdtd3d_torch.batch import BatchSimulation
        eps = ("2.0", "4.0", "6.0", "9.0")
        bsim = BatchSimulation(
            [cs.config(cs.MIE, ["--eps-sphere", eps[lane % len(eps)]])
             for lane in range(args.lanes)], device=dev)
        bsim.advance(20)
        bc = bsim._carry
        kcc = packed_tb.make_packed_tb_step(
            bsim.static, dev, batch=args.lanes).prepare(bsim._coeffs)
        bspare = packed_tb._alloc_like(bc)
        _, bterms, bdrive = packed_tb.generation_terms(
            bsim.static, kcc["tb"], bc["inc"], bc["t"])
        out["lanes"] = args.lanes
        out["lanes_shape"] = list(bsim.static.grid_shape)
        for rep in range(2):
            out[f"lanes_tb_ms_{rep}"] = cs.timed(lambda: packed_tb.tb_pass(
                bc, bspare, kcc["tb"], bterms, bdrive), 5)
            out[f"lanes_e_ms_{rep}"] = cs.timed(lambda: packed.e_update(
                bc["E"], bc["H"], bc.get("J"), bc["psE"], kcc["E"]), 5)
            out[f"lanes_h_ms_{rep}"] = cs.timed(lambda: packed.h_update(
                bc["H"], bc["E"], bc["psH"], kcc["H"]), 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
