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
``fdtd3d_torch.batch``). With ``--ds SIZES`` (default 256) it also
times the float32x2 step of ``Examples/precision3D_float32x2.txt`` at
``--same-size`` each of the comma-separated sizes (128: the example as
it stands) after 100 steps, and its kernels: the line kernel and the
one-pass
``ds_pass`` where the checkout has them, else the two in-place
``e_update``/``h_update`` launches of the earlier design with the
step's record terms; a size with the suffix ``_k`` (``256_k``) adds
the K sphere of ``chip_smoke.k_sphere_flags`` (magnetic Drude K, km/bm
grids), and ``--only-ds`` times only these. With ``--fused SIZES`` it also times the
recompute-fused pass (one ``fused_eh`` call: the section kernels where
the checkout has them, else its single launch), the two-pass
``e_family`` and ``h_family`` launches, and the whole fused and
two-pass steps, on ``Examples/vacuum3D_tfsf.txt`` at 256^3 after 150
steps and (512) on ``Examples/sphere3D_mie.txt`` as it stands after 200
(two-pass steps both), in f32 or (``256_bf16``, ``512_bf16``) bf16, and
at 256 both ladder steps' launches a step under torch.profiler (the
two-pass launches alone too, where the checkout's ``chip_smoke.py``
times them so); ``--only-fused`` skips the rest. With
``--packed`` it also times the packed single step's builds, twice each:
``e_update``, ``h_update`` and the whole packed step at 256^3 on
vacuum3D_tfsf after 150 packed steps in float32, bf16 and compensated
mode, the f32 main path's temporal-blocked step there (half a pass
call), ``e_update``/``h_update`` (J and K, 18 coefficient grids) and
the packed step on the double-negative sphere of ``chip_smoke.py``
phase 23 at 512^3 after 20 steps, and (``--lanes``, 4 unless given)
the lane-capable launches on the Mie lanes. With ``--tb KEYS`` it
also times one solo temporal-blocked pass, twice, at each of the
comma-separated keys: ``256`` (vacuum3D_tfsf at 256^3 after 150 steps),
``256_bf16`` (the same in bf16), ``mie512`` (``Examples/sphere3D_mie.txt``
as it stands, one lane at 512^3, after 20 steps); ``--only-tb`` times
only these. Needs a CUDA
device. Compare two commits within one call, in turns (parent, change,
change, parent), each in its own process: unpack the other commit into
a directory that ``.gitignore`` lists (``git archive``) and pass it as
``PATH``.

    python3 scripts/solo_kernel_times.py [PATH] [--lanes 4] [--ds 256,128]
        [--only-ds] [--fused 256,512] [--only-fused] [--packed]
        [--tb 256,256_bf16,mie512] [--only-tb]
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
    ap.add_argument("--ds", nargs="?", const="256", default=None,
                    help="also time the float32x2 step and its kernels "
                         "at these comma-separated sizes (default 256)")
    ap.add_argument("--fused", nargs="?", const="256", default=None,
                    help="also time the fused pass, the two-pass kernels "
                         "and both ladder steps at 256 and/or 512 (a "
                         "_bf16 suffix: in bf16)")
    ap.add_argument("--only-ds", action="store_true",
                    help="with --ds: skip the other kernels' times")
    ap.add_argument("--only-fused", action="store_true",
                    help="with --fused: skip the other kernels' times")
    ap.add_argument("--tb", default=None,
                    help="also time one solo tb pass at these keys "
                         "(256, 256_bf16, mie512)")
    ap.add_argument("--only-tb", action="store_true",
                    help="with --tb: skip the other kernels' times")
    ap.add_argument("--packed", action="store_true",
                    help="also time the packed step's builds (f32, bf16, "
                         "compensated, the DNG sphere at 512^3, lanes)")
    args = ap.parse_args()
    if args.packed and not args.lanes:
        args.lanes = 4
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
    dev = torch.device("cuda", 0)
    out = {"checkout": args.path,
           "card": torch.cuda.get_device_name(0)}
    if args.tb and args.only_tb:
        build.build_many(["packed_tb"])
        for key in args.tb.split(","):
            out[f"tb_{key}"] = tb_times(cs, dev, key)
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
        return 0
    if args.ds and args.only_ds:
        build.build_many(["packed_ds"])
        for size in args.ds.split(","):
            out[f"ds_{size}"] = ds_times(cs, dev, size)
        print(json.dumps(out), flush=True)
        return 0
    if args.fused and args.only_fused:
        build.build_many(["family", "fused_eh"])
        for size in args.fused.split(","):
            out[f"fused_{size}"] = fused_times(cs, dev, size)
        print(json.dumps(out), flush=True)
        return 0
    build.build_many(["packed_eh", "packed_tb"]
                     + (["packed_ds"] if args.ds else [])
                     + (["family", "fused_eh"] if args.fused else []))
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
        alloc = getattr(packed, "alloc_like", None) \
            or getattr(packed_tb, "_alloc_like")
        bspare = alloc(bc)
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
    if args.packed:       # the memory of the states above, released
        sim = carry = spare = tcc = cc = terms = None
        bsim = bc = bspare = kcc = bterms = None
        torch.cuda.empty_cache()
        out["packed"] = packed_times(cs, dev)
    for size in args.ds.split(",") if args.ds else ():
        out[f"ds_{size}"] = ds_times(cs, dev, size)
    for size in args.fused.split(",") if args.fused else ():
        out[f"fused_{size}"] = fused_times(cs, dev, size)
    print(json.dumps(out), flush=True)
    return 0


def tb_times(cs, dev, key, reps=30):
    """One solo tb pass at ``key`` (see the module docstring), twice, on
    the state its run reached, out of place into a copy of the carry."""
    from fdtd3d_torch.ops import packed_tb
    from fdtd3d_torch.sim import Simulation
    if key == "mie512":
        cfg, steps = cs.config(cs.MIE, []), 20
    else:
        size, _, dt = key.partition("_")
        cfg = cs.config(cs.EXAMPLE, ["--same-size", size]
                        + (cs.BF16 if dt == "bf16" else []))
        steps = 150
    sim = Simulation(cfg, device=dev)
    sim.advance(steps)
    carry = sim._carry
    tcc = packed_tb.make_packed_tb_step(sim.static, dev).prepare(sim.coeffs)
    spare = {k: cs.clone_carry(v) for k, v in carry.items()
             if k in ("E", "H", "J", "psE", "psH")}
    _, terms, drive = packed_tb.generation_terms(sim.static, tcc["tb"],
                                                 carry.get("inc"),
                                                 carry["t"])
    return {f"tb_ms_{rep}": cs.timed(lambda: packed_tb.tb_pass(
        carry, spare, tcc["tb"], terms, drive), reps) for rep in range(2)}


def packed_times(cs, dev, reps=30):
    """The packed step's builds (see the module docstring), twice each."""
    import torch
    from fdtd3d_torch.ops import packed, packed_tb
    from fdtd3d_torch.sim import Simulation
    out = {}

    def launches(key, sim, reps):
        carry = sim._carry
        step = packed.make_packed_step(sim.static, dev)
        cc = step.prepare(sim.coeffs)
        for rep in range(2):
            out[f"{key}_e_ms_{rep}"] = cs.timed(lambda: packed.e_update(
                carry["E"], carry["H"], carry.get("J"), carry["psE"],
                cc["E"], carry.get("rE")), reps)
            out[f"{key}_h_ms_{rep}"] = cs.timed(lambda: packed.h_update(
                carry["H"], carry["E"], carry["psH"], cc["H"],
                carry.get("K"), carry.get("rH")), reps)
            out[f"{key}_step_ms_{rep}"] = cs.timed(lambda: step(carry, cc),
                                                   reps)

    for key, extra in (("f32", []), ("bf16", cs.BF16),
                       ("comp", ["--compensated"])):
        torch.cuda.empty_cache()
        os.environ["FDTD3D_NO_TEMPORAL"] = "1"     # the packed step
        try:
            sim = Simulation(cs.config(cs.EXAMPLE, ["--same-size", "256"]
                                       + extra), device=dev)
        finally:
            os.environ.pop("FDTD3D_NO_TEMPORAL")
        sim.advance(150)
        launches(key, sim, reps)
        del sim
    torch.cuda.empty_cache()
    sim = Simulation(cs.config(cs.EXAMPLE, ["--same-size", "256"]),
                     device=dev)
    sim.advance(150)
    tb = packed_tb.make_packed_tb_step(sim.static, dev)
    tcc = tb.prepare(sim.coeffs)
    for rep in range(2):
        out[f"tb_step_ms_{rep}"] = cs.timed(lambda: tb(sim._carry, tcc),
                                            reps) / 2
    del sim, tb, tcc
    torch.cuda.empty_cache()
    sim = Simulation(cs.config(cs.MIE, cs.dng_flags(512, 20)), device=dev)
    sim.advance(20)
    launches("dng512", sim, 10)
    del sim
    torch.cuda.empty_cache()
    return out


def fused_times(cs, dev, size):
    """The fused pass, the two-pass kernels and both ladder steps at
    ``size`` (256: the vacuum example at 256^3; 512: the Mie example;
    with ``_bf16``: in bf16), twice each; the two-pass launches alone
    where the checkout times them so; at 256 both ladder steps' launches
    a step under torch.profiler."""
    import torch
    from fdtd3d_torch.ops import pallas3d, pallas_fused
    from fdtd3d_torch.sim import Simulation
    torch.cuda.empty_cache()
    path, extra, steps, reps = {
        "256": (cs.EXAMPLE, ["--same-size", "256"], 150, 30),
        "256_bf16": (cs.EXAMPLE, ["--same-size", "256"] + cs.BF16, 150, 30),
        "512": (cs.MIE, [], 200, 10),
        "512_bf16": (cs.MIE, cs.BF16, 200, 10)}[size]
    with cs.ladder_env("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"):
        sim = Simulation(cs.config(path, extra), device=dev)
        sim.advance(steps)
    static, coeffs, st = sim.static, sim.coeffs, sim.state
    if hasattr(cs, "family_args"):      # the launches with their sources
        e_args, h_args = cs.family_args(static, coeffs, st)
    else:                               # patches after each launch
        fe, fh, pe, ph = cs.kernel_args(static, coeffs, st)
        e_args = (st["E"], st["H"], pe, st.get("J"), fe)
        h_args = (st["H"], st["E"], ph, fh)
    if hasattr(cs, "fused_args"):       # the pass with its sources
        fargs = cs.fused_args(static, coeffs, st)
    else:                               # one launch, patches after it
        fargs = (st["E"], st["H"], pe, ph, st.get("J"), fe, fh)
    ladder = {}
    for name, build_step in (("fused", pallas_fused.make_fused_eh_step),
                             ("pallas3d", pallas3d.make_pallas_step)):
        k_step = build_step(static, dev)
        ladder[name] = (k_step, k_step.prepare(coeffs))
    out = {"shape": list(static.grid_shape)}
    for rep in range(2):
        out[f"fused_ms_{rep}"] = cs.timed(
            lambda: pallas_fused.fused_eh(*fargs), reps)
        out[f"e_family_ms_{rep}"] = cs.timed(
            lambda: pallas3d.e_family(*e_args), reps)
        out[f"h_family_ms_{rep}"] = cs.timed(
            lambda: pallas3d.h_family(*h_args), reps)
        for name, (k_step, cc) in ladder.items():
            out[f"{name}_step_ms_{rep}"] = cs.timed(
                lambda: k_step(st, cc), reps)
    if hasattr(cs, "family_launch_ms"):  # the launches alone
        out["e_family_launch_ms"] = cs.family_launch_ms("e_family", e_args,
                                                        reps)
        out["h_family_launch_ms"] = cs.family_launch_ms("h_family", h_args,
                                                        reps)
    if size == "256":                   # launches a step, by the profiler
        for name, names in (("pallas3d", ("FDTD3D_NO_PACKED",
                                          "FDTD3D_NO_FUSED")),
                            ("fused", ("FDTD3D_NO_PACKED",
                                       "FDTD3D_FORCE_FUSED"))):
            with cs.ladder_env(*names):
                psim = Simulation(cs.config(path, extra), device=dev)
                psim.advance(20)
                out[f"{name}_profile"] = cs.profile_window(psim, 20)
                del psim
    del sim, st, fargs, ladder, e_args, h_args
    return out


def ds_times(cs, dev, size):
    """The float32x2 step at ``size``^3 and its kernels, twice each."""
    import torch
    from fdtd3d_torch.ops import packed_ds, tfsf
    from fdtd3d_torch.sim import Simulation
    torch.cuda.empty_cache()
    n, _, k = size.partition("_")
    sim = Simulation(cs.config(cs.PRECISION, cs.k_sphere_flags(int(n))
                               if k == "k" else ["--same-size", n]),
                     device=dev)
    sim.advance(100)
    carry = sim._carry
    step = packed_ds.make_packed_ds_step(sim.static, dev)
    cc = step.prepare(sim.coeffs)
    out = {}
    if hasattr(packed_ds, "ds_pass"):       # line kernel + one pass
        from fdtd3d_torch.ops import packed
        inc = carry["inc"]
        line_dst = {k: torch.empty_like(v) for k, v in inc.items()}
        spare = packed.alloc_like(carry)
        pair = tfsf.line_source(sim.static.tfsf_setup, sim.static.omega,
                                sim.static.dt)(int(carry["t"]))
        kernels = {
            "ds_line": lambda: packed_ds.line_advance(inc, line_dst, cc,
                                                      pair),
            "ds_pass": lambda: packed_ds.ds_pass(carry, spare, cc, inc,
                                                 line_dst, None)}
    else:                                   # two in-place launches
        terms = packed_ds.record_terms(cc["plan"], carry["inc"])
        kernels = {
            "ds_e_update": lambda: packed_ds.e_update(
                carry["E"], carry["H"], carry.get("J"), carry["psE"],
                cc["E"], terms, None),
            "ds_h_update": lambda: packed_ds.h_update(
                carry["H"], carry["E"], carry["psH"], cc["H"], terms)}
    for rep in range(2):
        for name, fn in kernels.items():
            out[f"{name}_ms_{rep}"] = cs.timed(fn, 20)
        out[f"ds_step_ms_{rep}"] = cs.timed(lambda: step(carry, cc), 20)
    return out


if __name__ == "__main__":
    sys.exit(main())
