#!/usr/bin/env python3
"""Blocking variants of the recompute-fused kernel, timed on one GPU.

Builds variants of ``fdtd3d_torch/csrc/fused_eh.cu`` by textual
substitution of its brick (``TX`` x planes marched, ``TY`` y rows,
``TZ`` z columns) and of its launch bounds, checks each against the
plain version (``pallas_fused.fused_eh_plain``) at the gate of
``chip_smoke.py`` (2e-6 of each output's max), and times one launch of
each with CUDA events, in turns (a, b, ..., b, a), beside the two-pass
kernels' E + H launches, on ``Examples/vacuum3D_tfsf.txt`` at 256^3
after 150 steps and ``Examples/sphere3D_mie.txt`` (512^3) after 200.

Prints one JSON object: ms per launch per variant and grid (both
turns), and the card's name and power limit. Needs a CUDA device and
nvcc; prints no result without them.

    python3 scripts/fused_variants.py [--out FILE] [--skip-512]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join(ROOT, "fdtd3d_torch", "csrc", "fused_eh.cu")
OUT_DIR = os.path.join(ROOT, "build", "fused_variants")

# name -> {text in the source: its replacement}
VARIANTS = {
    "as_built": {},
    "tx8": {"constexpr int TX = 16;": "constexpr int TX = 8;"},
    "tx32": {"constexpr int TX = 16;": "constexpr int TX = 32;"},
    "ty4": {"constexpr int TY = 8;": "constexpr int TY = 4;"},
    "ty16": {"constexpr int TY = 8;": "constexpr int TY = 16;",
             "__launch_bounds__(THREADS, 4) fused_eh":
             "__launch_bounds__(THREADS) fused_eh"},
    "min3": {"__launch_bounds__(THREADS, 4) fused_eh":
             "__launch_bounds__(THREADS, 3) fused_eh"},
    "tz31": {"constexpr int TZ = 32;": "constexpr int TZ = 31;"},
    "tz31_ty16": {"constexpr int TZ = 32;": "constexpr int TZ = 31;",
                  "constexpr int TY = 8;": "constexpr int TY = 16;",
                  "__launch_bounds__(THREADS, 4) fused_eh":
                  "__launch_bounds__(THREADS) fused_eh"},
    "min5": {"__launch_bounds__(THREADS, 4) fused_eh":
             "__launch_bounds__(THREADS, 5) fused_eh"},
    "min6": {"__launch_bounds__(THREADS, 4) fused_eh":
             "__launch_bounds__(THREADS, 6) fused_eh"},
    "no_min": {"__launch_bounds__(THREADS, 4) fused_eh":
               "__launch_bounds__(THREADS) fused_eh"},
    "ty16_min3": {"constexpr int TY = 8;": "constexpr int TY = 16;",
                  "__launch_bounds__(THREADS, 4) fused_eh":
                  "__launch_bounds__(THREADS, 3) fused_eh"},
}


def build_variants():
    """One nvcc per variant, all started together: name -> ctypes lib."""
    from fdtd3d_torch.ops import build, pallas_fused
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SRC) as f:
        text = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs.items():
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            src = src.replace(old, new)
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.flags("fused_eh"), "-I", build.CSRC,
             "-Xptxas", "-v",
             "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        ptxas[name] = [ln.strip() for ln in (err + out).splitlines()
                       if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(lib)
        fn = libs[name].fdtd_fused_eh
        fn.argtypes = [ctypes.POINTER(pallas_fused._Params),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-512", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fdtd3d_torch.ops import pallas3d, pallas_fused
    from fdtd3d_torch.sim import Simulation
    dev = torch.device("cuda", 0)
    libs, ptxas = build_variants()
    grids = [("256", cs.config(cs.EXAMPLE, ["--same-size", "256"]), 150,
              30)]
    if not args.skip_512:
        grids.append(("512_mie", cs.config(cs.MIE, []), 200, 10))
    result = {"ptxas": ptxas, "ms": {}}
    for label, cfg, advance, reps in grids:
        sim = Simulation(cfg, device=dev)
        sim.advance(advance)
        st, static, coeffs = sim.state, sim.static, sim.coeffs
        del sim
        fe, fh, pe, ph = cs.kernel_args(static, coeffs, st)
        args_ = (st["E"], st["H"], pe, ph, st.get("J"), fe, fh)
        want = cs.as_tree(pallas_fused.fused_eh_plain(*args_),
                          ("E", "H", "psi_E", "psi_H", "J"))
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(name):
            prm, outs = pallas_fused.fused_params(*args_)
            err = libs[name].fdtd_fused_eh(ctypes.byref(prm),
                                           ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
            return outs

        for name in libs:
            got = cs.as_tree(run(name), ("E", "H", "psi_E", "psi_H", "J"))
            torch.cuda.synchronize()
            cs.compare(got, want, f"variant {name} at {label}")
        del want
        order = list(libs) + list(reversed(list(libs)))
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cs.timed(lambda: run(name), reps))
        times["two_pass_e_plus_h"] = [cs.timed(lambda: (
            pallas3d.e_family(st["E"], st["H"], pe, st.get("J"), fe),
            pallas3d.h_family(st["H"], st["E"], ph, fh)), reps)]
        result["ms"][label] = times
        print(f"fused_variants {label}: {json.dumps(times)}",
              file=sys.stderr, flush=True)
        del st, args_
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    result["nvidia_smi"] = smi.stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
