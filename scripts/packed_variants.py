#!/usr/bin/env python3
"""Each design choice of the packed step's two launches against its
alternative, on one GPU, in one call.

Builds variants of ``fdtd3d_torch/csrc/packed_eh.cu`` with nvcc ``-D``
build knobs and source patches (written under ``build/packed_variants``,
each patch's text found in the source exactly once), and plan options of
``ops/packed.py::plan_items``; holds each variant's ``e_update`` and
``h_update`` against their plain versions (``e_update_plain``,
``h_update_plain``; compensated bit for bit, f32 at 2e-6 and bf16 at
2e-2 of each family's max) on the main paths' states, and times the two
launches of each, by CUDA events, in turns (a, b, ..., b, a). States:
``Examples/vacuum3D_tfsf.txt`` at ``--same-size 256`` after 150 packed
steps in f32 (``256``), bf16 (``256_bf16``) and compensated mode
(``256_comp``), and the double-negative sphere of ``chip_smoke.py``
phase 23 at 256^3 after 20 steps (``dng256``: J, K and 18 coefficient
grids inside the sphere's box). Variants:

* ``as_built``: the source as it is (tiles of 8 rows, one warp a row;
  z cut at multiples of 32 cells, 64 where a thread takes two; the
  other family, and the thread's own old family, J or K and residuals,
  two planes ahead by cp.async into rings of three planes; two cells a
  thread in bf16 and compensated mode; slab and plain items by their
  own kernels, the plain one started by programmatic dependent launch;
  registers for four blocks an SM in float32, three in bf16 and
  compensated mode; x segments of 16 planes);
* ``pipe_1``, ``pipe_3``: one or three planes ahead;
* ``f32_blocks_3``: registers for three blocks an SM in float32;
  ``blocks_2``, ``blocks_4``: for two or four in bf16 and compensated
  mode;
* ``f32_pairs``: two z cells a thread in the float32 build too (8-byte
  words, 256-byte rows), and with ``f32_pairs_blocks_3`` three blocks;
* ``ty_4``, ``ty_16``: tiles of 4 rows or 16;
* ``no_sections``: every item in the slab kernel;
* ``no_grid_box``: every item reads the coefficient grids (the plan's
  GRID flag on every row; what the kernel did before);
* ``seg_8``, ``seg_32``, ``seg_64``: x segments of at most that many
  planes;
* ``skip_math``, ``skip_stores``: timing-only builds without the
  update's curl terms and ADE current (no psi, no J or K update), and
  then also without the stores: the march's loads, barriers and ring
  alone. Their results are wrong by design and are not checked; they
  patch the source's text (``PATCHES``), so the shipped kernel carries
  no timing-only branch.

Prints one JSON object: the card's name and power limit, per variant the
kernels' registers, spills and blocks an SM (ptxas), the worst
difference of its launches from the plain versions, relative to each
family's max, and per state the ms of e_update + h_update (both turns;
one parameter block launched again and again, so no host-side set-up is
timed). A variant whose build or launch fails is listed under
``failed``. Needs a CUDA device and nvcc; prints no result without them.

    python3 scripts/packed_variants.py [--only a,b] [--reps N]
        [--states 256,256_bf16,256_comp,dng256] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "packed_variants")

# timing-only source patches: (text of the source, its replacement),
# each text found exactly once
PATCHES = {
    "math": (("        float acc = 0.f;\n#pragma unroll\n"
              "        for (int t = 0; t < 2; ++t) {",
              "        float acc = 0.f;\n#pragma unroll\n"
              "        for (int t = 0; t < 0; ++t) {"),
             ("        if (J) {  // the ADE current",
              "        if (false) {  // the ADE current")),
    "stores": (("      stv<V>(F + c * vol + cell0, out);",
                "      if (out[0] == 1.2345e30f) stv<V>(F + c * vol + cell0, "
                "out);"),),
}

# name -> (nvcc -D knobs, source patches, plan option)
VARIANTS = {
    "as_built": ((), (), None),
    "pipe_1": (("PIPE=1",), (), None),
    "pipe_3": (("PIPE=3",), (), None),
    "f32_blocks_3": (("F32_BLOCKS=3",), (), None),
    "blocks_2": (("MIN_BLOCKS=2",), (), None),
    "blocks_4": (("MIN_BLOCKS=4",), (), None),
    "f32_pairs": (("F32_PAIRS=1",), (), None),
    "f32_pairs_blocks_3": (("F32_PAIRS=1", "F32_BLOCKS=3"), (), None),
    "ty_4": (("TY=4", "MIN_BLOCKS=6", "F32_BLOCKS=8"), (), None),
    "ty_16": (("TY=16", "MIN_BLOCKS=2", "F32_BLOCKS=2"), (), None),
    "no_sections": (("SECTIONS=0",), (), None),
    "no_grid_box": ((), (), "no_grid_box"),
    "seg_8": ((), (), "seg_8"),
    "seg_32": ((), (), "seg_32"),
    "seg_64": ((), (), "seg_64"),
    "skip_math": ((), ("math",), None),
    "skip_stores": ((), ("math", "stores"), None),
}
TIMING_ONLY = ("math", "stores")


def patched_source(patches, src):
    """``src`` (the kernel's text) with the named ``PATCHES`` applied."""
    for name in patches:
        for old, new in PATCHES[name]:
            if src.count(old) != 1:
                raise RuntimeError(f"patch {name}: {old!r} is not in the "
                                   "source exactly once")
            src = src.replace(old, new)
    return src


def build_variants(names):
    """One nvcc per distinct build (knobs and patches), all started
    together; name -> (library or the build error, ptxas lines)."""
    from fdtd3d_torch.ops import build
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(build.CSRC, "packed_eh.cu")) as f:
        source = f.read()
    procs, paths = {}, {}
    for name in names:
        knobs, patches, _ = VARIANTS[name]
        stem = "_".join(("packed",) + tuple(k.replace("=", "")
                                            for k in knobs) + patches)
        paths[name] = path = os.path.join(OUT_DIR, stem + ".so")
        if path in procs:
            continue
        cu = os.path.join(OUT_DIR, stem + ".cu")
        try:
            text = patched_source(patches, source)
        except RuntimeError as exc:
            procs[path] = exc
            continue
        with open(cu, "w") as f:
            f.write(text)
        cmd = [build.find_nvcc(), *build.flags("packed_eh"), "-I", build.CSRC,
               *(f"-D{k}" for k in knobs), "-Xptxas", "-v", "-o", path, cu]
        procs[path] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    done = {}
    for path, proc in procs.items():
        if isinstance(proc, Exception):
            done[path] = (proc, [])
            continue
        out, err = proc.communicate()
        lines = [ln.strip() for ln in (err + out).splitlines()
                 if "registers" in ln or "spill" in ln]
        done[path] = (ctypes.CDLL(path) if proc.returncode == 0
                      else RuntimeError(f"nvcc failed:\n{err[-2000:]}"),
                      lines)
    return {name: done[paths[name]] for name in names}


def plan_option(base, option):
    """The planner ``base`` (``packed.plan_items``) under a variant's plan
    option."""
    import numpy as np
    if option is None:
        return base

    @functools.wraps(base)
    def planned(*args, **kw):
        if option.startswith("seg_"):
            return base(*args, **dict(kw, segments=(int(option[4:]),)))
        rows, counts = base(*args, **kw)       # no_grid_box
        rows = np.array(rows)
        rows[:, 7] |= 1
        return rows, counts
    return planned


def state(cs, dev, name):
    """(carry, packed operands) of a state (see the module docstring)."""
    from fdtd3d_torch.ops import packed
    from fdtd3d_torch.sim import Simulation
    flags = {"256": ["--same-size", "256"],
             "256_bf16": ["--same-size", "256"] + cs.BF16,
             "256_comp": ["--same-size", "256", "--compensated"]}
    os.environ["FDTD3D_NO_TEMPORAL"] = "1"     # the packed step
    try:
        if name == "dng256":
            cfg = cs.config(cs.MIE, cs.dng_flags(256, 20))
            steps = 20
        else:
            cfg = cs.config(cs.EXAMPLE, flags[name])
            steps = 150
        sim = Simulation(cfg, device=dev)
    finally:
        os.environ.pop("FDTD3D_NO_TEMPORAL")
    if sim.step_kind != "packed_cuda":
        raise RuntimeError(f"{name}: ran {sim.step_kind}")
    sim.advance(steps)
    cc = packed.make_packed_step(sim.static, dev).prepare(sim.coeffs)
    return sim, sim._carry, cc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--states", default="256,256_bf16,256_comp,dng256")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("packed_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fdtd3d_torch.ops import build, packed
    names = args.only.split(",") if args.only else list(VARIANTS)
    if "as_built" not in names:
        names.insert(0, "as_built")
    built = build_variants(names)
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "ptxas": {},
           "max_rel_err": {}, "ms": {}, "failed": {}}
    failed = out["failed"]
    for name, (lib, lines) in built.items():
        out["ptxas"][name] = lines
        if isinstance(lib, Exception):
            failed[name] = str(lib)
    base = packed.plan_items

    def use(name, cc):
        build._LIBS["packed_eh"] = built[name][0]
        packed.plan_items = plan_option(base, VARIANTS[name][2])
        for fam in ("E", "H"):
            cc[fam].pop("_params", None)

    def operands(carry, cc, fam):
        if fam == "E":
            return (carry["E"], carry["H"], carry.get("J"), carry["psE"],
                    cc["E"], carry.get("rE"))
        return (carry["H"], carry["E"], carry.get("K"), carry["psH"],
                cc["H"], carry.get("rH"))

    for sname in args.states.split(","):
        sim, carry, cc = state(cs, dev, sname)
        tol = cs.BF16_TOL if sname.endswith("bf16") else cs.TOL
        exact = sname.endswith("comp")
        want = cs.clone_carry(carry)
        packed.e_update_plain(*operands(want, cc, "E"))
        F, S, J, psi, fc, R = operands(want, cc, "H")
        packed.h_update_plain(F, S, psi, fc, J, R)
        fam_max = {k: float(v.float().abs().max()) for k, v in
                   (("E", want["E"]), ("H", want["H"]))}
        for name in names:
            if name in failed or set(VARIANTS[name][1]) & set(TIMING_ONLY):
                continue
            use(name, cc)
            try:
                got = cs.clone_carry(carry)
                for fam, fn in (("E", "fdtd_e_update"),
                                ("H", "fdtd_h_update")):
                    F, S, J, psi, fc, R = operands(got, cc, fam)
                    lib = packed._library()
                    prm = packed._params(F, S, J, psi, fc, R,
                                         *packed.launch_geometry(lib, F, fc))
                    packed._launch(lib, fn, prm, dev)
                torch.cuda.synchronize()
                errs = [float((got[k].float() - want[k].float()).abs().max())
                        / fam_max[k] for k in ("E", "H")]
                for k in ("J", "K", "rE", "rH"):
                    if k in want:
                        errs.append(float((got[k].float() - want[k].float())
                                          .abs().max()))
                err = max(errs)
                out["max_rel_err"].setdefault(sname, {})[name] = err
                if (exact and err != 0.0) or not err < tol:
                    failed[name] = f"{sname}: differs from the plain " \
                                   f"versions ({err:.3e})"
                del got
            except RuntimeError as exc:     # a refused launch: recorded
                failed[name] = f"{sname}: {exc}"
        del want
        order = [n for n in names if n not in failed]
        ms = out["ms"].setdefault(sname, {})
        reps = args.reps
        for name in order + order[::-1]:
            use(name, cc)
            lib = built[name][0]
            blocks = []
            for fam, fn in (("E", "fdtd_e_update"), ("H", "fdtd_h_update")):
                F, S, J, psi, fc, R = operands(carry, cc, fam)
                prm = packed._params(F, S, J, psi, fc, R,
                                     *packed.launch_geometry(
                                         packed._library(), F, fc))
                blocks.append((fn, prm))
            ms.setdefault(name, []).append(cs.timed(lambda: [
                packed._launch(lib, fn, prm, dev) for fn, prm in blocks],
                reps))
        packed.plan_items = base
        for fam in ("E", "H"):
            cc[fam].pop("_params", None)
        print(f"packed_variants {sname}: {json.dumps(ms)}", file=sys.stderr,
              flush=True)
        del sim, carry, cc
        torch.cuda.empty_cache()
    build._LIBS.pop("packed_eh", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    out["nvidia_smi"] = smi.stdout.strip()
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
