#!/usr/bin/env python3
"""Each design choice of the two-pass step's launches against its
alternative, on one GPU, in one call.

Builds variants of ``fdtd3d_torch/csrc/family.cu`` with nvcc ``-D``
build knobs, flags and source patches (written under
``build/family_variants``, each patch's text found in the source exactly
once), and plan options of ``ops/pallas3d.py::plan_items``; holds each
variant's ``e_family`` and ``h_family`` launches against their plain
versions (``e_family_plain``, ``h_family_plain``: bit for bit for the
builds without FMA contraction, else at the gates: f32 2e-6 and bf16
2e-2 of each family's max) on the main paths' states, and times the two
launches of each, by CUDA events, in turns (a, b, ..., b, a), each
launch from one prebuilt parameter block, so no host-side set-up is
timed. States, each after its run's two-pass steps (``FDTD3D_NO_PACKED``
with ``FDTD3D_NO_FUSED``): ``Examples/vacuum3D_tfsf.txt`` at
``--same-size 256`` after 150 steps in f32 (``256``) and bf16
(``256_bf16``), ``Examples/sphere3D_mie.txt`` as it stands (512^3,
eps-sphere grids in their box) after 20 steps (``mie512``), and the
double-negative sphere of ``chip_smoke.py`` phase 24 at 256^3 (J, K and
their grids) after 20 steps (``dng256``). Variants:

* ``as_built``: the source as it is (tiles of 4 rows, one warp a row;
  two z cells a thread where n3 is even, in either dtype, so z is cut at
  multiples of 64 cells; the other family and the thread's own old
  values and J or K two planes ahead by cp.async into rings of three
  planes; the SLAB, SOURCE and PLAIN items by their own kernels, each
  started by programmatic dependent launch; registers for eight blocks
  an SM in float32, six in bf16; x segments of 16 planes; no FMA
  contraction);
* ``pipe_1``, ``pipe_3``: one or three planes ahead;
* ``f32_blocks_6``: registers for six blocks an SM in float32;
  ``blocks_4``, ``blocks_8``: for four or eight in bf16;
* ``f32_one``: one z cell a thread in the float32 build;
* ``ty_2``, ``ty_8``, ``ty_16``: tiles of 2, 8 or 16 rows (registers for
  as many threads an SM); ``ty_8_f32_one``: 8 rows and one cell a
  thread in float32 (the first design);
* ``no_sections``: every item in the SLAB kernel; ``no_overlap``: the
  sections launched in plain stream order;
* ``fmad``: FMA contraction allowed (no ``--fmad=false``);
* ``no_grid_box``: every item reads the coefficient grids;
* ``seg_8``, ``seg_32``: x segments of at most that many planes;
* ``skip_math``, ``skip_stores``: timing-only builds without the curl
  terms, sources and ADE current, and then also without the stores: the
  march's loads, barriers and rings alone. Their results are wrong by
  design and are not checked; they patch the source's text
  (``PATCHES``), so the shipped kernel carries no timing-only branch.

Prints one JSON object: the card's name and power limit, per variant the
kernels' registers and spills (ptxas), the worst difference of its
launches from the plain versions relative to each family's max, and per
state the ms of e_family and h_family (both turns). A variant whose
build or launch fails is listed under ``failed``. Needs a CUDA device
and nvcc; prints no result without them.

    python3 scripts/family_variants.py [--only a,b] [--reps N]
        [--states 256,256_bf16,mie512,dng256] [--out FILE]
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
OUT_DIR = os.path.join(ROOT, "build", "family_variants")

# timing-only source patches: (text of the source, its replacement),
# each text found exactly once
PATCHES = {
    "math": (("        for (int t = 0; t < 2; ++t) {\n"
              "          const int a = term_axis(c, t);\n"
              "          float term;",
              "        for (int t = 0; t < 0; ++t) {\n"
              "          const int a = term_axis(c, t);\n"
              "          float term;"),
             ("        if (SRC) {  // the family's records on the cell",
              "        if (false) {  // the family's records on the cell"),
             ("        jn[v] = ade ? ka[v] * jo[v] + kb[v] * old[v] : 0.f;",
              "        jn[v] = 0.f;")),
    "stores": (("      stv<V>(fld<T>(p.f.out, c) + cell0, out);",
                "      if (out[0] == 1.2345e30f) "
                "stv<V>(fld<T>(p.f.out, c) + cell0, out);"),),
}

# name -> (nvcc -D knobs, source patches, plan option, FMA contraction)
VARIANTS = {
    "as_built": ((), (), None, False),
    "pipe_1": (("PIPE=1",), (), None, False),
    "pipe_3": (("PIPE=3",), (), None, False),
    "f32_blocks_6": (("F32_BLOCKS=6",), (), None, False),
    "blocks_4": (("MIN_BLOCKS=4",), (), None, False),
    "blocks_8": (("MIN_BLOCKS=8",), (), None, False),
    "f32_one": (("F32_PAIRS=0",), (), None, False),
    "ty_2": (("TY=2", "MIN_BLOCKS=12", "F32_BLOCKS=16"), (), None, False),
    "ty_8": (("TY=8", "MIN_BLOCKS=3", "F32_BLOCKS=4"), (), None, False),
    "ty_8_f32_one": (("TY=8", "MIN_BLOCKS=3", "F32_BLOCKS=4",
                      "F32_PAIRS=0"), (), None, False),
    "ty_16": (("TY=16", "MIN_BLOCKS=2", "F32_BLOCKS=2"), (), None, False),
    "no_sections": (("SECTIONS=0",), (), None, False),
    "no_overlap": (("OVERLAP=0",), (), None, False),
    "fmad": ((), (), None, True),
    "no_grid_box": ((), (), "no_grid_box", False),
    "seg_8": ((), (), "seg_8", False),
    "seg_32": ((), (), "seg_32", False),
    "skip_math": ((), ("math",), None, False),
    "skip_stores": ((), ("math", "stores"), None, False),
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
    """One nvcc per distinct build (knobs, patches, flags), all started
    together; name -> (library or the build error, ptxas lines)."""
    from fdtd3d_torch.ops import build
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(build.CSRC, "family.cu")) as f:
        source = f.read()
    procs, paths = {}, {}
    for name in names:
        knobs, patches, _, fmad = VARIANTS[name]
        stem = "_".join(("family",) + tuple(k.replace("=", "")
                                            for k in knobs) + patches
                        + (("fmad",) if fmad else ()))
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
        flags = [f for f in build.flags("family")
                 if not (fmad and f == "--fmad=false")]
        cmd = [build.find_nvcc(), *flags, "-I", build.CSRC,
               *(f"-D{k}" for k in knobs), "-Xptxas", "-v", "-o", path, cu]
        procs[path] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    done = {}
    for path, proc in procs.items():
        if isinstance(proc, Exception):
            done[path] = (proc, [])
            continue
        out, err = proc.communicate()
        lines = sorted({ln.strip() for ln in (err + out).splitlines()
                        if "registers" in ln or "spill" in ln})
        done[path] = (ctypes.CDLL(path) if proc.returncode == 0
                      else RuntimeError(f"nvcc failed:\n{err[-2000:]}"),
                      lines)
    return {name: done[paths[name]] for name in names}


def plan_option(base, option):
    """The planner ``base`` (``pallas3d.plan_items``) under a variant's
    plan option."""
    import numpy as np
    if option is None:
        return base

    @functools.wraps(base)
    def planned(*args, **kw):
        if option.startswith("seg_"):
            return base(*args, **dict(kw, segments=(int(option[4:]),)))
        rows, counts = base(*args, **kw)       # no_grid_box
        rows = np.array(rows)
        rows[:, 7] = 1
        return rows, counts
    return planned


def state(cs, dev, name):
    """(simulation, prepared operands, the launches' arguments) of a
    state (see the module docstring)."""
    from fdtd3d_torch.ops import pallas3d, tfsf
    from fdtd3d_torch.sim import Simulation
    if name == "dng256":
        cfg, steps = cs.config(cs.MIE, cs.dng_flags(256, 20)), 20
    elif name == "mie512":
        cfg, steps = cs.config(cs.MIE, []), 20
    else:
        extra = cs.BF16 if name.endswith("bf16") else []
        cfg, steps = cs.config(cs.EXAMPLE, ["--same-size", "256"] + extra), \
            150
    with cs.ladder_env("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"):
        sim = Simulation(cfg, device=dev)
    if sim.step_kind != "pallas3d_cuda":
        raise RuntimeError(f"{name}: ran {sim.step_kind}")
    sim.advance(steps)
    static, st = sim.static, sim.state
    fp = pallas3d.prepare(static, sim.coeffs)
    terms = None
    if static.tfsf_setup is not None:
        inc = tfsf.advance_einc(st["inc"], sim.coeffs, st["t"], static.dt,
                                static.omega, static.tfsf_setup)
        terms = tfsf.record_terms(fp["plan"], inc)
    drive = pallas3d.point_drive(static, fp, st["t"])
    psi = {fam: {k: st[f"psi_{fam}"][k] for v in fp[fam]["psi"].values()
                 for _, k in v} for fam in "EH"}
    args = {"E": (st["E"], st["H"], psi["E"], st.get("J"), fp, "E", terms,
                  drive),
            "H": (st["H"], st["E"], psi["H"], st.get("K"), fp, "H", terms,
                  None)}
    return sim, fp, args


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--states", default="256,256_bf16,mie512,dng256")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("family_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fdtd3d_torch.ops import build, pallas3d
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
    base = pallas3d.plan_items
    fns = {"E": "fdtd_e_family", "H": "fdtd_h_family"}

    def use(name, fp):
        build._LIBS["family"] = built[name][0]
        pallas3d.plan_items = plan_option(base, VARIANTS[name][2])
        for fam in "EH":
            fp.pop(f"_plan_{fam}", None)

    def block(fam, a):
        """A launch's parameter block on the variant's library, with its
        outputs."""
        lib = pallas3d._library()
        first = a[0][a[4][fam]["comps"][0]]
        return pallas3d._params(*a, *pallas3d.launch_geometry(
            lib, first, a[4]["shape"][2]))

    for sname in args.states.split(","):
        sim, fp, fargs = state(cs, dev, sname)
        tol = cs.BF16_TOL if sname.endswith("bf16") else cs.TOL
        want = {"E": pallas3d.e_family_plain(*fargs["E"][:5],
                                             *fargs["E"][6:])}
        want["H"] = pallas3d.h_family_plain(*fargs["H"][:3], fp,
                                            fargs["H"][3], fargs["H"][6])
        fam_max = {fam: max(float(v.float().abs().max())
                            for v in want[fam][0].values()) for fam in "EH"}
        for name in names:
            if name in failed or set(VARIANTS[name][1]) & set(TIMING_ONLY):
                continue
            use(name, fp)
            try:
                errs = []
                for fam in "EH":
                    prm, new_f, new_psi, new_j = block(fam, fargs[fam])
                    pallas3d.launch(pallas3d._library(), fns[fam], prm, dev)
                    torch.cuda.synchronize()
                    w_f, w_psi, w_j = want[fam]
                    errs += [float((new_f[c].float() - w_f[c].float()).abs()
                                   .max()) / fam_max[fam] for c in w_f]
                    errs += [float((new_psi[k] - w_psi[k]).abs().max())
                             for k in w_psi]
                    errs += [float((new_j[c] - w_j[c]).abs().max())
                             for c in (w_j or {})]
                err = max(errs)
                out["max_rel_err"].setdefault(sname, {})[name] = err
                exact = not VARIANTS[name][3]
                if (exact and err != 0.0) or not err < tol:
                    failed[name] = f"{sname}: differs from the plain " \
                                   f"versions ({err:.3e})"
            except RuntimeError as exc:     # a refused launch: recorded
                failed[name] = f"{sname}: {exc}"
        order = [n for n in names if n not in failed]
        ms = out["ms"].setdefault(sname, {})
        for name in order + order[::-1]:
            use(name, fp)
            lib = pallas3d._library()
            for fam in "EH":
                prm = block(fam, fargs[fam])[0]
                ms.setdefault(f"{name}_{fam}", []).append(cs.timed(
                    lambda: pallas3d.launch(lib, fns[fam], prm, dev),
                    args.reps))
        pallas3d.plan_items = base
        for fam in "EH":
            fp.pop(f"_plan_{fam}", None)
        print(f"family_variants {sname}: {json.dumps(ms)}", file=sys.stderr,
              flush=True)
        del sim, fp, fargs, want
        torch.cuda.empty_cache()
    build._LIBS.pop("family", None)
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
