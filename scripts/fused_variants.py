#!/usr/bin/env python3
"""Each design choice of the recompute-fused pass against its alternative,
on one GPU, in one call.

Builds variants of ``fdtd3d_torch/csrc/fused_eh.cu`` with nvcc ``-D``
build knobs, source patches (written under ``build/fused_variants``, each
patch's text found in the source exactly once) and plan options of
``ops/pallas_fused.py::plan_items``; holds each variant's pass against
the plain version (``pallas_fused.fused_eh_plain``) on the main path's
states, and times the pass of each, by CUDA events, in turns (a, b, ...,
b, a), beside the two-pass kernels' E + H launches and the whole fused
step, on ``Examples/vacuum3D_tfsf.txt`` at ``--same-size 256`` after 150
steps and on ``Examples/sphere3D_mie.txt`` as it stands (512^3) after 200
(two-pass steps; ``--sizes 256`` for the first alone). Variants:

* ``as_built``: the source as it is (tiles of 10 x 32 owned cells in
  a window of 12 rows, one warp a row and the two halo columns on extra
  lanes, 408 threads, three blocks an SM; z cut at multiples of 32, so
  every owned row is whole aligned 128-byte lines; old fields one plane
  ahead by cp.async; one barrier a plane; programmatic dependent
  launch; no FMA contraction);
* ``tile_30``, ``tile_16``, ``tile_10``, ``tile_8``: windows of 30
  rows (28 owned, 1020 threads) one block an SM, of 16 rows two an SM,
  of 10 and of 8 rows four an SM; ``edge_2``: the edge kernels two an
  SM (more registers, no spills); ``wide_64x6``, ``wide_64x8``,
  ``wide_64x10``: 64 owned columns (256-byte rows) in windows of 6, 8
  or 10 rows, three, two or two blocks an SM
  (``wide_64x6_skip_eh_stores``: its loads alone);
* ``pipe_2``: old-field planes two ahead (as built: one);
* ``two_barriers``: a second barrier between the E and the H phase of a
  plane;
* ``plain_loads``: the rings filled by ordinary loads and stores instead
  of cp.async (the barrier publishes them all the same);
* ``no_overlap``: each section's kernel starts when the one before has
  ended (no programmatic dependent launch);
* ``fmad``: FMA contraction allowed (the halo cells may then differ from
  their owner's bits in another section's kernel);
* ``all_edge``: every item in the general edge kernel (all slab, record
  and point code compiled in everywhere); ``no_axis_split``: the slab
  items in the general edge kernel only (no kernels specialised by
  axis);
* ``bands``: the y and z axes cut band by band like x; ``seg_N``: x
  segments of N planes (as built: 16 where that gives every SM four
  items, else 10);
* ``skip_h``, ``skip_eh``, ``skip_eh_stores``, ``skip_eh_loads``,
  ``skip_all``: timing-only builds without H's, or without both
  families', arithmetic (the march's loads, barriers and stores alone),
  and then also without the field stores or the field loads, or without
  both (barriers and ring traffic alone); their results are wrong by
  design. They patch the source's text (``PATCHES``), so the shipped
  kernel carries no timing-only branch.

Prints one JSON object: the card's name and power limit, per variant
the section kernels' registers, spills and blocks an SM, the worst
difference of its pass from the plain version (0.0: bit for bit), and
per state the ms of the pass's kernels (both turns; one parameter block
launched again and again, so no host-side set-up is timed), with the
two-pass E + H launches and the fused step of the as-built source in
the same turns.
A variant whose build or launch fails is listed under ``failed``. Needs
a CUDA device and nvcc; prints no result without them.

    python3 scripts/fused_variants.py [--only a,b] [--reps N]
        [--sizes 256,512] [--out FILE]
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
OUT_DIR = os.path.join(ROOT, "build", "fused_variants")

# timing-only source patches: (text of the source, its replacement),
# each text found exactly once. SKEL_UPDATE stands in for a family's
# update: the new value is the old one.
SKEL = ("#define SKEL_UPDATE(...) "
        "for (int w_ = 0; w_ < 3; ++w_) out[w_] = old[w_]\n")
PATCHES = {
    "e_math": (("update<true, AX, SRC>(", "SKEL_UPDATE("),),
    "h_math": (("update<false, AX, SRC>(", "SKEL_UPDATE("),),
    "stores": (("if (store) st(fld<T>(p.e.out, c) + cell, out[c]);",
                "(void)store;"),
               ("for (int c = 0; c < 3; ++c) st(fld<T>(p.h.out, c) + cell, "
                "out[c]);", "(void)out;")),
    "loads": (("if (x >= lim || !inside) return;", "return;"),),
    "two_barriers": (("    // phase H(i-1): the new H",
                      "    __syncthreads();\n    // phase H(i-1): the new H"),),
    "plain_loads": (
        ("  const unsigned d = static_cast<unsigned>("
         "__cvta_generic_to_shared(dst));\n"
         "  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4;\\n\" "
         "::\"r\"(d),\n"
         "               \"l\"(src)\n"
         "               : \"memory\");", "  *dst = *src;"),),
}

# name -> (nvcc -D knobs or flags, source patches, plan option)
VARIANTS = {
    "as_built": ((), (), None),
    "tile_30": (("BY=30", "INNER_BLOCKS=1", "EDGE_BLOCKS=1"), (), None),
    "tile_16": (("BY=16", "INNER_BLOCKS=2", "EDGE_BLOCKS=2"), (), None),
    "tile_10": (("BY=10", "INNER_BLOCKS=4", "EDGE_BLOCKS=4"), (), None),
    "tile_8": (("BY=8", "INNER_BLOCKS=4", "EDGE_BLOCKS=4"), (), None),
    "edge_2": (("EDGE_BLOCKS=2",), (), None),
    "wide_64x6": (("BZ=64", "BY=6"), (), None),
    "wide_64x8": (("BZ=64", "BY=8", "INNER_BLOCKS=2", "EDGE_BLOCKS=2"), (),
                  None),
    "wide_64x10": (("BZ=64", "BY=10", "INNER_BLOCKS=2", "EDGE_BLOCKS=2"),
                   (), None),
    "wide_64x6_skip_eh_stores": (("BZ=64", "BY=6"),
                                 ("e_math", "h_math", "stores"), None),
    "pipe_2": (("PIPE=2",), (), None),
    "two_barriers": ((), ("two_barriers",), None),
    "plain_loads": ((), ("plain_loads",), None),
    "no_overlap": (("OVERLAP=0",), (), None),
    "fmad": (("--fmad=true",), (), None),
    "all_edge": ((), (), "all_edge"),
    "no_axis_split": ((), (), "no_axis_split"),
    "bands": ((), (), "bands"),
    "seg_8": ((), (), "seg_8"),
    "seg_24": ((), (), "seg_24"),
    "seg_32": ((), (), "seg_32"),
    "skip_h": ((), ("h_math",), None),
    "skip_eh": ((), ("e_math", "h_math"), None),
    "skip_eh_stores": ((), ("e_math", "h_math", "stores"), None),
    "skip_eh_loads": ((), ("e_math", "h_math", "loads"), None),
    "skip_all": ((), ("e_math", "h_math", "stores", "loads"), None),
}


def patched_source(patches, src):
    """``src`` (the kernel's text) with the named ``PATCHES`` applied."""
    for name in patches:
        for old, new in PATCHES[name]:
            if src.count(old) != 1:
                raise RuntimeError(f"patch {name}: {old!r} is not in the "
                                   "source exactly once")
            src = src.replace(old, new)
    return SKEL + src if patches else src


def build_variants(names):
    """One nvcc per distinct build (knobs and patches), all started
    together; name -> (library or the build error, ptxas lines)."""
    from fdtd3d_torch.ops import build
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(build.CSRC, "fused_eh.cu")) as f:
        source = f.read()
    procs, paths = {}, {}
    for name in names:
        knobs, patches, _ = VARIANTS[name]
        stem = "_".join(("fused",) + tuple(k.strip("-").replace("=", "")
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
        flags = [k for k in knobs if k.startswith("--")]
        base = build.NVCC_FLAGS + tuple(flags) if flags \
            else build.flags("fused_eh")
        cmd = [build.find_nvcc(), *base, "-I", build.CSRC,
               *(f"-D{k}" for k in knobs if not k.startswith("--")),
               "-Xptxas", "-v", "-o", path, cu]
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
    """The planner ``base`` (``pallas_fused.plan_items``) under a
    variant's plan option."""
    import numpy as np
    if option is None:
        return base

    @functools.wraps(base)
    def planned(*args, **kw):
        if option == "bands":
            return base(*args, **dict(kw, bands=True))
        if option.startswith("seg_"):
            return base(*args, **dict(kw, segments=(int(option[4:]),)))
        rows, counts = base(*args, **kw)
        if option == "all_edge":
            return np.ascontiguousarray(rows), (sum(counts), 0, 0, 0, 0, 0)
        # no_axis_split: the slab items in the general edge kernel
        return (np.ascontiguousarray(rows),
                (sum(counts[:4]), 0, 0, 0) + tuple(counts[4:]))
    return planned


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", default="256,512",
                    help="256: the vacuum example at 256^3; 512: the Mie "
                         "example as it stands")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fdtd3d_torch.ops import build, pallas3d, pallas_fused
    from fdtd3d_torch.sim import Simulation
    names = args.only.split(",") if args.only else list(VARIANTS)
    if "as_built" not in names:
        names.insert(0, "as_built")
    built = build_variants(names)
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "ptxas": {},
           "occupancy": {}, "max_abs_err": {}, "ms": {}, "failed": {}}
    failed = out["failed"]
    for name, (lib, lines) in built.items():
        out["ptxas"][name] = lines
        if isinstance(lib, Exception):
            failed[name] = str(lib)
    base = pallas_fused.plan_items

    def use(name, fp):
        build._LIBS["fused_eh"] = built[name][0]
        pallas_fused.plan_items = plan_option(base, VARIANTS[name][2])
        fp.pop("_plan", None)
        fp.pop("_params", None)

    states = {"256": (cs.EXAMPLE, ["--same-size", "256"], 150),
              "512": (cs.MIE, [], 200)}
    for size in args.sizes.split(","):
        path, extra, steps = states[size]
        with cs.ladder_env("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"):
            sim = Simulation(cs.config(path, extra), device=dev)
            sim.advance(steps)
        static, coeffs, st = sim.static, sim.coeffs, sim.state
        fargs = cs.fused_args(static, coeffs, st)
        fp = fargs[5]
        want = cs.as_tree(pallas_fused.fused_eh_plain(*fargs), cs.FUSED_OUTS)
        for name in names:
            if name in failed:
                continue
            use(name, fp)
            try:
                if name not in out["occupancy"]:
                    out["occupancy"][name] = pallas_fused.occupancy()
                got = cs.as_tree(pallas_fused.fused_eh(*fargs),
                                 cs.FUSED_OUTS)
                torch.cuda.synchronize()
                out["max_abs_err"].setdefault(size, {})[name] = max(
                    float((got[g][k] - want[g][k]).abs().max())
                    for g in want for k in want[g])
                del got
            except RuntimeError as exc:     # a refused launch: recorded
                failed[name] = f"{size}: {exc}"
        del want
        e_args, h_args = cs.family_args(static, coeffs, st)
        step = pallas_fused.make_fused_eh_step(static, dev)
        reps = args.reps if size == "256" else max(2, args.reps // 4)
        order = [n for n in names if n not in failed]
        ms = out["ms"].setdefault(size, {"two_pass_e_plus_h": [],
                                         "fused_step": []})
        for name in order + order[::-1]:
            use(name, fp)
            # the kernels alone: one parameter block with its outputs,
            # launched again and again (no host-side set-up per call)
            prm, outs = pallas_fused.fused_params(*fargs)
            ms.setdefault(name, []).append(cs.timed(
                lambda: pallas3d.launch(built[name][0], "fdtd_fused_pass",
                                        prm, dev), reps))
            del prm, outs
            if name == "as_built":
                ms["two_pass_e_plus_h"].append(cs.timed(lambda: (
                    pallas3d.e_family(*e_args),
                    pallas3d.h_family(*h_args)), reps))
                ms["fused_step"].append(cs.timed(lambda: step(st, fp), reps))
        pallas_fused.plan_items = base
        print(f"fused_variants {size}: {json.dumps(ms)}", file=sys.stderr,
              flush=True)
        del sim, st, fargs, fp, step
        torch.cuda.empty_cache()
    build._LIBS.pop("fused_eh", None)
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
