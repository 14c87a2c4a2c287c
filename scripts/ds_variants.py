#!/usr/bin/env python3
"""Each design choice of the float32x2 pass against its alternative, on
one GPU, in one call.

Builds variants of ``fdtd3d_torch/csrc/packed_ds.cu`` with nvcc ``-D``
build knobs, source patches (the timing-only builds, written under
``build/ds_variants``) and plan options of
``ops/packed_ds.py::plan_items``, holds
each variant's CUDA step (line kernel + pass) against the plain step on
the precision example's state, and times the pass and the whole step of
each, by CUDA events, in turns (a, b, ..., b, a), on
``Examples/precision3D_float32x2.txt`` at ``--same-size 256`` after 100
steps and as it stands (128^3) after 20 (``--sizes``: other sizes,
after 100 steps above 128). Variants:

* ``as_built``: the source as it is;
* ``fma_prod``: two_prod by one FMA (``__fmaf_rn(a, b, -p)``) instead of
  Dekker's split; its EFT probe on the extended inputs of
  ``chip_smoke.eft_extended_inputs`` is compared with the as-built
  probe, bit for bit;
* ``tile_16x32``, ``tile_16x32_one_block``, ``tile_8x32``,
  ``tile_8x64``, ``tile_16x64``: blocks of 16 x 32 threads (14 x 30
  owned), two an SM at most 64 registers or one an SM with more, of 8 x
  32 (6 x 30), four an SM, of 8 x 64 (6 x 62), two an SM, of 16 x 64 (14
  x 62), one an SM (as built: 32 x 32, 30 x 30 owned, one an SM);
  ``tile_8x64_skip_eh`` its skeleton (below);
* ``pipe_2``: old-field planes in flight 2 (as built: 1), in 16 x 32
  blocks one an SM (a 32 x 32 block's rings would not fit);
* ``no_overlap``: the inner kernel starts when the edge kernel has ended
  (no programmatic dependent launch);
* ``all_edge``: every item in the edge kernel (the slab path compiled in
  everywhere);
* ``align_8``: the tiles cut at multiples of 8 cells along z (24 wide,
  rows of owned cells on whole 32-byte sectors; as built: up to 30 wide
  anywhere);
* ``seg_N``: x segments of N planes (as built: 16 where that gives every
  SM four items, else 10);
* ``bands``, ``bands_seg_8``: each axis cut band by band, the CPML bands
  and the interior apart (narrow band tiles; as built: each axis cut
  whole into near-equal pieces), with the plan's segments or with 8
  planes (``bands_seg_8``: the pass's first plan); ``first_design``: that plan
  with 16 x 32 blocks, two an SM;
* ``skip_h``, ``skip_eh``, ``skip_eh_stores``, ``skip_eh_loads``:
  timing-only builds without H's, or without both families', arithmetic
  (the march's loads, barriers and stores alone), and then also without
  the field stores or without the field loads, or without both
  (``skip_all``: barriers and ring traffic alone); their results are
  wrong by design. They patch the source's text (``PATCHES``), so the
  shipped kernel carries no timing-only branch.

Prints one JSON object: the card, per variant the kernels' registers,
spills and blocks an SM, the worst difference of its step from the
plain step (0.0: bit for bit), and per state the ms of the pass and of
the step (both turns); the FMA probe's verdict. A variant whose build or
launch fails is listed under ``failed``. Needs a CUDA device and nvcc;
prints no result without them.

    python3 scripts/ds_variants.py [--only a,b] [--reps N] [--sizes 256,128]
        [--out FILE]
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
OUT_DIR = os.path.join(ROOT, "build", "ds_variants")

# timing-only source patches: (text of the source, its replacement),
# each text found exactly once. SKEL_UPDATE stands in for a family's
# update: the new value is the old one.
SKEL = ("#define SKEL_UPDATE(...) "
        "for (int w_ = 0; w_ < 6; ++w_) out[w_] = old[w_]\n")
PATCHES = {
    "e_math": (("update<true, AX, GRID>(", "SKEL_UPDATE("),),
    "h_math": (("update<false, AX, GRID>(", "SKEL_UPDATE("),),
    "stores": (("if (store) p.E2[w * vol + c_at] = out[w];", "(void)store;"),
               ("for (int w = 0; w < 6; ++w) p.H2[w * vol + c_at] = out[w];",
                "(void)out;")),
    "loads": (("if (x >= lim || !inside) return;", "return;"),),
}

# name -> (nvcc -D knobs, source patches, plan option)
VARIANTS = {
    "as_built": ((), (), None),
    "fma_prod": (("FMA_PROD=1",), (), None),
    "tile_16x32": (("BY=16", "INNER_BLOCKS=2", "EDGE_BLOCKS=2"), (), None),
    "tile_16x32_one_block": (("BY=16",), (), None),
    "tile_8x32": (("BY=8", "INNER_BLOCKS=4", "EDGE_BLOCKS=4"), (), None),
    "tile_8x64": (("BZ=64", "BY=8", "INNER_BLOCKS=2", "EDGE_BLOCKS=2"), (),
                  None),
    "tile_16x64": (("BZ=64", "BY=16"), (), None),
    "tile_8x64_skip_eh": (("BZ=64", "BY=8", "INNER_BLOCKS=2",
                           "EDGE_BLOCKS=2"), ("e_math", "h_math"), None),
    "pipe_2": (("PIPE=2", "BY=16"), (), None),
    "no_overlap": (("OVERLAP=0",), (), None),
    "all_edge": ((), (), "all_edge"),
    "align_8": ((), (), "align_8"),
    "skip_h": ((), ("h_math",), None),
    "skip_eh": ((), ("e_math", "h_math"), None),
    "skip_eh_stores": ((), ("e_math", "h_math", "stores"), None),
    "skip_eh_loads": ((), ("e_math", "h_math", "loads"), None),
    "skip_all": ((), ("e_math", "h_math", "stores", "loads"), None),
    "seg_6": ((), (), "seg_6"),
    "seg_8": ((), (), "seg_8"),
    "seg_12": ((), (), "seg_12"),
    "seg_16": ((), (), "seg_16"),
    "bands": ((), (), "bands"),
    "bands_seg_8": ((), (), "bands_seg_8"),
    "first_design": (("BY=16", "INNER_BLOCKS=2", "EDGE_BLOCKS=2"), (),
                     "bands_seg_8"),
}


def patched_source(patches, src):
    """``src`` (the kernel's text) with the named ``PATCHES`` applied."""
    if not patches:
        return src
    for name in patches:
        for old, new in PATCHES[name]:
            if src.count(old) != 1:
                raise RuntimeError(f"patch {name}: {old!r} is not in the "
                                   "source exactly once")
            src = src.replace(old, new)
    return SKEL + src


def build_variants(names):
    """One nvcc per distinct build (knobs and patches), all started
    together; name -> library (or the build error)."""
    from fdtd3d_torch.ops import build
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(build.CSRC, "packed_ds.cu")) as f:
        source = f.read()
    procs, paths, libs = {}, {}, {}
    for name in names:
        knobs, patches, _ = VARIANTS[name]
        stem = "_".join(("ds",) + knobs + patches)
        paths[name] = path = os.path.join(OUT_DIR, stem + ".so")
        if path in procs:
            continue
        cu = os.path.join(OUT_DIR, stem + ".cu")
        with open(cu, "w") as f:
            f.write(patched_source(patches, source))
        cmd = [build.find_nvcc(), *build.flags("packed_ds"), "-I",
               build.CSRC, *(f"-D{d}" for d in knobs), "-Xptxas", "-v",
               "-o", path, cu]
        procs[path] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    done = {}
    for path, proc in procs.items():
        _, err = proc.communicate()
        done[path] = ctypes.CDLL(path) if proc.returncode == 0 \
            else RuntimeError(f"nvcc failed:\n{err[-2000:]}")
    for name in names:
        libs[name] = done[paths[name]]
    return libs


def plan_option(base, option):
    """The planner ``base`` (``packed_ds.plan_items``) under a variant's
    plan option."""
    import numpy as np
    if option is None:
        return base

    @functools.wraps(base)
    def planned(*args, **kw):
        if option == "align_8":
            return base(*args, **dict(kw, zalign=8))
        if option.startswith("bands"):
            kw = dict(kw, bands=True)
        if "seg_" in option:
            seg = int(option.rsplit("_", 1)[1])
            kw = dict(kw, segments=(seg,))
        if option == "all_edge":
            rows, counts = base(*args, **kw)
            return np.ascontiguousarray(rows), (sum(counts), 0)
        return base(*args, **kw)
    return planned


def state_for(extra, dev, steps):
    """The precision example with ``extra`` flags after ``steps`` CUDA
    steps: (simulation, kernel step, plain step, prepared operands)."""
    import chip_smoke as cs
    from fdtd3d_torch.ops import packed_ds
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cs.config(cs.PRECISION, extra), device=dev)
    sim.advance(steps)
    k_step = packed_ds.make_packed_ds_step(sim.static, dev)
    p_step = packed_ds.make_packed_ds_step(sim.static, dev, plain=True)
    return sim, k_step, p_step, k_step.prepare(sim.coeffs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", default="256,128",
                    help="comma-separated grid sizes of the example")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ds_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fdtd3d_torch.ops import build, packed, packed_ds
    names = args.only.split(",") if args.only else list(VARIANTS)
    if "as_built" not in names:
        names.insert(0, "as_built")
    libs = build_variants(names)
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "occupancy": {},
           "max_abs_err": {}, "ms": {}, "failed": {}}
    failed = out["failed"]
    for name in names:
        if isinstance(libs[name], Exception):
            failed[name] = str(libs[name])
    base = packed_ds.plan_items

    def use(name, cc):
        build._LIBS["packed_ds"] = libs[name]
        packed_ds.plan_items = plan_option(base, VARIANTS[name][2])
        cc.pop("_params", None)
        cc.pop("_plan", None)

    # the FMA product against Dekker's on the extended probe inputs
    a, b = cs.eft_extended_inputs(dev)
    probes = {}
    for name in ("as_built", "fma_prod"):
        if name in names and name not in failed:
            build._LIBS["packed_ds"] = libs[name]
            probes[name] = packed_ds.eft_probe(a, b)
    if len(probes) == 2:
        diff = [int(((x.view(torch.int32) != y.view(torch.int32))
                     & ~(torch.isnan(x) & torch.isnan(y))).sum())
                for x, y in zip(probes["as_built"], probes["fma_prod"])]
        out["fma_probe_pairs"] = a.numel()
        out["fma_probe_differing"] = dict(zip(("s", "e", "p", "pe"), diff))
        out["fma_bit_identical"] = not any(diff)
    for size in args.sizes.split(","):
        label, steps = size, 100 if int(size) > 128 else 20
        extra = ["--same-size", size]
        sim, k_step, p_step, cc = state_for(extra, dev, steps)
        carry = sim._carry
        for name in names:
            if name in failed:
                continue
            use(name, cc)
            try:
                if name not in out["occupancy"]:
                    build._LIBS["packed_ds"] = libs[name]
                    out["occupancy"][name] = packed_ds.occupancy()
                got = k_step(cs.clone_carry(carry), cc)
                want = p_step(cs.clone_carry(carry), cc)
                torch.cuda.synchronize()
                err = max(float((x - y).abs().max()) for x, y in zip(
                    packed.carry_buffers(got), packed.carry_buffers(want)))
                out["max_abs_err"].setdefault(label, {})[name] = err
            except RuntimeError as exc:     # a refused launch: recorded
                failed[name] = f"{label}: {exc}"
        line_dst = {k: torch.empty_like(v) for k, v in carry["inc"].items()}
        spare = packed.alloc_like(carry)
        order = [n for n in names if n not in failed]
        for name in order + order[::-1]:
            use(name, cc)
            packed_ds.line_advance(carry["inc"], line_dst, cc, (0.0, 0.0))
            t_pass = cs.timed(lambda: packed_ds.ds_pass(
                carry, spare, cc, carry["inc"], line_dst, None), args.reps)
            t_step = cs.timed(lambda: k_step(carry, cc), args.reps)
            ms = out["ms"].setdefault(label, {}).setdefault(
                name, {"pass": [], "step": []})
            ms["pass"].append(t_pass)
            ms["step"].append(t_step)
        packed_ds.plan_items = base
        del sim, k_step, p_step, cc, carry, spare, line_dst
        torch.cuda.empty_cache()
    build._LIBS.pop("packed_ds", None)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
