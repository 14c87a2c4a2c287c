#!/usr/bin/env python3
"""Where the temporal-blocked pass's time goes, on one GPU.

Builds variants of ``fdtd3d_torch/csrc/packed_tb.cu`` with nvcc ``-D``
build knobs (every variant also with ``-DTB_BLOCK_TIMER``, which records
each block's ``%globaltimer`` start and end and its SM), and times one
pass of each, by CUDA events, in turns (a, b, ..., b, a), on
``Examples/vacuum3D_tfsf.txt`` at ``--same-size 256`` after 150 steps
(CPML on every axis, TFSF records; the f32 main path's state) and on
the same grid without CPML and TFSF; with ``--mie`` also on one lane of
``Examples/sphere3D_mie.txt`` at 512^3 after 20 steps (coefficient
grids). Variants (the build knobs of the source's header):

* ``as_built``: the source as it is;
* ``inner_1_block``: the inner kernel built for one block an SM;
* ``edge_2_blocks``: the general edge kernel built for two blocks an SM
  (at most 64 registers);
* ``single_2_blocks``: the single-axis edge kernels built for two
  blocks an SM (at most 64 registers; as built: one);
* ``pipe_1``, ``pipe_3``: generation-0 planes in flight 1 and 3 (as
  built: 2);
* ``no_overlap``: each section's kernel starts when the one before it
  has ended (no programmatic dependent launch);
* ``tile_32x32``: 32 x 32-thread blocks (28 x 28 owned, 1.31 columns
  computed a column owned, against 1.52), one block an SM;
* ``tile_8x32``: 8 x 32-thread blocks (4 x 28 owned), four inner blocks
  an SM;
* ``grid_order``: the plan's items in x, y, z order (not heaviest
  first);
* ``all_edge``: every item in the edge kernel (no inner kernel);
* ``no_zband``: z-band items in the block's own layout (not the
  transposed one);
* ``unaligned``: the interior tiles as wide as the others (28 cells,
  rows of owned cells on no particular sector boundary) instead of 24
  cells at multiples of 8;
* ``no_box``: the items of a call with coefficient grids all read them
  (no material box);
* ``one_edge``: every SLAB item in the general edge kernel (no kernel
  of one slab axis);
* ``seg_N``: x segments of N planes (as built: 48 where the grid gives
  every SM four items);
* ``param_copy``: a source patch (PATCHES, written under
  ``build/tb_variants``), the kernel parameter block without
  ``__grid_constant__`` (the compiler may copy the arrays a build
  indexes with per-thread values into local memory).

With ``--sharded`` the carries are shards of a decomposed run instead:
shard 0 and shard 3 of ``vacuum3D_tfsf.txt`` at 256^3 on (2,2,1), four
shards on the card, after 150 steps (their ghosts exchanged), each
shard's pass (``packed_tb.tb_pass_sharded``) timed and its blocks
timed as above, beside the unsharded pass of the same grid.

Prints one JSON object: the card, per variant the kernels' registers,
spills and blocks an SM, and per carry ms per pass (both turns; and
``host_ms``, the host's time to issue one), each
plan section's makespan and per-class block milliseconds (deciles) of
one pass; a variant whose launch the card refuses is listed under
``failed`` with the error. Needs a CUDA device and nvcc; prints no result
without them.

    python3 scripts/tb_variants.py [--mie] [--only a,b]
        [--source NAME=PATH ...] [--sharded] [--out FILE]
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
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
MIE = os.path.join(ROOT, "Examples", "sphere3D_mie.txt")
OUT_DIR = os.path.join(ROOT, "build", "tb_variants")
TIMER_BLOCKS = 65536  # mirrors csrc/packed_tb.cu

# name -> (nvcc -D knobs, plan option)
VARIANTS = {
    "as_built": ((), None),
    "inner_1_block": (("INNER_BLOCKS=1",), None),
    "edge_2_blocks": (("EDGE_BLOCKS=2",), None),
    "single_2_blocks": (("SINGLE_BLOCKS=2",), None),
    "pipe_1": (("PIPE=1",), None),
    "no_overlap": (("OVERLAP=0",), None),
    "pipe_3": (("PIPE=3",), None),
    "tile_32x32": (("BY=32", "INNER_BLOCKS=1"), None),
    "tile_8x32": (("BY=8", "INNER_BLOCKS=4", "EDGE_BLOCKS=2"), None),
    "grid_order": ((), "grid_order"),
    "all_edge": ((), "all_edge"),
    "no_zband": ((), "no_zband"),
    "unaligned": ((), "unaligned"),
    "no_box": ((), "no_box"),
    "one_edge": ((), "one_edge"),
    "seg_16": ((), "seg_16"),
    "seg_24": ((), "seg_24"),
    "seg_32": ((), "seg_32"),
    "seg_48": ((), "seg_48"),
    "seg_64": ((), "seg_64"),
    "param_copy": ((), None),
}

# variant -> (text of csrc/packed_tb.cu, its replacement): timing-only
# builds written under OUT_DIR
PATCHES = {
    "param_copy": ("tb_section(const __grid_constant__ Params p",
                   "tb_section(const Params p"),
}


def build_variants(names, sources):
    """One nvcc per variant, all started together; name -> library.
    ``sources``: variant name -> another source file (built as it is)."""
    from fdtd3d_torch.ops import build
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = sources.get(name, os.path.join(build.CSRC, "packed_tb.cu"))
        if name in PATCHES and name not in sources:
            with open(src) as f:
                text = f.read()
            old, new = PATCHES[name]
            if old not in text:
                raise RuntimeError(f"{name}: the source lacks {old!r}")
            src = os.path.join(OUT_DIR, f"{name}.cu")
            with open(src, "w") as f:
                f.write(text.replace(old, new))
        knobs = VARIANTS[name][0] if name in VARIANTS else ()
        defs = ["-DTB_BLOCK_TIMER"] + [f"-D{d}" for d in knobs]
        cmd = [build.find_nvcc(), *build.flags("packed_tb"), "-I",
               build.CSRC, *defs, "-Xptxas", "-v", "-o",
               os.path.join(OUT_DIR, f"{name}.so"), src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
    return {n: ctypes.CDLL(os.path.join(OUT_DIR, f"{n}.so")) for n in names}


def plan_option(base, option):
    """The planner ``base`` (``packed_tb.plan_items``) under a variant's
    plan option."""
    import numpy as np
    from fdtd3d_torch.ops import packed_tb
    if option is None:
        return base

    @functools.wraps(base)
    def planned(*args, **kw):
        if option == "no_zband":
            return base(*args, **dict(kw, zband=False))
        if option == "unaligned":
            return base(*args, **dict(kw, zalign=1))
        if option == "no_box" and kw.get("grids") not in (None, "all"):
            return base(*args, **dict(kw, grids="all"))
        if option.startswith("seg_"):
            return base(*args, **dict(kw, segments=(int(option[4:]),)))
        rows, counts = base(*args, **kw)
        bounds = np.cumsum((0,) + tuple(counts))
        secs = [rows[bounds[q]:bounds[q + 1]] for q in range(len(counts))]
        if option == "grid_order":
            secs = [sec[np.lexsort((sec[:, 1], sec[:, 0], sec[:, 4]))]
                    for sec in secs]
            return np.concatenate(secs), counts
        names = packed_tb.SECTIONS
        if option == "one_edge":   # no single-axis edge kernel
            edge = [names.index(n) for n in ("edge_x", "edge_y", "edge_z",
                                             "edge")]
            new = list(counts)
            for q in edge:
                new[q] = 0
            new[names.index("edge")] = sum(counts[q] for q in edge)
            order = [secs[q] for q in range(len(names))]
            return np.concatenate(order), tuple(new)
        if option != "all_edge":
            return rows, counts
        # all_edge: every item in the general edge kernel's sections
        grid = [q for q, n in enumerate(names) if n.endswith("_grid")]
        rest = [q for q in range(len(names)) if q not in grid]
        new = [0] * len(names)
        new[names.index("edge_grid")] = sum(counts[q] for q in grid)
        new[names.index("edge")] = sum(counts[q] for q in rest)
        order = [secs[q] for q in grid] + [secs[q] for q in rest]
        return np.concatenate(order), tuple(new)
    return planned


def carry_for(path, extra, dev, steps):
    """A pass's launch on the grid of the command file ``path`` (with the
    flags ``extra``) after ``steps``."""
    from fdtd3d_torch import cli
    from fdtd3d_torch.ops import packed, packed_tb
    from fdtd3d_torch.sim import Simulation
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        cli.read_cmd_file(path) + list(extra)))
    sim = Simulation(cfg, device=dev)
    sim.advance(steps)
    step = packed_tb.make_packed_tb_step(sim.static, dev)
    cc = step.prepare(sim.coeffs)
    carry = sim._carry
    spare = packed.alloc_like(carry)
    _, terms, drive = packed_tb.generation_terms(
        sim.static, cc["tb"], carry.get("inc"), carry["t"])

    def launch():
        packed_tb.tb_pass(carry, spare, cc["tb"], terms, drive)
    launch.tb = cc["tb"]
    return launch


def shard_carries(path, extra, dev, steps, topo, ranks):
    """Each of shards ``ranks``' pass launch (``tb_pass_sharded``) of a
    decomposed run on ``topo`` (every shard on ``dev``) after
    ``steps``, its ghosts exchanged: [(rank, launch)]."""
    from fdtd3d_torch import cli
    from fdtd3d_torch.ops import packed, packed_tb
    from fdtd3d_torch.sim import Simulation
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        cli.read_cmd_file(path) + list(extra)
        + ["--manual-topology", "x".join(map(str, topo))]))
    n = topo[0] * topo[1] * topo[2]
    sim = Simulation(cfg, devices=[dev] * n)
    sim.advance(steps)
    step = packed_tb.make_sharded_packed_tb_step(sim.static, sim.mesh)
    cc = step.prepare(sim.coeffs)
    shards = sim._carry["shards"]
    gh = step.exchange(shards)
    out = []
    for rs in packed.device_groups(sim.mesh).values():
        _, terms, drives = packed_tb.generation_terms_many(
            sim.static, [cc[r]["tb"] for r in rs], shards[rs[0]].get("inc"),
            sim._carry["t"])
        for r, t, d in zip(rs, terms, drives):
            if r not in ranks:
                continue
            spare = packed.alloc_like(shards[r])

            def launch(r=r, t=t, d=d, spare=spare):
                packed_tb.tb_pass_sharded(shards[r], spare, cc[r]["tb"], t,
                                          d, gh[r])
            launch.tb = cc[r]["tb"]
            out.append((r, launch))
    return out


def timed(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn, reps):
    """The host's time to issue one call (the launches queue; the card is
    synchronised before and after, outside the clock)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def block_times(lib, launch):
    """Each kernel's makespan and per-class block ms of one launch."""
    import numpy as np
    import torch
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * TIMER_BLOCKS))()
    lib.fdtd_tb_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.fdtd_tb_blocks(ctypes.addressof(buf), 3 * TIMER_BLOCKS) != 0:
        raise RuntimeError("reading the block timers failed")
    a = np.array(buf, dtype=np.float64).reshape(TIMER_BLOCKS, 3)
    plan, counts = launch.tb["_plan"][1]
    rows = plan.cpu().numpy()
    n = min(len(rows), TIMER_BLOCKS)
    a, rows = a[:n], rows[:n]
    out = {"blocks": int(n), "items": list(counts)}
    first = 0
    from fdtd3d_torch.ops import packed_tb
    for sec, count in zip(packed_tb.SECTIONS, counts):
        t = a[first:min(first + count, n)]
        if len(t):
            out[f"{sec}_makespan_ms"] = float(
                (t[:, 1].max() - t[:, 0].min()) / 1e6)
        first += count
    start = a[:, 0].min()
    out["pass_makespan_ms"] = float((a[:, 1].max() - start) / 1e6)
    dur = (a[:, 1] - a[:, 0]) / 1e6
    planes = rows[:, 5] - rows[:, 4]
    for cls, label in enumerate(("plain", "source", "slab")):
        sel = rows[:, 6] == cls
        if sel.any():
            out[f"{label}_block_ms_deciles"] = np.percentile(
                dur[sel], np.arange(0, 101, 10)).tolist()
            out[f"{label}_us_per_plane_median"] = float(np.median(
                dur[sel] * 1e3 / (planes[sel] + 3)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mie", action="store_true",
                    help="also time one Mie lane at 512^3")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="also time the source file PATH (the same "
                         "parameter block) as variant NAME")
    ap.add_argument("--sharded", action="store_true",
                    help="time shards 0 and 3 of a (2,2,1) run at 256^3 "
                         "beside the unsharded pass")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tb_variants: no CUDA device", file=sys.stderr)
        return 1
    from fdtd3d_torch.ops import build, packed_tb
    names = args.only.split(",") if args.only else list(VARIANTS)
    sources = dict(s.split("=", 1) for s in args.source)
    names += [n for n in sources if n not in names]
    libs = build_variants(names, sources)
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "occupancy": {},
           "ms": {}, "host_ms": {}, "blocks": {}}
    for name in names:
        build._LIBS["packed_tb"] = libs[name]
        out["occupancy"][name] = packed_tb.occupancy()
    carries = [("tfsf_cpml", EXAMPLE, ["--same-size", "256"], 150)]
    if not args.sharded:
        carries.append(("vacuum", EXAMPLE, ["--same-size", "256",
                                            "--no-use-pml",
                                            "--no-use-tfsf"], 150))
    if args.mie:
        carries.append(("mie512", MIE, [], 20))
    base = packed_tb.plan_items

    def use(name, tb):
        build._LIBS["packed_tb"] = libs[name]
        packed_tb.plan_items = plan_option(
            base, VARIANTS[name][1] if name in VARIANTS else None)
        tb.pop("_plan", None)
        tb.pop("_sharded_params", None)

    def launches():
        for label, path, extra, steps in carries:
            yield label, carry_for(path, extra, dev, steps)
        if args.sharded:
            for r, launch in shard_carries(
                    EXAMPLE, ["--same-size", "256"], dev, 150, (2, 2, 1),
                    (0, 3)):
                yield f"shard221_{r}", launch

    failed = out["failed"] = {}
    for label, launch in launches():
        for name in names + names[::-1]:
            if name in failed:
                continue
            use(name, launch.tb)
            try:
                ms = timed(launch, 20)
            except RuntimeError as exc:   # a refused launch: recorded
                failed[name] = f"{label}: {exc}"
                continue
            out["ms"].setdefault(label, {}).setdefault(name, []).append(ms)
            out["host_ms"].setdefault(label, {}).setdefault(
                name, []).append(host_ms(launch, 20))
        for name in names:
            if name not in failed:
                use(name, launch.tb)
                out["blocks"].setdefault(label, {})[name] = block_times(
                    libs[name], launch)
        packed_tb.plan_items = base
        del launch
        torch.cuda.empty_cache()
    build._LIBS.pop("packed_tb", None)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
