#!/usr/bin/env python3
"""Where the temporal-blocked kernel's time goes, on one GPU.

Builds variants of ``fdtd3d_torch/csrc/packed_tb.cu`` by textual
substitution (each with a per-block ``%globaltimer`` start/end and
``%smid`` record added at the kernel's ends), and times one pass of
each at 256^3 with CUDA events, in turns (a, b, ..., b, a), on two
carries: ``Examples/vacuum3D_tfsf.txt`` after 150 steps (CPML on every
axis, TFSF records) and the same grid without CPML and TFSF. Variants:

* ``as_built``: the source as it is;
* ``one_segment``: one x segment per (y, z) tile (a block marches the
  whole x axis: 220 blocks at 256^3);
* ``no_fast_path``: every cell takes the full path (CPML and records
  code in every cell);
* ``no_records``: the record terms compiled out (wrong fields; timing
  only);
* ``no_cpml``: the CPML compiled out (wrong fields; timing only).

Prints one JSON object: ms per pass per variant and carry (both turns),
and per-block milliseconds (min, deciles, max) and the makespan of one
pass. Needs a CUDA device and nvcc; prints no result without them.

    python3 scripts/tb_variants.py [--out FILE]
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
SRC = os.path.join(ROOT, "fdtd3d_torch", "csrc", "packed_tb.cu")
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
OUT_DIR = os.path.join(ROOT, "build", "tb_variants")
MAX_BLOCKS = 8192

# the per-block timer: start at the kernel's entry, end after its loop
TIMER = [
    ("__global__ void __launch_bounds__(NT, 1) tb_pass(const Params p) {",
     "__device__ unsigned long long g_blocks[3 * %d];\n"
     "__global__ void __launch_bounds__(NT, 1) tb_pass(const Params p) {\n"
     "  unsigned long long t_start;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t_start));"
     % MAX_BLOCKS),
    ("    for (int c = 0; c < 3; ++c) j_old[c] = j_new[c];\n  }\n}",
     "    for (int c = 0; c < 3; ++c) j_old[c] = j_new[c];\n  }\n"
     "  __syncthreads();\n"
     "  if (tid == 0) {\n"
     "    unsigned long long t_end;\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_end));\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x;\n"
     "    g_blocks[3 * b] = t_start;\n"
     "    g_blocks[3 * b + 1] = t_end;\n"
     "    g_blocks[3 * b + 2] = smid;\n"
     "  }\n}"),
    ('extern "C" {',
     'extern "C" {\n'
     'int fdtd_tb_blocks(unsigned long long* out, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, g_blocks,\n'
     '                                   n * sizeof(unsigned long long));\n'
     '}\n'),
]

VARIANTS = {
    "as_built": [],
    "one_segment": [("  return n > 1 ? n : 1;\n", "  return 1;\n")],
    "no_fast_path": [("<0, false>", "<0, true>"), ("<1, false>", "<1, true>")],
    "no_records": [("if (FULL) acc = add_records(",
                    "if (false) acc = add_records(")],
    "no_cpml": [("if (FULL && m > 0) {", "if (false) {")],
}


def build_variants():
    from fdtd3d_torch.ops import build
    os.makedirs(OUT_DIR, exist_ok=True)
    base = open(SRC).read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in TIMER + subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old[:50]!r} not in the source")
            src = src.replace(old, new)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [build.find_nvcc(), *build.flags("packed_tb"), "-o",
               os.path.join(OUT_DIR, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")


def carry_for(extra, dev):
    """A pass's operands on the main path's grid after 150 steps."""
    from fdtd3d_torch import cli
    from fdtd3d_torch.ops import packed_tb
    from fdtd3d_torch.sim import Simulation
    parser = cli.build_parser()
    cfg = cli.args_to_config(parser.parse_args(
        cli.read_cmd_file(EXAMPLE) + ["--same-size", "256"] + extra))
    sim = Simulation(cfg, device=dev)
    sim.advance(150)
    step = packed_tb.make_packed_tb_step(sim.static, dev)
    cc = step.prepare(sim.coeffs)
    carry = sim._carry
    spare = packed_tb._alloc_like(carry)
    _, terms, drive = packed_tb.generation_terms(
        sim.static, cc["tb"], carry.get("inc"), carry["t"])
    return lambda: packed_tb.tb_pass(carry, spare, cc["tb"], terms, drive)


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


def block_times(lib, launch):
    """Per-block milliseconds of one launch, and its makespan."""
    import numpy as np
    import torch
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * MAX_BLOCKS))()
    lib.fdtd_tb_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.fdtd_tb_blocks(ctypes.addressof(buf), 3 * MAX_BLOCKS) != 0:
        raise RuntimeError("reading the block timers failed")
    a = np.array(buf, dtype=np.float64).reshape(MAX_BLOCKS, 3)
    a = a[a[:, 1] > 0]
    dur = (a[:, 1] - a[:, 0]) / 1e6
    return {"blocks": int(len(a)),
            "block_ms_deciles": np.percentile(
                dur, np.arange(0, 101, 10)).tolist(),
            "makespan_ms": float((a[:, 1].max() - a[:, 0].min()) / 1e6)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tb_variants: no CUDA device", file=sys.stderr)
        return 1
    from fdtd3d_torch.ops import build
    build_variants()
    dev = torch.device("cuda", 0)
    libs = {n: ctypes.CDLL(os.path.join(OUT_DIR, f"{n}.so"))
            for n in VARIANTS}
    names = list(VARIANTS)
    out = {"device": torch.cuda.get_device_name(0), "ms": {}, "blocks": {}}
    for label, extra in (("tfsf_cpml", []),
                         ("vacuum", ["--no-use-pml", "--no-use-tfsf"])):
        launch = carry_for(extra, dev)
        for name in names + names[::-1]:
            build._LIBS["packed_tb"] = libs[name]
            out["ms"].setdefault(label, {}).setdefault(name, []).append(
                timed(launch, 20))
        for name in names:
            build._LIBS["packed_tb"] = libs[name]
            out["blocks"].setdefault(label, {})[name] = block_times(
                libs[name], launch)
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
