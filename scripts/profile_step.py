#!/usr/bin/env python3
"""Device-time breakdown of the port's f32 step on one GPU (the step
``Simulation`` dispatches: the temporal-blocked pass, two steps a call).

Runs ``Examples/vacuum3D_tfsf.txt`` at ``--same-size 256`` (the main
path's cell in PERF.md) through ``fdtd3d_torch.Simulation`` on the
card, warms up 20 steps, then traces 50 steps with ``torch.profiler``
and prints one JSON object:
the window's wall time, the summed device time of every kernel, the
device busy share (device time over wall), and the kernels by device
time. Needs a CUDA device; prints no result without one.

    python3 scripts/profile_step.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
SIZE, STEPS = 256, 50


def _device_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(ev, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from fdtd3d_torch import cli
    from fdtd3d_torch.sim import Simulation

    parser = cli.build_parser()
    cfg = cli.args_to_config(parser.parse_args(
        cli.read_cmd_file(EXAMPLE) + ["--same-size", str(SIZE)]))
    sim = Simulation(cfg, device="cuda")
    sim.advance(20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.advance(STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        us = _device_us(ev)
        if us > 0:
            rows.append({"name": ev.key[:80], "count": ev.count,
                         "device_us": us})
    rows.sort(key=lambda r: -r["device_us"])
    # kernels only: device-side rows whose names are not aten ops (the
    # aten rows carry their kernels' time too, as self time of 0 or a
    # duplicate, so count kernel rows once)
    kernel_rows = [r for r in rows if not r["name"].startswith("aten::")]
    device_us = sum(r["device_us"] for r in kernel_rows)
    out = {"size": SIZE, "steps": STEPS,
           "device": torch.cuda.get_device_name(0),
           "step_kind": sim.step_kind,
           "wall_us_per_step": wall_us / STEPS,
           "device_us_per_step": device_us / STEPS,
           "device_busy_share": device_us / wall_us,
           "kernels": kernel_rows[:20]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
