#!/usr/bin/env python3
"""End-to-end proof on one NVIDIA H100 that the PyTorch port runs.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one GPU,
no arguments; ``--out FILE`` also writes the measurements as JSON).
It imports the port (``fdtd3d_torch``) and torch only, never JAX or the
reference package, and exits non-zero on the first failure:

1. builds every CUDA kernel of the main path from ``fdtd3d_torch/csrc``
   and holds each kernel against its plain PyTorch version on the card:
   one launch of each at 256^3 (BASELINE config #3's width, xyz CPML +
   TFSF, seeded fields), then 10 whole packed steps of kernels against
   10 of plain versions, and the same 10 steps at 128^3 with a
   dielectric sphere (coefficient grids) and a Drude sphere (J), and at
   96^3 with an oblique plane wave, a point source and no CPML on x; the
   gate is the reference's, max |diff| / max |plain| < 2e-6 in f32 on
   E, H, psi, J and the incident line;
2. drives the main path through the user's entry point, the port's CLI
   on ``Examples/vacuum3D_tfsf.txt --same-size 256`` for its 150 steps
   with DAT dumps and the finite check, and asserts the packed CUDA
   step ran (2 launches per step), finite fields in the dumps, and
   scattered-field leakage outside the TFSF box within 10x of the JAX
   reference's at a small size on the CPU (scripts/tfsf_leakage.py);
3. times each kernel, its plain version and the whole step with CUDA
   events after warm-up at 256^3, beside the bytes bound at 3.35 TB/s.

The last lines are the kernels JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io as _io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
MIE = os.path.join(ROOT, "Examples", "sphere3D_mie.txt")
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

TOL = 2e-6               # the reference's f32 kernel-vs-jnp gate
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
# tfsf_leakage of the JAX reference (jnp step, CPU) on
# Examples/vacuum3D_tfsf.txt at --same-size 48, 150 steps, measured by
# scripts/tfsf_leakage.py; the card's run must stay within 10x of it.
REF_LEAKAGE = 2.506451500547642e-07
STEPS_CMP = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def config(path, extra):
    from fdtd3d_torch import cli
    parser = cli.build_parser()
    return cli.args_to_config(
        parser.parse_args(cli.read_cmd_file(path) + list(extra)))


def seeded_sim(cfg, dev, seed):
    """A packed-step Simulation on the card with seeded random E, H
    (and J with Drude), made on the device from a torch generator."""
    import torch
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    carry = sim._carry
    for key in ("E", "H", "J"):
        if key in carry:
            carry[key].copy_(0.01 * torch.randn(
                carry[key].shape, generator=g, device=dev))
    return sim


def clone_carry(carry):
    import torch
    if isinstance(carry, dict):
        return {k: clone_carry(v) for k, v in carry.items()}
    return carry.clone() if isinstance(carry, torch.Tensor) else carry


def leaves(carry, prefix=""):
    import torch
    for k, v in carry.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def compare(got, want, what):
    """Max |diff| per leaf, gated at TOL relative to the leaf's max;
    returns the largest absolute error."""
    worst = 0.0
    want_leaves = dict(leaves(want))
    for name, a in leaves(got):
        b = want_leaves[name]
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        rel = err / scale if scale > 0 else err
        if not rel < TOL:
            fail(f"{what}: {name} differs from the plain version: "
                 f"max|diff|={err:.3e}, max|plain|={scale:.3e}, "
                 f"rel={rel:.3e} >= {TOL}")
        worst = max(worst, err)
    return worst


def kernel_vs_plain(cfg, dev, seed, label):
    """10 packed steps with the kernels against 10 with the plain
    versions, from the same seeded carry; returns the worst error."""
    import torch
    from fdtd3d_torch.ops import packed
    sim = seeded_sim(cfg, dev, seed)
    k_step = packed.make_packed_step(sim.static, dev)
    p_step = packed.make_packed_step(sim.static, dev, plain=True)
    cc = k_step.prepare(sim.coeffs)
    ck = sim._carry
    cp = clone_carry(ck)
    for _ in range(STEPS_CMP):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    torch.cuda.synchronize()
    err = compare(ck, cp, f"{label}: {STEPS_CMP} packed steps")
    say(f"{label}: {STEPS_CMP} kernel steps match the plain version "
        f"(max abs err {err:.3e})")
    return err


def one_launch_vs_plain(sim, fn, plain_fn, family):
    """One launch of a family's kernel against its plain version on the
    same inputs (the carry of ``sim``, cloned twice)."""
    import torch
    from fdtd3d_torch.ops import packed
    cc = packed.make_packed_step(sim.static, sim.device).prepare(sim.coeffs)
    a, b = clone_carry(sim._carry), clone_carry(sim._carry)
    for carry, f in ((a, fn), (b, plain_fn)):
        if family == "E":
            f(carry["E"], carry["H"], carry.get("J"), carry["psE"], cc["E"])
        else:
            f(carry["H"], carry["E"], carry["psH"], cc["H"])
    torch.cuda.synchronize()
    return compare(a, b, f"one {family} launch")


def timed(fn, reps):
    """Mean ms of fn() over reps calls, by CUDA events after one
    warm-up call."""
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


def family_bytes(carry, cc, family):
    """Bytes one family update must move: each input read once, each
    output written once (fields, psi, J, coefficient grids, profiles)."""
    import torch
    vol = carry["E"][0].numel() * 4
    n = 3 * vol                                  # other family, read
    n += 2 * 3 * vol                             # own family, r + w
    ps = carry["psE"] if family == "E" else carry["psH"]
    n += sum(2 * v.numel() * 4 for v in ps.values())
    if family == "E" and "J" in carry:
        n += 2 * 3 * vol
    fc = cc[family]
    for key in ("a", "b", "kj", "bj"):
        for v in fc[key] or []:
            if isinstance(v, torch.Tensor):
                n += v.numel() * 4
    n += sum(v.numel() * 4 for v in fc["prof"].values())
    return n


def family_flops(carry, family):
    """Flops per family update: per component two differences (sub,
    mul, add), the CPML slab terms where psi lives, and the update
    (2 mul + 1 add; Drude 3 more)."""
    cells = carry["E"][0].numel()
    f = 3 * cells * (2 * 3 + 3)
    ps = carry["psE"] if family == "E" else carry["psH"]
    f += sum(v.numel() * 7 for v in ps.values())
    if family == "E" and "J" in carry:
        f += 3 * cells * 4
    return f


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the measurements as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this proof needs a GPU")
    try:
        from fdtd3d_torch import cli, diag
        from fdtd3d_torch.io import load_dat
        from fdtd3d_torch.ops import build, packed
        from fdtd3d_torch.sim import Simulation
        from fdtd3d_torch.solver import build_static
    except ImportError as exc:
        fail(f"the port is not importable from {ROOT}: {exc}")
    if "jax" in sys.modules or any(m.startswith("fdtd3d_tpu")
                                   for m in sys.modules):
        fail("the port pulled in jax or the reference package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    result = {"device": name}

    # ---- build -----------------------------------------------------------
    t0 = time.time()
    info = build.build("packed_eh", verbose=True)
    result["build_s"] = round(time.time() - t0, 3)
    say(f"built {os.path.relpath(info['path'], ROOT)} in "
        f"{result['build_s']} s (built={info['built']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"ptxas: {line.strip()}")

    # ---- phase 1: kernels vs plain versions on the card ------------------
    cfg256 = config(EXAMPLE, ["--same-size", "256"])
    sim = seeded_sim(cfg256, dev, seed=1)
    err_e = one_launch_vs_plain(sim, packed.e_update,
                                packed.e_update_plain, "E")
    err_h = one_launch_vs_plain(sim, packed.h_update,
                                packed.h_update_plain, "H")
    say(f"one launch at 256^3 matches the plain version (E {err_e:.3e}, "
        f"H {err_h:.3e})")
    err_steps = kernel_vs_plain(cfg256, dev, 1, "256^3 TFSF+CPML")
    mie = ["--same-size", "128", "--eps-sphere-center-x", "64",
           "--eps-sphere-center-y", "64", "--eps-sphere-center-z", "64",
           "--eps-sphere-radius", "16", "--use-drude", "--eps-inf", "4.0",
           "--omega-p", "1e12", "--gamma-d", "5e10",
           "--drude-sphere-center-x", "64", "--drude-sphere-center-y",
           "64", "--drude-sphere-center-z", "64",
           "--drude-sphere-radius", "12", "--topology", "none"]
    err_mie = kernel_vs_plain(config(MIE, mie), dev, 2,
                              "128^3 eps sphere + Drude sphere")
    oblique = ["--same-size", "96", "--pml-sizex", "0", "--angle-teta",
               "30", "--angle-phi", "40", "--angle-psi", "15",
               "--point-source", "Ez"]
    err_obl = kernel_vs_plain(config(EXAMPLE, oblique), dev, 3,
                              "96^3 oblique TFSF + point source, y/z CPML")
    result["max_abs_err"] = {"e_update_one": err_e, "h_update_one": err_h,
                             "steps_256": err_steps, "steps_128_mie":
                             err_mie, "steps_96_oblique": err_obl}
    del sim

    # ---- phase 2: the main path through the CLI ---------------------------
    packed.e_update.launches = 0
    packed.h_update.launches = 0
    torch.cuda.reset_peak_memory_stats()
    captured = _io.StringIO()
    argv = ["--cmd-from-file", EXAMPLE, "--same-size", "256",
            "--save-res", "150", "--check-finite", "--save-dir", OUT_DIR]
    t0 = time.time()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"e_update": packed.e_update.launches,
                "h_update": packed.h_update.launches}
    log_txt = captured.getvalue()
    say("cli: " + " | ".join(log_txt.strip().splitlines()))
    steps = cfg256.time_steps
    if rc != 0:
        fail(f"cli.main returned {rc}")
    if "step_kind=packed_cuda" not in log_txt:
        fail("the CLI did not run the packed CUDA step")
    if launches["e_update"] + launches["h_update"] != 2 * steps \
            or launches["e_update"] != steps:
        fail(f"kernel launches {launches} != {steps} per family")
    fields = {}
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        path = os.path.join(OUT_DIR, f"{c}_t{steps:06d}.dat")
        if not os.path.exists(path):
            fail(f"missing dump {path}")
        fields[c] = load_dat(path)
        if fields[c].shape != (256, 256, 256) \
                or not bool((abs(fields[c]) < float("inf")).all()):
            fail(f"{c}: bad dump (shape {fields[c].shape} or non-finite)")
    st = build_static(cfg256).tfsf_setup
    leak = diag.tfsf_leakage(fields, st.lo, st.hi)
    result["main_path"] = {
        "steps": steps, "wall_s": wall, "launches": launches,
        "tfsf_leakage": leak, "ref_tfsf_leakage_48": REF_LEAKAGE,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    if not leak <= 10 * REF_LEAKAGE:
        fail(f"TFSF leakage {leak:.3e} exceeds 10x the reference's "
             f"{REF_LEAKAGE:.3e}")
    say(f"main path: {steps} steps, launches {launches}, leakage "
        f"{leak:.3e} (reference at 48^3: {REF_LEAKAGE})")

    # ---- phase 3: times at 256^3 -----------------------------------------
    sim = Simulation(cfg256, device=dev)
    sim.advance(steps)             # a realistic mid-run state
    carry = sim._carry
    step = packed.make_packed_step(sim.static, dev)
    cc = step.prepare(sim.coeffs)
    reps = 50
    e_ms = timed(lambda: packed.e_update(carry["E"], carry["H"],
                                         carry.get("J"), carry["psE"],
                                         cc["E"]), reps)
    h_ms = timed(lambda: packed.h_update(carry["H"], carry["E"],
                                         carry["psH"], cc["H"]), reps)
    e_plain = timed(lambda: packed.e_update_plain(
        carry["E"], carry["H"], carry.get("J"), carry["psE"], cc["E"]), 5)
    h_plain = timed(lambda: packed.h_update_plain(
        carry["H"], carry["E"], carry["psH"], cc["H"]), 5)
    plain_step = packed.make_packed_step(sim.static, dev, plain=True)
    step_ms = timed(lambda: step(carry, cc), reps)
    plain_step_ms = timed(lambda: plain_step(carry, cc), 5)
    torch.cuda.reset_peak_memory_stats()
    sim.advance(10)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cells = 256 ** 3
    b_e = family_bytes(carry, cc, "E")
    b_h = family_bytes(carry, cc, "H")
    bound = {}
    for fam, nbytes in (("E", b_e), ("H", b_h)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = family_flops(carry, fam) / F32_FLOPS * 1e3
        bound[fam] = (max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations")
    vol = cells * 4
    step_bytes = 12 * vol + sum(2 * v.numel() * 4 for v in
                                list(carry["psE"].values())
                                + list(carry["psH"].values()))
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    result["times_256"] = {
        "e_update_ms": e_ms, "h_update_ms": h_ms,
        "kernel_ms_per_step": e_ms + h_ms, "step_ms": step_ms,
        "plain_e_ms": e_plain, "plain_h_ms": h_plain,
        "plain_step_ms": plain_step_ms,
        "mcells_per_s": cells / (step_ms * 1e-3) / 1e6,
        "step_bound_bytes": step_bytes, "step_bound_ms": step_bound_ms,
        "kernel_bound_share": step_bound_ms / (e_ms + h_ms),
        "peak_mem_bytes_advance": peak,
        "e_bound_ms": bound["E"][0], "h_bound_ms": bound["H"][0],
        "e_bytes": b_e, "h_bytes": b_h}
    say("times at 256^3: " + json.dumps(result["times_256"]))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    result["nvidia_smi"] = card
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)

    src = "fdtd3d_torch/csrc/packed_eh.cu"
    kernels = [
        {"name": "packed_eh.e_update", "route": "cuda", "source": src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
         "launches": launches["e_update"], "max_abs_err": err_e,
         "ms": e_ms, "plain_ms": e_plain, "bound_ms": bound["E"][0],
         "bound_by": bound["E"][1], "library_ms": None},
        {"name": "packed_eh.h_update", "route": "cuda", "source": src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
         "launches": launches["h_update"], "max_abs_err": err_h,
         "ms": h_ms, "plain_ms": h_plain, "bound_ms": bound["H"][0],
         "bound_by": bound["H"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
