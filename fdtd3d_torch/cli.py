"""``fdtd3d-torch`` entry point: the reference CLI on the PyTorch port.

Counterpart of ``fdtd3d_tpu/cli.py``. The front half (``build_parser``
with every flag of the reference, ``read_cmd_file``, ``args_to_config``)
is the reference's, so every ``Examples/*.txt`` command file parses to
the same ``SimConfig``; the port adds ``--device`` (cuda by default,
``--device cpu`` to run on the CPU). ``main`` runs every scheme mode
(1D, 2D, 3D), and 3D on a decomposed topology (``--topology auto``
over the visible cards or ``--num-devices``, ``--manual-topology
PXxPYxPZ``: the sharded packed step, where the reference's dispatch
takes its two-pass kernels the sharded two-pass step, in float32x2 the
sharded packed-ds step, in one process, one shard a visible card, or on
the CPU up to ``parallel.mesh.CPU_SHARDS`` shards;
``_check_topology_fits`` refuses more shards than that), ``--dry-run`` (the per-device plan of
``fdtd3d_torch/plan.py``, no device touched): the run in chunks,
``--norms-every`` lines, dumps every ``--save-res`` steps in the
``--save-formats`` (dat, txt, bmp), ``--save-materials``,
``--save-cmd-to-file``, the near-to-far-field transform (``--ntff``:
sampled between chunks, ``ntff_pattern.txt`` at the end), npz
checkpoints every ``--checkpoint-every`` steps (keep-K rotation,
``--checkpoint-keep``), ``--load-checkpoint``/``--resume auto|PATH``
(only the remaining steps run), ``--supervise``
(``fdtd3d_torch/supervisor.py``: retry, rollback, the kernel ladder),
the SIGTERM/SIGINT handlers (exit 143/130), and the closing throughput
line, for ``--dtype float32``, ``bfloat16`` (bf16 storage, f32
arithmetic; the DAT dumps are the fields' 2-byte words, as the
reference's), ``float32x2`` (the hi words are dumped, in f32, as the
reference dumps them; with the magnetic Drude flags too, and with
``--complex-field-values`` as two ds legs, ``<c8`` dumps of the hi
words: on the CPU under the reference's hook
``FDTD3D_FORCE_PAIRED_COMPLEX``, else a ValueError) and ``float64``;
and ``--batch a.txt b.txt ...`` (``_run_batch_cli``): the command
files as the lanes of one batch (fdtd3d_torch/batch.py), with the
reference's per-lane lines (float32x2 lanes refused, as the reference
refuses them). The
observability flags: ``--telemetry`` (the schema-v11 JSONL of
``fdtd3d_torch/telemetry.py``; with ``--per-chip-telemetry`` the
per-chip rows), ``--metrics-every`` (``save_dir/metrics.jsonl``, in the
chunk interval's gcd), ``--profile [DIR]`` and ``--trace DIR`` (the
per-chunk clock's ``profile:`` line; a torch.profiler trace), closed on
every exit with the run's ``telemetry: N records`` line. Flags whose
features are not ported yet raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import math
import shlex
import sys
import time
from typing import List, Optional

from fdtd3d_torch.config import (MaterialsConfig, NtffConfig, OutputConfig,
                                 ParallelConfig, PmlConfig,
                                 PointSourceConfig, SimConfig, SphereConfig,
                                 TfsfConfig)
from fdtd3d_torch.layout import SCHEME_MODES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fdtd3d",
        description="TPU-native 1D/2D/3D FDTD Maxwell solver "
                    "(JAX/XLA rebuild of fdtd3d)")
    g = p.add_argument_group("scheme / grid")
    g.add_argument("--scheme", choices=sorted(SCHEME_MODES), default=None,
                   help="solver mode (reference SchemeType)")
    g.add_argument("--1d", dest="dim1", metavar="PAIR",
                   help="1D mode shorthand, e.g. --1d EzHy")
    g.add_argument("--2d", dest="dim2", metavar="POL",
                   help="2D mode shorthand, e.g. --2d TMz")
    g.add_argument("--3d", dest="dim3", action=argparse.BooleanOptionalAction, default=False,
                   help="3D mode shorthand")
    g.add_argument("--sizex", type=int, default=32)
    g.add_argument("--sizey", type=int, default=32)
    g.add_argument("--sizez", type=int, default=32)
    g.add_argument("--same-size", type=int, metavar="N",
                   help="set sizex=sizey=sizez=N")
    g.add_argument("--time-steps", type=int, default=100)
    g.add_argument("--dx", type=float, default=1e-3, help="cell size, m")
    g.add_argument("--courant-factor", type=float, default=0.5)
    g.add_argument("--wavelength", type=float, default=20e-3,
                   help="source wavelength, m")
    g.add_argument("--dtype", choices=["float32", "float64", "bfloat16",
                                       "float32x2"],
                   default="float32")
    g.add_argument("--compensated", action=argparse.BooleanOptionalAction, default=False,
                   help="Kahan-compensated f32 updates: f64-class "
                        "long-horizon accuracy at ~1.25x the f32 "
                        "traffic (float32 only)")
    g.add_argument("--complex-field-values", action=argparse.BooleanOptionalAction, default=False)

    g = p.add_argument_group("boundaries (CPML)")
    g.add_argument("--use-pml", action=argparse.BooleanOptionalAction, default=False)
    g.add_argument("--pml-size", type=int, default=8,
                   help="thickness on every active axis")
    g.add_argument("--pml-sizex", type=int, default=None)
    g.add_argument("--pml-sizey", type=int, default=None)
    g.add_argument("--pml-sizez", type=int, default=None)

    g = p.add_argument_group("TFSF plane-wave source")
    g.add_argument("--use-tfsf", action=argparse.BooleanOptionalAction, default=False)
    g.add_argument("--tfsf-margin", type=int, default=8)
    g.add_argument("--angle-teta", type=float, default=0.0)
    g.add_argument("--angle-phi", type=float, default=0.0)
    g.add_argument("--angle-psi", type=float, default=0.0)
    g.add_argument("--tfsf-amplitude", type=float, default=1.0)
    g.add_argument("--tfsf-waveform", default="sin",
                   choices=["sin", "gauss_pulse"])

    g = p.add_argument_group("point source")
    g.add_argument("--point-source", metavar="COMP",
                   help="enable soft point source on component, e.g. Ez")
    g.add_argument("--point-source-x", type=int, default=None)
    g.add_argument("--point-source-y", type=int, default=None)
    g.add_argument("--point-source-z", type=int, default=None)
    g.add_argument("--point-source-amplitude", type=float, default=1.0)
    g.add_argument("--point-source-waveform", default="sin",
                   choices=["sin", "gauss_pulse", "ricker"])

    g = p.add_argument_group("materials")
    g.add_argument("--eps", type=float, default=1.0)
    g.add_argument("--mu", type=float, default=1.0)
    g.add_argument("--sigma-e", type=float, default=0.0)
    g.add_argument("--sigma-m", type=float, default=0.0)
    g.add_argument("--eps-sphere", type=float, default=None,
                   metavar="EPSVAL", help="spherical inclusion permittivity")
    g.add_argument("--eps-sphere-center-x", type=float, default=0.0)
    g.add_argument("--eps-sphere-center-y", type=float, default=0.0)
    g.add_argument("--eps-sphere-center-z", type=float, default=0.0)
    g.add_argument("--eps-sphere-radius", type=float, default=0.0)
    g.add_argument("--load-eps-from-file", metavar="PATH", default=None)
    g.add_argument("--load-mu-from-file", metavar="PATH", default=None)
    g.add_argument("--use-drude", action=argparse.BooleanOptionalAction, default=False)
    g.add_argument("--eps-inf", type=float, default=1.0)
    g.add_argument("--omega-p", type=float, default=0.0, help="rad/s")
    g.add_argument("--gamma-d", type=float, default=0.0, help="rad/s")
    g.add_argument("--drude-sphere-center-x", type=float, default=0.0)
    g.add_argument("--drude-sphere-center-y", type=float, default=0.0)
    g.add_argument("--drude-sphere-center-z", type=float, default=0.0)
    g.add_argument("--drude-sphere-radius", type=float, default=0.0)
    # magnetic Drude (reference metamaterial mode: OmegaPM/GammaM)
    g.add_argument("--use-drude-m", action=argparse.BooleanOptionalAction, default=False,
                   help="dispersive mu(w) via an ADE magnetic current")
    g.add_argument("--mu-inf", type=float, default=1.0)
    g.add_argument("--omega-pm", type=float, default=0.0, help="rad/s")
    g.add_argument("--gamma-m", type=float, default=0.0, help="rad/s")
    g.add_argument("--drude-m-sphere-center-x", type=float, default=0.0)
    g.add_argument("--drude-m-sphere-center-y", type=float, default=0.0)
    g.add_argument("--drude-m-sphere-center-z", type=float, default=0.0)
    g.add_argument("--drude-m-sphere-radius", type=float, default=0.0)

    g = p.add_argument_group("near-to-far-field (NTFF)")
    g.add_argument("--ntff", action=argparse.BooleanOptionalAction, default=False,
                   help="accumulate the NTFF running DFT during the run "
                        "and write the far-field pattern at the end")
    g.add_argument("--ntff-frequency", type=float, default=None,
                   help="DFT frequency, Hz (default: source frequency)")
    g.add_argument("--ntff-every", type=int, default=None,
                   help="sample every N steps (default ~16/period)")
    g.add_argument("--ntff-start", type=int, default=None,
                   help="first sampling step (default: half the run)")
    g.add_argument("--ntff-margin", type=int, default=2,
                   help="box margin inward from the PML inner face, cells")
    g.add_argument("--ntff-box-lo", metavar="X,Y,Z", default=None,
                   help="explicit box lower corner (overrides margin)")
    g.add_argument("--ntff-box-hi", metavar="X,Y,Z", default=None,
                   help="explicit box upper corner (overrides margin)")
    g.add_argument("--ntff-theta-steps", type=int, default=19)
    g.add_argument("--ntff-phi-steps", type=int, default=24)

    g = p.add_argument_group("parallel decomposition")
    g.add_argument("--topology", choices=["none", "auto", "manual"],
                   default="none")
    g.add_argument("--manual-topology", metavar="PXxPYxPZ", default=None,
                   help="e.g. 2x2x2 (reference --manual-topology)")
    g.add_argument("--num-devices", type=int, default=None)
    # multi-process runtime (the reference's mpirun surface): one process
    # per host; the device mesh then spans every process's chips.
    g.add_argument("--coordinator-address", default=None,
                   metavar="HOST:PORT")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)

    g = p.add_argument_group("kernels")
    g.add_argument("--use-pallas", choices=["auto", "on", "off"],
                   default="auto",
                   help="fused Pallas TPU kernels for the 3D hot path: "
                        "auto engages them on TPU when eligible; on "
                        "forces them (interpreter mode off-TPU, slow); "
                        "off always runs the jnp path")
    g.add_argument("--device", default=None, metavar="DEVICE",
                   help="torch device of the PyTorch port: cuda (the "
                        "default) or cpu; no GPU and no explicit cpu "
                        "is an error")
    g.add_argument("--require-pallas", action=argparse.BooleanOptionalAction, default=False,
                   help="error out if the fused kernels do not engage "
                        "instead of silently running the jnp fallback")

    g = p.add_argument_group("output")
    g.add_argument("--save-res", type=int, default=0,
                   help="dump fields every N steps")
    g.add_argument("--save-dir", default="out")
    g.add_argument("--save-formats", default="dat",
                   help="comma list of dat,txt,bmp")
    g.add_argument("--save-materials", action=argparse.BooleanOptionalAction, default=False)
    g.add_argument("--checkpoint-every", type=int, default=0)
    g.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="npz: rank-0 single file; orbax: sharding-aware "
                        "per-host shard writes (large/multi-host runs)")
    g.add_argument("--checkpoint-keep", type=int, default=3,
                   help="keep-K rotation for --checkpoint-every: only "
                        "the newest K committed snapshots stay on disk "
                        "(0 = keep all)")
    g.add_argument("--load-checkpoint", metavar="PATH", default=None)
    g.add_argument("--resume", metavar="auto|PATH", default=None,
                   help="resume a killed/preempted run from a COMMITTED "
                        "checkpoint and finish the remaining steps: "
                        "'auto' picks the newest committed snapshot in "
                        "--save-dir (snapshots failing their integrity "
                        "checks are skipped with a warning), or give an "
                        "explicit path (docs/ROBUSTNESS.md runbook)")
    g.add_argument("--norms-every", type=int, default=0,
                   help="print field norms every N steps")
    g.add_argument("--metrics-every", type=int, default=0,
                   help="append a structured metrics record (energy, "
                        "norms, divergence residual) to "
                        "save_dir/metrics.jsonl every N steps")
    g.add_argument("--log-level", type=int, default=1)
    g.add_argument("--profile", nargs="?", const=True, default=False,
                   metavar="DIR",
                   help="time every compute chunk (StepClock) and print "
                        "a throughput summary at the end; with DIR, also "
                        "capture a torch.profiler trace there "
                        "(DIR/trace.json, a Chrome trace; finalized on "
                        "every exit; degrades to a clean skip when no "
                        "profiler is available)")
    # compat: --profile was a BooleanOptionalAction before round 7, so
    # command files saved by earlier builds may contain --no-profile;
    # replay must keep working (hidden from --help and from
    # save_cmd_file, which skips SUPPRESS'd actions)
    g.add_argument("--no-profile", dest="profile", action="store_const",
                   const=False, help=argparse.SUPPRESS)
    g.add_argument("--check-finite", action=argparse.BooleanOptionalAction, default=False,
                   help="NaN/Inf tripwire over the state after each chunk")
    g.add_argument("--trace", metavar="DIR", default=None,
                   help="legacy alias for --profile DIR (kept for saved "
                        "command files)")
    g.add_argument("--telemetry", metavar="PATH", default=None,
                   help="flight recorder: append schema-versioned JSONL "
                        "records (per-chunk in-graph health counters, "
                        "wall time, run provenance, VMEM-ladder events) "
                        "to PATH; summarize with "
                        "tools/telemetry_report.py")
    g.add_argument("--metrics", metavar="PATH", default=None,
                   help="write an OpenMetrics/Prometheus text "
                        "exposition of this run's counters (chunk "
                        "throughput, wall-time histogram, recovery "
                        "events, unhealthy lanes, cache hits) to PATH "
                        "at exit, fed host-side from the same events "
                        "the telemetry sink records — any scraper "
                        "can ingest a run without parsing our JSONL; "
                        "works with or without --telemetry")
    g.add_argument("--per-chip-telemetry",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="with --telemetry: also record the UN-psummed "
                        "per-chip health counters (schema-v4 per_chip "
                        "records, tiny all_gathered scalars on the "
                        "same readback) plus a per-chunk imbalance "
                        "summary (max/mean ratio, straggler chip). "
                        "With --batch: per-LANE per_chip/imbalance "
                        "rows naming each tenant's straggler chip")

    g = p.add_argument_group("durability (docs/ROBUSTNESS.md)")
    g.add_argument("--supervise", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="run under the durable-run supervisor: bounded "
                        "retry with exponential backoff for transient "
                        "device errors; on a NaN/Inf health trip, roll "
                        "back to the last committed checkpoint and "
                        "resume down the kernel degradation ladder "
                        "(implies --check-finite)")

    g = p.add_argument_group("planning")
    g.add_argument("--dry-run", action=argparse.BooleanOptionalAction, default=False,
                   help="print the per-chip memory/communication plan "
                        "(no device needed) and exit — size pod-scale "
                        "configs on a laptop")

    g = p.add_argument_group("batched execution (docs/SERVICE.md)")
    g.add_argument("--batch", metavar="SPEC.txt", nargs="+",
                   default=None,
                   help="run B same-shape scenarios as ONE vmap-"
                        "batched execution: each SPEC.txt is a "
                        "command file (--cmd-from-file format) "
                        "describing one lane. Lanes must share the "
                        "graph-shaping config (grid/scheme/dtype/"
                        "steps/sources geometry) and may differ in "
                        "material values and point-source amplitude; "
                        "one compiled executable, one dispatch per "
                        "chunk for the whole batch. Per-lane health "
                        "flags — one lane's NaN never fails the "
                        "others. Top-level --telemetry/--metrics/"
                        "--check-finite apply to the batch; "
                        "FDTD3D_BATCH_MAX bounds the lane count.")
    g.add_argument("--batch-chunk", type=int, default=0, metavar="N",
                   help="advance the batch in N-step compiled chunks "
                        "(per-chunk telemetry cadence + per-lane "
                        "health granularity: a mid-run NaN is "
                        "attributed to its chunk, not just the final "
                        "state sweep); 0 = the whole horizon as one "
                        "chunk (fastest)")

    g = p.add_argument_group("command files")
    g.add_argument("--cmd-from-file", metavar="FILE", default=None,
                   help="read flags from a .txt command file (reference "
                        "format: one flag [value] per line)")
    g.add_argument("--save-cmd-to-file", metavar="FILE", default=None,
                   help="re-emit the effective flags to a command file")
    return p


def read_cmd_file(path: str) -> List[str]:
    """Reference-style .txt command file -> argv list."""
    argv: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                argv.extend(shlex.split(line))
    return argv


def _parse_xyz(val):
    """'X,Y,Z' -> (int, int, int), or None passthrough."""
    if val is None:
        return None
    parts = [p for p in str(val).replace("x", ",").split(",") if p]
    try:
        triple = tuple(int(p) for p in parts)
    except ValueError:
        triple = ()
    if len(triple) != 3:
        raise SystemExit(f"expected X,Y,Z integer triple, got {val!r}")
    return triple


def _resolve_scheme(args) -> str:
    if args.dim3:
        return "3D"
    if args.dim2:
        return f"2D_{args.dim2}"
    if args.dim1:
        return f"1D_{args.dim1}"
    return args.scheme or "3D"


def args_to_config(args) -> SimConfig:
    if args.same_size:
        args.sizex = args.sizey = args.sizez = args.same_size
    pml_size = (0, 0, 0)
    if args.use_pml:
        pml_size = tuple(
            args.pml_sizex if (a == 0 and args.pml_sizex is not None) else
            args.pml_sizey if (a == 1 and args.pml_sizey is not None) else
            args.pml_sizez if (a == 2 and args.pml_sizez is not None) else
            args.pml_size for a in range(3))
    manual = None
    if args.manual_topology:
        parts = args.manual_topology.lower().split("x")
        if len(parts) != 3:
            raise SystemExit("--manual-topology must look like 2x2x1")
        manual = tuple(int(v) for v in parts)
    ps_default = {0: args.sizex // 2, 1: args.sizey // 2,
                  2: args.sizez // 2}
    cfg = SimConfig(
        scheme=_resolve_scheme(args),
        size=(args.sizex, args.sizey, args.sizez),
        time_steps=args.time_steps,
        dx=args.dx,
        courant_factor=args.courant_factor,
        wavelength=args.wavelength,
        dtype=args.dtype,
        compensated=args.compensated,
        complex_fields=args.complex_field_values,
        pml=PmlConfig(size=pml_size),
        tfsf=TfsfConfig(
            enabled=args.use_tfsf,
            margin=(args.tfsf_margin,) * 3,
            angle_teta=args.angle_teta, angle_phi=args.angle_phi,
            angle_psi=args.angle_psi, amplitude=args.tfsf_amplitude,
            waveform=args.tfsf_waveform),
        point_source=PointSourceConfig(
            enabled=args.point_source is not None,
            component=args.point_source or "Ez",
            position=(
                args.point_source_x if args.point_source_x is not None
                else ps_default[0],
                args.point_source_y if args.point_source_y is not None
                else ps_default[1],
                args.point_source_z if args.point_source_z is not None
                else ps_default[2]),
            amplitude=args.point_source_amplitude,
            waveform=args.point_source_waveform),
        materials=MaterialsConfig(
            eps=args.eps, mu=args.mu,
            sigma_e=args.sigma_e, sigma_m=args.sigma_m,
            eps_sphere=SphereConfig(
                enabled=args.eps_sphere is not None,
                center=(args.eps_sphere_center_x, args.eps_sphere_center_y,
                        args.eps_sphere_center_z),
                radius=args.eps_sphere_radius,
                value=args.eps_sphere or 1.0),
            use_drude=args.use_drude,
            eps_inf=args.eps_inf, omega_p=args.omega_p, gamma=args.gamma_d,
            drude_sphere=SphereConfig(
                enabled=args.drude_sphere_radius > 0,
                center=(args.drude_sphere_center_x,
                        args.drude_sphere_center_y,
                        args.drude_sphere_center_z),
                radius=args.drude_sphere_radius),
            use_drude_m=args.use_drude_m,
            mu_inf=args.mu_inf, omega_pm=args.omega_pm,
            gamma_m=args.gamma_m,
            drude_m_sphere=SphereConfig(
                enabled=args.drude_m_sphere_radius > 0,
                center=(args.drude_m_sphere_center_x,
                        args.drude_m_sphere_center_y,
                        args.drude_m_sphere_center_z),
                radius=args.drude_m_sphere_radius),
            eps_file=args.load_eps_from_file,
            mu_file=args.load_mu_from_file),
        parallel=ParallelConfig(
            topology="manual" if manual else args.topology,
            manual_topology=manual, n_devices=args.num_devices),
        output=OutputConfig(
            save_res=args.save_res, save_dir=args.save_dir,
            formats=tuple(args.save_formats.split(",")),
            save_materials=args.save_materials,
            checkpoint_every=args.checkpoint_every,
            checkpoint_backend=args.checkpoint_backend,
            checkpoint_keep=args.checkpoint_keep,
            norms_every=args.norms_every, metrics_every=args.metrics_every,
            log_level=args.log_level,
            profile=bool(args.profile), check_finite=args.check_finite,
            telemetry_path=args.telemetry,
            metrics_path=args.metrics,
            per_chip_telemetry=args.per_chip_telemetry,
            # --profile DIR routes the device-trace lane; --trace is
            # the legacy alias (saved command files)
            profile_dir=(args.profile
                         if isinstance(args.profile, str) else None)
            or args.trace),
        ntff=NtffConfig(
            enabled=args.ntff, frequency=args.ntff_frequency,
            every=args.ntff_every, start=args.ntff_start,
            margin=args.ntff_margin,
            box_lo=_parse_xyz(args.ntff_box_lo),
            box_hi=_parse_xyz(args.ntff_box_hi),
            theta_steps=args.ntff_theta_steps,
            phi_steps=args.ntff_phi_steps),
        use_pallas={"auto": None, "on": True, "off": False}[args.use_pallas],
        require_pallas=args.require_pallas,
    )
    return cfg


# (flag attribute, value that means "not used", ROADMAP.md item)
_NOT_PORTED = (
    ("coordinator_address", None, "A11(b)"),
    ("num_processes", None, "A11(b)"), ("process_id", None, "A11(b)"),
    ("metrics", None, "A15"),
)


def _not_ported(flag: str, item: str) -> None:
    raise NotImplementedError(
        f"{flag} is not ported to fdtd3d_torch yet (ROADMAP.md queue "
        f"{item}); run it with the reference CLI (python -m "
        f"fdtd3d_tpu.cli)")


# the flags a batch does not take (ROADMAP.md item A13(b)): batch
# checkpoints and resume, and the per-run outputs the reference's batch
# leaves out (the far-field pattern, the material dump)
_BATCH_NOT_PORTED = (("checkpoint_every", 0), ("resume", None),
                     ("load_checkpoint", None), ("ntff", False),
                     ("save_materials", False))


def check_batch_ported(args) -> None:
    for attr, unused in _BATCH_NOT_PORTED:
        if getattr(args, attr) != unused:
            _not_ported("--batch with --" + attr.replace("_", "-"),
                        "A13(b)")


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature is not in this
    slice of the port."""
    for attr, unused, item in _NOT_PORTED:
        val = getattr(args, attr)
        if val != unused:
            _not_ported("--" + attr.replace("_", "-"), item)


def _check_topology_fits(cfg, device=None, resuming: bool = False):
    """A SystemExit naming the problem when the decomposition cannot map
    onto the devices a run has (the reference's ``_check_topology_fits``,
    fdtd3d_tpu/cli.py:573-596), never a raw traceback: the visible CUDA
    cards, or on the CPU ``parallel.mesh.CPU_SHARDS`` shards."""
    from fdtd3d_torch.parallel.mesh import auto_count, device_count
    from fdtd3d_torch.solver import config_topology
    kind = "cpu" if device is not None and str(device).startswith("cpu") \
        else "cuda"
    avail = device_count(kind)
    try:
        topo = config_topology(cfg, n_devices=auto_count(kind))
    except ValueError as exc:
        raise SystemExit(f"invalid decomposition topology: {exc}")
    n = topo[0] * topo[1] * topo[2]
    if n > 1 and n > avail:
        hint = ""
        if resuming:
            hint = (" — snapshots are topology-portable: pass a smaller "
                    "--manual-topology (or --topology none) and --resume "
                    "reshards the checkpoint onto it")
        raise SystemExit(
            f"topology {topo} needs {n} devices but only {avail} are "
            f"available{hint}")
    return topo


def dry_run(cfg, num_devices=None) -> int:
    """``--dry-run``: the per-device plan (``fdtd3d_torch/plan.py``)
    printed, no device touched (the reference's :706-725)."""
    from fdtd3d_torch import plan as plan_mod
    from fdtd3d_torch.log import log
    if cfg.parallel.topology == "auto" and not num_devices:
        raise SystemExit(
            "--dry-run with --topology auto needs --num-devices N (the "
            "plan depends on the device count you are sizing for)")
    p_ = plan_mod.plan(cfg, n_devices=num_devices or 1)
    log(f"dry run: scheme={cfg.scheme} global={cfg.grid_shape} "
        f"steps={cfg.time_steps} dtype={cfg.dtype}")
    log(p_.report())
    return 0


def resolve_ntff_cadence(cfg):
    """(frequency_hz, every, start) with the derived defaults filled in
    (``fdtd3d_tpu/cli.py::resolve_ntff_cadence``): the source frequency,
    ~16 samples a period, from half the run, the start aligned up to a
    multiple of ``every`` (the run samples only there). ``main`` and
    ``save_cmd_file`` share it, so a saved command file pins the derived
    cadence too."""
    from fdtd3d_torch import physics
    freq = cfg.ntff.frequency or physics.C0 / cfg.wavelength
    period_steps = 1.0 / (freq * cfg.dt)
    every = cfg.ntff.every or max(1, round(period_steps / 16.0))
    start = (cfg.ntff.start if cfg.ntff.start is not None
             else cfg.time_steps // 2)
    start = -(-start // every) * every
    return freq, every, start


# flags save_cmd_file does not re-emit: the command-file flags
# themselves, the batch list, and the port's --device (a saved file
# replays on either package's CLI, and on any device)
_NOT_SAVED = ("help", "cmd_from_file", "save_cmd_to_file", "batch",
              "device")


def save_cmd_file(args, path: str):
    """``--save-cmd-to-file``: every effective flag, defaults included,
    one ``flag [value]`` a line (``fdtd3d_tpu/cli.py::save_cmd_file``),
    the derived NTFF cadence resolved first, booleans in both states
    (``--flag`` / ``--no-flag``), written through the atomic writer: a
    saved file replays to the same configuration even if a default
    changes."""
    if args.ntff:
        freq, every, start = resolve_ntff_cadence(args_to_config(args))
        args = argparse.Namespace(**{**vars(args), "ntff_frequency": freq,
                                     "ntff_every": every,
                                     "ntff_start": start})
    lines = []
    for action in build_parser()._actions:
        if not action.option_strings or action.dest in _NOT_SAVED \
                or action.help == argparse.SUPPRESS:
            continue
        val = getattr(args, action.dest, None)
        if val is None:
            continue
        opt = action.option_strings[0]
        if isinstance(val, bool):
            neg = next((o for o in action.option_strings
                        if o.startswith("--no-")), None)
            if val:
                lines.append(opt)
            elif neg is not None:
                lines.append(neg)
        else:
            lines.append(f"{opt} {val}")
    from fdtd3d_torch.io import atomic_open
    with atomic_open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_ntff_pattern(col, cfg) -> str:
    """The far-field |E|^2 pattern over the angle grid, normalised to
    its peak, as ``save_dir/ntff_pattern.txt``: a header line, then
    ``theta phi value`` rows (``fdtd3d_tpu/cli.py::write_ntff_pattern``)."""
    import os

    import numpy as np

    from fdtd3d_torch.io import atomic_open
    thetas = np.linspace(0.0, 180.0, cfg.ntff.theta_steps)
    phis = np.arange(cfg.ntff.phi_steps) * (360.0 / cfg.ntff.phi_steps)
    pattern = col.directivity_pattern(thetas, phis)
    peak = pattern.max()
    if peak > 0:
        pattern = pattern / peak
    os.makedirs(cfg.output.save_dir, exist_ok=True)
    path = os.path.join(cfg.output.save_dir, "ntff_pattern.txt")
    with atomic_open(path, "w") as f:
        f.write("# theta_deg phi_deg directivity(normalized)\n")
        for i, th in enumerate(thetas):
            for j, ph in enumerate(phis):
                f.write(f"{th:.3f} {ph:.3f} {pattern[i, j]:.9e}\n")
    return path


def make_ntff_collector(sim, cfg):
    """-> (the NTFF collector, its cadence ``every``, its first sampling
    step), or (None, 0, 0) without ``--ntff``; an explicit box needs both
    its ends (SystemExit)."""
    if not cfg.ntff.enabled:
        return None, 0, 0
    from fdtd3d_torch.ntff import NtffCollector
    freq, every, start = resolve_ntff_cadence(cfg)
    box = None
    if cfg.ntff.box_lo is not None or cfg.ntff.box_hi is not None:
        if cfg.ntff.box_lo is None or cfg.ntff.box_hi is None:
            raise SystemExit(
                "--ntff-box-lo and --ntff-box-hi must be given together")
        box = (cfg.ntff.box_lo, cfg.ntff.box_hi)
    return NtffCollector(sim, frequency=freq, box=box,
                         margin=cfg.ntff.margin), every, start


def _run_batch_cli(parser, args) -> int:
    """``--batch spec1.txt spec2.txt ...``: parse each command file into
    one scenario, run them as one batch, report per-lane health. A
    tripped lane is a WARNED per-lane verdict, never a batch failure
    (exit stays 0: the other tenants' runs completed). The wall of the
    closing line covers the stepping and the end-of-run sweep, as the
    solo line's covers the stepping; the set-up (host coefficients of
    every lane) is printed beside it."""
    import dataclasses as _dc

    from fdtd3d_torch.batch import BatchSimulation
    from fdtd3d_torch.log import log, set_level, warn
    check_batch_ported(args)
    if args.supervise:
        # a supervised batch's recovery is per-lane isolation (one
        # lane's NaN flips only its verdict): --supervise forces the
        # finite check on, as in the reference
        args.check_finite = True
    cfgs = []
    for path in args.batch:
        largs = parser.parse_args(read_cmd_file(path))
        if largs.batch:
            raise SystemExit(
                f"--batch: {path} itself contains --batch (nested "
                f"batches are not a thing)")
        check_ported(largs)
        check_batch_ported(largs)
        cfgs.append(args_to_config(largs))
    if args.telemetry or args.check_finite or args.per_chip_telemetry:
        # top-level observability flags apply to the batch (lane 0's
        # output config drives the shared sink, the tripwire and the
        # per-chip rows, as in the reference)
        out0 = cfgs[0].output
        cfgs[0] = _dc.replace(cfgs[0], output=_dc.replace(
            out0, telemetry_path=args.telemetry or out0.telemetry_path,
            check_finite=args.check_finite or out0.check_finite,
            per_chip_telemetry=args.per_chip_telemetry
            or out0.per_chip_telemetry))
    set_level(cfgs[0].output.log_level)
    if args.profile or args.trace:
        # the reference's batch has no clock and no trace capture
        log("profile: a batch keeps no per-chunk clock and no trace "
            "(--profile/--trace apply to solo runs)")
    t0 = time.time()
    try:
        bsim = BatchSimulation(cfgs, device=args.device)
    except ValueError as exc:
        raise SystemExit(f"--batch: {exc}")
    setup = time.time() - t0
    t0 = time.time()
    try:
        bsim.run(chunk=args.batch_chunk)
        bsim.verify_final_lanes()
        bsim.block_until_ready()
    finally:
        bsim.close()
    wall = time.time() - t0
    # the batch dispatch verdict, mirroring the solo step-kind line: the
    # engaged kind, and the named batch_unsupported:<token> when the
    # batch could not ride the lane-capable kernels
    kind_line = f"step_kind={bsim.step_kind}"
    if bsim.batch_fallback:
        kind_line += f" {bsim.batch_fallback}"
    log(f"batch: {bsim.batch_size} lanes {kind_line}")
    cells = 1.0
    for a in bsim.static.mode.active_axes:
        cells *= bsim.cfg.grid_shape[a]
    mcps = cells * bsim.batch_size * bsim.cfg.time_steps \
        / max(wall, 1e-9) / 1e6
    for lane in range(bsim.batch_size):
        verdict = {True: "healthy", False: "NON-FINITE",
                   None: "unmeasured"}[bsim.lane_finite[lane]]
        extra = ""
        if bsim.lane_first_unhealthy_t[lane] is not None:
            extra = (f" (first bad step <= "
                     f"{bsim.lane_first_unhealthy_t[lane]})")
        log(f"batch lane {lane}: {verdict}{extra}")
    bad = [i for i, f in enumerate(bsim.lane_finite) if f is False]
    if bad:
        warn(f"batch: lane(s) {bad} tripped non-finite; the other "
             f"{bsim.batch_size - len(bad)} completed healthy")
    log(f"done: {bsim.batch_size} lanes x {bsim.cfg.time_steps} steps "
        f"in {wall:.2f}s ({mcps:.1f} Mcells/s aggregate, one launch per "
        f"kernel for every lane; set-up {setup:.2f}s)")
    return 0


def write_metrics(rec, save_dir: str) -> None:
    """Append one ``diag.metrics`` record to ``save_dir/metrics.jsonl``
    (the reference's ``--metrics-every`` file)."""
    import json
    import os
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _peek_supervisor_state(cfg, resume: str):
    """-> (supervisor recovery state or None, snapshot path or None).

    The recovery state a previous supervised run persisted into the
    snapshot ``--resume`` will pick (metadata only, no state bytes), so
    a supervised resume re-applies the ladder pins before the
    Simulation is built. ``auto`` takes the first snapshot of the
    restore's own walk (``sim.checkpoint_candidates``, with its horizon
    and metadata guards), so a foreign run's leftover snapshot in the
    same save_dir cannot donate its recovery state."""
    from fdtd3d_torch import io
    from fdtd3d_torch.log import warn
    from fdtd3d_torch.sim import (CKPT_UNUSABLE, checkpoint_candidates,
                                  ckpt_meta_mismatch)
    if resume == "auto":
        cand, meta = next(checkpoint_candidates(
            cfg, cfg.output.save_dir, cfg.time_steps), (None, None))
    else:
        cand = resume
        try:
            meta = io.read_checkpoint_meta(cand)
            reason = ckpt_meta_mismatch(cfg, meta)
        except CKPT_UNUSABLE as exc:
            reason = str(exc)
        if reason:
            warn(f"supervised resume: not adopting recovery state from "
                 f"{cand} ({reason})")
            meta = None
    state = (meta or {}).get("supervisor")
    return state, (cand if state else None)


def _resume(sim, args, cfg, peeked_ckpt) -> None:
    """``--load-checkpoint PATH`` / ``--resume auto|PATH`` into ``sim``
    (``fdtd3d_tpu/cli.py:801-854``): ``auto`` restores the newest
    usable snapshot (``sim.restore_newest``: newest first, skipping
    ones past this run's horizon and ones that fail the guards or the
    integrity checks)."""
    from fdtd3d_torch import io
    from fdtd3d_torch.log import log, warn
    from fdtd3d_torch.sim import restore_newest
    if args.load_checkpoint:
        sim.restore(args.load_checkpoint)
        log(f"restored checkpoint {args.load_checkpoint} at t={sim.t}")
    if not args.resume:
        return
    if args.resume != "auto":
        try:
            sim.restore(args.resume)
        except (io.CheckpointCorrupt, ValueError) as exc:
            raise SystemExit(f"--resume: {exc}")
        log(f"resumed from {args.resume} at t={sim.t}")
        return
    if not io.find_checkpoints(cfg.output.save_dir):
        raise SystemExit(
            f"--resume auto: no committed checkpoint in "
            f"{cfg.output.save_dir!r} (cadence runs write ckpt_tNNNNNN "
            f"snapshots there)")
    cand = restore_newest(sim, cfg.output.save_dir, cfg.time_steps)
    if cand is None:
        raise SystemExit(
            "--resume auto: no usable committed checkpoint (every "
            "candidate was corrupt, incompatible, or past this run's "
            "horizon)")
    log(f"resumed from {cand} at t={sim.t}")
    if peeked_ckpt is not None and cand != peeked_ckpt:
        warn(f"supervisor recovery state was adopted from {peeked_ckpt} "
             f"but the run resumed from {cand}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd_from_file:
        # CLI flags override the command file (parse file first, then argv)
        args = parser.parse_args(read_cmd_file(args.cmd_from_file) + argv)
    check_ported(args)
    if args.save_cmd_to_file:
        save_cmd_file(args, args.save_cmd_to_file)
    if args.batch:
        return _run_batch_cli(parser, args)
    if args.resume and args.load_checkpoint:
        raise SystemExit(
            "--resume and --load-checkpoint are mutually exclusive")
    if args.supervise:
        # the supervisor consumes the finite check: force it on
        args.check_finite = True
    cfg = args_to_config(args)
    if args.dry_run:
        return dry_run(cfg, args.num_devices)
    topo = _check_topology_fits(cfg, args.device,
                                resuming=bool(args.resume
                                              or args.load_checkpoint))
    if max(topo) > 1 and args.supervise:
        _not_ported(f"--supervise on the sharded topology {topo} (the "
                    f"supervisor's topology ladder)", "A11(b)")

    import signal

    import torch

    from fdtd3d_torch import diag, io
    from fdtd3d_torch import telemetry as _telemetry
    from fdtd3d_torch.log import log, set_level, warn
    from fdtd3d_torch.sim import Simulation
    set_level(cfg.output.log_level)
    sup = None  # the supervisor (--supervise); it may replace sim
    peeked_ckpt = None
    if args.supervise:
        # built before the Simulation: a supervised --resume adopts the
        # ladder pins a previous supervised run persisted
        from fdtd3d_torch.supervisor import Supervisor
        resume_state = None
        if args.resume:
            resume_state, peeked_ckpt = _peek_supervisor_state(
                cfg, args.resume)
        sup = Supervisor(cfg=cfg, resume_state=resume_state,
                         device=args.device)
        try:
            cfg = sup.cfg
            sim = sup.ensure_sim()
        except BaseException:
            # the pins adopted above must not leak into the caller
            sup._restore_env()
            raise
    else:
        sim = Simulation(cfg, device=args.device)

    def _current_sim():
        # after a ladder degrade the supervisor's sim replaces the first
        # one: the finalizer closes the live one
        return sup.sim if (sup is not None and sup.sim is not None) \
            else sim

    # SIGTERM/SIGINT end the run through SystemExit (143/130), so the
    # finally below runs on a kill as on any other exit; the previous
    # handlers come back on every exit (library callers must not
    # inherit ours)
    old_handlers = {}
    for sig, code in ((signal.SIGTERM, 143), (signal.SIGINT, 130)):
        try:
            old_handlers[sig] = signal.signal(
                sig, lambda _s, _frm, _c=code: sys.exit(_c))
        except (ValueError, OSError):  # not the main thread
            pass
    try:
        _resume(sim, args, cfg, peeked_ckpt)
        if cfg.output.save_materials:
            io.write_materials(sim)
        dev = sim.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        log(f"fdtd3d-torch: scheme={cfg.scheme} size={cfg.grid_shape} "
            f"steps={cfg.time_steps} dt={cfg.dt:.3e}s device={dev} "
            f"({name})")
        fallback = (sim.step_diag or {}).get("tb_fallback")
        log(f"step_kind={sim.step_kind}"
            + (f" tb_fallback={fallback['reason']}" if fallback else "")
            + (f" topology={sim.topology} shards on "
               f"{[str(d) for d in sim.mesh.devices]}"
               if sim.mesh is not None else ""))

        # the running DFT of the far field, sampled between chunks
        ntff_col, ntff_every, ntff_start = make_ntff_collector(sim, cfg)

        # gcd, not min: chunks must land on every cadence's multiples;
        # the checkpoint cadence is in it, so a resumed run's chunks end
        # where the uninterrupted run's do
        interval = 0
        for v in (cfg.output.save_res, cfg.output.norms_every,
                  cfg.output.checkpoint_every, cfg.output.metrics_every,
                  ntff_every):
            if v:
                interval = math.gcd(interval, v)

        def on_interval(s):
            if ntff_col is not None:
                # a supervised degrade replaces the Simulation: sample
                # the live one (same grid, dt and box)
                ntff_col.sim = s
                if s.t >= ntff_start and s.t % ntff_every == 0:
                    with _telemetry.span("ntff-sample"):
                        ntff_col.sample()
            # metrics before norms: when both cadences land on one step,
            # field_norms reuses the metrics pass (diag's per-step cache)
            if cfg.output.metrics_every and \
                    s.t % cfg.output.metrics_every == 0:
                write_metrics(diag.metrics(s), cfg.output.save_dir)
            if cfg.output.norms_every and s.t % cfg.output.norms_every == 0:
                norms = diag.field_norms(s)
                txt = " ".join(f"{k}={v:.4e}"
                               for k, v in sorted(norms.items()))
                log(f"[t={s.t}] {txt}")
            if cfg.output.save_res and s.t % cfg.output.save_res == 0:
                with _telemetry.span("io-dump"):
                    io.write_outputs(s, s.t)

        # after a restore only the remaining steps run, so the resumed
        # run ends at the same t as the uninterrupted one
        remaining = max(0, cfg.time_steps - sim.t) \
            if (args.load_checkpoint or args.resume) else cfg.time_steps
        t0 = time.time()
        if sup is not None:
            # the supervisor takes the absolute horizon (it tracks its
            # own progress across rollbacks); it owns the sim, so a
            # degrade can release the tripped one before the next rung
            horizon = max(cfg.time_steps, sim.t)
            sim = None
            sim = sup.run(time_steps=horizon,
                          on_interval=on_interval if interval else None,
                          interval=interval)
        else:
            sim.run(time_steps=remaining,
                    on_interval=on_interval if interval else None,
                    interval=interval)
        sim.block_until_ready()
        if ntff_col is not None and ntff_col.n_samples > 0:
            path = write_ntff_pattern(ntff_col, cfg)
            log(f"ntff: {ntff_col.n_samples} samples -> {path}")
        elif ntff_col is not None:
            warn(f"ntff: no samples collected (first sample at step "
                 f"{ntff_start}, every {ntff_every}, run ends at "
                 f"{cfg.time_steps}); no pattern written")
        dt_wall = time.time() - t0
        cells = 1.0
        for a in sim.static.mode.active_axes:
            cells *= cfg.grid_shape[a]
        mcps = cells * remaining / max(dt_wall, 1e-9) / 1e6
        if sim.clock is not None:
            log(f"profile: {sim.clock.report()}")
        if sup is not None and (sup.retries or sup.rollbacks
                                or sup.degrades):
            log(f"supervisor: {sup.retries} retries, {sup.rollbacks} "
                f"rollbacks, {sup.degrades} ladder degrades (now "
                f"{sim.step_kind})")
        log(f"done: {cfg.time_steps} steps in {dt_wall:.2f}s "
            f"({mcps:.1f} Mcells/s)")
        return 0
    finally:
        # every exit ends the recording: the trace file and the sink's
        # run_end record (the live sim may be a ladder replacement)
        cur = _current_sim()
        n_rec = 0
        if cur is not None:
            n_rec = cur.telemetry.n_records \
                if cur.telemetry is not None else 0
            has_sink = cur.telemetry is not None
            cur.close()
        for sig, old in old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        if sup is not None:
            sup._restore_env()  # idempotent; run()'s finally usually did
        if cur is not None and has_sink:
            log(f"telemetry: {n_rec + 1} records -> "
                f"{cfg.output.telemetry_path}")


if __name__ == "__main__":
    sys.exit(main())
