"""The whole slice on the CPU: the port's CLI on
Examples/vacuum3D_tfsf.txt against the reference CLI on the same flags.

The DAT dumps are read back with the reference's io.load_dat and held at
2e-6 relative to the family's field max (E or H): at normal incidence
the cross-polarised components hold only roundoff, so a per-component
scale would measure noise against noise. The manifest sidecars must be
byte-identical.
"""

import os

import numpy as np
import pytest

from fdtd3d_torch import cli as tcli
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
COMPS = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")


@pytest.mark.parametrize("use_pallas", ["auto", "on"])
def test_cli_dat_dumps_match_reference(tmp_path, capsys, use_pallas):
    flags = ["--cmd-from-file", EXAMPLE, "--same-size", "40",
             "--time-steps", "20", "--save-res", "20", "--norms-every",
             "10", "--check-finite"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert rcli.main(flags + ["--save-dir", str(ref_dir)]) == 0
    assert tcli.main(flags + ["--save-dir", str(port_dir), "--device",
                              "cpu", "--use-pallas", use_pallas]) == 0
    out = capsys.readouterr().out
    kind = "plain" if use_pallas == "auto" else "packed_tb_plain"
    assert f"step_kind={kind}" in out
    assert "[t=20]" in out and "Mcells/s" in out
    got = {c: rio.load_dat(str(port_dir / f"{c}_t000020.dat"))
           for c in COMPS}
    want = {c: rio.load_dat(str(ref_dir / f"{c}_t000020.dat"))
            for c in COMPS}
    for fam in "EH":
        scale = max(np.abs(want[c]).max() for c in COMPS if c[0] == fam)
        for c in COMPS:
            if c[0] != fam:
                continue
            assert got[c].shape == (40, 40, 40) and got[c].dtype == \
                np.float32
            err = np.abs(got[c] - want[c]).max()
            assert err < 2e-6 * scale, f"{c}: {err:.2e} vs {scale:.2e}"
    for c in COMPS:
        name = f"{c}_t000020.dat.manifest.json"
        assert (port_dir / name).read_bytes() == (ref_dir / name)\
            .read_bytes()
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))


@pytest.mark.parametrize("flag,item", [
    (["--checkpoint-backend", "orbax"], "A11"),
    (["--num-processes", "2"], "A11"), (["--metrics", "m.txt"], "A15"),
])
def test_cli_flags_outside_the_slice_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--3d", "--same-size", "16", "--device", "cpu"] + flag)


@pytest.mark.parametrize("paired", [False, True],
                         ids=["native_raises", "paired_runs"])
def test_cli_complex_float32x2(monkeypatch, capsys, paired):
    """``--complex-field-values --dtype float32x2``, which raised A10(b),
    runs as the paired ds legs (on the CPU under the reference's hook
    FDTD3D_FORCE_PAIRED_COMPLEX); without the hook the native complex
    route, which the reference fails on, raises a ValueError naming the
    paired route."""
    argv = ["--3d", "--same-size", "16", "--time-steps", "2", "--device",
            "cpu", "--complex-field-values", "--dtype", "float32x2"]
    monkeypatch.delenv("FDTD3D_FORCE_PAIRED_COMPLEX", raising=False)
    if not paired:
        with pytest.raises(ValueError, match="FDTD3D_FORCE_PAIRED_COMPLEX"):
            tcli.main(argv)
        return
    monkeypatch.setenv("FDTD3D_FORCE_PAIRED_COMPLEX", "1")
    assert tcli.main(argv) == 0
    assert "step_kind=complex2x_plain_ds tb_fallback=paired_complex" \
        in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--metrics-every", "--per-chip-telemetry",
                                  "--profile", "--telemetry"])
def test_cli_observability_flags_run(tmp_path, capsys, flag):
    """The flags of the health and profiling slice run on the CPU and
    leave their output: metrics.jsonl records at each cadence step, the
    per_chip records, the profile line, the telemetry file."""
    import json
    tel = tmp_path / "t.jsonl"
    extra = {"--metrics-every": ["--metrics-every", "2"],
             "--per-chip-telemetry": ["--per-chip-telemetry",
                                      "--telemetry", str(tel)],
             "--profile": ["--profile"],
             "--telemetry": ["--telemetry", str(tel)]}[flag]
    assert tcli.main(["--3d", "--same-size", "16", "--time-steps", "4",
                      "--point-source", "Ez", "--device", "cpu",
                      "--save-dir", str(tmp_path)] + extra) == 0
    out = capsys.readouterr().out
    if flag == "--metrics-every":
        rows = [json.loads(ln) for ln in
                (tmp_path / "metrics.jsonl").read_text().splitlines()]
        assert [r["t"] for r in rows] == [2.0, 4.0]
        assert all(r["energy"] > 0 for r in rows)
    elif flag == "--profile":
        assert "profile: 4 steps in " in out
    else:
        recs = [json.loads(ln) for ln in tel.read_text().splitlines()]
        types = [r["type"] for r in recs]
        assert types[0] == "run_start" and types[-1] == "run_end"
        assert types.count("chunk") == 1
        assert types.count("per_chip") == (flag == "--per-chip-telemetry")
        assert f"telemetry: {len(recs)} records -> {tel}" in out


PRECISION = os.path.join(ROOT, "Examples", "precision3D_float32x2.txt")
# The example's 128^3 cut to 32^3 and its 1000 steps to 20: 32 is the
# smallest width that keeps a TFSF box inside the 8-cell CPML and the
# 6-cell margin (lo 14, hi 17).
PRECISION_CUT = ["--same-size", "32", "--time-steps", "20"]


@pytest.fixture(scope="module")
def precision_reference():
    """The reference's packed-ds kernel (interpret mode) on the cut
    precision example: its fields after 20 steps. The reference CLI is
    not used: on the CPU it would pick the jnp-ds step, which with TFSF
    effectively never finishes there."""
    from fdtd3d_tpu.sim import Simulation
    parser = rcli.build_parser()
    args = parser.parse_args(rcli.read_cmd_file(PRECISION) + PRECISION_CUT
                             + ["--use-pallas", "on"])
    sim = Simulation(rcli.args_to_config(args))
    assert sim.step_kind == "pallas_packed_ds", sim.step_kind
    sim.run()
    return sim.fields()


@pytest.mark.parametrize("use_pallas,kind", [("auto", "plain_ds"),
                                             ("on", "packed_ds_plain")])
def test_cli_precision_example_matches_reference(tmp_path, capsys,
                                                 precision_reference,
                                                 use_pallas, kind):
    """The port's CLI runs Examples/precision3D_float32x2.txt (cut) with
    DAT dumps of the hi words in f32, as the reference writes them, and
    matches the reference's packed-ds fields at 1e-9 of the family max."""
    out_dir = tmp_path / "port"
    assert tcli.main(["--cmd-from-file", PRECISION, *PRECISION_CUT,
                      "--save-res", "20", "--check-finite", "--save-dir",
                      str(out_dir), "--device", "cpu", "--use-pallas",
                      use_pallas]) == 0
    assert f"step_kind={kind}" in capsys.readouterr().out
    want = precision_reference
    for fam in "EH":
        scale = max(np.abs(want[c]).max() for c in COMPS if c[0] == fam)
        assert scale > 0
        for c in COMPS:
            if c[0] != fam:
                continue
            path = str(out_dir / f"{c}_t000020.dat")
            got = rio.load_dat(path)
            assert got.shape == (32, 32, 32) and got.dtype == np.float32
            with open(path + ".manifest.json") as f:
                assert '"dtype": "<f4"' in f.read()
            err = np.abs(got.astype(np.float64) - want[c]).max()
            assert err < 1e-9 * scale, f"{c}: {err:.2e} vs {scale:.2e}"


def test_cli_float64_dumps_f64(tmp_path, capsys):
    """--dtype float64 runs the plain step through main and dumps f64."""
    assert tcli.main(["--cmd-from-file", EXAMPLE, "--same-size", "32",
                      "--time-steps", "6", "--dtype", "float64",
                      "--save-res", "6", "--save-dir", str(tmp_path),
                      "--device", "cpu"]) == 0
    assert "step_kind=plain" in capsys.readouterr().out
    got = rio.load_dat(str(tmp_path / "Ez_t000006.dat"))
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert np.abs(got).max() > 0
