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
    kind = "plain" if use_pallas == "auto" else "packed_plain"
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
    (["--supervise"], "A12"), (["--ntff"], "A8"),
    (["--checkpoint-every", "5"], "A6"), (["--resume", "auto"], "A6"),
    (["--num-processes", "2"], "A11"), (["--telemetry", "x.jsonl"], "A5"),
    (["--save-formats", "dat,txt"], "A7"), (["--batch", "a.txt"], "A13"),
])
def test_cli_flags_outside_the_slice_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--3d", "--same-size", "16", "--device", "cpu"] + flag)
