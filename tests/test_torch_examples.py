"""Every Examples/*.txt through the port's CLI on the CPU, against the
reference CLI on the same argv.

Each command file is replayed with tests/test_examples.py's overrides
(its CASES: the 3D configurations cut to 24-32^3 and 40-60 steps, the
1D/2D ones as they stand), plus a DAT dump at the last step. The printed
norms must agree to the last printed digit (``%.4e``: one unit in 1e4 of
the family's largest norm), the DAT dumps at 2e-6 of the family max
(E or H; float32x2 dumps its hi words, the reference's packed-ds kernel
runs on both sides at its 1e-9 gate), and the file lists and manifests
must be equal. Over 1000 steps and more (drude1D_metal,
metamaterial1D_dng) two f32 runs drift apart by their roundoff, as each
drifts from float64 (drude1D_metal at 1000 steps: 2.1e-6 between the
packages, 2.3e-6 from the reference's f32 run to its f64 run); there the
gate is the larger of 2e-6 and twice the reference's own f32-to-f64
distance, measured by a third run in float64.
``test_every_example_has_a_case`` keeps the set whole.
"""

import glob
import os
import re

import numpy as np
import pytest
from test_examples import CASES

from fdtd3d_torch import cli as tcli
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "Examples")
TOL = {"precision3D_float32x2.txt": 1e-9}


def test_every_example_has_a_case():
    files = {os.path.basename(p)
             for p in glob.glob(os.path.join(EXAMPLES, "*.txt"))}
    assert files == set(CASES)


def _norms(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("[t=")]
    assert lines, out
    return lines[-1].split()[0], {
        k: float(v) for k, v in re.findall(r"([EH][xyz])=([\d.e+-]+)",
                                           lines[-1])}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_matches_reference_cli(name, tmp_path, capsys):
    overrides = CASES[name][0]
    argv = ["--cmd-from-file", os.path.join(EXAMPLES, name)] + overrides
    args = rcli.build_parser().parse_args(
        rcli.read_cmd_file(os.path.join(EXAMPLES, name)) + overrides)
    steps = args.time_steps
    argv += ["--save-res", str(steps)]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert rcli.main(argv + ["--save-dir", str(ref_dir)]) == 0
    ref_out = capsys.readouterr().out
    assert tcli.main(argv + ["--save-dir", str(port_dir), "--device",
                             "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert "NotImplementedError" not in port_out
    t_ref, want = _norms(ref_out)
    t_port, got = _norms(port_out)
    assert t_ref == t_port and set(want) == set(got)
    for c, v in want.items():
        # a cross-polarised component holds only roundoff: its norm is
        # held to the family's largest, like the fields
        scale = max(w for k, w in want.items() if k[0] == c[0])
        assert abs(got[c] - v) <= 1e-4 * scale, \
            f"{c}: {got[c]:.4e} vs {v:.4e}"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    comps = sorted(want)
    fields = {}
    for c in comps:
        base = f"{c}_t{steps:06d}.dat"
        assert (port_dir / (base + ".manifest.json")).read_bytes() == \
            (ref_dir / (base + ".manifest.json")).read_bytes()
        fields[c] = (rio.load_dat(str(ref_dir / base)).astype(np.float64),
                     rio.load_dat(str(port_dir / base)).astype(np.float64))
    tol = {fam: TOL.get(name, 2e-6) for fam in "EH"}
    if steps >= 1000 and args.dtype == "float32":
        f64_dir = tmp_path / "ref64"
        assert rcli.main(argv + ["--save-dir", str(f64_dir), "--dtype",
                                 "float64"]) == 0
        f64 = {c: rio.load_dat(str(f64_dir / f"{c}_t{steps:06d}.dat"))
               for c in comps}
        for fam in "EH":
            members = [c for c in comps if c[0] == fam]
            scale = max(np.abs(f64[c]).max() for c in members)
            drift = max(np.abs(fields[c][0] - f64[c]).max()
                        for c in members) / scale
            tol[fam] = max(tol[fam], 2.0 * drift)
    for fam in "EH":
        members = [c for c in comps if c[0] == fam]
        scale = max(np.abs(fields[c][0]).max() for c in members)
        assert scale > 0, fam
        for c in members:
            err = np.abs(fields[c][0] - fields[c][1]).max()
            assert err <= tol[fam] * scale, \
                f"{c}: {err:.2e} vs {scale:.2e} (gate {tol[fam]:.2e})"
