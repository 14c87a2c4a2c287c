"""The port's TXT and BMP dumps, ``--save-materials`` and
``--save-cmd-to-file`` against the JAX reference's, on the CPU.

* ``format_e9`` (the vectorised ``%.9e``) against Python's correctly
  rounded format on random, tie, subnormal, huge and non-finite values;
* ``dump_txt``/``load_txt`` and ``dump_bmp``/``load_bmp`` against the
  reference's writers and readers on the same arrays: byte-equal files
  (the reference's native writer and its Python fallback alike), every
  mode's cut;
* the CLI with ``--save-formats dat,txt,bmp --save-materials`` against
  the reference CLI on the same argv: the material files byte-equal,
  the field dumps at 2e-6 of the family max (bf16: its TXT is its
  widened values, within the bf16 gate of the reference's), the BMP
  colours within one level, the file lists equal;
* ``--save-cmd-to-file``: byte-equal to the reference's file, the
  derived NTFF cadence pinned, replaying to the same configuration,
  also under drifted parser defaults.
"""

import os

import numpy as np
import pytest
import torch

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import io as tio
from fdtd3d_tpu import _native
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio


def _e9(v: float) -> bytes:
    if v != v:
        return b"-nan" if np.signbit(v) else b"nan"
    return f"{v:.9e}".encode()


@pytest.mark.parametrize("kind", ["f32", "f32_wide", "f64_wide", "bits",
                                  "edges"])
def test_format_e9_matches_printf(kind):
    rng = np.random.RandomState(11)
    n = 40000
    x = {
        "f32": rng.standard_normal(n).astype(np.float32),
        "f32_wide": (rng.standard_normal(n)
                     * 10.0 ** rng.randint(-44, 38, n)).astype(np.float32),
        "f64_wide": rng.standard_normal(n) * 10.0 ** rng.randint(-320, 308,
                                                                  n),
        "bits": (rng.randint(0, 2 ** 24, n)
                 * 2.0 ** rng.randint(-149, 104, n)).astype(np.float32),
        "edges": np.array(
            [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 2.0 ** -15,
             2.0 ** -16, 1e-45, 5e-324, 1.7976931348623157e308, 1e10,
             9999999999.5, 9999999999.4999, 999999999.5, 0.5, 1.0, 10.0,
             1e-5, 1e100, 1e-100, 123456789.25, 3.0517578125e-05,
             np.float32(3.4028235e38), 1e-310]),
    }[kind]
    got = tio.format_e9(x)
    assert got.shape == (len(x), 17) and got.dtype == np.uint8
    for i, v in enumerate(np.asarray(x, np.float64)):
        row = got[i]
        assert bytes(row[row != 0]) == _e9(float(v)), (i, v)


ARRAYS = {
    "3d_f32": lambda rng: rng.standard_normal((5, 6, 7)).astype(np.float32),
    "2d_f64": lambda rng: rng.standard_normal((9, 8, 1)) * 1e-7,
    "1d_bf16": lambda rng: torch.from_numpy(
        rng.standard_normal((30, 1, 1)).astype(np.float32)).to(
            torch.bfloat16).float().numpy(),
    "zeros_subnormals": lambda rng: np.array(
        [0.0, -0.0, 1e-40, -3e-39, 7.0, 1e30], np.float32).reshape(6, 1, 1),
    "120_rows": lambda rng: rng.uniform(-1, 1, (120, 3, 1)),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_txt_dump_byte_equal_to_reference(name, native, tmp_path,
                                          monkeypatch):
    arr = ARRAYS[name](np.random.RandomState(12))
    if not native:
        # the reference's pure-Python writer and reader
        monkeypatch.setattr(_native, "dump_txt", lambda *a: False)
        monkeypatch.setattr(_native, "load_txt", lambda *a: None)
    want, got = tmp_path / "ref.txt", tmp_path / "port.txt"
    rio.dump_txt(arr, str(want))
    tio.dump_txt(arr, str(got))
    assert got.read_bytes() == want.read_bytes()
    back = tio.load_txt(str(got), arr.shape)
    assert np.array_equal(back, rio.load_txt(str(want), arr.shape))
    assert np.array_equal(back, arr.astype(np.float64)) or \
        np.abs(back - arr).max() <= 1e-9 * np.abs(arr).max()


@pytest.mark.parametrize("kind", ["broadcast", "strided"])
def test_dat_and_txt_of_a_view_equal_reference(kind, tmp_path):
    """A uniform material grid is a broadcast view, a cut a strided one:
    written slice by slice (DAT) and gathered by index (TXT), byte-equal
    to the reference's files."""
    arr = np.broadcast_to(np.asarray(2.5), (6, 7, 8)) if kind == \
        "broadcast" else np.random.RandomState(16).rand(8, 9, 10)[:, ::2]
    for ext, port, ref in (("dat", tio.dump_dat, rio.dump_dat),
                           ("txt", tio.dump_txt, rio.dump_txt)):
        port(arr, str(tmp_path / f"port.{ext}"))
        ref(arr, str(tmp_path / f"ref.{ext}"))
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"ref.{ext}").read_bytes()


def test_txt_dump_spans_chunks(tmp_path, monkeypatch):
    """A dump larger than one formatting chunk equals the reference's."""
    monkeypatch.setattr(tio, "_TXT_CHUNK", 1000)
    arr = np.random.RandomState(13).standard_normal((17, 19, 13)).astype(
        np.float32)
    rio.dump_txt(arr, str(tmp_path / "ref.txt"))
    tio.dump_txt(arr, str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()


@pytest.mark.parametrize("shape,axes", [
    ((6, 7, 5), (0, 1, 2)), ((9, 11, 1), (0, 1)), ((1, 10, 13), (1, 2)),
    ((7, 1, 9), (0, 2)), ((21, 1, 1), (0,)), ((1, 1, 17), (2,)),
    ((5, 5, 5), (1, 0))])
def test_bmp_dump_byte_equal_to_reference(shape, axes, tmp_path):
    arr = np.random.RandomState(14).standard_normal(shape).astype(
        np.float32)
    want, got = tmp_path / "ref.bmp", tmp_path / "port.bmp"
    rio.dump_bmp(arr, str(want), axes)
    tio.dump_bmp(arr, str(got), axes)
    assert got.read_bytes() == want.read_bytes()
    assert np.array_equal(tio.load_bmp(str(got)), rio.load_bmp(str(want)))


def test_bmp_reader_matches_reference(tmp_path):
    rgb = np.random.RandomState(15).randint(0, 256, (7, 5, 3)).astype(
        np.uint8)
    data = tio.bmp_encode(rgb)
    assert data == rio._bmp_encode(rgb)
    path = tmp_path / "a.bmp"
    path.write_bytes(data)
    assert np.array_equal(tio.load_bmp(str(path)), rgb)
    # top-down rows (negative height)
    h, w = rgb.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    body = data[54:]
    rows = [body[y * stride:(y + 1) * stride] for y in range(h)][::-1]
    flipped = bytearray(data[:54] + b"".join(rows))
    flipped[22:26] = (-h).to_bytes(4, "little", signed=True)
    path.write_bytes(bytes(flipped))
    assert np.array_equal(tio.load_bmp(str(path)), rgb)
    assert np.array_equal(tio.load_bmp_gray(str(path)),
                          rio.load_bmp_gray(str(path)))
    path.write_bytes(data[:80])
    with pytest.raises(ValueError, match="truncated"):
        tio.load_bmp(str(path))
    path.write_bytes(b"XX" + data[2:])
    with pytest.raises(ValueError, match="not a BMP"):
        tio.load_bmp(str(path))


def _dump_argv(dtype):
    return ["--2d", "TMz", "--sizex", "28", "--sizey", "24", "--sizez",
            "1", "--time-steps", "30", "--use-pml", "--pml-size", "4",
            "--point-source", "Ez", "--eps-sphere", "3.0",
            "--eps-sphere-center-x", "14", "--eps-sphere-center-y", "12",
            "--eps-sphere-radius", "5", "--use-drude", "--omega-p", "1e11",
            "--drude-sphere-center-x", "10", "--drude-sphere-center-y",
            "10", "--drude-sphere-radius", "3", "--save-res", "30",
            "--save-formats", "dat,txt,bmp", "--save-materials",
            "--dtype", dtype]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2e-2)])
def test_cli_dumps_and_materials_match_reference(dtype, tol, tmp_path):
    argv = _dump_argv(dtype)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert rcli.main(argv + ["--save-dir", str(ref_dir)]) == 0
    assert tcli.main(argv + ["--save-dir", str(port_dir), "--device",
                             "cpu"]) == 0
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    materials = [n for n in names if not n.startswith(("E", "H"))]
    assert "eps_Ez.txt" in materials and "omega_p_Ez.bmp" in materials
    for n in materials:
        assert (port_dir / n).read_bytes() == (ref_dir / n).read_bytes(), n
    comps = ("Ez", "Hx", "Hy")
    shape = (28, 24, 1)
    fields = {c: (rio.load_txt(str(ref_dir / f"{c}_t000030.txt"), shape),
                  tio.load_txt(str(port_dir / f"{c}_t000030.txt"), shape))
              for c in comps}
    for fam in "EH":
        members = [c for c in comps if c[0] == fam]
        scale = max(np.abs(fields[c][0]).max() for c in members)
        for c in members:
            err = np.abs(fields[c][0] - fields[c][1]).max()
            assert err <= tol * scale, f"{c}: {err:.2e} vs {scale:.2e}"
    for c in comps:
        base = f"{c}_t000030"
        assert (port_dir / f"{base}.dat.manifest.json").read_bytes() == \
            (ref_dir / f"{base}.dat.manifest.json").read_bytes()
        # the TXT dump is the dumped field's values, widened exactly
        values = tio.load_dat(str(port_dir / f"{base}.dat"))
        tio.dump_txt(values, str(tmp_path / "again.txt"))
        assert (tmp_path / "again.txt").read_bytes() == \
            (port_dir / f"{base}.txt").read_bytes()
        a = tio.load_bmp(str(port_dir / f"{base}.bmp")).astype(int)
        b = rio.load_bmp(str(ref_dir / f"{base}.bmp")).astype(int)
        levels = 1 if dtype == "float32" else 8
        assert np.abs(a - b).max() <= levels, c


def test_one_dimensional_dumps_match_reference(tmp_path):
    argv = ["--cmd-from-file", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "Examples", "drude1D_metal.txt"), "--time-steps", "40",
        "--norms-every", "40", "--save-res", "40", "--dtype", "float64",
        "--save-formats", "txt,bmp", "--save-materials"]
    assert rcli.main(argv + ["--save-dir", str(tmp_path / "ref")]) == 0
    assert tcli.main(argv + ["--save-dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert not any(n.endswith(".dat") for n in names)
    for n in names:
        want = (tmp_path / "ref" / n).read_bytes()
        got = (tmp_path / "port" / n).read_bytes()
        if n.startswith(("E", "H")) and n.endswith(".txt"):
            w = rio.load_txt(str(tmp_path / "ref" / n), (160, 1, 1))
            g = tio.load_txt(str(tmp_path / "port" / n), (160, 1, 1))
            assert np.abs(w - g).max() <= 1e-12 * np.abs(w).max(), n
        elif n.startswith(("E", "H")):
            assert len(got) == len(want) and got[:54] == want[:54], n
        else:
            assert got == want, n


NTFF_ARGV = ["--3d", "--same-size", "48", "--time-steps", "123",
             "--courant-factor", "0.4", "--wavelength", "15e-3",
             "--use-pml", "--pml-size", "6", "--ntff", "--point-source",
             "Ez", "--save-formats", "dat,txt"]


def test_save_cmd_file_equals_reference_and_pins_ntff(tmp_path):
    want, got = tmp_path / "ref.txt", tmp_path / "port.txt"
    rcli.save_cmd_file(rcli.build_parser().parse_args(NTFF_ARGV), str(want))
    tcli.save_cmd_file(tcli.build_parser().parse_args(NTFF_ARGV), str(got))
    assert got.read_bytes() == want.read_bytes()
    parser = tcli.build_parser()
    cfg = tcli.args_to_config(parser.parse_args(NTFF_ARGV))
    replayed = tcli.args_to_config(parser.parse_args(
        tcli.read_cmd_file(str(got))))
    freq, every, start = tcli.resolve_ntff_cadence(cfg)
    assert (replayed.ntff.frequency, replayed.ntff.every,
            replayed.ntff.start) == (freq, every, start)
    assert (freq, every, start) == rcli.resolve_ntff_cadence(
        rcli.args_to_config(rcli.build_parser().parse_args(NTFF_ARGV)))
    assert start % every == 0 and start >= cfg.time_steps // 2
    # all else equal: the pinned cadence resolves to itself
    import dataclasses
    assert dataclasses.replace(replayed, ntff=cfg.ntff) == cfg
    assert "--device" not in got.read_text()


def test_save_cmd_file_survives_default_drift(tmp_path):
    out = str(tmp_path / "cmd.txt")
    argv = ["--3d", "--same-size", "32", "--use-pml"]
    parser = tcli.build_parser()
    tcli.save_cmd_file(parser.parse_args(argv), out)
    direct = tcli.args_to_config(parser.parse_args(argv))
    drifted = tcli.build_parser()
    drifted.set_defaults(pml_size=4, courant_factor=0.9, time_steps=7,
                         dtype="bfloat16", use_tfsf=True, compensated=True)
    assert tcli.args_to_config(drifted.parse_args(
        tcli.read_cmd_file(out))) == direct


def test_cli_save_cmd_to_file_replays(tmp_path, capsys):
    saved = tmp_path / "cmd.txt"
    argv = ["--2d", "TMz", "--same-size", "24", "--time-steps", "12",
            "--point-source", "Ez", "--norms-every", "12"]
    assert tcli.main(argv + ["--save-cmd-to-file", str(saved),
                             "--save-dir", str(tmp_path / "a"),
                             "--device", "cpu"]) == 0
    first = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[t=12]")]
    assert tcli.main(["--cmd-from-file", str(saved), "--device",
                      "cpu"]) == 0
    again = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[t=12]")]
    assert first and first == again
