"""The PyTorch port's configuration and CLI front half against the
reference's: every Examples/*.txt command file parses to an equal
SimConfig in both packages, and the port names what it does not run."""

import dataclasses
import glob
import os

import pytest

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.config import ParallelConfig
from fdtd3d_tpu import cli as rcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "Examples", "*.txt")))


def _cfg(cli_mod, argv):
    return cli_mod.args_to_config(cli_mod.build_parser().parse_args(argv))


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_config_equals_reference(path):
    argv = rcli.read_cmd_file(path)
    assert tcli.read_cmd_file(path) == argv
    assert dataclasses.asdict(_cfg(tcli, argv)) \
        == dataclasses.asdict(_cfg(rcli, argv))


def test_parser_keeps_every_reference_flag():
    """Every option string of the reference parser exists in the port's
    with the same default (the port adds --device only)."""
    ref = {o: a for a in rcli.build_parser()._actions
           for o in a.option_strings}
    port = {o: a for a in tcli.build_parser()._actions
            for o in a.option_strings}
    assert set(port) - set(ref) == {"--device"}
    assert set(ref) <= set(port)
    for opt, act in ref.items():
        assert port[opt].default == act.default, opt


@pytest.mark.parametrize("argv", [
    ["--3d", "--same-size", "24", "--use-pml", "--pml-sizex", "3",
     "--pml-sizez", "5", "--use-tfsf", "--angle-teta", "30",
     "--angle-phi", "40", "--angle-psi", "15", "--tfsf-waveform",
     "gauss_pulse"],
    ["--3d", "--sizex", "20", "--sizey", "24", "--sizez", "28",
     "--point-source", "Ey", "--point-source-y", "3",
     "--point-source-waveform", "ricker", "--use-drude", "--omega-p",
     "1e11", "--gamma-d", "1e10", "--drude-sphere-radius", "4",
     "--eps-sphere", "3.0", "--eps-sphere-radius", "5"],
])
def test_flag_combinations_equal_reference(argv):
    assert dataclasses.asdict(_cfg(tcli, argv)) \
        == dataclasses.asdict(_cfg(rcli, argv))


@pytest.mark.parametrize("name,item", [
    ("vacuum1D_ezhy.txt", "A10"), ("vacuum2D_tmz.txt", "A10"),
    ("precision3D_compensated.txt", "A11"),
    ("precision3D_float32x2.txt", "A9"),
    ("metamaterial1D_dng.txt", "A10")])
def test_out_of_scope_examples_name_their_roadmap_item(name, item):
    cfg = _cfg(tcli, tcli.read_cmd_file(os.path.join(ROOT, "Examples",
                                                     name)))
    if cfg.dtype == "float32x2" or cfg.compensated:
        # the float32x2 and compensated steps are ported, on a topology
        # too (A11(a); float32x2's sharded packed-ds step, B4(c))
        cfg = dataclasses.replace(cfg, parallel=ParallelConfig(
            topology="manual", manual_topology=(2, 1, 1)))
        assert tsolver.build_static(cfg).topology == (2, 1, 1)
        return
    else:
        # the 1D/2D modes and complex fields are ported, complex fields
        # with float32x2 too (A10(b)), as the paired ds legs only: the
        # native complex float32x2 route, which the reference fails on,
        # raises a ValueError naming the paired route (ROADMAP A10)
        cfg = dataclasses.replace(cfg, complex_fields=True,
                                  dtype="float32x2")
        static = tsolver.build_static(cfg)
        assert not static.paired_complex
        with pytest.raises(ValueError, match=item):
            tsolver.make_step(static, "cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        tsolver.build_static(cfg)


@pytest.mark.parametrize("name", ["vacuum3D_tfsf.txt", "sphere3D_mie.txt",
                                  "drude3D_nanoantenna.txt",
                                  "precision3D_float32x2.txt",
                                  "precision3D_compensated.txt",
                                  "vacuum1D_ezhy.txt", "vacuum2D_tmz.txt",
                                  "drude1D_metal.txt",
                                  "metamaterial1D_dng.txt"])
def test_in_scope_examples_pass_the_scope_check(name):
    cfg = _cfg(tcli, tcli.read_cmd_file(os.path.join(ROOT, "Examples",
                                                     name)))
    tsolver.check_scope(cfg)
