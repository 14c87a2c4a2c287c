"""The PyTorch port stands alone and fails loudly.

* the 1D/2D modes, the NTFF collector and the TXT/BMP, material and
  command-file writers (through the CLI) load neither jax, fdtd3d_tpu,
  ml_dtypes nor the reference's native I/O library;
* importing fdtd3d_torch and stepping 3D runs on the CPU (f32 and bf16
  plain and temporal-blocked with a packed tail step, the fused and
  two-pass ladder steps, float32x2 plain and packed-ds, float64,
  compensated plain and packed, magnetic Drude K packed in f32 and bf16,
  and a 2-lane batch through fdtd3d_torch.batch) pulls in neither jax, nor
  fdtd3d_tpu, nor ml_dtypes (checked in a subprocess: this test process
  imports jax through tests/conftest.py);
* no CUDA device and no explicit ``cpu`` raises;
* an out-of-scope configuration raises NotImplementedError naming its
  ROADMAP.md item;
* a seeded NaN trips FloatingPointError with the first-bad-step bound;
* the kernel module imports without nvcc, and on the CPU no kernel is
  built or launched.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fdtd3d_torch import SimConfig, Simulation
from fdtd3d_torch.config import (MaterialsConfig, ParallelConfig,
                                 PmlConfig, PointSourceConfig, SphereConfig,
                                 TfsfConfig)
from fdtd3d_torch.ops import build, packed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(scheme="3D", size=(16, 16, 16), time_steps=4,
             pml=PmlConfig(size=(3, 3, 3)),
             tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
             point_source=PointSourceConfig(enabled=True, component="Ez",
                                            position=(8, 8, 8)))

_CHILD = """
import sys
from fdtd3d_torch import SimConfig, Simulation
from fdtd3d_torch.config import PmlConfig, TfsfConfig
for dtype, flag in (("float32", False), ("float32", True),
                    ("bfloat16", False), ("bfloat16", True),
                    ("float32x2", False), ("float32x2", True),
                    ("float64", None)):
    cfg = SimConfig(scheme="3D", size=(16, 16, 16), time_steps=3,
                    pml=PmlConfig(size=(3, 3, 3)), use_pallas=flag,
                    tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
                    dtype=dtype)
    sim = Simulation(cfg, device="cpu")
    sim.run()
    assert sim.t == 3
    if flag and dtype in ("float32", "bfloat16"):
        assert sim.step_kind == "packed_tb_plain", sim.step_kind
        sim.advance(4)
        assert sim.t == 7
    if dtype == "bfloat16":
        sim.field("Ez")
import os
for names, kind in ((("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"),
                     "fused_plain"),
                    (("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"),
                     "pallas3d_plain")):
    os.environ.update({k: "1" for k in names})
    cfg = SimConfig(scheme="3D", size=(16, 16, 16), time_steps=3,
                    pml=PmlConfig(size=(3, 3, 3)), use_pallas=True,
                    tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)))
    sim = Simulation(cfg, device="cpu").run()
    assert sim.step_kind == kind and sim.t == 3, sim.step_kind
    for k in names:
        del os.environ[k]
from fdtd3d_torch.config import MaterialsConfig, SphereConfig
K = MaterialsConfig(use_drude_m=True, mu_inf=1.5, omega_pm=1e11,
                    gamma_m=1e10, drude_m_sphere=SphereConfig(
                        enabled=True, center=(8, 8, 8), radius=3))
for kw, kind in ((dict(compensated=True, use_pallas=False), "plain"),
                 (dict(compensated=True, use_pallas=True), "packed_plain"),
                 (dict(materials=K, use_pallas=True), "packed_plain"),
                 (dict(materials=K, use_pallas=True, dtype="bfloat16"),
                  "packed_plain")):
    cfg = SimConfig(scheme="3D", size=(16, 16, 16), time_steps=3,
                    pml=PmlConfig(size=(3, 3, 3)), **kw)
    sim = Simulation(cfg, device="cpu").run()
    assert sim.step_kind == kind and sim.t == 3, sim.step_kind
import fdtd3d_torch.exact
import fdtd3d_torch.ops.packed_tb
import fdtd3d_torch.ops.pallas3d
import fdtd3d_torch.ops.pallas_fused
from fdtd3d_torch.batch import BatchSimulation
from fdtd3d_torch.config import PointSourceConfig
lanes = [SimConfig(scheme="3D", size=(16, 16, 16), time_steps=3,
                   pml=PmlConfig(size=(3, 3, 3)), use_pallas=True,
                   point_source=PointSourceConfig(
                       enabled=True, component="Ez", position=(8, 8, 8),
                       amplitude=amp)) for amp in (1.0, 2.0)]
bsim = BatchSimulation(lanes, device="cpu").run()
assert bsim.step_kind == "packed_tb_plain", bsim.step_kind
assert bsim.t == 3 and bsim.verify_final_lanes().lane_finite == [True] * 2
import tempfile
from fdtd3d_torch import faults
from fdtd3d_torch.config import OutputConfig
from fdtd3d_torch.supervisor import RetryPolicy, Supervisor
with tempfile.TemporaryDirectory() as d:
    faults.install("nan@t=2; preempt@t=8")
    cfg = SimConfig(scheme="3D", size=(16, 16, 16), time_steps=6,
                    pml=PmlConfig(size=(3, 3, 3)), use_pallas=True,
                    output=OutputConfig(save_dir=d, checkpoint_every=2))
    sup = Supervisor(cfg, device="cpu",
                     policy=RetryPolicy(sleep=lambda _s: None))
    sim = sup.run(interval=2)
    assert sim.t == 6 and sim.step_kind == "packed_plain", sim.step_kind
    faults.clear()
bad = sorted(m for m in sys.modules
             if m in ("jax", "ml_dtypes")
             or m.startswith(("jax.", "ml_dtypes.", "fdtd3d_tpu")))
print("LEAKED" if bad else "CLEAN", bad)
"""


_CHILD_OUTPUTS = """
import sys, tempfile
from fdtd3d_torch import SimConfig, Simulation, cli
from fdtd3d_torch.config import PmlConfig, PointSourceConfig
from fdtd3d_torch.ntff import NtffCollector
for scheme, size in (("1D_EzHy", (40, 1, 1)), ("2D_TEz", (24, 20, 1))):
    cfg = SimConfig(scheme=scheme, size=size, time_steps=5,
                    pml=PmlConfig(size=(4, 4, 0)), use_pallas=True,
                    dtype="float32x2" if scheme == "2D_TEz" else "float32")
    sim = Simulation(cfg, device="cpu").run()
    assert sim.step_kind in ("plain", "plain_ds"), sim.step_kind
cfg = SimConfig(scheme="3D", size=(16, 16, 16), time_steps=0,
                pml=PmlConfig(size=(3, 3, 3)),
                point_source=PointSourceConfig(enabled=True,
                                               position=(8, 8, 8)))
sim = Simulation(cfg, device="cpu")
col = NtffCollector(sim, 3e10)
for _ in range(3):
    sim.advance(2)
    col.sample()
assert col.directivity_pattern([0.0, 90.0], [0.0]).shape == (2, 1)
with tempfile.TemporaryDirectory() as d:
    assert cli.main(["--2d", "TMz", "--same-size", "16", "--time-steps",
                     "4", "--point-source", "Ez", "--save-res", "4",
                     "--save-formats", "dat,txt,bmp", "--save-materials",
                     "--save-cmd-to-file", d + "/cmd.txt", "--save-dir",
                     d, "--device", "cpu"]) == 0
    assert cli.main(["--3d", "--same-size", "16", "--time-steps", "8",
                     "--point-source", "Ez", "--use-pml", "--pml-size",
                     "3", "--ntff", "--ntff-margin", "1", "--save-dir",
                     d, "--device", "cpu"]) == 0
with open("/proc/self/maps") as f:
    native = "libfdtd3d_io" in f.read()
bad = sorted(m for m in sys.modules
             if m in ("jax", "ml_dtypes")
             or m.startswith(("jax.", "ml_dtypes.", "fdtd3d_tpu")))
print("LEAKED" if bad or native else "CLEAN", bad, native)
"""


def test_outputs_and_modes_import_neither_jax_nor_native_io():
    """The 1D/2D modes, the NTFF collector and the TXT/BMP/material and
    command-file writers (through the CLI) pull in neither jax, nor
    fdtd3d_tpu, nor ml_dtypes, and load no native/libfdtd3d_io.so."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD_OUTPUTS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("CLEAN"), proc.stdout


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("CLEAN"), proc.stdout


def test_no_cuda_and_no_explicit_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Simulation(SimConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(SimConfig(**SMALL), device="cuda")
    from fdtd3d_torch import cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--3d", "--same-size", "16"])


_K = MaterialsConfig(use_drude_m=True, mu_inf=1.5, omega_pm=1e11,
                     gamma_m=1e10, drude_m_sphere=SphereConfig(
                         enabled=True, center=(8, 8, 8), radius=3))


@pytest.mark.parametrize("kw,item", [
    (dict(scheme="2D_TMz", size=(16, 16, 1), complex_fields=True,
          dtype="float32x2"), "A10"),
    (dict(dtype="float32x2", materials=_K), r"B4\(b\)"),
    (dict(dtype="float32x2", parallel=ParallelConfig(
        topology="manual", manual_topology=(2, 1, 1))), "A9"),
    (dict(complex_fields=True, dtype="float32x2"), "A10"),
    (dict(compensated=True, parallel=ParallelConfig(
        topology="manual", manual_topology=(2, 1, 1))), "A11"),
])
def test_out_of_scope_config_raises(kw, item):
    cfg = dict(SMALL, **kw)
    if item == r"B4\(b\)":
        # ported: float32x2 with K runs the plain ds step on the CPU
        sim = Simulation(SimConfig(**cfg), device="cpu").run(2)
        assert sim.step_kind == "plain_ds" and "K" in sim.state
        return
    if item == "A9":
        # ported: float32x2 on a topology runs the sharded packed-ds
        # step (B4(c)), its plain versions on the CPU (an x PML that
        # leaves the 8-cell shards room for slab psi)
        cfg["pml"] = PmlConfig(size=(2, 3, 3))
        sim = Simulation(SimConfig(**cfg), device="cpu").run(2)
        assert sim.step_kind == "packed_ds_plain"
        assert sim.mesh is not None and sim.topology == (2, 1, 1)
        return
    if kw.get("complex_fields"):
        # complex float32x2 is ported as paired ds legs (A10(b)); its
        # native route, which the reference fails on, raises a
        # ValueError naming the paired route and ROADMAP A10 (no TFSF:
        # SMALL's incidence has a component along 2D TMz's inactive z)
        cfg["tfsf"] = TfsfConfig()
        with pytest.raises(ValueError, match=item):
            Simulation(SimConfig(**cfg), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        Simulation(SimConfig(**cfg), device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_seeded_nan_trips_with_step_bound(use_pallas):
    from fdtd3d_torch.config import OutputConfig
    cfg = SimConfig(**SMALL, use_pallas=use_pallas,
                    output=OutputConfig(check_finite=True))
    sim = Simulation(cfg, device="cpu")
    sim.advance(2)
    ez = sim.field("Ez")
    ez[5, 6, 7] = np.nan
    sim.set_field("Ez", ez)
    with pytest.raises(FloatingPointError,
                       match=r"first bad step in \(2, 5\]") as exc:
        sim.advance(3)
    assert "Ez" in exc.value.bad_components


def test_kernel_module_needs_no_nvcc_on_cpu():
    """The wrappers take their plain versions for CPU tensors: nothing is
    built, loaded or launched."""
    from fdtd3d_torch.ops import packed_tb
    packed.e_update.launches = packed.h_update.launches = 0
    packed_tb.tb_pass.launches = 0
    sim = Simulation(SimConfig(**SMALL, use_pallas=True), device="cpu")
    sim.run()
    sim.advance(1)
    assert sim.step_kind == "packed_tb_plain"
    assert packed.e_update.launches == packed.h_update.launches == 0
    assert packed_tb.tb_pass.launches == 0
    assert build._LIBS == {}
    assert build.library_path("packed_eh").startswith(
        os.path.join(ROOT, "build", "fdtd3d_torch"))


def test_ds_kernel_module_needs_no_nvcc_on_cpu():
    """The packed-ds wrappers take their plain versions for CPU
    tensors; nothing is built or launched."""
    from fdtd3d_torch.ops import packed_ds
    packed_ds.line_advance.launches = packed_ds.ds_pass.launches = 0
    sim = Simulation(SimConfig(**dict(SMALL, dtype="float32x2"),
                               use_pallas=True), device="cpu")
    sim.run()
    assert sim.step_kind == "packed_ds_plain"
    assert packed_ds.line_advance.launches == packed_ds.ds_pass.launches == 0
    assert build._LIBS == {}


@pytest.mark.parametrize("names,kind", [
    (("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"), "fused_plain"),
    (("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"), "pallas3d_plain"),
])
def test_ladder_kernel_modules_need_no_nvcc_on_cpu(names, kind,
                                                   monkeypatch):
    """The fused and two-pass wrappers take their plain versions for CPU
    tensors; nothing is built or launched."""
    from fdtd3d_torch.ops import pallas3d, pallas_fused
    for k in names:
        monkeypatch.setenv(k, "1")
    pallas3d.e_family.launches = pallas3d.h_family.launches = 0
    pallas_fused.fused_eh.launches = 0
    sim = Simulation(SimConfig(**SMALL, use_pallas=True), device="cpu")
    sim.run()
    assert sim.step_kind == kind
    assert pallas3d.e_family.launches == pallas3d.h_family.launches == 0
    assert pallas_fused.fused_eh.launches == 0
    assert build._LIBS == {}
    for lib in ("family", "fused_eh"):
        assert build.flags(lib)[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
        assert build.library_path(lib).startswith(
            os.path.join(ROOT, "build", "fdtd3d_torch"))
    # the fused pass's halo cells must have their owner's bits in every
    # section kernel, and the two-pass kernels reproduce their plain
    # versions' bits: no FMA contraction in either
    assert build.flags("family") == build.NVCC_FLAGS + ("--fmad=false",)
    assert build.flags("fused_eh") == build.NVCC_FLAGS + ("--fmad=false",)


def test_library_flags_are_per_library_and_hashed(monkeypatch):
    """packed_ds builds without FMA contraction and without fast math;
    packed_eh keeps the common flags; a library's file name changes
    with its flags, not only with its source."""
    assert build.flags("packed_eh") == build.NVCC_FLAGS
    assert build.flags("packed_tb") == build.NVCC_FLAGS
    ds_flags = build.flags("packed_ds")
    assert "--fmad=false" in ds_flags
    assert not any("fast" in f or "ftz=true" in f for f in ds_flags)
    before = build.library_path("packed_ds")
    monkeypatch.setitem(build.LIBRARY_FLAGS, "packed_ds",
                        ("--fmad=true",))
    assert build.library_path("packed_ds") != before
    assert build.library_path("packed_eh") != before


def test_float64_with_the_kernel_forced_raises():
    """float64 has no kernel in either package: forcing the kernel path
    raises instead of running another step."""
    with pytest.raises(NotImplementedError, match="float64"):
        Simulation(SimConfig(**dict(SMALL, dtype="float64"),
                             use_pallas=True), device="cpu")
