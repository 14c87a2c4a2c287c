"""The port's float32x2 steps against the JAX reference on the CPU.

Both the port's plain ds step (kind ``plain_ds``, the port of the
reference's jnp-ds step) and its packed-ds step (kind
``packed_ds_plain``: the plain versions of the two CUDA launches, with
the per-step record plane terms) are held against the reference's
packed-ds Pallas kernel in interpret mode (``Simulation(...,
use_pallas=True)``, kind ``pallas_packed_ds``). The reference's 3D
jnp-ds step is never run here: with a source it effectively never
finishes on XLA:CPU (tests/test_float32x2.py), and the reference's own
tests hold its kernel against it.

Both sides start from one carry: seeded f64 fields split into
normalised (hi, lo) pairs (numpy), set on the reference and carried across with
fdtd3d_torch.convert. The gates are the reference's packed-ds-vs-jnp-ds
gates (tests/test_pallas_packed_ds.py), on hi AND lo words, relative to
the family's field max: vacuum 1e-12 (the same EFT sequence op for op),
CPML 1e-9 with psi hi/lo at 1e-6 (the slab algebra's summation order
differs at O(eps^2) between the plain step and the kernels), Drude J at
1e-5 (the ADE current is plain f32 by design, so a one-ulp difference
feeds back at f32 scale), oblique TFSF plus a point source at 1e-9.

Two more: the packed-ds step alone on the reference's physics gate
(axis-aligned TFSF, scattered over total < 1e-10), and the port's
float64 plain step against the numpy f64 oracle (tests/oracle.py).
"""

import math

import numpy as np
import pytest
from oracle import run_3d
from torch_parity import to_port

from fdtd3d_torch import convert
from fdtd3d_torch.ops import ds
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

BASE = dict(scheme="3D", size=(16, 16, 16), time_steps=6, dx=1e-3,
            courant_factor=0.4, wavelength=8e-3, dtype="float32x2")
OMEGA = 2.0 * np.pi * 3e8 / BASE["wavelength"]

# case -> (config, field gate, psi gate, J gate)
CASES = {
    "vacuum": (dict(), 1e-12, None, None),
    "cpml": (dict(pml=PmlConfig(size=(3, 3, 3))), 1e-9, 1e-6, None),
    "drude": (dict(pml=PmlConfig(size=(3, 3, 3)),
                   materials=MaterialsConfig(
                       eps=1.5,
                       eps_sphere=SphereConfig(enabled=True,
                                               center=(8, 7, 8), radius=4,
                                               value=3.0),
                       use_drude=True, eps_inf=1.0, omega_p=0.05 * OMEGA,
                       gamma=1e10)), 1e-6, 1e-6, 1e-5),
    "tfsf_point": (dict(pml=PmlConfig(size=(3, 3, 3)),
                        tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                                        angle_teta=30.0, angle_phi=40.0,
                                        angle_psi=15.0),
                        point_source=PointSourceConfig(
                            enabled=True, component="Ez",
                            position=(5, 9, 7))), 1e-9, 1e-6, None),
}


def _seeded_reference(kw, seed):
    """The reference's packed-ds Simulation with seeded fields: f64
    draws split into normalised (hi, lo) pairs."""
    ref = RSim(SimConfig(**BASE, use_pallas=True, **kw))
    assert ref.step_kind == "pallas_packed_ds", ref.step_kind
    rng = np.random.RandomState(seed)
    st = ref.state
    for grp in ("E", "H"):
        for c in st[grp]:
            st[grp][c], st["lo" + grp][c] = ds.from_f64(
                0.01 * rng.standard_normal(st[grp][c].shape))
    ref.state = st
    return ref


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _rel(a, b, scale):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        .max() / (scale + 1e-30)


def _check(want, got, field_tol, psi_tol, j_tol):
    for grp in ("E", "H"):
        scale = max(np.abs(want[grp][c]).max() for c in want[grp])
        for key in (grp, "lo" + grp):
            for c in want[key]:
                r = _rel(want[key][c], got[key][c], scale)
                assert r < field_tol, f"{key}/{c}: rel {r:.2e}"
    for key in ("psi_E", "psi_H", "lopsi_E", "lopsi_H"):
        assert (key in want) == (key in got), key
        for c in want.get(key, {}):
            hi = want[key.replace("lo", "")][c]
            r = _rel(want[key][c], got[key][c], np.abs(hi).max())
            assert r < psi_tol, f"{key}/{c}: rel {r:.2e}"
    for c in want.get("J", {}):
        r = _rel(want["J"][c], got["J"][c], np.abs(want["J"][c]).max())
        assert r < j_tol, f"J/{c}: rel {r:.2e}"
    for k in want.get("inc", {}):
        r = _rel(want["inc"][k], got["inc"][k],
                 np.abs(want["inc"][k.replace("_lo", "")]).max())
        assert r < 1e-12, f"inc/{k}: rel {r:.2e}"
    assert int(want["t"]) == int(got["t"])


@pytest.fixture(scope="module")
def reference_runs():
    """case -> (initial state, final state) of the reference, numpy."""
    out = {}
    for i, (case, (kw, *_)) in enumerate(sorted(CASES.items())):
        ref = _seeded_reference(kw, seed=10 + i)
        init = _np(ref.state)
        ref.run()
        out[case] = (init, _np(ref.state))
    return out


@pytest.mark.parametrize("use_pallas,kind", [(False, "plain_ds"),
                                             (True, "packed_ds_plain")])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ds_step_matches_reference_packed_ds(case, use_pallas, kind,
                                             reference_runs):
    kw, field_tol, psi_tol, j_tol = CASES[case]
    init, want = reference_runs[case]
    port = TSim(to_port(SimConfig(**BASE, use_pallas=use_pallas, **kw)),
                device="cpu")
    assert port.step_kind == kind
    port.state = convert.state_from_reference(init)
    port.run()
    _check(want, convert.state_to_reference(port.state), field_tol,
           psi_tol, j_tol)


def test_packed_ds_tfsf_scattered_clean():
    """The reference's physics gate on the port alone: axis-aligned
    incidence, the scattered region outside the TFSF box clean to the
    mode's floor (an error in the record machinery leaks O(1))."""
    cfg = SimConfig(scheme="3D", size=(24, 24, 24), time_steps=30,
                    dx=1e-3, courant_factor=0.5, wavelength=6e-3,
                    dtype="float32x2", use_pallas=True,
                    pml=PmlConfig(size=(4, 4, 4)),
                    tfsf=TfsfConfig(enabled=True, margin=(4, 4, 4),
                                    angle_teta=90.0, angle_phi=0.0,
                                    angle_psi=180.0))
    sim = TSim(to_port(cfg), device="cpu")
    assert sim.step_kind == "packed_ds_plain"
    sim.run()
    ez = np.asarray(sim.field("Ez"), np.float64)
    tot = np.abs(ez[8:16, 8:16, 8:16]).max()
    sc = np.abs(ez[5:7, 5:19, 5:19]).max()
    assert tot > 1e-3, tot
    assert sc / tot < 1e-10, (sc, tot)


def test_float64_plain_step_matches_numpy_oracle():
    """The port's float64 plain step (vacuum, soft Ez point source, PEC
    walls) against tests/oracle.py::run_3d, f64 numpy. Tolerance 1e-12
    relative to the field max: both are f64, and differ only in the
    order of the curl sums and the phase evaluation of the source."""
    n, steps = 12, 30
    cfg = SimConfig(scheme="3D", size=(n, n, n), time_steps=steps,
                    dx=1e-3, courant_factor=0.5, wavelength=6e-3,
                    dtype="float64",
                    point_source=PointSourceConfig(
                        enabled=True, component="Ez", position=(6, 5, 7)))
    sim = TSim(to_port(cfg), device="cpu")
    assert sim.step_kind == "plain"
    sim.run()
    want = run_3d(n, steps, cfg.dx, cfg.dt, cfg.omega, (6, 5, 7))
    for fam in "EH":
        comps = [c for c in want if c[0] == fam]
        scale = max(np.abs(want[c]).max() for c in comps)
        assert scale > 0
        for c in comps:
            got = sim.field(c)
            assert got.dtype == np.float64
            r = np.abs(got - want[c]).max() / scale
            assert r < 1e-12, f"{c}: rel {r:.2e}"
    assert math.isfinite(scale)
