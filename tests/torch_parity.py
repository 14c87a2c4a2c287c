"""Shared helpers of the tests that hold the PyTorch port
(``fdtd3d_torch``) against the JAX reference (``fdtd3d_tpu``) on the CPU.

Both packages get the same configuration (the port's dataclasses are
rebuilt from ``dataclasses.asdict`` of the reference's), the same seeded
fields (made with numpy, carried across with ``fdtd3d_torch.convert``),
and are compared in the reference's unpacked state form. The tolerance
is the reference's own kernel-vs-jnp gate: max |diff| over max |ref|
below 2e-6 in f32 (tests/test_pallas_packed.py), per state leaf.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from fdtd3d_torch import config as tconfig
from fdtd3d_torch import convert
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

TOL = 2e-6
BASE = dict(scheme="3D", size=(16, 16, 16), time_steps=8, dx=1e-3,
            courant_factor=0.4, wavelength=8e-3)

# The parametrised set of the parity tests: vacuum, xyz CPML, oblique
# TFSF, point source, Drude + sphere material grid, and the kitchen sink
# of tests/test_pallas_packed.py:92-106.
CASES = {
    "vacuum": dict(),
    "xyz_cpml": dict(pml=PmlConfig(size=(3, 3, 3))),
    "oblique_tfsf": dict(
        pml=PmlConfig(size=(3, 3, 3)),
        tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2), angle_teta=30.0,
                        angle_phi=40.0, angle_psi=15.0)),
    "point_source": dict(
        pml=PmlConfig(size=(3, 3, 3)),
        point_source=PointSourceConfig(enabled=True, component="Ey",
                                       position=(7, 8, 9))),
    "drude_sphere": dict(
        pml=PmlConfig(size=(0, 3, 3)),
        materials=MaterialsConfig(
            eps=1.5,
            eps_sphere=SphereConfig(enabled=True, center=(8, 7, 8),
                                    radius=5, value=3.0),
            use_drude=True, eps_inf=2.0, omega_p=2e11, gamma=1e10,
            drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8),
                                      radius=3))),
    "kitchen_sink": dict(
        pml=PmlConfig(size=(3, 3, 3)),
        tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(5, 9, 7)),
        materials=MaterialsConfig(
            eps=2.0,
            eps_sphere=SphereConfig(enabled=True, center=(8, 8, 8),
                                    radius=4, value=6.0),
            use_drude=True, eps_inf=1.5, omega_p=1e11, gamma=1e10,
            drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8),
                                      radius=3))),
}


# Compensated (Kahan) float32 and magnetic Drude K: the configurations
# whose dispatch differs (tests/test_torch_compensated.py and
# tests/test_torch_drude_m.py hold their numbers): compensated with a
# point source (the packed step), compensated with coefficient grids
# (the reference declines its packed kernel: the plain step), and a K
# sphere (tests/test_pallas_packed.py:277's materials) with CPML and
# TFSF. Compensated runs are float32 only.
K_SPHERE = MaterialsConfig(
    use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
    drude_m_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3))
MODE_CASES = {
    "compensated_point": dict(CASES["point_source"], compensated=True),
    "compensated_grid": dict(CASES["kitchen_sink"], compensated=True),
    "k_sphere": dict(pml=PmlConfig(size=(3, 3, 3)),
                     tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
                     materials=K_SPHERE),
}


def ref_config(case: str, **kw) -> SimConfig:
    kw = dict(CASES[case] if case in CASES else MODE_CASES[case], **kw)
    return SimConfig(**BASE, **kw)


def to_port(obj):
    """A reference config dataclass -> the port's, field by field."""
    cls = getattr(tconfig, type(obj).__name__)
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = to_port(v)
        kw[f.name] = v
    return cls(**kw)


def seed_reference(sim: RSim, seed: int) -> None:
    """Seeded random E/H (numpy), as tests/test_pallas_packed.py seeds."""
    rng = np.random.RandomState(seed)
    for grp in ("E", "H"):
        for c in list(sim.state[grp]):
            shape = sim.state[grp][c].shape
            sim.set_field(c, 0.01 * rng.standard_normal(shape)
                          .astype(np.float32))


def np_state(sim: RSim):
    return jax.tree.map(np.asarray, sim.state)


def run_pair(ref_cfg: SimConfig, seed: int = 0, steps: int = None):
    """Run the reference and the port from the same seeded state; return
    (reference final state, port final state) as numpy dicts and the two
    simulations."""
    ref = RSim(ref_cfg)
    seed_reference(ref, seed)
    port = TSim(to_port(ref_cfg), device="cpu")
    port.state = convert.state_from_reference(np_state(ref))
    n = ref_cfg.time_steps if steps is None else steps
    ref.advance(n)
    port.advance(n)
    return (np_state(ref), convert.state_to_reference(port.state),
            ref, port)


def assert_state_close(want, got, tol: float = TOL, path: str = ""):
    """Every leaf of the reference's unpacked state, held at ``tol``
    relative to the leaf's max (the reference's gate)."""
    assert set(want) == set(got), f"{path}: keys {set(want)} != {set(got)}"
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, dict):
            assert_state_close(a, b, tol, f"{path}/{k}")
            continue
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, f"{path}/{k}: {a.shape} != {b.shape}"
        if k == "t":
            assert int(a) == int(b)
            continue
        scale = np.abs(a).max()
        err = np.abs(a.astype(np.float64) - b).max()
        rel = err / scale if scale > 0 else err
        assert rel < tol, f"{path}/{k}: rel {rel:.2e} (max {scale:.2e})"


# the reference's ds gates (tests/test_pallas_packed_ds.py:263-285): E and
# H (hi and lo words) against the family's max, psi pairs against the psi
# max, the ADE currents J and K against their own max, the incident line
DS_GATES = {"field": 1e-6, "psi": 1e-6, "ade": 1e-5, "line": 1e-12}


def assert_ds_state_close(want, got, gates=None):
    """Every leaf of the unpacked float32x2 state within its ds gate
    (``DS_GATES`` unless ``gates`` overrides some): a lo word is held
    to its family's (or its psi's) hi max, since the pair's value is hi
    + lo and a lo word alone is roundoff."""
    g = dict(DS_GATES, **(gates or {}))
    assert set(want) == set(got), f"keys {set(want)} != {set(got)}"

    def rel(a, b, scale):
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max()
                     / (scale + 1e-30))

    for grp in ("E", "H"):
        scale = max(np.abs(want[grp][c]).max() for c in want[grp])
        for key in (grp, "lo" + grp):
            for c in want[key]:
                r = rel(want[key][c], got[key][c], scale)
                assert r < g["field"], f"{key}/{c}: rel {r:.2e}"
    for key in ("psi_E", "psi_H", "lopsi_E", "lopsi_H"):
        assert (key in want) == (key in got), key
        for c in want.get(key, {}):
            hi = want[key.replace("lo", "")][c]
            r = rel(want[key][c], got[key][c], np.abs(hi).max())
            assert r < g["psi"], f"{key}/{c}: rel {r:.2e}"
    for grp in ("J", "K"):
        for c in want.get(grp, {}):
            r = rel(want[grp][c], got[grp][c], np.abs(want[grp][c]).max())
            assert r < g["ade"], f"{grp}/{c}: rel {r:.2e}"
    for k in want.get("inc", {}):
        r = rel(want["inc"][k], got["inc"][k],
                np.abs(want["inc"][k.replace("_lo", "")]).max())
        assert r < g["line"], f"inc/{k}: rel {r:.2e}"
    assert int(want["t"]) == int(got["t"])
