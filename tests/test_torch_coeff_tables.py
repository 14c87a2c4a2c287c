"""The port's material coefficients, built on per-label tables, against
the reference's full-grid build, key for key and bit for bit, on the
CPU: every combination of a medium sphere, a Drude plasma (in a sphere
or everywhere) and a loss, on the E and H sides, in float32, compensated
float32 and float32x2, and a material file (the full-grid path)."""

import numpy as np
import pytest
from torch_parity import BASE, to_port

from fdtd3d_torch import materials as tmaterials
from fdtd3d_torch import solver as tsolver
from fdtd3d_tpu import solver as rsolver
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig, SimConfig,
                               SphereConfig)

EPS_SPHERE = SphereConfig(enabled=True, center=(8, 7, 8), radius=5,
                          value=3.0)
MU_SPHERE = SphereConfig(enabled=True, center=(7, 8, 9), radius=4,
                         value=2.5)
PLASMA = SphereConfig(enabled=True, center=(9, 8, 8), radius=3)

MATERIALS = {
    "eps_sphere": dict(eps=1.5, eps_sphere=EPS_SPHERE),
    "mu_sphere_lossy": dict(mu=1.2, mu_sphere=MU_SPHERE, sigma_m=3e2,
                            sigma_e=0.02),
    "plasma_sphere_only": dict(use_drude=True, eps_inf=2.0, omega_p=2e11,
                               gamma=1e10, drude_sphere=PLASMA),
    "uniform_plasma_over_sphere": dict(eps_sphere=EPS_SPHERE,
                                       use_drude=True, eps_inf=2.0,
                                       omega_p=2e11, gamma=1e10),
    "both_sides": dict(eps=1.5, eps_sphere=EPS_SPHERE, mu_sphere=MU_SPHERE,
                       sigma_e=0.01, use_drude=True, eps_inf=2.0,
                       omega_p=2e11, gamma=1e10, drude_sphere=PLASMA,
                       use_drude_m=True, mu_inf=1.5, omega_pm=1e11,
                       gamma_m=1e10, drude_m_sphere=MU_SPHERE),
    "uniform_k_over_mu_sphere": dict(mu_sphere=MU_SPHERE, use_drude_m=True,
                                     mu_inf=1.5, omega_pm=1e11,
                                     gamma_m=1e10),
}
MODES = {"float32": dict(), "compensated": dict(compensated=True),
         "float32x2": dict(dtype="float32x2")}


def _assert_same(want, got):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        assert np.shape(got[k]) == np.shape(v), k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(MATERIALS))
def test_coefficient_tables_equal_the_reference(case, mode):
    cfg = SimConfig(**BASE, pml=PmlConfig(size=(0, 3, 3)),
                    materials=MaterialsConfig(**MATERIALS[case]),
                    **MODES[mode])
    _assert_same(rsolver.build_coeffs(rsolver.build_static(cfg)),
                 tsolver.build_coeffs(tsolver.build_static(to_port(cfg))))


def test_coefficient_tables_on_threads_equal_the_reference():
    """A grid of more than 2**20 cells: labels and gathers run on slices
    of planes, each on a thread."""
    cfg = SimConfig(**dict(BASE, size=(104, 104, 104)),
                    pml=PmlConfig(size=(0, 3, 3)),
                    materials=MaterialsConfig(**dict(
                        MATERIALS["both_sides"],
                        eps_sphere=SphereConfig(enabled=True,
                                                center=(52, 40, 60),
                                                radius=30, value=3.0),
                        drude_m_sphere=SphereConfig(enabled=True,
                                                    center=(50, 52, 47),
                                                    radius=21))),
                    dtype="float32x2")
    _assert_same(rsolver.build_coeffs(rsolver.build_static(cfg)),
                 tsolver.build_coeffs(tsolver.build_static(to_port(cfg))))


def test_material_file_takes_the_full_grid_path(tmp_path):
    """An eps file with a Drude sphere on the E side (the grids as the
    reference builds them) beside a mu sphere on the H side (tables)."""
    eps = 1.0 + np.random.default_rng(3).random((16, 16, 16))
    path = str(tmp_path / "eps.npy")
    np.save(path, eps)
    cfg = SimConfig(**BASE, materials=MaterialsConfig(
        eps_file=path, mu_sphere=MU_SPHERE, use_drude=True, eps_inf=2.0,
        omega_p=2e11, gamma=1e10, drude_sphere=PLASMA), dtype="float32x2")
    _assert_same(rsolver.build_coeffs(rsolver.build_static(cfg)),
                 tsolver.build_coeffs(tsolver.build_static(to_port(cfg))))


def test_sphere_labels_hold_each_spheres_bit():
    shape = (16, 16, 16)
    label = tmaterials.sphere_labels("Ez", shape, (0, 1, 2),
                                     (EPS_SPHERE, None, PLASMA))
    assert label.dtype == np.uint8 and label.shape == shape
    for b, sphere in ((0, EPS_SPHERE), (2, PLASMA)):
        np.testing.assert_array_equal(
            (label >> b) & 1 == 1,
            tmaterials._sphere_mask("Ez", shape, (0, 1, 2), sphere))
    assert not ((label >> 1) & 1).any()
    assert tmaterials.sphere_labels("Ez", shape, (0, 1, 2),
                                    (None, SphereConfig())) is None
