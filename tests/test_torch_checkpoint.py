"""npz checkpoints of the PyTorch port against the JAX reference's, on the
CPU.

* Format: for the same state (seeded with numpy, carried across with
  fdtd3d_torch.convert) the port's and the reference's checkpoints carry
  equal ``_manifest`` and ``_checksum`` and the same run metadata, in
  f32, bf16, float32x2, compensated f32, and with Drude J and magnetic
  Drude K.
* Cross-restore: each package's ``load_checkpoint`` passes on the
  other's file; each restores the other's snapshot bit for bit, and the
  restored runs go on N steps to fields within 2e-6 (bf16 2e-2) of the
  family max of the other package's run from the same state.
* Bit-equal resume: a port run restored from its own cadence snapshot
  equals the uninterrupted run bit for bit with the same chunk
  boundaries (tests/test_io.py:196), on the temporal-blocked schedule
  with an odd chunk length (a packed tail step every chunk) too, and
  also when restored into a sim that has already run.
* The guards (scheme, size, dtype, carry family) give the reference's
  messages; truncation, zeroed bytes and a manifest mismatch raise the
  port's CheckpointCorrupt; discovery and keep-K rotation agree with the
  reference's.
"""

import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_parity import BASE, K_SPHERE, np_state, to_port

from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch import sim as tsim_mod
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu import io as rio
from fdtd3d_tpu import sim as rsim_mod
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

SMALL = BASE            # 16^3: the temporal-blocked pass's scope
PML = PmlConfig(size=(3, 3, 3))
TFSF = TfsfConfig(enabled=True, margin=(2, 2, 2))
J_AND_K = dataclasses.replace(
    K_SPHERE, use_drude=True, eps_inf=1.5, omega_p=1e11, gamma=1e10,
    drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3))
# mode -> configuration keywords (16^3, CPML 3). float32x2 has no source
# here: the reference's jnp-ds step with a source does not finish on the
# CPU in a test's time (its format case with TFSF is FORMAT_DS).
MODES = {
    "float32": dict(pml=PML, tfsf=TFSF, point_source=PointSourceConfig(
        enabled=True, component="Ez", position=(7, 8, 9))),
    "bfloat16": dict(pml=PML, tfsf=TFSF, dtype="bfloat16"),
    "float32x2": dict(pml=PML, dtype="float32x2"),
    "compensated": dict(pml=PML, compensated=True,
                        point_source=PointSourceConfig(
                            enabled=True, component="Ey",
                            position=(7, 8, 9))),
    "drude_j_k": dict(pml=PML, tfsf=TFSF, materials=J_AND_K),
}
FORMAT_DS = dict(pml=PML, tfsf=TFSF, dtype="float32x2")
TOL = {"bfloat16": 2e-2}
STEPS = 6


def ref_cfg(kw, **extra):
    return SimConfig(**dict(SMALL, **kw, **extra))


def seeded_state(ref: RSim, seed: int):
    """The reference's state tree with every leaf seeded (numpy): E, H,
    psi, J, K, the incident line at 0.01, the float32x2 lo words at
    1e-9, the Kahan residuals at 1e-10; bf16 leaves as ml_dtypes
    bfloat16 (the reference's storage); t = 6."""
    rng = np.random.RandomState(seed)
    state = np_state(ref)

    def fill(key, tree):
        out = {}
        for k, v in tree.items():
            scale = 1e-9 if key.startswith("lo") or k.endswith("_lo") \
                else 1e-10 if key in ("rE", "rH") else 0.01
            a = (scale * rng.standard_normal(v.shape)).astype(np.float32)
            out[k] = a.astype(v.dtype)
        return out

    seeded = {k: fill(k, v) for k, v in state.items() if k != "t"}
    seeded["t"] = np.asarray(6, dtype=np.int32)
    return seeded


def seeded_pair(kw, seed=1, **extra):
    """(reference sim, port sim, the numpy state both hold)."""
    cfg = ref_cfg(kw, use_pallas=False, **extra)
    ref = RSim(cfg)
    state = seeded_state(ref, seed)
    ref.state = jax.tree.map(jnp.asarray, state)
    port = TSim(to_port(cfg), device="cpu")
    port.state = convert.state_from_reference(state)
    assert port.t == 6
    return ref, port, state


def raw_meta(path):
    with np.load(path, allow_pickle=False) as z:
        return __import__("json").loads(
            zlib.decompress(z["__meta__"].tobytes()))


def widened(tree):
    """A state tree as float32/int numpy (bf16 leaves widened)."""
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return convert.to_host(tree)
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def assert_bits_equal(want, got, path=""):
    want, got = widened(want), widened(got)
    assert set(want) == set(got), (path, set(want), set(got))
    for k in want:
        if isinstance(want[k], dict):
            assert_bits_equal(want[k], got[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(
                np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")


def assert_fields_close(want, got, tol):
    """Every E/H component within ``tol`` of its family's max."""
    want, got = widened(want), widened(got)
    for fam in ("E", "H"):
        scale = max(float(np.abs(a).max()) for a in want[fam].values())
        for c, a in want[fam].items():
            err = float(np.abs(a.astype(np.float64) - got[fam][c]).max())
            assert err <= tol * scale, f"{c}: {err:.3e} vs {scale:.3e}"


@pytest.mark.parametrize("mode", sorted(MODES) + ["float32x2_tfsf"])
def test_port_and_reference_files_agree(tmp_path, mode):
    """Same state -> equal _manifest, _checksum and run metadata."""
    kw = FORMAT_DS if mode == "float32x2_tfsf" else MODES[mode]
    ref, port, _state = seeded_pair(kw)
    pr, pp = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref.checkpoint(pr)
    port.checkpoint(pp)
    mr, mp = raw_meta(pr), raw_meta(pp)
    assert mp["_manifest"] == mr["_manifest"]
    assert mp["_checksum"] == mr["_checksum"]
    for key in ("t", "scheme", "size", "topology", "psi_slabs", "dtype",
                "state_keys"):
        assert mp[key] == mr[key], key
    if mode == "bfloat16":
        assert mp["_manifest"]["E/Ex"] == [[16, 16, 16], "<f4"]
    if mode == "float32x2_tfsf":
        assert "inc/Einc_lo" in mp["_manifest"]
    # each package's loader passes on the other's file, to the same tree
    a, ea = rio.load_checkpoint(pp)
    b, eb = tio.load_checkpoint(pr)
    assert_bits_equal(a, b)
    assert ea == eb | {"step_kind": ea["step_kind"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cross_restore_and_continue(tmp_path, mode):
    """Each package restores the other's snapshot bit for bit and goes
    on STEPS steps to the other package's fields within the gate."""
    ref, port, state = seeded_pair(MODES[mode])
    pr, pp = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref.checkpoint(pr)
    port.checkpoint(pp)
    cfg = ref_cfg(MODES[mode], use_pallas=False)
    ref2 = RSim(cfg)
    ref2.restore(pp)
    port2 = TSim(to_port(cfg), device="cpu")
    port2.restore(pr)
    assert ref2.t == port2.t == 6
    assert_bits_equal(state, np_state(ref2))
    assert_bits_equal(state, convert.state_to_reference(port2.state))
    for sim in (ref, port, ref2, port2):
        sim.advance(STEPS)
    tol = TOL.get(mode, 2e-6)
    assert_fields_close(np_state(ref), port2.state, tol)
    assert_fields_close(convert.state_to_reference(port.state),
                        np_state(ref2), tol)


# mode -> (configuration keywords, the port's kind with use_pallas=True)
RESUME = {
    "float32": (MODES["float32"], "packed_tb_plain"),
    "bfloat16": (MODES["bfloat16"], "packed_tb_plain"),
    "float32x2": (FORMAT_DS, "packed_ds_plain"),
    "compensated": (MODES["compensated"], "packed_plain"),
    "drude_j_k": (MODES["drude_j_k"], "packed_plain"),
}


@pytest.mark.parametrize("mode", sorted(RESUME))
def test_resume_is_bit_equal(tmp_path, mode):
    """Cadence 5 over 15 steps (each chunk two tb passes and a packed
    tail step on the tb schedule): restored at t=10, the run equals the
    uninterrupted one bit for bit, also restored into a sim that has
    already run (its prepared operands cached)."""
    kw, kind = RESUME[mode]
    cfg = to_port(ref_cfg(kw, use_pallas=True, time_steps=15,
                          output=OutputConfig(save_dir=str(tmp_path),
                                              checkpoint_every=5)))
    full = TSim(cfg, device="cpu")
    assert full.step_kind == kind
    for _ in range(3):
        full.advance(5)
    assert [t for t, _ in tio.find_checkpoints(str(tmp_path))] == \
        [15, 10, 5]
    snap = os.path.join(str(tmp_path), "ckpt_t000010.npz")
    quiet = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, checkpoint_every=0))
    fresh = TSim(quiet, device="cpu")
    warm = TSim(quiet, device="cpu")
    warm.advance(3)
    for sim in (fresh, warm):
        sim.restore(snap)
        assert sim.t == 10
        sim.advance(5)
        assert_bits_equal(full.state, sim.state)


def test_restored_leaves_keep_their_dtypes(tmp_path):
    """bf16 fields and f32 psi/line come back in their storage dtypes,
    into the live carry's own tensors (no second carry)."""
    cfg = to_port(ref_cfg(MODES["bfloat16"], use_pallas=True))
    sim = TSim(cfg, device="cpu")
    sim.advance(4)
    path = str(tmp_path / "ck.npz")
    sim.checkpoint(path)
    sim.advance(3)
    before = {k: v.data_ptr() for k, v in sim.component_views().items()}
    sim.restore(path)
    views = sim.component_views()
    assert {k: v.data_ptr() for k, v in views.items()} == before
    assert all(v.dtype == torch.bfloat16 for v in views.values())
    assert sim._dict_view()["psi_E"]["Ex_y"].dtype == torch.float32
    assert sim.t == 4


# the metadata of each guard case, and what it differs from SMALL in
GUARDS = {
    "scheme": {"scheme": "2D_TMz"},
    "size": {"size": [16, 12, 16]},
    "dtype": {"dtype": "bfloat16"},
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_guard_messages_match_reference(case):
    cfg = ref_cfg(MODES["float32"])
    extra = dict({"scheme": "3D", "size": [16, 16, 16],
                  "dtype": "float32"}, **GUARDS[case])
    want = rsim_mod.ckpt_meta_mismatch(cfg, extra)
    assert want is not None
    assert tsim_mod.ckpt_meta_mismatch(to_port(cfg), extra) == want


@pytest.mark.parametrize("case", ["size", "dtype", "carry_family"])
def test_restore_guards_raise(tmp_path, case):
    base = ref_cfg(MODES["float32"], use_pallas=False)
    other = {"size": dataclasses.replace(base, size=(18, 16, 16)),
             "dtype": dataclasses.replace(base, dtype="bfloat16"),
             "carry_family": dataclasses.replace(
                 base, materials=MaterialsConfig(
                     use_drude=True, eps_inf=2.0, omega_p=1e10,
                     gamma=1e9))}[case]
    ck = str(tmp_path / "ck.npz")
    TSim(to_port(other), device="cpu").checkpoint(ck)
    match = {"size": "grid size", "dtype": "dtype",
             "carry_family": "carry family"}[case]
    with pytest.raises(ValueError, match=match) as got:
        TSim(to_port(base), device="cpu").restore(ck)
    with pytest.raises(ValueError) as want:
        RSim(base).restore(ck)
    assert str(got.value) == str(want.value)


def _mislaid(tree):
    """``tree`` (a dict-form state) with its first leaf whose shape is
    not its own reverse laid out in the reversed shape: the same element
    count in the wrong layout."""
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in tree.items()}
    for grp, sub in out.items():
        for k, v in (sub.items() if isinstance(sub, dict) else ()):
            if tuple(v.shape) != tuple(v.shape)[::-1]:
                sub[k] = v.reshape(tuple(v.shape)[::-1])
                return out
    raise AssertionError("no leaf with an asymmetric shape")


@pytest.mark.parametrize("case", ["setter_shape", "restore_shape",
                                  "setter_structure"])
def test_state_install_checks_each_leaf(tmp_path, case):
    """The one install path (the ``state`` setter, ``restore``, the
    supervisor's snapshot rollback) refuses a leaf of the right element
    count in the wrong shape, and a tree of other keys, before it
    writes anything into the live carry."""
    sim = TSim(to_port(ref_cfg(MODES["float32"], use_pallas=True)),
               device="cpu")
    sim.advance(2)
    before = sim.state
    if case == "setter_structure":
        bad = dict(before)
        bad.pop(next(k for k, v in bad.items() if isinstance(v, dict)
                     and k not in ("E", "H")))
        with pytest.raises(ValueError, match="structure mismatch"):
            sim.state = bad
    elif case == "setter_shape":
        with pytest.raises(ValueError, match="shape"):
            sim.state = _mislaid(before)
    else:
        ck = str(tmp_path / "ck.npz")
        tio.save_checkpoint(_mislaid(before), ck,
                            extra=sim._ckpt_meta())
        with pytest.raises(ValueError, match="shape"):
            sim.restore(ck)
    assert_bits_equal(before, sim.state)


def _good_checkpoint(tmp_path):
    """A snapshot with no zero run in its field bytes, so that zeroing
    any 64 of them changes the payload."""
    sim = TSim(to_port(ref_cfg(MODES["float32"], use_pallas=True)),
               device="cpu")
    rng = np.random.RandomState(3)
    for c, v in sim.component_views().items():
        sim.set_field(c, 1.0 + rng.random_sample(tuple(v.shape)))
    sim.advance(2)
    path = str(tmp_path / "ck.npz")
    sim.checkpoint(path)
    return path


@pytest.mark.parametrize("damage", ["truncate", "zero", "manifest"])
def test_corruption_raises_checkpoint_corrupt(tmp_path, damage):
    path = _good_checkpoint(tmp_path)
    if damage == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
        match = "structure check"
    elif damage == "zero":
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.seek(size // 2)
            fh.write(b"\0" * 64)
        match = "check failed"
    else:
        with np.load(path) as z:
            members = {k: z[k] for k in z.files if k != "H/Hx"}
        np.savez(path, **members)
        match = r"manifest check failed \(missing arrays: \['H/Hx'\]"
    with pytest.raises(tio.CheckpointCorrupt, match=match):
        tio.load_checkpoint(path)
    sim = TSim(to_port(ref_cfg(MODES["float32"], use_pallas=True)),
               device="cpu")
    with pytest.raises(tio.CheckpointCorrupt):
        sim.restore(path)


def _touch_ckpts(d, ts, bare=()):
    for t in ts:
        tio.save_checkpoint({"t": t}, os.path.join(d, f"ckpt_t{t:06d}.npz"),
                            extra={"t": t})
    for t in bare:
        with open(os.path.join(d, f"ckpt_t{t:06d}"), "wb") as fh:
            fh.write(b"not a checkpoint")


def test_find_and_prune_match_reference(tmp_path):
    """Newest first, a bare file without .npz skipped; keep-K honours
    t_max, so a longer run's leftovers never crowd out the live run's
    snapshots; the reference reads the same directory the same way."""
    d = str(tmp_path)
    _touch_ckpts(d, (5, 10, 15, 40, 45), bare=(50,))
    found = tio.find_checkpoints(d)
    assert [t for t, _ in found] == [45, 40, 15, 10, 5]
    assert found == rio.find_checkpoints(d)
    assert tio.find_latest_checkpoint(d).endswith("ckpt_t000045.npz")
    pruned = tio.prune_checkpoints(d, keep=2, t_max=15)
    assert sorted(os.path.basename(p) for p in pruned) == \
        ["ckpt_t000005.npz"]
    assert [t for t, _ in tio.find_checkpoints(d)] == [45, 40, 15, 10]
    tio.prune_checkpoints(d, keep=1)
    assert [t for t, _ in tio.find_checkpoints(d)] == [45]
    assert os.path.exists(os.path.join(d, "ckpt_t000050"))
    assert tio.prune_checkpoints(d, keep=0) == []


def test_cadence_keeps_k_and_meta_reads_without_arrays(tmp_path):
    cfg = to_port(ref_cfg(MODES["float32"], use_pallas=True,
                          output=OutputConfig(save_dir=str(tmp_path),
                                              checkpoint_every=2,
                                              checkpoint_keep=2)))
    sim = TSim(cfg, device="cpu")
    sim.extra_ckpt_meta["note"] = {"k": 1}
    for _ in range(4):
        sim.advance(2)
    assert [t for t, _ in tio.find_checkpoints(str(tmp_path))] == [8, 6]
    meta = tio.read_checkpoint_meta(os.path.join(str(tmp_path),
                                                 "ckpt_t000008.npz"))
    assert meta["t"] == 8 and meta["note"] == {"k": 1}
    assert meta["step_kind"] == "packed_tb_plain"
    assert "_manifest" not in meta and "_checksum" not in meta
    assert meta == rio.read_checkpoint_meta(
        os.path.join(str(tmp_path), "ckpt_t000008.npz"))
