"""Carry state and coefficients across between the two packages.

The reference (``fdtd3d_tpu``) keeps its state as a dict of arrays
``{E, H, psi_E, psi_H, J, inc, t}``, and with float32x2 fields also the
low words ``loE``, ``loH``, ``lopsi_E``, ``lopsi_H`` and
``inc/{Einc,Hinc}_lo``; the port's dict form has the same keys and
shapes, with torch tensors and a host integer ``t``. These functions
map numpy copies of one onto the other, key by key whatever the keys,
so both packages can start from identical fields (hi and lo words
alike) and be compared in the unpacked form. Coefficients cross the
same way, the ``*_lo`` words and the ds CPML profile pairs included.

Complex fields cross as complex arrays (complex64/complex128 both
ways); the two real legs of a paired complex run cross as two
dict-form states under ``re``/``im``. A complex float32x2 state crosses
like any other: complex64 leaves, the low words too once the run has
stepped (real float32 low words before, as the reference's
``init_state`` makes them), and magnetic Drude's ``K`` beside ``J``.

bfloat16 leaves (bf16 fields, and the Kahan residuals ``rE``/``rH`` of
compensated mode, bf16 in both packages): the reference keeps them as
``ml_dtypes`` bfloat16 arrays, which numpy sees as 2-byte void words;
the port does not import ``ml_dtypes``. A 2-byte void leaf comes across
as a bf16 tensor with the same bits (``from_host``; ``bf16_words``
gives them back as int16 words), and a bf16 tensor goes back as float32
holding the same values, widened exactly (``to_host``): numpy has no
bf16 of its own, and every bf16 value is an f32 value. Magnetic Drude's
``K`` crosses like J.

A decomposed run's global state and coefficients have the reference's
sharded layout (psi ``2 m p`` planes along its own axis, the slab
profiles ``2 m p`` long: ``solver.slab_axes`` and ``build_coeffs`` of a
static with that topology, in both packages), so they cross as any
other, leaf for leaf; ``parallel.mesh.ShardMesh.split`` cuts them into
the shards' pieces and ``io.reshard_psi_tree`` moves psi between
topologies.

A batch (fdtd3d_torch/batch.py) has the lane-stacked forms: the
reference's batched state and coefficient trees carry a leading lane
axis on every leaf (``t`` a (B,) vector, a scalar coefficient a (B,)
vector); the port's batch state has the same lane-leading leaves with
one host ``t``, and its lane-capable coefficients keep what every lane
shares once (``batch.stack_lane_coeffs``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fdtd3d_torch.solver import coeffs_to_device


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (a copy); bf16 widened exactly to
    float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def from_host(a) -> torch.Tensor:
    """A numpy array as a CPU tensor (a copy); 2-byte void words (the
    reference's ``ml_dtypes`` bfloat16) as a bf16 tensor of the same
    bits."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def bf16_words(t: torch.Tensor) -> np.ndarray:
    """The bits of a bf16 tensor as a host int16 array (a copy)."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().copy()


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: int(np.asarray(v)) if k == "t" else _to_torch(v, device)
                for k, v in tree.items()}
    return from_host(tree).to(device)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: np.asarray(v, dtype=np.int32) if k == "t"
                else _to_numpy(v) for k, v in tree.items()}
    return to_host(tree)


def state_from_reference(np_state: Dict[str, Any],
                         device="cpu") -> Dict[str, Any]:
    """The reference's unpacked state (numpy leaves) -> the port's
    dict-form state on ``device``; complex leaves stay complex, and a
    paired complex carry's legs (``{"re": leg, "im": leg, "t"}``, each
    leg a dict-form state) cross the same way, every ``t`` a host
    integer."""
    return _to_torch(np_state, device)


def state_to_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's dict-form state -> the reference's unpacked form
    (numpy leaves, complex ones complex, every ``t`` an int32 scalar;
    a paired carry's legs too)."""
    return _to_numpy(state)


def coeffs_from_reference(np_coeffs: Dict[str, Any],
                          device="cpu") -> Dict[str, Any]:
    """The reference's host coefficient dict -> the port's device
    coefficients (arrays as tensors, scalars as host floats)."""
    return coeffs_to_device(np_coeffs, device)


def stacked_state_from_reference(np_state: Dict[str, Any],
                                 device="cpu") -> Dict[str, Any]:
    """The reference's lane-stacked state (numpy leaves, ``t`` one entry
    per lane) -> the port's lane-stacked dict-form state on ``device``
    (the lanes advance together: one host ``t``)."""
    t = np.asarray(np_state["t"]).reshape(-1)
    if not (t == t[0]).all():
        raise ValueError(f"the lanes of a batch share one t, got {t}")
    out = {k: _to_torch(v, device) for k, v in np_state.items()
           if k != "t"}
    out["t"] = int(t[0])
    return out


def stacked_state_to_reference(state: Dict[str, Any],
                               lanes: int) -> Dict[str, Any]:
    """The port's lane-stacked dict-form state -> the reference's
    stacked form (numpy leaves, ``t`` an int32 vector of ``lanes``)."""
    out = {k: _to_numpy(v) for k, v in state.items() if k != "t"}
    out["t"] = np.full(lanes, state["t"], dtype=np.int32)
    return out


def _lane(tree: Any, lane: int) -> Any:
    if isinstance(tree, dict):
        return {k: _lane(v, lane) for k, v in tree.items()}
    return np.asarray(tree)[lane]


def stacked_coeffs_from_reference(np_coeffs: Dict[str, Any],
                                  device="cpu") -> Dict[str, Any]:
    """The reference's lane-stacked coefficient tree -> the port's
    lane-capable device coefficients (``batch.stack_lane_coeffs`` of the
    lanes' dicts)."""
    from fdtd3d_torch.batch import stack_lane_coeffs
    lanes = len(np.asarray(next(iter(np_coeffs.values()))))
    return stack_lane_coeffs([_lane(np_coeffs, i) for i in range(lanes)],
                             device)


def stacked_coeffs_to_reference(coeffs: Dict[str, Any],
                                lanes: int) -> Dict[str, Any]:
    """The port's lane-capable coefficients -> the reference's
    lane-stacked tree: a value the lanes share is repeated per lane."""
    from fdtd3d_torch.batch import PER_LANE_SCALARS
    out: Dict[str, Any] = {}
    for k, v in coeffs.items():
        if isinstance(v, torch.Tensor):
            a = to_host(v)
            per_lane = k in PER_LANE_SCALARS or a.ndim == 4
            out[k] = a.copy() if per_lane \
                else np.broadcast_to(a, (lanes,) + a.shape).copy()
        else:
            out[k] = np.full(lanes, v, dtype=np.float32)
    return out
