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
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fdtd3d_torch.solver import coeffs_to_device


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def state_from_reference(np_state: Dict[str, Any],
                         device="cpu") -> Dict[str, Any]:
    """The reference's unpacked state (numpy leaves) -> the port's
    dict-form state on ``device``."""
    out = {k: _to_torch(v, device) for k, v in np_state.items()
           if k != "t"}
    out["t"] = int(np.asarray(np_state["t"]))
    return out


def state_to_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's dict-form state -> the reference's unpacked form
    (numpy leaves, ``t`` as an int32 scalar)."""
    out = {k: _to_numpy(v) for k, v in state.items() if k != "t"}
    out["t"] = np.asarray(state["t"], dtype=np.int32)
    return out


def coeffs_from_reference(np_coeffs: Dict[str, Any],
                          device="cpu") -> Dict[str, Any]:
    """The reference's host coefficient dict -> the port's device
    coefficients (arrays as tensors, scalars as host floats)."""
    return coeffs_to_device(np_coeffs, device)
