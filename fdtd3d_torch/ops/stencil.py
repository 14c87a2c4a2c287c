"""Difference stencils of the PyTorch port (unsharded).

Counterpart of ``fdtd3d_tpu/ops/stencil.py::make_diff_ops`` without the
halo exchange (domain decomposition is ROADMAP item A11): at the domain
edge the missing neighbor plane is zero, which is the PEC ghost value.

Sign/time conventions (leapfrog):
  E-update uses BACKWARD differences of H:  (H[i] - H[i-1]) / d
  H-update uses FORWARD  differences of E:  (E[i+1] - E[i]) / d
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def make_diff_ops() -> Tuple[Callable, Callable]:
    """Build (diff_b, diff_f) difference ops.

    diff_b(f, axis): f[i] - f[i-1]  (zero ghost below index 0)
    diff_f(f, axis): f[i+1] - f[i]  (zero ghost above index n-1)

    A size-1 (inactive) axis yields exactly zero, as in the reference.
    """

    def diff_b(f: torch.Tensor, axis: int) -> torch.Tensor:
        n = f.shape[axis]
        if n == 1:
            return torch.zeros_like(f)
        out = f.clone()
        out.narrow(axis, 1, n - 1).sub_(f.narrow(axis, 0, n - 1))
        return out

    def diff_f(f: torch.Tensor, axis: int) -> torch.Tensor:
        n = f.shape[axis]
        if n == 1:
            return torch.zeros_like(f)
        out = torch.empty_like(f)
        torch.sub(f.narrow(axis, 1, n - 1), f.narrow(axis, 0, n - 1),
                  out=out.narrow(axis, 0, n - 1))
        torch.neg(f.narrow(axis, n - 1, 1), out=out.narrow(axis, n - 1, 1))
        return out

    return diff_b, diff_f
