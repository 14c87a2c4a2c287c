"""Field diagnostics of the PyTorch port.

Counterpart of ``fdtd3d_tpu/diag.py::field_norms`` (``--norms-every``).
The energy, divergence and metrics records come with ROADMAP.md item A5.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from fdtd3d_torch.telemetry import max_abs


def tfsf_leakage(fields: Dict[str, np.ndarray], lo: Sequence[int],
                 hi: Sequence[int]) -> float:
    """Scattered-field leakage of a TFSF run: max |E| over the cells
    outside the total-field box (more than one cell beyond any face, to
    stay clear of the staggered face samples) over max |E| inside it.
    In vacuum the scattered region should hold only roundoff; an
    indexing or sign error in the face corrections shows up here."""
    e = [np.abs(np.asarray(v)) for k, v in fields.items() if k[0] == "E"]
    shape = e[0].shape
    inside = np.ones(shape, dtype=bool)
    for a in range(3):
        idx = np.arange(shape[a])
        ok = (idx >= lo[a] - 1) & (idx <= hi[a] + 1)
        s = [1, 1, 1]
        s[a] = shape[a]
        inside &= ok.reshape(s)
    mx_in = max(float(v[inside].max()) for v in e)
    mx_out = max(float(v[~inside].max()) for v in e)
    return mx_out / mx_in if mx_in > 0 else float("inf")


def field_norms(sim) -> Dict[str, float]:
    """max|comp| for every stored field component: one reduction per
    component on the device, one readback."""
    comps = sim.component_views()
    vals = torch.stack([max_abs(v) for v in comps.values()]).tolist()
    return dict(zip(comps, vals))
