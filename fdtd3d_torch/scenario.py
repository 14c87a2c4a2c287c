"""ScenarioSpec: the WHAT of a run, as its own object.

Counterpart of ``fdtd3d_tpu/scenario.py``: a run is a scenario spec (the
``SimConfig`` with its derived static setup and host-built coefficient
arrays), a state, and the step that evolves it. The batch executor
(``fdtd3d_torch/batch.py``) stacks many specs' states and coefficients
under one lane-capable step. The spec memoizes its derived products.

The reference's ``fingerprint()`` (the key of its executable cache) is
not here: the cache comes with the rest of ROADMAP.md item A13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from fdtd3d_torch.config import SimConfig

# cfg fields allowed to DIFFER between the lanes of one batch, as in the
# reference: material values reach the kernels as per-lane coefficient
# grids (a scalar that differs between lanes is refused by the dispatch
# authority, solver.batch_fallback_reason, with scalar_coeff_divergence),
# the point-source amplitude as a per-lane device value, and the output
# settings never reach the step. Everything else shapes the step and
# must be equal in every lane.
BATCH_VARIABLE_FIELDS = ("materials", "output")
BATCH_VARIABLE_SUBFIELDS = {"point_source": ("amplitude",)}


class ScenarioSpec:
    """One scenario's full description + memoized derived products."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self._static = None
        self._coeffs_np = None

    @property
    def static(self):
        """The static setup (solver.StaticSetup) of the configuration."""
        if self._static is None:
            from fdtd3d_torch.solver import build_static
            self._static = build_static(self.cfg)
        return self._static

    def build_coeffs(self, static=None) -> Dict[str, Any]:
        """Host-built (numpy) coefficient dict, memoized per spec."""
        from fdtd3d_torch.solver import build_coeffs
        if static is not None:
            return build_coeffs(static)
        if self._coeffs_np is None:
            self._coeffs_np = build_coeffs(self.static)
        return self._coeffs_np

    def init_state(self, static=None, device="cpu") -> Dict[str, Any]:
        """Zero dict-form state on ``device``."""
        from fdtd3d_torch.solver import init_state
        return init_state(static if static is not None else self.static,
                          device)

    def batch_fingerprint(self) -> Dict[str, Any]:
        """Canonical dict of every cfg field that must be EQUAL across
        the lanes of a batch (the step-shaping fields); the batch
        executor compares these and names the first differing field."""
        d = dataclasses.asdict(self.cfg)
        for field in BATCH_VARIABLE_FIELDS:
            d.pop(field, None)
        for field, subs in BATCH_VARIABLE_SUBFIELDS.items():
            if field in d:
                for sub in subs:
                    d[field].pop(sub, None)
        return d


def batch_fingerprint_diff(a: Dict[str, Any], b: Dict[str, Any],
                           prefix: str = "") -> Optional[str]:
    """First dotted field path where two batch fingerprints differ
    (None = batch-compatible), so the eligibility error can name the
    offending flag."""
    for key in sorted(set(a) | set(b)):
        path = f"{prefix}{key}"
        va, vb = a.get(key), b.get(key)
        if isinstance(va, dict) and isinstance(vb, dict):
            sub = batch_fingerprint_diff(va, vb, prefix=f"{path}.")
            if sub:
                return sub
        elif va != vb:
            return f"{path} ({va!r} vs {vb!r})"
    return None
