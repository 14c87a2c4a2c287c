"""High-level Simulation of the PyTorch port.

Counterpart of ``fdtd3d_tpu/sim.py::Simulation`` for one device: owns
the state and the coefficients, advances the leapfrog in chunks, and
checks the fields for non-finite values after each chunk when
``OutputConfig.check_finite`` is set (one reduction over every state
tensor, float32x2 hi and lo words alike, and one readback).

The device is an explicit argument: ``Simulation(cfg)`` runs on the
current CUDA device and raises when there is none;
``Simulation(cfg, device="cpu")`` runs on the CPU. The live carry is
updated in place by the packed steps, and the temporal-blocked pass
swaps its buffers with a spare set every pass, so ``state`` returns a
snapshot (copies), ``set_field`` writes into the live carry, and a view
from ``component_views`` holds until the next ``advance``. Checkpoints
come with ROADMAP.md item A6.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fdtd3d_torch import convert, telemetry
from fdtd3d_torch.solver import (StaticSetup, build_coeffs, build_static,
                                 coeffs_to_device, init_state,
                                 make_chunk_runner)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; a CUDA device
    that is not there is an error, never a quiet run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fdtd3d_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' (CLI: --device cpu) to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def _map_tensors(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


class Simulation:
    """Owns solver state + coefficients; advances the leapfrog in chunks."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.static: StaticSetup = build_static(cfg)
        self.coeffs = coeffs_to_device(build_coeffs(self.static),
                                       self.device)
        self._runner = make_chunk_runner(
            self.static, self.device, health=cfg.output.check_finite)
        self.step_kind: str = self._runner.kind
        # kernel diagnostics: the temporal-blocking depth, or why the
        # temporal-blocked pass did not engage (tb_fallback)
        self.step_diag = self._runner.diag
        if cfg.require_pallas and self.step_kind not in (
                "packed_tb_cuda", "packed_cuda", "packed_ds_cuda",
                "fused_cuda", "pallas3d_cuda"):
            raise ValueError(
                f"require_pallas is set but the CUDA kernels did not "
                f"engage (step_kind={self.step_kind}, device="
                f"{self.device})")
        self._chunk_idx = 0
        # zeros made directly in the carry's form: building the dict
        # form first and packing it would hold the fields twice
        shapes = init_state(self.static, "meta")
        if self._runner.packed:
            shapes = self._runner.pack(shapes)
        self._carry = _map_tensors(shapes, lambda t: torch.zeros(
            t.shape, dtype=t.dtype, device=self.device))

    # -- state representation ---------------------------------------------

    def _dict_view(self) -> Dict[str, Any]:
        """Dict-form view of the live carry (no copies)."""
        if self._runner.packed:
            return self._runner.unpack(self._carry)
        return self._carry

    @property
    def state(self) -> Dict[str, Any]:
        """The solver state in dict form, as a snapshot (copies)."""
        return _map_tensors(self._dict_view(), torch.clone)

    @state.setter
    def state(self, value: Dict[str, Any]):
        """Install a dict-form state (tensors or numpy arrays, with the
        keys and shapes of ``init_state``) as the live carry."""
        want = init_state(self.static, "meta")

        def adopt(ref, new, path):
            if isinstance(ref, dict):
                if not isinstance(new, dict) or set(new) != set(ref):
                    raise ValueError(f"state structure mismatch at "
                                     f"{path or 'top'}")
                return {k: adopt(ref[k], new[k], f"{path}/{k}")
                        for k in ref}
            if isinstance(ref, torch.Tensor):
                t = new if isinstance(new, torch.Tensor) \
                    else convert.from_host(new)
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                                     f"{tuple(ref.shape)}")
                return t.to(device=self.device, dtype=ref.dtype).clone()
            return int(new)

        st = adopt(want, value, "")
        self._carry = self._runner.pack(st) if self._runner.packed else st

    def component_views(self) -> Dict[str, torch.Tensor]:
        """Every stored field component (E then H) as a view of the live
        carry: with float32x2 fields, the hi words (as the reference's
        ``field``/``fields`` return them)."""
        view = self._dict_view()
        return {c: v for g in ("E", "H") for c, v in view[g].items()}

    # -- stepping ----------------------------------------------------------

    def advance(self, n_steps: int):
        """Advance n_steps. With check_finite, a chunk whose fields went
        non-finite raises FloatingPointError naming the components and
        the first-bad-step bound."""
        if n_steps <= 0:
            return self
        t_prev = self.t
        out = self._runner(self._carry, self.coeffs, n_steps)
        health = None
        if self._runner.health:
            out, health = out
        self._carry = out
        self._chunk_idx += 1
        if health is not None and not telemetry.is_finite(health):
            bad = sorted(self._nonfinite_leaves())
            names = ", ".join(bad) if bad else "unknown"
            err = FloatingPointError(
                f"non-finite field values tripped the health "
                f"reduction in chunk {self._chunk_idx}: first bad "
                f"step in ({t_prev}, {self.t}]; components: {names} "
                f"(check the Courant factor / Drude stability bound)")
            err.bad_components = bad
            raise err
        return self

    def _nonfinite_leaves(self):
        """Names of the state leaves holding non-finite values (failure
        path only: a host pass over the state)."""
        view = self._dict_view()
        for grp, sub in view.items():
            if not isinstance(sub, dict):
                continue
            for k, v in sub.items():
                if not bool(torch.isfinite(v).all()):
                    yield k if grp in ("E", "H") else f"{grp}/{k}"

    def run(self, time_steps: Optional[int] = None,
            on_interval: Optional[Callable] = None, interval: int = 0):
        """Run the loop; call on_interval(sim) every `interval` steps."""
        total = time_steps if time_steps is not None \
            else self.cfg.time_steps
        if not interval or on_interval is None:
            return self.advance(total)
        done = 0
        while done < total:
            n = min(interval, total - done)
            self.advance(n)
            done += n
            on_interval(self)
        return self

    # -- access ------------------------------------------------------------

    @property
    def t(self) -> int:
        return int(self._carry["t"])

    def sample(self, comp: str, idx) -> float:
        """One field value as a python float (one small readback)."""
        return float(self.component_views()[comp][tuple(idx)].item())

    def field(self, comp: str) -> np.ndarray:
        """One field component as a host numpy array: with bf16 storage
        widened exactly to float32 (the reference returns an
        ``ml_dtypes`` bfloat16 array, a type the port does not use)."""
        return convert.to_host(self.component_views()[comp])

    def fields(self) -> Dict[str, np.ndarray]:
        return {c: convert.to_host(v)
                for c, v in self.component_views().items()}

    def set_field(self, comp: str, value):
        """Overwrite one field component of the live carry."""
        views = self.component_views()
        if comp not in views:
            raise KeyError(f"{comp} not active in scheme {self.cfg.scheme}")
        dst = views[comp]
        src = convert.from_host(np.broadcast_to(np.asarray(value), dst.shape))
        dst.copy_(src.to(dtype=dst.dtype))
        lo = self._dict_view().get("lo" + comp[0])
        if lo is not None:
            # the pair's value is hi + lo: a stale lo word would perturb
            # the value just set
            lo[comp].zero_()
        return self

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @staticmethod
    def run_batch(cfgs, time_steps: Optional[int] = None, device=None,
                  chunk: int = 0):
        """Run B same-shape scenarios as one batch
        (:class:`fdtd3d_torch.batch.BatchSimulation`): in-scope batches
        ride the lane-capable kernels, one launch for every lane; a
        batch the dispatch authority gives a token runs the plain step
        lane by lane, with ``batch_unsupported:<token>`` recorded.
        Returns the finished batch, after its end-of-run
        ``verify_final_lanes`` sweep; per-lane results via
        ``lane_state(i)`` / ``lane_field(i, comp)``, verdicts via
        ``lane_finite`` / ``lane_first_unhealthy_t``. ``chunk`` advances
        the batch that many steps per chunk (0 = one chunk)."""
        from fdtd3d_torch.batch import BatchSimulation
        bsim = BatchSimulation(cfgs, device=device)
        bsim.run(time_steps, chunk=chunk)
        bsim.verify_final_lanes()
        return bsim

