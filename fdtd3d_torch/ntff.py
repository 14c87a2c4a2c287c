"""Near-to-far-field (NTFF) transform of the PyTorch port.

Counterpart of ``fdtd3d_tpu/ntff.py``: surface equivalence over a closed
virtual box,

  N(r^) = integral of  J_s exp(+jk r'.r^) dS',   J_s =  n^ x H
  L(r^) = integral of  M_s exp(+jk r'.r^) dS',   M_s = -n^ x E
  E_theta ~ -(L_phi + eta0 N_theta),  E_phi ~ +(L_theta - eta0 N_phi)

evaluated in the frequency domain from a running DFT of the tangential
fields on the box's six faces (24 face planes: each face's tangential E
and H components), sampled between chunks of the run.

Sampling (``NtffCollector.sample``) reads the face planes from the live
carry (``Simulation.component_legs``, fetched anew at every sample: the
temporal-blocked pass swaps its buffers, so a view held from an earlier
sample may point at a stale one) and adds each plane times the DFT
phase, E at ``-w t dt`` and H at ``-w (t + 1/2) dt`` (the leapfrog's
staggering), to Kahan-compensated float32 sums in real arithmetic, as
the reference does: a plain f32 sum would drift as sqrt(samples) *
2^-24, the compensated one stays at O(2^-24). Tangential H lives half a
cell off the face plane, so the two H planes next to the face are
averaged. The arithmetic is plain torch ops on the device (the
reference's is jnp outside any kernel); no host transfer happens until
``acc`` folds the compensation in at float64 on the host, in one copy.
Storage rules: a bf16 plane is widened to float32 before any arithmetic;
float32x2 runs sample the hi words (the reference reads ``state["E"]``,
whose lo words live in ``loE``/``loH``); float64 planes are averaged in
float64 and rounded to float32, as the reference casts them. Complex
fields add their imaginary planes (a paired run's im leg, a native run's
imaginary part) in the same real arithmetic, each part rounded to
float32 as the reference's ``jnp.real``/``jnp.imag`` casts are; a
complex float32x2 run's legs give their hi words.

``far_field`` and ``directivity_pattern`` evaluate the radiation
integrals on the host, each component at its own Yee position
(``layout.YEE_OFFSETS``; the normal coordinate sits on the face). The
phase of a face point factors into one per in-plane axis, so the
integral over a face is two matrix products over the grid of directions
instead of one complex exponential per point and direction; the result
equals the reference's term by term up to float64 rounding.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from fdtd3d_torch import physics
from fdtd3d_torch.layout import YEE_OFFSETS, component_axis

AXES = (0, 1, 2)
Key = Tuple[int, int, str]      # (normal axis, side 0 = lo / 1 = hi, comp)


class NtffCollector:
    """Accumulates the running DFT of tangential E/H on a closed box.

    ``box``: ((lo_x, lo_y, lo_z), (hi_x, hi_y, hi_z)), inclusive cell
    indices; None takes the configuration's ``ntff.box_lo``/``box_hi``
    when set (both, or a ValueError), else ``margin`` cells inward from
    each PML's inner face. ``sim`` may be replaced by a Simulation of the
    same grid (a supervised run's degrade): the accumulators carry on."""

    def __init__(self, sim, frequency: float,
                 box: Tuple[Tuple[int, int, int], Tuple[int, int, int]]
                 = None, margin: int = 2):
        if sim.static.mode.name != "3D":
            raise ValueError("NTFF requires the 3D scheme")
        self.sim = sim
        self.omega = 2.0 * math.pi * frequency
        self.dt = sim.static.dt
        self.dx = sim.static.dx
        shape = sim.static.grid_shape
        ntff = sim.cfg.ntff
        if box is None and (ntff.box_lo is not None
                            or ntff.box_hi is not None):
            if ntff.box_lo is None or ntff.box_hi is None:
                raise ValueError(
                    "ntff.box_lo and ntff.box_hi must be set together")
            box = (tuple(ntff.box_lo), tuple(ntff.box_hi))
        if box is None:
            pml = sim.cfg.pml.size
            lo = tuple(pml[a] + margin for a in AXES)
            hi = tuple(shape[a] - 1 - pml[a] - margin for a in AXES)
        else:
            lo, hi = box
        for a in AXES:
            # the H average reads plane lo-1: a box on the wall would
            # read outside the grid
            if lo[a] < 1 or hi[a] > shape[a] - 1 or hi[a] <= lo[a]:
                raise ValueError(
                    f"NTFF box [{lo[a]}, {hi[a]}] invalid on axis {a} "
                    f"(need 1 <= lo < hi <= {shape[a] - 1})")
        self.lo, self.hi = tuple(lo), tuple(hi)
        # the face planes: for each axis and side, every component
        # tangential to that face (24)
        self.keys = tuple(
            (axis, side, c) for axis in AXES for side in (0, 1)
            for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")
            if component_axis(c) != axis)
        # per key a (4, n_p, n_q) float32 device tensor: the real sum,
        # its Kahan compensation, the imaginary sum, its compensation
        self._acc: Dict[Key, torch.Tensor] = {}
        self._host: Dict[Key, np.ndarray] = None
        self.n_samples = 0

    def _face(self, axis: int, at: int):
        sl = [slice(self.lo[a], self.hi[a] + 1) for a in AXES]
        sl[axis] = at
        return tuple(sl)

    def _face_plane(self, views, key: Key) -> torch.Tensor:
        """The plane of ``key`` sampled from the component views: E on
        the face, H averaged over the face and the plane below it (a
        bf16 field widened first), in float32 (a complex field's plane
        stays complex64: ``sample`` takes its parts)."""
        axis, side, c = key
        f = views[c]
        if f.dtype == torch.bfloat16:
            f = f.float()
        idx = self.lo[axis] if side == 0 else self.hi[axis]
        if c[0] == "E":
            plane = f[self._face(axis, idx)]
        else:
            plane = 0.5 * (f[self._face(axis, idx)]
                           + f[self._face(axis, idx - 1)])
        return plane.to(torch.complex64 if plane.is_complex()
                        else torch.float32)

    def sample(self):
        """Accumulate one DFT sample at the sim's current step, on the
        device (no host transfer). A complex field's real and imaginary
        planes (the two legs of a paired run, or the parts of a native
        complex one) enter as the reference's real arithmetic:
        ``(pr + j pi)(cs + j sn) = (pr cs - pi sn) + j (pr sn + pi cs)``;
        a real field's as ``pr cs + j pr sn``."""
        t = self.sim.t
        ang_e = -self.omega * t * self.dt
        ang_h = -self.omega * (t + 0.5) * self.dt
        phase = {"E": (float(np.float32(math.cos(ang_e))),
                       float(np.float32(math.sin(ang_e)))),
                 "H": (float(np.float32(math.cos(ang_h))),
                       float(np.float32(math.sin(ang_h))))}
        legs = self.sim.component_legs()
        for key in self.keys:
            planes = [self._face_plane(v, key) for v in legs]
            if planes[0].is_complex():
                planes = [planes[0].real, planes[0].imag]
            pr = planes[0]
            pi = planes[1] if len(planes) == 2 else None
            acc = self._acc.get(key)
            if acc is None:
                acc = self._acc[key] = torch.zeros(
                    (4,) + tuple(pr.shape), dtype=torch.float32,
                    device=pr.device)
            cs, sn = phase[key[2][0]]
            if pi is None:
                re_part, im_part = pr * cs, pr * sn
            else:
                re_part, im_part = pr * cs - pi * sn, pr * sn + pi * cs
            for s, comp, contrib in ((acc[0], acc[1], re_part),
                                     (acc[2], acc[3], im_part)):
                y = contrib - comp
                total = s + y
                comp.copy_((total - s) - y)
                s.copy_(total)
        self._host = None
        self.n_samples += 1

    def device_bytes(self) -> int:
        """Bytes the accumulators hold on the device."""
        return sum(a.numel() * a.element_size() for a in self._acc.values())

    @property
    def acc(self) -> Dict[Key, np.ndarray]:
        """Host complex128 accumulators, the compensation folded in at
        float64: one copy from the device, cached until the next
        sample."""
        if self._host is None:
            keys = list(self._acc)
            flat = torch.cat([self._acc[k].reshape(-1) for k in keys]) \
                .cpu().numpy().astype(np.float64) if keys else None
            out, pos = {}, 0
            for k in keys:
                shape = tuple(self._acc[k].shape)
                n = int(np.prod(shape))
                re, re_c, im, im_c = flat[pos:pos + n].reshape(shape)
                out[k] = (re - re_c) + 1j * (im - im_c)
                pos += n
            self._host = out
        return self._host

    # -- post-processing ---------------------------------------------------

    def _coords(self, axis: int, side: int, comp: str):
        """(in-plane axes (p, q), their coordinates with comp's Yee
        offsets, the normal coordinate), in cells."""
        p, q = (b for b in AXES if b != axis)
        off = YEE_OFFSETS[comp]
        cp = np.arange(self.lo[p], self.hi[p] + 1, dtype=np.float64) + off[p]
        cq = np.arange(self.lo[q], self.hi[q] + 1, dtype=np.float64) + off[q]
        normal = float(self.lo[axis] if side == 0 else self.hi[axis])
        return (p, q), cp, cq, normal

    @staticmethod
    def _levi(i, j, k):
        return (i - j) * (j - k) * (k - i) // 2  # +1/-1/0

    def far_fields(self, thetas_deg: Sequence[float],
                   phis_deg: Sequence[float]):
        """Complex (E_theta, E_phi) arrays at the directions
        (thetas_deg[d], phis_deg[d]) (``fdtd3d_tpu/ntff.py::far_field``
        for each)."""
        if self.n_samples == 0:
            raise RuntimeError("no samples collected")
        th = np.radians(np.asarray(thetas_deg, dtype=np.float64))
        ph = np.radians(np.asarray(phis_deg, dtype=np.float64))
        rhat = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                         np.cos(th)], axis=1)
        theta_hat = np.stack([np.cos(th) * np.cos(ph),
                              np.cos(th) * np.sin(ph), -np.sin(th)], axis=1)
        phi_hat = np.stack([-np.sin(ph), np.cos(ph), np.zeros_like(ph)],
                           axis=1)
        kdx = self.omega / physics.C0 * self.dx
        scale = self.dt * self.dx ** 2 / self.n_samples  # dS' and DFT norm
        N = np.zeros((len(th), 3), dtype=np.complex128)
        L = np.zeros((len(th), 3), dtype=np.complex128)
        for (axis, side, comp), acc in self.acc.items():
            sigma = -1.0 if side == 0 else 1.0
            ca = component_axis(comp)
            j3 = 3 - axis - ca           # the third axis: cross target
            sign = sigma * self._levi(axis, ca, j3)
            (p, q), cp, cq, normal = self._coords(axis, side, comp)
            up = np.exp(1j * kdx * np.outer(rhat[:, p], cp))
            uq = np.exp(1j * kdx * np.outer(rhat[:, q], cq))
            total = np.einsum("dq,dq->d", up @ acc, uq) \
                * np.exp(1j * kdx * rhat[:, axis] * normal) * scale
            if comp[0] == "H":           # N += (n x H) term
                N[:, j3] += sign * total
            else:                        # L += (-n x E) term
                L[:, j3] -= sign * total
        n_th = np.einsum("dc,dc->d", N, theta_hat)
        n_ph = np.einsum("dc,dc->d", N, phi_hat)
        l_th = np.einsum("dc,dc->d", L, theta_hat)
        l_ph = np.einsum("dc,dc->d", L, phi_hat)
        return -(l_ph + physics.ETA0 * n_th), l_th - physics.ETA0 * n_ph

    def far_field(self, theta_deg: float, phi_deg: float):
        """Complex (E_theta, E_phi) pattern amplitudes at one direction."""
        e_theta, e_phi = self.far_fields([theta_deg], [phi_deg])
        return e_theta[0], e_phi[0]

    def directivity_pattern(self, thetas, phis) -> np.ndarray:
        """|E|^2 pattern (unnormalized) over the angle grid
        thetas x phis."""
        tt, pp = np.meshgrid(np.asarray(thetas, dtype=np.float64),
                             np.asarray(phis, dtype=np.float64),
                             indexing="ij")
        e_theta, e_phi = self.far_fields(tt.ravel(), pp.ravel())
        return (np.abs(e_theta) ** 2 + np.abs(e_phi) ** 2).reshape(tt.shape)
