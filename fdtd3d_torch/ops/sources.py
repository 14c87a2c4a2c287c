"""Source waveforms and point-source masks of the PyTorch port.

Counterpart of ``fdtd3d_tpu/ops/sources.py`` (``waveform``,
``point_mask``, and the float32x2 ``phase_frac_ds``/``waveform_ds``).
The step counter is a host integer in the port, so the waveform is
evaluated on the host (numpy scalars of the real dtype; the ds waveform
in float32 CPU tensors, for a block of steps at once), with the same
operations in the same order as the reference's traced version; the
result enters the device work as one scalar (or pair) per step and
costs no device readback.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from fdtd3d_torch.ops import ds

# Waveform shape constants, shared with the reference
# (fdtd3d_tpu/ops/sources.py): the ramp lasts _RAMP_PERIODS periods
# (smoothstep), the Gaussian pulse has tau = _PULSE_TAU_PERIODS periods
# centered at _PULSE_T0_TAUS * tau.
_RAMP_PERIODS = 2.0
_PULSE_TAU_PERIODS = 1.5
_PULSE_T0_TAUS = 4.0


def _phase_frac(step: int, f: float) -> np.float32:
    """frac(step * f) as f32, via 64-bit fixed-point modular arithmetic.

    The reference computes the top 32 bits of ``step * q mod 2**64``
    (q = frac(f) quantized to q/2**64) with wrapping uint32 multiplies;
    Python integers give the same bits directly. The only rounding left
    is the f32 cast of the final fraction: a constant ~4e-7 rad at any
    horizon, instead of a phase error growing with the step count.
    """
    q = int(round((f % 1.0) * 2.0 ** 64)) & ((1 << 64) - 1)
    s = int(step) & 0xffffffff
    u = ((s * q) >> 32) & 0xffffffff
    return np.float32(u) * np.float32(2.0 ** -32)


def _phase_words(step: int, f: float):
    """(top-32, low-32) words of frac(step * f) in 64-bit fixed point:
    the reference's wrapping uint32 arithmetic, in Python integers."""
    q = int(round((f % 1.0) * 2.0 ** 64)) & ((1 << 64) - 1)
    s = int(step) & 0xffffffff
    prod = s * q
    return (prod >> 32) & 0xffffffff, prod & 0xffffffff


def phase_frac_ds(steps, f: float):
    """frac(step * f) as a ds pair exact to 2^-48 (hi truncated from
    below, 0 <= lo), for each host integer of ``steps``: two float32
    CPU tensors of ``steps``' length."""
    words = [_phase_words(s, f) for s in steps]
    u = np.array([w[0] for w in words], dtype=np.uint64)
    low32 = np.array([w[1] for w in words], dtype=np.uint64)
    uh = (u & 0xffffff00).astype(np.float32)   # top 24 bits: exact in f32
    rem = (u & 0xff).astype(np.float32)
    c32, c64 = np.float32(2.0 ** -32), np.float32(2.0 ** -64)
    fh = uh * c32
    fl = rem * c32 + low32.astype(np.float32) * c64
    return torch.from_numpy(fh), torch.from_numpy(fl)


def waveform_ds(kind: str, steps, offset: float, omega: float, dt: float):
    """Double-single source waveform at each host step of ``steps``:
    an (hi, lo) pair of float32 CPU tensors.

    The ds oscillator (``ds.sin2pi`` over the exact fixed-point phase)
    removes the f32 sin's wave-coherent error; the "sin" ramp runs in
    ds too. Non-oscillatory kinds take the f32 waveform with a zero lo
    word. The steps are evaluated as one vector: every op is
    elementwise, so each element has the bits a scalar call would give.
    """
    if kind not in ("sin", "gauss_pulse"):
        hi = torch.tensor([float(waveform(kind, s, offset, omega, dt))
                           for s in steps], dtype=torch.float32)
        return hi, torch.zeros_like(hi)
    f = (omega * dt) / (2.0 * math.pi)
    fh, fl = phase_frac_ds(steps, f)
    fh, fl = ds.add_ff(fh, fl, *ds.pair_tensors((offset * f) % 1.0, fh))
    osc = ds.sin2pi(fh, fl)
    period = 2.0 * math.pi / omega
    st = torch.tensor([int(s) for s in steps], dtype=torch.int64).to(
        torch.float32) + float(np.float32(offset))
    if kind == "sin":
        sph, spl = ds.pair_tensors(np.float64(dt)
                                   / (_RAMP_PERIODS * period), fh)
        th, tl = ds.scale_f(sph, spl, st)
        rh = torch.clamp(th + tl, 0.0, 1.0)
        inside = (rh > 0.0) & (rh < 1.0)
        rl = torch.where(inside, tl, torch.zeros_like(tl))
        rh = torch.where(inside, th, rh)
        # smoothstep r*r*(3-2r) in ds
        r2h, r2l = ds.mul_ff(rh, rl, rh, rl)
        mh, ml = ds.add_f(-2.0 * rh, -2.0 * rl, ds.f32(3.0, rh))
        rmp = ds.mul_ff(r2h, r2l, mh, ml)
        return ds.mul_ff(*osc, *rmp)
    t = st * float(np.float32(dt))
    tau = _PULSE_TAU_PERIODS * period
    t0 = _PULSE_T0_TAUS * tau
    env = torch.exp(-(((t - float(np.float32(t0)))
                       / float(np.float32(tau))) ** 2))
    return ds.scale_f(*osc, env)


class DsSourceTable:
    """amplitude * waveform_ds(kind, t, offset, ...) as host floats
    (hi, lo) per integer step, evaluated in blocks of ``block`` steps:
    one vector evaluation serves many steps, so a step costs a table
    read instead of a few hundred scalar ops."""

    def __init__(self, kind: str, offset: float, omega: float, dt: float,
                 amplitude: float, block: int = 256):
        self.args = (kind, offset, omega, dt)
        self.amplitude = amplitude
        self.block = block
        self.start = None
        self.values = None

    def __call__(self, t: int) -> Tuple[float, float]:
        if self.start is None or not 0 <= t - self.start < self.block:
            kind, offset, omega, dt = self.args
            wh, wl = waveform_ds(kind, range(t, t + self.block), offset,
                                 omega, dt)
            hi, lo = ds.mul_ff(wh, wl,
                               *ds.pair_tensors(self.amplitude, wh))
            self.start = t
            self.values = (hi.tolist(), lo.tolist())
        i = t - self.start
        return self.values[0][i], self.values[1][i]


def waveform(kind: str, step: int, offset: float, omega: float,
             dt: float, real_dtype=np.float32):
    """Scalar source waveform at time ``(step + offset) * dt``.

    kind:
      "sin"         — CW sinusoid with a smooth ramp (smoothstep over
                      _RAMP_PERIODS periods)
      "gauss_pulse" — sine-modulated Gaussian pulse, spectrum centered
                      on omega
      "ricker"      — Ricker wavelet, peak frequency omega/2pi
    """
    rd = real_dtype
    t = (rd(step) + rd(offset)) * rd(dt)
    period = 2.0 * math.pi / omega
    if kind in ("sin", "gauss_pulse"):
        if np.dtype(rd) == np.float64:
            osc = np.sin(omega * t)
        else:
            f = (omega * dt) / (2.0 * math.pi)   # cycles per step (f64)
            frac = _phase_frac(step, f) + np.float32((offset * f) % 1.0)
            osc = np.sin(np.float32(2.0 * math.pi) * frac)
        if kind == "sin":
            ramp = rd(np.clip(t / rd(_RAMP_PERIODS * period), 0.0, 1.0))
            ramp = ramp * ramp * (rd(3.0) - rd(2.0) * ramp)  # smoothstep
            return rd(ramp * osc)
        tau = _PULSE_TAU_PERIODS * period
        t0 = _PULSE_T0_TAUS * tau
        return rd(osc * np.exp(-(((t - rd(t0)) / rd(tau)) ** 2)))
    if kind == "ricker":
        f0 = omega / (2.0 * math.pi)
        t0 = 1.5 / f0
        a = rd((math.pi * f0) ** 2) * (t - rd(t0)) ** 2
        return rd((rd(1.0) - rd(2.0) * a) * np.exp(-a))
    raise ValueError(f"unknown waveform {kind!r}")


def point_mask(gx, gy, gz, pos, active_axes) -> torch.Tensor:
    """One-hot 3D bool mask at a global cell, from 1D coordinate arrays."""
    ms = []
    for a, g, p in ((0, gx, pos[0]), (1, gy, pos[1]), (2, gz, pos[2])):
        m = (g == p) if a in active_axes \
            else torch.ones_like(g, dtype=torch.bool)
        ms.append(m)
    return (ms[0][:, None, None] & ms[1][None, :, None]
            & ms[2][None, None, :])


def host_round(x: float, dtype) -> float:
    """An f32 value rounded on the host to the field dtype ``dtype``, as
    a store rounds it (bf16: round to nearest even); other dtypes keep
    it. A source patch adds its value rounded so, as the reference's
    patches do (``val.astype(field dtype)`` before the add)."""
    if dtype != torch.bfloat16:
        return x
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))
