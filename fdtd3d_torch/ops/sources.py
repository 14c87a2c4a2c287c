"""Source waveforms and point-source masks of the PyTorch port.

Counterpart of ``fdtd3d_tpu/ops/sources.py`` (``waveform`` and
``point_mask``). The step counter is a host integer in the port, so the
waveform is evaluated on the host in numpy scalars of the real dtype,
with the same operations in the same order as the reference's traced
version; the result enters the device work as one scalar per step and
costs no device readback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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
