"""Double-single (float-float) arithmetic on torch tensors.

Counterpart of ``fdtd3d_tpu/ops/ds.py``. A value is carried as an
unevaluated sum ``hi + lo`` of two float32 words with ``|lo| <=
ulp(hi)/2``, which gives about 2^-47 of effective significand on the
f32 units. The classic error-free transformations (Dekker 1971, Knuth
TAOCP 4.2.2): ``two_sum``/``two_diff`` (exact rounding error of a +- b),
``two_prod`` (exact error of a * b by Dekker splitting at 2^12), and the
pair combinations ``add_ff``/``sub_ff``/``add_f``/``mul_ff``/``scale_f``,
each renormalised with the full 6-op ``two_sum``.

Every function takes and returns ``(hi, lo)`` pairs of float32 tensors
(any broadcastable shapes, 0-d included). Constants are passed as
float32 tensors, never as Python floats that would meet a float32 word
in a host-side product: ``split`` of a Python float would run in double.

Rounding contract. Each eager torch op rounds its result once, so the
EFT sequences here are exact without the reference's optimisation
barriers. That holds only while every ds expression is written as
separate elementwise ops: never use a fused torch op (``addcmul``,
``addcdiv``, ``lerp``, ``baddbmm``, ...) in one, since their CPU kernels
may contract a product and a sum into one FMA. Never run this module
under ``torch.compile``, which may fuse and contract the same way. The
CUDA twin (``csrc/packed_ds.cu``) writes each operation with an
explicitly rounded intrinsic and is built with ``--fmad=false``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

# Dekker split point for f32: 2^ceil(24/2) + 1.
_SPLIT = 4097.0


def f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a 0-d tensor on ``like``'s device (its
    value rounded to f32 once, on the host)."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=like.device)


def two_sum(a, b) -> Pair:
    """Exact a + b = s + err, no precondition (6 flops, Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def two_diff(a, b) -> Pair:
    """Exact a - b = s + err, no precondition (6 flops)."""
    s = a - b
    bb = s - a
    err = (a - (s - bb)) - (b + bb)
    return s, err


def split(a) -> Pair:
    """a = hi + lo with hi carrying the top 12 significand bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b) -> Pair:
    """Exact a * b = p + err (17 flops; Dekker, no fma)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add_ff(ah, al, bh, bl) -> Pair:
    """(ah,al) + (bh,bl), error O(eps^2) (Dekker add, 20 flops)."""
    sh, se = two_sum(ah, bh)
    te, tf = two_sum(al, bl)
    se = se + te
    sh, se = two_sum(sh, se)
    se = se + tf
    return two_sum(sh, se)


def sub_ff(ah, al, bh, bl) -> Pair:
    return add_ff(ah, al, -bh, -bl)


def add_f(ah, al, b) -> Pair:
    """(ah,al) + plain-f32 b (10 flops)."""
    sh, se = two_sum(ah, b)
    se = se + al
    return two_sum(sh, se)


def mul_ff(ah, al, bh, bl) -> Pair:
    """(ah,al) * (bh,bl), error O(eps^2) (24 flops)."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return two_sum(p, e)


def scale_f(ah, al, b) -> Pair:
    """(ah,al) * plain-f32 b (21 flops)."""
    p, e = two_prod(ah, b)
    e = e + al * b
    return two_sum(p, e)


def neg(ah, al) -> Pair:
    return -ah, -al


def to_f32(ah, al):
    """Collapse to the nearest single f32 (hi absorbs lo by invariant)."""
    return ah + al


def from_f64(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split of a float64 numpy array or scalar into (hi, lo)
    float32 numpy values (setup-time only)."""
    hi = np.asarray(x, np.float64).astype(np.float32)
    lo = (np.asarray(x, np.float64) - hi.astype(np.float64)) \
        .astype(np.float32)
    return hi, lo


def as_f32(v, like: torch.Tensor) -> torch.Tensor:
    """A coefficient as a float32 tensor: a tensor as it is, a scalar
    (a host float) as a 0-d tensor of its f32 value."""
    return v if isinstance(v, torch.Tensor) else f32(v, like)


def pair_tensors(x, like: torch.Tensor) -> Pair:
    """``from_f64(x)`` of a scalar as two 0-d float32 tensors."""
    hi, lo = from_f64(np.float64(x))
    return f32(hi, like), f32(lo, like)


# ---------------------------------------------------------------------------
# double-single sin(2*pi*x): the source oscillator
# ---------------------------------------------------------------------------
# An f32 sin has ~eps32 relative error that is coherent with the wave;
# Taylor evaluation in ds restores ~2^-45.

def _taylor_coeffs():
    sin_c = [from_f64(((-1.0) ** k) / math.factorial(2 * k + 1))
             for k in range(11)]
    cos_c = [from_f64(((-1.0) ** k) / math.factorial(2 * k))
             for k in range(11)]
    return sin_c, cos_c


_SIN_C, _COS_C = _taylor_coeffs()


def _horner(cs, zh, zl):
    ph, pl = (f32(v, zh) for v in cs[-1])
    for c in cs[-2::-1]:
        ph, pl = mul_ff(ph, pl, zh, zl)
        ph, pl = add_ff(ph, pl, f32(c[0], zh), f32(c[1], zh))
    return ph, pl


def sin2pi(fh, fl) -> Pair:
    """sin(2*pi*(fh + fl)) as a ds pair, |error| ~ 2^-45.

    The input is a ds phase fraction in turns, fh >= 0 truncated from
    below with 0 <= fl (``sources.phase_frac_ds``'s layout); any f in
    [0, 2) is accepted. The quadrant reduction is exact: 4*fh is an
    exact f32 product and 4*fh - q is exact by Sterbenz.
    """
    pio2 = pair_tensors(np.float64(np.pi) / 2.0, fh)
    xh = fh * 4.0
    xl = fl * 4.0
    q = torch.floor(xh)
    rh, rl = two_sum(xh - q, xl)
    th, tl = mul_ff(rh, rl, *pio2)                  # theta in [0, pi/2)
    zh, zl = mul_ff(th, tl, th, tl)                 # theta^2
    sh_, sl_ = _horner(_SIN_C, zh, zl)
    sh_, sl_ = mul_ff(th, tl, sh_, sl_)             # sin(theta)
    ch_, cl_ = _horner(_COS_C, zh, zl)              # cos(theta)
    qm = torch.remainder(q, 4.0)
    out = []
    for s_, c_ in ((sh_, ch_), (sl_, cl_)):
        out.append(torch.where(qm == 0.0, s_,
                               torch.where(qm == 1.0, c_,
                                           torch.where(qm == 2.0, -s_,
                                                       -c_))))
    return out[0], out[1]
