"""Bit-exact model of the Mantissa Prediction Unit (MPU), Fig. 3.

Port of ``repro.core.mpu``.  The MPU evaluates Eq. (1) of the paper on 64
shift values per group with a 3-stage pipeline:

  Stage 1: 64 parallel shift units, shift_i >> shift_i and 1 >> shift_i
           (fixed point: operands carry F fractional bits).
  Stage 2: two 64-input adder trees.
  Stage 3: division via an 8-bit reciprocal LUT (no divider), multiply by
           k, add B_fix, saturate to 5 bits.

Every intermediate is an int32 of a defined width, so the model is
integer-exact on any device and equals the JAX package's bit for bit.
:func:`repro_torch.core.dsbp.predict_bdyn` is its floating-point oracle.

Fixed-point conventions (DESIGN.md §3):
  F        = 12 fractional bits for the 2**-shift operands (shifts > 12
             underflow to 0, like the truncated hardware register).
  LUT      = round(2**15 / d) for the 8-bit normalized divisor d in [128,255].
  k        = unsigned fixed point with KF=4 fractional bits.
  ratio    carries Q=6 fractional bits into the k multiplier.
"""
from __future__ import annotations

import numpy as np
import torch

from .dsbp import MAX_SHIFT

__all__ = ["MPU_F", "MPU_KF", "MPU_Q", "reciprocal_lut", "mpu_ratio", "mpu_predict"]

MPU_F = 12  # stage-1 fractional bits
MPU_KF = 4  # k fractional bits
MPU_Q = 6  # ratio fractional bits fed to the k multiplier
_LUT_BITS = 15

# 256-entry LUT, built once on the host; only indices 128..255 are
# reachable after normalization
_RECIP = np.zeros(256, np.int32)
_RECIP[1:] = np.round((1 << _LUT_BITS) / np.arange(1, 256)).astype(np.int32)
reciprocal_lut = torch.from_numpy(_RECIP)


def _shift(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x * 2**-t for either sign of t: x >> t, else x << -t.  Both shift
    amounts are clamped at 0 (torch's shift by a negative amount is
    undefined), as JAX's ``maximum(t, 0)`` guards do."""
    return torch.where(t >= 0, x >> t.clamp(min=0), x << (-t).clamp(min=0))


def _stage1(shift: torch.Tensor, nz: torch.Tensor):
    """shift_i >> shift_i and 1 >> shift_i at F fractional bits."""
    s = shift.clamp(0, MAX_SHIFT).to(torch.int32)
    zero = torch.zeros_like(s)
    num = torch.where(nz, (s << MPU_F) >> s, zero)
    den = torch.where(nz, torch.full_like(s, 1 << MPU_F) >> s, zero)
    return num, den


def _stage2(num: torch.Tensor, den: torch.Tensor):
    """64-input adder trees (exact in int32: sums < 2**23 / 2**19)."""
    return num.sum(dim=-1, dtype=torch.int32), den.sum(dim=-1, dtype=torch.int32)


def _normalize_u8(den_sum: torch.Tensor):
    """den_sum = d * 2**t with d in [128, 255] (d = 0 iff den_sum = 0).

    den_sum <= 64 * 2**F = 2**18: exact in f32, so frexp gives the exact
    MSB position (hardware: a priority encoder).
    """
    _, e = torch.frexp(den_sum.to(torch.float32))  # den = m * 2**e, m in [.5, 1)
    t = e.to(torch.int32) - 8  # d = den >> t in [128, 255]
    d = _shift(den_sum, t)
    d = torch.where(den_sum > 0, d.clamp(1, 255), torch.zeros_like(d))
    return d.to(torch.int32), t


def mpu_ratio(shift: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """Stages 1-3a: the LUT-divided ratio with MPU_Q fractional bits (int32)."""
    num, den = _stage2(*_stage1(shift, nz))
    d, t = _normalize_u8(den)
    recip = reciprocal_lut.to(d.device)[d.long()]
    # num/den = num * recip / (2**LUT_BITS * 2**t), kept at Q fractional
    # bits; num_sum <= 64 * 2**(F-1) = 2**17 and recip <= 2**8 after
    # normalization, so the product fits a 25-bit (int32) multiplier
    ratio = _shift(num * recip, _LUT_BITS + t - MPU_Q)
    return torch.where(den > 0, ratio, torch.zeros_like(ratio)).to(torch.int32)


def mpu_predict(shift: torch.Tensor, nz: torch.Tensor, k_fixed: int, b_fix: int,
                ceil_output: bool = True) -> torch.Tensor:
    """Full MPU: B_g = sat5( k * ratio + B_fix ).

    ``k_fixed`` is k in MPU_KF-bit fixed point (e.g. k=2 -> 32).
    ``ceil_output=True`` applies the input path's hardware round-up; the
    weight path (offline) never goes through the MPU.
    """
    ratio = mpu_ratio(shift, nz)  # Q frac bits; <= 31 * 2**Q = 2**11
    acc = int(k_fixed) * ratio + (int(b_fix) << (MPU_Q + MPU_KF))
    frac = MPU_Q + MPU_KF
    if ceil_output:
        b = -((-acc) >> frac)  # ceil for non-negative acc
    else:
        b = (acc + (1 << (frac - 1))) >> frac
    return b.clamp(0, 31).to(torch.int32)  # 5-bit saturation
