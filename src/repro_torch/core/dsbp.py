"""Dynamic Shift-aware Bitwidth Prediction (DSBP), Algorithm 1 of the paper.

Port of ``repro.core.dsbp``.  Per 64-group of the reduction axis:

    E_max   = max_i E_i                       (zeros excluded)
    shift_i = E_max - E_i
    ratio   = sum_i shift_i*2^-shift_i / sum_i 2^-shift_i
    B_g     = round_to_valid(k*ratio + B_fix)   (MPU, Eq. 1; or ceil(ratio)
              first for the offline weight path, Algorithm 1)

and every element aligns to a (B_g+1)-bit signed integer sharing the group
scale 2**(E_max-(B_g-1)).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F

from .formats import FPFormat, decompose, exp2i, get_format, per_tensor_scale

__all__ = [
    "DSBPConfig",
    "WEIGHT_VALID_WIDTHS",
    "INPUT_WIDTH_RANGE",
    "MAX_SHIFT",
    "group_reshape",
    "group_shifts",
    "predict_bdyn",
    "round_to_valid_weight",
    "round_to_valid_input",
    "align_group",
    "per_row_scale",
    "dsbp_quantize",
    "exact_dot_dtype",
]

WEIGHT_VALID_WIDTHS = (1, 3, 5, 7)
INPUT_WIDTH_RANGE = (1, 11)
MAX_SHIFT = 31  # shifts saturate here, as the macro's MPU registers do


def exact_dot_dtype(device: torch.device) -> torch.dtype:
    """The float type the exact integer group dots run in: |A_i| <= 2**11,
    |A_w| <= 2**7, so every product and every partial sum of a 64-deep dot
    is an integer of magnitude <= 2**24, exact in float32 in any order.
    float32 on the CPU while torch's float32 matmuls run at full precision
    (half the bytes and twice the speed of float64, bit-identical), float64
    anywhere else, exact whatever the precision setting (TF32 on the card)."""
    if torch.device(device).type == "cpu" and torch.get_float32_matmul_precision() == "highest":
        return torch.float32
    return torch.float64


@dataclasses.dataclass(frozen=True)
class DSBPConfig:
    """Hyperparameters of one DSBP operand path (inputs or weights)."""

    fmt: str = "e4m3"
    k: float = 1.0
    b_fix: int = 6
    group_size: int = 64
    side: Literal["input", "weight"] = "input"
    mode: Literal["dsbp", "fixed"] = "dsbp"
    predictor: Literal["algorithm1", "mpu"] = "mpu"
    mantissa_rounding: Literal["rne", "trunc"] = "rne"
    scale_granularity: Literal["tensor", "row"] = "tensor"

    def __post_init__(self):
        # the weight path is computed offline with Algorithm 1
        if self.side == "weight" and self.predictor == "mpu":
            object.__setattr__(self, "predictor", "algorithm1")

    @property
    def format(self) -> FPFormat:
        return get_format(self.fmt)


def group_reshape(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(..., K) -> (..., K//G, G), zero-padding K up to a multiple of G."""
    k = x.shape[-1]
    pad = (-k) % group_size
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (k + pad) // group_size, group_size)


def group_shifts(e_unb: torch.Tensor, m_int: torch.Tensor):
    """Per-group shifts of grouped fields (..., n_g, G).  Zeros are
    excluded from the max and get the saturated shift.  Returns
    (shift, e_max, nonzero_mask)."""
    nz = m_int != 0
    e_eff = torch.where(nz, e_unb, torch.full_like(e_unb, -(2**30)))
    e_max = e_eff.amax(dim=-1)
    e_max = torch.where(nz.any(dim=-1), e_max, torch.zeros_like(e_max))
    shift = torch.clamp(e_max[..., None] - e_unb, 0, MAX_SHIFT)
    shift = torch.where(nz, shift, torch.full_like(shift, MAX_SHIFT))
    return shift.to(torch.int32), e_max.to(torch.int32), nz


def predict_bdyn(shift: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """Raw weighted-average ratio sum(shift*2^-shift)/sum(2^-shift); 0.0
    for all-zero groups."""
    w = exp2i(-shift) * nz.to(torch.float32)
    num = (shift.to(torch.float32) * w).sum(dim=-1)
    den = w.sum(dim=-1)
    ratio = num / torch.clamp(den, min=1e-30)
    return torch.where(den > 0, ratio, torch.zeros_like(ratio))


def round_to_valid_weight(b_raw: torch.Tensor) -> torch.Tensor:
    """Nearest of {1,3,5,7} (ties up): the macro's weight widths."""
    b = torch.clamp(b_raw, WEIGHT_VALID_WIDTHS[0], WEIGHT_VALID_WIDTHS[-1])
    idx = torch.floor((b - 1.0) / 2.0 + 0.5)
    return (2 * idx + 1).to(torch.int32)


def round_to_valid_input(b_raw: torch.Tensor) -> torch.Tensor:
    """Hardware-friendly round-up to the continuous 1..11 input widths."""
    lo, hi = INPUT_WIDTH_RANGE
    return torch.clamp(torch.ceil(b_raw), lo, hi).to(torch.int32)


def _predict_b(shift: torch.Tensor, nz: torch.Tensor, cfg: DSBPConfig) -> torch.Tensor:
    if cfg.mode == "fixed":
        raw = torch.full(shift.shape[:-1], float(cfg.b_fix), dtype=torch.float32,
                         device=shift.device)
    elif cfg.predictor == "algorithm1":
        raw = cfg.k * torch.ceil(predict_bdyn(shift, nz)) + cfg.b_fix
    else:  # 'mpu', Eq. (1)
        raw = cfg.k * predict_bdyn(shift, nz) + cfg.b_fix
    if cfg.side == "weight":
        return round_to_valid_weight(raw)
    return round_to_valid_input(raw)


def align_group(sign, m_int, mbits: int, shift, e_max, b, rounding: str = "rne"):
    """Align grouped fields to (B+1)-bit signed integers + group scale
    (each element's exponent enters through its shift).  Returns
    (a int32 (..., n_g, G), scale f32 (..., n_g))."""
    b_e = b[..., None]
    # s_i * 2**(B-1-shift) == m_int * 2**(B-1-shift-mbits), sign applied
    mag = sign.to(torch.float32) * m_int.to(torch.float32) * exp2i(b_e - 1 - shift - mbits)
    lim = exp2i(b_e)  # 2**B
    if rounding == "rne":
        a = torch.clamp(torch.round(mag), -(lim - 1.0), lim - 1.0)
    else:
        # FIAU serial read of the 2's-complement register: floor division,
        # 2c range [-2^B, 2^B-1]
        a = torch.clamp(torch.floor(mag), -lim, lim - 1.0)
    return a.to(torch.int32), exp2i(e_max - (b - 1))


def per_row_scale(x: torch.Tensor, fmt, margin: float = 1.0) -> torch.Tensor:
    """Power-of-two scale per row (all-but-last axes), LLM-FP4-style
    per-channel weight scaling."""
    f = get_format(fmt)
    amax = x.abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    _, e = torch.frexp(f.max_value * margin / amax)
    return exp2i(e - 1)


def dsbp_quantize(x: torch.Tensor, cfg: DSBPConfig) -> dict:
    """Full DSBP pipeline along the last axis: f32 tensor -> dict of
    ``a`` int32 (..., n_g, G), ``scale`` f32 (..., n_g), ``bits`` int32
    (..., n_g), ``tscale`` (0-d or (..., 1)) and the FP8 ``value``."""
    f = cfg.format
    x = x.to(torch.float32)
    if cfg.scale_granularity == "row":
        tscale = per_row_scale(x, f)
    else:
        tscale = per_tensor_scale(x, f)
    fields = decompose(x * tscale, f)
    sign = group_reshape(fields["sign"], cfg.group_size)
    e_unb = group_reshape(fields["e_unb"], cfg.group_size)
    m_int = group_reshape(fields["m_int"], cfg.group_size)
    shift, e_max, nz = group_shifts(e_unb, m_int)
    b = _predict_b(shift, nz, cfg)
    a, scale = align_group(sign, m_int, f.mbits, shift, e_max, b,
                           cfg.mantissa_rounding)
    return {"a": a, "scale": scale, "bits": b, "tscale": tscale,
            "value": fields["value"]}
