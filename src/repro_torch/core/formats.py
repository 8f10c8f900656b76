"""Bit-exact minifloat (FP8-family) codecs in PyTorch.

Port of ``repro.core.formats``: round-to-nearest-even saturating quantize
with subnormals, exact field extraction, and power-of-two tensor scales.
``2**n`` is assembled from its bit pattern and ``floor(log2|x|)`` comes
from ``torch.frexp``, so every value is exact on any device.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FPFormat",
    "FP8_FORMATS",
    "get_format",
    "exp2i",
    "quantize",
    "decompose",
    "per_tensor_scale",
    "scale_for_amax",
]


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A saturating minifloat format: 1 sign bit + ``ebits`` + ``mbits``."""

    name: str
    ebits: int
    mbits: int
    max_value: float
    bias: int

    @property
    def emin(self) -> int:
        """Unbiased exponent of the smallest *normal* binade."""
        return 1 - self.bias

    @property
    def emax(self) -> int:
        """Unbiased exponent of the largest binade."""
        return (1 << self.ebits) - 1 - self.bias


def _mk(name: str, ebits: int, mbits: int, max_value: float | None = None) -> FPFormat:
    bias = (1 << (ebits - 1)) - 1
    if max_value is None:
        emax = (1 << ebits) - 1 - bias
        max_value = (2.0 - 2.0 ** (-mbits)) * (2.0 ** emax)
    return FPFormat(name, ebits, mbits, float(max_value), bias)


# E4M3 follows the OCP "fn" convention (max 448, no inf); E5M2 saturates at
# its max normal.  E5M3/E5M7 are the fixed alignment targets of Table I.
FP8_FORMATS: dict[str, FPFormat] = {
    "e2m5": _mk("e2m5", 2, 5),
    "e3m4": _mk("e3m4", 3, 4),
    "e4m3": _mk("e4m3", 4, 3, max_value=448.0),
    "e5m2": _mk("e5m2", 5, 2, max_value=57344.0),
    "e5m3": _mk("e5m3", 5, 3),
    "e5m7": _mk("e5m7", 5, 7),
}


def get_format(fmt: str | FPFormat) -> FPFormat:
    if isinstance(fmt, FPFormat):
        return fmt
    try:
        return FP8_FORMATS[fmt.lower()]
    except KeyError as e:
        raise ValueError(f"unknown FP8 format {fmt!r}; have {list(FP8_FORMATS)}") from e


def _floor_log2(ax: torch.Tensor) -> torch.Tensor:
    """floor(log2(|x|)) for positive finite x, exact via frexp."""
    _, e = torch.frexp(ax)  # ax = m * 2**e with m in [0.5, 1)
    return e - 1


def exp2i(n) -> torch.Tensor:
    """Exact 2**n (f32) for integer n in [-126, 127], from the bit pattern."""
    n = torch.as_tensor(n).to(torch.int32)
    return ((n + 127) << 23).view(torch.float32)


def quantize(x: torch.Tensor, fmt: str | FPFormat = "e4m3") -> torch.Tensor:
    """Round ``x`` (f32) to the nearest value of ``fmt``: half to even,
    saturating at ±max_value, with gradual subnormals."""
    f = get_format(fmt)
    x = x.to(torch.float32)
    ax = x.abs()
    e = _floor_log2(torch.where(ax > 0, ax, torch.ones_like(ax)))
    e = torch.clamp(e, min=f.emin)  # subnormal binades share emin's step
    step = exp2i(e - f.mbits)
    q = torch.round(x / step) * step  # torch.round == round-half-even
    q = torch.clamp(q, -f.max_value, f.max_value)
    return torch.where(ax > 0, q, x * 0.0)  # preserves signed zero


def decompose(x: torch.Tensor, fmt: str | FPFormat = "e4m3") -> dict:
    """Quantize to ``fmt`` and return the hardware-visible fields: int32
    ``sign`` (+1/-1), ``e_unb`` (unbiased exponent, ``emin`` for
    subnormals and zero), ``m_int`` (integer significand with the implicit
    bit) and the decoded ``value``."""
    f = get_format(fmt)
    q = quantize(x, f)
    aq = q.abs()
    nz = aq > 0
    e = _floor_log2(torch.where(nz, aq, torch.ones_like(aq)))
    e = torch.clamp(e, f.emin, f.emax)
    m = torch.round(aq * exp2i(f.mbits - e)).to(torch.int32)
    m = torch.where(nz, m, torch.zeros_like(m))
    e = torch.where(nz, e, torch.full_like(e, f.emin)).to(torch.int32)
    sign = torch.where(q < 0, -1, 1).to(torch.int32)
    return {"sign": sign, "e_unb": e, "m_int": m, "value": q}


def per_tensor_scale(x: torch.Tensor, fmt: str | FPFormat, margin: float = 1.0) -> torch.Tensor:
    """Power-of-two per-tensor scale mapping amax(x) into the format's
    range, as a 0-d f32 tensor on x's device (no host sync)."""
    return scale_for_amax(x.abs().max(), fmt, margin)


def scale_for_amax(amax: torch.Tensor, fmt: str | FPFormat, margin: float = 1.0) -> torch.Tensor:
    """:func:`per_tensor_scale` from an already reduced ``amax`` (a
    sharded activation's, reduced over the ranks that split it)."""
    f = get_format(fmt)
    amax = amax.to(torch.float32)
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    _, e = torch.frexp(torch.as_tensor(f.max_value * margin, dtype=torch.float32,
                                       device=amax.device) / amax)
    return exp2i(e - 1)
