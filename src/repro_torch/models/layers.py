"""Shared model layers: RMSNorm, RoPE, and DSBP-quantizable projections.

Port of ``repro.models.layers``.  Projection weights keep the JAX layout
``(d_in, d_out)`` so ``x @ w`` reads the same in both packages.
"""
from __future__ import annotations

import torch

from repro_torch.core.packed import PackedDSBPWeight, get_quant_method
from repro_torch.core.quantized import PRESETS

__all__ = ["rms_norm", "rope", "Quant", "dense"]


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


class Quant:
    """The active quantization: a PRESETS key (or config, or None) and the
    registry method that executes it.  ``method=None`` auto-selects
    'dsbp_ref' when a config is set, 'dense_bf16' otherwise."""

    def __init__(self, preset, method: str | None = None):
        if isinstance(preset, str):
            if preset not in PRESETS:
                raise ValueError(f"unknown quant preset {preset!r}; valid: "
                                 f"{sorted(PRESETS)}")
            self.cfg = PRESETS[preset]
        else:
            self.cfg = preset
        if method is None:
            method = "dsbp_ref" if self.cfg is not None else "dense_bf16"
        self.method = get_quant_method(method)

    def __bool__(self):
        return self.cfg is not None


def dense(w, x: torch.Tensor, quant: Quant | None = None) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) through the active quant method;
    ``w`` is a raw tensor or a :class:`PackedDSBPWeight`."""
    if quant is not None and quant:
        return quant.method.apply(w, x, quant.cfg)
    if isinstance(w, PackedDSBPWeight):
        return get_quant_method("dsbp_ref").apply(w, x, None)
    return torch.matmul(x, w)


def _rope_angles(positions: torch.Tensor, d_head: int, theta: float):
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Half-split rotary embedding. x: (B, H, S, D), positions: (B, S) or (S,)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    if cos.ndim == 2:  # (S, half) -> broadcast over batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, None], sin[:, None]  # head axis
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
