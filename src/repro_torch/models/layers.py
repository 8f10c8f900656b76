"""Shared model layers: RMSNorm, RoPE, and DSBP-quantizable projections.

Port of ``repro.models.layers``.  Projection weights keep the JAX layout
``(d_in, d_out)`` so ``x @ w`` reads the same in both packages.
"""
from __future__ import annotations

import torch

from repro_torch.core.packed import PackedDSBPWeight, get_quant_method
from repro_torch.core.quantized import PRESETS
from repro_torch.parallel.context import fold_partials

__all__ = ["rms_norm", "rope", "Quant", "dense", "weight", "param_dtype"]


def param_dtype(cfg) -> torch.dtype:
    """The dtype of a config's parameters, activations and KV caches (JAX
    ``model._dtype``): bfloat16 or float32."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def weight(shape, device, dtype=torch.float32) -> torch.nn.Parameter:
    """An uninitialized parameter (no gradient: the port serves), which
    ``model.init`` or ``repro_torch.bridge`` fills."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The mean of squares accumulates in float64: a library reduction sums
    in an order that depends on how many rows it reduces, and an f32 sum
    then differs in the last bit between a batch and its rows (a mesh's
    data split); rounded from float64 the order no longer shows."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True, dtype=torch.float64).to(torch.float32)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


class Quant:
    """The active quantization: a PRESETS key (or config, or None) and the
    registry method that executes it.  ``method=None`` auto-selects
    'dsbp_ref' when a config (or policy mode) is set, 'dense_bf16'
    otherwise.

    ``preset`` may be the string ``"policy"``: per-layer mode.  No global
    config is active; every packed weight runs under the config its own
    container was packed with (``pw.cfg``), so one model serves the mixed
    configs of a :class:`~repro_torch.policy.DSBPPolicy`.  Raw (unpacked)
    weights take the float matmul in that mode: a policy quantizes exactly
    the projections it packed."""

    def __init__(self, preset, method: str | None = None):
        self.per_layer = preset == "policy"
        if self.per_layer:
            self.cfg = None
        elif isinstance(preset, str):
            if preset not in PRESETS:
                raise ValueError(f"unknown quant preset {preset!r}; valid: "
                                 f"{sorted(PRESETS)} or 'policy' (per-layer "
                                 f"packed configs)")
            self.cfg = PRESETS[preset]
        else:
            self.cfg = preset
        if method is None:
            method = "dsbp_ref" if bool(self) else "dense_bf16"
        self.method = get_quant_method(method)

    def __bool__(self):
        return self.cfg is not None or self.per_layer

    def cfg_for(self, w):
        """The config one projection runs under: the global preset, or
        (policy mode) the config its packed container was built with."""
        if self.per_layer:
            return w.cfg if isinstance(w, PackedDSBPWeight) else None
        return self.cfg


def dense(w, x: torch.Tensor, quant: Quant | None = None,
          name: str | None = None) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) through the active quant method
    under ``quant.cfg_for(w)``; ``w`` is a raw tensor or a
    :class:`PackedDSBPWeight`, ``name`` the projection's weight name (the
    key of its tensor-parallel split under a mesh: a quantized
    projection's method folds its own partials, a float row-parallel
    one's partials are summed here)."""
    if quant is not None and quant:
        return quant.method.apply(w, x, quant.cfg_for(w), name=name)
    if isinstance(w, PackedDSBPWeight):
        return get_quant_method("dsbp_ref").apply(w, x, None, name=name)
    return fold_partials(torch.matmul(x, w), name)


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
