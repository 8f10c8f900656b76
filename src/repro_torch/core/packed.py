"""Pack-once DSBP weight container and the quantized-linear-method registry.

Port of ``repro.core.packed``.  :class:`PackedDSBPWeight` holds the offline
weight path in **kernel layout** (layout v2), as buffers of an
``nn.Module`` so ``.to(device)`` moves it with the model:

  ka      int8  (..., K', N)   aligned mantissas, reduction axis leading;
                               K' = n_g * G is the group-padded width
  kscale  f32   (..., n_g, N)  per-64-group scales (powers of two)
  tscale  f32   (..., N, 1)    per-channel (or 0-d per-tensor) scale
  bits    int8  (..., N, n_g)  predicted aligned widths B_g

plus the static logical GEMM shape ``(k, n)``, the group size, the
:class:`~repro_torch.core.quantized.QuantizedMatmulConfig` it was packed
under and the layout ``version``.

The registry decides how ``models.layers.dense`` executes a projection:

  dense_bf16   plain matmul, no quantization
  dsbp_ref     reference DSBP numerics (torch grouped int contraction)
  dsbp_kernel  the two-kernel DSBP GEMM: the input path (B3), then the
               grouped integer GEMM (B4) off the stored operands
  dsbp_fused   the one-pass fused DSBP GEMM (CUDA kernel on the card,
               its plain PyTorch version on the CPU) — the serving default
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = [
    "PackedDSBPWeight",
    "LAYOUT_VERSION",
    "to_kernel_layout",
    "QuantMethod",
    "register_quant_method",
    "get_quant_method",
]

LAYOUT_VERSION = 2


def to_kernel_layout(a, scale):
    """``a (..., N, n_g, G)`` / ``scale (..., N, n_g)`` -> ``ka (..., K', N)``
    / ``kscale (..., n_g, N)``: a pure permutation, run once at pack time."""
    lead = a.shape[:-3]
    n, ng, g = a.shape[-3:]
    ka = a.reshape(*lead, n, ng * g).transpose(-1, -2).contiguous()
    return ka, scale.transpose(-1, -2).contiguous()


class PackedDSBPWeight(nn.Module):
    """Offline-quantized DSBP weight for a logical ``(k, n)`` GEMM."""

    def __init__(self, ka, kscale, tscale, bits, *, k, n, group_size, cfg,
                 version: int = LAYOUT_VERSION):
        super().__init__()
        self.register_buffer("ka", ka)
        self.register_buffer("kscale", kscale)
        self.register_buffer("tscale", tscale)
        self.register_buffer("bits", bits)
        self.k = k
        self.n = n
        self.group_size = group_size
        self.cfg = cfg
        self.version = version

    @property
    def padded_k(self) -> int:
        """K rounded up to a multiple of the group (zero-filled lanes)."""
        return self.ka.shape[-2]

    @property
    def a(self) -> torch.Tensor:
        """Legacy ``(..., N, n_g, G)`` aligned-mantissa view of :attr:`ka`."""
        lead = self.ka.shape[:-2]
        kp, n = self.ka.shape[-2:]
        g = self.group_size
        return self.ka.transpose(-1, -2).reshape(*lead, n, kp // g, g)

    @property
    def scale(self) -> torch.Tensor:
        """Legacy ``(..., N, n_g)`` group-scale view of :attr:`kscale`."""
        return self.kscale.transpose(-1, -2)

    def extra_repr(self) -> str:
        return (f"k={self.k}, n={self.n}, group={self.group_size}, "
                f"v{self.version}")

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Back to a dense ``(..., k, n)`` matrix (weight-only consumption)."""
        deq = self.ka.to(dtype) * torch.repeat_interleave(
            self.kscale.to(dtype), self.group_size, dim=-2)
        ts = self.tscale.to(dtype)
        if ts.ndim >= 2:  # per-channel (..., N, 1) -> (..., 1, N)
            ts = ts.transpose(-1, -2)
        if ts.ndim < deq.ndim:
            ts = ts.reshape(*ts.shape, *([1] * (deq.ndim - ts.ndim)))
        return (deq / ts)[..., : self.k, :]


# ---------------------------------------------------------------------------
# Quantized-linear-method registry
# ---------------------------------------------------------------------------

class QuantMethod:
    """How a projection executes: ``apply(w, x, cfg)`` computes the logical
    ``x (..., K) @ w (K, N)``, with ``w`` a raw tensor or a
    :class:`PackedDSBPWeight` and ``cfg`` the active
    ``QuantizedMatmulConfig`` (None = no activation quantization)."""

    name: str = "?"

    def apply(self, w, x, cfg):
        if isinstance(w, PackedDSBPWeight):
            if cfg is None:
                return _matmul(w.dequantize(x.dtype), x)
            return self._apply_packed(w, x, cfg)
        if cfg is None:
            return _matmul(w, x)
        return self._apply_raw(w, x, cfg)

    def _apply_packed(self, pw, x, cfg):
        raise NotImplementedError

    def _apply_raw(self, w, x, cfg):
        raise NotImplementedError


_REGISTRY: dict[str, QuantMethod] = {}


def register_quant_method(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def get_quant_method(name: str) -> QuantMethod:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown quant method {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def _matmul(w, x):
    return torch.matmul(x, w.to(x.dtype))


@register_quant_method
class DenseBF16Method(QuantMethod):
    """No quantization: the float matmul baseline."""

    name = "dense_bf16"

    def apply(self, w, x, cfg):
        del cfg
        if isinstance(w, PackedDSBPWeight):
            w = w.dequantize(x.dtype)
        return _matmul(w, x)


@register_quant_method
class DSBPRefMethod(QuantMethod):
    """Reference DSBP numerics: packed weights take the integer path
    (on-the-fly input quantization + grouped int contraction off the packed
    form); raw weights quantize both operands per call (forward only)."""

    name = "dsbp_ref"

    def _apply_packed(self, pw, x, cfg):
        from . import quantized as Q

        return Q.packed_matmul(x, pw, input_cfg=cfg.input_cfg).to(x.dtype)

    def _apply_raw(self, w, x, cfg):
        from . import quantized as Q

        return Q.dsbp_matmul_ref(x, w, cfg).to(x.dtype)


@register_quant_method
class DSBPKernelMethod(QuantMethod):
    """The two-kernel DSBP GEMM (``kernels.ops.dsbp_matmul_packed``): the
    int8 aligned mantissas of a packed weight feed the grouped GEMM
    directly, under the *active* config's input path.  Raw weights pack
    per call (forward only)."""

    name = "dsbp_kernel"

    def _apply_packed(self, pw, x, cfg):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul_packed(x, pw, input_cfg=cfg.input_cfg).to(x.dtype)

    def _apply_raw(self, w, x, cfg):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul(x, w, cfg).to(x.dtype)


@register_quant_method
class DSBPFusedMethod(QuantMethod):
    """The one-pass fused DSBP GEMM (``kernels.ops.dsbp_matmul_fused``):
    FP8 quantize + predict + align + MAC in one kernel off the container's
    kernel-layout operands.  Raw weights pack per call."""

    name = "dsbp_fused"

    def _apply_packed(self, pw, x, cfg):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul_fused(x, pw, input_cfg=cfg.input_cfg).to(x.dtype)

    def _apply_raw(self, w, x, cfg):
        from . import quantized as Q

        return self._apply_packed(Q.pack_weights(w, cfg), x, cfg)
