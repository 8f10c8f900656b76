"""The standalone DSBP input path (B3): wrapper, plain version, launch count.

``fp8_quant_align(x, cfg)`` maps ``x (M, K)`` f32, already multiplied by
the per-tensor scale, to ``(a int32 (M, K), scale f32 (M, K/64), bits
int32 (M, K/64))``: FP8 quantize, group max exponent, MPU width, FIAU
alignment — the first pass of the two-kernel ``dsbp_kernel`` method.  On
a CUDA tensor it launches ``csrc/fp8_quant_align.cu`` (or raises); on a
CPU tensor it runs the plain version, ``dsbp_fused.quant_align_tile``,
which B1's input path shares, so B3 and B1 align the same values to the
same bits.

Replaces ``src/repro/kernels/fp8_quant_align.py::fp8_quant_align_kernel_call``
(:123).
"""
from __future__ import annotations

import torch

from repro_torch.core.dsbp import DSBPConfig
from repro_torch.core.formats import get_format

from . import build
from .dsbp_fused import GROUP, quant_align_tile

__all__ = ["fp8_quant_align", "fp8_quant_align_plain"]


def fp8_quant_align_plain(x: torch.Tensor, cfg: DSBPConfig):
    return quant_align_tile(x, cfg)


def fp8_quant_align(x: torch.Tensor, cfg: DSBPConfig):
    """x (M, K) f32 pre-scaled, K a multiple of 64 -> (a, scale, bits)."""
    if x.ndim != 2 or x.shape[1] % GROUP:
        raise ValueError(f"fp8_quant_align takes (M, K) with K % {GROUP} == 0, "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"fp8_quant_align takes float32, got {x.dtype}")
    if not x.is_cuda:
        with build.plain_body():
            return fp8_quant_align_plain(x, cfg)
    m, k = x.shape
    f = get_format(cfg.fmt)
    x = x.contiguous()
    a = torch.empty((m, k), dtype=torch.int32, device=x.device)
    scale = torch.empty((m, k // GROUP), dtype=torch.float32, device=x.device)
    bits = torch.empty((m, k // GROUP), dtype=torch.int32, device=x.device)
    launch = build.load("fp8_quant_align")
    err = launch(x.data_ptr(), a.data_ptr(), scale.data_ptr(), bits.data_ptr(), m, k,
                 f.mbits, f.emin, f.emax, f.max_value, int(cfg.mode == "fixed"),
                 float(cfg.k), int(cfg.b_fix), int(cfg.mantissa_rounding == "trunc"),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fp8_quant_align kernel launch failed: CUDA error {err}")
    fp8_quant_align.launches += 1
    return a, scale, bits


fp8_quant_align.launches = 0
