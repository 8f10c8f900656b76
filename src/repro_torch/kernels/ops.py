"""Public wrappers around the kernels, in the JAX package's layouts.

Port of the main-path entry of ``repro.kernels.ops``,
``dsbp_matmul_fused`` (:150).  It dispatches by the device of its tensors:
a CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version.  (The JAX GQA attention wrapper, :333, has no
counterpart: the port's attention kernel indexes heads itself.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dsbp import DSBPConfig
from repro_torch.core.formats import per_tensor_scale
from repro_torch.core.packed import PackedDSBPWeight

from .dsbp_fused import dsbp_fused

__all__ = ["dsbp_matmul_fused"]


def dsbp_matmul_fused(x: torch.Tensor, pw: PackedDSBPWeight,
                      input_cfg: DSBPConfig | None = None) -> torch.Tensor:
    """x (..., K) @ packed(K, N) -> (..., N) f32 through the one-pass fused
    DSBP GEMM, off the container's stored kernel-layout operands."""
    if pw.ka.ndim != 2:
        raise ValueError(f"dsbp_matmul_fused needs a 2-D logical weight; got "
                         f"leading axes {tuple(pw.ka.shape[:-2])}")
    if x.shape[-1] != pw.k:
        raise ValueError(f"activation K={x.shape[-1]} != packed logical K={pw.k}")
    batch = x.shape[:-1]
    icfg = input_cfg if input_cfg is not None else pw.cfg.input_cfg
    xm = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if pw.padded_k != pw.k:  # mirror the zero lanes the weights packed with
        xm = F.pad(xm, (0, pw.padded_k - pw.k))
    # computed on the device and passed by pointer: no host sync per call
    ts = per_tensor_scale(xm, icfg.fmt).reshape(1)
    tw = pw.tscale.reshape(-1).expand(pw.n) if pw.tscale.numel() == 1 \
        else pw.tscale.reshape(pw.n)
    y = dsbp_fused(xm, ts, pw.ka, pw.kscale, tw.to(torch.float32), icfg)
    return y.reshape(*batch, pw.n)
