"""The grouped integer DSBP GEMM (B4): wrapper, plain version, launch count.

``dsbp_matmul(ax, sx, aw, sw, folded=)`` computes ``y (M, N) f32 =
sum_g sx[m,g] * sw[g,n] * dot64_g(ax, aw)`` from aligned input mantissas
``ax`` int32 (M, K), |ax| <= 2048, with group scales ``sx`` (M, K/64)
(B3's outputs) against a packed weight's ``aw = ka`` int8 (K, N) and
``sw = kscale`` (K/64, N) — the second pass of the two-kernel
``dsbp_kernel`` method.

One order for both forms: an exact integer dot per 64-group, then ``y = y
+ dot * (sx * sw)`` in group order.  The JAX kernel's ``folded`` form (one
f32 dot of the pow2-prescaled operands, ``_kernel_folded``) is the same
sum, since every product is exact, taken in an order the TPU's MXU does
not specify; on Hopper the exact group dots are both the fastest route
(int8 tensor cores) and the most exact, so ``folded`` stays in the
signature for the JAX API and no longer changes the result: kernel and
plain version give the same bits for both forms, and the unfolded form's
bits are JAX's.

On a CUDA tensor it launches ``csrc/dsbp_matmul.cu`` (or raises): a
layout pass cuts the 12-bit inputs into int8 halves in a scratch this
wrapper allocates, then B1's integer tensor-core GEMM reads it.  On a CPU
tensor it runs the plain version.  Replaces
``src/repro/kernels/dsbp_matmul.py::dsbp_matmul_kernel_call`` (:84).
"""
from __future__ import annotations

import torch

from . import build
from .dsbp_fused import GROUP

__all__ = ["dsbp_matmul", "dsbp_matmul_plain"]


def dsbp_matmul_plain(ax, sx, aw, sw, *, folded: bool = True) -> torch.Tensor:
    """Exact group dots folded in group order, for either form (see the
    module docstring)."""
    m, k = ax.shape
    n = aw.shape[1]
    ng = k // GROUP
    y = torch.zeros((m, n), dtype=torch.float32, device=ax.device)
    # float64 holds every |dot| < 2**24 exactly on any device and BLAS
    dots = torch.bmm(ax.reshape(m, ng, GROUP).transpose(0, 1).to(torch.float64),
                     aw.reshape(ng, GROUP, n).to(torch.float64)).to(torch.float32)
    for g in range(ng):
        y = y + dots[g] * (sx[:, g:g + 1] * sw[g:g + 1, :])
    return y


def _check(ax, sx, aw, sw):
    m, k = ax.shape
    n = aw.shape[1]
    if k % GROUP or aw.shape != (k, n) or sx.shape != (m, k // GROUP) \
            or sw.shape != (k // GROUP, n):
        raise ValueError(f"dsbp_matmul shapes: ax {tuple(ax.shape)}, sx "
                         f"{tuple(sx.shape)}, aw {tuple(aw.shape)}, sw {tuple(sw.shape)}")
    want = {"ax": (ax, torch.int32), "sx": (sx, torch.float32),
            "aw": (aw, torch.int8), "sw": (sw, torch.float32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt or t.device != ax.device:
            raise ValueError(f"dsbp_matmul: {name} must be {dt} on {ax.device}, "
                             f"got {t.dtype} on {t.device}")


def dsbp_matmul(ax: torch.Tensor, sx: torch.Tensor, aw: torch.Tensor,
                sw: torch.Tensor, *, folded: bool = True) -> torch.Tensor:
    """ax (M, K) int32, sx (M, K/64) f32, aw (K, N) int8, sw (K/64, N) f32
    -> y (M, N) f32."""
    _check(ax, sx, aw, sw)
    if not ax.is_cuda:
        with build.plain_body():
            return dsbp_matmul_plain(ax, sx, aw, sw, folded=folded)
    m, k = ax.shape
    n = aw.shape[1]
    # 16-byte loads of the int32 rows, the weight rows and the kscale rows
    ax, aw, sw = build.aligned(ax), build.aligned(aw), build.aligned(sw)
    sx = sx.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=ax.device)
    # the layout pass's hi | lo int8 halves, 128 bytes per (row, group)
    scratch = torch.empty(m * k * 2, dtype=torch.int8, device=ax.device)
    launch = build.load("dsbp_matmul")
    err = launch(ax.data_ptr(), sx.data_ptr(), aw.data_ptr(), sw.data_ptr(), y.data_ptr(),
                 scratch.data_ptr(), scratch.numel(), m, n, k,
                 torch.cuda.current_stream(ax.device).cuda_stream)
    if err:
        raise RuntimeError(f"dsbp_matmul kernel launch failed: CUDA error {err}")
    dsbp_matmul.launches += 1
    return y


dsbp_matmul.launches = 0
