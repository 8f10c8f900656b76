"""The one-pass DSBP GEMM (B1): wrapper, plain PyTorch version, launch count.

``dsbp_fused(x, ts, ka, kscale, tw, cfg)`` computes the final f32 output
``y (M, N)`` of the paper's datapath from raw activations ``x (M, K')``
against a packed weight in kernel layout.  On a CUDA tensor it launches
``csrc/dsbp_fused.cu`` (or raises); on a CPU tensor it runs
:func:`dsbp_fused_plain`, the same stages in PyTorch in the same order, so
the kernel and the plain version agree bit for bit on the card.

Replaces ``src/repro/kernels/dsbp_fused.py::dsbp_fused_kernel_call`` (:73).
"""
from __future__ import annotations

import torch

from repro_torch.core.dsbp import MAX_SHIFT, DSBPConfig
from repro_torch.core.formats import exp2i, get_format

from . import build

GROUP = 64

__all__ = ["GROUP", "quant_align_tile", "dsbp_fused", "dsbp_fused_plain"]


def _floor_log2(ax: torch.Tensor) -> torch.Tensor:
    """Exponent field of |x| (the kernel's bit read; f32 subnormals give
    -127 and are clamped to the format's emin by every caller)."""
    return ((ax.view(torch.int32) >> 23) & 0xFF) - 127


def _tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (64) in the kernel's order: lane pairs
    (element l + element l+32), then the xor butterfly 16, 8, 4, 2, 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def quant_align_tile(x: torch.Tensor, cfg: DSBPConfig):
    """Input path of (M, K') f32 activations already multiplied by the
    tensor scale: FP8 quantize, group max exponent, MPU width, FIAU
    alignment.  Returns ``(a int32 (M, K'), scale f32 (M, K'/64), bits
    int32 (M, K'/64))`` — the plain twin of ``csrc/quant_align.cuh`` and
    of ``repro.kernels.fp8_quant_align.quant_align_tile``."""
    f = get_format(cfg.fmt)
    x = x.to(torch.float32)
    m, k = x.shape
    ng = k // GROUP
    one = torch.ones_like(x)

    # ---- FP8 quantize (RNE, saturating) + field extraction ----
    ax = x.abs()
    e = torch.clamp(_floor_log2(torch.where(ax > 0, ax, one)), min=f.emin)
    step = exp2i(e - f.mbits)
    q = torch.clamp(torch.round(x / step) * step, -f.max_value, f.max_value)
    q = torch.where(ax > 0, q, torch.zeros_like(q))
    aq = q.abs()
    e_unb = torch.clamp(_floor_log2(torch.where(aq > 0, aq, one)), f.emin, f.emax)
    m_int = torch.round(aq * exp2i(f.mbits - e_unb))
    nz = aq > 0
    e_unb = torch.where(nz, e_unb, torch.full_like(e_unb, f.emin))

    # ---- group max exponent + shifts ----
    eg = e_unb.reshape(m, ng, GROUP)
    nzg = nz.reshape(m, ng, GROUP)
    e_max = torch.where(nzg, eg, torch.full_like(eg, -(2**30))).amax(dim=-1)
    e_max = torch.where(nzg.any(dim=-1), e_max, torch.zeros_like(e_max))
    shift = torch.clamp(e_max[:, :, None] - eg, 0, MAX_SHIFT)
    shift = torch.where(nzg, shift, torch.full_like(shift, MAX_SHIFT))

    # ---- MPU, Eq. (1) ----
    if cfg.mode == "fixed":
        b = torch.full((m, ng), cfg.b_fix, dtype=torch.int32, device=x.device)
    else:
        w = torch.where(nzg, exp2i(-shift), torch.zeros((), device=x.device))
        num = _tree_sum(shift.to(torch.float32) * w)
        den = _tree_sum(w)
        ratio = num / torch.clamp(den, min=1e-30)
        ratio = torch.where(den > 0, ratio, torch.zeros_like(ratio))
        b = torch.clamp(torch.ceil(cfg.k * ratio + cfg.b_fix), 1, 11).to(torch.int32)

    # ---- FIAU: align to (b+1)-bit signed ints sharing 2**(e_max-(b-1)) ----
    sign = torch.where(q < 0, -1.0, 1.0).reshape(m, ng, GROUP)
    mag = sign * m_int.reshape(m, ng, GROUP) * exp2i(b[:, :, None] - 1 - shift - f.mbits)
    lim = exp2i(b[:, :, None])
    if cfg.mantissa_rounding == "rne":
        a = torch.clamp(torch.round(mag), -(lim - 1.0), lim - 1.0)
    else:
        a = torch.clamp(torch.floor(mag), -lim, lim - 1.0)
    return a.reshape(m, k).to(torch.int32), exp2i(e_max - (b - 1)), b


def dsbp_fused_plain(x, ts, ka, kscale, tw, cfg: DSBPConfig) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: exact 64-deep integer dots per
    group, then ``y += (dot * s/ts) * (kscale/tw)`` in group order."""
    m, kp = x.shape
    n = ka.shape[1]
    ng = kp // GROUP
    ts = ts.reshape(())
    a, s, _ = quant_align_tile(x.to(torch.float32) * ts, cfg)
    sx = s / ts                                  # (M, ng) folded input scales
    sw = kscale / tw.reshape(1, n)               # (ng, N) folded weight scales
    # float64 holds every |dot| < 2**24 exactly on any device and BLAS
    dots = torch.bmm(a.reshape(m, ng, GROUP).transpose(0, 1).to(torch.float64),
                     ka.reshape(ng, GROUP, n).to(torch.float64)).to(torch.float32)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(ng):
        y = y + (dots[g] * sx[:, g:g + 1]) * sw[g:g + 1, :]
    return y


def _check(x, ts, ka, kscale, tw):
    m, kp = x.shape
    n = ka.shape[1]
    if kp % GROUP or ka.shape != (kp, n) or kscale.shape != (kp // GROUP, n):
        raise ValueError(f"dsbp_fused shapes: x {tuple(x.shape)}, ka "
                         f"{tuple(ka.shape)}, kscale {tuple(kscale.shape)}")
    if tw.numel() != n or ts.numel() != 1:
        raise ValueError(f"dsbp_fused scales: ts {tuple(ts.shape)}, tw "
                         f"{tuple(tw.shape)} for N={n}")
    want = {"x": (x, torch.float32), "ts": (ts, torch.float32),
            "ka": (ka, torch.int8), "kscale": (kscale, torch.float32),
            "tw": (tw, torch.float32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt or t.device != x.device:
            raise ValueError(f"dsbp_fused: {name} must be {dt} on {x.device}, "
                             f"got {t.dtype} on {t.device}")


def dsbp_fused(x: torch.Tensor, ts: torch.Tensor, ka: torch.Tensor,
               kscale: torch.Tensor, tw: torch.Tensor,
               cfg: DSBPConfig) -> torch.Tensor:
    """x (M, K') f32 raw activations, ts (1,) pow2 input scale, ka (K', N)
    int8, kscale (K'/64, N) f32, tw (N,) f32 -> y (M, N) f32."""
    _check(x, ts, ka, kscale, tw)
    if not x.is_cuda:
        with build.plain_body():
            return dsbp_fused_plain(x, ts, ka, kscale, tw, cfg)
    m, kp = x.shape
    n = ka.shape[1]
    f = get_format(cfg.fmt)
    x, ts, ka, kscale, tw = (t.contiguous() for t in (x, ts, ka, kscale, tw))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    launch = build.load("dsbp_fused")
    err = launch(x.data_ptr(), ts.data_ptr(), ka.data_ptr(), kscale.data_ptr(),
                 tw.data_ptr(), y.data_ptr(), m, n, kp, f.mbits, f.emin, f.emax,
                 f.max_value, int(cfg.mode == "fixed"), float(cfg.k),
                 int(cfg.b_fix), int(cfg.mantissa_rounding == "trunc"),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dsbp_fused kernel launch failed: CUDA error {err}")
    dsbp_fused.launches += 1
    return y


dsbp_fused.launches = 0
