"""The one-pass DSBP GEMM (B1): wrapper, plain PyTorch version, launch count.

``dsbp_fused(x, ts, ka, kscale, tw, cfg)`` computes the final f32 output
``y (M, N)`` of the paper's datapath from raw activations ``x (M, K')``
against a packed weight in kernel layout.  On a CUDA tensor it launches
``csrc/dsbp_fused.cu`` (or raises): the input path once per (row, group)
into a scratch this wrapper allocates, then the integer tensor-core GEMM
(any N: N % 16 != 0 takes a slower instantiation, never a padded copy of
the weight); on a CPU tensor it
runs :func:`dsbp_fused_plain`, the same stages in PyTorch in the same
order, so the kernel and the plain version agree bit for bit on the card.

Replaces ``src/repro/kernels/dsbp_fused.py::dsbp_fused_kernel_call`` (:73).

B8, :func:`dsbp_fused_sharded_call`, replaces ``dsbp_fused_sharded_call``
(:135): B1 under ``shard_map``.  It is no new kernel body, on the TPU nor
here: each rank launches B1 on its own shards and, for a row-parallel
projection, folds the partial outputs with one ``all_reduce`` after the
in-kernel scale division.  Its plain version is :func:`dsbp_fused_plain`
over the whole weight.
"""
from __future__ import annotations

import torch

from repro_torch.core.dsbp import MAX_SHIFT, DSBPConfig, exact_dot_dtype
from repro_torch.core.formats import exp2i, get_format

from . import build

GROUP = 64

__all__ = ["GROUP", "quant_align_tile", "dsbp_fused", "dsbp_fused_plain",
           "dsbp_fused_sharded_call"]


def _floor_log2(ax: torch.Tensor) -> torch.Tensor:
    """Exponent field of |x| (the kernel's bit read; f32 subnormals give
    -127 and are clamped to the format's emin by every caller)."""
    return ((ax.view(torch.int32) >> 23) & 0xFF) - 127


def _tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (64) in the kernel's order (quant_align.cuh):
    element e + element e+32, then e + 16, e + 8, e + 4, e + 2, e + 1."""
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
    # every |dot| <= 2**24: exact in the type exact_dot_dtype picks
    dt = exact_dot_dtype(x.device)
    dots = torch.bmm(a.reshape(m, ng, GROUP).transpose(0, 1).to(dt),
                     ka.reshape(ng, GROUP, n).to(dt)).to(torch.float32)
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
    x, ts = build.aligned(x), ts.contiguous()  # the input path loads x 16 bytes at a time
    tw = tw.reshape(-1).contiguous()
    ka, kscale = build.aligned(ka), build.aligned(kscale)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    # the input path's output, once per (row, group): a halves and sx
    scratch = torch.empty(m * (kp // GROUP) * (2 * GROUP + 4), dtype=torch.uint8,
                          device=x.device)
    launch = build.load("dsbp_fused")
    err = launch(x.data_ptr(), ts.data_ptr(), ka.data_ptr(), kscale.data_ptr(),
                 tw.data_ptr(), y.data_ptr(), scratch.data_ptr(), scratch.numel(),
                 m, n, kp, f.mbits, f.emin, f.emax,
                 f.max_value, int(cfg.mode == "fixed"), float(cfg.k),
                 int(cfg.b_fix), int(cfg.mantissa_rounding == "trunc"),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dsbp_fused kernel launch failed: CUDA error {err}")
    dsbp_fused.launches += 1
    return y


dsbp_fused.launches = 0


def dsbp_fused_sharded_call(x: torch.Tensor, ts: torch.Tensor, ka: torch.Tensor,
                            kscale: torch.Tensor, tw: torch.Tensor, cfg: DSBPConfig,
                            mesh=None, *, k_axis: str | None = None) -> torch.Tensor:
    """B8: B1 on this rank's shards, partials folded over ``k_axis``.

    ``x (M_l, K'_l)`` holds this rank's rows and K slice, ``ts (1,)`` the
    GLOBAL pow2 input scale (reduced over every rank that splits ``x``
    before the call), ``ka (K'_l, N_l)`` / ``kscale (K'_l/64, N_l)`` /
    ``tw (N_l,)`` the weight's shards (K slices group-aligned, so every
    group lies on one rank).  Each rank quantizes and aligns its own K
    slice and runs B1 (the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors); with ``k_axis`` set (row-parallel), ONE
    ``all_reduce(SUM)`` over that axis of ``mesh`` sums the partial
    outputs.  The partials are integer dots times pow2 scales, so the sum
    equals the single-device group-order sum whenever the f32 group-order
    sum does not round (every input the JAX tests use; not every input:
    heavy-tailed activations with widely spread group exponents differ by
    a few ulps)."""
    y = dsbp_fused(x, ts, ka, kscale, tw, cfg)
    if x.is_cuda:
        dsbp_fused_sharded_call.launches += 1
    if k_axis is not None:
        mesh.all_reduce(y, "sum", k_axis)
    return y


dsbp_fused_sharded_call.launches = 0
