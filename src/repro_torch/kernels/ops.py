"""Public wrappers around the kernels, in the JAX package's layouts.

Port of ``repro.kernels.ops``: ``fp8_quant_align`` (:92),
``dsbp_matmul_packed`` (:102), ``dsbp_matmul_fused`` (:150),
``dsbp_matmul_fused_sharded`` (:190),
``dsbp_matmul`` (:274), the straight-through QAT products
``dsbp_matmul_ste`` (:293) and ``dsbp_matmul_fused_ste`` (:319), and the two
dispatch contracts
``count_weight_transposes`` (:52) and ``count_kv_dequants`` (:386),
``quant_sat_stats`` (:444, the quantize-path health statistic of
``repro_torch.obs.health``), plus the paged cache's ``count_kv_gathers``
(no JAX counterpart: the JAX model reads a paged pool through a gathered
view) and the numeric guard's reduction ``finite_flags`` (JAX's engine
jits its own).  Each
wrapper dispatches by the device of its tensors: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the kernel's plain PyTorch version.
(The JAX GQA attention wrappers, :333 and :354, have no counterpart: the
port's attention kernels index heads themselves.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.dsbp import DSBPConfig
from repro_torch.core.formats import get_format, per_tensor_scale, scale_for_amax
from repro_torch.core.packed import PackedDSBPWeight

from . import build
from . import fp8_quant_align as _qa
from .dsbp_fused import dsbp_fused, dsbp_fused_sharded_call
from .dsbp_matmul import dsbp_matmul as _dsbp_matmul

__all__ = ["fp8_quant_align", "dsbp_matmul_packed", "dsbp_matmul_fused",
           "dsbp_matmul_fused_sharded", "dsbp_matmul", "dsbp_matmul_ste",
           "dsbp_matmul_fused_ste",
           "count_weight_transposes", "count_kv_dequants", "count_kv_gathers",
           "quant_sat_stats", "sat_counts", "finite_flags"]


def _check_packed_2d(pw: PackedDSBPWeight, x: torch.Tensor, name: str) -> None:
    if pw.ka.ndim != 2:
        raise ValueError(f"{name} needs a 2-D logical weight; got leading axes "
                         f"{tuple(pw.ka.shape[:-2])}")
    if x.shape[-1] != pw.k:
        raise ValueError(f"activation K={x.shape[-1]} != packed logical K={pw.k}")


def _rows(x: torch.Tensor, pw: PackedDSBPWeight) -> torch.Tensor:
    """x (..., K) as f32 rows (M, K'), zero lanes mirroring the ones the
    weights packed with."""
    xm = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if pw.padded_k != pw.k:
        xm = F.pad(xm, (0, pw.padded_k - pw.k))
    return xm


def fp8_quant_align(x: torch.Tensor, cfg: DSBPConfig) -> dict:
    """On-the-fly input path (B3): (M, K) f32 -> aligned ints, group
    scales, widths and the pow2 tensor scale (computed on the device)."""
    ts = per_tensor_scale(x, cfg.fmt)
    a, s, b = _qa.fp8_quant_align(x * ts, cfg)
    return {"a": a, "scale": s, "bits": b, "tscale": ts}


def dsbp_matmul_packed(x: torch.Tensor, pw: PackedDSBPWeight,
                       input_cfg: DSBPConfig | None = None,
                       folded: bool = True) -> torch.Tensor:
    """The two-kernel DSBP GEMM: x (..., K) @ packed(K, N) -> (..., N) f32
    through B3 (input path) then B4 (grouped integer GEMM) off the
    container's stored kernel-layout operands, then ``y / (ts * tw)``."""
    _check_packed_2d(pw, x, "dsbp_matmul_packed")
    batch = x.shape[:-1]
    icfg = input_cfg if input_cfg is not None else pw.cfg.input_cfg
    qx = fp8_quant_align(_rows(x, pw), icfg)
    y = _dsbp_matmul(qx["a"], qx["scale"], pw.ka, pw.kscale, folded=folded)
    tw = pw.tscale.reshape(1, -1) if pw.tscale.ndim else pw.tscale
    return (y / (qx["tscale"] * tw)).reshape(*batch, pw.n)


def dsbp_matmul_fused(x: torch.Tensor, pw: PackedDSBPWeight,
                      input_cfg: DSBPConfig | None = None) -> torch.Tensor:
    """x (..., K) @ packed(K, N) -> (..., N) f32 through the one-pass fused
    DSBP GEMM (B1), off the container's stored kernel-layout operands."""
    _check_packed_2d(pw, x, "dsbp_matmul_fused")
    batch = x.shape[:-1]
    icfg = input_cfg if input_cfg is not None else pw.cfg.input_cfg
    xm = _rows(x, pw)
    # computed on the device and passed by pointer: no host sync per call
    ts = per_tensor_scale(xm, icfg.fmt).reshape(1)
    tw = pw.tscale.reshape(-1).expand(pw.n) if pw.tscale.numel() == 1 \
        else pw.tscale.reshape(pw.n)
    y = dsbp_fused(xm, ts, pw.ka, pw.kscale, tw.to(torch.float32), icfg)
    return y.reshape(*batch, pw.n)


def _axes_tuple(ax) -> tuple:
    if not ax:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def dsbp_matmul_fused_sharded(x: torch.Tensor, pw: PackedDSBPWeight, mesh,
                              input_cfg: DSBPConfig | None = None, *, batch_axis=None,
                              k_axis: str | None = None,
                              n_axis: str | None = None) -> torch.Tensor:
    """The fused DSBP GEMM on one rank of a mesh: this rank's shards
    ``x (..., K_l) @ pw (K_l, N_l) -> (..., N_l)``, through B8.

    The axes say how the operands were cut (the engine's plan,
    ``parallel.sharding.serve_cuts``, applies JAX's divisibility fallbacks,
    :244-257, when it cuts them): ``batch_axis`` splits the token rows,
    ``k_axis`` the contraction (row-parallel: the partial outputs are
    summed over it, inside B8), ``n_axis`` the output columns
    (column-parallel: each rank keeps its own, no collective).  The
    per-tensor input scale is the GLOBAL one, as JAX computes it before
    its ``shard_map``: this rank's amax goes through ``all_reduce(MAX)``
    over every axis that splits ``x``, on the device (no host sync), then
    through the same pow2 formula."""
    _check_packed_2d(pw, x, "dsbp_matmul_fused_sharded")
    if k_axis is not None and (k_axis == n_axis or k_axis in _axes_tuple(batch_axis)):
        raise ValueError(f"axis {k_axis!r} cannot split K and another dim")
    batch = x.shape[:-1]
    icfg = input_cfg if input_cfg is not None else pw.cfg.input_cfg
    xm = _rows(x, pw)
    amax = xm.abs().max().reshape(1)
    for axis in _axes_tuple(batch_axis) + _axes_tuple(k_axis):
        mesh.all_reduce(amax, "max", axis)
    ts = scale_for_amax(amax, icfg.fmt)
    tw = pw.tscale.reshape(-1).expand(pw.n) if pw.tscale.numel() == 1 \
        else pw.tscale.reshape(pw.n)
    y = dsbp_fused_sharded_call(xm, ts, pw.ka, pw.kscale, tw.to(torch.float32), icfg,
                                mesh, k_axis=k_axis)
    return y.reshape(*batch, pw.n)


def dsbp_matmul(x: torch.Tensor, w: torch.Tensor, cfg, folded: bool = True) -> torch.Tensor:
    """Both kernels with the weight packed per call (a convenience: the
    engine packs once and calls :func:`dsbp_matmul_packed`)."""
    from repro_torch.core.quantized import pack_weights

    return dsbp_matmul_packed(x, pack_weights(w, cfg), folded=folded)


def dsbp_matmul_ste(x: torch.Tensor, w: torch.Tensor, cfg) -> torch.Tensor:
    """Kernel forward (B3 then B4, the weight packed per call),
    straight-through backward: QAT through the 'dsbp_kernel' method."""
    from repro_torch.core.quantized import STEProduct

    return STEProduct.apply(x, w, cfg, dsbp_matmul)


def _fused_forward(x, w, cfg):
    from repro_torch.core.quantized import pack_weights

    return dsbp_matmul_fused(x, pack_weights(w, cfg))


def dsbp_matmul_fused_ste(x: torch.Tensor, w: torch.Tensor, cfg) -> torch.Tensor:
    """Fused-kernel forward (the weight packed per call, then B1),
    straight-through backward: QAT through the 'dsbp_fused' method sees
    the exact serving numerics while keeping full-precision gradients."""
    from repro_torch.core.quantized import STEProduct

    return STEProduct.apply(x, w, cfg, _fused_forward)


def sat_counts(x: torch.Tensor, fmt, tscale: torch.Tensor) -> tuple:
    """Device-side body of :func:`quant_sat_stats`: int64 0-d tensors
    (overflow, underflow, nonfinite) of ``x`` against ``fmt`` under
    ``tscale`` (a 0-d f32 tensor; <= 0 takes the per-call scale of the
    finite values), and the scale used.  Nothing crosses to the host."""
    f = get_format(fmt)
    x = x.to(torch.float32)
    finite = torch.isfinite(x)
    xz = torch.where(finite, x, torch.zeros_like(x))
    ts = torch.where(tscale > 0, tscale, per_tensor_scale(xz, f))
    ax = xz.abs() * ts
    overflow = ((ax > f.max_value) & finite).sum()
    underflow = ((ax > 0) & (ax < 2.0 ** f.emin) & finite).sum()
    return overflow, underflow, (~finite).sum(), ts


def quant_sat_stats(x: torch.Tensor, cfg, tscale: float | None = None) -> dict:
    """Overflow / underflow / non-finite counts of ``x`` against a target
    FP format, the quantize-path health statistic of "FP8 Formats for Deep
    Learning" (read by :mod:`repro_torch.obs.health`).

    ``cfg`` is a :class:`DSBPConfig` (its ``fmt``), an ``FPFormat`` or a
    format name.  With ``tscale=None`` the per-call power-of-two scale
    applies (then nothing overflows by construction), so a caller tracking
    a distribution's shift passes a frozen scale; overflow = ``|x|*tscale``
    above the format's max, underflow = non-zero magnitudes below its
    smallest normal ``2**emin``.  The counts are reduced on ``x``'s device
    and cross to the host as four numbers."""
    fmt = getattr(cfg, "fmt", None)
    if fmt is None:
        fmt = cfg if isinstance(cfg, str) else getattr(cfg, "name", str(cfg))
    x = torch.as_tensor(x)
    ts = torch.tensor(0.0 if tscale is None else tscale, dtype=torch.float32,
                      device=x.device)
    overflow, underflow, nonfinite, used = sat_counts(x, fmt, ts)
    overflow, underflow, nonfinite, used = torch.stack(
        [overflow.double(), underflow.double(), nonfinite.double(), used.double()]).tolist()
    return {"overflow": int(overflow), "underflow": int(underflow),
            "nonfinite": int(nonfinite), "total": int(x.numel()), "tscale": float(used)}


def finite_flags(logits: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The numeric guard's reduction: one f32 per row of ``logits`` (B,
    ...), 0 where every value of the row is finite and NaN where any is not
    (x * 0 is a signed zero for finite x and NaN for NaN and +-inf, and a
    sum keeps a NaN), summed in f32 whatever the logits' dtype (bf16
    included).  Two kernels on the logits' device."""
    return torch.sum((logits * 0).flatten(1), dim=-1, dtype=torch.float32, out=out)


# ---------------------------------------------------------------------------
# Dispatch contracts: what a call sends to PyTorch outside the kernels
# ---------------------------------------------------------------------------

_RELAYOUT_OPS = {torch.ops.aten.permute, torch.ops.aten.transpose, torch.ops.aten.t,
                 torch.ops.aten.clone, torch.ops.aten.copy_}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _tensors(item)


class _OpCounter(TorchDispatchMode):
    """Counts the ATen ops a call dispatches that satisfy ``pred(func,
    inputs, outputs)``, outside the kernels' plain versions (a kernel
    launch dispatches nothing; on the CPU its plain version stands in for
    it, as a Pallas body is skipped by the JAX counters)."""

    def __init__(self, pred):
        super().__init__()
        self.pred = pred
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not build.in_plain_body() and self.pred(
                func, list(_tensors((args, kwargs or {}))), list(_tensors(out))):
            self.count += 1
        return out


def _count(pred, fn, *args) -> int:
    with _OpCounter(pred) as counter:
        fn(*args)
    return counter.count


def count_weight_transposes(fn, *args, min_size: int) -> int:
    """Permutes, transposes and contiguous copies of tensors of >=
    ``min_size`` elements that ``fn(*args)`` dispatches: the checkable form
    of the no-relayout contract — a packed projection reads its
    kernel-layout operands straight from the container, never a per-call
    weight-sized relayout."""
    def pred(func, ins, outs):
        return (func.overloadpacket in _RELAYOUT_OPS and bool(ins)
                and ins[0].numel() >= min_size)

    return _count(pred, fn, *args)


def count_kv_dequants(fn, *args, min_size: int) -> int:
    """Ops that ``fn(*args)`` dispatches turning an int8 tensor of >=
    ``min_size`` elements into a float one: the checkable form of the
    dequantize-free KV contract — a packed attention step widens the
    cache's mantissas only inside the kernel, never as a KV-sized float
    copy.  The dequantize-oracle path counts >= 1; the packed path 0."""
    def pred(func, ins, outs):
        return (any(t.dtype == torch.int8 and t.numel() >= min_size for t in ins)
                and any(t.is_floating_point() for t in outs))

    return _count(pred, fn, *args)


_GATHER_OPS = {torch.ops.aten.index, torch.ops.aten.gather, torch.ops.aten.index_select,
               torch.ops.aten.take_along_dim, torch.ops.aten.embedding}


def count_kv_gathers(fn, *args, min_size: int) -> int:
    """Gather/index ops producing a tensor of >= ``min_size`` elements that
    ``fn(*args)`` dispatches: the checkable form of the paged read
    contract — a paged decode step reads the block pool through the table
    inside the B6/B7 kernels, never through a KV-sized gathered view.  The
    gather-oracle path counts >= 1."""
    def pred(func, ins, outs):
        return (func.overloadpacket in _GATHER_OPS
                and any(t.numel() >= min_size for t in outs))

    return _count(pred, fn, *args)
