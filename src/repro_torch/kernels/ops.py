"""Public wrappers around the kernels, in the JAX package's layouts.

Port of ``repro.kernels.ops``: ``fp8_quant_align`` (:92),
``dsbp_matmul_packed`` (:102), ``dsbp_matmul_fused`` (:150),
``dsbp_matmul`` (:274), and the two dispatch contracts
``count_weight_transposes`` (:52) and ``count_kv_dequants`` (:386).  Each
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
from repro_torch.core.formats import per_tensor_scale
from repro_torch.core.packed import PackedDSBPWeight

from . import build
from . import fp8_quant_align as _qa
from .dsbp_fused import dsbp_fused
from .dsbp_matmul import dsbp_matmul as _dsbp_matmul

__all__ = ["fp8_quant_align", "dsbp_matmul_packed", "dsbp_matmul_fused",
           "dsbp_matmul", "count_weight_transposes", "count_kv_dequants"]


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


def dsbp_matmul(x: torch.Tensor, w: torch.Tensor, cfg, folded: bool = True) -> torch.Tensor:
    """Both kernels with the weight packed per call (a convenience: the
    engine packs once and calls :func:`dsbp_matmul_packed`)."""
    from repro_torch.core.quantized import pack_weights

    return dsbp_matmul_packed(x, pack_weights(w, cfg), folded=folded)


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
