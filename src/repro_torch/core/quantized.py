"""DSBP-quantized matmul: the macro's datapath as PyTorch ops.

Port of ``repro.core.quantized`` (the forward paths and the
straight-through training product :func:`dsbp_matmul_ste`; the energy
model is :mod:`repro_torch.core.energy`):

  weights  offline:    FP8 -> group fields -> Algorithm-1 B_w -> int8 A_w, σ_w
  inputs   on the fly: FP8 -> group fields -> MPU B_i (Eq. 1) -> A_i, σ_i
  MAC      per group:  Σ_g (A_i_g · A_w_g) · σ_i[m,g] · σ_w[n,g]

The integer dots are exact (|A_i| <= 2**11, |A_w| <= 2**7, 64-deep sums
<= 2**24); they run in the float type :func:`dsbp.exact_dot_dtype` picks,
which holds them exactly on every device whatever the float32 matmul
precision setting.
"""
from __future__ import annotations

import dataclasses

import torch

from . import dsbp
from .dsbp import DSBPConfig
from .packed import PackedDSBPWeight, to_kernel_layout

__all__ = [
    "QuantizedMatmulConfig",
    "PRESETS",
    "quantize_weights",
    "quantize_inputs",
    "grouped_int_matmul",
    "pack_weights",
    "packed_matmul",
    "dsbp_matmul_ref",
    "dsbp_matmul",
    "dsbp_matmul_ste",
    "STEProduct",
]


@dataclasses.dataclass(frozen=True)
class QuantizedMatmulConfig:
    """Hyperparameters of one DSBP-quantized GEMM (both operand paths)."""

    input_cfg: DSBPConfig = DSBPConfig(fmt="e4m3", side="input", k=1.0, b_fix=6)
    weight_cfg: DSBPConfig = DSBPConfig(fmt="e2m5", side="weight", k=1.0,
                                        b_fix=5, scale_granularity="row")

    @property
    def mode(self) -> str:
        """The macro's power mode of this config (``core.energy``)."""
        return "fp_dsbp" if self.input_cfg.mode == "dsbp" else "fp_fixed"


def _preset(k, b_in, b_w, mode="dsbp", fmt_i="e4m3", fmt_w="e2m5"):
    return QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt=fmt_i, side="input", k=k, b_fix=b_in, mode=mode),
        weight_cfg=DSBPConfig(fmt=fmt_w, side="weight", k=k, b_fix=b_w, mode=mode,
                              scale_granularity="row"),
    )


# Table I design points: inputs E4M3/E5M2, weights E2M5.
PRESETS: dict[str, QuantizedMatmulConfig] = {
    "e5m3_fixed": _preset(0.0, 3, 3, mode="fixed"),
    "e5m7_fixed": _preset(0.0, 7, 7, mode="fixed"),
    "precise": _preset(1.0, 6, 5),
    "efficient": _preset(2.0, 4, 4),
}


def quantize_weights(w: torch.Tensor, cfg: DSBPConfig) -> dict:
    """Offline weight path: w (K, N) grouped along K per output column;
    returns ``a (N, n_g, G)`` etc. (reduction axis last)."""
    return dsbp.dsbp_quantize(w.transpose(-1, -2), cfg)


def quantize_inputs(x: torch.Tensor, cfg: DSBPConfig) -> dict:
    """On-the-fly input path: x (..., K) grouped along K per row."""
    return dsbp.dsbp_quantize(x, cfg)


def grouped_int_matmul(qx: dict, qw: dict) -> torch.Tensor:
    """The INT MAC array contraction with per-group scale fusion:
    f32 (M, N) = Σ_g σx[m,g] σw[n,g] Σ_i A_x[m,g,i] A_w[n,g,i], descaled by
    the per-tensor scales."""
    dt = dsbp.exact_dot_dtype(qx["a"].device)
    partial = torch.einsum("mgi,ngi->mng", qx["a"].to(dt), qw["a"].to(dt)).to(torch.float32)
    scaled = partial * (qx["scale"][:, None, :] * qw["scale"][None, :, :])
    y = scaled.sum(dim=-1)
    tx = qx["tscale"].reshape(-1, 1) if qx["tscale"].ndim else qx["tscale"]
    tw = qw["tscale"].reshape(1, -1) if qw["tscale"].ndim else qw["tscale"]
    return y / (tx * tw)


def pack_weights(w: torch.Tensor, cfg: QuantizedMatmulConfig | str) -> PackedDSBPWeight:
    """Offline weight path, run ONCE: w (..., K, N) -> PackedDSBPWeight in
    kernel layout (bit-exact vs :func:`quantize_weights`; the int8
    narrowing is lossless for every valid weight width)."""
    if isinstance(cfg, str):
        cfg = PRESETS[cfg]
    wcfg = cfg.weight_cfg
    k, n = w.shape[-2:]
    lead = w.shape[:-2]
    # one matrix at a time: a per-tensor weight scale is per matrix; each
    # matrix's fields narrow and take the kernel layout as they come, into
    # outputs allocated once, so a stack of E experts holds one matrix's
    # temporaries beside its packed result, never E wide copies
    mats = w.to(torch.float32).reshape(-1, k, n)
    out = None
    for i, m in enumerate(mats):
        q = quantize_weights(m, wcfg)
        ka, kscale = to_kernel_layout(q["a"].to(torch.int8), q["scale"])
        fields = (ka, kscale, q["tscale"], q["bits"].to(torch.int8))
        del q
        if out is None:
            out = [f.new_empty((len(mats), *f.shape)) for f in fields]
        for o, f in zip(out, fields):
            o[i] = f
        del fields, ka, kscale
    ka, kscale, tscale, bits = (o.reshape(*lead, *o.shape[1:]) for o in out)
    return PackedDSBPWeight(ka=ka, kscale=kscale, tscale=tscale, bits=bits, k=k, n=n,
                            group_size=wcfg.group_size, cfg=cfg)


def packed_matmul(x: torch.Tensor, pw: PackedDSBPWeight,
                  input_cfg: DSBPConfig | None = None) -> torch.Tensor:
    """Grouped int contraction consuming the packed form directly:
    x (..., K) @ packed(K, N) -> (..., N) f32, input path on the fly."""
    if x.shape[-1] != pw.k:
        raise ValueError(f"activation K={x.shape[-1]} != packed logical K={pw.k}")
    if pw.ka.ndim != 2:
        raise ValueError(f"packed_matmul needs a 2-D logical weight; got "
                         f"leading axes {tuple(pw.ka.shape[:-2])}")
    icfg = input_cfg if input_cfg is not None else pw.cfg.input_cfg
    batch_shape = x.shape[:-1]
    qx = quantize_inputs(x.reshape(-1, x.shape[-1]), icfg)
    qw = {"a": pw.a, "scale": pw.scale, "tscale": pw.tscale}
    return grouped_int_matmul(qx, qw).reshape(*batch_shape, pw.n)


def dsbp_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                    cfg: QuantizedMatmulConfig) -> torch.Tensor:
    """Reference DSBP GEMM: x (..., K) @ w (K, N) -> (..., N) f32."""
    batch_shape = x.shape[:-1]
    qx = quantize_inputs(x.reshape(-1, x.shape[-1]), cfg.input_cfg)
    qw = quantize_weights(w, cfg.weight_cfg)
    return grouped_int_matmul(qx, qw).reshape(*batch_shape, w.shape[-1])


def dsbp_matmul(x: torch.Tensor, w: torch.Tensor, cfg: QuantizedMatmulConfig,
                use_kernel: bool = False) -> torch.Tensor:
    """DSBP GEMM; ``use_kernel=True`` routes to the two kernels (B3, B4)."""
    if use_kernel:
        from repro_torch.kernels import ops

        return ops.dsbp_matmul(x, w, cfg)
    return dsbp_matmul_ref(x, w, cfg)


class STEProduct(torch.autograd.Function):
    """A quantized forward with JAX's straight-through backward
    (``core/quantized.py:_ste_bwd``): ``gx = g @ wᵀ`` and ``gw = xᵀ g`` on
    the raw operands, as if the forward were the float product (the
    rounding and clipping ops would give zero gradients).  ``forward_fn(x,
    w, cfg)`` is the quantized product; it runs with autograd off, so a
    weight packed inside it records nothing.  The two backward products
    are plain float matmuls, as JAX's einsums are (no Pallas kernel); a
    profile names them ``ste_backward``."""

    @staticmethod
    def forward(ctx, x, w, cfg, forward_fn):
        ctx.save_for_backward(x, w)
        return forward_fn(x, w, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors  # under remat this recomputes the layer first
        with torch.profiler.record_function("ste_backward"):
            gx = torch.matmul(g, w.to(g.dtype).transpose(-1, -2))
            xm = x.reshape(-1, x.shape[-1]).to(g.dtype)
            gw = torch.matmul(xm.transpose(0, 1), g.reshape(-1, g.shape[-1]))
            return gx.to(x.dtype), gw.to(w.dtype), None, None


def dsbp_matmul_ste(x: torch.Tensor, w: torch.Tensor,
                    cfg: QuantizedMatmulConfig) -> torch.Tensor:
    """Quantized forward (:func:`dsbp_matmul_ref`), straight-through
    (full-precision) backward: QAT through the 'dsbp_ref' method."""
    return STEProduct.apply(x, w, cfg, dsbp_matmul_ref)
