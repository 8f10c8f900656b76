"""DSBP-quantized matmul: the macro's datapath as PyTorch ops.

Port of ``repro.core.quantized`` (forward paths only; the straight-through
training estimator, energy model and stats wait for the training slice):

  weights  offline:    FP8 -> group fields -> Algorithm-1 B_w -> int8 A_w, σ_w
  inputs   on the fly: FP8 -> group fields -> MPU B_i (Eq. 1) -> A_i, σ_i
  MAC      per group:  Σ_g (A_i_g · A_w_g) · σ_i[m,g] · σ_w[n,g]

The integer dots are exact (|A_i| < 2**11, |A_w| < 2**7, 64-deep sums
< 2**24); they run in float64, which holds them exactly on every device
whatever the float32 matmul precision setting.
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
]


@dataclasses.dataclass(frozen=True)
class QuantizedMatmulConfig:
    """Hyperparameters of one DSBP-quantized GEMM (both operand paths)."""

    input_cfg: DSBPConfig = DSBPConfig(fmt="e4m3", side="input", k=1.0, b_fix=6)
    weight_cfg: DSBPConfig = DSBPConfig(fmt="e2m5", side="weight", k=1.0,
                                        b_fix=5, scale_granularity="row")


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
    partial = torch.einsum("mgi,ngi->mng", qx["a"].to(torch.float64),
                           qw["a"].to(torch.float64)).to(torch.float32)
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
    # one matrix at a time: a per-tensor weight scale is per matrix
    qs = [quantize_weights(m, wcfg) for m in w.to(torch.float32).reshape(-1, k, n)]
    q = {key: torch.stack([qq[key] for qq in qs]).reshape(*lead, *qs[0][key].shape)
         for key in ("a", "scale", "tscale", "bits")}
    ka, kscale = to_kernel_layout(q["a"].to(torch.int8), q["scale"])
    return PackedDSBPWeight(
        ka=ka, kscale=kscale, tscale=q["tscale"].contiguous(),
        bits=q["bits"].to(torch.int8), k=k, n=n,
        group_size=wcfg.group_size, cfg=cfg,
    )


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
