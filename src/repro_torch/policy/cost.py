"""Candidate-assignment cost model.

Port of ``repro.policy.cost`` (numpy over a calibration report): a
per-layer ``(k, B_fix, mode)`` assignment maps to the paper's macro model
(:mod:`repro_torch.core.energy`: the 28 nm DCIM macro's modeled
throughput, power and TOPS/W, not the GPU's), weighted by each layer's
measured FLOP share.  The DSBP predictor's per-group width is a pure
function of the raw ratio r (inputs: ``clip(ceil(k·r + B_fix), 1, 11)``;
weights: ``round_to_valid(k·⌈r⌉ + B_fix)``), so the recorded histograms
price every candidate without running the model again.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dsbp
from repro_torch.core import energy as E
from repro_torch.core.dsbp import DSBPConfig
from repro_torch.core.quantized import PRESETS, QuantizedMatmulConfig

from .calibrate import CalibrationReport, LayerStats, bin_centers

__all__ = [
    "predict_layer_bits",
    "assignment_cost",
    "candidate_ladder",
    "input_bitwidth_ladder",
    "resolve_cfg",
]


def resolve_cfg(cfg: QuantizedMatmulConfig | str) -> QuantizedMatmulConfig:
    if isinstance(cfg, str):
        if cfg not in PRESETS:
            raise ValueError(f"unknown preset {cfg!r}; valid: {sorted(PRESETS)}")
        return PRESETS[cfg]
    return cfg


def _np_round_to_valid_weight(b_raw) -> np.ndarray:
    # the ONE implementation of the macro's valid-width rounding lives in
    # core.dsbp; it runs in float32, as the JAX package's does on numpy
    return dsbp.round_to_valid_weight(
        torch.as_tensor(np.asarray(b_raw), dtype=torch.float32)).numpy()


def _np_round_to_valid_input(b_raw) -> np.ndarray:
    return dsbp.round_to_valid_input(
        torch.as_tensor(np.asarray(b_raw), dtype=torch.float32)).numpy()


def _avg_input_bits(stats: LayerStats, icfg: DSBPConfig) -> float:
    """Histogram-predicted average aligned input width incl. sign bit."""
    if icfg.mode == "fixed":
        return float(_np_round_to_valid_input(np.asarray([icfg.b_fix]))[0]) + 1.0
    r = bin_centers()
    if icfg.predictor == "algorithm1":
        raw = icfg.k * np.ceil(r) + icfg.b_fix
    else:  # 'mpu', Eq. (1)
        raw = icfg.k * r + icfg.b_fix
    b = _np_round_to_valid_input(raw)
    h = stats.ratio_hist.astype(np.float64)
    return float((b * h).sum() / max(h.sum(), 1.0)) + 1.0


def _avg_weight_bits(stats: LayerStats, wcfg: DSBPConfig) -> float:
    """Exact average aligned weight width incl. sign bit, off the integer
    B_dyn = ceil(r) histogram (the weight predictor is integer-exact)."""
    if wcfg.mode == "fixed":
        return float(_np_round_to_valid_weight(np.asarray([wcfg.b_fix]))[0]) + 1.0
    bdyn = np.arange(stats.w_bdyn_hist.size, dtype=np.float64)
    b = _np_round_to_valid_weight(wcfg.k * bdyn + wcfg.b_fix)
    h = stats.w_bdyn_hist.astype(np.float64)
    return float((b * h).sum() / max(h.sum(), 1.0)) + 1.0


def predict_layer_bits(stats: LayerStats,
                       cfg: QuantizedMatmulConfig | str) -> tuple[float, float]:
    """(avg input bits, avg weight bits), Table I's "Avg. I/W", for one
    layer under one candidate, predicted from calibration statistics."""
    cfg = resolve_cfg(cfg)
    return _avg_input_bits(stats, cfg.input_cfg), _avg_weight_bits(stats, cfg.weight_cfg)


def assignment_cost(report: CalibrationReport, assignment: dict) -> dict:
    """Modeled macro cost of a per-layer assignment {path: config-or-preset}:
    time_l = flops_l / Tput(I_l, W_l), energy_l = time_l * P(mode_l), and
    the aggregate TOPS/W is total FLOPs / total energy.  Every number is
    the paper's macro model, not a GPU measurement."""
    per_layer = {}
    t_total = 0.0
    e_total = 0.0
    f_total = 0.0
    wi_sum = 0.0
    ww_sum = 0.0
    for path, stats in report.layers.items():
        cfg = resolve_cfg(assignment[path])
        avg_i, avg_w = predict_layer_bits(stats, cfg)
        tput = E.throughput_ops(avg_i, avg_w)
        p = E.power_w(avg_i, avg_w, cfg.mode)
        t = stats.flops / tput
        per_layer[path] = {
            "avg_i": avg_i, "avg_w": avg_w, "mode": cfg.mode,
            "time_s": t, "energy_j": t * p,
            "eff_tops_w": E.efficiency_tops_per_w(avg_i, avg_w, cfg.mode),
            "flop_share": report.flop_share(path),
        }
        t_total += t
        e_total += t * p
        f_total += stats.flops
        wi_sum += avg_i * stats.flops
        ww_sum += avg_w * stats.flops
    return {
        "time_s": t_total,
        "energy_j": e_total,
        "eff_tops_w": f_total / max(e_total, 1e-30) / 1e12,
        "avg_i": wi_sum / max(f_total, 1.0),
        "avg_w": ww_sum / max(f_total, 1.0),
        "per_layer": per_layer,
    }


def _dsbp_cfg(k: float, b_in: int, b_w: int) -> QuantizedMatmulConfig:
    return QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt="e4m3", side="input", k=k, b_fix=b_in),
        weight_cfg=DSBPConfig(fmt="e2m5", side="weight", k=k, b_fix=b_w,
                              scale_granularity="row"),
    )


def candidate_ladder() -> list[tuple[str, QuantizedMatmulConfig]]:
    """The autotuner's per-layer config ladder, most precise first: Table
    I's Precise/Efficient points, one interpolant and one extrapolant on
    the paper's (k, B_fix) axes."""
    return [
        ("precise", PRESETS["precise"]),            # k=1, 6/5
        ("balanced", _dsbp_cfg(1.5, 5, 4)),
        ("efficient", PRESETS["efficient"]),        # k=2, 4/4
        ("aggressive", _dsbp_cfg(2.0, 3, 3)),
    ]


def input_bitwidth_ladder(b_fixes=(6, 4, 3, 2), k: float = 1.0,
                          b_w: int = 7) -> list[tuple[str, QuantizedMatmulConfig]]:
    """Input-side demotion ladder: weights pinned near-lossless (``b_w=7``
    keeps the whole E2M5 mantissa after alignment), inputs walk B_fix
    down, where the per-group prediction buys the macro its throughput."""
    return [(f"i{b}_w{b_w}", _dsbp_cfg_iw(k, b, b_w)) for b in b_fixes]


def _dsbp_cfg_iw(k: float, b_in: int, b_w: int) -> QuantizedMatmulConfig:
    return QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt="e4m3", side="input", k=k, b_fix=b_in),
        weight_cfg=DSBPConfig(fmt="e2m5", side="weight", k=1.0, b_fix=b_w,
                              scale_granularity="row"),
    )
