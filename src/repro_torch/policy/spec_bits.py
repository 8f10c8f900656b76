"""Per-layer draft-bitwidth pricing for self-speculative decoding.

Port of ``repro.policy.spec_bits``.  The draft truncates every packed
weight group to its top ``draft_bits`` mantissa bits
(:func:`repro_torch.core.packed.draft_view`); its quality per layer is
governed by how many bits the truncation drops, a pure function of the
calibration report's weight-side B_dyn histograms.
:func:`price_draft_bits` turns that into a per-layer artifact for
``ServeConfig.spec_draft_bits`` (the same stacked path keys, resolved per
layer by :func:`repro_torch.spec.draft.resolve_draft_bits`): layers whose
truncation drops the most bits, weighted by FLOP share, keep the fine
width until a draft-compute budget is spent; the rest draft coarse.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dsbp import DSBPConfig

from .calibrate import CalibrationReport, LayerStats
from .cost import _np_round_to_valid_weight, resolve_cfg

__all__ = ["truncated_bits_per_group", "price_draft_bits"]


def truncated_bits_per_group(stats: LayerStats, wcfg: DSBPConfig,
                             draft_bits: int) -> float:
    """Mean mantissa bits a ``draft_bits`` truncation drops per weight group
    of one layer, off the integer B_dyn histogram: the packed width is
    ``round_to_valid(k·B_dyn + B_fix)`` and the draft drops
    ``max(width - draft_bits, 0)`` bits."""
    bdyn = np.arange(stats.w_bdyn_hist.size, dtype=np.float64)
    if wcfg.mode == "fixed":
        widths = np.full_like(bdyn, float(
            _np_round_to_valid_weight(np.asarray([wcfg.b_fix]))[0]))
    else:
        widths = _np_round_to_valid_weight(wcfg.k * bdyn + wcfg.b_fix)
    dropped = np.maximum(widths.astype(np.float64) - draft_bits, 0.0)
    h = stats.w_bdyn_hist.astype(np.float64)
    return float((dropped * h).sum() / max(h.sum(), 1.0))


def price_draft_bits(report: CalibrationReport, pack_cfg="precise", *,
                     bits_fine: int = 6, bits_coarse: int = 2,
                     budget_frac_fine: float = 0.5):
    """Per-layer draft widths from calibration statistics.

    Layers are ranked by ``flop_share × truncated-bits-at-coarse`` (the
    layers where coarse drafting destroys the most mantissa in the compute
    that matters); the top ranks draft at ``bits_fine`` until their
    cumulative FLOP share exceeds ``budget_frac_fine``, the rest at
    ``bits_coarse``.  Returns ``(bits, info)``: ``bits`` is the
    ``ServeConfig.spec_draft_bits`` artifact — ``{path: width, 'default':
    bits_coarse}`` with the same projection path keys as
    :class:`~repro_torch.policy.policy.DSBPPolicy` — and ``info`` carries the
    per-layer scores and the modeled average draft width for provenance.
    """
    if not 1 <= bits_coarse <= bits_fine <= 7:
        raise ValueError(
            f"need 1 <= bits_coarse <= bits_fine <= 7, got "
            f"{bits_coarse}/{bits_fine}")
    wcfg = resolve_cfg(pack_cfg).weight_cfg
    if not report.layers:
        raise ValueError("calibration report names no quantizable layers")
    scores = {
        path: report.flop_share(path)
        * truncated_bits_per_group(stats, wcfg, bits_coarse)
        for path, stats in report.layers.items()
    }
    order = sorted(report.layers, key=lambda p: -scores[p])
    bits: dict[str, int] = {}
    fine_share = 0.0
    for path in order:
        share = report.flop_share(path)
        if scores[path] > 0 and fine_share + share <= budget_frac_fine:
            bits[path] = bits_fine
            fine_share += share
        else:
            bits[path] = bits_coarse
    artifact = dict(bits)
    artifact["default"] = bits_coarse
    avg = sum(report.flop_share(p) * bits[p] for p in bits)
    info = {
        "pack_cfg": getattr(pack_cfg, "mode", pack_cfg),
        "bits_fine": bits_fine,
        "bits_coarse": bits_coarse,
        "budget_frac_fine": budget_frac_fine,
        "fine_flop_share": fine_share,
        "avg_draft_bits_flop_weighted": avg,
        "scores": {p: round(scores[p], 6) for p in order},
    }
    return artifact, info
