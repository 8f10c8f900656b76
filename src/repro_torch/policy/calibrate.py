"""Activation-statistics calibration for DSBP policies.

Port of ``repro.policy.calibrate``.  The model runs over calibration
batches with a recording method on the quantized-linear-method registry
(``calibrate_record``): it observes each projection's input, then runs the
float baseline, so the model's numerics are the unquantized reference.
Per projection path (JAX's stacked key ``units/<pos>/attn/wq``, which
``pack_weights_int8`` and :class:`~repro_torch.policy.policy.DSBPPolicy`
share) it collects the sufficient statistics of the DSBP predictor:

  * the per-64-group raw predicted ratio r = Σ shift·2^-shift / Σ 2^-shift
    as a fixed-bin histogram: every candidate (k, B_fix, mode) maps r to
    a width by arithmetic, so one pass prices every candidate;
  * the per-element shift histogram and nonzero fraction;
  * the accumulated GEMM FLOPs, the cost model's per-layer weights;

and, off the raw weights, a histogram of the integer Algorithm-1 B_dyn =
ceil(r) per weight group.

A projection is known by its module path, resolved once to its stacked key
(:func:`repro_torch.spec.draft.stacked_key`): the port's weights are the
model's own parameters, alive for the whole pass, so no mapping can go
stale.  Every layer at one pattern position aggregates under one key, the
granularity a packed container serves.  The histograms stay on the
device: each observation bucketizes and counts on the card, and each
projection's counts are read once, at the end (the JAX recorder copies
every observation to the host).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import dsbp
from repro_torch.core.dsbp import MAX_SHIFT, DSBPConfig
from repro_torch.core.formats import decompose, per_tensor_scale
from repro_torch.core.packed import (PackedDSBPWeight, QuantMethod, get_quant_method,
                                     register_quant_method)
from repro_torch.core.quantized import PRESETS, QuantizedMatmulConfig
from repro_torch.models.layers import Quant
from repro_torch.models.packing import PROJ_NAMES
from repro_torch.spec.draft import stacked_key

__all__ = [
    "LayerStats",
    "CalibrationReport",
    "calibrate",
    "synthetic_calibration_batches",
    "RATIO_BINS",
]

# ratio histogram bins over [0, MAX_SHIFT]; 256 bins -> ~0.12 binade
# resolution, well under the predictor's ceil() quantization step of 1
RATIO_BINS = 256


@dataclasses.dataclass
class LayerStats:
    """Calibration statistics for one projection path."""

    path: str
    k: int                      # logical GEMM reduction width
    n: int                      # logical GEMM output width
    # --- input (on-the-fly) side ---
    ratio_hist: np.ndarray      # (RATIO_BINS,) counts of per-group raw ratios
    shift_hist: np.ndarray      # (MAX_SHIFT+1,) per-element shift counts (nz)
    nz: int                     # nonzero FP8 elements observed
    total: int                  # elements observed
    groups: int                 # input groups observed
    tokens: int                 # activation rows observed
    flops: float                # accumulated 2*m*k*n over calibration
    # --- weight (offline) side ---
    w_bdyn_hist: np.ndarray     # (MAX_SHIFT+2,) counts of ceil(r) per group
    w_groups: int
    w_nz_frac: float

    @property
    def nz_frac(self) -> float:
        return self.nz / max(self.total, 1)


@dataclasses.dataclass
class CalibrationReport:
    """All layers' statistics + run provenance."""

    layers: dict[str, LayerStats]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return sum(s.flops for s in self.layers.values())

    def flop_share(self, path: str) -> float:
        return self.layers[path].flops / max(self.total_flops, 1.0)


def _bin_edges() -> np.ndarray:
    return np.linspace(0.0, float(MAX_SHIFT), RATIO_BINS + 1)


def bin_centers() -> np.ndarray:
    e = _bin_edges()
    return (e[:-1] + e[1:]) / 2.0


def _group_ratios(x2d: torch.Tensor, cfg: DSBPConfig):
    """(per-group raw ratio, per-element shift, nz mask) of one 2-D tensor
    under the probe FP8 format: the field-extraction front half of
    :func:`repro_torch.core.dsbp.dsbp_quantize`."""
    f = cfg.format
    if cfg.scale_granularity == "row":
        tscale = dsbp.per_row_scale(x2d, f)
    else:
        tscale = per_tensor_scale(x2d, f)
    fields = decompose(x2d * tscale, f)
    e_unb = dsbp.group_reshape(fields["e_unb"], cfg.group_size)
    m_int = dsbp.group_reshape(fields["m_int"], cfg.group_size)
    shift, _, nz = dsbp.group_shifts(e_unb, m_int)
    return dsbp.predict_bdyn(shift, nz), shift, nz


def _count(hist: torch.Tensor, idx: torch.Tensor) -> None:
    """``hist[i] += #(idx == i)`` on the device (no host sync)."""
    idx = idx.reshape(-1).to(torch.int64)
    hist.index_add_(0, idx, torch.ones_like(idx))


@register_quant_method
class _RecordingMethod(QuantMethod):
    """The registry intercept: observe, then run the float baseline.  The
    registered instance has no recorder and is the float baseline;
    :func:`calibrate` runs one of its own, holding its recorder."""

    name = "calibrate_record"

    def __init__(self, recorder=None):
        self.recorder = recorder
        self.inner = get_quant_method("dense_bf16")

    def apply(self, w, x, cfg, name=None):
        if self.recorder is not None:
            self.recorder.observe(w, x)
        return self.inner.apply(w, x, cfg, name=name)


class _Recorder:
    def __init__(self, input_probe: DSBPConfig, paths: dict, device):
        self.input_probe = input_probe
        self.paths = paths          # {raw projection parameter: stacked key}
        self.stats: dict[str, dict] = {}
        self.edges = torch.as_tensor(_bin_edges(), dtype=torch.float64, device=device)

    def _entry(self, path: str, k: int, n: int, device) -> dict:
        if path not in self.stats:
            z = lambda size: torch.zeros(size, dtype=torch.int64, device=device)  # noqa: E731
            self.stats[path] = {
                "k": k, "n": n, "ratio_hist": z(RATIO_BINS),
                # one bin past MAX_SHIFT collects the zeros, dropped at the end
                "shift_hist": z(MAX_SHIFT + 2), "nz": z(()),
                "total": 0, "groups": 0, "tokens": 0, "flops": 0.0,
            }
        return self.stats[path]

    def observe(self, w, x) -> None:
        path = self.paths.get(w) if not isinstance(w, PackedDSBPWeight) else None
        if path is None:
            return
        k, n = w.shape[-2:]
        xm = x.reshape(-1, x.shape[-1]).to(torch.float32)
        ratio, shift, nz = _group_ratios(xm, self.input_probe)
        ent = self._entry(path, k, n, xm.device)
        # np.histogram's bins: [e_i, e_i+1), the last one closed; f32 ratios
        # compared against the f64 edges exactly
        b = torch.bucketize(ratio.to(torch.float64), self.edges, right=True) - 1
        _count(ent["ratio_hist"], b.clamp(0, RATIO_BINS - 1))
        _count(ent["shift_hist"], torch.where(nz, shift, MAX_SHIFT + 1))
        ent["nz"] += nz.sum()
        ent["total"] += nz.numel()
        ent["groups"] += ratio.numel()
        ent["tokens"] += xm.shape[0]
        ent["flops"] += 2.0 * xm.shape[0] * k * n


def _weight_stats(leaves, cfg: DSBPConfig):
    """Offline weight-side statistics of every layer's weight under one
    key: the histogram of the integer Algorithm-1 B_dyn = ceil(r) per
    group, counted on the device and read once."""
    hist = nz_sum = None
    total = 0
    for w in leaves:
        ratio, _, nz = _group_ratios(w.to(torch.float32).T, cfg)
        h = torch.zeros(MAX_SHIFT + 2, dtype=torch.int64, device=w.device)
        _count(h, torch.ceil(ratio))
        hist = h if hist is None else hist + h
        s = nz.sum()
        nz_sum = s if nz_sum is None else nz_sum + s
        total += nz.numel()
    hist = hist.cpu().numpy()
    return hist, int(hist.sum()), int(nz_sum) / max(total, 1)


def refuse_unported(cfg: ArchConfig, what: str) -> None:
    """What the policy loop does not run yet: expert stacks (JAX folds each
    into one policy entry, ``repro.policy.calibrate`` :210-226; the port
    does not) and a bfloat16 model (its statistics and trial serves are
    not held against JAX's in bf16): both name ROADMAP A12."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"{what} on an MoE model ({cfg.name}, {cfg.n_experts} experts) is not "
            f"ported yet (ROADMAP A12)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"{what} on a {cfg.dtype} model ({cfg.name}) is not ported yet (ROADMAP A12)")


def synthetic_calibration_batches(cfg: ArchConfig, n_batches: int = 2,
                                  batch: int = 2, seq: int = 32,
                                  seed: int = 0) -> list[np.ndarray]:
    """Deterministic token batches over the model's vocab (fixed seed):
    the JAX package's, array for array."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (batch, seq)) for _ in range(n_batches)]


def raw_projections(model, cfg=None) -> dict:
    """{stacked key: [raw projection parameter of each layer under it]}:
    every 2-D parameter named in ``PROJ_NAMES``, by its module path."""
    cfg = cfg or model.cfg
    out: dict[str, list] = {}
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in PROJ_NAMES and p.ndim == 2:
            out.setdefault(stacked_key(cfg, name), []).append(p)
    return out


@torch.inference_mode()
def calibrate(model, cfg: ArchConfig, batches,
              probe: QuantizedMatmulConfig | str = "precise") -> CalibrationReport:
    """Collect per-projection DSBP statistics over ``batches``.

    ``model`` must hold RAW (unpacked) projections: calibration prices
    every candidate config, so it reads the float weights.  ``probe``
    fixes the FP8 formats and scale granularities the group fields are
    extracted under (every PRESETS entry shares e4m3 inputs and row-scaled
    e2m5 weights, so one probe prices them all).  The batches run on the
    model's device."""
    if any(isinstance(m, PackedDSBPWeight) for m in model.modules()):
        raise ValueError("calibrate() needs the raw float tree, not packed "
                         "weights — pack AFTER choosing a policy")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"calibration drives plain token batches; frontend={cfg.frontend!r}")
    refuse_unported(cfg, "calibrate")
    probe = PRESETS[probe] if isinstance(probe, str) else probe
    gsize = probe.input_cfg.group_size
    by_key = raw_projections(model, cfg)
    paths = {p: key for key, ps in by_key.items() for p in ps if p.shape[-2] >= gsize}
    device = model.device
    recorder = _Recorder(probe.input_cfg, paths, device)
    quant = Quant(probe, method="calibrate_record")
    quant.method = _RecordingMethod(recorder)
    n_tokens = 0
    for b in batches:
        n_tokens += int(np.prod(np.shape(b)))
        model.forward(torch.as_tensor(np.asarray(b), dtype=torch.int64, device=device),
                      quant=quant)

    layers: dict[str, LayerStats] = {}
    for path, ent in recorder.stats.items():
        w_hist, w_groups, w_nz = _weight_stats(by_key[path], probe.weight_cfg)
        layers[path] = LayerStats(
            path=path, k=ent["k"], n=ent["n"],
            ratio_hist=ent["ratio_hist"].cpu().numpy(),
            shift_hist=ent["shift_hist"][: MAX_SHIFT + 1].cpu().numpy(),
            nz=int(ent["nz"]), total=ent["total"], groups=ent["groups"],
            tokens=ent["tokens"], flops=ent["flops"],
            w_bdyn_hist=w_hist, w_groups=w_groups, w_nz_frac=w_nz,
        )
    meta = {
        "arch": cfg.name,
        "n_batches": len(batches) if hasattr(batches, "__len__") else None,
        "n_tokens": n_tokens,
        "probe_fmt": (probe.input_cfg.fmt, probe.weight_cfg.fmt),
        "n_layers": len(layers),
    }
    return CalibrationReport(layers=layers, meta=meta)
