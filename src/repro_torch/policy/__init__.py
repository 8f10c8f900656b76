"""The DSBP policy loop (port of ``repro.policy``).

  calibrate.py  -- run calibration batches through the model with a
                   recording method on the quantized-linear-method
                   registry: per-projection DSBP statistics (ratio and
                   shift histograms, nonzero fractions, FLOP shares)
  cost.py       -- a per-layer (k, B_fix, mode) assignment priced on the
                   paper's macro model (core.energy), by FLOP share
  search.py     -- the accuracy-constrained greedy autotuner, scored
                   through the eval harness and the serving engine
  policy.py     -- the DSBPPolicy artifact (layer path -> config, KV
                   entry -> spec, provenance), JSON shared with JAX
  spec_bits.py  -- per-layer draft widths (ServeConfig.spec_draft_bits)
  kv_bits.py    -- per-entry KV widths (DSBPPolicy.kv_layers)
  reprice.py    -- telemetry-driven widening: obs.QuantHealth guard-trip /
                   drift signals -> a new DSBPPolicy
"""
from .calibrate import CalibrationReport, LayerStats, calibrate, synthetic_calibration_batches
from .cost import assignment_cost, candidate_ladder, predict_layer_bits
from .kv_bits import KVEntryStats, collect_kv_stats, kv_dropped_bits, price_kv_bits
from .policy import DSBPPolicy
from .reprice import KV_WIDEN_LADDER, WIDEN_LADDER, reprice_from_telemetry, widen_config
from .search import autotune
from .spec_bits import price_draft_bits

__all__ = [
    "DSBPPolicy",
    "CalibrationReport",
    "LayerStats",
    "calibrate",
    "synthetic_calibration_batches",
    "assignment_cost",
    "candidate_ladder",
    "predict_layer_bits",
    "autotune",
    "price_draft_bits",
    "KVEntryStats",
    "collect_kv_stats",
    "kv_dropped_bits",
    "price_kv_bits",
    "reprice_from_telemetry",
    "widen_config",
    "WIDEN_LADDER",
    "KV_WIDEN_LADDER",
]
