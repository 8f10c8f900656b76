"""Telemetry-driven policy repricing (port of ``repro.policy.reprice``).

The closing half of the observe -> adapt loop: :mod:`repro_torch.obs.health`
accumulates per-cache-entry guard trips, saturation counts and
alignment-shift histograms while serving; :func:`reprice_from_telemetry`
turns that telemetry into a NEW :class:`~repro_torch.policy.policy.DSBPPolicy`
-- every projection under a flagged entry's path prefix widens one rung up
the preset ladder, the entry's KV spec bumps one rung up the kv ladder,
and the decision trail lands in ``meta["reprice"]``.  The result is an
ordinary policy: its JSON (``to_json``) equals the JAX package's for the
same telemetry, and it serves through ``ServeConfig(pack_preset=policy)``.

Entry naming contract: health keys are cache-entry names ``units.{i}`` /
``tail.{i}`` (the :mod:`repro_torch.policy.kv_bits` granularity); policy
layer keys are projection paths ``units/{i}/attn/wq``-style, so entry
``units.{i}`` maps to the path prefix ``units/{i}/``.  A telemetry key
containing ``/`` is treated as a direct layer key and widens exactly that
projection.
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.core.quantized import PRESETS, QuantizedMatmulConfig
from repro_torch.kvq import resolve_kv_spec
from repro_torch.obs.health import shift_drift
from repro_torch.policy.policy import DSBPPolicy

__all__ = ["WIDEN_LADDER", "KV_WIDEN_LADDER", "widen_config",
           "reprice_from_telemetry"]

# ascending total fixed mantissa width: 3+3 -> 4+4 -> 6+5 -> 7+7
WIDEN_LADDER = ("e5m3_fixed", "efficient", "precise", "e5m7_fixed")
KV_WIDEN_LADDER = ("kv4", "kv6", "kv8")


def _width(cfg: QuantizedMatmulConfig) -> int:
    return cfg.input_cfg.b_fix + cfg.weight_cfg.b_fix


def _preset_name(cfg: QuantizedMatmulConfig) -> str:
    for name, cand in PRESETS.items():
        if cand == cfg:
            return name
    return f"b_fix={cfg.input_cfg.b_fix}/{cfg.weight_cfg.b_fix}"


def widen_config(cfg: QuantizedMatmulConfig | None,
                 ladder=WIDEN_LADDER) -> QuantizedMatmulConfig | None:
    """The next-wider ladder preset: first rung carrying strictly more
    total fixed mantissa bits than ``cfg`` (the widest rung is a fixed
    point — repricing is idempotent there)."""
    if cfg is None:
        return None
    rungs = [PRESETS[n] if isinstance(n, str) else n for n in ladder]
    for cand in rungs:
        if _width(cand) > _width(cfg):
            return cand
    return rungs[-1]


def _widen_kv(spec, ladder):
    if spec is None:
        return None  # float entry: nothing to widen
    for name in ladder:
        cand = resolve_kv_spec(name)
        if cand.bits > spec.bits:
            return cand
    return resolve_kv_spec(ladder[-1])


def _entry_prefix(entry: str) -> str:
    fam, _, idx = entry.partition(".")
    return f"{fam}/{idx}/"


def _normalize(telemetry):
    """-> (trips, hists) keyed by entry/layer name; accepts a
    ``repro_torch.obs.QuantHealth``, its ``snapshot()`` dict, or a plain
    ``{name: trip-count}`` mapping."""
    trips: dict = {}
    hists: dict = {}
    if hasattr(telemetry, "entries") and not isinstance(telemetry, Mapping):
        for name, e in telemetry.entries.items():
            trips[name] = int(e.guard_trips)
            hists[name] = e.shift_hist
    elif isinstance(telemetry, Mapping) and "entries" in telemetry:
        for name, e in telemetry["entries"].items():
            trips[name] = int(e.get("guard_trips", 0))
            if e.get("shift_hist") is not None:
                hists[name] = e["shift_hist"]
    elif isinstance(telemetry, Mapping):
        trips = {name: int(n) for name, n in telemetry.items()}
    else:
        raise TypeError(f"unsupported telemetry type: {type(telemetry)!r}")
    return trips, hists


def reprice_from_telemetry(policy: DSBPPolicy, telemetry, *,
                           calibration: Mapping | None = None,
                           min_trips: int = 1,
                           drift_threshold: float = 0.25,
                           ladder=WIDEN_LADDER,
                           kv_ladder=KV_WIDEN_LADDER) -> DSBPPolicy:
    """Widen every policy layer a health signal implicates; returns a NEW
    policy (the input is never mutated).

    An entry is flagged when its guard-trip count reaches ``min_trips``
    OR (given ``calibration``: entry name -> stored
    :class:`~repro.policy.kv_bits.KVEntryStats` / raw histogram) its
    shift-histogram TV distance vs calibration reaches
    ``drift_threshold``.  Entries with no matching policy layers are
    reported in ``meta["reprice"]["unmatched"]`` rather than ignored.
    """
    trips, hists = _normalize(telemetry)
    flagged: dict = {}
    for name, n in trips.items():
        if n >= min_trips:
            flagged[name] = f"guard_trips={n}"
    if calibration:
        for name, hist in hists.items():
            if name in flagged or name not in calibration:
                continue
            d = shift_drift(hist, calibration[name])
            if d >= drift_threshold:
                flagged[name] = f"shift_drift={d:.3f}"

    layers = dict(policy.layers)
    kv_layers = dict(policy.kv_layers)
    widened: dict = {}
    kv_widened: dict = {}
    unmatched: list = []
    for name in sorted(flagged):
        if "/" in name:  # direct projection-path key
            cur = policy.config_for(name)
            new = widen_config(cur, ladder)
            if new is None or _width(new) <= _width(cur):
                unmatched.append(name)
            else:
                layers[name] = new
                widened[name] = _preset_name(new)
            continue
        prefix = _entry_prefix(name)
        hit = False
        for key in policy.layers:
            if not key.startswith(prefix):
                continue
            cur = layers[key]
            new = widen_config(cur, ladder)
            if _width(new) > _width(cur):
                layers[key] = new
                widened[key] = _preset_name(new)
            hit = True
        cur_kv = policy.kv_spec_for(name)
        new_kv = _widen_kv(cur_kv, kv_ladder)
        if cur_kv is not None and new_kv.bits > cur_kv.bits:
            kv_layers[name] = new_kv
            kv_widened[name] = new_kv.bits
            hit = True
        if not hit:
            unmatched.append(name)

    meta = dict(policy.meta)
    meta["reprice"] = {"flagged": dict(sorted(flagged.items())),
                       "widened": widened,
                       "kv_widened": kv_widened,
                       "unmatched": unmatched,
                       "min_trips": min_trips,
                       "drift_threshold": drift_threshold}
    return DSBPPolicy(layers=layers, default=policy.default, meta=meta,
                      kv_layers=kv_layers, kv_default=policy.kv_default)
