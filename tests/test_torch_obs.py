"""The port's serving observability against the JAX package, on the CPU.

The counterpart of ``tests/test_obs.py``: the metrics registry (Prometheus
``le`` bucket math, both exports round-tripping, the same exposition text
as JAX's for the same operations), the trace recorder (span nesting,
drops, the Chrome export), the engine hooks (``last_stats`` and tokens
unchanged with ``observe=True``, a deterministic trace under a seeded
``FaultPlan``, guard-trip telemetry), quantization health
(``attribute_trip`` per cache entry, ``quant_sat_stats`` and
``sample_cache`` equal to JAX's on the same arrays and caches, float and
kv8), ``reprice_from_telemetry`` (the same policy JSON as JAX's, also
after a save and load through the port's checkpoint store) and the
recorder alone."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax.numpy as jnp  # noqa: E402

from repro import obs as JO  # noqa: E402
from repro import policy as JP  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch import policy as TP  # noqa: E402
from repro_torch.core.quantized import PRESETS  # noqa: E402
from repro_torch.kernels.ops import _OpCounter, quant_sat_stats  # noqa: E402
from repro_torch.obs import (Histogram, MetricsRegistry, QuantHealth,  # noqa: E402
                             ServeRecorder, TraceRecorder, shift_drift)
from repro_torch.policy import (DSBPPolicy, WIDEN_LADDER,  # noqa: E402
                                reprice_from_telemetry, widen_config)
from repro_torch.serve import faults as FA  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from test_torch_engine import PROMPT_SEED  # noqa: E402
from test_torch_model import LENS, _prompts, make_pair  # noqa: E402
from test_torch_spec import _np_cache  # noqa: E402

PAGED = dict(max_len=32, batch_size=4, paged=True, kv_block_size=4)


@pytest.fixture(scope="module")
def pair():
    return make_pair("gqa", packed=True)


def _eng(pair, **scfg) -> Engine:
    return Engine(pair[2], ServeConfig(**scfg), device="cpu")


def _reqs(lens, seed=PROMPT_SEED):
    rng = np.random.default_rng(seed)
    return [Request(uid=f"r{i}", tokens=rng.integers(0, 512, n), max_new_tokens=8)
            for i, n in enumerate(lens)]


def _fake_cache(poison=False):
    """A minimal cache tree in the port's entry layout (``Model.cache_tree``):
    two entries of one layer each."""
    k = torch.ones(2, 4, 8)
    if poison:
        k[0, 0, 0] = float("nan")
    return {"units": [[{"k": k, "v": torch.ones(2, 4, 8)}],
                      [{"k": torch.ones(2, 4, 8), "v": torch.ones(2, 4, 8)}]],
            "tail": []}


# ---------------------------------------------------------------------------
# metrics registry: bucket math and export round-trips
# ---------------------------------------------------------------------------

def test_histogram_and_counter_rules():
    """Prometheus ``le`` buckets with a +Inf overflow; buckets strictly
    ascending; counters never decrease; one kind per name."""
    h = Histogram(buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 4.0, 5.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1]
    assert h.count == 5 and h.sum == pytest.approx(12.0)
    assert h.cumulative() == [(1.0, 2), (2.0, 3), (4.0, 4), ("+Inf", 5)]
    for buckets in ((1.0, 1.0, 2.0), ()):
        with pytest.raises(ValueError, match="ascending"):
            Histogram(buckets=buckets)
    reg = MetricsRegistry()
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("c_total").inc(-1)
    reg.counter("c_total").inc(3)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")
    assert reg.value("c_total") == 3


def _fill(reg):
    reg.counter("serve_requests_total", status="ok").inc(2)
    reg.counter("serve_requests_total", status="cancelled").inc()
    reg.gauge("serve_decode_tps").set(12.5)
    h = reg.histogram("serve_ttft_seconds", buckets=(0.1, 1.0), help="ttft")
    h.observe(0.05)
    h.observe(2.0)
    reg.histogram("serve_decode_step_seconds").observe(0.0123)
    return reg


def test_registry_snapshot_roundtrip_and_prometheus():
    """Both exports round-trip, and the same operations give JAX's
    snapshot and exposition text."""
    reg = _fill(MetricsRegistry())
    snap = reg.snapshot()
    json.dumps(snap)
    back = MetricsRegistry.from_snapshot(snap)
    assert back.snapshot() == snap
    assert back.value("serve_requests_total", status="ok") == 2
    text = reg.to_prometheus()
    assert 'serve_requests_total{status="ok"} 2' in text
    assert 'serve_ttft_seconds_bucket{le="+Inf"} 2' in text
    assert back.to_prometheus() == text
    j = _fill(JO.MetricsRegistry())
    assert text == j.to_prometheus() and snap == j.snapshot()
    assert MetricsRegistry.from_snapshot(j.snapshot()).to_prometheus() == text


# ---------------------------------------------------------------------------
# trace recorder
# ---------------------------------------------------------------------------

def test_trace_spans_drops_and_chrome_export():
    """Spans nest (ending an outer span closes the inner ones), the
    terminal status sits on the closed request span, events past capacity
    are counted as dropped, and the Chrome export equals JAX's."""
    tr = TraceRecorder()
    tr.begin("a", "request", 0, prompt_len=4)
    tr.begin("a", "queued", 0)
    tr.begin("a", "prefill", 1)
    tr.end("a", "queued", 1)
    assert tr.open_spans("a") == ("request",)
    tr.end("a", "request", 2, status="ok")
    assert tr.complete("a") and tr.terminal_status("a") == "ok"
    tree = tr.span_tree("a")
    assert tree["phase"] == "request" and tree["end_step"] == 2
    tr2 = TraceRecorder()
    tr2.begin("b", "request", 0)
    assert tr2.terminal_status("b") is None
    tr2.end("b", "nonexistent", 1)
    assert tr2.open_spans("b") == ("request",)
    tr3 = TraceRecorder(max_events=3)
    for i in range(5):
        tr3.instant("a", "tick", i)
    assert len(tr3.events) == 3 and tr3.dropped == 2 and tr3.to_json()["dropped"] == 2
    rows = {}
    for name, cls in (("t", TraceRecorder), ("j", JO.TraceRecorder)):
        tr = cls()
        tr.begin("a", "request", 0)
        tr.instant(None, "decode-step", 1, lanes=2)
        tr.end("a", "request", 2, status="ok")
        rows[name] = [{k: v for k, v in r.items() if k != "ts"} for r in tr.to_chrome()]
    assert rows["t"] == rows["j"]
    inst = next(r for r in rows["t"] if r["ph"] == "i")
    assert inst["tid"] == 0 and inst["s"] == "t"
    assert [r["args"]["status"] for r in rows["t"] if r["ph"] == "E"] == ["ok"]


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def test_last_stats_backcompat_and_token_parity(pair):
    off = _eng(pair, max_len=32, batch_size=2)
    out_off = off.serve(_reqs((5, 9)))
    on = _eng(pair, max_len=32, batch_size=2, observe=True)
    out_on = on.serve(_reqs((5, 9)))
    assert set(off.last_stats) == set(on.last_stats)
    for u in out_off:
        assert np.array_equal(out_off[u], out_on[u])
    assert on.obs.complete_spans(on.last_stats["request_status"])
    assert off.obs.enabled is False and not off.obs.trace.events
    summ = on.obs.request_summary()
    assert set(summ) == set(out_on)
    for s in summ.values():
        assert s["status"] == "ok" and s["ttft_s"] >= 0 and s["tokens"] == 8
    snap = on.obs.snapshot()
    json.dumps(snap)
    assert MetricsRegistry.from_snapshot(snap["metrics"]).snapshot() == snap["metrics"]
    assert on.obs.metrics.value("serve_decode_steps_total") == on.last_stats["decode_steps"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_observe_dispatches_no_extra_ops(pair, paged):
    """The recorder is host bookkeeping: an observed serve, its loop and
    every recorder hook in it included, dispatches exactly the ops of an
    unobserved one (on the card: the same kernels)."""
    counts = []
    for observe in (False, True):
        scfg = dict(PAGED if paged else dict(max_len=32, batch_size=2), observe=observe)
        eng = _eng(pair, **scfg)
        with _OpCounter(lambda *a: True) as c:
            eng.serve(_reqs((5, 9, 7)))
        assert eng.obs.enabled == observe and eng.last_stats["decode_steps"]
        counts.append(c.count)
    assert counts[0] == counts[1] and counts[0]


def test_recorder_determinism_under_seeded_plan(pair):
    """Same seeded plan -> the same event sequence modulo timestamps."""
    reqs = _reqs((5, 9, 7, 6), seed=3)
    uids = [r.uid for r in reqs]
    scfg = dict(PAGED, kv_blocks=13, max_active=4, numeric_guard="quarantine", observe=True)

    def run():
        eng = _eng(pair, **scfg)
        plan = FA.FaultPlan.seeded(5, uids=uids, n_alloc=2, n_cow=1, n_nan=1, n_cancel=1,
                                   decode_calls=12, alloc_calls=10, steps=8, lanes=4)
        eng.serve([dataclasses.replace(r) for r in reqs], faults=plan)
        return eng, plan

    (a, pa), (b, pb) = run(), run()
    assert a.obs.trace.signature() == b.obs.trace.signature()
    assert a.obs.trace.dropped == 0
    assert a.last_stats["request_status"] == b.last_stats["request_status"]
    assert a.obs.complete_spans(a.last_stats["request_status"])
    assert dict(pa.injected) == dict(pb.injected) and sum(pa.injected.values()) > 0
    for kind, n in pa.injected.items():
        assert (a.obs.metrics.value("serve_faults_injected_total", kind=kind) or 0) == n
    assert a.obs.metrics.value("serve_block_pool_used") is not None


def test_guard_trip_telemetry_under_nan_injection(pair):
    eng = _eng(pair, numeric_guard="quarantine", observe=True, **PAGED)
    eng.serve(_reqs((5, 9)), faults=FA.FaultPlan(nan_steps={1: "all"}))
    obs = eng.obs
    assert obs.health.total_trips >= 2
    # a NaN in the logits never reaches the cache: unattributed
    assert obs.health.unattributed_trips == obs.health.total_trips
    assert obs.health.trips() == {}
    assert obs.metrics.value("serve_guard_trips_total") == obs.health.total_trips
    trips = [e for e in obs.trace.events if e.phase == "guard-trip"]
    assert trips and all(e.args["entries"] == "unattributed" for e in trips)
    assert obs.complete_spans(eng.last_stats["request_status"])


# ---------------------------------------------------------------------------
# quant health
# ---------------------------------------------------------------------------

def test_attribute_trip_blames_poisoned_entry_only():
    qh = QuantHealth()
    assert qh.attribute_trip(_fake_cache(poison=True)) == ["units.0"]
    assert qh.trips() == {"units.0": 1} and qh.unattributed_trips == 0
    assert qh.attribute_trip(_fake_cache(poison=False)) == []
    assert qh.unattributed_trips == 1 and qh.total_trips == 2


@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_attribute_trip_groups_layers_by_entry(pair, kv):
    """A NaN in one layer's K at a live slot of the engine's cache: every
    smoke layer is entry ``units.0``, so one trip names it once."""
    model = pair[2]
    with torch.inference_mode():
        _, cache, _ = model.prefill(torch.from_numpy(_prompts(512, seed=PROMPT_SEED)), 24,
                                    lengths=LENS, kv=kv)
        leaf = cache[1]["k"]
        (leaf.scale if kv else leaf)[0, 0, 2, 0] = float("nan")
    qh = QuantHealth()
    assert qh.attribute_trip(model.cache_tree(cache)) == ["units.0"]
    assert qh.entries["units.0"].guard_trips == 1 and qh.entries["units.0"].nonfinite == 1


def test_quant_sat_stats_equals_jax():
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 30
    x[[3, 7, 11]] = [np.nan, np.inf, 1e-30]
    for tscale in (None, 2.0 ** 10, 2.0 ** -20):
        got = quant_sat_stats(torch.from_numpy(x), "e5m7", tscale=tscale)
        assert got == JOPS.quant_sat_stats(x, "e5m7", tscale=tscale), tscale
        assert got["nonfinite"] == 2


def test_quant_sat_stats_frozen_scale():
    x = torch.linspace(-4.0, 4.0, 64)
    clean = quant_sat_stats(x, "e5m7")
    assert clean["overflow"] == 0 and clean["total"] == 64 and clean["tscale"] > 0
    frozen = quant_sat_stats(x, "e5m7", tscale=clean["tscale"] * 1e6)
    assert frozen["overflow"] > 0
    assert quant_sat_stats(torch.tensor([1.0, float("nan"), float("inf")]),
                           "e5m7")["nonfinite"] == 2


def test_sample_cache_freezes_scale_and_fills_shift_hist():
    qh = QuantHealth()
    qh.sample_cache(_fake_cache())
    ts0 = qh.entries["units.0"].tscale
    assert ts0 is not None and qh.entries["units.0"].shift_hist.sum() > 0
    qh.sample_cache(_fake_cache())
    assert qh.entries["units.0"].tscale == ts0 and qh.entries["units.0"].samples == 2
    snap = qh.snapshot()
    json.dumps(snap)
    assert snap["entries"]["units.0"]["total"] > 0


@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_sample_cache_equals_jax(pair, kv):
    """Two samples of the same caches (the second 4096x larger, so the
    frozen scale overflows): per-entry counts, tscale and shift histogram
    equal to JAX's."""
    jcfg, params, model = pair
    qt, qj = QuantHealth(), JO.QuantHealth()
    for seed, scale in ((PROMPT_SEED, 1.0), (4, 4096.0)):
        toks = jnp.asarray(_prompts(512, seed=seed))
        _, jcache, _ = JM.prefill(params, {"tokens": toks}, jcfg, max_len=24,
                                  lengths=jnp.asarray(LENS), kv=kv)
        if kv is None:
            jcache = {"units": [{n: e[n] * scale for n in ("k", "v")} for e in jcache["units"]],
                      "tail": []}
        tcache = bridge.cache_from_jax(_np_cache(jcache), jcfg, device="cpu")
        qj.sample_cache(jcache)
        qt.sample_cache(model.cache_tree(tcache))
    assert qt.snapshot() == qj.snapshot()
    e = qt.entries["units.0"]
    assert e.samples == 2 and e.shift_hist.sum() > 0
    if kv is None:
        assert e.overflow > 0


def test_shift_drift_bounds_and_equals_jax():
    a = np.array([10, 0, 0])
    assert shift_drift(a, a) == 0.0
    assert shift_drift(a, np.array([0, 0, 10])) == pytest.approx(1.0)
    assert shift_drift(np.array([1.0]), np.array([1.0, 0.0, 0.0])) == 0.0
    rng = np.random.default_rng(2)
    for _ in range(5):
        h, b = rng.integers(0, 50, 32), rng.integers(0, 50, 20)
        assert shift_drift(h, b) == JO.shift_drift(h, b)


# ---------------------------------------------------------------------------
# telemetry -> policy repricing
# ---------------------------------------------------------------------------

_KEYS = ("units/0/attn/wq", "units/0/ff/w1", "units/1/attn/wq")


def test_reprice_widens_exactly_the_tripping_layer():
    pol = DSBPPolicy.uniform("efficient", _KEYS)
    new = reprice_from_telemetry(pol, {"units.0": 2})
    assert new.layers["units/0/attn/wq"] == PRESETS["precise"]
    assert new.layers["units/0/ff/w1"] == PRESETS["precise"]
    assert new.layers["units/1/attn/wq"] == PRESETS["efficient"]
    assert new.default == pol.default
    assert pol.layers["units/0/attn/wq"] == PRESETS["efficient"]  # no mutation
    rp = new.meta["reprice"]
    assert rp["flagged"] == {"units.0": "guard_trips=2"}
    assert set(rp["widened"]) == {"units/0/attn/wq", "units/0/ff/w1"} and rp["unmatched"] == []


def test_reprice_min_trips_and_unmatched():
    pol = DSBPPolicy.uniform("efficient", _KEYS)
    assert reprice_from_telemetry(pol, {"units.0": 1}, min_trips=3).layers == pol.layers
    missed = reprice_from_telemetry(pol, {"units.7": 5})
    assert missed.layers == pol.layers and missed.meta["reprice"]["unmatched"] == ["units.7"]


def test_reprice_accepts_health_object_and_kv_spec():
    qh = QuantHealth()
    qh.record_trip("units.0", 2)
    pol = DSBPPolicy.uniform("efficient", _KEYS).with_kv({"units.0": "kv4", "units.1": "kv4"})
    new = reprice_from_telemetry(pol, qh)
    assert new.layers["units/0/attn/wq"] == PRESETS["precise"]
    assert new.kv_spec_for("units.0").bits == 6 and new.kv_spec_for("units.1").bits == 4
    assert new.meta["reprice"]["kv_widened"] == {"units.0": 6}


def test_reprice_direct_layer_key_and_ladder_top():
    pol = DSBPPolicy.uniform("efficient", _KEYS)
    new = reprice_from_telemetry(pol, {"units/1/attn/wq": 1})
    assert new.layers["units/1/attn/wq"] == PRESETS["precise"]
    assert new.layers["units/0/attn/wq"] == PRESETS["efficient"]
    top = DSBPPolicy.uniform("e5m7_fixed", _KEYS)
    again = reprice_from_telemetry(top, {"units.0": 9})
    assert again.layers == top.layers
    assert again.meta["reprice"]["widened"] == {} and again.meta["reprice"]["unmatched"] == []


def test_reprice_drift_flag_with_calibration():
    qh = QuantHealth()
    qh.entry("units.0").shift_hist[0] = 100
    new = reprice_from_telemetry(DSBPPolicy.uniform("efficient", _KEYS), qh,
                                 calibration={"units.0": np.array([0, 0, 0, 100])},
                                 drift_threshold=0.5)
    assert new.layers["units/0/attn/wq"] == PRESETS["precise"]
    assert "shift_drift" in new.meta["reprice"]["flagged"]["units.0"]


def test_widen_config_ladder_order():
    widths = [PRESETS[n].input_cfg.b_fix + PRESETS[n].weight_cfg.b_fix for n in WIDEN_LADDER]
    assert widths == sorted(widths)
    assert widen_config(None) is None
    assert widen_config(PRESETS["efficient"]) == PRESETS["precise"]
    assert widen_config(PRESETS["e5m7_fixed"]) == PRESETS["e5m7_fixed"]


def _health(mod, trips, hist):
    qh = mod.QuantHealth()
    for name, n in trips.items():
        qh.record_trip(name, n)
    for name, h in hist.items():
        qh.entry(name).shift_hist[: len(h)] = h
    return qh


def test_reprice_json_equals_jax():
    """The repriced policy (and its decision trail) serializes to JAX's
    JSON for the same telemetry, given as a health object: trips with KV
    specs, a direct layer key with an unmatched entry, a drift flag."""
    cases = (dict(preset="efficient", kv={"units.0": "kv4", "units.1": "kv6"},
                  trips={"units.0": 2, "units.1": 1}, kw={}),
             dict(preset="e5m3_fixed", kv={}, trips={"units/1/attn/wq": 1, "units.5": 3},
                  kw=dict(min_trips=1)),
             dict(preset="precise", kv={"units.1": "kv4"}, trips={"units.0": 1},
                  hist={"units.1": [0, 100]}, kw=dict(drift_threshold=0.4, min_trips=2)))
    for case in cases:
        pols = []
        for pmod, omod in ((JP, JO), (TP, TO)):
            pol = pmod.DSBPPolicy.uniform(case["preset"], _KEYS)
            if case["kv"]:
                pol = pol.with_kv(case["kv"])
            qh = _health(omod, case["trips"], case.get("hist", {}))
            calib = {"units.1": np.array([100, 0])} if case.get("hist") else None
            pols.append(pmod.reprice_from_telemetry(pol, qh, calibration=calib, **case["kw"]))
        assert pols[1].to_json() == pols[0].to_json(), case
        assert DSBPPolicy.from_json(pols[0].to_json()).to_json() == pols[1].to_json()


def test_repriced_policy_loads_through_checkpoint_path(tmp_path):
    """The port's case of JAX's test of the same name (tests/test_obs.py
    :365): a repriced policy saved by ``DSBPPolicy.save`` through the
    port's checkpoint store and loaded back widens the tripping layer, its
    KV entry and its decision trail; its JSON equals JAX's repriced
    policy's after JAX's own save and load, and the port loads JAX's
    checkpoint to the same JSON."""
    pol = DSBPPolicy.uniform("efficient", _KEYS).with_kv({"units.0": "kv4"})
    new = reprice_from_telemetry(pol, {"units.0": 1})
    path = new.save(str(tmp_path / "port"), step=3)
    back = DSBPPolicy.load(str(tmp_path / "port"))
    assert path and back.layers["units/0/attn/wq"] == PRESETS["precise"]
    assert back.kv_spec_for("units.0").bits == 6
    assert back.meta["reprice"]["flagged"] == {"units.0": "guard_trips=1"}
    jnew = JP.reprice_from_telemetry(
        JP.DSBPPolicy.uniform("efficient", _KEYS).with_kv({"units.0": "kv4"}), {"units.0": 1})
    jnew.save(str(tmp_path / "jax"), step=3)
    want = JP.DSBPPolicy.load(str(tmp_path / "jax")).to_json()
    assert back.to_json() == new.to_json() == want
    assert DSBPPolicy.load(str(tmp_path / "jax")).to_json() == want


# ---------------------------------------------------------------------------
# the recorder alone
# ---------------------------------------------------------------------------

def _lifecycle(rec):
    rec.serve_start("paged", [("a", 4)])
    rec.admitted("a", 0, prompt_len=4)
    rec.first_token("a", 1)
    rec.decode_step(1, 1, 0.001)
    rec.preempted("a", 2)
    rec.admitted("a", 3, resumed=True)
    rec.first_token("a", 3)
    rec.spec_round(4, [1, 3])
    rec.fault_injected("cow", 0)
    rec.terminal("a", "ok", 5, tokens=4)
    rec.serve_end({"decode_tokens": 4, "decode_tps": 100.0,
                   "prefix_lookups": 2, "prefix_hit_blocks": 3})


def test_recorder_full_lifecycle_and_preempt_cycle():
    rec = ServeRecorder(enabled=True)
    _lifecycle(rec)
    assert rec.complete_spans({"a": "ok"})
    assert not rec.complete_spans({"a": "cancelled"})
    phases = [c["phase"] for c in rec.trace.span_tree("a")["children"]]
    assert phases == ["queued", "prefill", "decode", "queued", "prefill", "decode"]
    assert rec.metrics.value("serve_preemptions_total") == 1
    assert rec.metrics.value("serve_resumed_total") == 1
    assert rec.metrics.value("serve_decode_tokens_total") == 4
    assert rec.metrics.value("serve_prefix_hit_rate") == pytest.approx(1.5)
    summ = rec.request_summary()["a"]
    assert summ["tok_s"] > 0 and summ["total_s"] >= summ["ttft_s"]
    jrec = JO.ServeRecorder(enabled=True)
    _lifecycle(jrec)
    assert rec.trace.signature() == jrec.trace.signature()
    strip = [n for n in jrec.metrics.snapshot()["families"]
             if not n.endswith("_seconds")]  # wall-clock histograms differ
    for name in strip:
        assert rec.metrics.snapshot()["families"][name] == \
            jrec.metrics.snapshot()["families"][name], name


def test_recorder_disabled_is_inert():
    rec = ServeRecorder(enabled=False)
    rec.serve_start("dense", [("a", 4)])
    rec.admitted("a", 0)
    rec.guard_trip(["a"], 1, cache=_fake_cache(poison=True))
    rec.terminal("a", "ok", 2)
    rec.serve_end({"decode_tokens": 4})
    assert not rec.trace.events and not rec.requests
    assert rec.health.total_trips == 0
    assert rec.metrics.snapshot()["families"] == {}


@pytest.mark.parametrize("extra", [[], ["--paged", "--kv-block-size", "4"]], ids=["dense", "paged"])
def test_launcher_robust_flags(monkeypatch, capsys, tmp_path, extra):
    """--numeric-guard, --deadline-steps, --observe and its exports, as
    JAX's launcher prints them."""
    import sys

    from repro_torch.launch import serve as launcher

    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    argv = ["serve", "--smoke", "--packed", "--device", "cpu", "--new-tokens", "4",
            "--prompt-len", "7", "--batch", "2", "--numeric-guard", "quarantine-lane",
            "--deadline-steps", "3", "--trace", str(trace), "--metrics-json", str(metrics),
            *extra]
    monkeypatch.setattr(sys, "argv", argv)
    launcher.main()
    out = capsys.readouterr().out
    assert "served 4 ragged requests" in out and "lifecycle: {" in out
    assert "guard_checks" in out and out.count(" ttft ") == 4
    assert json.loads(trace.read_text())["traceEvents"]
    snap = json.loads(metrics.read_text())
    assert snap["scheduler"] == ("paged" if extra else "dense") and snap["trace"]["dropped"] == 0
