"""The port's DSBP policy loop against the JAX package, on the CPU.

The cases of ``tests/test_policy.py`` (all but the two that need
``checkpoint.store``, which is not ported), each held against the JAX
package on the same weights (yi-9b smoke, carried across by
``repro_torch.bridge``): the policy JSON is one string in both packages,
both ways; packing under a mixed policy gives JAX's containers field for
field; policy serving gives JAX's greedy tokens (GQA and MHA smoke
llama-7b-paper, with a joint ``kv_layers`` side); the calibration report
equals JAX's; the pricing functions (cost, KV, draft) give JAX's outputs
exactly on JAX's report; the autotuner returns JAX's policy.

Tolerances.  Weight-side statistics, ``tokens``, ``groups``, ``total`` and
``flops`` are exact (the weights are bridged; the flops accumulate in the
same order).  The input side sees activations that differ from JAX's in
the last bits (the float matmuls sum in other orders), so a group ratio or
an element's FP8 rounding can cross an edge: the ratio and shift
histograms may differ by ``HIST_TOL`` of their counts (L1, a moved count
counts twice) and ``nz`` by the same share (measured: equal at these
seeds).  Packed serving runs the port's ``dsbp_fused`` (plain) beside
JAX's ``dsbp_ref``, which the JAX suite holds bit-exact; streams may part
only at a near tie of the JAX model (``_streams_match``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core import energy as JE  # noqa: E402
from repro.core.packed import PackedDSBPWeight as JaxPacked  # noqa: E402
from repro.core.packed import key_entry_str  # noqa: E402
from repro.core.quantized import PRESETS as JAX_PRESETS  # noqa: E402
from repro.eval import boolq_synthetic as jax_boolq  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro import policy as JP  # noqa: E402
from repro.policy.cost import input_bitwidth_ladder as jax_ladder  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import policy as TP  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import energy as E  # noqa: E402
from repro_torch.core.dsbp import DSBPConfig  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.core.quantized import PRESETS, QuantizedMatmulConfig  # noqa: E402
from repro_torch.eval import boolq_synthetic  # noqa: E402
from repro_torch.kvq import KV_PRESETS  # noqa: E402
from repro_torch.launch import calibrate as calibrate_launcher  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.policy.cost import input_bitwidth_ladder  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig, pack_weights_int8  # noqa: E402
from repro_torch.spec.draft import projection_keys  # noqa: E402
from test_torch_engine import PROMPT_SEED  # noqa: E402
from test_torch_model import VARIANTS, make_pair, np_tree  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402

HIST_TOL = 0.01
MIXED = ("precise", "efficient", "e5m7_fixed", "e5m3_fixed")


def _models():
    """(JAX cfg, JAX params, port cfg, port model) with the same weights."""
    jcfg = jax_smoke_config("yi-9b").replace(dtype="float32", remat=False)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_config("yi-9b")
    return jcfg, params, cfg, bridge.model_from_jax(np_tree(params), cfg, device="cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg, params, cfg, model = _models()
    jrep = JP.calibrate(params, jcfg,
                        JP.synthetic_calibration_batches(jcfg, 1, 2, 16, seed=0))
    rep = TP.calibrate(model, cfg, TP.synthetic_calibration_batches(cfg, 1, 2, 16, seed=0))
    return jcfg, params, jrep, cfg, model, rep


def _port_cfg(jc) -> QuantizedMatmulConfig:
    return QuantizedMatmulConfig(input_cfg=DSBPConfig(**dataclasses.asdict(jc.input_cfg)),
                                 weight_cfg=DSBPConfig(**dataclasses.asdict(jc.weight_cfg)))


def _port_report(jrep) -> TP.CalibrationReport:
    """JAX's report as the port's dataclasses, field for field."""
    return TP.CalibrationReport(
        layers={k: TP.LayerStats(**{f.name: getattr(s, f.name)
                                    for f in dataclasses.fields(TP.LayerStats)})
                for k, s in jrep.layers.items()},
        meta=dict(jrep.meta))


def _mixed_policy(report, policy_cls, presets):
    """Two presets alternating over the report's sorted paths."""
    keys = sorted(report.layers)
    cfgs = [presets["precise"], presets["efficient"]]
    return policy_cls(layers={k: cfgs[i % 2] for i, k in enumerate(keys)},
                      meta={"origin": "test"})


# ---------------- artifact round-trips ----------------

def test_policy_json_roundtrip(setup):
    _, _, jrep, _, _, rep = setup
    pol = _mixed_policy(rep, TP.DSBPPolicy, PRESETS)
    pol.default = PRESETS["e5m3_fixed"]
    back = TP.DSBPPolicy.from_json(pol.to_json())
    assert back.layers == pol.layers
    assert back.default == pol.default
    assert back.meta == pol.meta
    k = sorted(pol.layers)[0]
    assert back.config_for(k) == pol.layers[k]
    assert back.config_for("units/9/nope") == PRESETS["e5m3_fixed"]
    # the same artifact as JAX's, string for string
    jpol = _mixed_policy(jrep, JP.DSBPPolicy, JAX_PRESETS)
    jpol.default = JAX_PRESETS["e5m3_fixed"]
    assert jpol.to_json() == pol.to_json()


def _joint_jax_policy(jrep):
    keys = sorted(jrep.layers)
    return JP.DSBPPolicy(
        layers={k: JAX_PRESETS[MIXED[i % 4]] for i, k in enumerate(keys)},
        default=JAX_PRESETS["precise"], meta={"origin": "jax", "acc": [1.0, 0.5]},
        kv_layers={"units.0": "kv4", "tail.0": None}, kv_default="kv8")


def test_policy_json_is_one_artifact_both_ways(setup):
    """A JAX-made joint policy (mixed presets + kv_layers) loads in the port
    and writes the same string; a port-made one loads in JAX likewise."""
    _, _, jrep, _, _, _ = setup
    jpol = _joint_jax_policy(jrep)
    tpol = TP.DSBPPolicy.from_json(jpol.to_json())
    assert tpol.to_json() == jpol.to_json()
    assert tpol.kv_spec_for("units.0") == KV_PRESETS["kv4"]
    assert tpol.kv_spec_for("tail.0") is None
    assert tpol.kv_spec_for("units.1") == KV_PRESETS["kv8"]
    for k, c in jpol.layers.items():
        assert tpol.config_for(k) == _port_cfg(c)
    assert tpol.summary() == jpol.summary()
    back = JP.DSBPPolicy.from_json(tpol.to_json())
    assert back.to_json() == jpol.to_json()
    # replace_layer / with_kv / uniform keep the strings equal too
    k0 = sorted(jpol.layers)[0]
    assert (tpol.replace_layer(k0, PRESETS["efficient"]).to_json()
            == jpol.replace_layer(k0, JAX_PRESETS["efficient"]).to_json())
    art = {"units.0": "kv8", "default": "kv4"}
    assert (tpol.with_kv(art, meta_update={"x": 1}).to_json()
            == jpol.with_kv(art, meta_update={"x": 1}).to_json())
    assert (TP.DSBPPolicy.uniform("precise", [k0]).to_json()
            == JP.DSBPPolicy.uniform("precise", [k0]).to_json())
    assert len(tpol) == len(jpol)


# ---------------- packing ----------------

def test_pack_weights_int8_unknown_preset_valueerror(setup):
    _, _, _, cfg, _, _ = setup
    with pytest.raises(ValueError) as ei:
        pack_weights_int8(TM.init(cfg, device="cpu"), "not_a_preset")
    msg = str(ei.value)
    for name in PRESETS:
        assert name in msg
    assert "DSBPPolicy" in msg


def _by_key(model) -> dict:
    out = {}
    for key, pw in projection_keys(model):
        out.setdefault(key, []).append(pw)
    return out


def test_policy_packing_embeds_per_layer_configs(setup):
    """A mixed policy packs different configs into different containers,
    uncovered projections stay raw, and every container equals JAX's
    stacked one at its unit, field for field."""
    jcfg, params, jrep, cfg, _, rep = setup
    keys = sorted(rep.layers)
    pol = TP.DSBPPolicy(layers={keys[0]: PRESETS["precise"],
                                keys[1]: PRESETS["efficient"]})  # no default
    model = bridge.model_from_jax(np_tree(params), cfg, device="cpu")
    stats = pack_weights_int8(model, pol)
    assert stats["layers_packed"] == 2 * cfg.n_units
    by_key = _by_key(model)
    assert sorted(by_key) == keys[:2]
    assert all(pw.cfg == PRESETS["precise"] for pw in by_key[keys[0]])
    assert all(pw.cfg == PRESETS["efficient"] for pw in by_key[keys[1]])
    raw = {n for n, p in model.named_parameters() if n.split(".")[-1] in ("wq", "w2")}
    assert raw  # uncovered projections stay raw parameters
    jpacked, jstats = jax_pack(params, JP.DSBPPolicy.from_json(pol.to_json()))
    assert jstats["avg_w_bits"] == stats["avg_w_bits"]
    _assert_containers_equal(jpacked, model)


def _assert_containers_equal(jpacked, model):
    flat = jax.tree_util.tree_flatten_with_path(
        jpacked, is_leaf=lambda x: isinstance(x, JaxPacked))[0]
    jby = {"/".join(key_entry_str(p) for p in path): leaf for path, leaf in flat
           if isinstance(leaf, JaxPacked)}
    tby = _by_key(model)
    assert sorted(jby) == sorted(tby)
    for key, jpw in jby.items():
        assert all(pw.cfg == _port_cfg(jpw.cfg) for pw in tby[key])
        for r, pw in enumerate(tby[key]):
            for f in ("ka", "kscale", "tscale", "bits"):
                np.testing.assert_array_equal(getattr(pw, f).numpy(),
                                              np.asarray(getattr(jpw, f))[r])
            assert (pw.k, pw.n, pw.group_size) == (jpw.k, jpw.n, jpw.group_size)


def test_mixed_policy_containers_equal_jax(setup):
    """Every rung of a four-preset policy with a default: ka, kscale,
    tscale, bits and cfg equal to JAX's containers."""
    jcfg, params, jrep, cfg, _, _ = setup
    jpol = _joint_jax_policy(jrep)
    jpacked, jstats = jax_pack(params, jpol)
    model = bridge.model_from_jax(np_tree(params), cfg, device="cpu")
    stats = pack_weights_int8(model, TP.DSBPPolicy.from_json(jpol.to_json()))
    assert stats["avg_w_bits"] == jstats["avg_w_bits"]
    _assert_containers_equal(jpacked, model)


def test_policy_under_a_mesh_is_refused(setup):
    _, _, _, cfg, _, rep = setup
    pol = TP.DSBPPolicy.uniform("precise", sorted(rep.layers))
    with pytest.raises(NotImplementedError, match="A13"):
        Engine(TM.init(cfg, device="cpu"),
               ServeConfig(max_len=32, pack_preset=pol, mesh_shape=(1, 1)), device="cpu")


# ---------------- serving parity ----------------

def test_uniform_policy_token_parity(setup):
    """A uniform policy serves token for token (and logit for logit) what
    the same config as a global preset serves, and JAX's tokens."""
    jcfg, params, jrep, cfg, _, rep = setup
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8))
    lengths = np.asarray([8, 5, 3])
    pol = TP.DSBPPolicy.uniform("precise", sorted(rep.layers))
    eng_p = Engine(bridge.model_from_jax(np_tree(params), cfg, device="cpu"),
                   ServeConfig(max_len=48, pack_preset=pol), device="cpu")
    eng_g = Engine(bridge.model_from_jax(np_tree(params), cfg.replace(quant="precise"),
                                         device="cpu"), ServeConfig(max_len=48), device="cpu")
    assert eng_p.cfg.quant == "policy" and eng_p.quant.per_layer
    got = eng_p.generate(prompts, 6, lengths=lengths)
    ref = eng_g.generate(prompts, 6, lengths=lengths)
    np.testing.assert_array_equal(got, ref)
    with torch.inference_mode():
        a = eng_p.model.forward(torch.as_tensor(prompts), quant=eng_p.quant)
        b = eng_g.model.forward(torch.as_tensor(prompts), quant=eng_g.quant)
    assert torch.equal(a, b)
    jeng = JaxEngine(params, jcfg, JaxServeConfig(
        max_len=48, quant_method="dsbp_ref",
        pack_preset=JP.DSBPPolicy.uniform("precise", sorted(jrep.layers))))
    np.testing.assert_array_equal(got, jeng.generate(prompts, 6, lengths=lengths))


def test_uniform_policy_score_parity(setup):
    _, _, _, cfg, _, rep = setup
    pol = TP.DSBPPolicy.uniform("efficient", sorted(rep.layers))
    eng_p = Engine(TM.init(cfg, device="cpu"), ServeConfig(max_len=64, pack_preset=pol),
                   device="cpu")
    eng_g = Engine(TM.init(cfg.replace(quant="efficient"), device="cpu"),
                   ServeConfig(max_len=64), device="cpu")
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, cfg.vocab_size, (n,)) for n in (10, 7, 12)]
    plens = [6, 3, 8]
    np.testing.assert_array_equal(eng_p.score_continuations(seqs, plens),
                                  eng_g.score_continuations(seqs, plens))


def test_mixed_policy_serves_ragged(setup):
    """A mixed per-layer policy runs the slot scheduler; a ragged serve
    equals each request alone and JAX's streams."""
    jcfg, params, jrep, cfg, _, rep = setup
    pol = _mixed_policy(rep, TP.DSBPPolicy, PRESETS)
    fresh = lambda: bridge.model_from_jax(np_tree(params), cfg, device="cpu")  # noqa: E731
    eng = Engine(fresh(), ServeConfig(max_len=48, batch_size=2, pack_preset=pol),
                 device="cpu")
    assert eng.cfg.quant == "policy"
    assert eng.pack_report["layers_packed"] == len(rep.layers) * cfg.n_units
    rng = np.random.default_rng(3)
    lens = (5, 9, 3, 7)
    toks = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    out = eng.serve([Request(uid=i, tokens=t, max_new_tokens=4)
                     for i, t in enumerate(toks)], max_new_tokens=4)
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(v) == 4 for v in out.values())
    for uid in (0, 2):
        solo = Engine(fresh(), ServeConfig(max_len=48, batch_size=1, pack_preset=pol),
                      device="cpu")
        np.testing.assert_array_equal(out[uid], solo.serve([toks[uid]], max_new_tokens=4)[0])
    jeng = JaxEngine(params, jcfg, JaxServeConfig(
        max_len=48, batch_size=2, quant_method="dsbp_ref",
        pack_preset=JP.DSBPPolicy.from_json(pol.to_json())))
    jreqs = [JaxRequest(uid=i, tokens=t, max_new_tokens=4) for i, t in enumerate(toks)]
    _streams_match(jeng.serve(jreqs, max_new_tokens=4), out, jeng, jreqs)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_joint_policy_serve_matches_jax(variant):
    """A JAX-made joint policy (four presets cycling over the projections,
    kv_layers {units.0: kv4, default: kv8}) through ``pack_preset`` and
    ``kv_quant``: the port's greedy streams are JAX's ``Engine.serve``'s
    on GQA and MHA smoke llama-7b-paper."""
    jcfg, params, model = make_pair(variant, packed=False)
    keys = sorted(f"units/0/{sub}/{n}" for sub, ns in (("attn", ("wq", "wk", "wv", "wo")),
                                                       ("ffn", ("w1", "w2", "w3")))
                  for n in ns)
    jpol = JP.DSBPPolicy(layers={k: JAX_PRESETS[MIXED[i % 4]] for i, k in enumerate(keys)},
                         kv_layers={"units.0": "kv4"}, kv_default="kv8")
    pol = TP.DSBPPolicy.from_json(jpol.to_json())
    jeng = JaxEngine(params, jcfg, JaxServeConfig(
        max_len=32, batch_size=2, quant_method="dsbp_ref", pack_preset=jpol, kv_quant=jpol))
    eng = Engine(model, ServeConfig(max_len=32, batch_size=2, pack_preset=pol, kv_quant=pol),
                 device="cpu")
    assert eng.kv_spec == {"units.0": KV_PRESETS["kv4"], "default": KV_PRESETS["kv8"]}
    rng = np.random.default_rng(PROMPT_SEED)
    toks = [rng.integers(0, jcfg.vocab_size, n) for n in (5, 11, 8, 3)]
    jreqs = [JaxRequest(uid=i, tokens=t, max_new_tokens=5) for i, t in enumerate(toks)]
    out = eng.serve([Request(uid=i, tokens=t, max_new_tokens=5)
                     for i, t in enumerate(toks)], max_new_tokens=5)
    assert eng.last_stats["kv_packed"]
    _streams_match(jeng.serve(jreqs, max_new_tokens=5), out, jeng, jreqs)


def test_weight_only_policy_keeps_the_float_cache(setup):
    _, _, _, cfg, _, _ = setup
    assert Engine(TM.init(cfg, device="cpu"), ServeConfig(
        max_len=32, kv_quant=TP.DSBPPolicy()), device="cpu").kv_spec is None


# ---------------- calibration ----------------

def test_calibration_deterministic_under_fixed_seeds(setup):
    _, _, _, cfg, model, report = setup
    rep2 = TP.calibrate(model, cfg, TP.synthetic_calibration_batches(cfg, 1, 2, 16, seed=0))
    assert sorted(report.layers) == sorted(rep2.layers)
    for k, s in report.layers.items():
        s2 = rep2.layers[k]
        np.testing.assert_array_equal(s.ratio_hist, s2.ratio_hist)
        np.testing.assert_array_equal(s.shift_hist, s2.shift_hist)
        np.testing.assert_array_equal(s.w_bdyn_hist, s2.w_bdyn_hist)
        assert (s.nz, s.total, s.groups, s.tokens, s.flops) == \
               (s2.nz, s2.total, s2.groups, s2.tokens, s2.flops)


def _assert_reports_match(jrep, rep):
    assert sorted(jrep.layers) == sorted(rep.layers)
    assert rep.meta == {**jrep.meta, "probe_fmt": tuple(jrep.meta["probe_fmt"])}
    worst = 0.0
    for k, js in jrep.layers.items():
        s = rep.layers[k]
        assert (s.k, s.n, s.total, s.groups, s.tokens, s.flops, s.w_groups) == \
               (js.k, js.n, js.total, js.groups, js.tokens, js.flops, js.w_groups), k
        np.testing.assert_array_equal(s.w_bdyn_hist, js.w_bdyn_hist)
        assert s.w_nz_frac == js.w_nz_frac
        for h, jh, n in ((s.ratio_hist, js.ratio_hist, js.groups),
                         (s.shift_hist, js.shift_hist, js.nz)):
            assert h.shape == jh.shape and h.dtype == jh.dtype
            d = np.abs(h - jh).sum() / max(n, 1)
            assert d <= HIST_TOL, (k, d)
            worst = max(worst, d)
        assert abs(s.nz - js.nz) <= HIST_TOL * js.total, k
    return worst


def test_calibration_report_matches_jax(setup):
    _, _, jrep, _, _, rep = setup
    _assert_reports_match(jrep, rep)


def test_calibration_covers_projections_with_flop_shares(setup):
    _, _, _, _, _, report = setup
    assert sorted(report.layers) == [
        "units/0/attn/wk", "units/0/attn/wo", "units/0/attn/wq",
        "units/0/attn/wv", "units/0/ffn/w1", "units/0/ffn/w2",
        "units/0/ffn/w3"]
    shares = [report.flop_share(p) for p in report.layers]
    assert abs(sum(shares) - 1.0) < 1e-9
    assert report.layers["units/0/ffn/w1"].flops > \
           report.layers["units/0/attn/wk"].flops


def test_calibration_rejects_packed_tree(setup):
    _, _, _, cfg, _, _ = setup
    model = TM.init(cfg, device="cpu")
    pack_weights_int8(model, "precise")
    with pytest.raises(ValueError, match="raw float tree"):
        TP.calibrate(model, cfg, TP.synthetic_calibration_batches(cfg, 1, 1, 16))


def test_calibration_batches_equal_jax(setup):
    jcfg, _, _, cfg, _, _ = setup
    for j, t in zip(JP.synthetic_calibration_batches(jcfg, 3, 2, 16, seed=4),
                    TP.synthetic_calibration_batches(cfg, 3, 2, 16, seed=4)):
        np.testing.assert_array_equal(j, t)


def test_group_ratio_histogram_edges_match_numpy():
    """The device-side bucketize puts every f32 ratio in np.histogram's
    bin, the closed last bin included, at and next to every edge."""
    from repro.policy.calibrate import bin_centers as jax_bin_centers
    from repro_torch.policy.calibrate import RATIO_BINS, _bin_edges, _count, bin_centers

    e = _bin_edges()
    vals = []
    for x in e:
        f = np.float32(x)
        vals += [f, np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(64))]
    ratio = np.clip(np.asarray(vals, np.float32), 0, 31)
    edges = torch.as_tensor(e, dtype=torch.float64)
    b = (torch.bucketize(torch.as_tensor(ratio).double(), edges, right=True) - 1).clamp(0, 255)
    h = torch.zeros(RATIO_BINS, dtype=torch.int64)
    _count(h, b)
    np.testing.assert_array_equal(h.numpy(), np.histogram(ratio, bins=e)[0])
    np.testing.assert_array_equal(bin_centers(), jax_bin_centers())


# ---------------- cost model (on JAX's report) ----------------

def test_uniform_fixed_cost_matches_closed_form(setup):
    _, _, jrep, _, _, _ = setup
    report = _port_report(jrep)
    for preset, (i, w, eff) in {"e5m3_fixed": (4, 4, 77.9),
                                "e5m7_fixed": (8, 8, 20.4)}.items():
        c = TP.assignment_cost(report, {p: preset for p in report.layers})
        assert (c["avg_i"], c["avg_w"]) == (i, w)
        np.testing.assert_allclose(
            c["eff_tops_w"], E.efficiency_tops_per_w(i, w, "fp_fixed"), rtol=1e-9)
        np.testing.assert_allclose(c["eff_tops_w"], eff, rtol=0.05)


def _ladders(pkg_ladder):
    return pkg_ladder((6, 4, 3, 2)) + pkg_ladder((6, 3, 1))


def test_assignment_cost_equals_jax_on_jax_report(setup):
    """Every uniform rung of both ladders and a mixed assignment: the
    port's cost dict is JAX's, number for number."""
    _, _, jrep, _, _, _ = setup
    report = _port_report(jrep)
    keys = sorted(jrep.layers)
    jl = JP.candidate_ladder() + _ladders(jax_ladder)
    tl = TP.candidate_ladder() + _ladders(input_bitwidth_ladder)
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (_, jc), (_, tc) in zip(jl, tl):
        assert tc == _port_cfg(jc)
        assert JP.assignment_cost(jrep, {p: jc for p in keys}) == \
            TP.assignment_cost(report, {p: tc for p in keys})
    mixed = {p: MIXED[i % 4] for i, p in enumerate(keys)}
    assert JP.assignment_cost(jrep, mixed) == TP.assignment_cost(report, mixed)


def test_predict_layer_bits_orders_with_b_fix(setup):
    _, _, jrep, _, _, _ = setup
    report = _port_report(jrep)
    key = sorted(report.layers)[0]
    stats = report.layers[key]
    fixed = QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt="e4m3", side="input", k=0.0, b_fix=5, mode="fixed"),
        weight_cfg=DSBPConfig(fmt="e2m5", side="weight", k=0.0, b_fix=3,
                              mode="fixed", scale_granularity="row"))
    assert TP.predict_layer_bits(stats, fixed) == (6.0, 4.0)
    ladder = input_bitwidth_ladder((6, 3, 1))
    bits = [TP.predict_layer_bits(stats, c)[0] for _, c in ladder]
    assert bits[0] > bits[1] > bits[2]
    ws = {round(TP.predict_layer_bits(stats, c)[1], 6) for _, c in ladder}
    assert len(ws) == 1
    for (_, jc), (_, tc) in zip(jax_ladder((6, 3, 1)), ladder):
        assert JP.predict_layer_bits(jrep.layers[key], jc) == \
            TP.predict_layer_bits(stats, tc)


def test_energy_constants_feed_the_same_model():
    assert dataclasses.asdict(E.MACRO) == dataclasses.asdict(JE.MACRO)
    for row in E.TABLE1:
        assert E.efficiency_tops_per_w(row["i"], row["w"], row["mode"]) == \
            JE.efficiency_tops_per_w(row["i"], row["w"], row["mode"])


# ---------------- KV and draft pricing (on JAX's report) ----------------

def test_price_draft_bits_equals_jax(setup):
    _, _, jrep, _, _, _ = setup
    report = _port_report(jrep)
    for kw in ({}, {"bits_fine": 7, "bits_coarse": 3, "budget_frac_fine": 0.3},
               {"budget_frac_fine": 1.0}):
        for pack in ("precise", "efficient", "e5m7_fixed"):
            assert TP.price_draft_bits(report, pack, **kw) == \
                JP.price_draft_bits(jrep, pack, **kw)
    with pytest.raises(ValueError):
        TP.price_draft_bits(report, bits_fine=2, bits_coarse=3)


def test_price_draft_bits_feeds_spec_draft_bits(setup):
    """The draft-width artifact resolves per layer in the port's engine as
    in JAX's."""
    from repro_torch.spec import draft_params

    _, params, jrep, cfg, _, _ = setup
    bits, _ = TP.price_draft_bits(_port_report(jrep), budget_frac_fine=0.3)
    eng = Engine(bridge.model_from_jax(np_tree(params), cfg.replace(quant="precise"),
                                       device="cpu"),
                 ServeConfig(max_len=32, spec_k=2, spec_draft_bits=bits), device="cpu")
    widths = draft_params(eng.model, bits)
    for key, pw in projection_keys(eng.model):
        assert widths[pw] == bits.get(key, bits["default"])
    assert len(set(widths.values())) == 2  # fine and coarse layers both present


def _kv_pair(variant="gqa"):
    jcfg, params, model = make_pair(variant, packed=False)
    batches = JP.synthetic_calibration_batches(jcfg, 2, 2, 16, seed=1)
    return (JP.collect_kv_stats(params, jcfg, batches),
            TP.collect_kv_stats(model, model.cfg, batches))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_collect_kv_stats_matches_jax(variant):
    jst, tst = _kv_pair(variant)
    assert sorted(jst) == sorted(tst)
    for name, j in jst.items():
        t = tst[name]
        assert (t.name, t.mbits, t.total, t.groups, t.bytes_per_token) == \
               (j.name, j.mbits, j.total, j.groups, j.bytes_per_token)
        assert np.abs(t.shift_hist - j.shift_hist).sum() <= HIST_TOL * j.nz
        assert abs(t.nz - j.nz) <= HIST_TOL * j.total


def _kv_stats_as_port(jst):
    return {n: TP.KVEntryStats(**{f.name: getattr(s, f.name)
                                  for f in dataclasses.fields(TP.KVEntryStats)})
            for n, s in jst.items()}


def test_price_kv_bits_equals_jax():
    jst, _ = _kv_pair()
    tst = _kv_stats_as_port(jst)
    for spec in ("kv8", "kv6", "kv4", 3):
        for n in jst:
            assert TP.kv_dropped_bits(tst[n], spec) == JP.kv_dropped_bits(jst[n], spec)
    for kw in ({}, {"budget_frac_fine": 1.0}, {"budget_frac_fine": 0.0},
               {"fine": "kv6", "coarse": "kv4"}):
        art, info = TP.price_kv_bits(tst, **kw)
        jart, jinfo = JP.price_kv_bits(jst, **kw)
        assert info == jinfo
        assert {k: dataclasses.asdict(v) for k, v in art.items()} == \
            {k: dataclasses.asdict(v) for k, v in jart.items()}
    with pytest.raises(ValueError):
        TP.price_kv_bits(tst, fine="kv4", coarse="kv8")
    with pytest.raises(ValueError):
        TP.price_kv_bits({})


# ---------------- the autotuner end to end ----------------

def test_autotune_produces_serving_policy(setup):
    """At tests/test_policy.py's setup, with KV pricing from JAX's KV
    statistics, the port returns JAX's joint policy: the same rungs, trace,
    accuracies and KV side; it serves end to end."""
    jcfg, params, jrep, cfg, model, report = setup
    task = boolq_synthetic(cfg.vocab_size, 16, seed=9)
    assert [(i.context, i.choices) for i in task.items] == [
        (i.context, i.choices) for i in jax_boolq(jcfg.vocab_size, 16, seed=9).items]
    jkv = JP.collect_kv_stats(params, jcfg, JP.synthetic_calibration_batches(
        jcfg, 1, 2, 16, seed=2))
    ladder = input_bitwidth_ladder((6, 2))
    kw = dict(max_drop=1.0, quant_method="dsbp_ref", batch_items=8)
    pol = TP.autotune(model, cfg, report, [task], ladder=ladder,
                      kv_stats=_kv_stats_as_port(jkv), **kw)
    assert sorted(pol.layers) == sorted(report.layers)
    assert all(r == "i2_w7" for r in pol.meta["rungs"].values())
    ceiling = TP.assignment_cost(report, {p: ladder[0][1] for p in report.layers})
    assert pol.meta["modeled"]["eff_tops_w"] > ceiling["eff_tops_w"]
    # the raw model is left as it was: the trials ran on a shared view
    assert not any(isinstance(m, PackedDSBPWeight) for m in model.modules())
    jpol = JP.autotune(params, jcfg, jrep, [jax_boolq(jcfg.vocab_size, 16, seed=9)],
                       ladder=jax_ladder((6, 2)), kv_stats=jkv, **kw)
    assert pol.layers == {k: _port_cfg(c) for k, c in jpol.layers.items()}
    for key in ("trace", "baseline_acc", "final_acc", "rungs", "kv_pricing"):
        assert pol.meta[key] == jpol.meta[key], key
    assert pol.kv_spec_for("units.0") == KV_PRESETS[
        "kv" + jpol.meta["kv_pricing"]["assignment"]["units.0"].split("/")[0][2:]]
    back = TP.DSBPPolicy.from_json(pol.to_json())
    eng = Engine(bridge.model_from_jax(np_tree(params), cfg, device="cpu"),
                 ServeConfig(max_len=48, batch_size=2, pack_preset=back), device="cpu")
    out = eng.serve([np.arange(5) % cfg.vocab_size], max_new_tokens=3)
    assert len(out[0]) == 3


def test_autotune_strict_floor_matches_jax(setup):
    """max_drop 0 over the ladder (6, 3, 2), where accuracies decide: on
    the two most bit-hungry paths of the report (the others pack at the
    ceiling), the port takes JAX's decisions, trial for trial."""
    jcfg, params, jrep, cfg, model, report = setup
    keep = ("units/0/ffn/w1", "units/0/ffn/w2")
    sub = lambda r, cls: cls(layers={k: r.layers[k] for k in keep}, meta=r.meta)  # noqa: E731
    kw = dict(max_drop=0.0, quant_method="dsbp_ref", batch_items=16)
    pol = TP.autotune(model, cfg, sub(report, TP.CalibrationReport),
                      [boolq_synthetic(cfg.vocab_size, 16, seed=9)],
                      ladder=input_bitwidth_ladder((6, 3, 2)), **kw)
    jpol = JP.autotune(params, jcfg, sub(jrep, JP.CalibrationReport),
                       [jax_boolq(jcfg.vocab_size, 16, seed=9)],
                       ladder=jax_ladder((6, 3, 2)), **kw)
    assert pol.meta["trace"] == jpol.meta["trace"]
    assert pol.layers == {k: _port_cfg(c) for k, c in jpol.layers.items()}
    assert pol.default == _port_cfg(jpol.default)


def test_calibrate_launcher_prints_the_policy(capsys):
    calibrate_launcher.main(["--smoke", "--device", "cpu", "--batches", "1",
                             "--items", "12", "--ladder", "6", "2"])
    out = capsys.readouterr().out
    assert "calibrated 7 projection paths" in out
    assert "modeled on the paper's 28 nm macro" in out
    blob = out.split("policy JSON:\n", 1)[1].strip()
    pol = TP.DSBPPolicy.from_json(blob)
    assert sorted(pol.layers) == sorted(pol.meta["rungs"])
    assert JP.DSBPPolicy.from_json(blob).to_json() == blob


def test_serve_launcher_takes_a_jax_policy_json(monkeypatch, capsys, tmp_path, setup):
    """``launch.serve --policy FILE`` serves a JAX-made joint policy: its
    per-layer configs packed, its KV side as the cache."""
    import sys

    from repro_torch.launch import serve as serve_launcher

    _, _, jrep, _, _, _ = setup
    path = tmp_path / "policy.json"
    path.write_text(_joint_jax_policy(jrep).to_json())
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "yi-9b", "--smoke", "--device",
                                      "cpu", "--ragged", "--new-tokens", "3",
                                      "--prompt-len", "7", "--batch", "2",
                                      "--policy", str(path)])
    serve_launcher.main()
    out = capsys.readouterr().out
    assert "policy of 7 layer entries" in out
    kv_line = next(ln for ln in out.splitlines() if ln.startswith("packed KV cache:"))
    assert "'units.0': KVQuantConfig(bits=4" in kv_line and "'tail.0': None" in kv_line
    assert "served 4 ragged requests" in out and "288 KV bytes/token" in out
