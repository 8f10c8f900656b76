"""The Griffin hybrid family in the port against the JAX package, on the
CPU: models and the dense engine.

Configs: smoke recurrentgemma-2b (rglru, rglru, attn_local x 2 + a tail of
two rglru layers; tied embeddings, MQA), smoke gemma3-12b (5 attn_local :
1 attn_full, tied) and the ring oracle without MoE, smoke llama-7b-paper
with ``pattern=("attn_local",), window=8``.  JAX weights are carried into
the port by ``repro_torch.bridge``; inputs are numpy from a seed.

* ``Model.forward``, ragged ``prefill`` and ``decode_step`` past the
  window (the ring wraps) within 1e-5 of max|logit| of JAX's, caches
  (ring K/V and recurrent state) within 1e-5 of max|ref|; the port decodes
  a bridged JAX cache like JAX; ``verify_step`` + ``rollback_cache``
  within 2e-5 of JAX's (tests/test_spec.py's tolerance).
* Greedy ``generate`` of a float model token-equal to the JAX ``Engine``
  at ``window=16`` (both packages' configs, so prompts past the window
  stay short); the packed engines are in tests/test_torch_hybrid_serve.py
  and tests/test_torch_hybrid_paged.py, which share these helpers.
* The 'fallback' retry's recurrent state: restored from the refs a step
  leaves untouched, it decodes from the pre-step state bit for bit.
* The refusals: the new kinds and tied embeddings under a mesh name A13
  (bfloat16 models are served: tests/test_torch_bf16.py)."""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import Quant  # noqa: E402
from repro_torch.serve.engine import (Engine, Request, ServeConfig,  # noqa: E402
                                      pack_weights_int8)
from test_torch_model import np_tree  # noqa: E402

# the JAX model's entry points, jitted once per shape (eager dispatch of
# a hybrid stack compiles op by op, several times slower)
J_FORWARD = jax.jit(JM.forward, static_argnums=(2,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JM.decode_step, static_argnums=(4,))
J_VERIFY = jax.jit(JM.verify_step, static_argnums=(4, 5))
J_ROLLBACK = jax.jit(JM.rollback_cache, static_argnums=(5, 6))

CONFIGS = {
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "gemma3-12b": ("gemma3-12b", {}),
    "ring-oracle": ("llama-7b-paper", {"pattern": ("attn_local",), "window": 8}),
}
W = 16            # the engines' window: prompts past it stay short
PROMPT_SEED = 5   # pinned: token-equal in every engine configuration here
LENS = np.asarray([30, 11, 23], np.int32)


def hybrid_pair(name="recurrentgemma-2b", seed=0, **kw):
    """(JAX cfg, JAX params, port model) with the same float weights."""
    arch, base = CONFIGS.get(name, (name, {}))
    kw = {**base, **kw}
    jcfg = jax_smoke_config(arch).replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    model = bridge.model_from_jax(np_tree(params), smoke_config(arch).replace(**kw),
                                  device="cpu")
    return jcfg, params, model


@functools.lru_cache(maxsize=None)
def packed_pair(name="recurrentgemma-2b"):
    """(JAX cfg, packed JAX params, packed port model) at window W, built
    once per process: every engine of these tests serves them (an engine
    takes an already packed model as it is)."""
    jcfg, params, model = hybrid_pair(name, window=W, quant="precise")
    params, _ = jax_pack(params, "precise")
    pack_weights_int8(model, "precise")
    return jcfg, params, model


def engines(name="recurrentgemma-2b", packed=True, **scfg):
    """JAX and port engines over the same weights at window W: packed
    "precise" (JAX through dsbp_ref, the port through its default
    dsbp_fused) unless ``packed`` is False."""
    if packed:
        jcfg, params, model = packed_pair(name)
    else:
        jcfg, params, model = hybrid_pair(name, window=W)
    jeng = JaxEngine(params, jcfg, JaxServeConfig(
        quant_method="dsbp_ref" if packed else None, **scfg))
    return jeng, Engine(model, ServeConfig(**scfg), device="cpu")


def prompts(lens=LENS, seed=PROMPT_SEED, vocab=512):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), int(max(lens))), np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, vocab, n)
    return toks


def requests(lens, cls=Request, seed=PROMPT_SEED, new=5, prefix=None):
    """Requests of the given prompt lengths (``prefix`` tokens shared by
    every prompt longer than it, when given)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 512, prefix or 0)
    out = []
    for i, n in enumerate(lens):
        toks = rng.integers(0, 512, n)
        if prefix and n > prefix:
            toks[:prefix] = shared
        out.append(cls(uid=f"r{i}", tokens=toks, max_new_tokens=new))
    return out


def _close(j, t, rel):
    j, t = np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert np.abs(j - t).max() <= rel * max(np.abs(j).max(), 1e-30), np.abs(j - t).max()


def _np_cache(jcache):
    """A JAX float cache tree as numpy, every entry's leaves (K/V or the
    recurrent state)."""
    return {part: [{n: np.asarray(v) for n, v in e.items()} for e in jcache[part]]
            for part in ("units", "tail")}


def _layer_caches(jcache, cfg):
    """A JAX cache tree as the port's per-layer list (unit leaves split)."""
    return bridge.cache_from_jax(_np_cache(jcache), cfg, device="cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jcfg, params, model = hybrid_pair(name)
    toks = prompts(lens=(90, 90), seed=1)
    jl = J_FORWARD(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.inference_mode():
        tl = model.forward(torch.from_numpy(toks))
    _close(jl, tl, 1e-5)
    assert hasattr(model, "lm_head") != jcfg.tie_embeddings


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "ring-oracle"])
def test_prefill_and_decode_past_the_window_match_jax(name):
    """Ragged prefill longer than the window, then decode steps at
    per-row positions (the ring wraps): logits and every cache entry
    within 1e-5 of JAX's; decoding from JAX's own cache (bridged) gives
    JAX's logits too."""
    jcfg, params, model = hybrid_pair(name)
    lens = np.asarray([90, 70, 9], np.int32)
    toks = prompts(lens, seed=2)
    jl, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 128,
                              jnp.asarray(lens))
    with torch.inference_mode():
        tl, tcache, _ = model.prefill(torch.from_numpy(toks), 128, lengths=lens)
    _close(jl, tl, 1e-5)
    bridged = _layer_caches(jcache, jcfg)
    for b, t in zip(bridged, tcache):
        assert b.keys() == t.keys()
        for k in t:
            _close(b[k].numpy(), t[k], 1e-5)
    steps = np.random.default_rng(3).integers(0, 512, (3, 3))
    for t in range(3):
        step = steps[:, t:t + 1]
        jl, jcache = J_DECODE(params, {"tokens": jnp.asarray(step)}, jcache,
                              jnp.asarray(lens + t), jcfg)
        with torch.inference_mode():
            tl, tcache = model.decode_step(torch.from_numpy(step), tcache,
                                           torch.from_numpy(lens + t))
            bl, bridged = model.decode_step(torch.from_numpy(step), bridged,
                                            torch.from_numpy(lens + t))
        _close(jl, tl, 1e-5)
        _close(jl, bl, 1e-5)


def test_verify_and_rollback_match_jax():
    """A 5-token verify from ragged positions past the window (the ring
    slots wrap inside the pass), then a ragged-keep rollback: logits and
    the rolled-back cache within 2e-5 of JAX's verify_step /
    rollback_cache, and the port's rollback equals its own chained decode
    of the kept tokens."""
    jcfg, params, model = hybrid_pair("recurrentgemma-2b", window=8)
    lens = np.asarray([14, 6, 10], np.int32)
    toks = prompts(lens, seed=4)
    _, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 32,
                             jnp.asarray(lens))
    steps = np.random.default_rng(5).integers(0, 512, (3, 5))
    keep = np.asarray([1, 5, 3], np.int32)
    jl, jnew, jrb = J_VERIFY(params, {"tokens": jnp.asarray(steps)}, jcache,
                             jnp.asarray(lens), jcfg, True)
    jrolled = J_ROLLBACK(jcache, jnew, jrb, jnp.asarray(keep), jnp.asarray(lens), jcfg, 5)
    tcache = _layer_caches(jcache, jcfg)
    with torch.inference_mode():
        tl, tcache, rb = model.verify_step(torch.from_numpy(steps), tcache,
                                           torch.from_numpy(lens), collect_rollback=True)
        model.rollback_cache(tcache, rb, torch.from_numpy(keep), torch.from_numpy(lens), 5)
    _close(jl, tl, 2e-5)
    for j, t in zip(_layer_caches(jrolled, jcfg), tcache):
        for k in t:
            _close(j[k].numpy(), t[k], 2e-5)
    for b in range(3):  # row b of the rollback == row b decoded keep[b] steps
        ref = _layer_caches(jcache, jcfg)
        with torch.inference_mode():
            for t in range(int(keep[b])):
                model.decode_step(torch.from_numpy(steps[:, t:t + 1]), ref,
                                  torch.from_numpy(lens + t))
        for r, t in zip(ref, tcache):
            for k in t:
                _close(r[k][b].numpy(), t[k][b], 2e-5)


def test_fallback_retry_decodes_from_the_pre_step_state():
    """The engine's retry restores the recurrent state refs (a step
    replaces state and never writes into it), so a dsbp_ref re-run after
    a dsbp_fused step equals a dsbp_ref step from a copy of the pre-step
    cache, logits and every entry bit for bit; re-running without the
    restore advances the state twice."""
    jcfg, params, model = hybrid_pair("recurrentgemma-2b", window=8, quant="precise")
    pack_weights_int8(model, "precise")
    toks = torch.from_numpy(prompts(seed=6))
    step = torch.from_numpy(np.asarray([[7], [11], [13]], np.int64))
    pos = torch.from_numpy(LENS)
    fused, ref = Quant("precise", "dsbp_fused"), Quant("precise", "dsbp_ref")
    with torch.inference_mode():
        _, cache, _ = model.prefill(toks, 32, lengths=LENS)
        before = copy.deepcopy(cache)
        refs = model.state_refs(cache)
        model.decode_step(step, cache, pos, fused)
        twice = copy.deepcopy(cache)
        model.restore_states(cache, refs)
        got, cache = model.decode_step(step, cache, pos, ref)
        want, before = model.decode_step(step, before, pos, ref)
        wrong, twice = model.decode_step(step, twice, pos, ref)
    assert torch.equal(got, want)
    for a, b in zip(cache, before):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert not torch.equal(wrong, want)


# ---------------------------------------------------------------------------
# the dense engine
# ---------------------------------------------------------------------------

def test_generate_float_matches_jax_engine():
    jeng, eng = engines(packed=False, max_len=48)
    toks = prompts()
    np.testing.assert_array_equal(eng.generate(toks, 6, lengths=LENS),
                                  jeng.generate(toks, 6, lengths=LENS))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["recurrentgemma-2b", "gemma3-12b"])
def test_mesh_refuses_hybrid_kinds_naming_a13(name):
    model = TM.init(smoke_config(name), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as ei:
        Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2)), device="cpu")
    msg = str(ei.value)
    assert "tied embeddings" in msg and "attn_local" in msg
    assert ("rglru" in msg) == (name == "recurrentgemma-2b")


# ---------------------------------------------------------------------------
# the policy loop and quantization health on the new kinds
# ---------------------------------------------------------------------------

def test_policy_loop_and_health_match_jax():
    """On smoke recurrentgemma-2b, as JAX: the KV statistics (the
    attn_local entry only: a recurrent state is no KV leaf), packing under
    a mixed DSBPPolicy with a default (every container, ``rec`` ones and
    the tail's included, equal to JAX's), and QuantHealth over
    ``Model.cache_tree`` (samples skip the recurrent entries; a NaN in a
    tail layer's state is blamed on tail.0).  The port's calibration
    covers the projections a quantized forward runs (``wa`` / ``wx`` are
    weight-only, as in JAX, so absent); its report is held to JAX's on
    yi-9b in tests/test_torch_policy.py (the same code path)."""
    from repro import obs as JO
    from repro import policy as JP
    from repro.core.packed import key_entry_str
    from repro.core.quantized import PRESETS as JAX_PRESETS
    from repro.core.quantized import pack_weights as jax_pack_leaf
    from repro_torch import policy as TP
    from repro_torch.serve.engine import PROJ_NAMES
    from repro_torch.obs import QuantHealth
    from repro_torch.spec.draft import projection_keys
    from test_torch_policy import MIXED

    jcfg, params, model = hybrid_pair("recurrentgemma-2b")
    batches = JP.synthetic_calibration_batches(jcfg, 1, 2, 16, seed=0)
    rep = TP.calibrate(model, model.cfg, batches)
    assert "units/0/rec/w_in" in rep.layers and "tail/1/ffn/w2" in rep.layers
    assert not any(k.endswith(("/wa", "/wx")) for k in rep.layers)
    jkv, tkv = JP.collect_kv_stats(params, jcfg, batches), TP.collect_kv_stats(
        model, model.cfg, batches)
    assert sorted(jkv) == sorted(tkv) == ["units.2"]
    assert (tkv["units.2"].total, tkv["units.2"].bytes_per_token) == \
           (jkv["units.2"].total, jkv["units.2"].bytes_per_token)

    # packing: four presets over the calibrated paths, "precise" elsewhere;
    # JAX's pack_weights_int8 walks its tree with this rule
    keys = sorted(rep.layers)
    jpol = JP.DSBPPolicy(layers={k: JAX_PRESETS[MIXED[i % 4]] for i, k in enumerate(keys)},
                         default=JAX_PRESETS["precise"])
    tpol = TP.DSBPPolicy.from_json(jpol.to_json())
    stats = pack_weights_int8(model, tpol)
    assert stats["layers_packed"] == 8 * 6 + 7 * 2
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(key_entry_str(p) for p in path)
        cfg = jpol.config_for(key)
        if (key.rsplit("/", 1)[-1] in PROJ_NAMES and leaf.ndim >= 2 and cfg is not None
                and leaf.shape[-2] >= cfg.weight_cfg.group_size):
            want[key] = (cfg, leaf)
    tby = {}
    for key, pw in projection_keys(model):
        tby.setdefault(key, []).append(pw)
    assert sorted(want) == sorted(tby) and "tail/1/rec/wx" in tby
    for key in want:
        assert all(pw.cfg == tpol.config_for(key) for pw in tby[key]), key
    # the recurrent containers' bytes, unit 1's and the tail's
    for key, r in (("units/0/rec/wa", 1), ("units/1/rec/w_out", 0), ("tail/1/rec/wx", None)):
        cfg, leaf = want[key]
        jpw = jax_pack_leaf(leaf if r is None else leaf[r], cfg)
        pw = tby[key][0 if r is None else r]
        for f in ("ka", "kscale", "tscale", "bits"):
            np.testing.assert_array_equal(getattr(pw, f).numpy(), np.asarray(getattr(jpw, f)))

    # health: samples over the KV entry; a NaN in tail.0's state is blamed
    _, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(prompts(seed=7))}, jcfg, 32,
                             jnp.asarray(LENS))
    tcache = _layer_caches(jcache, jcfg)
    qj, qt = JO.QuantHealth(), QuantHealth()
    qj.sample_cache(jcache)
    qt.sample_cache(model.cache_tree(tcache))
    assert qt.snapshot() == qj.snapshot() and sorted(qt.entries) == ["units.2"]
    tail0 = len(model.layers) - 2
    tcache[tail0]["h"][1, 3] = float("nan")
    jcache["tail"][0]["h"] = jcache["tail"][0]["h"].at[1, 3].set(jnp.nan)
    assert qt.attribute_trip(model.cache_tree(tcache)) == qj.attribute_trip(jcache) == ["tail.0"]
