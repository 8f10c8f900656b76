"""The MoE family in the port against the JAX package, on the CPU.

Config: smoke mixtral-8x7b (2 ``attn_local`` layers, 4 experts, top-2,
dispatch groups of 64 tokens).  JAX weights are carried into the port by
``repro_torch.bridge``; inputs are numpy from a seed.

* ``moe_ffn`` against ``repro.models.moe.moe_ffn`` on the same weights and
  inputs: the routing first (the chosen experts equal, the gates within
  1e-6), then the outputs within 1e-5 of max|y| with nothing dropped and
  at ``capacity_factor=0.5``, where choices past an expert's capacity drop
  (the output then moves by more than 1e-4 from the no-drop one, the
  oracle of tests/test_models.py:114); one input spans two groups with
  pad rows.  Under ``no_drop`` a row's output does not depend on its
  batch (1e-5, tests/test_models.py:105).
* Packed expert stacks: ``pack_weights_int8`` gives one container per
  stack with a leading E axis, every child equal to JAX's and the same
  bits statistics; a ``DSBPPolicy`` default packs them too; ``moe_ffn``
  over them (weight-only, dequantized) and over a speculative draft's
  views of them within 1e-5 of JAX's.
* ``Model.forward`` with and without ``no_drop``, ragged ``prefill`` and
  decode past the window (window 8: the ring wraps), ``verify_step`` over
  a ring wrap and its rollback, within 1e-5 (2e-5 for verify, as
  tests/test_spec.py) of max|logit| of JAX's.
* ``Engine.score_continuations`` with the capacity lifted: JAX's scores,
  and a row's score independent of the rest of its batch.
* The streamed packed ``init(pack=)`` equals ``init`` followed by
  ``pack_weights_int8``, bit for bit, for the MoE, dense and hybrid
  families and under a policy.
* The refusals: an MoE model under a mesh names ROADMAP A13 (the expert
  axis), the policy loop on one names A12."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.layers import dense as jax_dense  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro.spec.draft import draft_params as jax_draft_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.layers import Quant  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig, pack_weights_int8  # noqa: E402
from repro_torch.spec.draft import draft_quant  # noqa: E402
from test_torch_hybrid import J_DECODE, J_FORWARD, J_PREFILL, J_ROLLBACK, J_VERIFY  # noqa: E402
from test_torch_hybrid import _close, _layer_caches, prompts  # noqa: E402
from test_torch_model import np_tree  # noqa: E402

ARCH = "mixtral-8x7b"
J_MOE = jax.jit(JMOE.moe_ffn, static_argnums=(2,), static_argnames=("no_drop",))
TOL = 1e-5


def moe_pair(seed=0, **kw):
    """(JAX cfg, JAX params, port model) of smoke mixtral-8x7b with the
    same float weights."""
    jcfg = jax_smoke_config(ARCH).replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    model = bridge.model_from_jax(np_tree(params), smoke_config(ARCH).replace(**kw),
                                  device="cpu")
    return jcfg, params, model


@functools.lru_cache(maxsize=None)
def packed_moe_pair(window=8):
    """(JAX cfg, packed JAX params, packed port model), built once per
    process: packed "precise", JAX's tree through its
    ``pack_weights_int8``, the port's through its own."""
    jcfg, params, model = moe_pair(window=window, quant="precise")
    params, _ = jax_pack(params, "precise")
    pack_weights_int8(model, "precise")
    return jcfg, params, model


def _moe_params(jcfg, seed):
    """A standalone MoE block's JAX params and the port module with them."""
    params = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    moe = TMOE.MoE(smoke_config(ARCH), torch.device("cpu"))
    with torch.no_grad():
        for name in ("router", "w1", "w3", "w2"):
            getattr(moe, name).copy_(torch.tensor(np.asarray(params[name])))
    return params, moe


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _groups(x, cfg):
    """x (B, S, d) as the dispatch groups and their valid rows."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.moe_group, t)
    pad = (-t) % g
    xf = np.concatenate([x.reshape(t, d), np.zeros((pad, d), np.float32)])
    return xf.reshape(-1, g, d), (np.arange(t + pad) < t).reshape(-1, g)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16), (3, 30)], ids=["one-group", "padded-groups"])
@pytest.mark.parametrize("capacity", [None, 0.5], ids=["no-drop", "capacity-0.5"])
def test_moe_ffn_routing_and_outputs_match_jax(shape, capacity):
    jcfg = jax_smoke_config(ARCH)
    if capacity is not None:
        jcfg = jcfg.replace(capacity_factor=capacity)
    cfg = smoke_config(ARCH).replace(capacity_factor=jcfg.capacity_factor)
    params, moe = _moe_params(jcfg, seed=0)
    x = _x((*shape, jcfg.d_model), seed=9)
    # the routing: the reference's own router product, softmax and top-k
    xg, valid = _groups(x, cfg)
    jprobs = jax.nn.softmax(jax_dense(params["router"], jnp.asarray(xg)).astype(jnp.float32))
    jgate, jidx = jax.lax.top_k(jprobs, jcfg.top_k)
    jgate = jgate / jnp.maximum(jnp.sum(jgate, -1, keepdims=True), 1e-9)
    no_drop = capacity is None
    cap = xg.shape[1] if no_drop else max(int(cfg.capacity_factor * cfg.top_k * xg.shape[1]
                                              / cfg.n_experts), 1)
    with torch.inference_mode():
        idx, gate, _, keep = TMOE.route(moe.router, torch.from_numpy(xg), cfg,
                                        torch.from_numpy(valid), cap)
        y = TMOE.moe_ffn(moe, torch.from_numpy(x), cfg, no_drop=no_drop)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    n_choices = int(valid.sum()) * cfg.top_k
    assert (int(keep.sum()) == n_choices) == no_drop  # capacity 0.5 drops
    _close(J_MOE(params, jnp.asarray(x), jcfg, no_drop=no_drop), y, TOL)
    if not no_drop:  # the oracle of tests/test_models.py:114
        with torch.inference_mode():
            loose = TMOE.moe_ffn(moe, torch.from_numpy(x), cfg, no_drop=True)
        assert float((y - loose).abs().max()) > 1e-4


def test_moe_ffn_no_drop_is_batch_independent():
    jcfg = jax_smoke_config(ARCH)
    _, moe = _moe_params(jcfg, seed=0)
    x = torch.from_numpy(_x((4, 16, jcfg.d_model), seed=9))
    with torch.inference_mode():
        full = TMOE.moe_ffn(moe, x, moe_cfg := smoke_config(ARCH), no_drop=True)
        half = TMOE.moe_ffn(moe, x[:2], moe_cfg, no_drop=True)
    np.testing.assert_allclose(full[:2].numpy(), half.numpy(), atol=1e-5)


def test_top_k_puts_the_lower_expert_first_on_exact_ties():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]]])
    vals, idx = TMOE._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ---------------------------------------------------------------------------
# packed experts
# ---------------------------------------------------------------------------

def _jax_moe_tree(params, layer):
    """The JAX model's MoE block of layer ``layer`` (unit slice)."""
    return jax.tree.map(lambda a: a[layer], params["units"][0]["moe"])


def test_packed_expert_stacks_equal_jax():
    jcfg, params, model = packed_moe_pair()
    n_layers = len(model.layers)
    jmoe = params["units"][0]["moe"]
    for i, layer in enumerate(model.layers):
        assert isinstance(layer.moe.router, torch.nn.Parameter)  # the router stays raw
        for name in ("w1", "w3", "w2"):
            pw, jpw = getattr(layer.moe, name), jmoe[name]
            assert isinstance(pw, PackedDSBPWeight) and pw.ka.shape[0] == jcfg.n_experts
            assert (pw.k, pw.n) == (jpw.k, jpw.n)
            for f in ("ka", "kscale", "tscale", "bits"):
                np.testing.assert_array_equal(getattr(pw, f).numpy(),
                                              np.asarray(getattr(jpw, f))[i], err_msg=f)
    # the bits statistics count every expert: a fresh pack of the same weights
    _, jraw, raw = moe_pair(window=8, quant="precise")
    _, jstats = jax_pack(jraw, "precise")
    stats = pack_weights_int8(raw, "precise")
    assert stats["layers_packed"] == 7 * n_layers and jstats["layers_packed"] == 7
    assert stats["avg_w_bits"] == jstats["avg_w_bits"]


@pytest.mark.parametrize("draft_bits", [None, 3], ids=["target", "draft-3"])
def test_packed_moe_ffn_and_its_draft_match_jax(draft_bits):
    """Packed stacks dequantize weight-only, as JAX's ``_expert_w``; a
    draft's quant reads their MSB-slice views, as JAX's draft tree (which
    views every container) does."""
    jcfg, params, model = packed_moe_pair()
    jtree = jax_draft_params(params, draft_bits) if draft_bits else params
    x = _x((3, 30, jcfg.d_model), seed=11)
    quant = None
    if draft_bits:
        quant = draft_quant(model, model.cfg.replace(quant_method="dsbp_fused"), draft_bits)
    with torch.inference_mode():
        y = TMOE.moe_ffn(model.layers[1].moe, torch.from_numpy(x), model.cfg, quant,
                         no_drop=True)
        target = TMOE.moe_ffn(model.layers[1].moe, torch.from_numpy(x), model.cfg,
                              no_drop=True)
    _close(J_MOE(_jax_moe_tree(jtree, 1), jnp.asarray(x), jcfg, no_drop=True), y, TOL)
    assert (float((y - target).abs().max()) > 1e-4) == bool(draft_bits)


def test_policy_default_packs_the_expert_stacks_as_jax():
    from repro import policy as JP
    from repro.core.quantized import PRESETS as JAX_PRESETS
    from repro_torch import policy as TP
    from repro_torch.spec.draft import projection_keys

    jcfg, params, model = moe_pair()
    jpol = JP.DSBPPolicy(layers={"units/0/attn/wq": JAX_PRESETS["efficient"],
                                 "units/0/moe/w2": JAX_PRESETS["e5m3_fixed"]},
                         default=JAX_PRESETS["precise"])
    tpol = TP.DSBPPolicy.from_json(jpol.to_json())
    jpacked, jstats = jax_pack(params, jpol)
    stats = pack_weights_int8(model, tpol)
    assert stats["avg_w_bits"] == jstats["avg_w_bits"]
    got = {}
    for key, pw in projection_keys(model):
        got.setdefault(key, []).append(pw)
    want = jpacked["units"][0]
    assert sorted(got) == sorted(f"units/0/{blk}/{n}" for blk, ns in
                                 (("attn", "wq wk wv wo"), ("moe", "w1 w3 w2"))
                                 for n in ns.split())
    for key, pws in got.items():
        _, _, blk, name = key.split("/")
        assert all(pw.cfg == tpol.config_for(key) for pw in pws), key
        for i, pw in enumerate(pws):
            np.testing.assert_array_equal(pw.ka.numpy(), np.asarray(want[blk][name].ka)[i])
            np.testing.assert_array_equal(pw.bits.numpy(),
                                          np.asarray(want[blk][name].bits)[i])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("no_drop", [False, True], ids=["capacity", "no-drop"])
def test_forward_matches_jax(no_drop):
    jcfg, params, model = moe_pair()
    toks = prompts(lens=(40, 40), seed=1)
    jl = jax.jit(JM.forward, static_argnums=(2,), static_argnames=("no_drop",))(
        params, {"tokens": jnp.asarray(toks)}, jcfg, no_drop=no_drop)
    with torch.inference_mode():
        tl = model.forward(torch.from_numpy(toks), no_drop=no_drop)
        other = model.forward(torch.from_numpy(toks), no_drop=not no_drop)
    _close(jl, tl, TOL)
    assert float((tl - other).abs().max()) > 1e-4  # the capacity drops something here


def test_ragged_prefill_and_ring_decode_match_jax():
    """Ragged prompts longer than the window (8), then decode steps at
    per-row positions (the ring wraps): logits and every ring within 1e-5
    of JAX's (tests/test_serving.py:44-46, :63)."""
    jcfg, params, model = moe_pair(window=8)
    lens = np.asarray([6, 14, 10], np.int32)
    toks = prompts(lens, seed=3)
    jl, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 16,
                              jnp.asarray(lens))
    with torch.inference_mode():
        tl, tcache, _ = model.prefill(torch.from_numpy(toks), 16, lengths=lens)
    _close(jl, tl, TOL)
    for b, t in zip(_layer_caches(jcache, jcfg), tcache):
        assert t["k"].shape[2] == 8  # a ring of window slots
        for k in t:
            _close(b[k].numpy(), t[k], TOL)
    steps = np.random.default_rng(1).integers(0, 512, (3, 3))
    for t in range(3):
        step = steps[:, t:t + 1]
        jl, jcache = J_DECODE(params, {"tokens": jnp.asarray(step)}, jcache,
                              jnp.asarray(lens + t), jcfg)
        with torch.inference_mode():
            tl, tcache = model.decode_step(torch.from_numpy(step), tcache,
                                           torch.from_numpy(lens + t))
        _close(jl, tl, TOL)


def test_verify_over_a_ring_wrap_and_rollback_match_jax():
    """A 5-token verify whose positions cross the ring boundary, then a
    ragged-keep rollback: logits and the rolled-back rings within 2e-5 of
    JAX's (tests/test_spec.py:75, :212)."""
    jcfg, params, model = moe_pair(window=8)
    lens = np.asarray([6, 14, 10], np.int32)
    toks = prompts(lens, seed=4)
    _, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 16,
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


def test_packed_forward_matches_jax():
    jcfg, params, model = packed_moe_pair()
    toks = prompts(lens=(40, 40), seed=1)
    jl = J_FORWARD(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.inference_mode():
        tl = model.forward(torch.from_numpy(toks), quant=Quant("precise", "dsbp_fused"))
    _close(jl, tl, 1e-3)  # tests/test_torch_model.py's packed tolerance


# ---------------------------------------------------------------------------
# the streamed packed init
# ---------------------------------------------------------------------------

def test_score_continuations_match_jax_and_are_batch_invariant():
    """Scoring lifts the capacity (JAX serve/engine.py:933): the packed
    port's scores within 1e-4 of max|score| of JAX's (tests/test_torch_eval.py's
    bound), and a row scored alone equals the same row among others
    within 1e-5 (the per-tensor input scale the batch shares)."""
    from repro.serve.engine import Engine as JaxEngine
    from repro.serve.engine import ServeConfig as JaxServeConfig

    jcfg, params, model = packed_moe_pair()
    jeng = JaxEngine(params, jcfg, JaxServeConfig(max_len=64, quant_method="dsbp_ref"))
    eng = Engine(model, ServeConfig(max_len=64), device="cpu")
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, jcfg.vocab_size, (n,)) for n in (29, 12, 31, 20, 25)]
    plens = [20, 4, 16, 10, 22]
    j = np.asarray(jeng.score_continuations(seqs, plens))
    t = eng.score_continuations(seqs, plens)
    assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max(), (t, j)
    solo = np.concatenate([eng.score_continuations([s], [p]) for s, p in zip(seqs, plens)])
    np.testing.assert_allclose(t, solo, rtol=0, atol=1e-5)


def _assert_models_equal(a, b):
    for (na, ta), (nb, tb) in zip(list(a.named_parameters()) + list(a.named_buffers()),
                                  list(b.named_parameters()) + list(b.named_buffers())):
        assert na == nb and ta.dtype == tb.dtype and torch.equal(ta, tb), (na, nb)
    pa = [(n, m.k, m.n, m.cfg) for n, m in a.named_modules() if isinstance(m, PackedDSBPWeight)]
    pb = [(n, m.k, m.n, m.cfg) for n, m in b.named_modules() if isinstance(m, PackedDSBPWeight)]
    assert pa == pb and pa


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b", "recurrentgemma-2b", "llama-7b-paper"])
def test_streamed_packed_init_equals_init_then_pack(arch):
    cfg = smoke_config(arch)
    drawn = TM.init(cfg, seed=3, device="cpu")
    stats = pack_weights_int8(drawn, "precise")
    streamed = TM.init(cfg, seed=3, device="cpu", pack="precise")
    _assert_models_equal(drawn, streamed)
    assert sum(isinstance(m, PackedDSBPWeight) for m in streamed.modules()) == \
        stats["layers_packed"]
    assert not any(p.is_meta for p in streamed.parameters())


def test_streamed_init_under_a_policy_equals_init_then_pack():
    from repro_torch.core.quantized import PRESETS
    from repro_torch.policy import DSBPPolicy

    pol = DSBPPolicy(layers={"units/0/moe/w1": PRESETS["efficient"],
                             "units/0/attn/wo": PRESETS["e5m3_fixed"]})
    drawn = TM.init(smoke_config(ARCH), seed=1, device="cpu")
    pack_weights_int8(drawn, pol)
    _assert_models_equal(drawn, TM.init(smoke_config(ARCH), seed=1, device="cpu", pack=pol))


def test_init_draws_expert_stacks_at_their_fan_in():
    """w1 / w3 / router at d**-0.5, w2 at ff**-0.5 (JAX ``init_moe``): the
    fan-in of an (E, d_in, d_out) stack is d_in, not E."""
    cfg = smoke_config(ARCH).replace(n_layers=1)
    moe = TM.init(cfg, seed=0, device="cpu").layers[0].moe
    for name, fan_in in (("router", cfg.d_model), ("w1", cfg.d_model),
                         ("w3", cfg.d_model), ("w2", cfg.d_ff)):
        std = float(getattr(moe, name).std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_moe_under_a_mesh_names_roadmap_a13():
    model = TM.init(smoke_config(ARCH), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as ei:
        Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2)), device="cpu")
    assert "MoE" in str(ei.value) and "expert axis" in str(ei.value)


@pytest.mark.parametrize("step", ["calibrate", "autotune"])
def test_policy_loop_on_moe_names_roadmap_a12(step):
    from repro_torch import policy as TP

    cfg = smoke_config(ARCH)
    model = TM.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        if step == "calibrate":
            TP.calibrate(model, cfg, TP.synthetic_calibration_batches(cfg, 1, 2, 16))
        else:
            TP.autotune(model, cfg, TP.CalibrationReport(layers={}), [])


def test_serve_launcher_draws_mixtral_packed_layer_by_layer(monkeypatch, capsys):
    import sys

    from repro_torch.launch import serve as launcher

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke", "--packed",
                                      "--device", "cpu", "--new-tokens", "3"])
    launcher.main()
    out = capsys.readouterr().out
    assert "drawn and packed one layer at a time" in out and "generated (4, 3)" in out
