"""The port's self-speculative decoding against the JAX package, on the CPU.

The MSB-slice draft view (``draft_view``), its per-layer widths and the
narrow KV view are bit-equal to JAX's; a draft container gives one result
through every method; the dense ``verify_step`` is within 2e-5 of JAX's
logits (float weights: the frameworks sum in other orders); the in-place
``rollback_cache`` leaves every slot bit-equal to JAX's select over the
same old and new caches; ``greedy_accept`` and ``acceptance_summary`` are
JAX's; one speculation round (dense and paged) gives JAX's targets and
keeps and leaves JAX's cache; and ``Engine.serve(spec_k=3)``, dense float,
dense kv8 with ``kv_draft_bits``, paged float and paged kv8, emits the
port's own non-speculative stream and JAX's speculative stream with JAX's
accepted-length histogram.  Packed weights run the port's ``dsbp_fused``
(plain) beside JAX's ``dsbp_ref``, which the JAX suite holds bit-exact;
the prompts of the rounds and serves come from ``PROMPT_SEED`` (3), which
``tests/test_torch_engine.py`` pins for its parity tests (a last-bit
difference upstream can flip a near tie).  Plus EOS truncation mid-round, the
configuration errors with JAX's messages, the mesh refusal and the
launcher's flags."""
import copy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kvq as JK  # noqa: E402
from repro.core.packed import PackedDSBPWeight as JaxPacked  # noqa: E402
from repro.core.packed import draft_view as jax_draft_view  # noqa: E402
from repro.core.packed import key_entry_str  # noqa: E402
from repro.core.quantized import PRESETS as JAX_PRESETS  # noqa: E402
from repro.core.quantized import pack_weights as jax_pack_weights  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro.spec import decode as JSD  # noqa: E402
from repro.spec import draft_params as jax_draft_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kvq as TK  # noqa: E402
from repro_torch.core import quantized as Q  # noqa: E402
from repro_torch.core.packed import draft_view, get_quant_method  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.spec import (acceptance_summary, build_spec_round,  # noqa: E402
                              build_spec_round_paged, draft_params, greedy_accept,
                              resolve_draft_bits)
from repro_torch.spec.draft import projection_keys  # noqa: E402
from test_torch_engine import PROMPT_SEED  # noqa: E402
from test_torch_model import LENS, VARIANTS, _prompts, make_pair  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402

SPEC_K = 3
N_NEW = 6
# verify logits against JAX's (float weights): the frameworks sum the
# matmuls and the softmax in other orders; JAX's own verify-vs-decode
# tolerance (tests/test_spec.py)
VERIFY_REL = 2e-5


def _pw(seed=0, k=128, n=64):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jpw = jax_pack_weights(jnp.asarray(w), JAX_PRESETS["precise"])
    return jpw, bridge.packed_from_jax(**{k_: np.asarray(getattr(jpw, k_)) for k_ in
                                          ("ka", "kscale", "tscale", "bits")},
                                       k=jpw.k, n=jpw.n, group_size=jpw.group_size,
                                       cfg="precise")


# ---------------------------------------------------------------------------
# the draft view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", range(1, 8))
def test_draft_view_bit_equal_to_jax(d):
    jpw, tpw = _pw()
    jv, tv = jax_draft_view(jpw, d), draft_view(tpw, d)
    np.testing.assert_array_equal(np.asarray(jv.ka), tv.ka.numpy())
    np.testing.assert_array_equal(np.asarray(jv.kscale).view(np.int32),
                                  tv.kscale.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jv.bits), tv.bits.numpy())
    assert (tv.k, tv.n, tv.group_size, tv.cfg) == (tpw.k, tpw.n, tpw.group_size, tpw.cfg)
    assert tv.tscale is tpw.tscale and tv.ka is not tpw.ka
    if d == 7:  # every weight width of the preset: the container's numerics
        assert torch.equal(tv.ka, tpw.ka) and torch.equal(tv.kscale, tpw.kscale)


def test_draft_view_leaves_the_container_and_checks_width():
    _, tpw = _pw()
    before = {k: getattr(tpw, k).clone() for k in ("ka", "kscale", "tscale", "bits")}
    draft_view(tpw, 2)
    for k, v in before.items():
        assert torch.equal(getattr(tpw, k), v), k
    for bad in (0, 8):
        with pytest.raises(ValueError, match=r"draft_bits must be in \[1, 7\]"):
            draft_view(tpw, bad)


def test_draft_view_through_every_method():
    """A draft container is a plain v2 container: the reference integer
    path, the two-kernel method and the fused method (plain versions)
    give one result, as ``tests/test_spec.py:276`` checks in JAX, and it
    differs from the full-width result."""
    _, tpw = _pw(seed=1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 128)).astype(np.float32))
    dv = draft_view(tpw, 4)
    cfg = Q.PRESETS["precise"]
    y_ref = get_quant_method("dsbp_ref").apply(dv, x, cfg)
    y_two = TO.dsbp_matmul_packed(x, dv)
    y_fused = TO.dsbp_matmul_fused(x, dv)
    assert torch.equal(y_ref, y_two) and torch.equal(y_ref, y_fused)
    assert not torch.equal(y_ref, TO.dsbp_matmul_fused(x, tpw))


def _jax_paths(tree):
    is_pw = lambda x: isinstance(x, JaxPacked)  # noqa: E731
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_pw)[0]
    return {"/".join(key_entry_str(p) for p in path): leaf
            for path, leaf in flat if is_pw(leaf)}


@pytest.mark.parametrize("bits", [4, {"units/0/attn/wq": 7, "units/0/ffn/w2": 1,
                                      "default": 2}], ids=["uniform", "per-layer"])
def test_draft_params_resolve_jax_keys(bits):
    """Every projection of the port resolves the JAX stacked-tree key of
    its layer (all repeats of a pattern position share it), and its draft
    view equals the matching slice of JAX's ``draft_params`` bit for bit."""
    jcfg, params, model = make_pair("gqa", packed=True)
    jviews = _jax_paths(jax_draft_params(params, bits))
    widths = draft_params(model, bits)
    keys = dict(projection_keys(model))
    assert set(keys) == set(jviews) and len(widths) == 7 * jcfg.n_layers
    p = len(jcfg.pattern)
    for i, layer in enumerate(model.layers):
        for sub, names in (("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("w1", "w3", "w2"))):
            for name in names:
                pw = getattr(getattr(layer, sub), name)
                key = f"units/{i % p}/{sub}/{name}"
                assert widths[pw] == resolve_draft_bits(bits, key)
                jv, tv = jviews[key], draft_view(pw, widths[pw])
                r = i // p
                np.testing.assert_array_equal(np.asarray(jv.ka[r]), tv.ka.numpy())
                np.testing.assert_array_equal(np.asarray(jv.kscale[r]), tv.kscale.numpy())
                np.testing.assert_array_equal(np.asarray(jv.bits[r]), tv.bits.numpy())
    with pytest.raises(ValueError, match="must be in"):
        resolve_draft_bits({"default": 9}, "units/0/attn/wq")


# ---------------------------------------------------------------------------
# the narrow KV view
# ---------------------------------------------------------------------------

def _jax_kv8_cache(variant="gqa", max_len=24):
    jcfg, params, model = make_pair(variant, packed=False)
    toks = _prompts(jcfg.vocab_size)
    _, jcache, _ = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=max_len,
                              lengths=jnp.asarray(LENS), kv="kv8")
    return jcfg, params, model, jcache


def _np_cache(jcache):
    def leaf(x):
        if isinstance(x, JK.PackedKVBlock):
            return {"qm": np.asarray(x.qm), "scale": np.asarray(x.scale), "bits": x.bits,
                    "fmt": x.fmt}
        return np.asarray(x)
    return {part: [{n: leaf(e[n]) for n in ("k", "v")} for e in jcache[part]]
            for part in ("units", "tail")}


def _to_jax_cache(tcache, cfg):
    """The port's per-layer cache as a JAX tree (units stacked over R)."""
    def stack(leaves):
        if isinstance(leaves[0], TK.PackedKVBlock):
            return JK.PackedKVBlock(jnp.asarray(np.stack([x.qm.numpy() for x in leaves])),
                                    jnp.asarray(np.stack([x.scale.numpy() for x in leaves])),
                                    bits=leaves[0].bits, fmt=leaves[0].fmt)
        return jnp.asarray(np.stack([x.numpy() for x in leaves]))
    p = len(cfg.pattern)
    return {"units": [{n: stack([tcache[r * p + i][n] for r in range(cfg.n_units)])
                       for n in ("k", "v")} for i in range(p)], "tail": []}


def _leaf_arrays(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("db", [2, 6, 8])
def test_kv_narrow_view_bit_equal_to_jax(db):
    jcfg, _, _, jcache = _jax_kv8_cache()
    tcache = bridge.cache_from_jax(_np_cache(jcache), jcfg, device="cpu")
    tview = TK.kv_narrow_view(tcache, db)
    jview = JK.kv_narrow_view(jcache, db)
    for a, b in zip(_leaf_arrays(jview), _leaf_arrays(_to_jax_cache(tview, jcfg))):
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                      b.view(np.int32) if b.dtype == np.float32 else b)
    for entry, view in zip(tcache, tview):  # the cache itself is untouched
        assert view["k"].bits == db and entry["k"].bits == 8
        assert (view["k"] is entry["k"]) == (db == 8)
    floats = [{"k": torch.zeros(1), "v": torch.zeros(1)}]
    assert TK.kv_narrow_view(floats, 4)[0]["k"] is floats[0]["k"]
    with pytest.raises(ValueError, match=r"kv draft bits must be in \[2, 8\]"):
        TK.kv_narrow_view(tcache, 1)


# ---------------------------------------------------------------------------
# verify and rollback (dense)
# ---------------------------------------------------------------------------

def _verify_case(variant, kv, seed=3):
    jcfg, params, model = make_pair(variant, packed=False)
    toks = _prompts(jcfg.vocab_size)
    _, jcache, _ = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=24,
                              lengths=jnp.asarray(LENS), kv=kv)
    tcache = bridge.cache_from_jax(_np_cache(jcache), jcfg, device="cpu")
    steps = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (len(LENS), 4))
    return jcfg, params, model, jcache, tcache, steps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_verify_step_matches_jax(variant, kv):
    """Logits within VERIFY_REL of JAX's verify_step, from the same cache,
    and within that of the port's own 4 chained decode steps."""
    jcfg, params, model, jcache, tcache, steps = _verify_case(variant, kv)
    pos = torch.from_numpy(LENS.copy())
    jl, _ = JM.verify_step(params, {"tokens": jnp.asarray(steps)}, jcache,
                           jnp.asarray(LENS), jcfg)
    seq = copy.deepcopy(tcache)
    with torch.inference_mode():
        tl, tcache = model.verify_step(torch.from_numpy(steps), tcache, pos)
        dl = [model.decode_step(torch.from_numpy(steps[:, t:t + 1]), seq, pos + t)[0]
              for t in range(steps.shape[1])]
    jl = np.asarray(jl)
    top = np.abs(jl).max()
    assert np.abs(jl - tl.numpy()).max() <= VERIFY_REL * top
    assert np.abs(torch.cat(dl, dim=1).numpy() - tl.numpy()).max() <= VERIFY_REL * top


@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_rollback_cache_ragged_keep_bit_equal_to_jax(kv):
    """keep [1, 3, 2] after a 4-token verify: every slot equals JAX's
    ``rollback_cache`` over the same old and new caches bit for bit, and
    (``tests/test_spec.py:137``) the accepted slots hold the verify's
    writes, the rejected ones the pre-verify bytes."""
    jcfg, params, model, jcache, tcache, steps = _verify_case("gqa", kv)
    T = steps.shape[1]
    old = _to_jax_cache(tcache, jcfg)
    with torch.inference_mode():
        _, tcache, rb = model.verify_step(torch.from_numpy(steps), tcache,
                                          torch.from_numpy(LENS), collect_rollback=True)
    new = _to_jax_cache(tcache, jcfg)
    keep = np.asarray([1, 3, 2], np.int32)
    model.rollback_cache(tcache, rb, torch.from_numpy(keep), torch.from_numpy(LENS), T)
    want = JM.rollback_cache(old, new, {"units": [{}], "tail": []}, jnp.asarray(keep),
                             jnp.asarray(LENS), jcfg, T)
    for a, b in zip(_leaf_arrays(want), _leaf_arrays(_to_jax_cache(tcache, jcfg))):
        np.testing.assert_array_equal(a, b)
    s = 24
    for o, n, g in zip(_leaf_arrays(old), _leaf_arrays(new), _leaf_arrays(want)):
        for i, p in enumerate(LENS):
            for j in range(T):
                src = n if j < keep[i] else o
                r = (int(p) + j) % s
                np.testing.assert_array_equal(g[:, i, :, r], src[:, i, :, r])


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------

def test_greedy_accept_and_summary_match_jax():
    draft = np.asarray([[7, 8, 9], [7, 8, 9], [1, 8, 9], [7, 8, 2]])
    target = np.asarray([[7, 8, 9, 4], [7, 8, 1, 4], [7, 8, 9, 4], [7, 8, 9, 4]])
    want = np.asarray(JSD.greedy_accept(jnp.asarray(draft), jnp.asarray(target)))
    got = greedy_accept(torch.from_numpy(draft), torch.from_numpy(target)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [4, 3, 1, 3])
    hist = np.asarray([0, 5, 2, 0, 3])
    for kw in ({}, {"slot_accepted": [4, 9], "slot_rounds": [2, 0]}):
        assert acceptance_summary(hist, 3, **kw) == JSD.acceptance_summary(hist, 3, **kw)


# ---------------------------------------------------------------------------
# one round
# ---------------------------------------------------------------------------

def _packed_models(variant="gqa"):
    jcfg, params, model = make_pair(variant, packed=True)
    return jcfg, params, model, model.cfg


def _assert_caches_equal(jtree, ttree, rel):
    """Integer leaves exactly, float leaves within ``rel`` of max|value|."""
    for a, b in zip(_leaf_arrays(jtree), _leaf_arrays(ttree)):
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("kv,kv_draft_bits", [(None, None), ("kv8", 6)],
                         ids=["float", "kv8-narrow"])
def test_spec_round_matches_jax(kv, kv_draft_bits):
    """One dense round from a JAX prefill: JAX's targets and keeps, and the
    cache after the round equal to JAX's (integers exactly)."""
    jcfg, params, model, tcfg = _packed_models()
    toks = _prompts(jcfg.vocab_size, seed=PROMPT_SEED)
    jl, jcache, _ = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=24,
                               lengths=jnp.asarray(LENS), kv=kv)
    tcache = bridge.cache_from_jax(_np_cache(jcache), jcfg, device="cpu")
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int64)
    jround = JSD.build_spec_round(jcfg, SPEC_K, 4, "dsbp_ref", kv_draft_bits=kv_draft_bits)
    jt, jk, jcache = jround(params, jcache, jnp.asarray(tok), jnp.asarray(LENS))
    tround = build_spec_round(tcfg.replace(quant_method="dsbp_fused"), SPEC_K, 4, "dsbp_ref",
                              kv_draft_bits=kv_draft_bits)
    with torch.inference_mode():
        tt, tk, tcache = tround(model, tcache, torch.from_numpy(tok), torch.from_numpy(LENS))
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    assert 1 <= int(tk.min()) and int(tk.max()) <= SPEC_K + 1
    _assert_caches_equal(jcache, _to_jax_cache(tcache, jcfg), 1e-3)


@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_spec_round_paged_matches_jax(kv):
    """One paged round (lane 1 idle, live 0): JAX's targets and keeps, the
    pool after it equal to JAX's (integers exactly), nothing written
    through the idle lane's table."""
    jcfg, params, model, tcfg = _packed_models()
    bs, nb, max_len = 4, 20, 24
    toks = _prompts(jcfg.vocab_size, seed=PROMPT_SEED)
    table = (1 + np.arange(len(LENS) * max_len // bs) % (nb - 1)).reshape(len(LENS), -1)
    table = table.astype(np.int32)
    jpool = JM.init_paged_cache(jcfg, len(LENS), nb, bs, kv=kv)
    jl, jpool, _ = JM.prefill_paged(params, {"tokens": jnp.asarray(toks)}, jpool,
                                    jnp.asarray(table), jcfg, max_len, jnp.asarray(LENS),
                                    jnp.zeros(len(LENS), jnp.int32))
    tpool = bridge.cache_from_jax(_np_cache(jpool), jcfg, device="cpu")
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int64)
    live = np.asarray([1, 0, 1], np.int32)
    jround = JSD.build_spec_round_paged(jcfg, SPEC_K, 4, "dsbp_ref", max_len)
    jt, jk, jpool = jround(params, jpool, jnp.asarray(table), jnp.asarray(tok),
                           jnp.asarray(LENS), jnp.asarray(live))
    tround = build_spec_round_paged(tcfg.replace(quant_method="dsbp_fused"), SPEC_K, 4,
                                    "dsbp_ref", max_len)
    before = copy.deepcopy(tpool)
    with torch.inference_mode():
        tt, tk, tpool = tround(model, tpool, table, torch.from_numpy(tok), LENS, live)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    assert int(tk[1]) == 0
    for i in (0, 2):  # the idle lane's targets are never read
        np.testing.assert_array_equal(np.asarray(jt)[i], tt.numpy()[i])
    _assert_caches_equal(jpool, _to_jax_cache(tpool, jcfg), 1e-3)
    for b, a in zip(_leaf_arrays(_to_jax_cache(before, jcfg)),
                    _leaf_arrays(_to_jax_cache(tpool, jcfg))):
        np.testing.assert_array_equal(a[:, table[1]], b[:, table[1]])


# ---------------------------------------------------------------------------
# speculative serving
# ---------------------------------------------------------------------------

def _spec_engines(variant="gqa", **scfg):
    """JAX's speculative engine and the port's speculative and
    non-speculative engines over the same packed "precise" weights."""
    jcfg, params, model = make_pair(variant, packed=False)
    jcfg = jcfg.replace(quant="precise")
    model.cfg = model.cfg.replace(quant="precise")
    jeng = JaxEngine(params, jcfg, JaxServeConfig(quant_method="dsbp_ref", spec_k=SPEC_K,
                                                  **scfg))
    spec = Engine(model, ServeConfig(spec_k=SPEC_K, **scfg), device="cpu")
    scfg.pop("kv_draft_bits", None)
    base = Engine(model, ServeConfig(**scfg), device="cpu")
    return jeng, spec, base


def _requests(cls, lens, budgets=None, seed=PROMPT_SEED):
    rng = np.random.default_rng(seed)
    budgets = budgets or [N_NEW] * len(lens)
    return [cls(uid=i, tokens=rng.integers(0, 512, n), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, budgets))]


SERVE_CASES = {
    "dense-float": dict(max_len=32, batch_size=2),
    "dense-kv8-narrow": dict(max_len=32, batch_size=2, kv_quant="kv8", kv_draft_bits=6),
    "paged-float": dict(max_len=32, batch_size=2, paged=True, kv_block_size=4,
                        max_active=3, prefill_bucket=8, chunk_prefill_tokens=12),
    "paged-kv8": dict(max_len=32, batch_size=2, paged=True, kv_block_size=4,
                      max_active=3, prefill_bucket=8, chunk_prefill_tokens=12,
                      kv_quant="kv8"),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_spec_serve_matches_jax_and_plain_decoding(case):
    """5 ragged requests (one long enough to prefill in chunks on the paged
    engines): the speculative stream equals the port's non-speculative
    stream and JAX's speculative stream, with JAX's accepted-length
    histogram; the engine's containers stay the same objects and bytes."""
    jeng, spec, base = _spec_engines(**SERVE_CASES[case])
    lens = [5, 11, 8, 3, 19]
    containers = [(pw, pw.ka.data_ptr(), pw.ka.clone())
                  for _, pw in projection_keys(spec.model)]
    jout = jeng.serve(_requests(JaxRequest, lens))
    out = spec.serve(_requests(Request, lens))
    plain = base.serve(_requests(Request, lens))
    reqs = _requests(Request, lens)
    _streams_match(jout, out, jeng, reqs)
    for uid, t in plain.items():
        np.testing.assert_array_equal(out[uid], t, err_msg=str(uid))
    st, jst = spec.last_stats, jeng.last_stats
    assert st["accepted_hist"] == jst["accepted_hist"]
    assert st["mean_accepted"] == jst["mean_accepted"]
    for key in ("spec_rounds", "draft_tokens", "decode_tokens", "decode_steps"):
        assert st[key] == jst[key], key
    if "slot_mean_accepted" in jst:
        assert st["slot_mean_accepted"] == jst["slot_mean_accepted"]
    assert st["decode_tokens"] == base.last_stats["decode_tokens"]
    assert spec.spec_report == jeng.spec_report
    assert spec.spec_report["extra_weight_nbytes"] == 0
    for (_, pw), (same, ptr, ka) in zip(projection_keys(spec.model), containers):
        assert pw is same and pw.ka.data_ptr() == ptr and torch.equal(pw.ka, ka)
    if spec.scfg.paged:
        assert st["blocks_in_use_at_exit"] == 0 and st["chunked_requests"] == 1


def test_spec_serve_eos_truncates_mid_round():
    """Accepted tokens past an EOS are dropped and the slot frees at the
    EOS, as the non-speculative path stops (``tests/test_spec.py:379``)."""
    jcfg, params, model = make_pair("gqa", packed=False)
    prompts = [np.random.default_rng(0).integers(0, jcfg.vocab_size, n) for n in (5, 11, 8)]
    free_run = Engine(model, ServeConfig(max_len=32, batch_size=2),
                      device="cpu").serve(prompts, max_new_tokens=6)
    eos = int(free_run[0][2])
    base = Engine(model, ServeConfig(max_len=32, batch_size=2, eos_id=eos),
                  device="cpu").serve(prompts, max_new_tokens=6)
    spec = Engine(model, ServeConfig(max_len=32, batch_size=2, eos_id=eos, spec_k=SPEC_K,
                                     spec_draft_bits=7), device="cpu")
    out = spec.serve(prompts, max_new_tokens=6)
    jout = JaxEngine(params, jcfg, JaxServeConfig(max_len=32, batch_size=2, eos_id=eos,
                                                  spec_k=SPEC_K, spec_draft_bits=7)
                     ).serve(prompts, max_new_tokens=6)
    for uid in base:
        np.testing.assert_array_equal(out[uid], base[uid])
        np.testing.assert_array_equal(out[uid], jout[uid])
    assert out[0].tolist() == free_run[0][:3].tolist()  # stopped AT the EOS
    assert spec.last_stats["accepted_hist"][0] == 0


def test_spec_serve_budgets_and_headroom():
    jcfg, params, model = make_pair("gqa", packed=False)
    rng = np.random.default_rng(2)
    p = [rng.integers(0, jcfg.vocab_size, n) for n in (6, 9)]
    eng = Engine(model, ServeConfig(max_len=32, batch_size=2, spec_k=2), device="cpu")
    out = eng.serve([Request(uid="a", tokens=p[0], max_new_tokens=2),
                     Request(uid="b", tokens=p[1], max_new_tokens=5)])
    assert len(out["a"]) == 2 and len(out["b"]) == 5
    jeng = JaxEngine(params, jcfg, JaxServeConfig(max_len=32, batch_size=2, spec_k=2))
    with pytest.raises(ValueError) as jerr:  # budget + spec headroom overflows the cache
        jeng.serve([JaxRequest(uid="x", tokens=p[0], max_new_tokens=25)])
    with pytest.raises(ValueError) as terr:
        eng.serve([Request(uid="x", tokens=p[0], max_new_tokens=25)])
    assert str(terr.value) == str(jerr.value) and "spec_k 2" in str(terr.value)


@pytest.mark.parametrize("scfg", [
    dict(spec_k=2, temperature=1.0),
    dict(kv_draft_bits=6),
    dict(kv_quant="kv8", kv_draft_bits=1),
    dict(kv_quant="kv8", kv_draft_bits=9),
], ids=["temperature", "kv-draft-without-kv", "kv-draft-1", "kv-draft-9"])
def test_spec_config_errors_match_jax(scfg):
    jcfg, params, model = make_pair("gqa", packed=False)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(params, jcfg, JaxServeConfig(max_len=32, **scfg))
    with pytest.raises(ValueError) as terr:
        Engine(model, ServeConfig(max_len=32, **scfg), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_spec_round_refuses_guard_and_zero_k():
    """spec_k 0 is refused, with the guard or without; guard=True (the
    numeric guard's per-lane finiteness mask, refused until the guard was
    ported) builds a round (its mask is held against JAX's in
    tests/test_torch_robustness.py)."""
    cfg = make_pair("gqa", packed=False)[2].cfg
    for build in (build_spec_round, build_spec_round_paged):
        assert callable(build(cfg, 2, guard=True))
        for guard in (False, True):
            with pytest.raises(ValueError, match="spec_k must be >= 1"):
                build(cfg, 0, guard=guard)


def test_spec_under_a_mesh_is_refused():
    model = make_pair("gqa", packed=False)[2]
    with pytest.raises(NotImplementedError, match=r"ROADMAP A13\): speculative rounds"):
        Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2), spec_k=2), device="cpu")


@pytest.mark.parametrize("extra", [[], ["--paged", "--kv-block-size", "4"],
                                   ["--kv-quant", "kv8", "--kv-draft-bits", "6"]],
                         ids=["dense", "paged", "kv8-narrow"])
def test_launcher_spec_flags(monkeypatch, capsys, extra):
    argv = ["serve", "--smoke", "--packed", "--device", "cpu", "--ragged", "--spec-k", "3",
            "--spec-draft-method", "dsbp_fused", "--new-tokens", "4", "--prompt-len", "7",
            "--batch", "2", *extra]
    monkeypatch.setattr(sys, "argv", argv)
    launcher.main()
    out = capsys.readouterr().out
    assert "speculative: spec_k 3, draft bits 4, draft method dsbp_fused" in out
    assert "accepted_hist" in out and "served 4 ragged requests" in out
