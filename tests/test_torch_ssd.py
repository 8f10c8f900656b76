"""The Mamba-2 SSD family in the port against the JAX package, on the CPU:
the block (``repro_torch.models.ssd``) and the model.

Config: smoke mamba2-370m (2 ssd layers, d_model 128, d_inner 256, 8 SSD
heads of 32, state 32, chunk 128, tied embeddings, vocab 512) and a
``vocab_size=500`` variant, whose head pads to 512.  JAX weights are
carried into the port by ``repro_torch.bridge``; inputs are numpy from a
seed.

* ``ssd_chunked`` against JAX's at chunk 8 / 16 / S, with and without
  ``h0``, within 1e-5 of max|ref|, and against the port's ``ssd_naive``
  (2e-5); a sequence split in two with the state carried equals the whole
  (1e-5, JAX tests/test_models.py:51-75); a chunk that does not divide the
  width raises ``ValueError`` where JAX asserts.
* ``ssd_block`` with ragged ``lengths`` and a carried state,
  ``ssd_decode_step`` and ``ssd_verify`` within 1e-5 of JAX's; the
  verify's per-step states bit-equal to chained decode steps.
* ``Model.forward``, ragged ``prefill`` and ``decode_step`` logits and
  states within 1e-5 of JAX's (both vocabularies); the padded head columns
  are -1e30 as JAX's; ``verify_step`` + ``rollback_cache`` within 2e-5 of
  JAX's and equal to a verify of the kept tokens bit for bit.
* ``init`` draws JAX's shapes and ranges, ``init(pack=)`` = init + pack.
* Calibration against JAX's report; the mesh refuses SSD naming ROADMAP
  A13 and the SSD state.

Where a test holds the port to itself bit for bit across passes of
different widths (verify vs decode, rollback vs a shorter verify), the
projections run a row-wise product (``_rowwise_dense``): a library matmul
of T rows may round a row otherwise than one of fewer rows.  Every state
op (conv, gates, the recurrence) is elementwise per row and needs no such
help."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssd as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssd as TS  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig, pack_weights_int8  # noqa: E402
from test_torch_model import np_tree  # noqa: E402

J_FORWARD = jax.jit(JM.forward, static_argnums=(2,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JM.decode_step, static_argnums=(4,))
J_VERIFY = jax.jit(JM.verify_step, static_argnums=(4, 5))
J_ROLLBACK = jax.jit(JM.rollback_cache, static_argnums=(5, 6))

ARCH = "mamba2-370m"
VOCABS = {"vocab512": {}, "vocab500": {"vocab_size": 500}}
LENS = np.asarray([40, 17, 33], np.int32)


@functools.lru_cache(maxsize=None)
def ssd_pair(variant="vocab512", seed=0):
    """(JAX cfg, JAX params, port model) with the same float weights,
    built once per variant."""
    kw = VOCABS[variant]
    jcfg = jax_smoke_config(ARCH).replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    model = bridge.model_from_jax(np_tree(params), smoke_config(ARCH).replace(**kw),
                                  device="cpu")
    return jcfg, params, model


def prompts(lens=LENS, seed=5, vocab=500):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), int(max(lens))), np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, vocab, n)
    return toks


def _close(j, t, rel):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert np.abs(j - t).max() <= rel * max(np.abs(j).max(), 1e-30), np.abs(j - t).max()


def _layer_caches(jcache, cfg):
    tree = {part: [{n: np.asarray(v) for n, v in e.items()} for e in jcache[part]]
            for part in ("units", "tail")}
    return bridge.cache_from_jax(tree, cfg, device="cpu")


def _rowwise_dense(w, x, quant=None, name=None):
    """x @ w with each output row's sum in an order that does not depend
    on how many rows the call has."""
    return (x[..., :, None] * w).sum(dim=-2)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed=0, b=2, s=32, h=4, p=8, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    a = (-rng.uniform(0.5, 2.0, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_chunked_matches_jax_and_naive(chunk, with_h0):
    """y and h_last within 1e-5 of max|ref| of JAX's chunked scan (chunk
    32 = the whole sequence), and within 2e-5 of the port's per-step
    oracle."""
    x, dt, a, bm, cm, h0 = _scan_inputs(seed=chunk)
    h0 = h0 if with_h0 else None
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                            None if h0 is None else jnp.asarray(h0))
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = TS.ssd_chunked(*t, chunk, th0)
    _close(jy, y, 1e-5)
    _close(jh, h, 1e-5)
    ny, nh = TS.ssd_naive(*t, th0)
    _close(ny.numpy(), y, 2e-5)
    _close(nh.numpy(), h, 2e-5)


def test_ssd_split_sequence_carries_state():
    """Two halves with the state carried == the whole sequence (JAX
    tests/test_models.py::test_ssd_state_carry), within 1e-5."""
    x, dt, a, bm, cm, _ = _scan_inputs(seed=3, b=1, s=64, h=2, p=8, n=4)
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    y_full, h_full = TS.ssd_chunked(*t, 16)
    first = [v[:, :32] if v.ndim > 1 else v for v in t]
    second = [v[:, 32:] if v.ndim > 1 else v for v in t]
    _, h1 = TS.ssd_chunked(*first, 16)
    y2, h2 = TS.ssd_chunked(*second, 16, h0=h1)
    _close(y_full[:, 32:].numpy(), y2, 1e-5)
    _close(h_full.numpy(), h2, 1e-5)


def test_chunk_width_refused_with_value_error():
    """A chunk that does not divide the width: JAX asserts, the port raises
    ``ValueError`` (and pads nothing)."""
    x, dt, a, bm, cm, _ = _scan_inputs(s=24)
    with pytest.raises(AssertionError):
        JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), 16)
    with pytest.raises(ValueError, match="does not divide"):
        TS.ssd_chunked(*[torch.from_numpy(v) for v in (x, dt, a, bm, cm)], 16)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def block_pair(seed=1):
    """(JAX cfg, JAX block params, port SSD module) with the same weights."""
    jcfg = jax_smoke_config(ARCH)
    params = JS.init_ssd_block(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    cfg = smoke_config(ARCH)
    mod = TS.SSD(cfg, "cpu")
    with torch.no_grad():
        for name, v in params.items():
            getattr(mod, name).copy_(torch.from_numpy(np.asarray(v)))
    return jcfg, params, cfg, mod


def _state(cfg, seed, b=3):
    rng = np.random.default_rng(seed)
    st = JS.init_ssd_state(b, cfg, jnp.float32)
    return {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in st.items()}


def test_ssd_block_decode_and_verify_match_jax():
    """Sequence mode with ragged lengths from a carried state, a decode
    step and a 5-token verify (outputs, states and per-step states) within
    1e-5 of max|ref| of JAX's."""
    jcfg, params, cfg, mod = block_pair()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 32, cfg.d_model)).astype(np.float32)
    lens = np.asarray([32, 9, 20], np.int32)
    st = _state(cfg, seed=3)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, js = jax.jit(JS.ssd_block, static_argnums=(2,), static_argnames=("chunk",))(
        params, jnp.asarray(x), jcfg, state=jst, chunk=jcfg.ssd_chunk, lengths=jnp.asarray(lens))
    with torch.inference_mode():
        ty, ts = TS.ssd_block(mod, torch.from_numpy(x), cfg, state=tst, chunk=cfg.ssd_chunk,
                              lengths=lens)
    for b, n in enumerate(lens):  # pad rows' outputs are not compared
        _close(np.asarray(jy)[b, :n], ty[b, :n], 1e-5)
    for k in ("h", "conv"):
        _close(js[k], ts[k], 1e-5)
    step = x[:, :1]
    jy, jd = jax.jit(JS.ssd_decode_step, static_argnums=(3,))(params, jnp.asarray(step), jst,
                                                               jcfg)
    with torch.inference_mode():
        ty, td = TS.ssd_decode_step(mod, torch.from_numpy(step), tst, cfg)
    _close(jy, ty, 1e-5)
    for k in ("h", "conv"):
        _close(jd[k], td[k], 1e-5)
    jy, jv, jsteps = jax.jit(JS.ssd_verify, static_argnums=(2,))(
        params, jnp.asarray(x[:, :5]), jcfg, state=jst)
    with torch.inference_mode():
        ty, tv, tsteps = TS.ssd_verify(mod, torch.from_numpy(x[:, :5]), cfg, state=tst)
    _close(jy, ty, 1e-5)
    for k in ("h", "conv"):
        _close(jv[k], tv[k], 1e-5)
        _close(jsteps[k], tsteps[k], 1e-5)
    # the old state is never written into
    for k, v in st.items():
        np.testing.assert_array_equal(tst[k].numpy(), v)


def test_verify_steps_bit_equal_to_chained_decode(monkeypatch):
    """The rollback contract: T chained decode steps and one T-token
    verify reach the same per-step states bit for bit (the decode step's
    own ``_recur`` chain from the same gate values)."""
    monkeypatch.setattr(TS, "dense", _rowwise_dense)
    _, _, cfg, mod = block_pair()
    st = {k: torch.from_numpy(v) for k, v in _state(cfg, seed=7).items()}
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 6, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        _, vst, steps = TS.ssd_verify(mod, x, cfg, state=st)
        cur, hs, convs = st, [], []
        for t in range(x.shape[1]):
            _, cur = TS.ssd_decode_step(mod, x[:, t:t + 1], cur, cfg)
            hs.append(cur["h"])
            convs.append(cur["conv"])
    assert torch.equal(steps["h"], torch.stack(hs, dim=1))
    assert torch.equal(steps["conv"], torch.stack(convs, dim=1))
    assert torch.equal(vst["h"], cur["h"]) and torch.equal(vst["conv"], cur["conv"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VOCABS))
def test_forward_prefill_decode_match_jax(variant):
    """Forward logits, a ragged prefill (logits and every layer's state)
    and three decode steps at per-row positions within 1e-5 of max|ref| of
    JAX's; decoding from JAX's own (bridged) state gives JAX's logits too.
    With vocab 500 the head's padded columns 500..511 are -1e30 in both."""
    jcfg, params, model = ssd_pair(variant)
    toks = prompts(seed=1)
    jl = J_FORWARD(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.inference_mode():
        tl = model.forward(torch.from_numpy(toks))
    _close(jl, tl, 1e-5)
    assert not hasattr(model, "lm_head") and jcfg.tie_embeddings
    assert tl.shape[-1] == jcfg.padded_vocab_size == 512
    if jcfg.vocab_size != jcfg.padded_vocab_size:
        pad = tl[..., jcfg.vocab_size:]
        assert torch.all(pad == -1e30) and np.all(np.asarray(jl)[..., jcfg.vocab_size:] == -1e30)
        assert torch.all(tl[..., :jcfg.vocab_size] > -1e30)
    jl, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 64,
                              jnp.asarray(LENS))
    with torch.inference_mode():
        tl, tcache, _ = model.prefill(torch.from_numpy(toks), 64, lengths=LENS)
    _close(jl, tl, 1e-5)
    bridged = _layer_caches(jcache, jcfg)
    for b, t in zip(bridged, tcache):
        assert b.keys() == t.keys() == {"h", "conv"}
        for k in t:
            _close(b[k].numpy(), t[k], 1e-5)
    steps = np.random.default_rng(3).integers(0, 500, (3, 3))
    for t in range(3):
        step = steps[:, t:t + 1]
        jl, jcache = J_DECODE(params, {"tokens": jnp.asarray(step)}, jcache,
                              jnp.asarray(LENS + t), jcfg)
        with torch.inference_mode():
            tl, tcache = model.decode_step(torch.from_numpy(step), tcache,
                                           torch.from_numpy(LENS + t))
            bl, bridged = model.decode_step(torch.from_numpy(step), bridged,
                                            torch.from_numpy(LENS + t))
        _close(jl, tl, 1e-5)
        _close(jl, bl, 1e-5)
    for b, t in zip(_layer_caches(jcache, jcfg), tcache):
        for k in t:
            _close(b[k].numpy(), t[k], 1e-5)


def test_verify_and_rollback_match_jax():
    """A 4-token verify from ragged positions, then a ragged-keep rollback:
    logits and the rolled-back states within 2e-5 of JAX's verify_step /
    rollback_cache (tests/test_spec.py's tolerance)."""
    jcfg, params, model = ssd_pair()
    toks = prompts(seed=4)
    _, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 64,
                             jnp.asarray(LENS))
    steps = np.random.default_rng(5).integers(0, 512, (3, 4))
    keep = np.asarray([1, 4, 2], np.int32)
    jl, jnew, jrb = J_VERIFY(params, {"tokens": jnp.asarray(steps)}, jcache,
                             jnp.asarray(LENS), jcfg, True)
    jrolled = J_ROLLBACK(jcache, jnew, jrb, jnp.asarray(keep), jnp.asarray(LENS), jcfg, 4)
    tcache = _layer_caches(jcache, jcfg)
    with torch.inference_mode():
        tl, tcache, rb = model.verify_step(torch.from_numpy(steps), tcache,
                                           torch.from_numpy(LENS), collect_rollback=True)
        model.rollback_cache(tcache, rb, torch.from_numpy(keep), torch.from_numpy(LENS), 4)
    _close(jl, tl, 2e-5)
    for j, t in zip(_layer_caches(jrolled, jcfg), tcache):
        for k in t:
            _close(j[k].numpy(), t[k], 2e-5)


def test_rollback_equals_verify_of_kept_tokens_exactly(monkeypatch):
    """rollback(keep) after a 4-token verify == a verify of only the kept
    tokens, every state leaf bit for bit (JAX
    tests/test_spec.py::test_rollback_equals_prefix_verify on the
    attention-free stack), for keep 1..4 and a ragged keep; keep 4 is the
    fully advanced cache."""
    monkeypatch.setattr(TS, "dense", _rowwise_dense)
    jcfg, params, model = ssd_pair()
    toks = prompts(seed=6)
    _, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcfg, 64,
                             jnp.asarray(LENS))
    steps = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (3, 4)))
    pos = torch.from_numpy(LENS)
    with torch.inference_mode():
        full = _layer_caches(jcache, jcfg)
        _, full, rb = model.verify_step(steps, full, pos, collect_rollback=True)
        rolled = {}
        for keep in ((1, 1, 1), (2, 2, 2), (3, 3, 3), (4, 4, 4), (1, 4, 2)):
            rolled[keep] = [dict(c) for c in full]
            model.rollback_cache(rolled[keep], rb, torch.tensor(keep), pos, 4)
            for b, k in enumerate(keep):
                ref = _layer_caches(jcache, jcfg)
                model.verify_step(steps[:, :k], ref, pos)
                for r, t in zip(ref, rolled[keep]):
                    for name in t:
                        assert torch.equal(r[name][b], t[name][b]), (keep, b, name)
    for r, t in zip(full, rolled[4, 4, 4]):
        for name in t:
            assert torch.equal(r[name], t[name])


def test_init_draws_jax_shapes_and_ranges():
    """``init`` gives the JAX tree's shapes (through the bridge's names),
    the SSD leaves JAX's ranges (a_log = log U(1, 16), softplus(dt_bias) in
    [1e-3, 0.1], d_skip = 1, conv_w ~ N(0, 0.01)), and ``init(pack=)``
    equals init followed by ``pack_weights_int8`` bit for bit."""
    jcfg, _, bridged = ssd_pair()
    cfg = bridged.cfg
    model = TM.init(cfg, seed=3, device="cpu")
    assert [(n, p.shape) for n, p in model.named_parameters()] == \
           [(n, p.shape) for n, p in bridged.named_parameters()]
    layer = model.layers[0]
    assert not hasattr(layer, "norm2") and not hasattr(layer, "ffn")
    a = torch.exp(torch.cat([l.ssd.a_log for l in model.layers]))
    assert a.min() >= 1.0 and a.max() <= 16.0
    sp = torch.nn.functional.softplus(torch.cat([l.ssd.dt_bias for l in model.layers]))
    assert sp.min() >= 1e-3 * (1 - 1e-5) and sp.max() <= 0.1 * (1 + 1e-5)
    assert torch.all(torch.cat([l.ssd.d_skip for l in model.layers]) == 1)
    conv = torch.cat([l.ssd.conv_w.reshape(-1) for l in model.layers])
    assert 0.08 < float(conv.std()) < 0.12
    w_in = layer.ssd.w_in
    assert w_in.shape == (cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssd_heads)
    assert 0.8 < float(w_in.std()) * cfg.d_model ** 0.5 < 1.2
    want = TM.init(cfg, seed=3, device="cpu")
    pack_weights_int8(want, "precise")
    got = TM.init(cfg, seed=3, device="cpu", pack="precise")
    wt = dict(list(want.named_parameters()) + list(want.named_buffers()))
    gt = list(got.named_parameters()) + list(got.named_buffers())
    assert [n for n, _ in gt] == list(wt)
    assert any(n.endswith("ssd.w_in.ka") for n in wt) and any(n.endswith("ssd.w_out.ka")
                                                            for n in wt)
    for n, t in gt:
        assert torch.equal(t, wt[n]), n


def test_packed_keys_are_the_jax_paths():
    """``w_in`` and ``w_out`` pack under PROJ_NAMES (``conv_w`` and the
    per-head vectors stay raw), keyed ``units/0/ssd/w_in`` as JAX's trees:
    the paths policies and draft widths use."""
    from repro_torch.spec.draft import projection_keys

    _, _, bridged = ssd_pair()
    model = TM.init(bridged.cfg, device="cpu", pack="precise")
    keys = sorted(k for k, _ in projection_keys(model))
    assert keys == ["units/0/ssd/w_in"] * 2 + ["units/0/ssd/w_out"] * 2
    assert isinstance(model.layers[1].ssd.conv_w, torch.nn.Parameter)


# ---------------------------------------------------------------------------
# the policy loop's calibration, and the mesh refusal
# ---------------------------------------------------------------------------

def test_calibration_report_matches_jax():
    """``calibrate`` on smoke mamba2 against JAX's: the same projection
    keys (w_in and w_out of units/0), counts and flops equal, histograms
    within tests/test_torch_policy.py's tolerance."""
    from repro import policy as JP
    from repro_torch import policy as TP
    from test_torch_policy import _assert_reports_match

    jcfg, params, model = ssd_pair()
    batches = JP.synthetic_calibration_batches(jcfg, 1, 2, 16, seed=0)
    jrep = JP.calibrate(params, jcfg, batches)
    rep = TP.calibrate(model, model.cfg, batches)
    assert sorted(rep.layers) == ["units/0/ssd/w_in", "units/0/ssd/w_out"]
    _assert_reports_match(jrep, rep)


def test_mesh_refuses_ssd_naming_a13():
    model = TM.init(smoke_config(ARCH), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as ei:
        Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2)), device="cpu")
    msg = str(ei.value)
    assert "'ssd'" in msg and "the SSD state" in msg and "tied embeddings" in msg
