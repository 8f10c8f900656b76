"""The port's RG-LRU block (``repro_torch.models.recurrent``) against the
JAX package's (``repro.models.recurrent``), on the CPU, at smoke width
(d_model 128, rnn_width 64, d_conv 4).

Inputs are numpy from a seed; the JAX block's weights are carried into
the port's :class:`RGLRU`.  Tolerances: the sequence scan is a
Hillis-Steele scan in the port and ``lax.associative_scan`` in JAX (other
tree orders), and the matmuls accumulate in other orders, so outputs and
states agree within 1e-5 of max|ref|.  Integer selections
(``select_state_step``, ``freeze_state``) and the conv context gathers are
exact.  Within the port, a verify pass's per-step states equal chained
decode steps bit for bit (the rollback contract)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

REL = 1e-5
B, S = 3, 37


def _pair(seed=0):
    """(JAX cfg, JAX block params, port cfg, port RGLRU) with equal weights."""
    jcfg = jax_smoke_config("recurrentgemma-2b")
    cfg = smoke_config("recurrentgemma-2b")
    params = JR.init_rglru_block(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rec = TR.RGLRU(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in rec.named_parameters():
            p.copy_(torch.tensor(np.asarray(params[name])))
    return jcfg, params, cfg, rec


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    r = cfg.rnn_dim
    return {"h": rng.standard_normal((B, r)).astype(np.float32),
            "conv": rng.standard_normal((B, cfg.d_conv - 1, r)).astype(np.float32)}


def _close(j, t, rel=REL):
    j, t = np.asarray(j), t.detach().numpy()
    assert j.shape == t.shape
    assert np.abs(j - t).max() <= rel * np.abs(j).max(), np.abs(j - t).max()


def _jstate(st):
    return None if st is None else {k: jnp.asarray(v) for k, v in st.items()}


def _tstate(st):
    return None if st is None else {k: torch.from_numpy(v) for k, v in st.items()}


@pytest.mark.parametrize("mode", ["plain", "ragged", "carried", "ragged+carried"])
def test_rglru_block_matches_jax(mode):
    jcfg, params, cfg, rec = _pair()
    x = _x((B, S, cfg.d_model), seed=1)
    lengths = np.asarray([S, 20, 1], np.int32) if "ragged" in mode else None
    st = _state(cfg, seed=2) if "carried" in mode else None
    jy, jst = JR.rglru_block(params, jnp.asarray(x), jcfg, state=_jstate(st),
                             lengths=None if lengths is None else jnp.asarray(lengths))
    with torch.inference_mode():
        ty, tst = TR.rglru_block(rec, torch.from_numpy(x), cfg, state=_tstate(st),
                                 lengths=None if lengths is None else torch.from_numpy(lengths))
    _close(jy, ty)
    _close(jst["h"], tst["h"])
    # the conv context is a gather of the same w_in outputs
    _close(jst["conv"], tst["conv"])


def test_decode_and_verify_match_jax():
    jcfg, params, cfg, rec = _pair(seed=3)
    st = _state(cfg, seed=4)
    x = _x((B, 5, cfg.d_model), seed=5)
    jy, jst = JR.rglru_decode_step(params, jnp.asarray(x[:, :1]), _jstate(st), jcfg)
    jv, jvst, jsteps = JR.rglru_verify(params, jnp.asarray(x), jcfg, state=_jstate(st))
    with torch.inference_mode():
        ty, tst = TR.rglru_decode_step(rec, torch.from_numpy(x[:, :1]), _tstate(st), cfg)
        tv, tvst, tsteps = TR.rglru_verify(rec, torch.from_numpy(x), cfg, state=_tstate(st))
    _close(jy, ty)
    for name in ("h", "conv"):
        _close(jst[name], tst[name])
        _close(jvst[name], tvst[name])
        _close(jsteps[name], tsteps[name])
    _close(jv, tv)


def _rowwise_dense(w, x, quant=None, name=None):
    """x @ w with each output row's sum in an order that does not depend
    on how many rows the call has (a library matmul's blocking does)."""
    return (x[..., :, None] * w).sum(dim=-2)


def test_verify_steps_bit_equal_to_chained_decode(monkeypatch):
    """The rollback contract: T chained decode steps and one T-token
    verify pass reach the same per-step states bit for bit (the same
    ``h = a h + b`` chain from the same gate values).  The projections run
    a row-wise product here, so that the gate values themselves are the
    same in both (a library matmul of T rows may round a row otherwise
    than one of 1 row: JAX's test holds verify and decode within 2e-5)."""
    monkeypatch.setattr(TR, "dense", _rowwise_dense)
    _, _, cfg, rec = _pair(seed=6)
    st = _tstate(_state(cfg, seed=7))
    x = torch.from_numpy(_x((B, 6, cfg.d_model), seed=8))
    with torch.inference_mode():
        _, vst, steps = TR.rglru_verify(rec, x, cfg, state=st)
        cur, hs, convs = st, [], []
        for t in range(x.shape[1]):
            _, cur = TR.rglru_decode_step(rec, x[:, t:t + 1], cur, cfg)
            hs.append(cur["h"])
            convs.append(cur["conv"])
    assert torch.equal(steps["h"], torch.stack(hs, dim=1))
    assert torch.equal(steps["conv"], torch.stack(convs, dim=1))
    assert torch.equal(vst["h"], hs[-1]) and torch.equal(vst["conv"], convs[-1])


def test_decode_step_leaves_old_state_untouched():
    """A step returns new state tensors: the engine's fallback retry and
    the speculative round go back to the old dict without a copy."""
    _, _, cfg, rec = _pair(seed=9)
    st = _tstate(_state(cfg, seed=10))
    before = {k: v.clone() for k, v in st.items()}
    with torch.inference_mode():
        TR.rglru_decode_step(rec, torch.from_numpy(_x((B, 1, cfg.d_model), 11)), st, cfg)
        TR.rglru_verify(rec, torch.from_numpy(_x((B, 3, cfg.d_model), 12)), cfg, state=st)
    for k in st:
        assert torch.equal(st[k], before[k])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_and_conv_states_equal_jax(with_state):
    jcfg, params, cfg, rec = _pair(seed=13)
    u = _x((B, 9, cfg.rnn_dim), seed=14)
    st = _state(cfg, seed=15)["conv"] if with_state else None
    lengths = np.asarray([9, 4, 2], np.int32)
    jout, jnew = JR.causal_conv1d(params["conv_w"], jnp.asarray(u),
                                  None if st is None else jnp.asarray(st),
                                  lengths=jnp.asarray(lengths))
    tout, tnew = TR.causal_conv1d(rec.conv_w.detach(), torch.from_numpy(u),
                                  None if st is None else torch.from_numpy(st),
                                  lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    np.testing.assert_array_equal(np.asarray(jnew), tnew.numpy())
    conv0 = _state(cfg, seed=16)["conv"]
    np.testing.assert_array_equal(
        np.asarray(JR.conv_states_per_step(jnp.asarray(conv0), jnp.asarray(u))),
        TR.conv_states_per_step(torch.from_numpy(conv0), torch.from_numpy(u)).numpy())


@pytest.mark.parametrize("with_old", [False, True])
def test_select_state_step_and_freeze_state_equal_jax(with_old):
    rng = np.random.default_rng(17)
    steps = {"h": rng.standard_normal((4, 5, 8)).astype(np.float32),
             "conv": rng.standard_normal((4, 5, 3, 8)).astype(np.float32)}
    old = {"h": rng.standard_normal((4, 8)).astype(np.float32),
           "conv": rng.standard_normal((4, 3, 8)).astype(np.float32)}
    keep = np.asarray([1, 5, 0, 3], np.int32) if with_old else np.asarray([1, 5, 2, 3], np.int32)
    j = JB.select_state_step({k: jnp.asarray(v) for k, v in steps.items()},
                             jnp.asarray(keep),
                             old={k: jnp.asarray(v) for k, v in old.items()} if with_old else None)
    t = TB.select_state_step({k: torch.from_numpy(v) for k, v in steps.items()},
                             torch.from_numpy(keep),
                             old={k: torch.from_numpy(v) for k, v in old.items()}
                             if with_old else None)
    for k in steps:
        np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy())
    wl = np.asarray([0, 1, 0, 2], np.int32)
    jf = JB.freeze_state({k: jnp.asarray(v) for k, v in old.items()},
                         {k: jnp.asarray(v[:, 0]) for k, v in steps.items()}, jnp.asarray(wl))
    tf = TB.freeze_state({k: torch.from_numpy(v) for k, v in old.items()},
                         {k: torch.from_numpy(v[:, 0]) for k, v in steps.items()},
                         torch.from_numpy(wl))
    for k in old:
        np.testing.assert_array_equal(np.asarray(jf[k]), tf[k].numpy())


@pytest.mark.parametrize("s", [1, 2, 5, 64, 100])
def test_scan_equals_sequential_recurrence(s):
    """The log-depth scan computes every prefix of h = a h + b (within
    float round-off of the sequential chain)."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 6)).astype(np.float32))
    h, ref = torch.zeros(2, 6), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    ref = torch.stack(ref, dim=1)
    got = TR._scan(a, b)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
