"""The port's fault-tolerant serving against the JAX package, on the CPU.

The counterpart of ``tests/test_robustness.py`` at smoke llama-7b-paper
(GQA), packed "precise" (the port through its default dsbp_fused, whose
plain version the 'fallback' retry's dsbp_ref equals bit for bit here):
request validation, allocator edge cases, ``FaultPlan`` (``seeded`` equal
to JAX's field for field), ``check_invariants``, ``last_stats`` on any
exit, cancellation and deadlines, preemption with bit-exact resume under
injected refusals, the numeric guard's policies in both schedulers and in
speculative rounds, and the seeded fault mix.  Cross-package: the JAX and
port engines, given the same requests and the same plan, give equal
statuses, robust counters and trace signatures (dense, paged, speculative),
streams equal under the near-tie rule of ``test_torch_engine.py``; and the
'fallback' retry over the port's in-place cache equals a reference decode
from the pre-step cache, dense and paged, float and kv8.
(``test_allocator_random_ops_conserve_refcounts`` has no counterpart: the
reference fails it; ``test_admission_preemption_strictly_higher_priority``'s
is ``test_torch_paged.py::test_admission_preempts_only_strictly_lower_priority``.)"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro.spec import decode as JSD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import Quant  # noqa: E402
from repro_torch.serve import blocks as SB  # noqa: E402
from repro_torch.serve import faults as FA  # noqa: E402
from repro_torch.serve.engine import (REQUEST_STATES, Engine, Request,  # noqa: E402
                                      ServeConfig)
from repro_torch.spec import build_spec_round  # noqa: E402
from test_torch_engine import PROMPT_SEED  # noqa: E402
from test_torch_model import LENS, _prompts, make_pair  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402
from test_torch_spec import _np_cache  # noqa: E402

PAGED = dict(max_len=32, batch_size=4, paged=True, kv_block_size=4)
ROBUST = ("cancelled", "deadline_expired", "quarantined", "numeric_faults", "guard_checks",
          "fallback_steps", "preemptions", "resumed", "invariant_checks")


@pytest.fixture(scope="module")
def pair():
    """JAX cfg, packed JAX params and the port's packed model, once: every
    port engine of this module serves the one packed model."""
    return make_pair("gqa", packed=True)


def _eng(pair, **scfg) -> Engine:
    return Engine(pair[2], ServeConfig(**scfg), device="cpu")


def _jeng(pair, **scfg) -> JaxEngine:
    return JaxEngine(pair[1], pair[0], JaxServeConfig(quant_method="dsbp_ref", **scfg))


def _reqs(lens, seed=PROMPT_SEED, cls=Request, new=8, **fields):
    rng = np.random.default_rng(seed)
    return [cls(uid=f"r{i}", tokens=rng.integers(0, 512, n), max_new_tokens=new,
                **{k: v[i] for k, v in fields.items()}) for i, n in enumerate(lens)]


def _ok(st) -> set:
    return {u for u, s in st["request_status"].items() if s in ("ok", "preempted")}


@pytest.fixture(scope="module")
def base(pair):
    """Unfaulted streams of the port's paged and dense engines (the
    references most cases compare with), keyed by request set."""
    out = {}
    eng = _eng(pair, **PAGED)
    for lens, seed in (((5, 9, 7, 6), PROMPT_SEED), ((5, 9, 7, 6, 8), 4),
                       ((5, 9, 7, 6, 8, 10), 5)):
        out["paged", lens] = eng.serve(_reqs(lens, seed))
    dense = _eng(pair, max_len=48, batch_size=3)
    out["dense", (5, 9, 7)] = dense.serve(_reqs((5, 9, 7)))
    out["dense", (5, 9)] = dense.serve(_reqs((5, 9)))
    return out


def _prefix_of(out, ref, uid):
    assert np.array_equal(out[uid], ref[uid][: len(out[uid])]), uid


# ---------------------------------------------------------------------------
# request validation and configuration
# ---------------------------------------------------------------------------

def test_norm_request_rejects_like_jax():
    """An empty or 2-D prompt, a zero budget, an unhashable uid and a
    deadline below 1 are refused with JAX's messages."""
    for req, match in ((dict(tokens=np.zeros((0,), np.int64)), "non-empty"),
                       (dict(tokens=np.zeros((2, 3), np.int64)), "1-D"),
                       (dict(tokens=np.arange(4), max_new_tokens=0), "max_new_tokens"),
                       (dict(uid=["list", "uid"], tokens=np.arange(4)), "unhashable"),
                       (dict(tokens=np.arange(4), deadline_steps=0), "deadline_steps")):
        fields = {"uid": "a", **req}
        with pytest.raises(ValueError, match=match) as terr:
            Engine._norm_request(Request(**fields), 0, 8)
        with pytest.raises(ValueError) as jerr:
            JaxEngine._norm_request(JaxRequest(**fields), 0, 8)
        assert str(terr.value) == str(jerr.value)


def test_norm_request_does_not_mutate_caller():
    r = Request(uid="a", tokens=[1, 2, 3])
    out = Engine._norm_request(r, 0, 8)
    assert isinstance(out.tokens, np.ndarray) and isinstance(r.tokens, list)


def test_guard_config_errors_match_jax(pair):
    """An unknown policy, and 'fallback' with speculation: JAX's messages."""
    for scfg in (dict(numeric_guard="bogus"), dict(spec_k=2, numeric_guard="fallback")):
        with pytest.raises(ValueError) as terr:
            _eng(pair, max_len=32, **scfg)
        with pytest.raises(ValueError) as jerr:
            _jeng(pair, max_len=32, **scfg)
        assert str(terr.value) == str(jerr.value)


def test_mesh_refuses_guard_observe_and_faults(pair):
    model = TM.init(pair[2].cfg.replace(quant=None), device="cpu")  # a mesh takes a float model
    for scfg, what in ((dict(numeric_guard="quarantine"), "numeric guard"),
                       (dict(observe=True), "serve recorder")):
        with pytest.raises(NotImplementedError, match=rf"ROADMAP A13\): the {what}"):
            Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2), **scfg), device="cpu")
    eng = _eng(pair, max_len=32, batch_size=2)
    eng.mesh = object()  # what a mesh engine holds: the plan is refused first
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        eng.serve(_reqs((5,)), faults=FA.FaultPlan())


# ---------------------------------------------------------------------------
# allocator edge cases
# ---------------------------------------------------------------------------

def test_allocator_edge_cases():
    """A double free raises, forgetting an unknown block frees nothing, an
    already writable table copies nothing, a scratch entry is refused, and
    the gauges equal JAX's after the same operations."""
    from repro.serve import blocks as JSB

    a = SB.BlockAllocator(4, 2)
    (b,) = a.alloc(1)
    a.free([b])
    with pytest.raises(ValueError, match="double free"):
        a.free([b])
    p = SB.PrefixCache(a)
    assert p.forget(3) is False and p.forget(SB.SCRATCH_BLOCK) is False
    assert a.free_blocks == 3
    a = SB.BlockAllocator(5, 2)
    table = np.zeros(4, np.int32)
    table[:2] = a.alloc(2)
    before = a.refcounts().copy()
    assert a.ensure_writable(table, [0, 1]) == ([], [])
    assert np.array_equal(a.refcounts(), before)
    with pytest.raises(ValueError, match="unallocated"):
        a.ensure_writable(np.zeros(4, np.int32), [0])
    ta, ja = SB.BlockAllocator(9, 4), JSB.BlockAllocator(9, 4)
    for a in (ta, ja):
        ids = a.alloc(3)
        a.share(ids[0])
        a.free([ids[2]])
    assert ta.stats() == ja.stats()


# ---------------------------------------------------------------------------
# fault plan + invariant checker
# ---------------------------------------------------------------------------

def _plan_fields(p):
    return (p.seed, p.alloc_failures, p.cow_failures, p.nan_steps, p.persistent_nan,
            p.cancels, p.spec_mismatch_rounds)


def test_fault_plan_seeded_equals_jax():
    """Same seed -> JAX's plan field for field (and the same plan again);
    another seed -> another plan."""
    kw = dict(uids=["a", "b", "c", "d"], n_alloc=2, n_cow=2, n_nan=3, n_cancel=2, n_spec=2,
              decode_calls=12, alloc_calls=10, steps=8, lanes=4)
    for seed in (0, 5, 7, 11, 123):
        tp, jp = FA.FaultPlan.seeded(seed, **kw), JF.FaultPlan.seeded(seed, **kw)
        assert _plan_fields(tp) == _plan_fields(jp)
        assert _plan_fields(FA.FaultPlan.seeded(seed, **kw)) == _plan_fields(tp)
    p7, p8 = FA.FaultPlan.seeded(7, **kw), FA.FaultPlan.seeded(8, **kw)
    assert p8.alloc_failures != p7.alloc_failures or p8.nan_steps != p7.nan_steps


def test_fault_plan_hooks_match_jax():
    """The injection hooks, call by call: the same hits, tallies and
    observer calls; NaNs land in the chosen rows of a copy."""
    kw = dict(seed=3, alloc_failures={1}, cow_failures={0}, nan_steps={0: (1,), 2: "all"},
              cancels={4: ("x",)}, spec_mismatch_rounds={1})
    seen = {"t": [], "j": []}
    tp, jp = FA.FaultPlan(**kw), JF.FaultPlan(**kw)
    tp.observer = lambda k, i: seen["t"].append((k, i))
    jp.observer = lambda k, i: seen["j"].append((k, i))
    for p in (tp, jp):
        assert [p._take_alloc_fault() for _ in range(3)] == [False, True, False]
        assert [p._take_cow_fault() for _ in range(2)] == [True, False]
        assert p.cancels_at(4) == ("x",) and p.cancels_at(3) == ()
    logits = np.arange(12, dtype=np.float32).reshape(3, 4)
    t0 = tp.corrupt_logits(torch.from_numpy(logits), [0, 1, 2])
    j0 = np.asarray(jp.corrupt_logits(logits, [0, 1, 2]))
    np.testing.assert_array_equal(t0.numpy(), j0)
    assert torch.isnan(t0[1]).all() and not torch.isnan(t0[0]).any()
    src = torch.from_numpy(logits)
    assert tp.corrupt_logits(src, [0, 1]) is src  # call 1: nothing scheduled
    jp.corrupt_logits(logits, [0, 1])
    fin = np.ones(3, bool)
    np.testing.assert_array_equal(tp.corrupt_finite(torch.from_numpy(fin), [0, 2]).numpy(),
                                  jp.corrupt_finite(fin, [0, 2]))
    keep = np.asarray([3, 0, 2])
    for _ in range(2):
        np.testing.assert_array_equal(tp.clip_spec_keep(keep), jp.clip_spec_keep(keep))
    assert tp.injected == jp.injected and seen["t"] == seen["j"]
    tp.reset()
    assert sum(tp.injected.values()) == 0 and tp.observer is None


def test_invariant_checker_catches_leak_and_loss():
    a = SB.BlockAllocator(5, 2)
    a.alloc(2)  # held by nobody the checker can see -> leak
    with pytest.raises(AssertionError, match="refcount conservation"):
        FA.check_invariants(a, tables=np.zeros((1, 4), np.int32), lanes=[None])
    b = SB.BlockAllocator(5, 2)
    t = np.zeros((1, 4), np.int32)
    t[0, 0] = b.alloc(1)[0]
    with pytest.raises(AssertionError, match="released lane"):
        FA.check_invariants(b, tables=t, lanes=[None])
    with pytest.raises(AssertionError, match="lost"):
        FA.check_invariants(SB.BlockAllocator(5, 2), out={"a": []}, uids=["a", "b"])
    # the plan's allocator refuses before any state mutates
    plan = FA.FaultPlan(alloc_failures={0}, cow_failures={0})
    a = plan.allocator(6, 2)
    with pytest.raises(SB.BlockError, match="fault-injected"):
        a.alloc(2)
    assert a.free_blocks == 5 and a.used_blocks == 0
    t = np.zeros(3, np.int32)
    t[:1] = a.alloc(1)
    a.share(int(t[0]))
    before, row = a.refcounts().copy(), t.copy()
    with pytest.raises(SB.BlockError, match="COW split refused"):
        a.ensure_writable(t, [0])
    assert np.array_equal(a.refcounts(), before) and np.array_equal(t, row)
    assert plan.injected["alloc"] == 1 and plan.injected["cow"] == 1


# ---------------------------------------------------------------------------
# last_stats and conservation on any exit
# ---------------------------------------------------------------------------

def test_exception_mid_loop_conserves_allocator_and_last_stats(pair):
    eng = _eng(pair, numeric_guard="fail-fast", **PAGED)
    with pytest.raises(FA.NumericFault):
        eng.serve(_reqs((5, 9, 7)), faults=FA.FaultPlan(nan_steps={1: "all"}))
    st = eng.last_stats
    assert st["completed"] is False and st["decode_steps"] >= 1
    assert set(st["request_status"]) == {"r0", "r1", "r2"}
    alloc = eng._last_alloc
    assert alloc.used_blocks == 0 and alloc.free_blocks == eng.kv_blocks - 1
    FA.check_invariants(alloc)
    # the dense scheduler as well
    eng = _eng(pair, max_len=32, batch_size=2, numeric_guard="fail-fast")
    with pytest.raises(FA.NumericFault):
        eng.serve(_reqs((5, 9)), faults=FA.FaultPlan(nan_steps={0: "all"}))
    st = eng.last_stats
    assert st["completed"] is False and st["numeric_faults"] >= 1
    assert all(k in st for k in ROBUST)


# ---------------------------------------------------------------------------
# cancellation + deadlines
# ---------------------------------------------------------------------------

def test_cancel_queued_and_midstream(pair, base):
    ref = base["paged", (5, 9, 7, 6)]
    eng = _eng(pair, **PAGED)
    eng.cancel("r3")  # before serve starts: still queued at iteration 0
    out = eng.serve(_reqs((5, 9, 7, 6)), faults=FA.FaultPlan(cancels={3: ("r1",)}))
    st = eng.last_stats
    status = st["request_status"]
    assert status["r1"] == "cancelled" and status["r3"] == "cancelled"
    assert st["cancelled"] == 2 and st["completed"] is True
    assert 0 < len(out["r1"]) < len(ref["r1"])
    _prefix_of(out, ref, "r1")
    assert len(out["r3"]) == 0
    for uid in ("r0", "r2"):
        assert status[uid] == "ok" and np.array_equal(out[uid], ref[uid])
    FA.check_invariants(eng._last_alloc)


def test_deadline_expiry_frees_lane(pair):
    rng = np.random.default_rng(0)
    reqs = [Request(uid="slow", tokens=rng.integers(0, 512, 5), max_new_tokens=20,
                    deadline_steps=3),
            Request(uid="fast", tokens=rng.integers(0, 512, 7), max_new_tokens=6)]
    eng = _eng(pair, invariant_checks=True, **PAGED)
    out = eng.serve(reqs)
    st = eng.last_stats
    assert st["request_status"] == {"slow": "deadline", "fast": "ok"}
    assert st["deadline_expired"] == 1 and st["invariant_checks"] > 0
    assert 0 < len(out["slow"]) < 20 and len(out["fast"]) == 6


def test_dense_cancel_and_deadline(pair, base):
    """The dense scheduler's control sweep: a cancel mid-stream and an
    expired deadline keep a prefix of the unfaulted stream."""
    ref = base["dense", (5, 9, 7)]
    eng = _eng(pair, max_len=48, batch_size=3)
    reqs = _reqs((5, 9, 7), deadline_steps=[None, None, 4])
    out = eng.serve(reqs, faults=FA.FaultPlan(cancels={2: ("r0",)}))
    status = eng.last_stats["request_status"]
    assert status == {"r0": "cancelled", "r1": "ok", "r2": "deadline"}
    # iteration i admits (at 0) and decodes: r0 has 3 tokens when the
    # sweep of iteration 2 cancels it, r2 5 when iteration 4 expires it
    assert len(out["r0"]) == 3 and len(out["r2"]) == 5
    for uid in out:
        _prefix_of(out, ref, uid)
    assert np.array_equal(out["r1"], ref["r1"])


# ---------------------------------------------------------------------------
# preemption + bit-exact resume
# ---------------------------------------------------------------------------

def test_preempt_resume_token_parity(pair, base):
    ref = base["paged", (5, 9, 7, 6)]
    eng = _eng(pair, **PAGED)
    out = eng.serve(_reqs((5, 9, 7, 6)), faults=FA.FaultPlan(cow_failures={0, 3}))
    st = eng.last_stats
    assert st["preemptions"] >= 1 and st["resumed"] >= 1 and st["invariant_checks"] > 0
    assert "preempted" in st["request_status"].values()
    assert set(st["request_status"].values()) <= {"ok", "preempted"}
    for uid in ref:
        assert np.array_equal(out[uid], ref[uid]), uid
    FA.check_invariants(eng._last_alloc)


def test_pool_exhaustion_preempts_instead_of_raising(pair, base):
    ref = base["paged", (5, 9, 7, 6, 8)]
    eng = _eng(pair, **dict(PAGED, kv_blocks=13, max_active=3))
    out = eng.serve(_reqs((5, 9, 7, 6, 8), seed=4),
                    faults=FA.FaultPlan(alloc_failures={0, 2}, cow_failures={1}))
    st = eng.last_stats
    assert st["completed"] is True
    assert set(st["request_status"].values()) <= {"ok", "preempted"}
    for uid in ref:
        assert np.array_equal(out[uid], ref[uid]), uid
    FA.check_invariants(eng._last_alloc)


# ---------------------------------------------------------------------------
# numeric guards
# ---------------------------------------------------------------------------

def test_guard_quarantine_kills_one_lane_not_the_batch(pair, base):
    ref = base["paged", (5, 9, 7, 6)]
    eng = _eng(pair, numeric_guard="quarantine", **PAGED)
    out = eng.serve(_reqs((5, 9, 7, 6)), faults=FA.FaultPlan(nan_steps={1: (0,)}))
    st = eng.last_stats
    assert st["request_status"]["r0"] == "quarantined"
    assert st["quarantined"] == 1 and st["numeric_faults"] >= 1
    assert 0 < len(out["r0"]) < len(ref["r0"])
    _prefix_of(out, ref, "r0")
    for uid in ("r1", "r2", "r3"):
        assert st["request_status"][uid] == "ok" and np.array_equal(out[uid], ref[uid])
    FA.check_invariants(eng._last_alloc)


def test_guard_fail_fast_raises_with_uids(pair):
    for scfg in (dict(max_len=32, batch_size=2), PAGED):
        eng = _eng(pair, numeric_guard="fail-fast", **scfg)
        with pytest.raises(FA.NumericFault) as ei:
            eng.serve(_reqs((5, 9)), faults=FA.FaultPlan(nan_steps={0: (1,)}))
        assert ei.value.uids == ["r1"] and ei.value.step == 0  # iteration 0 decodes


def test_guard_fallback_recovers_transient_fault(pair, base):
    """A NaN the reference-path retry clears costs one fallback step and
    changes nothing: every stream equals the unfaulted run, all 'ok'
    (dense, then paged)."""
    for kind, lens, scfg in (("dense", (5, 9, 7), dict(max_len=48, batch_size=3)),
                             ("paged", (5, 9, 7, 6), PAGED)):
        ref = base[kind, lens]
        eng = _eng(pair, numeric_guard="fallback", **scfg)
        out = eng.serve(_reqs(lens), faults=FA.FaultPlan(nan_steps={1: (0,)}))
        st = eng.last_stats
        assert st["fallback_steps"] == 1 and st["quarantined"] == 0
        assert set(st["request_status"].values()) == {"ok"}
        for uid in ref:
            assert np.array_equal(out[uid], ref[uid]), (kind, uid)


def test_guard_fallback_persistent_fault_quarantines(pair):
    eng = _eng(pair, numeric_guard="fallback", **PAGED)
    eng.serve(_reqs((5, 9)), faults=FA.FaultPlan(nan_steps={1: (0,)}, persistent_nan=True))
    st = eng.last_stats
    assert st["fallback_steps"] == 1
    assert st["request_status"] == {"r0": "quarantined", "r1": "ok"}


def test_dense_guard_quarantine_parity(pair, base):
    ref = base["dense", (5, 9, 7)]
    eng = _eng(pair, max_len=48, batch_size=3, numeric_guard="quarantine")
    out = eng.serve(_reqs((5, 9, 7)), faults=FA.FaultPlan(nan_steps={2: (1,)}))
    assert eng.last_stats["request_status"]["r1"] == "quarantined"
    _prefix_of(out, ref, "r1")
    for uid in ("r0", "r2"):
        assert np.array_equal(out[uid], ref[uid])


def test_guard_off_costs_nothing(pair):
    """No guard, no check; with one, a check per admission prefill group
    and per decode step."""
    eng = _eng(pair, **PAGED)
    eng.serve(_reqs((5, 9)))
    assert eng.last_stats["guard_checks"] == 0 and eng._finite is None
    eng = _eng(pair, max_len=32, batch_size=2, numeric_guard="quarantine")
    eng.serve(_reqs((5, 9)))
    st = eng.last_stats
    assert st["guard_checks"] == st["decode_steps"] + 1 and st["numeric_faults"] == 0


def test_fallback_retry_equals_decode_from_pre_step_cache(pair):
    """The 'fallback' retry over the port's in-place cache: a dsbp_ref
    step re-run after a dsbp_fused step with the same tokens and positions
    gives the logits and the cache of a dsbp_ref step from a copy of the
    pre-step cache, bit for bit (each step writes its own slots before its
    attention reads them): dense and paged, float and kv8."""
    for kv in (None, "kv8"):
        for paged in (False, True):
            _check_retry(pair[2], kv, paged)


def _check_retry(model, kv, paged):
    """One retry case of the test above."""
    toks = torch.from_numpy(_prompts(512, seed=PROMPT_SEED))
    step = torch.from_numpy(np.asarray([[7], [11], [13]], np.int64))
    fused, ref = Quant("precise", "dsbp_fused"), Quant("precise", "dsbp_ref")
    with torch.inference_mode():
        if paged:
            table = np.arange(1, 1 + 3 * 6, dtype=np.int32).reshape(3, 6)
            cache = model.init_paged_cache(19, 4, kv=kv)
            model.prefill_paged(toks, cache, table, 24, lengths=LENS)
            live = np.asarray([1, 0, 1], np.int32)

            def run(c, q):
                return model.decode_step_paged(step, c, table, LENS, live, 24, q)
        else:
            _, cache, _ = model.prefill(toks, 24, lengths=LENS, kv=kv)

            def run(c, q):
                return model.decode_step(step, c, torch.from_numpy(LENS), q)
        before = copy.deepcopy(cache)
        run(cache, fused)
        got, cache = run(cache, ref)
        want, before = run(before, ref)
    assert torch.equal(got, want), (kv, paged)
    for a, b in zip(cache, before):
        for name in ("k", "v"):
            x, y = a[name], b[name]
            pairs = [(x.qm, y.qm), (x.scale, y.scale)] if kv else [(x, y)]
            for u, w in pairs:
                assert torch.equal(u, w), (kv, paged, name)


# ---------------------------------------------------------------------------
# speculation under faults
# ---------------------------------------------------------------------------

def test_spec_mismatch_clip_keeps_token_parity(pair, base):
    ref = base["dense", (5, 9)]
    eng = _eng(pair, max_len=48, batch_size=2, spec_k=2)
    plan = FA.FaultPlan(spec_mismatch_rounds={0, 1, 2})
    out = eng.serve(_reqs((5, 9)), faults=plan)
    assert plan.injected["spec"] == 3
    for uid in ref:
        assert np.array_equal(out[uid], ref[uid]), uid


def test_spec_guard_quarantines_before_commit(pair, base):
    """A non-finite verify pass quarantines its lane before any of the
    round's tokens commit; the other lane's stream is untouched (dense,
    then paged)."""
    ref = base["dense", (5, 9)]
    for paged in (False, True):
        scfg = dict(max_len=48, batch_size=2, spec_k=2, numeric_guard="quarantine")
        if paged:
            scfg.update(paged=True, kv_block_size=4)
        eng = _eng(pair, **scfg)
        out = eng.serve(_reqs((5, 9)), faults=FA.FaultPlan(nan_steps={1: (0,)}))
        st = eng.last_stats
        assert st["request_status"] == {"r0": "quarantined", "r1": "ok"}
        assert st["guard_checks"] >= 2
        _prefix_of(out, ref, "r0")
        assert np.array_equal(out["r1"], ref["r1"])
        if paged:
            FA.check_invariants(eng._last_alloc)


def test_spec_round_finite_mask_matches_jax(pair):
    """guard=True: the round's 4th output, all True on clean logits, and
    the accepted lengths as JAX's guarded round gives them."""
    jcfg, params, model = pair
    toks = _prompts(512, seed=PROMPT_SEED)
    jl, jcache, _ = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=24,
                               lengths=jnp.asarray(LENS))
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int64)
    jres = JSD.build_spec_round(jcfg, 2, 4, "dsbp_ref", guard=True)(
        params, jcache, jnp.asarray(tok), jnp.asarray(LENS))
    tcache = bridge.cache_from_jax(_np_cache(jcache), jcfg, device="cpu")
    with torch.inference_mode():
        tres = build_spec_round(model.cfg, 2, 4, "dsbp_ref", guard=True)(
            model, tcache, torch.from_numpy(tok), torch.from_numpy(LENS))
    assert len(tres) == len(jres) == 4
    np.testing.assert_array_equal(np.asarray(jres[3]), tres[3].numpy())
    assert tres[3].dtype == torch.bool and bool(tres[3].all())
    np.testing.assert_array_equal(np.asarray(jres[1]), tres[1].numpy())


# ---------------------------------------------------------------------------
# acceptance: the standard seeded scenario
# ---------------------------------------------------------------------------

def test_seeded_fault_mix_zero_lost_requests(pair, base):
    ref = base["paged", (5, 9, 7, 6, 8, 10)]
    reqs = _reqs((5, 9, 7, 6, 8, 10), seed=5)
    uids = [r.uid for r in reqs]
    eng = _eng(pair, numeric_guard="quarantine", **dict(PAGED, kv_blocks=17, max_active=4))
    plan = FA.FaultPlan.seeded(5, uids=uids, n_alloc=2, n_cow=2, n_nan=1, n_cancel=1,
                               decode_calls=12, alloc_calls=10, steps=8, lanes=4)
    out = eng.serve(reqs, faults=plan)
    st = eng.last_stats
    assert st["completed"] is True and set(st["request_status"]) == set(uids)
    assert set(st["request_status"].values()) <= set(REQUEST_STATES)
    assert set(out) == set(uids) and st["invariant_checks"] > 0
    assert sum(plan.injected.values()) > 0
    for uid in _ok(st):
        assert np.array_equal(out[uid], ref[uid]), uid
    for uid in uids:
        _prefix_of(out, ref, uid)
    FA.check_invariants(eng._last_alloc, out=out, uids=uids)


# ---------------------------------------------------------------------------
# cross-package: the same requests and plan through both engines
# ---------------------------------------------------------------------------

def _both(pair, scfg, lens, seed, plan_kw=None, seeded=None, **fields):
    """Serve one request set through the JAX and port engines under equal
    plans (``plan_kw`` for FaultPlan(...), ``seeded`` for .seeded(...)),
    observed; returns (jax engine, port engine, jax out, port out)."""
    jeng, eng = _jeng(pair, observe=True, **scfg), _eng(pair, observe=True, **scfg)
    outs = []
    for e, cls, mod in ((jeng, JaxRequest, JF), (eng, Request, FA)):
        reqs = _reqs(lens, seed, cls=cls, **fields)
        plan = (mod.FaultPlan.seeded(seeded[0], uids=[r.uid for r in reqs], **seeded[1])
                if seeded else mod.FaultPlan(**plan_kw) if plan_kw else None)
        outs.append(e.serve(reqs, faults=plan))
        outs.append(plan)
    jout, jplan, tout, tplan = outs
    _streams_match(jout, tout, jeng, _reqs(lens, seed, **fields))
    jst, tst = jeng.last_stats, eng.last_stats
    assert tst["request_status"] == jst["request_status"]
    assert tst["completed"] == jst["completed"]
    for key in ROBUST + ("decode_steps", "decode_tokens", "admissions", "prefill_tokens"):
        assert tst[key] == jst[key], (key, tst[key], jst[key])
    assert eng.obs.trace.signature() == jeng.obs.trace.signature()
    counters = [n for n, f in jeng.obs.metrics.snapshot()["families"].items()
                if f["kind"] == "counter"]
    for name in counters:
        assert eng.obs.metrics.value(name) == jeng.obs.metrics.value(name), name
    if jplan is not None:
        assert tplan.injected == jplan.injected
    return jeng, eng, jout, tout


def test_dense_faults_match_jax(pair):
    """Dense: a NaN quarantine, a mid-stream cancel and a deadline."""
    _, eng, _, _ = _both(pair, dict(max_len=48, batch_size=2, numeric_guard="quarantine"),
                         (5, 9, 7, 6), PROMPT_SEED,
                         plan_kw=dict(nan_steps={2: (1,)}, cancels={4: ("r2",)}),
                         deadline_steps=[None, None, None, 3])
    assert set(eng.last_stats["request_status"].values()) == {
        "ok", "quarantined", "cancelled", "deadline"}


def test_paged_seeded_faults_match_jax(pair):
    """Paged: the seeded mix (refusals, COW contention, NaN, cancel) on an
    over-subscribed pool."""
    _, eng, _, _ = _both(
        pair, dict(PAGED, kv_blocks=13, max_active=4, numeric_guard="quarantine"),
        (5, 9, 7, 6), 3, seeded=(5, dict(n_alloc=2, n_cow=1, n_nan=1, n_cancel=1,
                                          decode_calls=12, alloc_calls=10, steps=8,
                                          lanes=4)))
    st = eng.last_stats
    assert st["invariant_checks"] > 0 and st["completed"]


def test_spec_faults_match_jax(pair):
    """Speculative rounds: a NaN quarantine before commit and clamped
    acceptance."""
    _both(pair, dict(max_len=48, batch_size=2, spec_k=2, numeric_guard="quarantine"),
          (5, 9, 7), PROMPT_SEED,
          plan_kw=dict(nan_steps={1: (0,)}, spec_mismatch_rounds={0, 2}))


def test_kv8_fallback_matches_jax(pair):
    """'fallback' over a paged kv8 pool: JAX retries from its pre-step
    cache, the port rewrites the step's slots in place; two fallback steps,
    every request 'ok', the same streams and trace."""
    scfg = dict(max_len=32, batch_size=3, numeric_guard="fallback", kv_quant="kv8",
                paged=True, kv_block_size=4)
    _, eng, _, _ = _both(pair, scfg, (5, 9, 7), PROMPT_SEED,
                         plan_kw=dict(nan_steps={1: (0,), 3: "all"}))
    st = eng.last_stats
    assert st["fallback_steps"] == 2 and set(st["request_status"].values()) == {"ok"}
