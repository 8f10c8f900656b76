"""The port's dense serving engine on the Griffin hybrid against the JAX
``Engine``, on the CPU: smoke recurrentgemma-2b at ``window=16``, packed
"precise" (JAX through dsbp_ref, the port through dsbp_fused), prompts
past the window at the pinned prompt seed of tests/test_torch_hybrid.py.
Every admission prefills two prompts padded to one 32-token bucket, so
the JAX engine compiles one prefill shape for the whole file.

* Greedy ``generate`` and the dense ``serve`` scheduler (admission
  scatters the recurrent state rows like K/V rows) under
  numeric_guard='fallback' and one ``FaultPlan`` NaN at decode call 1:
  one fallback step, the same statuses and streams as JAX's faulted
  serve, and the same streams as the port's unfaulted serve (the retry
  decodes from the pre-step recurrent state).
* The kv8 cache (ring layers quantized at the write; recurrent state
  stays f32): streams and KV bytes per token equal to JAX's.
* Speculative rounds (spec_k 3, draft bits 7): the streams,
  ``accepted_hist``, rounds and mean acceptance equal to JAX's.  A round
  restores what its draft advanced before the verify (the recurrent
  state, and the slots of a wrapped ``attn_local`` ring), and its
  rollback selects each row's state at its accepted step; the draft runs
  ``wa`` / ``wx`` weight-only over its draft view, as JAX's draft tree
  does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro.serve import faults as JF  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.serve import faults as FA  # noqa: E402
from test_torch_hybrid import engines, prompts, requests  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402

SERVE_LENS = (30, 23, 19, 27)
DENSE = dict(max_len=48, batch_size=2, prefill_bucket=32)


def _serve_both(**scfg):
    jeng, eng = engines(**DENSE, **scfg)
    jout = jeng.serve(requests(SERVE_LENS, JaxRequest))
    out = eng.serve(requests(SERVE_LENS))
    _streams_match(jout, out, jeng, requests(SERVE_LENS))
    return jeng.last_stats, eng.last_stats


def test_packed_dense_engine_and_fallback_match_jax():
    jeng, eng = engines(numeric_guard="fallback", **DENSE)
    # 6 rglru layers of 8 projections (wa and wx too), 2 attn_local of 7
    assert sum(isinstance(m, PackedDSBPWeight) for m in eng.model.modules()) == 8 * 6 + 7 * 2
    lens = np.asarray(SERVE_LENS[:2], np.int32)
    toks = np.zeros((2, 32), np.int64)
    toks[:, :lens.max()] = prompts(lens)
    np.testing.assert_array_equal(eng.generate(toks, 6, lengths=lens),
                                  jeng.generate(toks, 6, lengths=lens))
    out = eng.serve(requests(SERVE_LENS))
    st = eng.last_stats
    assert st["fallback_steps"] == 0 and set(st["request_status"].values()) == {"ok"}
    jf = jeng.serve(requests(SERVE_LENS, JaxRequest), faults=JF.FaultPlan(nan_steps={1: (0,)}))
    tf = eng.serve(requests(SERVE_LENS), faults=FA.FaultPlan(nan_steps={1: (0,)}))
    st, jst = eng.last_stats, jeng.last_stats
    assert st["fallback_steps"] == jst["fallback_steps"] == 1
    assert st["request_status"] == jst["request_status"]
    assert set(st["request_status"].values()) == {"ok"}
    for key in ("decode_steps", "decode_tokens", "admissions", "kv_bytes_per_token"):
        assert st[key] == jst[key], key
    _streams_match(jf, tf, jeng, requests(SERVE_LENS))
    for uid in out:
        np.testing.assert_array_equal(tf[uid], out[uid])


def test_kv8_serve_matches_jax():
    jst, st = _serve_both(kv_quant="kv8")
    assert st["kv_packed"] and jst["kv_packed"]
    assert st["kv_bytes_per_token"] == jst["kv_bytes_per_token"]


def test_speculative_dense_serve_matches_jax():
    jst, st = _serve_both(spec_k=3, spec_draft_bits=7)
    for key in ("accepted_hist", "spec_rounds", "mean_accepted"):
        assert st[key] == jst[key], key
