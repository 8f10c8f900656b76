"""The port's paged scheduler on the MoE family against the JAX ``Engine``,
on the CPU: the packed pair of tests/test_torch_moe.py (smoke
mixtral-8x7b at ``window=8``, packed "precise"), block size 4, greedy.

* Serving across a ring wrap (prompts and decodes longer than the window,
  so each lane's ring wraps through its block table; tests/test_paged.py
  :282), float and kv8 pools (tests/test_kvq.py:283): streams equal to
  JAX's paged serve and to the port's own dense serve.
* Two lanes sharing a whole 8-token prompt: the ring's wrap writes into the
  shared blocks, so the copy-on-write split fires (tests/test_paged.py
  :298, and over a packed pool tests/test_kvq.py:305): prefix hits and
  splits equal to JAX's, streams equal to JAX's and to the dense serve.
* Speculative rounds through the block tables (spec_k 3, draft bits 4):
  streams and ``accepted_hist`` equal to JAX's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from test_torch_hybrid import requests  # noqa: E402
from test_torch_moe_serve import engines, port_engine  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402

BASE = dict(batch_size=2, max_len=24, prefill_bucket=8)
PAGED = dict(paged=True, kv_block_size=4)
COUNTERS = ("decode_steps", "decode_tokens", "admissions", "prefill_tokens", "cow_splits",
            "prefix_hit_blocks", "block_peak_used", "block_bytes", "kv_bytes_per_token")


def _shared_prompt(cls, n=2):
    shared = np.random.default_rng(6).integers(0, 512, 8)
    return [cls(uid=f"s{i}", tokens=shared.copy(), max_new_tokens=8) for i in range(n)]


def _serve_three(make, **scfg):
    """The JAX paged serve, the port's paged serve and the port's dense
    serve of the requests ``make(cls)`` builds; streams held equal."""
    jeng, eng = engines(**BASE, **PAGED, **scfg)
    jout = jeng.serve(make(JaxRequest))
    out = eng.serve(make(Request))
    _streams_match(jout, out, jeng, make(Request))
    dout = port_engine(**BASE, **scfg).serve(make(Request))
    for uid in out:
        np.testing.assert_array_equal(out[uid], dout[uid])
    st, jst = eng.last_stats, jeng.last_stats
    for key in COUNTERS:
        assert st[key] == jst[key], (key, st[key], jst[key])
    assert st["blocks_in_use_at_exit"] == 0
    return st


@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_paged_serve_across_a_ring_wrap_matches_jax(kv):
    st = _serve_three(lambda cls: requests((6, 14, 10, 12), cls, seed=5, new=6), kv_quant=kv)
    assert st["kv_packed"] == (kv is not None)


@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float", "kv8"])
def test_cow_split_on_a_shared_ring_matches_jax(kv):
    st = _serve_three(_shared_prompt, kv_quant=kv)
    assert st["prefix_hit_blocks"] > 0 and st["cow_splits"] > 0


def test_speculative_paged_serve_matches_jax():
    jeng, eng = engines(**BASE, **PAGED, spec_k=3, spec_draft_bits=4)
    make = lambda cls: requests((6, 14, 10, 12), cls, seed=5, new=6)  # noqa: E731
    jout = jeng.serve(make(JaxRequest))
    out = eng.serve(make(Request))
    _streams_match(jout, out, jeng, make(Request))
    for key in ("accepted_hist", "spec_rounds", "mean_accepted"):
        assert eng.last_stats[key] == jeng.last_stats[key], key
