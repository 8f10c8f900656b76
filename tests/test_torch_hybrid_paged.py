"""The port's paged and speculative serving on the Griffin hybrid against
the JAX ``Engine``, on the CPU, at ``window=16`` and packed "precise"
(the pinned prompt seed of tests/test_torch_hybrid.py).

* Paged serving (block size 4, 3 lanes): two prompts sharing an 8-token
  prefix (shared blocks), a chunked 30-token prompt past the window (its
  lane starts from the pristine recurrent state; the chunk pass freezes
  the others), and prompts past the window, for smoke recurrentgemma-2b
  (smoke gemma3-12b, whose local and global layers share one block
  table, is in tests/test_torch_hybrid_paged_gemma3.py, so the two JAX
  references run on separate workers): streams and the scheduler's
  counters equal to JAX's.
* Speculative rounds through the block tables (spec_k 3, draft bits 7):
the streams and ``accepted_hist`` equal to JAX's (the round restores the
recurrent state its draft advanced; the pool's draft slots come back
from their copies)."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro.serve.engine import Request as JaxRequest  # noqa: E402
from test_torch_hybrid import engines, requests  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402

PAGED = dict(max_len=48, batch_size=3, paged=True, kv_block_size=4,
             chunk_prefill_tokens=24)
LENS = (12, 14, 30, 5, 20)
PREFIX = 8
COUNTERS = ("decode_steps", "decode_tokens", "admissions", "prefill_tokens", "chunk_steps",
            "chunked_requests", "cow_splits", "prefix_hit_blocks", "block_peak_used",
            "block_bytes", "kv_bytes_per_token")


def _serve_both(name, **scfg):
    jeng, eng = engines(name, **scfg)
    jout = jeng.serve(requests(LENS, JaxRequest, prefix=PREFIX))
    out = eng.serve(requests(LENS, prefix=PREFIX))
    _streams_match(jout, out, jeng, requests(LENS, prefix=PREFIX))
    return jeng.last_stats, eng.last_stats


def check_paged_serve(name):
    jst, st = _serve_both(name, **PAGED)
    for key in COUNTERS:
        assert st[key] == jst[key], (key, st[key], jst[key])
    assert st["prefix_hit_blocks"] > 0 and st["chunk_steps"] > 0
    assert st["blocks_in_use_at_exit"] == 0


@pytest.mark.parametrize("name", ["recurrentgemma-2b"])
def test_paged_serve_matches_jax(name):
    check_paged_serve(name)


def test_speculative_paged_serve_matches_jax():
    jst, st = _serve_both("recurrentgemma-2b", spec_k=3, spec_draft_bits=7, **PAGED)
    for key in ("accepted_hist", "spec_rounds", "mean_accepted"):
        assert st[key] == jst[key], key
