"""Paged serving of smoke gemma3-12b against the JAX ``Engine``, on the
CPU, at ``window=16`` and packed "precise": its local (S_c 16) and
global (S_c 48) layers share one block table (one entry spans
``block_size`` ring slots of every KV layer, so the local layers read
the first window / block_size entries).  The traffic and the checks are
tests/test_torch_hybrid_paged.py's: shared prefix blocks, a chunked
prompt past the window, streams and the scheduler's counters equal to
JAX's."""
import pytest

pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from test_torch_hybrid_paged import check_paged_serve  # noqa: E402


@pytest.mark.parametrize("name", ["gemma3-12b"])
def test_paged_serve_matches_jax(name):
    check_paged_serve(name)
