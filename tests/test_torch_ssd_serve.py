"""The port's serving engines on the Mamba-2 SSD family against the JAX
``Engine``, on the CPU: smoke mamba2-370m, float and packed "precise"
(JAX through dsbp_ref, the port through dsbp_fused), the weights of
tests/test_torch_ssd.py.

* Greedy ``generate`` (ragged) and the dense ``serve`` scheduler (state
  rows scatter like K/V rows), float and packed, token-equal to JAX's
  (PROMPT_SEED pinned, as JAX's PARITY_SEEDS are).
* The paged scheduler on a model with no KV layer: no allocator, no
  prefix cache, ``kv_blocks`` 0, chunks of ``prefill_bucket`` tokens;
  token-equal to the dense serve and to JAX's paged serve on the scenario
  of JAX tests/test_paged.py::test_paged_parity_float, with a chunked
  prompt.
* Speculative serving (spec_k 3, draft bits 4) dense and paged equal to
  spec_k 0 and to JAX's on JAX tests/test_spec.py::
  test_spec_serving_token_parity's mamba2 case, with JAX's accepted_hist.
* A kv8 ``ServeConfig`` is accepted and serves what the float cache
  serves (there is nothing to quantize), dense and paged.
* ``score_continuations`` within 1e-5 of max|score| of JAX's."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_model import np_tree  # noqa: E402
from test_torch_ssd import ARCH, jax_smoke_config, smoke_config  # noqa: E402

PROMPT_SEED = 1   # pinned: token-equal in every engine configuration here
PAGED_LENS = (5, 11, 8, 6, 40, 9)  # 40 > 4 * bucket: a chunked prompt
SPEC_LENS = (5, 11, 8, 3, 14)


@functools.lru_cache(maxsize=None)
def _jax_pair(packed: bool):
    """(JAX cfg, JAX params), packed "precise" or float."""
    jcfg = jax_smoke_config(ARCH).replace(remat=False, quant="precise" if packed else None)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    if packed:
        params, _ = jax_pack(params, "precise")
    return jcfg, params


def _port_model(packed: bool):
    """A fresh port model over the JAX pair's weights (an engine takes its
    model over)."""
    jcfg, params = _jax_pair(packed)
    cfg = smoke_config(ARCH).replace(quant=jcfg.quant)
    return bridge.model_from_jax(np_tree(params), cfg, device="cpu")


def engines(packed=True, **scfg):
    jcfg, params = _jax_pair(packed)
    jeng = JaxEngine(params, jcfg, JaxServeConfig(
        quant_method="dsbp_ref" if packed else None, **scfg))
    return jeng, Engine(_port_model(packed), ServeConfig(**scfg), device="cpu")


def _reqs(lens, seed=PROMPT_SEED, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)) for n in lens]


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_generate_and_dense_serve_match_jax(packed):
    """A ragged generate (prompts padded to 48: one chunk of 48) and a
    dense serve of 5 requests through 2 slots, token-equal to JAX's."""
    jeng, eng = engines(packed, max_len=64, batch_size=2, prefill_bucket=8)
    if packed:  # w_in and w_out of both layers, packed once
        assert sum(isinstance(m, type(eng.model.layers[0].ssd.w_in))
                   for m in eng.model.modules()) == 4
    lens = np.asarray([40, 17, 33], np.int32)
    toks = np.zeros((3, 48), np.int64)
    for j, t in enumerate(_reqs(lens)):
        toks[j, :len(t)] = t
    np.testing.assert_array_equal(eng.generate(toks, 6, lengths=lens),
                                  jeng.generate(toks, 6, lengths=lens))
    reqs = _reqs(SPEC_LENS, seed=2)
    _same(eng.serve(reqs, max_new_tokens=6), jeng.serve(reqs, max_new_tokens=6))
    for key in ("decode_steps", "decode_tokens", "admissions", "kv_bytes_per_token"):
        assert eng.last_stats[key] == jeng.last_stats[key], key
    assert eng.last_stats["kv_bytes_per_token"] == 0


def test_paged_serve_without_a_pool_matches_dense_and_jax():
    """JAX test_paged_parity_float's scenario (2 lanes, max_len 32,
    bucket 8, blocks of 4) plus a 40-token prompt past the chunk threshold
    (4 * bucket): paged == dense == JAX's paged serve, with no allocator,
    ``kv_blocks`` 0 and no stalled decode step."""
    reqs = _reqs(PAGED_LENS, seed=1)
    base = dict(batch_size=2, max_len=56, prefill_bucket=8)
    jeng, dense = engines(packed=False, **base)
    od = dense.serve(reqs, max_new_tokens=8)
    _, paged = engines(packed=False, paged=True, kv_block_size=4, **base)
    op = paged.serve(reqs, max_new_tokens=8)
    _same(od, op)
    jpaged = JaxEngine(jeng.params, jeng.cfg, JaxServeConfig(paged=True, kv_block_size=4,
                                                             **base))
    _same(op, jpaged.serve(reqs, max_new_tokens=8))
    st, jst = paged.last_stats, jpaged.last_stats
    assert st["paged"] and st["kv_blocks"] == jst["kv_blocks"] == 0
    assert paged._last_alloc is None and paged._last_prefix is None
    assert st["stalled_decode_steps"] == 0 and st["block_peak_used"] == 0
    assert st["chunked_requests"] == jst["chunked_requests"] == 1
    for key in ("decode_steps", "chunk_steps", "admissions", "prefill_tokens"):
        assert st[key] == jst[key], key


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_serve_matches_spec_k0_and_jax(paged):
    """JAX test_spec_serving_token_parity's mamba2 case (packed "precise",
    max_len 64, 2 slots, spec_k 3 at draft bits 4): the speculative
    streams equal the spec_k 0 streams and JAX's, with JAX's accepted_hist
    and rounds."""
    reqs = _reqs(SPEC_LENS, seed=0)
    pg = dict(paged=True, kv_block_size=4) if paged else {}
    jbase, base = engines(max_len=64, batch_size=2, **pg)
    out_b = base.serve(reqs, max_new_tokens=6)
    spec_kw = dict(max_len=64, batch_size=2, spec_k=3, spec_draft_bits=4, **pg)
    jspec, spec = engines(**spec_kw)
    out_s = spec.serve(reqs, max_new_tokens=6)
    _same(out_b, out_s)
    _same(out_s, jspec.serve(reqs, max_new_tokens=6))
    st, jst = spec.last_stats, jspec.last_stats
    for key in ("accepted_hist", "spec_rounds", "mean_accepted", "decode_tokens"):
        assert st[key] == jst[key], key
    assert st["decode_tokens"] == base.last_stats["decode_tokens"]
    if not paged:
        _same(out_b, jbase.serve(reqs, max_new_tokens=6))


def test_kv8_config_serves_what_float_serves():
    """kv8 on a model with no KV layer: accepted, nothing quantized (no
    packed leaf, 0 KV bytes per token), the float cache's tokens, dense
    and paged."""
    reqs = _reqs(SPEC_LENS, seed=3)
    for pg in ({}, dict(paged=True, kv_block_size=4)):
        base = dict(max_len=64, batch_size=2, **pg)
        outs = {}
        for kv in (None, "kv8"):
            eng = Engine(_port_model(True), ServeConfig(kv_quant=kv, **base), device="cpu")
            outs[kv] = eng.serve(reqs, max_new_tokens=6)
            assert not eng.last_stats["kv_packed"] and eng.last_stats["kv_bytes_per_token"] == 0
        assert eng.kv_spec is not None
        _same(outs[None], outs["kv8"])


def test_score_continuations_match_jax():
    """Sums of continuation log-probs (sequences padded to one bucket of
    32) within 1e-5 of max|score| of JAX's, float and packed."""
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 512, n) for n in (20, 9, 31, 14)]
    plens = [12, 3, 20, 13]
    for packed in (False, True):
        jeng, eng = engines(packed, max_len=64, batch_size=2, prefill_bucket=32)
        want = np.asarray(jeng.score_continuations(seqs, plens))
        got = eng.score_continuations(seqs, plens)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (got, want)
