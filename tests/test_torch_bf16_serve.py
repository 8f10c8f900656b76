"""The port's engine serving bfloat16 models against the JAX model, on the
CPU, at smoke size.

The oracle is the JAX model's own cached path (``prefill`` then
``decode_step``, jitted, as the JAX engine runs it) teacher-forced on the
port's tokens: at every step the port's greedy token must be the JAX
argmax, or within ``TIE_ULPS`` bf16 ulps of max|logit| of it (a near tie
of the reference).  bf16 logits make ties and one-ulp near ties common,
and the two packages round at other places (tests/test_torch_bf16.py):
on float weights the port's token sat at most 4 ulps below the JAX max
over the cases here, on packed weights at most 18 (recurrentgemma-2b:
an activation one ulp apart crosses an FP8 rounding boundary); the JAX
engine's own tokens sit up to 10 ulps below its sequence-mode forward's
max on packed recurrentgemma-2b and mixtral-8x7b.  Hence 8 ulps on float
weights and 32 on packed ones.  Checking the port's tokens step by step
(not only up to a first difference) keeps each step's check exact.

* ``generate`` (ragged prompts) of llama-7b-paper GQA and MHA, float and
  packed "precise", and of recurrentgemma-2b, gemma3-12b, mixtral-8x7b,
  mamba2-370m, musicgen-large (codebook frames) and llava-next-34b (image
  prefixes), packed: logits bf16, every token within the rule.
* llama-7b-paper packed: a kv8 ``generate`` against JAX's kv8 cached
  path; the paged ``serve`` (float pool, a chunked prompt) and a
  speculative ``serve`` (spec_k 2) against the float cached path.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from test_torch_bf16 import LENS, bf16_pair, inputs, jbatch, ulp  # noqa: E402

TIE_ULPS = {False: 8, True: 32}
N_NEW = 6
MAX_LEN = 48
J_PREFILL = jax.jit(JM.prefill, static_argnums=(2, 3, 5))
J_DECODE = jax.jit(JM.decode_step, static_argnums=(4,))


def _oracle(jcfg, params, toks, img, lens, out, kv=None) -> list:
    """The JAX cached path's logits (f32 numpy (B, V)) of each of the
    ``out.shape[1]`` steps, teacher-forced on the tokens ``out`` (B, n)
    (audio (B, n, K)) after the ragged prompts."""
    s_img = 0 if img is None else img.shape[1]
    lens = np.asarray(lens, np.int32) + s_img
    lg, cache, _ = J_PREFILL(params, jbatch(toks, img), jcfg, MAX_LEN, jnp.asarray(lens), kv)
    steps = [np.asarray(lg[:, -1]).astype(np.float32)]
    for t in range(out.shape[1] - 1):
        lg, cache = J_DECODE(params, {"tokens": jnp.asarray(out[:, t:t + 1])}, cache,
                             jnp.asarray(lens + t), jcfg)
        steps.append(np.asarray(lg[:, -1]).astype(np.float32))
    return steps


def _check(steps, out, k: int, tie: float, rows=None):
    """Each token of ``out`` (B, n[, K]) within ``tie`` ulps of the max of
    its step's logits (per codebook block of an audio head); ``rows``
    (B,) the steps of each row to check (default all)."""
    worst = 0.0
    for t, lg in enumerate(steps):
        for b in range(out.shape[0]):
            if rows is not None and t >= rows[b]:
                continue
            blocks = lg[b].reshape(k, -1) if k else lg[b][None]
            for blk, tok in zip(blocks, np.atleast_1d(out[b, t])):
                gap = (blk.max() - blk[tok]) / ulp(np.abs(blk).max())
                worst = max(worst, gap)
                assert gap <= tie, f"row {b} step {t}: token {tok} {gap} ulps below the max"
    return worst


def _engine(case, packed, **scfg):
    _, _, model = bf16_pair(case, packed)
    return Engine(TM.shared(model), ServeConfig(max_len=MAX_LEN, **scfg), device="cpu")


GENERATE = [("llama-gqa", False), ("llama-gqa", True), ("llama-mha", False),
            ("llama-mha", True), ("recurrentgemma-2b", True), ("gemma3-12b", True),
            ("mixtral-8x7b", True), ("mamba2-370m", True), ("musicgen-large", True),
            ("llava-next-34b", True)]


@pytest.mark.parametrize("case,packed", GENERATE,
                         ids=[f"{c}-{'packed' if p else 'float'}" for c, p in GENERATE])
def test_generate_follows_the_jax_cached_path(case, packed):
    jcfg, params, _ = bf16_pair(case, packed)
    eng = _engine(case, packed)
    toks, img = inputs(jcfg)
    out = eng.generate(toks, N_NEW, extra=None if img is None else {"image_embeds": img},
                       lengths=LENS)
    k = jcfg.n_codebooks
    assert out.shape == (len(LENS), N_NEW) + ((k,) if k else ())
    _check(_oracle(jcfg, params, toks, img, LENS, out), out, k, TIE_ULPS[packed])


def test_kv8_generate_follows_the_jax_kv8_cached_path():
    jcfg, params, _ = bf16_pair("llama-gqa", True)
    eng = _engine("llama-gqa", True, kv_quant="kv8")
    toks, _ = inputs(jcfg)
    out = eng.generate(toks, N_NEW, lengths=LENS)
    assert eng.kv_spec is not None
    _check(_oracle(jcfg, params, toks, None, LENS, out, kv="kv8"), out, 0, TIE_ULPS[True])


SERVE_LENS = (12, 5, 9, 21, 7)  # 21 > 4 * the bucket: a chunked paged prompt


def _requests(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, vocab, n), max_new_tokens=N_NEW)
            for i, n in enumerate(SERVE_LENS)]


@functools.lru_cache(maxsize=None)
def _serve(mode: str):
    jcfg, _, _ = bf16_pair("llama-gqa", True)
    scfg = dict(batch_size=2, prefill_bucket=4)
    if mode == "paged":
        scfg.update(paged=True, kv_block_size=4)
    else:
        scfg.update(spec_k=2)
    eng = _engine("llama-gqa", True, **scfg)
    return eng.serve(_requests(jcfg.vocab_size)), eng.last_stats


@pytest.mark.parametrize("mode", ["paged", "spec"])
def test_llama_serve_follows_the_jax_cached_path(mode):
    """Every request's stream, checked as a row of one teacher-forced
    ragged batch (float KV: a row's numerics do not depend on its batch)."""
    jcfg, params, _ = bf16_pair("llama-gqa", True)
    out, stats = _serve(mode)
    reqs = _requests(jcfg.vocab_size)
    assert sorted(out) == [r.uid for r in reqs]
    lens = np.asarray(SERVE_LENS, np.int32)
    toks = np.zeros((len(reqs), int(lens.max())), np.int64)
    emitted = np.zeros((len(reqs), N_NEW), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :len(r.tokens)] = r.tokens
        assert len(out[r.uid]) == N_NEW
        emitted[i] = out[r.uid]
    _check(_oracle(jcfg, params, toks, None, lens, emitted), emitted, 0, TIE_ULPS[True])
    if mode == "spec":
        assert sum(stats["accepted_hist"]) > 0
    else:
        assert stats["chunked_requests"] >= 1
