"""The port's dense serving engine on the MoE family against the JAX
``Engine``, on the CPU: smoke mixtral-8x7b at ``window=8`` (as the JAX
tests run it: prompts and decodes wrap the ring), packed "precise" (JAX
through dsbp_ref, the port through dsbp_fused), greedy, at pinned prompt
seeds.  Every engine serves the one packed pair that
tests/test_torch_moe.py builds once per process.

* Ragged ``generate`` and the dense ``serve`` scheduler (tests/test_serving.py
  :44-63, the mixtral cases): equal streams.
* The kv8 cache: serving over the packed cache equals serving over a float
  cache whose every write goes through quantize -> dequantize, logits bit
  for bit (tests/test_kvq.py:254); the kv8 streams and KV bytes per token
  equal to JAX's.
* Speculative rounds (spec_k 3) at draft bits 7 and 4 (the draft reads
  the expert stacks' MSB-slice views): streams, ``accepted_hist``,
  rounds and mean acceptance equal to JAX's (tests/test_spec.py).
* A window shorter than ``spec_k`` is refused as JAX refuses it
  (tests/test_spec.py:416).

The paged scheduler on the same pair is in tests/test_torch_moe_paged.py,
so the two files' JAX engines run on separate workers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_hybrid import prompts, requests  # noqa: E402
from test_torch_moe import moe_pair, packed_moe_pair  # noqa: E402
from test_torch_paged import _streams_match  # noqa: E402

SERVE_LENS = (6, 14, 10, 12, 9)
DENSE = dict(max_len=32, batch_size=2, prefill_bucket=8)


def port_engine(**scfg):
    """The port's engine over the packed pair's model."""
    return Engine(packed_moe_pair()[2], ServeConfig(**scfg), device="cpu")


def engines(**scfg):
    """JAX and port engines over the packed pair."""
    jcfg, params, _ = packed_moe_pair()
    jeng = JaxEngine(params, jcfg, JaxServeConfig(quant_method="dsbp_ref", **scfg))
    return jeng, port_engine(**scfg)


def serve_both(lens=SERVE_LENS, new=6, **scfg):
    """Both engines' serves of the same requests, streams held equal:
    (JAX stats, the port's stats, the port's streams, the port's engine)."""
    jeng, eng = engines(**scfg)
    jout = jeng.serve(requests(lens, JaxRequest, new=new))
    out = eng.serve(requests(lens, new=new))
    _streams_match(jout, out, jeng, requests(lens, new=new))
    return jeng.last_stats, eng.last_stats, out, eng


def test_generate_and_dense_serve_match_jax():
    jeng, eng = engines(**DENSE)
    # 2 attn_local layers of 4 projections and 3 expert stacks each
    assert sum(isinstance(m, PackedDSBPWeight) for m in eng.model.modules()) == 7 * 2
    lens = np.asarray([14, 6, 10], np.int32)
    toks = prompts(lens)
    np.testing.assert_array_equal(eng.generate(toks, 6, lengths=lens),
                                  jeng.generate(toks, 6, lengths=lens))
    jst, st, _, _ = serve_both(**DENSE)
    for key in ("decode_steps", "decode_tokens", "admissions", "prefill_tokens"):
        assert st[key] == jst[key], key


def test_kv8_serving_equals_its_qdq_oracle_and_jax(monkeypatch):
    from repro_torch.kvq import KV_PRESETS, PackedKVBlock, quantize_kv
    from repro_torch.models import blocks as TB

    jst, st, packed_out, eng = serve_both(kv_quant="kv8", **DENSE)
    assert st["kv_packed"] and jst["kv_packed"]
    assert st["kv_bytes_per_token"] == jst["kv_bytes_per_token"]
    lens = np.asarray([14, 6, 10], np.int32)
    toks = torch.from_numpy(prompts(lens, seed=4))
    steps = np.random.default_rng(5).integers(0, 512, (len(lens), 3))

    def run(kv):
        logits = []
        with torch.inference_mode():
            lg, cache, _ = eng.model.prefill(toks, 32, lengths=lens, quant=eng.quant, kv=kv)
            for t in range(steps.shape[1]):
                logits.append(lg)
                lg, cache = eng.model.decode_step(torch.from_numpy(steps[:, t:t + 1]), cache,
                                                  torch.from_numpy(lens + t), eng.quant)
        return logits + [lg]

    packed_logits = run("kv8")
    real = TB.quantize_like

    def qdq(cache_leaf, fresh):
        if not isinstance(cache_leaf, PackedKVBlock):
            return quantize_kv(fresh, KV_PRESETS["kv8"]).dequantize()
        return real(cache_leaf, fresh)

    monkeypatch.setattr(TB, "quantize_like", qdq)
    for a, b in zip(packed_logits, run(None)):
        assert torch.equal(a, b), float((a - b).abs().max())
    oracle_out = port_engine(**DENSE).serve(requests(SERVE_LENS, new=6))
    for uid in packed_out:
        np.testing.assert_array_equal(packed_out[uid], oracle_out[uid])


@pytest.mark.parametrize("draft_bits", [7, 4])
def test_speculative_dense_serve_matches_jax(draft_bits):
    jst, st, _, _ = serve_both(spec_k=3, spec_draft_bits=draft_bits, **DENSE)
    for key in ("accepted_hist", "spec_rounds", "mean_accepted"):
        assert st[key] == jst[key], key


def test_spec_k_past_the_window_is_refused_as_jax():
    jcfg, params, model = moe_pair(window=2)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(params, jcfg, JaxServeConfig(max_len=64, spec_k=2))
    with pytest.raises(ValueError) as terr:
        Engine(model, ServeConfig(max_len=64, spec_k=2), device="cpu")
    assert str(terr.value) == str(jerr.value)
