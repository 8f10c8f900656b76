"""grok-1-314b, the eleventh config, in the port against the JAX package,
on the CPU.

grok is a plain MoE decoder (8 experts, top-2, ``attn_full``, no window),
so the port's MoE path serves it.  Smoke grok (2 layers, 4 experts,
d_model 128) from JAX's weights, carried over by ``repro_torch.bridge``:

* ``Engine.generate`` on two ragged prompt sets equals the JAX ``Engine``'s
  greedy tokens, with float weights and packed "precise" (JAX through
  'dsbp_ref', the port through 'dsbp_fused'), token for token;
* the launcher refuses full-size grok (~346 GB packed) before it draws a
  weight, naming ROADMAP A13 and the packed size against the card's
  memory.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_model import np_tree  # noqa: E402

ARCH = "grok-1-314b"
N_NEW = 6
# two ragged prompt sets: (lengths, prompt seed)
PROMPT_SETS = [((14, 6, 10), 3), ((5, 17, 9, 12), 4)]


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, 512, n)
    return toks, np.asarray(lens, np.int32)


def test_smoke_grok_is_a_full_attention_moe_decoder():
    cfg = smoke_config(ARCH)
    assert (cfg.family, cfg.pattern, cfg.window) == ("moe", ("attn_full",), 0)
    assert (cfg.n_layers, cfg.n_experts, cfg.top_k) == (2, 4, 2)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.d_ff,
            full.n_experts, full.vocab_size) == (64, 6144, 48, 8, 32768, 8, 131_072)


@pytest.mark.parametrize("lens,seed", PROMPT_SETS, ids=["3-rows", "4-rows"])
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_generate_tokens_equal_jax(packed, lens, seed):
    quant = "precise" if packed else None
    jcfg = jax_smoke_config(ARCH).replace(remat=False, quant=quant)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.model_from_jax(np_tree(params), smoke_config(ARCH).replace(quant=quant),
                                  device="cpu")
    jeng = JaxEngine(params, jcfg, JaxServeConfig(max_len=32, quant_method="dsbp_ref"))
    eng = Engine(model, ServeConfig(max_len=32), device="cpu")
    assert eng.cfg.quant_method == ("dsbp_fused" if packed else None)
    if packed:  # 4 attention projections and 3 expert stacks per layer
        assert sum(isinstance(m, PackedDSBPWeight) for m in eng.model.modules()) == 7 * 2
    toks, lens = _prompts(lens, seed)
    got = eng.generate(toks, N_NEW, lengths=lens)
    assert got.shape == (len(lens), N_NEW)
    np.testing.assert_array_equal(got, jeng.generate(toks, N_NEW, lengths=lens))


def test_launcher_refuses_full_size_grok_before_drawing(monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("the launcher drew a model")

    monkeypatch.setattr(TM, "init", no_draw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--packed", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as ei:
        launcher.main()
    msg = str(ei.value)
    assert f"{launcher.packed_nbytes(get_config(ARCH)) / 1e9:.1f} GB packed" in msg
    assert f"{launcher.H100_BYTES / 1e9:.1f} GB" in msg
    assert launcher.packed_nbytes(get_config(ARCH)) > 300e9


def test_launcher_packed_sizes_match_the_streamed_init():
    """The launcher's estimate against init(pack=)'s bytes at smoke size,
    within 3%: the norms and routers it leaves out are 1.9% there, far
    less at full width."""
    from repro_torch.serve.engine import _nbytes

    cfg = smoke_config(ARCH)
    got = _nbytes(TM.init(cfg, seed=0, device="cpu", pack="precise"))
    assert abs(got - launcher.packed_nbytes(cfg)) < 0.03 * got
