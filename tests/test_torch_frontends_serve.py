"""``Engine.generate`` of the two modality frontends against the JAX
``Engine.generate``, on the CPU: smoke musicgen-large ((B, L, K) codebook
prompts in, (B, n_new, K) frames out) and smoke llava-next-34b (16
standard-normal image embeddings per row in ``extra``, text ``lengths``
at the API), the weights of tests/test_torch_frontends.py.

* Greedy tokens EQUAL to JAX's, with ragged lengths, float and packed
  "precise" weights (JAX through dsbp_ref, the port through dsbp_fused),
  a float cache and kv8; and with uniform prompts (``lengths`` None).
  Prompt seeds are pinned (ROADMAP C, near ties), as the other port
  engine tests pin theirs.
* Temperature > 0: the same seed gives the same stream within the port,
  of the greedy shape and in range.
* A row served alone gives what it gives in the ragged batch (float
  weights: nothing couples the rows), so a vlm row's length counts its
  own image prefix.
* The launcher's frontend path (its 3-D audio prompts, seeded image
  embeddings, ragged lengths) gives JAX ``Engine.generate``'s tokens on
  the same weights and inputs (not JAX's launcher, which builds 2-D
  prompts and crashes on audio)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro.serve import engine as JE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_frontends import ARCHS, LENS, inputs, pair  # noqa: E402

N_NEW = 5
PROMPT_SEED = 11  # pinned: token-equal in every engine configuration here


@functools.lru_cache(maxsize=None)
def _jax_generate(arch, packed, kv, ragged, seed):
    jcfg, params, _ = pair(arch)
    jcfg = jcfg.replace(quant="precise" if packed else None)
    jeng = JE.Engine(params, jcfg, JE.ServeConfig(
        max_len=48, kv_quant=kv, quant_method="dsbp_ref" if packed else None))
    toks, img = inputs(jcfg, seed=seed)
    return jeng.generate(toks, N_NEW, extra=None if img is None else {"image_embeds": img},
                         lengths=LENS if ragged else None)


def _port(arch, packed=False, **scfg):
    """A port engine over the pair's float weights (it packs them when
    ``packed``, as the JAX engine does)."""
    _, _, model = pair(arch)
    model = TM.shared(model, model.cfg.replace(quant="precise" if packed else None))
    return Engine(model, ServeConfig(max_len=48, **scfg), device="cpu")


def _generate(eng, seed=PROMPT_SEED, lens=LENS, rows=slice(None)):
    toks, img = inputs(eng.cfg, seed=seed)
    extra = None if img is None else {"image_embeds": img[rows]}
    return eng.generate(toks[rows], N_NEW, extra=extra,
                        lengths=None if lens is None else lens[rows])


def _shape(arch, b=len(LENS)):
    cfg = pair(arch)[0]
    return (b, N_NEW) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
@pytest.mark.parametrize("kv", [None, "kv8"], ids=["float_kv", "kv8"])
def test_generate_matches_jax_engine(arch, packed, kv):
    eng = _port(arch, packed, kv_quant=kv)
    assert (eng.pack_report is not None) == packed
    assert eng.cfg.quant_method == ("dsbp_fused" if packed else None)
    out = _generate(eng)
    assert out.shape == _shape(arch)
    np.testing.assert_array_equal(out, _jax_generate(arch, packed, kv, True, PROMPT_SEED))


@pytest.mark.parametrize("arch", ARCHS)
def test_uniform_prompts_match_jax_engine(arch):
    """``lengths`` None: every row its full width (plus the image)."""
    out = _generate(_port(arch, packed=True), lens=None)
    np.testing.assert_array_equal(out, _jax_generate(arch, True, None, False, PROMPT_SEED))


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_generate_is_seeded(arch):
    def run(seed):
        return _generate(_port(arch, temperature=1.0, seed=seed))

    a = run(0)
    assert a.shape == _shape(arch)
    np.testing.assert_array_equal(a, run(0))
    assert ((a >= 0) & (a < pair(arch)[0].vocab_size)).all()
    assert not np.array_equal(a, run(1))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_row_alone_equals_its_row_in_the_batch(arch):
    """Float weights: row 1 (the shortest prompt) generated alone, its
    prompt cut to its length, equals row 1 of the ragged batch."""
    eng = _port(arch)
    batch = _generate(eng)
    toks, img = inputs(eng.cfg, seed=PROMPT_SEED)
    n = int(LENS[1])
    alone = eng.generate(toks[1:2, :n], N_NEW,
                         extra=None if img is None else {"image_embeds": img[1:2]})
    np.testing.assert_array_equal(alone[0], batch[1])


def test_generate_rejects_unknown_extra_inputs():
    eng = _port("llava-next-34b")
    toks, img = inputs(eng.cfg)
    with pytest.raises(ValueError, match="image_embeds"):
        eng.generate(toks, 2, extra={"image_embeds": img, "audio": img}, lengths=LENS)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_generate_equals_jax_engine(arch, monkeypatch, capsys):
    """The launcher's frontend path (its prompts, image embeddings and
    ragged lengths, through ``Engine.generate``) held to JAX's
    ``Engine.generate`` on the same weights and inputs: the launcher
    draws its model through ``M.init``, which serves the pair's float
    weights here."""
    from repro_torch.launch import serve as L

    jcfg, params, model = pair(arch)
    seen = {}
    monkeypatch.setattr(L.M, "init", lambda cfg, **kw: TM.shared(model, cfg))
    real = Engine.generate

    def spy(self, prompts, n_new, extra=None, lengths=None):
        out = real(self, prompts, n_new, extra=extra, lengths=lengths)
        seen.update(prompts=prompts, n_new=n_new, extra=extra, lengths=lengths, out=out)
        return out

    monkeypatch.setattr(Engine, "generate", spy)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke", "--device", "cpu",
                                     "--ragged", "--prompt-len", "8", "--new-tokens", "4"])
    L.main()
    capsys.readouterr()
    jeng = JE.Engine(params, jcfg, JE.ServeConfig(max_len=8 + jcfg.n_image_tokens + 4 + 8))
    want = jeng.generate(seen["prompts"], seen["n_new"], extra=seen["extra"],
                         lengths=seen["lengths"])
    assert seen["out"].shape == (4, 4) + _shape(arch)[2:]
    np.testing.assert_array_equal(seen["out"], want)
