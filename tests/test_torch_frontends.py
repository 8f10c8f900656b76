"""The two modality frontends in the port against the JAX package, on the
CPU: the model (``repro_torch.models.model``), its bridge and its init.

Configs: smoke musicgen-large (``audio_codebooks``: K=4 codebooks of a
512 vocab, the embedding and the head 4 * 512 rows wide) and a
``vocab_size=500`` variant, whose every codebook block pads to 512; smoke
llava-next-34b (``vlm_patches``: 16 image tokens prepended) and its
``vocab_size=500`` variant.  JAX weights are carried into the port by
``repro_torch.bridge``; inputs are numpy from a seed, image embeddings
standard normal as JAX's tests draw them.

* Configs: ``n_codebooks``, ``n_image_tokens``, ``padded_vocab_size`` and
  ``param_count`` (its audio term) equal JAX's, full and smoke, and
  ``param_count`` of every config the port copies.
* ``embed_tokens`` (K rows summed at offsets ``k * Vp``; the image prefix
  in front), ``forward`` logits and the pad columns of every codebook
  block against JAX ``M.forward``: within 1e-6 / 1e-5 of max|ref| (float
  weights; the frameworks sum in other orders), -1e30 where JAX masks.
* Packed "precise" forward within 1e-3 of max|logit| (the FP8 input
  roundings, as tests/test_torch_model.py).
* Ragged ``prefill`` (lengths count embedded positions) and
  ``decode_step`` with (B, 1, K) codebook steps against ``M.prefill`` /
  ``M.decode_step`` within 1e-5; a prompt's last token decoded equals the
  prefill over it within 1e-4 (JAX tests/test_arch_smoke.py::
  test_smoke_prefill_decode_consistency); ``verify_step`` against JAX's
  within 2e-5.
* The bridge carries the wider ``embed`` / ``lm_head`` exactly; ``init``
  draws them at JAX's fan-in d; ``init(pack=)`` equals ``init`` followed by
  ``pack_weights_int8`` bit for bit.
* ``sample_tokens`` per codebook (greedy: the first maximum of each block,
  as JAX's; sampled: (B, K) from one generator, seeded).
* Refusals, as JAX's: ``serve`` (dense and paged) and
  ``score_continuations`` with JAX's own messages, calibration and KV
  calibration; a mesh names ROADMAP A13 (bfloat16 frontends are served:
  tests/test_torch_bf16.py).
* The launcher: 3-D audio prompts and seeded image embeddings through
  ``generate``, and the serve-only flags refused."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import (Engine, ServeConfig, pack_weights_int8,  # noqa: E402
                                      sample_tokens)
from test_torch_model import np_tree  # noqa: E402

J_FORWARD = jax.jit(JM.forward, static_argnums=(2,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JM.decode_step, static_argnums=(4,))
J_VERIFY = jax.jit(JM.verify_step, static_argnums=(4,))

ARCHS = ["musicgen-large", "llava-next-34b"]
VOCABS = {"vocab512": {}, "vocab500": {"vocab_size": 500}}
CASES = [(a, v) for a in ARCHS for v in VOCABS]
CASE_IDS = [f"{a}-{v}" for a, v in CASES]
LENS = np.asarray([12, 5, 9], np.int32)


@functools.lru_cache(maxsize=None)
def pair(arch, variant="vocab512", packed=False):
    """(JAX cfg, JAX params, port model) over the same weights; packed
    "precise" on both sides when ``packed`` (the port's model is fresh:
    callers that hand it to an Engine take it over)."""
    kw = dict(VOCABS[variant], quant="precise" if packed else None)
    jcfg = jax_configs.smoke_config(arch).replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.model_from_jax(np_tree(params), smoke_config(arch).replace(**kw),
                                  device="cpu")
    if packed:
        params, _ = JE.pack_weights_int8(params, "precise")
        pack_weights_int8(model, "precise")
        model.cfg = model.cfg.replace(quant_method="dsbp_fused")
        jcfg = jcfg.replace(quant_method="dsbp_ref")
    return jcfg, params, model


def inputs(cfg, lens=LENS, seed=0):
    """Right-padded prompts ((B, L) text or (B, L, K) codebook ids) and,
    for a vlm config, (B, S_img, d) standard-normal image embeddings."""
    rng = np.random.default_rng(seed)
    shape = (len(lens), int(max(lens))) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    toks = np.zeros(shape, np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, cfg.vocab_size, (n,) + shape[2:])
    img = None
    if cfg.frontend == "vlm_patches":
        img = rng.standard_normal((len(lens), cfg.n_image_tokens, cfg.d_model)).astype(
            np.float32)
    return toks, img


def jbatch(toks, img):
    batch = {"tokens": jnp.asarray(toks)}
    if img is not None:
        batch["image_embeds"] = jnp.asarray(img)
    return batch


def timg(img):
    return None if img is None else torch.from_numpy(img)


def _close(j, t, rel):
    j = np.asarray(j)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    err = np.abs(j - t).max()
    assert err <= rel * np.abs(j).max(), (err, np.abs(j).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_config_fields_match_jax(arch):
    for get in ("get_config", "smoke_config"):
        for kw in VOCABS.values():
            jc = getattr(jax_configs, get)(arch).replace(**kw)
            tc = getattr(configs, get)(arch).replace(**kw)
            for field in ("frontend", "n_codebooks", "n_image_tokens", "padded_vocab_size"):
                assert getattr(tc, field) == getattr(jc, field), (get, field)
            assert tc.param_count() == jc.param_count(), get
            assert TM._vocab_rows(tc) == JM._vocab_rows(jc)
    full = configs.get_config(arch)
    if full.frontend == "audio_codebooks":  # K embeddings and K heads of 2048 rows
        assert (full.n_codebooks, TM._vocab_rows(full)) == (4, 4 * 2048)
        assert smoke_config(arch).replace(vocab_size=500).padded_vocab_size == 512
    else:
        assert (full.n_image_tokens, smoke_config(arch).n_image_tokens) == (2880, 16)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_count_matches_jax(arch):
    assert configs.get_config(arch).param_count() == jax_configs.get_config(arch).param_count()
    assert (configs.smoke_config(arch).param_count()
            == jax_configs.smoke_config(arch).param_count())


# ---------------------------------------------------------------------------
# embedding, head, forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,variant", CASES, ids=CASE_IDS)
def test_embed_tokens_match_jax(arch, variant):
    jcfg, params, model = pair(arch, variant)
    toks, img = inputs(jcfg, seed=1)
    jx, jpos = JM.embed_tokens(params, jbatch(toks, img), jcfg)
    with torch.inference_mode():
        x, pos = model.embed_tokens(torch.from_numpy(toks), timg(img))
    _close(jx, x, 1e-6)
    np.testing.assert_array_equal(np.asarray(jpos), pos.numpy())
    if img is not None:  # the prefix is the image, as given
        np.testing.assert_array_equal(x[:, :img.shape[1]].numpy(), img)


@pytest.mark.parametrize("arch,variant", CASES, ids=CASE_IDS)
def test_forward_and_pad_masks_match_jax(arch, variant):
    jcfg, params, model = pair(arch, variant)
    toks, img = inputs(jcfg, seed=2)
    jl = np.asarray(J_FORWARD(params, jbatch(toks, img), jcfg))
    with torch.inference_mode():
        tl = model.forward(torch.from_numpy(toks), image_embeds=timg(img))
    assert tl.shape[-1] == TM._vocab_rows(model.cfg)
    valid = np.arange(tl.shape[-1]) % jcfg.padded_vocab_size < jcfg.vocab_size
    assert valid.sum() == jcfg.vocab_size * max(jcfg.n_codebooks, 1)
    np.testing.assert_array_equal(tl.numpy()[..., ~valid], jl[..., ~valid])
    assert (tl.numpy()[..., ~valid] == TM.NEG_INF).all()
    _close(jl[..., valid], tl.numpy()[..., valid], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_forward_matches_jax(arch):
    jcfg, params, model = pair(arch, packed=True)
    toks, img = inputs(jcfg, seed=3)
    jl = np.asarray(J_FORWARD(params, jbatch(toks, img), jcfg))
    with torch.inference_mode():
        tl = model.forward(torch.from_numpy(toks), image_embeds=timg(img))
    _close(jl, tl, 1e-3)


# ---------------------------------------------------------------------------
# prefill / decode / verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,variant", CASES, ids=CASE_IDS)
def test_ragged_prefill_and_decode_match_jax(arch, variant):
    """Ragged prompts (a vlm row's length counts its image prefix), then
    three per-row decode steps of (B, 1) tokens or (B, 1, K) frames."""
    jcfg, params, model = pair(arch, variant)
    toks, img = inputs(jcfg, seed=4)
    lens = LENS + (jcfg.n_image_tokens if img is not None else 0)
    jl, jcache, jlen = J_PREFILL(params, jbatch(toks, img), jcfg, 48, lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, cache, tlen = model.prefill(torch.from_numpy(toks), 48, lengths=lens,
                                        image_embeds=timg(img))
    _close(jl, tl, 1e-5)
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    steps = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                              (3,) + toks.shape[:1] + (1,) + toks.shape[2:])
    pos = lens.copy()
    for step in steps:
        jl, jcache = J_DECODE(params, {"tokens": jnp.asarray(step)}, jcache,
                              jnp.asarray(pos), jcfg)
        with torch.inference_mode():
            tl, cache = model.decode_step(torch.from_numpy(step), cache, torch.from_numpy(pos))
        _close(jl, tl, 1e-5)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(arch):
    """The port's own prefill over L + 1 tokens against a prefill over L
    and one decode step (JAX test_smoke_prefill_decode_consistency): the
    last position's logits within 1e-4 of max|logit|."""
    _, _, model = pair(arch)
    cfg = model.cfg
    toks, img = inputs(cfg, lens=np.asarray([33, 33]), seed=0)
    with torch.inference_mode():
        full, _, _ = model.prefill(torch.from_numpy(toks), 64, image_embeds=timg(img))
        _, cache, length = model.prefill(torch.from_numpy(toks[:, :32]), 64,
                                         image_embeds=timg(img))
        dec, _ = model.decode_step(torch.from_numpy(toks[:, 32:33]), cache, length)
    scale = float(full.abs().max())
    assert float((dec[:, 0] - full[:, 0]).abs().max()) < 1e-4 * max(scale, 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_jax(arch):
    """Three tokens (frames) per row in one pass over a ragged prefill's
    cache, against JAX ``verify_step`` (2e-5 of max|logit|)."""
    jcfg, params, model = pair(arch)
    toks, img = inputs(jcfg, seed=6)
    lens = LENS + (jcfg.n_image_tokens if img is not None else 0)
    _, jcache, _ = J_PREFILL(params, jbatch(toks, img), jcfg, 48, lengths=jnp.asarray(lens))
    draft = np.random.default_rng(7).integers(0, jcfg.vocab_size, toks.shape[:1] + (3,)
                                              + toks.shape[2:])
    jl, _ = J_VERIFY(params, {"tokens": jnp.asarray(draft)}, jcache, jnp.asarray(lens), jcfg)
    with torch.inference_mode():
        _, cache, _ = model.prefill(torch.from_numpy(toks), 48, lengths=lens,
                                    image_embeds=timg(img))
        tl, _ = model.verify_step(torch.from_numpy(draft), cache, torch.from_numpy(lens))
    _close(jl, tl, 2e-5)


# ---------------------------------------------------------------------------
# bridge, init, packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_wide_embedding_and_head(arch):
    jcfg, params, model = pair(arch)
    rows = JM._vocab_rows(jcfg)
    assert tuple(model.embed.shape) == (rows, jcfg.d_model) == params["embed"].shape
    assert tuple(model.lm_head.shape) == (jcfg.d_model, rows) == params["lm_head"].shape
    np.testing.assert_array_equal(model.embed.detach().numpy(), np.asarray(params["embed"]))
    np.testing.assert_array_equal(model.lm_head.detach().numpy(),
                                  np.asarray(params["lm_head"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_embedding_and_head_at_fan_in_d(arch):
    cfg = smoke_config(arch)
    model = TM.init(cfg, seed=0, device="cpu")
    rows = TM._vocab_rows(cfg)
    assert tuple(model.embed.shape) == (rows, cfg.d_model)
    assert tuple(model.lm_head.shape) == (cfg.d_model, rows)
    for name in ("embed", "lm_head"):
        std = float(getattr(model, name).std())
        assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05, (name, std)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_init_equals_init_then_pack(arch):
    """``init(pack=)`` (drawn and packed one layer at a time) against
    ``init`` followed by ``pack_weights_int8``: every parameter, buffer and
    container bit for bit; the head and the embedding stay float."""
    cfg = smoke_config(arch)
    drawn = TM.init(cfg, seed=3, device="cpu")
    stats = pack_weights_int8(drawn, "precise")
    streamed = TM.init(cfg, seed=3, device="cpu", pack="precise")
    named = (list(drawn.named_parameters()) + list(drawn.named_buffers()),
             list(streamed.named_parameters()) + list(streamed.named_buffers()))
    assert [n for n, _ in named[0]] == [n for n, _ in named[1]]
    for (n, a), (_, b) in zip(*named):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    packed = [n for n, m in streamed.named_modules() if isinstance(m, PackedDSBPWeight)]
    assert len(packed) == stats["layers_packed"] == 7 * cfg.n_layers
    assert not isinstance(streamed.lm_head, PackedDSBPWeight)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_greedy_sampling_per_codebook_matches_jax():
    """(B, K * Vp) logits with planted ties: the first maximum of each
    codebook block, (B, K) tokens, as JAX ``sample_tokens``."""
    cfg = jax_configs.smoke_config("musicgen-large")
    k, vp = cfg.n_codebooks, cfg.padded_vocab_size
    lg = np.random.default_rng(8).standard_normal((3, k * vp)).astype(np.float32)
    lg[0, 5] = lg[0, 9] = lg[0].max() + 1  # a tie inside codebook 0
    lg[1, vp + 3] = lg[1, vp + 400] = 10.0  # and inside codebook 1
    want = np.asarray(JE.sample_tokens(jnp.asarray(lg), cfg))
    got = sample_tokens(torch.from_numpy(lg), n_codebooks=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (3, k) and got[0, 0] == 5 and got[1, 1] == 3


def test_sampled_codebooks_are_seeded_and_in_range():
    k, vp = 4, 512
    lg = torch.from_numpy(np.random.default_rng(9).standard_normal((3, k * vp)).astype(
        np.float32))

    def draw(seed):
        return sample_tokens(lg, 1.0, torch.Generator().manual_seed(seed), n_codebooks=k)

    a, b = draw(0), draw(0)
    assert a.shape == (3, k) and torch.equal(a, b)
    assert ((a >= 0) & (a < vp)).all()
    assert not torch.equal(draw(0), draw(1))
    out = torch.empty(3, k, dtype=torch.int64)
    assert sample_tokens(lg, 1.0, torch.Generator().manual_seed(0), out=out,
                         n_codebooks=k) is out and torch.equal(out, a)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _jax_message(call) -> str:
    with pytest.raises(NotImplementedError) as ei:
        call()
    return str(ei.value)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["serve", "serve_paged", "score_continuations"])
def test_engine_refuses_what_jax_refuses(arch, what):
    """``serve`` (both schedulers) and ``score_continuations`` raise with
    JAX's own message: ``generate`` is a frontend's whole serving
    surface."""
    jcfg, params, model = pair(arch)
    paged = what == "serve_paged"
    jeng = JE.Engine(params, jcfg, JE.ServeConfig(max_len=32, paged=paged, kv_block_size=4))
    eng = Engine(TM.shared(model), ServeConfig(max_len=32, paged=paged, kv_block_size=4),
                 device="cpu")
    seqs = [np.arange(6), np.arange(9)]
    if what == "score_continuations":
        calls = (lambda: jeng.score_continuations(seqs, [2, 3]),
                 lambda: eng.score_continuations(seqs, [2, 3]))
    else:
        calls = (lambda: jeng.serve(seqs, max_new_tokens=2),
                 lambda: eng.serve(seqs, max_new_tokens=2))
    want = _jax_message(calls[0])
    with pytest.raises(NotImplementedError) as ei:
        calls[1]()
    assert str(ei.value) == want and jcfg.frontend in want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["calibrate", "collect_kv_stats"])
def test_calibration_refuses_frontends_as_jax(arch, what):
    import importlib

    JC, JK, TC, TK = (importlib.import_module(f"{pkg}.policy.{mod}")
                      for pkg in ("repro", "repro_torch") for mod in ("calibrate", "kv_bits"))
    jcfg, params, model = pair(arch)
    batches = [np.zeros((2, 8), np.int64)]
    jfn, tfn = (JC.calibrate, TC.calibrate) if what == "calibrate" else (
        JK.collect_kv_stats, TK.collect_kv_stats)
    want = _jax_message(lambda: jfn(params, jcfg, batches))
    with pytest.raises(NotImplementedError) as ei:
        tfn(TM.shared(model), model.cfg, batches)
    assert str(ei.value) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_refuses_frontends_naming_a13(arch):
    model = TM.init(smoke_config(arch), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as ei:
        Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2)), device="cpu")
    assert f"the {model.cfg.frontend} frontend" in str(ei.value)


@pytest.mark.parametrize("entry", ["forward", "generate_ragged"])
def test_vlm_model_needs_image_embeds(entry):
    """Without ``image_embeds`` a vlm model names the missing input, from
    ``forward`` and from a ragged ``generate`` (which adds the image
    length to ``lengths`` first)."""
    jcfg, _, model = pair("llava-next-34b")
    with pytest.raises(ValueError, match="image_embeds"):
        if entry == "forward":
            model.forward(torch.zeros(1, 4, dtype=torch.int64))
        else:
            eng = Engine(TM.shared(model), ServeConfig(max_len=48), device="cpu")
            eng.generate(np.zeros((2, 6), np.int64), 2, lengths=[6, 3])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,flags,shape", [
    ("musicgen-large", ["--packed"], "(4, 3, 4)"),
    ("musicgen-large", ["--ragged", "--kv-quant", "kv8"], "(4, 3, 4)"),
    ("llava-next-34b", ["--packed", "--ragged"], "(4, 3)"),
    ("llama-7b-paper", ["--packed"], "(4, 3)"),
], ids=["audio-packed", "audio-ragged-kv8", "vlm-packed-ragged", "text-packed"])
def test_launcher_generates_through_the_frontend(arch, flags, shape, monkeypatch, capsys):
    """One ``generate`` path for every arch: a frontend's inputs, or a
    text model's (B, L) prompts (the frontend "none")."""
    from repro_torch.launch import serve as L

    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke", "--device", "cpu",
                                     "--prompt-len", "8", "--new-tokens", "3", *flags])
    L.main()
    out = capsys.readouterr().out
    assert f"generated {shape}" in out, out
    what = {"musicgen-large": "4 codebooks per frame", "llava-next-34b": "16 image tokens",
            "llama-7b-paper": "(prompt lens [8, 8, 8, 8])"}[arch]
    assert what in out


@pytest.mark.parametrize("flags", [["--paged"], ["--spec-k", "3"], ["--policy", "p.json"],
                                   ["--mesh", "1x2"], ["--observe"]],
                         ids=["paged", "spec_k", "policy", "mesh", "observe"])
def test_launcher_refuses_serve_only_flags(flags, monkeypatch, capsys):
    from repro_torch.launch import serve as L

    monkeypatch.setattr("sys.argv", ["serve", "--arch", "musicgen-large", "--smoke",
                                     "--device", "cpu", *flags])
    with pytest.raises(SystemExit):
        L.main()
    assert "Engine.generate only" in capsys.readouterr().err
