"""The port's serving engine against the JAX engine, on the CPU.

Greedy tokens of ``Engine.generate`` on ragged prompts equal the JAX
``Engine``'s (quant_method 'dsbp_ref', which the JAX suite holds bit-exact
and token-equal to its fused kernel) for smoke llama-7b-paper (GQA) and
its MHA variant, float and packed "precise".  A row may stop being
compared at the step where the reference's own top-2 logit gap is below
the logit tolerance (1e-3 · max|logit|, tests/test_torch_model.py): there
the two argmaxes are a near tie, not a fault.  Plus the ``serve`` slot
scheduler, sampling determinism, the no-silent-CPU rule and the copied
configs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from test_torch_model import LENS, VARIANTS, _prompts, make_pair  # noqa: E402

TIE = 1e-3
N_NEW = 6


def _near_tie(params, jcfg, prompt, emitted) -> bool:
    """The reference's top-2 gap where it chose emitted[-1] (teacher-forced
    over the prompt and the tokens before it) is below the tolerance."""
    seq = np.concatenate([prompt, emitted[:-1]])[None]
    lg = np.asarray(JM.forward(params, {"tokens": jnp.asarray(seq)}, jcfg))[0, -1]
    top2 = np.sort(lg)[-2:]
    return top2[1] - top2[0] < TIE * np.abs(lg).max()


def _assert_tokens_match(jtok, ttok, params, jcfg, prompts, lens):
    for b in range(jtok.shape[0]):
        diff = np.flatnonzero(jtok[b] != ttok[b])
        if diff.size:
            t = int(diff[0])
            assert _near_tie(params, jcfg, prompts[b, :lens[b]], jtok[b, :t + 1]), (
                f"row {b} diverges at step {t}: {jtok[b]} vs {ttok[b]}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_generate_tokens_match_jax_engine(variant, packed):
    jcfg, params, model = make_pair(variant, packed=False)  # engines pack
    if packed:
        jcfg = jcfg.replace(quant="precise")
        model.cfg = model.cfg.replace(quant="precise")
    prompts = _prompts(jcfg.vocab_size, seed=2)
    jeng = JaxEngine(params, jcfg, JaxServeConfig(max_len=32, quant_method="dsbp_ref"))
    jtok = jeng.generate(prompts, N_NEW, lengths=LENS)
    eng = Engine(model, ServeConfig(max_len=32), device="cpu")
    assert (eng.pack_report is not None) == packed
    assert eng.cfg.quant_method == ("dsbp_fused" if packed else None)
    ttok = eng.generate(prompts, N_NEW, lengths=LENS)
    assert ttok.shape == (len(LENS), N_NEW)
    _assert_tokens_match(jtok, ttok, jeng.params, jeng.cfg, prompts, LENS)
    if packed:
        # the JAX count is per stacked leaf (one per projection name), the
        # port's per projection of every layer
        assert eng.pack_report["layers_packed"] == 7 * eng.cfg.n_layers
        assert jeng.pack_report["layers_packed"] == 7
        assert eng.pack_report["avg_w_bits"] == jeng.pack_report["avg_w_bits"]


def _engine(jax_too=False, batch_size=2, **scfg):
    """The port's packed engine on smoke llama-7b-paper (GQA), and with
    ``jax_too`` the JAX engine over the same weights."""
    jcfg, params, model = make_pair("gqa", packed=False)
    model.cfg = model.cfg.replace(quant="precise")
    eng = Engine(model, ServeConfig(max_len=32, batch_size=batch_size, **scfg),
                 device="cpu")
    if not jax_too:
        return eng
    jeng = JaxEngine(params, jcfg.replace(quant="precise"), JaxServeConfig(
        max_len=32, batch_size=batch_size, quant_method="dsbp_ref", **scfg))
    return jeng, eng


def _requests(vocab, lens=(5, 11, 8, 3, 9), budgets=(4, 2, 5, 3, 4), cls=Request):
    rng = np.random.default_rng(3)
    return [cls(uid=i, tokens=rng.integers(0, vocab, n), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, budgets))]


def test_serve_slot_reuse_and_budgets_match_jax():
    """5 requests through 2 slots: freed slots are refilled, every request
    stops at its own budget, and the streams equal the JAX scheduler's."""
    jeng, eng = _engine(jax_too=True)
    jout = jeng.serve(_requests(512, cls=JaxRequest))
    out = eng.serve(_requests(512))
    assert sorted(out) == list(range(5))
    for uid, r in enumerate(_requests(512)):
        assert len(out[uid]) == r.max_new_tokens
        np.testing.assert_array_equal(out[uid], jout[uid])
    st = eng.last_stats
    assert st["admissions"] == 5 and st["requests"] == 5
    assert st["decode_tokens"] == sum(len(t) - 1 for t in out.values())


def test_serve_matches_batch1_generate():
    """Slot reuse at batch 2 equals each prompt generated alone."""
    eng = _engine()
    reqs = _requests(512, budgets=(4,) * 5)
    out = eng.serve(reqs)
    for r in reqs:
        alone = eng.generate(r.tokens[None], 4)
        np.testing.assert_array_equal(out[r.uid], alone[0])


def test_serve_eos_frees_slot_early():
    eng = _engine()
    reqs = _requests(512, budgets=(6,) * 5)
    free_run = eng.serve(reqs)
    eos = int(free_run[0][1])  # request 0's second token
    eng = _engine(eos_id=eos)
    out = eng.serve(reqs)
    assert out[0].tolist() == free_run[0][:2].tolist()
    for uid, toks in out.items():  # every stream ends at its first EOS
        stop = np.flatnonzero(free_run[uid] == eos)
        n = int(stop[0]) + 1 if stop.size else 6
        assert toks.tolist() == free_run[uid][:n].tolist()


def test_temperature_sampling_is_deterministic():
    def run(seed):
        eng = _engine(temperature=1.0, seed=seed)
        return eng.generate(_prompts(512, seed=2), N_NEW, lengths=LENS)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke_config("llama-7b-paper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init(cfg)
    model = TM.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, ServeConfig())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_copied_configs_equal_jax(arch):
    for get in ("get_config", "smoke_config"):
        jc = dataclasses.asdict(getattr(jax_configs, get)(arch))
        tc = dataclasses.asdict(getattr(configs, get)(arch))
        assert tc == jc
    jc, tc = jax_configs.get_config(arch), configs.get_config(arch)
    for prop in ("n_units", "tail", "padded_vocab_size"):
        assert getattr(tc, prop) == getattr(jc, prop)
