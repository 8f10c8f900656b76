"""Training beyond the dense family, the port against the JAX package on
the CPU: ``loss_fn`` and every parameter's gradient of the Griffin hybrid
(smoke recurrentgemma-2b: two (rglru, rglru, attn_local) units and a
two-layer rglru tail, window 8 under 16 positions), MoE (smoke
mixtral-8x7b at window 8, and grok-1-314b's full attention; GShard
capacity dropping, at least one choice dropped in the batch) and SSD
(smoke mamba2-370m at chunk 8: two chunks and their carry), float and
"precise" through 'dsbp_ref', with a loss mask, against
``jax.value_and_grad(JM.loss_fn)``; three ``Trainer`` steps of an MoE and
an SSD config against JAX's ``Trainer``.  The frontends' cases are in
``tests/test_torch_train_frontends.py``, which takes its machinery from
here.

Tolerances, relative to max|.| of each array (the loss to itself).  Each
lies between two readings on this file's inputs (seed 3):
- below, the port against JAX, worst over every array (float / "precise"):
  hybrid 8.5e-6 / 1.1e-6 (the RG-LRU's log-depth scan against
  ``lax.associative_scan``, another order of the same products), MoE
  1.6e-6 / 9.4e-7, SSD 8.2e-7 / 1.3e-6, each loss within 7.1e-8;
- above, one planted fault per family (``FAULTS``): the scan's decay
  without its gradient (hybrid: 1.0), capacity dropping turned off (MoE:
  the dropped choices come back, 0.40-0.49), half the gradient of the SSD
  decay rate (0.5).
So the limits are 5e-5 for the hybrid and 1e-5 for the others, the loss
1e-6 everywhere.  No projection input crosses an FP8 rounding boundary
between the packages at this size, so "precise" keeps the float limits."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import recurrent as TREC  # noqa: E402
from repro_torch.models import ssd as TSSD  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

from test_torch_model import np_tree  # noqa: E402
from test_torch_train_model import _jax_leaf, _n_leaves, _rel  # noqa: E402

LOSS_REL = 1e-6
# (arch, overrides of its smoke config, gradient limit)
FAMILIES = {
    "hybrid": ("recurrentgemma-2b", {"window": 8}, 5e-5),
    "moe": ("mixtral-8x7b", {"window": 8}, 1e-5),
    "moe_full": ("grok-1-314b", {}, 1e-5),
    "ssd": ("mamba2-370m", {"ssd_chunk": 8}, 1e-5),
}
SEQ = 16


def _drop_capacity_off(monkeypatch):
    """MoE fault: the layers run with nothing dropped (serving's
    ``no_drop``), where training drops past the capacity."""
    monkeypatch.setattr(TM, "_layer_out", lambda layer, x, cfg, quant, positions:
                        TM.blocks.layer_seq(layer, x, cfg, quant, positions, no_drop=True)[0])


def _scan_decay_detached(monkeypatch):
    """Hybrid fault: the RG-LRU scan's decay a_t carries no gradient."""
    orig = TREC._scan
    monkeypatch.setattr(TREC, "_scan", lambda a, b: orig(a.detach(), b))


def _ssd_decay_grad_halved(monkeypatch):
    """SSD fault: the decay rate A carries half its gradient into
    ``a_log`` (the forward unchanged)."""
    orig = TSSD.ssd_chunked
    monkeypatch.setattr(TSSD, "ssd_chunked", lambda x, dt, a, b, c, chunk, h0=None:
                        orig(x, dt, (a + a.detach()) / 2, b, c, chunk, h0))


FAULTS = {"hybrid": _scan_decay_detached, "moe": _drop_capacity_off,
          "moe_full": _drop_capacity_off, "ssd": _ssd_decay_grad_halved}


def family_batch(cfg, seed: int, b: int = 2, s: int = SEQ) -> dict:
    """A seeded batch of ``cfg``'s kind: (B, S) tokens and labels with a
    loss mask; an audio config's (B, S, K) codebook ids (JAX takes no mask
    there); a vlm config's image embeddings (B, n_image_tokens, d)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_codebooks":
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1, cfg.n_codebooks))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": (rng.random((b, s)) < 0.7).astype(np.float32)}
    if cfg.frontend == "vlm_patches":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def pair(arch: str, over: dict, quant):
    """(JAX config, port config) of ``arch``'s smoke config with
    ``over``, ``quant`` through 'dsbp_ref', no remat."""
    kw = dict(over, quant=quant, quant_method="dsbp_ref" if quant else None)
    return jax_smoke_config(arch).replace(remat=False, **kw), smoke_config(arch).replace(**kw)


@functools.lru_cache(maxsize=None)
def jax_oracle(arch: str, over: tuple, quant):
    """JAX's loss and gradients on the seeded batch, from JAX's initial
    parameters: (jax config, port config, numpy param tree, batch, loss,
    numpy gradient tree).  Cached: a case and its planted fault share it."""
    jcfg, cfg = pair(arch, dict(over), quant)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    batch = family_batch(cfg, seed=3)
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True), static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    return jcfg, cfg, np_tree(params), batch, float(jl), jax.tree_util.tree_map(np.asarray, jg)


def port_loss_grads(tree, cfg, batch):
    """The port's loss and {name: gradient} from the bridged tree."""
    model = bridge.model_from_jax(tree, cfg, device="cpu")
    p = adamw.trainable(model)
    loss, _ = TM.loss_fn(model, batch)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def readings(arch: str, over: dict, quant):
    """(relative loss difference, [(relative gradient difference, name)]
    worst first, number of gradients) of the port against JAX."""
    jcfg, cfg, tree, batch, jl, jg = jax_oracle(arch, tuple(sorted(over.items())), quant)
    loss, grads = port_loss_grads(tree, cfg, batch)
    assert len(grads) == _n_leaves(jg, jcfg)
    rels = sorted(((_rel(g, _jax_leaf(jg, n, jcfg)), n) for n, g in grads.items()),
                  reverse=True)
    return abs(loss - jl) / abs(jl), rels


CASES = [(f, q) for q in (None, "precise") for f in FAMILIES]


@pytest.mark.parametrize("family,quant", CASES)
def test_loss_and_gradients_match_jax(family, quant):
    """The loss and every parameter's gradient (embedding, each layer's
    norms, projections, recurrent, SSD and router leaves, the expert
    stacks, the final norm and the head or the tied embedding) within the
    family's limits of JAX's ``value_and_grad(loss_fn)``."""
    arch, over, limit = FAMILIES[family]
    loss_rel, rels = readings(arch, over, quant)
    print(f"{family} {quant}: loss {loss_rel:.2e}, worst gradients "
          f"{[(n, float('%.2e' % r)) for r, n in rels[:3]]}")
    assert loss_rel <= LOSS_REL
    assert rels[0][0] <= limit, rels[:3]


@pytest.mark.parametrize("family,quant", CASES)
def test_planted_fault_exceeds_the_limit(family, quant, monkeypatch):
    """Each family's planted fault (``FAULTS``) moves some gradient past
    the family's limit: the limit would catch it."""
    arch, over, limit = FAMILIES[family]
    FAULTS[family](monkeypatch)
    _, rels = readings(arch, over, quant)
    print(f"{family} {quant}, {FAULTS[family].__name__}: worst gradients "
          f"{[(n, float('%.2e' % r)) for r, n in rels[:3]]}")
    assert rels[0][0] > 0.3 > limit, rels[:3]


@pytest.mark.parametrize("family", ["moe", "moe_full"])
def test_moe_training_drops_past_capacity(family, monkeypatch):
    """The batch of the parity cases overflows an expert's capacity, so
    the gradient of a dropped choice's path (nothing: its combine weight
    is 0, as JAX's) is part of what they hold; the same forward with
    ``no_drop`` (serving's) drops nothing."""
    arch, over, _ = FAMILIES[family]
    _, cfg = pair(arch, over, None)
    batch = family_batch(cfg, seed=3)
    seen = []
    orig = TMOE.route

    def route(router, xg, cfg_, valid, cap):
        out = orig(router, xg, cfg_, valid, cap)
        seen.append(int((valid[..., None] & ~out[3]).sum()))
        return out

    monkeypatch.setattr(TMOE, "route", route)
    model = bridge.model_from_jax(jax_oracle(arch, tuple(sorted(over.items())), None)[2], cfg,
                                  device="cpu")
    TM.loss_fn(model, batch)
    dropped = list(seen)
    seen.clear()
    model(torch.as_tensor(batch["tokens"]), no_drop=True)
    print(f"{family}: choices dropped per layer {dropped}; lifted {seen}")
    assert len(dropped) == cfg.n_layers and sum(dropped) > 0
    assert seen == [0] * cfg.n_layers


# ---------------- Trainer steps ----------------

TRAIN_OKW = dict(lr_peak=5e-3, warmup_steps=1, total_steps=3)
TRAIN_DKW = dict(seed=0, batch_size=4, seq_len=32)
# each step's loss, and each parameter after three AdamW steps relative to
# the change it made: the float Trainer limits of
# tests/test_torch_train_model.py (an element whose gradient is noise in
# both packages may step the other way in AdamW's first, sign-like update)
STEP_REL = (1e-5, 1e-3)


def trainer_parity(arch: str, over: dict, quant, dkw=TRAIN_DKW):
    """Three steps of the port's ``Trainer`` from the JAX ``Trainer``'s own
    initial parameters, on the same stream and schedule: (port losses, JAX
    losses, [(parameter difference / the change JAX made, name)])."""
    from repro.data.pipeline import DataConfig as JDC
    from repro.optim import adamw as JA
    from repro.train.trainer import TrainConfig as JTC
    from repro.train.trainer import Trainer as JTrainer

    jcfg, cfg = pair(arch, over, quant)
    jparams, _, jhist = JTrainer(jcfg, JTC(steps=3, log_every=1000), JA.AdamWConfig(**TRAIN_OKW),
                                 JDC(**dkw)).run()
    tree = np_tree(JM.init(jax.random.PRNGKey(0), jcfg))
    model = bridge.model_from_jax(tree, cfg, device="cpu")
    start = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    _, _, hist = Trainer(cfg, TrainConfig(steps=3, log_every=1000),
                         adamw.AdamWConfig(**TRAIN_OKW), DataConfig(**dkw), model=model).run()
    rels = []
    for name, p in model.named_parameters():
        want = np.asarray(_jax_leaf(jparams, name, jcfg))
        moved = max(np.linalg.norm(want - start[name]), 1e-12)
        rels.append((float(np.linalg.norm(p.detach().numpy() - want) / moved), name))
    return hist, [float(v) for v in jhist], sorted(rels, reverse=True)


@pytest.mark.parametrize("family", ["moe", "ssd"])
def test_trainer_steps_match_jax_trainer(family):
    """Three float steps of the port's ``Trainer`` (4 x 32 tokens: two
    MoE dispatch groups at window 8; four SSD chunks of 8) against JAX's: each loss and
    every parameter after the third step within STEP_REL."""
    arch, over, _ = FAMILIES[family]
    hist, jhist, rels = trainer_parity(arch, over, None)
    print(f"{family}: losses {hist} vs {jhist}; parameters {rels[:3]}")
    assert len(hist) == len(jhist) == 3
    for a, b in zip(hist, jhist):
        assert abs(a - b) <= STEP_REL[0] * abs(b), (hist, jhist)
    assert rels[0][0] <= STEP_REL[1], rels[:3]
