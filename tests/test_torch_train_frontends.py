"""Training the modality frontends, the port against the JAX package on
the CPU: ``loss_fn`` and every parameter's gradient of smoke
musicgen-large (K = 4 codebooks: logits read as (B, S, K, Vp) against
(B, S, K) labels, no mask, as JAX's) and smoke llava-next-34b (16 image
embeddings in front of 16 text tokens; the loss and its mask over the
text positions only), float and "precise" through 'dsbp_ref', against
``jax.value_and_grad(JM.loss_fn)``; and one microbatched llava train step
(two microbatches, each with its own image embeddings) against JAX's
``train_step``.  The machinery is ``tests/test_torch_train_families.py``'s.

Tolerances, relative to max|.| of each array, as there (the loss 1e-6,
every gradient 1e-5), between two readings on these inputs (seed 3):
- below, the port against JAX, worst over every array (float /
  "precise"): musicgen 1.8e-6 / 8.6e-7, llava 2.3e-6 / 9.7e-7, each loss
  within 1.5e-7;
- above, one planted fault per frontend (``FAULTS``): the codebook heads'
  columns read codebook-minor (the reshape of (B, S, K * Vp) logits taken
  as (B, S, Vp, K)) and the vlm loss taken over the image prefix (the
  first S_txt positions), each moving some gradient by 0.3 or more of its
  max|.|.
The microbatched step: the loss 1e-5 (the float Trainer's limit) and
every parameter's first moment (the clipped mean gradient) 1e-5."""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import train_step  # noqa: E402

from test_torch_model import np_tree  # noqa: E402
from test_torch_train_families import LOSS_REL, STEP_REL, family_batch, pair, readings  # noqa: E402
from test_torch_train_model import _jax_leaf, _rel  # noqa: E402

GRAD_REL = 1e-5
FRONTENDS = {"audio": "musicgen-large", "vlm": "llava-next-34b"}


def _codebook_minor(monkeypatch):
    """Audio fault: the K * Vp head columns regrouped codebook-minor, so
    each codebook's loss reads the wrong columns."""
    orig = TM.Model.head

    def head(self, x):
        logits = orig(self, x)
        b, s, kv = logits.shape
        k = self.cfg.n_codebooks
        return logits.reshape(b, s, kv // k, k).transpose(-1, -2).reshape(b, s, kv)

    monkeypatch.setattr(TM.Model, "head", head)


def _loss_over_prefix(monkeypatch):
    """Vlm fault: the loss over the first S_txt positions (the image
    prefix and the start of the text) instead of the text's."""
    orig = TM.Model.head

    def head(self, x):
        logits = orig(self, x)
        return logits.roll(self.cfg.n_image_tokens, dims=1)

    monkeypatch.setattr(TM.Model, "head", head)


FAULTS = {"audio": _codebook_minor, "vlm": _loss_over_prefix}
CASES = [(f, q) for q in (None, "precise") for f in FRONTENDS]


@pytest.mark.parametrize("frontend,quant", CASES)
def test_loss_and_gradients_match_jax(frontend, quant):
    """The loss and every parameter's gradient (the K-block embedding and
    head of the audio model; the vlm model's through its image prefix)
    within LOSS_REL / GRAD_REL of JAX's."""
    loss_rel, rels = readings(FRONTENDS[frontend], {}, quant)
    print(f"{frontend} {quant}: loss {loss_rel:.2e}, worst gradients "
          f"{[(n, float('%.2e' % r)) for r, n in rels[:3]]}")
    assert loss_rel <= LOSS_REL
    assert rels[0][0] <= GRAD_REL, rels[:3]


@pytest.mark.parametrize("frontend,quant", CASES)
def test_planted_fault_exceeds_the_limit(frontend, quant, monkeypatch):
    """Each frontend's planted fault moves some gradient past GRAD_REL."""
    FAULTS[frontend](monkeypatch)
    _, rels = readings(FRONTENDS[frontend], {}, quant)
    print(f"{frontend} {quant}, {FAULTS[frontend].__name__}: worst gradients "
          f"{[(n, float('%.2e' % r)) for r, n in rels[:3]]}")
    assert rels[0][0] > 0.3 > GRAD_REL, rels[:3]


def test_microbatched_vlm_step_matches_jax():
    """One AdamW step over two microbatches of llava-next-34b's smoke
    config, each with its own image embeddings (a leading microbatch axis
    on every leaf of the batch) against JAX's ``train_step`` on the same
    stacked batch: the loss (the mean of the microbatches' losses) within
    STEP_REL[0], and the first moment m = (1 - b1) * the clipped mean
    gradient of every parameter within GRAD_REL of max|.|.  (m holds the
    averaged gradient itself; the parameters after a first, sign-like
    AdamW step move a near-zero gradient's element by up to lr either
    way.)"""
    from repro.optim import adamw as JA
    from repro.train.trainer import train_step as jtrain_step

    jcfg, cfg = pair(FRONTENDS["vlm"], {}, None)
    micro = [family_batch(cfg, seed=s) for s in (5, 6)]
    stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    assert stacked["image_embeds"].shape == (2, 2, cfg.n_image_tokens, cfg.d_model)
    okw = dict(lr_peak=5e-3, warmup_steps=1, total_steps=3)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    jocfg = JA.AdamWConfig(**okw)
    _, jstate, jm = jax.jit(partial(jtrain_step, cfg=jcfg, opt_cfg=jocfg))(
        params, JA.init_state(params, jocfg), {k: jnp.asarray(v) for k, v in stacked.items()})
    model = bridge.model_from_jax(np_tree(params), cfg, device="cpu")
    ocfg = adamw.AdamWConfig(**okw)
    state, metrics = train_step(model, adamw.init_state(adamw.trainable(model), ocfg), stacked,
                                ocfg)
    loss, jloss = float(metrics["loss"]), float(jm["loss"])
    rels = sorted(((_rel(m, _jax_leaf(jstate["m"], k, jcfg)), k)
                   for k, m in state["m"].items()), reverse=True)
    print(f"loss {loss} vs {jloss}; first moments {rels[:3]}")
    assert len(rels) == len(list(model.parameters()))
    assert abs(loss - jloss) <= STEP_REL[0] * abs(jloss)
    assert rels[0][0] <= GRAD_REL, rels[:3]
