"""Training a model in the port against the JAX package, on the CPU:
``loss_fn`` and every parameter's gradient on smoke llama-7b-paper (GQA
and MHA) and on smoke gemma3-12b cut to one 5:1 local / full unit with a
window of 8 under 16 positions, and tied embeddings (float and "precise"
through 'dsbp_ref', with a loss mask) against
``jax.value_and_grad(M.loss_fn)``, in f32 and (BF16_REL) in bfloat16;
three ``Trainer`` steps from bridged JAX parameters against JAX's
``Trainer``; and, port only, remat equal to
no remat, gradient accumulation equal to its microbatches, a restart that
resumes bit for bit, and QAT through the fused method that learns.

Tolerances, relative to max|.| of each array.  ``loss_fn``: the loss 1e-6
and every gradient 1e-5 (matmuls and reductions accumulate in other
orders; ~1e-6 measured), float and "precise" alike at this batch (no
activation crosses an FP8 rounding boundary between the packages there).
Trainer steps, float: each loss 1e-5, and each parameter after three AdamW
steps within 1e-3 of the change it made (the first update is lr * sign(g)
per element, so an element whose gradient is noise in both packages may
move the other way; 2.2e-4 measured).  Trainer steps, "precise": the
projections' inputs differ between the packages in last bits, and some
of them round to another FP8 value (ROADMAP C's near ties), so the first
loss already differs by 1.8e-4; fed JAX's inputs, the port's products
give JAX's first loss within LOSS_REL
(``test_precise_step_gap_is_fp8_roundings``).  The limits, each loss
1.5e-3 and each parameter's change 0.4, lie between two readings
(``test_step_limits_lie_between_noise_and_faults``): below, the port
against JAX (7.5e-4, 0.21) and against itself from weights one ulp away
(3.7e-4, 0.19); above, three planted faults (w2's weight gradient lost:
2.8e-3, 1.0; w2's output scale doubled: 7.3e-3, 0.88; one 64-group of
w2's input dropped: 8.1e-3, 1.05)."""
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer, train_step  # noqa: E402

from test_torch_model import np_tree  # noqa: E402

LOSS_REL = 1e-6
GRAD_REL = 1e-5
# Trainer steps, (loss, parameter change): float (measured 2e-7, 2.2e-4);
# "precise" (between last-bit noise and planted faults, see above)
STEP_REL = {None: (1e-5, 1e-3), "precise": (1.5e-3, 0.4)}
# (arch, overrides of its smoke config)
VARIANTS = {"gqa": ("llama-7b-paper", {}), "mha": ("llama-7b-paper", {"n_kv_heads": 4}),
            "gemma3": ("gemma3-12b", {"n_layers": 6, "window": 8})}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_leaf(params, name: str, cfg):
    """The JAX array of the port parameter ``name``: a per-layer slice of
    a stacked unit leaf (layer i is unit i // P at pattern position i %
    P), or a tail layer's own leaf past the units."""
    if not name.startswith("layers."):
        return params["final_norm"]["scale"] if name == "final_norm" else params[name]
    _, i, *path = name.split(".")
    i, p_len = int(i), len(cfg.pattern)
    base = cfg.n_units * p_len
    node = params["units"][i % p_len] if i < base else params["tail"][i - base]
    for part in path:
        node = node[part]
    if path[-1] in ("norm1", "norm2"):
        node = node["scale"]
    return node[i // p_len] if i < base else node


def _n_leaves(params, cfg) -> int:
    """The port's parameter count of a JAX param tree: a stacked unit leaf
    holds one parameter per unit."""
    units = sum(len(jax.tree_util.tree_leaves(u)) for u in params["units"])
    return units * cfg.n_units + len(jax.tree_util.tree_leaves(
        {k: v for k, v in params.items() if k != "units"}))


def _pair(variant: str, quant):
    arch, over = VARIANTS[variant]
    kw = dict(over, quant=quant, quant_method="dsbp_ref" if quant else None)
    jcfg = jax_smoke_config(arch).replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_config(arch).replace(**kw)
    return jcfg, params, cfg


def _batch(cfg, seed: int, b: int = 2, s: int = 16, masked: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


@pytest.mark.parametrize("variant,quant", [(v, q) for q in (None, "precise") for v in VARIANTS])
def test_loss_and_gradients_match_jax(variant, quant):
    """``loss_fn``'s loss and the gradient of every parameter (embedding,
    each layer's norms and projections, the final norm and the head, or
    the embedding alone where the head is tied to it), with a loss mask,
    against ``jax.value_and_grad`` of JAX's ``loss_fn``."""
    jcfg, params, cfg = _pair(variant, quant)
    batch = _batch(cfg, seed=3, masked=True)
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True), static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    model = bridge.model_from_jax(np_tree(params), cfg, device="cpu")
    p = adamw.trainable(model)
    loss, _ = TM.loss_fn(model, batch)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert abs(float(loss) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert len(grads) == (2 if cfg.tie_embeddings else 3) + 9 * cfg.n_layers == _n_leaves(
        jg, jcfg)
    for name, g in grads.items():
        assert _rel(g, _jax_leaf(jg, name, jcfg)) <= GRAD_REL, (name, _rel(g, _jax_leaf(jg, name,
                                                                                      jcfg)))


# bfloat16 ``loss_fn`` and gradients against JAX's jitted run: (variant,
# quant) -> (loss limit, gradient limit), each relative as above.  Both
# packages round every activation to bf16, and XLA, jitted, keeps some
# results in f32 where the port rounds them (ROADMAP C), so a gradient
# differs by bf16 ulps that the layers compound.  Readings on seed 3's
# masked batch, worst gradient over every array (loss): the port against
# JAX jitted 1.7e-2 (2.9e-4) / 6.7e-2 (2.0e-3) / 0.22 (2.2e-3); JAX's own
# eager run against its jitted one 2.1e-2 (1.2e-4) / 0.11 (1.5e-3) / 0.25
# (1.0e-3); the planted faults of BF16_FAULTS: float, w2's output x2: 1.0;
# "precise", w2's weight gradient lost 1.0 / 1.0, w2's output x2 1.07 /
# 1.87, w2's last input group dropped 0.88 / 1.41.  Each limit lies above
# JAX's own spread and below every fault.
BF16_REL = {("gqa", None): (5e-3, 0.05), ("gqa", "precise"): (5e-3, 0.3),
            ("gemma3", "precise"): (5e-3, 0.5)}


def _on_w2(fault, d_ff: int):
    """A planted fault of the 'dsbp_ref' straight-through product applied
    to w2 alone (K = d_ff)."""
    from repro_torch.core import quantized as Q

    orig = Q.dsbp_matmul_ste
    return lambda x, w, c: fault(orig, x, w, c) if w.shape[0] == d_ff else orig(x, w, c)


BF16_FAULTS = {
    "w2 gradient lost": lambda orig, x, w, c: orig(x, w.detach(), c) + 0 * w.sum(),
    "w2 output x2": lambda orig, x, w, c: 2 * orig(x, w, c),
    "w2 input group dropped": lambda orig, x, w, c: orig(
        torch.cat([x[..., :-64], torch.zeros_like(x[..., -64:])], -1), w, c),
}


@functools.lru_cache(maxsize=None)
def _bf16_oracle(variant: str, quant):
    """JAX's jitted bf16 loss and gradients (as f32 numpy) on seed 3's
    masked batch: (jax config, port config, numpy param tree, batch, loss,
    gradient tree)."""
    arch, over = VARIANTS[variant]
    kw = dict(over, quant=quant, quant_method="dsbp_ref" if quant else None, dtype="bfloat16")
    jcfg = jax_smoke_config(arch).replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_config(arch).replace(**kw)
    batch = _batch(cfg, seed=3, masked=True)
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True), static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    return (jcfg, cfg, np_tree(params), batch, float(jl),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg))


def _bf16_readings(variant: str, quant):
    """(relative loss difference, worst (relative gradient difference,
    name)) of the port's bf16 step against JAX's."""
    jcfg, cfg, tree, batch, jl, jg = _bf16_oracle(variant, quant)
    model = bridge.model_from_jax(tree, cfg, device="cpu")
    p = adamw.trainable(model)
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    loss, _ = TM.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    worst = max((_rel(g.float(), _jax_leaf(jg, k, jcfg)), k) for k, g in zip(p, grads))
    return abs(float(loss) - jl) / abs(jl), worst


@pytest.mark.parametrize("variant,quant", sorted(BF16_REL, key=str))
def test_bf16_loss_and_gradients_match_jax(variant, quant):
    """A bfloat16 model's ``loss_fn`` and every parameter's bf16 gradient
    against JAX's jitted ``value_and_grad`` within BF16_REL."""
    loss_rel, (worst, name) = _bf16_readings(variant, quant)
    print(f"bf16 {variant} {quant}: loss {loss_rel:.2e}, worst gradient {name} {worst:.3g}")
    loss_lim, grad_lim = BF16_REL[(variant, quant)]
    assert loss_rel <= loss_lim and worst <= grad_lim, (loss_rel, worst, name)


@pytest.mark.parametrize("variant,quant,fault", [
    ("gqa", None, "w2 output x2")] + [(v, "precise", f) for v in ("gqa", "gemma3")
                                      for f in BF16_FAULTS])
def test_bf16_limits_lie_below_planted_faults(variant, quant, fault, monkeypatch):
    """Each planted fault on w2 moves some bf16 gradient past its case's
    limit: the float case's through the float product (its output x2), the
    "precise" cases' through the straight-through product."""
    from repro_torch.core import quantized as Q
    from repro_torch.models import layers as L

    cfg = _bf16_oracle(variant, quant)[1]
    if quant is None:
        fold = L.fold_partials
        monkeypatch.setattr(L, "fold_partials", lambda y, name: 2 * fold(y, name)
                            if name == "w2" else fold(y, name))
    else:
        monkeypatch.setattr(Q, "dsbp_matmul_ste", _on_w2(BF16_FAULTS[fault], cfg.d_ff))
    _, (worst, name) = _bf16_readings(variant, quant)
    print(f"bf16 {variant} {quant}, {fault}: worst gradient {name} {worst:.3g}")
    assert worst > BF16_REL[(variant, quant)][1], (worst, name)


def test_remat_equals_no_remat_and_accumulation_equals_microbatches():
    """``cfg.remat`` recomputes each layer in the backward: the loss and
    every gradient bit-equal to the stored forward's, through the fused
    method's straight-through product.  A leading microbatch axis: the
    loss is the mean of the microbatches' losses, and the update equals
    AdamW over their mean gradient, bit for bit."""
    jcfg, params, cfg = _pair("gqa", "precise")
    tree = np_tree(params)
    batch = _batch(cfg, seed=4)
    out = []
    for remat in (False, True):
        model = bridge.model_from_jax(tree, cfg.replace(remat=remat, quant_method="dsbp_fused"),
                                      device="cpu")
        p = adamw.trainable(model)
        loss, _ = TM.loss_fn(model, batch)
        out.append((loss, torch.autograd.grad(loss, list(p.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))

    ocfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4)
    micro = [_batch(cfg, seed=s) for s in (5, 6)]
    stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    model = bridge.model_from_jax(tree, cfg, device="cpu")
    p = adamw.trainable(model)
    st, metrics = train_step(model, adamw.init_state(p, ocfg), stacked, ocfg)
    ref = bridge.model_from_jax(tree, cfg, device="cpu")
    rp = adamw.trainable(ref)
    losses, gsum = [], None
    for m in micro:
        loss, _ = TM.loss_fn(ref, m)
        g = torch.autograd.grad(loss, list(rp.values()))
        losses.append(loss.detach())
        gsum = [gi.clone() for gi in g] if gsum is None else [a + b for a, b in zip(gsum, g)]
    adamw.apply_updates(rp, adamw.init_state(rp, ocfg), {k: g / 2 for k, g in zip(rp, gsum)},
                        ocfg)
    assert float(metrics["loss"]) == float((losses[0] + losses[1]) / 2)
    assert all(torch.equal(p[k], rp[k]) for k in p)


# the Trainer comparison: its model, optimizer and stream
TRAIN_OKW = dict(lr_peak=5e-3, warmup_steps=1, total_steps=3)
TRAIN_DKW = dict(seed=0, batch_size=4, seq_len=32)


def _trainer_cfgs(quant):
    base = dict(d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
                vocab_size=256, remat=False, quant=quant,
                quant_method="dsbp_ref" if quant else None)
    return (jax_get_config("llama-7b-paper").replace(**base),
            get_config("llama-7b-paper").replace(**base))


def _port_steps(cfg, tree):
    """Three steps of the port's ``Trainer`` from the param tree ``tree``:
    (losses, {name: final parameter})."""
    model = bridge.model_from_jax(tree, cfg, device="cpu")
    tr = Trainer(cfg, TrainConfig(steps=3, log_every=1000), adamw.AdamWConfig(**TRAIN_OKW),
                 DataConfig(**TRAIN_DKW), model=model)
    _, _, hist = tr.run()
    return hist, {k: p.detach().numpy() for k, p in model.named_parameters()}


def _step_readings(hist, params, ref_hist, ref_params, start) -> tuple:
    """(largest relative loss difference, largest parameter difference
    relative to the change the reference made from ``start``)."""
    loss = max(abs(a - float(b)) / abs(float(b)) for a, b in zip(hist, ref_hist))
    par = max(np.linalg.norm(params[k] - ref_params[k])
              / max(np.linalg.norm(ref_params[k] - start[k]), 1e-12) for k in params)
    return loss, par


def _start(cfg, tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            bridge.model_from_jax(tree, cfg, device="cpu").named_parameters()}


@pytest.mark.parametrize("quant", [None, "precise"])
def test_trainer_steps_match_jax_trainer(quant):
    """Three steps of the port's ``Trainer`` started from the JAX
    ``Trainer``'s own initial parameters (bridged), on the same synthetic
    stream and AdamW schedule: each step's loss and every parameter after
    the third step (relative to the change it made) within STEP_REL."""
    from repro.optim import adamw as JA
    from repro.data.pipeline import DataConfig as JDC
    from repro.train.trainer import TrainConfig as JTC
    from repro.train.trainer import Trainer as JTrainer

    jcfg, cfg = _trainer_cfgs(quant)
    jtr = JTrainer(jcfg, JTC(steps=3, log_every=1000), JA.AdamWConfig(**TRAIN_OKW),
                   JDC(**TRAIN_DKW))
    p0 = JM.init(jax.random.PRNGKey(0), jcfg)
    jparams, _, jhist = jtr.run()
    hist, got = _port_steps(cfg, np_tree(p0))
    assert len(hist) == len(jhist) == 3
    loss_rel, param_rel = STEP_REL[quant]
    for a, b in zip(hist, jhist):
        assert abs(a - float(b)) <= loss_rel * abs(float(b)), (hist, jhist)
    start = _start(cfg, np_tree(p0))
    for name, p in got.items():
        want = np.asarray(_jax_leaf(jparams, name, jcfg))
        moved = np.linalg.norm(want - start[name])
        err = np.linalg.norm(p - want)
        assert err <= param_rel * max(moved, 1e-12), (name, err, moved)


def test_precise_step_gap_is_fp8_roundings(monkeypatch):
    """The cause of the "precise" Trainer gap, at its first loss (the same
    parameters and batch in both packages): the projections' inputs differ
    in last bits, and some of them round to another FP8 value; fed JAX's
    inputs, the port's products give JAX's loss within LOSS_REL, where
    their own inputs leave it 1e-5 or more apart."""
    import repro.core.quantized as JQ

    from repro_torch.core import quantized as Q
    from repro_torch.data.pipeline import SyntheticLM

    jcfg, cfg = _trainer_cfgs("precise")
    p0 = JM.init(jax.random.PRNGKey(0), jcfg)
    batch = SyntheticLM(DataConfig(**TRAIN_DKW), cfg).batch(0)
    jxs = []
    jorig = JQ.dsbp_matmul_ste

    def jrec(x, w, c):
        jax.debug.callback(lambda a: jxs.append(np.array(a)), x, ordered=True)
        return jorig(x, w, c)

    monkeypatch.setattr(JQ, "dsbp_matmul_ste", jrec)
    jl, _ = jax.jit(JM.loss_fn, static_argnums=2)(
        p0, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    jax.effects_barrier()
    orig, txs, fed = Q.dsbp_matmul_ste, [], iter(jxs)
    products = {
        "own": lambda x, w, c: orig(txs.append(x.detach().clone()) or x, w, c),
        "fed": lambda x, w, c: orig(torch.from_numpy(next(fed)).reshape(x.shape), w, c),
    }
    losses = []
    for fn in products.values():
        monkeypatch.setattr(Q, "dsbp_matmul_ste", fn)
        model = bridge.model_from_jax(np_tree(p0), cfg, device="cpu")
        losses.append(float(TM.loss_fn(model, batch)[0]))
    assert len(jxs) == len(txs) == 7 * cfg.n_layers
    icfg = Q.PRESETS["precise"].input_cfg
    flips = 0
    for a, b in zip(jxs, txs):
        qa, qb = (Q.quantize_inputs(torch.as_tensor(t).reshape(-1, t.shape[-1]), icfg)
                  for t in (a, b))
        flips += int((qa["a"] * qa["scale"][..., None] != qb["a"] * qb["scale"][..., None]).sum())
    own, fed_loss = (abs(v - float(jl)) / abs(float(jl)) for v in losses)
    print(f"first loss: own inputs {own:.2e} from JAX's, fed JAX's {fed_loss:.2e}; "
          f"{flips} inputs round to another FP8 value")
    assert flips > 0
    assert own >= 1e-5
    assert fed_loss <= LOSS_REL


@pytest.mark.parametrize("case", ["one ulp", "w2 gradient lost", "w2 output x2",
                                  "w2 input group dropped"])
def test_step_limits_lie_between_noise_and_faults(case, monkeypatch):
    """Readings on each side of STEP_REL["precise"], port against port
    over the same three steps.  Below: the same steps from weights one ulp
    away (the last-bit noise an honest run carries) stay within both
    limits.  Above: each planted fault of the 'dsbp_ref' product, on w2
    (K = d_ff), exceeds both: its weight gradient lost, its output scale
    off by one power of two, or its last 64-group of inputs dropped."""
    from repro_torch.core import quantized as Q

    jcfg, cfg = _trainer_cfgs("precise")
    tree = np_tree(JM.init(jax.random.PRNGKey(0), jcfg))
    start = _start(cfg, tree)
    ref = _port_steps(cfg, tree)
    orig = Q.dsbp_matmul_ste

    def on_w2(fault):
        return lambda x, w, c: fault(x, w, c) if w.shape[0] == cfg.d_ff else orig(x, w, c)

    faults = {
        "w2 gradient lost": lambda x, w, c: orig(x, w.detach(), c) + 0 * w.sum(),
        "w2 output x2": lambda x, w, c: 2 * orig(x, w, c),
        "w2 input group dropped": lambda x, w, c: orig(
            torch.cat([x[..., :-64], torch.zeros_like(x[..., -64:])], -1), w, c),
    }
    if case == "one ulp":
        tree = jax.tree_util.tree_map(lambda a: np.nextafter(a, np.inf).astype(a.dtype), tree)
    else:
        monkeypatch.setattr(Q, "dsbp_matmul_ste", on_w2(faults[case]))
    loss, par = _step_readings(*_port_steps(cfg, tree), *ref, start)
    loss_rel, param_rel = STEP_REL["precise"]
    print(f"{case}: loss {loss:.2e}, parameters {par:.3f}")
    if case == "one ulp":
        assert loss <= loss_rel and par <= param_rel, (loss, par)
    else:
        assert loss > loss_rel and par > param_rel, (loss, par)


def test_restart_resumes_bit_for_bit(tmp_path):
    """Four fused-QAT steps with a checkpoint every two; a second
    ``Trainer`` restored from step 2 (the step-4 checkpoints removed) runs
    steps 3-4 with the same losses and ends on the same parameters and
    optimizer state, bit for bit (the checkpoint holds them exactly)."""
    cfg = smoke_config("llama-7b-paper").replace(quant="precise", quant_method="dsbp_fused")
    okw = dict(lr_peak=3e-3, warmup_steps=1, total_steps=4)
    dcfg = DataConfig(seed=2, batch_size=2, seq_len=16)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    one = Trainer(cfg, TrainConfig(steps=4, ckpt_dir=a, ckpt_every=2, seed=1),
                  adamw.AdamWConfig(**okw), dcfg, device="cpu")
    m1, s1, h1 = one.run()
    assert sorted(os.listdir(a)) == ["step_00000002", "step_00000004"]
    shutil.copytree(os.path.join(a, "step_00000002"), os.path.join(b, "step_00000002"))
    two = Trainer(cfg, TrainConfig(steps=4, ckpt_dir=b, ckpt_every=2, seed=1),
                  adamw.AdamWConfig(**okw), dcfg, device="cpu")
    m2, s2, h2 = two.run()
    assert h2 == h1[2:]
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
    assert int(s2["step"]) == 4
    assert all(torch.equal(s1[g][k], s2[g][k]) for g in ("m", "v") for k in s1[g])


def test_qat_through_the_fused_method_learns():
    """The port's case of tests/test_system.py:36: a tiny model trained
    through 'dsbp_fused' with the "efficient" preset (the fused kernel's
    plain version forward, straight-through backward) drops its loss by
    more than 0.3 nats in 25 steps on the structured stream."""
    cfg = get_config("llama-7b-paper").replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab_size=256,
        remat=False, quant="efficient", quant_method="dsbp_fused")
    tr = Trainer(cfg, TrainConfig(steps=25, log_every=1000),
                 adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=25),
                 DataConfig(seed=1, batch_size=4, seq_len=64), device="cpu")
    _, _, hist = tr.run()
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0] - 0.3, (hist[0], hist[-1])
