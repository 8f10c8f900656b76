"""Training loop with fault tolerance: checkpoint/restart, straggler
detection and gradient accumulation.

Port of ``repro.train.trainer`` for one device (a mesh waits for ROADMAP
A13).  :func:`train_step` takes the gradient of ``models.model.loss_fn``
with autograd: projections run the model's quant method, so a DSBP
method trains through its kernels' forward with a straight-through
backward, and attention through B2 with the plain version's backward.
Every family and frontend trains: the recurrent, SSD and MoE leaves (the
expert stacks raw) are parameters like the projections, and an audio or
vlm batch carries its codebook ids or image embeddings.
:class:`Trainer` drives it from the synthetic stream, saving ``(params,
opt_state)`` through ``checkpoint.store`` every ``ckpt_every`` steps and
at the end, and restarting from the newest checkpoint.  Runs on the card
unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adamw

__all__ = ["TrainConfig", "train_step", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    # a step longer than timeout_factor x the median step time is recorded
    # as a straggler (surfaced in metrics and logs)
    straggler_timeout_factor: float = 3.0
    seed: int = 0


def _value_and_grad(model, params: dict, batch: dict):
    loss, _ = M.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def train_step(model, opt_state: dict, batch: dict, opt_cfg: adamw.AdamWConfig):
    """One (optionally accumulated) optimizer step: the parameters
    (:func:`adamw.trainable`) update in place; returns
    (opt_state, {loss, lr, grad_norm}).  ``tokens`` with a leading axis
    beyond (B, S) are microbatches: their f32 gradients are summed and
    averaged, as JAX's scan (:44-58); every other leaf of the batch
    (labels, a mask, a vlm model's ``image_embeds``) carries the same
    leading axis and is split with them."""
    params = adamw.trainable(model)
    extra = 3 if model.cfg.frontend == "audio_codebooks" else 2
    if torch.as_tensor(batch["tokens"]).ndim > extra:
        n = len(batch["tokens"])
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n):
            loss, g = _value_and_grad(model, params, {k: v[i] for k, v in batch.items()})
            gsum = {k: gsum[k] + g[k] for k in gsum}
            lsum = lsum + loss
        grads = {k: v / n for k, v in gsum.items()}
        loss = lsum / n
    else:
        loss, grads = _value_and_grad(model, params, batch)
    _, opt_state, om = adamw.apply_updates(params, opt_state, grads, opt_cfg)
    return opt_state, {"loss": loss, **om}


class Trainer:
    """Host-side loop: data, steps, checkpoints, restart, straggler log.

    ``model`` starts training from a ready model (the tests bridge JAX's
    parameters in); otherwise :func:`models.model.init` draws one from
    ``tcfg.seed`` on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig,
                 opt_cfg: adamw.AdamWConfig | None = None,
                 data_cfg: DataConfig | None = None, *, model=None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=tcfg.steps)
        self.data = SyntheticLM(data_cfg or DataConfig(seed=tcfg.seed), cfg)
        self.model = model
        self.device = model.device if model is not None else resolve_device(device)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []

    def init_or_restore(self):
        """(model, params, opt_state, start step): the newest checkpoint
        under ``tcfg.ckpt_dir`` restored into the model in place, if any."""
        if self.model is None:
            self.model = M.init(self.cfg, seed=self.tcfg.seed, device=self.device)
        params = adamw.trainable(self.model)
        opt_state = adamw.init_state(params, self.opt_cfg)
        start = 0
        if self.tcfg.ckpt_dir:
            last = store.latest_step(self.tcfg.ckpt_dir)
            if last is not None:
                (saved, opt_state), _ = store.restore(
                    self.tcfg.ckpt_dir, (params, opt_state), step=last)
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(saved[k])
                start = last
        return self.model, params, opt_state, start

    def run(self, on_metrics: Callable[[int, dict], Any] | None = None):
        """Train from the newest checkpoint (or from scratch) to
        ``tcfg.steps``, saving every ``ckpt_every`` steps and at the end
        (once, where the last step saved already); returns (model,
        opt_state, losses of the steps run)."""
        model, params, opt_state, start = self.init_or_restore()
        history = []
        saved = None
        for step in range(start, self.tcfg.steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.data.batch(step).items()}
            t0 = time.monotonic()
            opt_state, metrics = train_step(model, opt_state, batch, self.opt_cfg)
            loss = float(metrics["loss"])  # blocks: realistic step timing
            dt = time.monotonic() - t0
            self.step_times.append(dt)
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if len(self.step_times) > 5 and dt > self.tcfg.straggler_timeout_factor * med:
                self.stragglers.append(step)
            history.append(loss)
            if on_metrics and step % self.tcfg.log_every == 0:
                on_metrics(step, {"loss": loss, "step_time_s": dt,
                                  "stragglers": len(self.stragglers)})
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                store.save(self.tcfg.ckpt_dir, step + 1, (params, opt_state))
                saved = step + 1
        if self.tcfg.ckpt_dir and saved != self.tcfg.steps:  # JAX saves it twice
            store.save(self.tcfg.ckpt_dir, self.tcfg.steps, (params, opt_state))
        return model, opt_state, history
