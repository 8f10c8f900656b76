"""AdamW from scratch with configurable state dtypes.

Port of ``repro.optim.adamw`` over a model's named parameters: ``params``
is a ``{name: Parameter}`` dict (``trainable(model)``), and the state is
the tree ``{"step", "m": {name: ...}, "v": {name: ...}[, "master": {name:
...}]}`` that ``checkpoint.store`` saves under the same keys.  Not a
``torch.optim`` optimizer: :func:`apply_updates` runs JAX's arithmetic in
JAX's order, under ``torch.no_grad()``, writing the parameters (and the
state) in place.

The state-dtype knobs: the low-memory preset keeps m in bfloat16 and no
master copy; ``master_dtype="float32"`` keeps an f32 master copy of bf16
parameters, which the update reads and the parameters are rounded from.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "init_state", "apply_updates", "cosine_schedule",
           "clip_by_global_norm", "trainable"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"  # 'bfloat16' for the low-mem preset
    v_dtype: str = "float32"
    master_dtype: str | None = None  # 'float32' keeps a master copy when
    # params are bf16; None updates params in their own dtype


def _dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def trainable(model) -> dict:
    """The model's raw parameters by name, with gradients turned on (the
    port's parameters are made frozen, for serving; a packed container
    holds buffers and is serve-only)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine down to ``lr_min_ratio``
    of it, in f32 as JAX's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=step.device)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (1 + torch.cos(pi * frac))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    dev = next(iter(params.values())).device if params else None
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: torch.zeros(p.shape, dtype=_dt(cfg.m_dtype), device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=_dt(cfg.v_dtype), device=p.device)
              for k, p in params.items()},
    }
    if cfg.master_dtype:
        state["master"] = {k: p.detach().to(_dt(cfg.master_dtype), copy=True)
                           for k, p in params.items()}
    return state


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to global norm <= ``max_norm``, the f32 global norm):
    the leaves' f32 sums of squares added in the dict's order."""
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))
    # a true division (``max_norm / t`` would take t's reciprocal, then multiply)
    scale = torch.clamp(torch.full_like(gn, max_norm) / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in grads.items()}, gn


@torch.no_grad()
@torch.profiler.record_function("adamw_update")
def apply_updates(params: dict, state: dict, grads: dict, cfg: AdamWConfig):
    """One AdamW step: writes ``params`` and ``state`` in place; returns
    (params, state, metrics {lr, grad_norm}); a profile names it
    ``adamw_update``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    master = state.get("master")
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * gf
        v32 = v.to(torch.float32) * b2 + (1 - b2) * gf * gf
        mhat = m32 / bc1
        vhat = v32 / bc2
        base = (master[k] if master is not None else p).to(torch.float32)
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * base)
        p.copy_(new.to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))
        if master is not None:
            master[k].copy_(new.to(master[k].dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
