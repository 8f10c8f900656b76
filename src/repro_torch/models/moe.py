"""Mixture-of-Experts FFN: GShard grouped top-k dispatch.

Port of ``repro.models.moe`` (``init_moe`` :22, ``moe_ffn`` :35).  Tokens
split into dispatch groups of ``min(cfg.moe_group, B*S)`` (the last group
zero-padded; pad rows never dispatch).  The router is a raw (d, E) weight,
never quantized; softmax in f32, top-k, the k gates renormalised by
``max(sum, 1e-9)``.  Each expert takes ``cap`` tokens per group:
``g_sz`` under ``no_drop`` (serving: nothing drops, so a token's output is
independent of its batch), else ``max(int(capacity_factor * k * g_sz /
E), 1)``, filled in GShard priority order (choice-major, then token order
within the group) and past it the choice is dropped.

Where JAX builds (G, S, E, cap) one-hot dispatch and combine tensors and
contracts them by einsum, this computes the same slot of every (token,
choice) from the same cumulative counts, gathers the tokens into an (E,
G * cap, d) slot buffer by index, runs one batched product per expert
stack, and gathers each token's k expert rows back, weighted by its gates:
the same routing, the same drops, no one-hot tensor and no host sync (no
data-dependent shape).  Packed experts are consumed weight-only: each
stack dequantizes to the activation dtype for its product and is dropped
after it (DESIGN.md §9); a speculative draft's quant reads the stacks'
draft views, as JAX's draft tree views every container.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.packed import PackedDSBPWeight

from .layers import dense, param_dtype
from .layers import weight as _weight

__all__ = ["MoE", "moe_ffn", "route"]


class MoE(nn.Module):
    """The router (d, E) and the expert stacks ``w1`` / ``w3`` (E, d, ff)
    and ``w2`` (E, ff, d): raw parameters or, once packed, one
    :class:`PackedDSBPWeight` per stack with a leading E axis."""

    def __init__(self, cfg, device):
        super().__init__()
        d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, param_dtype(cfg)
        self.router = _weight((d, e), device, dt)
        self.w1 = _weight((e, d, ff), device, dt)
        self.w3 = _weight((e, d, ff), device, dt)
        self.w2 = _weight((e, ff, d), device, dt)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower expert
    index first among exact ties (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router, xg: torch.Tensor, cfg, valid: torch.Tensor, cap: int):
    """The dispatch of groups ``xg`` (G, S, d) whose rows ``valid`` (G, S)
    are real tokens: ``(idx, gate, pos, keep)``, each (G, S, k) — the
    chosen experts, their renormalised gates, each choice's place in its
    expert's queue (counted over the group in priority order: every
    token's first choice before any second choice) and whether it is
    within ``cap``."""
    e, k = cfg.n_experts, cfg.top_k
    logits = dense(router, xg)  # the router stays in float
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate, idx = _top_k(probs, k)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    chosen = F.one_hot(idx, e) * valid[:, :, None, None]          # (G, S, k, E)
    per_choice = chosen.sum(dim=1)                                 # (G, k, E)
    earlier = per_choice.cumsum(dim=1) - per_choice                # earlier choices
    queue = chosen.cumsum(dim=1) - 1 + earlier[:, None]            # (G, S, k, E)
    pos = queue.gather(-1, idx[..., None])[..., 0]
    keep = (pos < cap) & valid[..., None]
    return idx, gate, pos, keep


def _expert_w(w, dtype, view):
    """One expert stack as a dense (E, d_in, d_out) tensor: a packed
    container dequantized (through the draft's view when ``view`` is
    set), a raw one as it is."""
    if view is not None:
        w = view(w)
    if isinstance(w, PackedDSBPWeight):
        return w.dequantize(dtype)
    return w.to(dtype)


def moe_ffn(moe: MoE, x: torch.Tensor, cfg, quant=None, no_drop: bool = False) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): top-k routed SiLU experts.  ``quant`` is
    read only for a speculative draft's weight views (the experts are
    weight-only in every quant mode, as in JAX)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dev, dt = x.device, x.dtype
    t = b * s
    g_sz = min(cfg.moe_group, t)
    pad = (-t) % g_sz
    n_g = (t + pad) // g_sz
    xf = x.reshape(t, d)
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)])
    valid = (torch.arange(t + pad, device=dev) < t).reshape(n_g, g_sz)
    cap = g_sz if no_drop else max(int(cfg.capacity_factor * k * g_sz / e), 1)
    idx, gate, pos, keep = route(moe.router, xf.reshape(n_g, g_sz, d), cfg, valid, cap)

    # slot (expert, group, place) of each kept choice in the (E, G * cap)
    # buffer; a dropped choice gets a sink slot of its own past the end,
    # so no two choices share a slot and the scatter has one order
    rows = n_g * cap
    n_slot = e * rows
    grp = torch.arange(n_g, device=dev)[:, None, None]
    slot = torch.where(keep, idx * rows + grp * cap + pos,
                       n_slot + torch.arange(n_g * g_sz * k, device=dev).view(n_g, g_sz, k))
    token = (grp * g_sz + torch.arange(g_sz, device=dev)[None, :, None]).expand(n_g, g_sz, k)
    # slot -> token row of xf; empty slots read an appended zero row
    src = torch.full((n_slot + n_g * g_sz * k,), n_g * g_sz, dtype=torch.int64, device=dev)
    src.scatter_(0, slot.reshape(-1), token.reshape(-1))
    xe = torch.cat([xf, xf.new_zeros(1, d)]).index_select(0, src[:n_slot]).view(e, rows, d)

    view = getattr(quant.method, "weight_view", None) if quant is not None else None
    h1 = torch.bmm(xe, _expert_w(moe.w1, dt, view))
    h3 = torch.bmm(xe, _expert_w(moe.w3, dt, view))
    h = F.silu(h1.to(torch.float32)).to(dt) * h3
    del h1, h3
    ye = torch.bmm(h, _expert_w(moe.w2, dt, view)).view(n_slot, d)

    picked = ye.index_select(0, torch.where(keep, slot, 0).reshape(-1)).view(n_g, g_sz, k, d)
    # the combine weights round to the activation dtype (JAX casts
    # ``combine``), then one f32 sum of the k exact products, rounded once:
    # the reference's dot over (expert, slot)
    wts = torch.where(keep, gate, torch.zeros((), device=dev)).to(dt)
    y = (picked.to(torch.float32) * wts.to(torch.float32)[..., None]).sum(dim=2).to(dt)
    return y.reshape(-1, d)[:t].reshape(b, s, d)
