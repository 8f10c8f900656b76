"""Griffin / RecurrentGemma recurrent block: causal conv1d + RG-LRU.

Port of ``repro.models.recurrent``: :class:`RGLRU` holds the weights of
``init_rglru_block`` (:26) under the JAX tree names; :func:`_gates` (:45),
:func:`causal_conv1d` (:74), :func:`rglru_block` (:97),
:func:`conv_states_per_step` (:133), :func:`rglru_verify` (:145),
:func:`rglru_decode_step` (:188) and :func:`init_rglru_state` (:202).

RG-LRU (arXiv:2402.19427 §2.4)::

    r_t = sigmoid(W_a x_t + b_a)             (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)             (input gate)
    a_t = exp(-c * softplus(lam) * r_t)      (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX function is jnp, outside any Pallas kernel, so this is plain
PyTorch on the CPU and on the card alike.  Where the two differ:

* GELU is the tanh form (``jax.nn.gelu``'s default), not torch's erf.
* ``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's returns x itself
  above its threshold of 20.  ``lam`` is drawn in [2, 6], far below it, so
  the two differ only in rounding.
* The sequence scan: JAX runs ``lax.associative_scan``, whose tree order
  this does not copy bit for bit (tests hold it within 1e-5 of max|ref|).
  :func:`_scan` is a log-depth Hillis-Steele scan of the (a, b) pairs,
  ceil(log2 S) elementwise passes, so a long prompt costs a dozen launches
  per layer on the card and not one per position.
* ``wa`` and ``wx`` run weight-only, as in JAX: ``_gates`` calls ``dense``
  with no quantization, so a packed container dequantizes through
  ``dsbp_ref`` with no config, and never reaches the fused kernel (B1).
  The speculative draft runs them over its draft view (the quant method's
  ``weight_view``), as JAX's draft tree does.

Recurrent state is ``{'h': (B, r) f32, 'conv': (B, K-1, r)}``, ``conv``
in the model dtype (JAX :202-207).  A step
returns NEW state tensors and never writes into the old ones, so a caller
that keeps the old dict can go back to it (the engine's fallback retry and
the speculative round rely on this).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense, param_dtype
from .layers import weight as _weight

__all__ = ["RGLRU", "causal_conv1d", "rglru_block", "rglru_decode_step",
           "rglru_verify", "conv_states_per_step", "init_rglru_state"]

_C = 8.0


class RGLRU(nn.Module):
    """The recurrent block's weights: projections ``w_in``, ``w_gate`` (d,
    r), ``w_out`` (r, d), ``wa``, ``wx`` (r, r), raw or packed; the
    depthwise ``conv_w`` (K, r), all in the model dtype; ``lam``, ``ba``,
    ``bx`` (r,) f32 in every model (JAX :33-41)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, r, dt = cfg.d_model, cfg.rnn_dim, param_dtype(cfg)
        self.w_in = _weight((d, r), device, dt)
        self.w_gate = _weight((d, r), device, dt)
        self.w_out = _weight((r, d), device, dt)
        self.conv_w = _weight((cfg.d_conv, r), device, dt)
        self.wa = _weight((r, r), device, dt)
        self.wx = _weight((r, r), device, dt)
        self.lam = _weight((r,), device)
        self.ba = _weight((r,), device)
        self.bx = _weight((r,), device)


def _weight_only(w, x, quant):
    """``dense`` with no quantization (JAX ``_gates``), over the draft's
    view of ``w`` when ``quant`` is a speculative draft's."""
    view = getattr(quant.method, "weight_view", None) if quant is not None else None
    return dense(w if view is None else view(w), x)


def _gates(rec: RGLRU, x, quant=None):
    """(a_t, gated input), both f32 (..., r), from the post-conv x."""
    r_gate = torch.sigmoid(_weight_only(rec.wa, x, quant).to(torch.float32) + rec.ba)
    i_gate = torch.sigmoid(_weight_only(rec.wx, x, quant).to(torch.float32) + rec.bx)
    log_a = -_C * F.softplus(rec.lam) * r_gate  # <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * x.to(torch.float32))
    return a, gated_x


def _scan(a, b):
    """All prefixes of ``h_t = a_t h_{t-1} + b_t`` from h_{-1} = 0 along
    axis 1: a Hillis-Steele scan, each pass composing every position with
    the one ``d`` before it (d = 1, 2, 4, ...)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:  # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def causal_conv1d(conv_w, x, state=None, lengths=None):
    """Depthwise causal conv. x (B, S, r); conv_w (K, r); ``state`` (B,
    K-1, r) the trailing context (None: zeros).  ``lengths`` (B,) the valid
    length of right-padded rows: the returned state is then each row's
    context at its own last valid token.  Returns (out, new_state)."""
    k = conv_w.shape[0]
    b, s, r = x.shape
    if state is None:
        state = torch.zeros((b, k - 1, r), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, r)
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * conv_w[i]
    if lengths is None:
        new_state = xp[:, s:].clone()
    else:
        # xp row (len_b + i) is input token len_b - (K-1) + i
        idx = (torch.as_tensor(lengths, device=x.device).to(torch.int64)[:, None]
               + torch.arange(k - 1, device=x.device)[None, :])
        new_state = torch.gather(xp, 1, idx[:, :, None].expand(b, k - 1, r))
    return out, new_state


def _gate_branch(rec: RGLRU, x, quant):
    return F.gelu(dense(rec.w_gate, x, quant, name="w_gate").to(torch.float32),
                  approximate="tanh")


def _out(rec: RGLRU, y, gate, x, quant):
    return dense(rec.w_out, (y.to(torch.float32) * gate).to(x.dtype), quant, name="w_out")


def rglru_block(rec: RGLRU, x, cfg, quant=None, state=None, lengths=None):
    """The block in sequence mode: x (B, S, d) -> (y (B, S, d), new state).
    ``state`` an optional carried {h, conv}; ``lengths`` (B,) marks
    right-padded rows, whose pad steps become identity transitions (a = 1,
    input 0), so the end state is each row's at its own last token."""
    gate = _gate_branch(rec, x, quant)
    u = dense(rec.w_in, x, quant, name="w_in")
    u, new_conv = causal_conv1d(rec.conv_w, u, None if state is None else state["conv"],
                                lengths=lengths)
    a, b = _gates(rec, u, quant)
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=x.device).to(torch.int64)
        pad = (torch.arange(x.shape[1], device=x.device)[None, :] >= lens[:, None])[..., None]
        a = torch.where(pad, torch.ones_like(a), a)
        b = torch.where(pad, torch.zeros_like(b), b)
    if state is not None:
        # seed the scan with the carried h, folded into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"].to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    hh = _scan(a, b)
    out = _out(rec, hh.to(u.dtype), gate, x, quant)
    return out, {"h": hh[:, -1].contiguous(), "conv": new_conv}


def conv_states_per_step(conv_state, x):
    """Per-step conv contexts of a T-token run: entry t is the (K-1)-deep
    context after input t, the ``conv`` a decode step at t carries out.
    x (B, T, r), conv_state (B, K-1, r) -> (B, T, K-1, r)."""
    k1 = conv_state.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    idx = (torch.arange(x.shape[1], device=x.device)[:, None] + 1
           + torch.arange(k1, device=x.device)[None, :])
    return xp[:, idx]


def _recur(h, a, b):
    """THE decode recurrence ``h = a h + b``, one step: the op chain a
    verify pass repeats per token, so its states equal chained decode
    steps bit for bit."""
    return a * h + b


def rglru_verify(rec: RGLRU, x, cfg, quant=None, state=None):
    """T tokens advanced in one call with every intermediate state kept
    for rollback.  The projections, conv and gates run batched over the T
    tokens; the recurrence runs token by token with :func:`_recur`, the
    decode step's own op chain.  x (B, T, d); state {h, conv}.  Returns
    (y (B, T, d), new state, steps {'h': (B, T, r), 'conv': (B, T, K-1,
    r)})."""
    gate = _gate_branch(rec, x, quant)
    u_in = dense(rec.w_in, x, quant, name="w_in")
    u, _ = causal_conv1d(rec.conv_w, u_in, state["conv"])
    a, b = _gates(rec, u, quant)
    h = state["h"].to(torch.float32)
    hs = []
    for t in range(x.shape[1]):
        h = _recur(h, a[:, t], b[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    out = _out(rec, hs.to(u.dtype), gate, x, quant)
    # conv contexts gather from the pre-conv inputs, as a decode step's
    conv_steps = conv_states_per_step(state["conv"], u_in)
    steps = {"h": hs, "conv": conv_steps}
    return out, {"h": hs[:, -1], "conv": conv_steps[:, -1]}, steps


def rglru_decode_step(rec: RGLRU, x, state, cfg, quant=None):
    """x (B, 1, d); state {h (B, r), conv (B, K-1, r)} -> (y, new state)."""
    gate = _gate_branch(rec, x, quant)
    u = dense(rec.w_in, x, quant, name="w_in")
    u, new_conv = causal_conv1d(rec.conv_w, u, state["conv"])
    a, b = _gates(rec, u, quant)
    h = _recur(state["h"].to(torch.float32), a[:, 0], b[:, 0])
    out = _out(rec, h[:, None].to(u.dtype), gate, x, quant)
    return out, {"h": h, "conv": new_conv}


def init_rglru_state(batch: int, cfg, device) -> dict:
    r = cfg.rnn_dim
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, r), dtype=param_dtype(cfg),
                                device=device)}
