"""Mamba-2 SSD (state-space duality) block: chunked parallel form + decode.

Port of ``repro.models.ssd``: :class:`SSD` holds the weights of
``init_ssd_block`` (:29) under the JAX tree names; :func:`_split_proj`
(:48), :func:`ssd_chunked` (:56), :func:`ssd_naive` (:118),
:func:`ssd_block` (:135), :func:`ssd_decode_step` (:168),
:func:`ssd_verify` (:192) and :func:`init_ssd_state` (:240).

The minimal SSD algorithm of arXiv:2405.21060 (Listing 1): the sequence
splits into chunks of Q; within a chunk the quadratic "attention" form
runs as matrix products, and the states pass between chunks with a short
loop over the chunks::

  per chunk c:   L[i,j] = exp(sum_{j<t<=i} dt_t A)  (causal decay)
    Y_intra = (C B^T * L) (dt * X)
    S_c     = sum_q exp(cum_end - cum_q) B_q (x) (dt * X)_q
    carry   : S = exp(sum_chunk dt A) S_prev + S_c
    Y_inter = exp(cum_q) C_q . S_prev

Decode is the SSM recurrence h = exp(dt A) h + dt B (x) x; y = C h + D x.

The JAX functions are jnp, outside any Pallas kernel, so this is plain
PyTorch on the CPU and on the card alike; only the two projections
``w_in`` and ``w_out`` go through ``dense`` (B1 when packed).  Where the
two packages differ:

* ``jax.nn.softplus`` is ``logaddexp(x, 0)``, and so is dt's softplus here
  (torch's ``softplus`` returns x itself above its threshold).
* The chunk width must divide the sequence (JAX asserts it): a width it
  does not divide raises a ``ValueError`` (a prompt batch is padded to a
  multiple of ``prefill_bucket``, so serve a chunk-multiple bucket).
* The contractions are f32 products: torch keeps TF32 off by default
  (``torch.backends.cuda.matmul.allow_tf32`` False; ``chip_smoke.py``
  sets it so), and a caller must not turn it on.

State is ``{'h': (B, H, P, N) f32, 'conv': (B, K-1, din + 2 N)}``,
``conv`` in the model dtype (JAX :240-245).  In a bfloat16 model the
conv's silu output rounds to bf16 (JAX :150), ``C B^T`` is a bf16
product, and every contraction that mixes a bf16 operand with an f32 one
runs in f32 over the exact upcast, as JAX promotes it.  A step
returns NEW state tensors and never writes into the old ones, so a caller
that keeps the old dict can go back to it (the engine's fallback retry
and the speculative round rely on this).  :func:`ssd_verify` advances the
state token by token through :func:`_token_step`, the decode step's own
gates and recurrence, so its per-step states equal chained decode steps
bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense, param_dtype
from .layers import weight as _weight
from .recurrent import causal_conv1d, conv_states_per_step

__all__ = ["SSD", "ssd_block", "ssd_decode_step", "ssd_verify", "init_ssd_state",
           "ssd_chunked", "ssd_naive"]


class SSD(nn.Module):
    """The block's weights: the fused in-projection ``w_in`` (d, 2 din +
    2 N + H) (columns z, x, B, C, dt) and ``w_out`` (din, d), raw or
    packed; the depthwise ``conv_w`` (K, din + 2 N), all in the model
    dtype; ``a_log``, ``dt_bias`` and ``d_skip`` (H,) f32 in every model
    (JAX :35-44)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, din, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssd_heads
        dt = param_dtype(cfg)
        self.w_in = _weight((d, 2 * din + 2 * ns + nh), device, dt)
        self.conv_w = _weight((cfg.d_conv, din + 2 * ns), device, dt)
        self.w_out = _weight((din, d), device, dt)
        self.a_log = _weight((nh,), device)
        self.dt_bias = _weight((nh,), device)
        self.d_skip = _weight((nh,), device)


def _f32(t):
    """A bf16 operand upcast (exactly) where JAX promotes a mixed
    contraction to f32; an f32 one as it is."""
    return t.to(torch.float32)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(cfg, zxbcdt):
    """(z, x, B, C, dt) of the fused in-projection's columns."""
    din, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssd_heads
    return torch.split(zxbcdt, [din, din, ns, ns, nh], dim=-1)


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """The chunked SSD scan.  x (B, S, H, P); dt (B, S, H); a (H,)
    (negative); b, c (B, S, N); ``h0`` an optional (B, H, P, N) initial
    state.  Returns y (B, S, H, P), h_last (B, H, P, N) f32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"SSD chunk {q} does not divide the sequence width {s}: pad the "
                         f"batch to a multiple of the chunk (prefill_bucket)")
    nc = s // q
    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    br = b.reshape(bsz, nc, q, n)
    cr = c.reshape(bsz, nc, q, n)

    da = dtr * a  # (B, nc, q, H), <= 0
    cum = torch.cumsum(da, dim=2)  # inclusive within the chunk
    # intra-chunk causal decay L[i, j] = exp(cum_i - cum_j) for i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, H)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    # the mask before the exp: exp of a masked positive would overflow
    l_mat = torch.exp(torch.where(mask, li, torch.full_like(li, -torch.inf)))
    xdt = xr * dtr[..., None]  # (B, nc, q, H, P)
    cb = torch.einsum("bcin,bcjn->bcij", _f32(cr), _f32(br)).to(x.dtype)
    m_mat = cb[..., None] * l_mat  # (B, nc, i, j, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m_mat, xdt)

    # each chunk's state contribution, then the carry across chunks
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, q, H)
    s_c = torch.einsum("bcqn,bcqhp->bchpn", _f32(br), decay_end[..., None] * xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    s_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0.to(torch.float32))
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s_prev)
        s_prev = chunk_decay[:, ci, :, None, None] * s_prev + s_c[:, ci].to(torch.float32)
    s_prevs = torch.stack(s_prevs, dim=1)  # (B, nc, H, P, N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", _f32(cr), _f32(s_prevs.to(x.dtype)))
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, s_prev


def ssd_naive(x, dt, a, b, c, h0=None):
    """The per-step recurrence, the oracle of :func:`ssd_chunked`."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    h_t = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
           if h0 is None else h0)
    ys = []
    for t in range(s):
        h_t = _recur(h_t, x[:, t], b[:, t], dt[:, t], a)
        ys.append(torch.einsum("bn,bhpn->bhp", _f32(c[:, t]), h_t))
    return torch.stack(ys, dim=1), h_t


def _recur(h, xh, b, dt, a):
    """THE decode recurrence, one step: h (B, H, P, N), xh (B, H, P), b
    (B, N), dt (B, H), a (H,).  The op chain a verify pass repeats per
    token, so its states equal chained decode steps bit for bit."""
    dec = torch.exp(dt * a)  # (B, H)
    upd = b[:, None, None, :] * (xh * dt[..., None])[..., None]  # (B, H, P, N)
    return dec[:, :, None, None] * h + upd


def _in_proj(mod: SSD, x, cfg, quant):
    """The fused in-projection of x (B, S, d): (z, the conv's input (x, B,
    C columns), dt's pre-activation)."""
    z, xs, bmat, cmat, dt = _split_proj(cfg, dense(mod.w_in, x, quant, name="w_in"))
    return z, torch.cat([xs, bmat, cmat], dim=-1), dt


def _gates(mod: SSD, cfg, conv_out, dt):
    """silu of the conv's output and softplus(dt + dt_bias): (xh (..., H,
    P), B, C (..., N) in the activation dtype, dt (..., H) f32)."""
    din, ns = cfg.d_inner, cfg.ssm_state
    conv_out = F.silu(conv_out.to(torch.float32)).to(conv_out.dtype)
    xs, bmat, cmat = torch.split(conv_out, [din, ns, ns], dim=-1)
    dt = _softplus(dt.to(torch.float32) + mod.dt_bias)
    return xs.reshape(*xs.shape[:-1], cfg.n_ssd_heads, cfg.ssm_headdim), bmat, cmat, dt


def _token_step(mod: SSD, cfg, h, conv_out, dt, a):
    """One token of the recurrence from its conv output (B, 1, C) and dt
    pre-activation (B, 1, H): (xh, C, the new h).  A decode step and each
    token of a verify pass run this on tensors of one shape and layout, so
    their gates round alike whatever the batched width (a CPU elementwise
    kernel rounds a vectorized body and a scalar tail differently)."""
    xh, bmat, cmat, dt = _gates(mod, cfg, conv_out, dt)
    return xh, cmat, _recur(h, xh[:, 0], bmat[:, 0], dt[:, 0], a)


def _out(mod: SSD, y, xh, z, x, cfg, quant):
    """y + D x, gated by silu(z), through ``w_out``."""
    y = y + mod.d_skip[:, None] * xh.to(torch.float32)
    y = y.reshape(*y.shape[:-2], cfg.d_inner) * F.silu(z.to(torch.float32))
    return dense(mod.w_out, y.to(x.dtype), quant, name="w_out")


def ssd_block(mod: SSD, x, cfg, quant=None, state=None, chunk: int = 256, lengths=None):
    """The block in sequence mode: x (B, S, d) -> (y (B, S, d), new state).
    ``state`` an optional carried {h, conv}; ``lengths`` (B,) marks
    right-padded rows, whose pad steps get dt = 0 (decay 1, input 0), so
    the end state is each row's at its own last token."""
    z, conv_in, dt = _in_proj(mod, x, cfg, quant)
    conv_out, new_conv = causal_conv1d(mod.conv_w, conv_in,
                                       None if state is None else state["conv"], lengths=lengths)
    xh, bmat, cmat, dt = _gates(mod, cfg, conv_out, dt)
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=x.device).to(torch.int64)
        pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lens[:, None]
        dt = torch.where(pad[..., None], torch.zeros_like(dt), dt)
    a = -torch.exp(mod.a_log)
    y, h_last = ssd_chunked(xh, dt, a, bmat, cmat, chunk,
                            None if state is None else state["h"])
    return _out(mod, y, xh, z, x, cfg, quant), {"h": h_last, "conv": new_conv}


def ssd_decode_step(mod: SSD, x, state, cfg, quant=None):
    """x (B, 1, d); state {h (B, H, P, N), conv (B, K-1, C)} -> (y, new
    state)."""
    z, conv_in, dt = _in_proj(mod, x, cfg, quant)
    conv_out, new_conv = causal_conv1d(mod.conv_w, conv_in, state["conv"])
    a = -torch.exp(mod.a_log)
    xh, cmat, h = _token_step(mod, cfg, state["h"].to(torch.float32), conv_out, dt, a)
    y = torch.einsum("bn,bhpn->bhp", _f32(cmat[:, 0]), h)[:, None]
    return _out(mod, y, xh, z, x, cfg, quant), {"h": h, "conv": new_conv}


def ssd_verify(mod: SSD, x, cfg, quant=None, state=None):
    """T tokens advanced in one call with every intermediate state kept
    for rollback.  The projections and the conv run batched over the T
    tokens; then each token runs :func:`_token_step`, the decode step's
    own gates and recurrence (not the chunked form), so the per-step
    states equal T chained decode steps bit for bit.  x (B, T, d); state
    {h, conv}.  Returns (y (B, T, d), new state, steps {'h': (B, T, H, P,
    N) f32, 'conv': (B, T, K-1, C)})."""
    z, conv_in, dt = _in_proj(mod, x, cfg, quant)
    conv_out, _ = causal_conv1d(mod.conv_w, conv_in, state["conv"])
    a = -torch.exp(mod.a_log)
    h = state["h"].to(torch.float32)
    xhs, cms, hs = [], [], []
    for t in range(x.shape[1]):
        xh, cmat, h = _token_step(mod, cfg, h, conv_out[:, t:t + 1].contiguous(),
                                  dt[:, t:t + 1], a)
        xhs.append(xh)
        cms.append(cmat)
        hs.append(h)
    hs = torch.stack(hs, dim=1)  # (B, T, H, P, N)
    xh, cmat = torch.cat(xhs, dim=1), torch.cat(cms, dim=1)
    y = torch.einsum("btn,bthpn->bthp", _f32(cmat), hs)
    # conv contexts gather from the conv's inputs, as a decode step's
    conv_steps = conv_states_per_step(state["conv"], conv_in)
    steps = {"h": hs, "conv": conv_steps}
    return (_out(mod, y, xh, z, x, cfg, quant), {"h": hs[:, -1], "conv": conv_steps[:, -1]},
            steps)


def init_ssd_state(batch: int, cfg, device) -> dict:
    din, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssd_heads
    return {"h": torch.zeros((batch, nh, cfg.ssm_headdim, ns), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, din + 2 * ns), dtype=param_dtype(cfg),
                                device=device)}
