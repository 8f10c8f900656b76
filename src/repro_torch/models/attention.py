"""Attention for prefill, decode and verify, through the flash-attention
kernels.

Port of ``repro.models.attention``: :func:`blockwise_attention` (:116) and
:func:`decode_attention` (:220) keep their JAX masks, and both route to
``kernels.flash_attention`` — the CUDA kernels for tensors on the card,
their plain PyTorch versions for tensors on the CPU.  A decode cache of
:class:`~repro_torch.kvq.PackedKVBlock` leaves goes to the packed-KV kernel
(B5), which folds the scales as the JAX ``qk_logits`` / ``pv_out`` packed
branches (:36-63) do; a float cache to B2.  Prefill attends over the fresh
float K/V (B2), as in JAX, with a gradient (training's sequence mode).
The JAX GQA wrapper (``kernels/ops.py:333``) only vmapped a single-head
kernel over heads; the port's kernels index heads themselves.

The paged cache adds :func:`gather_kv_view` (:66), :func:`verify_attention`
(:173, with the packed ``qk_logits`` / ``pv_out`` branches and the
sliding window) and :func:`paged_decode_attention`, which reads a block pool through the
lanes' block tables with B6 (float pool) or B7 (packed pool), where the
JAX model attends over the gathered view.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    NEG_INF, flash_attention, flash_attention_grad, gather_blocks,
    packed_flash_attention, paged_flash_attention, paged_packed_flash_attention, scale_q)
from repro_torch.kvq import PackedKVBlock

__all__ = ["blockwise_attention", "decode_attention", "verify_attention",
           "gather_kv_view", "paged_decode_attention"]


def _rows(value, b: int, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device).expand(b).contiguous()


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_lens=None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); ``q_offset`` is the absolute
    position of q[0], ``kv_lens`` (B,) the valid key length of each
    right-padded row (default: all Skv); ``window`` > 0 masks keys at or
    before ``query - window`` (sliding-window layers).  Differentiable in
    q, k and v (``flash_attention_grad``): training runs it forward
    through B2."""
    b, skv = q.shape[0], k.shape[2]
    kv_len = _rows(skv if kv_lens is None else kv_lens, b, q.device)
    return flash_attention_grad(q, k, v, kv_len, _rows(q_offset, b, q.device),
                                causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, pos, kv_len=None) -> torch.Tensor:
    """q (B, Hq, 1, D) over caches (B, Hkv, S, D), float tensors or
    :class:`PackedKVBlock` leaves: tokens < pos (scalar or (B,), per row)
    are valid, and the query sits at position pos - 1.  A ring cache (JAX
    ``_ring_decode_attention``) passes ``kv_len`` = min(pos, S): its slots
    hold positions, not in order, that all precede the query."""
    b = q.shape[0]
    pos = _rows(pos, b, q.device)
    n = pos if kv_len is None else _rows(kv_len, b, q.device)
    if isinstance(k_cache, PackedKVBlock):
        return packed_flash_attention(q, k_cache.qm, k_cache.scale, v_cache.qm,
                                      v_cache.scale, n, pos - 1, causal=True)
    return flash_attention(q, k_cache, v_cache, n, pos - 1, causal=True)


# ---------------- paged: block pools through block tables ----------------

def gather_kv_view(pool, table: torch.Tensor, s_c: int):
    """A dense per-lane view (B, Hkv, s_c, D) of a block pool (NB, Hkv, bs,
    D) through ``table`` (B, MB) (entry j holds ring slots [j*bs,
    (j+1)*bs)); a :class:`PackedKVBlock` pool gathers both children through
    the same table.  Value-exact at every slot a writer touched; slots
    never written hold recycled-block content, which every consumer masks.
    This copy is the read path of the chunked (verify) pass; paged decode
    reads the pool through the table in B6/B7 instead."""
    bs = pool.shape[2]
    nb = s_c // bs
    if nb * bs != s_c:
        raise ValueError(f"cache length {s_c} not a multiple of block size {bs}")
    table = table[:, :nb]
    if isinstance(pool, PackedKVBlock):
        return PackedKVBlock(gather_blocks(pool.qm, table), gather_blocks(pool.scale, table),
                             bits=pool.bits, fmt=pool.fmt)
    return gather_blocks(pool, table)


def paged_decode_attention(q, pool_k, pool_v, table: torch.Tensor, pos,
                           kv_len=None) -> torch.Tensor:
    """q (B, Hq, 1, D) at absolute position ``pos`` (B,) of each lane over
    a pool read through ``table`` (B, MB): the keys at positions <= pos are
    valid, the semantics of ``decode_attention(q, ck, cv, pos + 1)`` over
    the gathered view (JAX ``models/blocks.py:413``; a ring passes
    ``kv_len`` = min(pos + 1, MB * bs)).  A float pool goes to B6, a packed
    one to B7."""
    b = q.shape[0]
    pos = _rows(pos, b, q.device)
    n = pos + 1 if kv_len is None else _rows(kv_len, b, q.device)
    if isinstance(pool_k, PackedKVBlock):
        return paged_packed_flash_attention(q, pool_k.qm, pool_k.scale, pool_v.qm,
                                            pool_v.scale, table, n, pos, causal=True)
    return paged_flash_attention(q, pool_k, pool_v, table, n, pos, causal=True)


def _qk_logits(qg, kv) -> torch.Tensor:
    """QK^T over the last axes: (B, Hkv, R, T, D) x (B, Hkv, S, D) ->
    (B, Hkv, R, T, S).  Packed K folds its pow2 scale after the dot (JAX
    ``qk_logits``): exact, so it equals dequantize-then-dot bit for bit.
    A float K contracts in f32 over the exact upcasts: the jitted JAX
    einsum of two bf16 operands followed by its cast to f32 compiles to one
    f32 dot (XLA keeps the excess precision), so the scores of a bf16 model
    are not rounded to bf16."""
    if isinstance(kv, PackedKVBlock):
        lg = torch.einsum("bhrtd,bhkd->bhrtk", qg.to(torch.float32),
                          kv.qm.to(torch.float32))
        return lg * kv.scale[..., 0][:, :, None, None, :]
    return torch.einsum("bhrtd,bhkd->bhrtk", qg.to(torch.float32), kv.to(torch.float32))


def _pv_out(p, kv) -> torch.Tensor:
    """P·V; packed V folds its pow2 scale into the probabilities (JAX
    ``pv_out``)."""
    if isinstance(kv, PackedKVBlock):
        return torch.einsum("bhrtk,bhkd->bhrtd", p * kv.scale[..., 0][:, :, None, None, :],
                            kv.qm.to(torch.float32))
    return torch.einsum("bhrtk,bhkd->bhrtd", p, kv.to(torch.float32))


def verify_attention(q, k_new, v_new, k_cache, v_cache, pos, window: int = 0):
    """Multi-token decode: T queries per row (q (B, Hq, T, D), token j at
    absolute position pos + j) attend over the cached history (B, Hkv,
    S_c, D; entries < pos valid) plus the T fresh keys (B, Hkv, T, D),
    causally among themselves.  The fresh K/V ride as separate operands,
    not written first (a write-first would evict ring slots that earlier
    queries still need, and would commit rejected drafts).  Caches and
    fresh K/V are float tensors or :class:`PackedKVBlock` leaves.

    The JAX function is jnp with no Pallas kernel; this is the same math
    in PyTorch, on the CPU and on the card alike."""
    b, hq, t, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    dev = q.device
    qg = scale_q(q).reshape(b, hkv, rep, t, d)
    posb = _rows(pos, b, dev).to(torch.int64)
    qpos = posb[:, None] + torch.arange(t, device=dev)[None, :]          # (B, T)
    last = posb[:, None] - 1
    p_old = last - torch.remainder(last - torch.arange(s, device=dev)[None, :], s)
    valid_old = (p_old >= 0)[:, None, :].expand(b, t, s)                 # (B, T, S)
    j = torch.arange(t, device=dev)
    valid_new = (j[None, :] <= j[:, None])[None].expand(b, t, t)         # key <= query
    if window:
        valid_old = valid_old & (p_old[:, None, :] > qpos[:, :, None] - window)
        valid_new = valid_new & (j[None, :] > j[:, None] - window)[None]
    lg_old = _qk_logits(qg, k_cache)
    lg_new = _qk_logits(qg, k_new)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    lg_old = torch.where(valid_old[:, None, None], lg_old, neg)
    lg_new = torch.where(valid_new[:, None, None], lg_new, neg)
    p = torch.softmax(torch.cat([lg_old, lg_new], dim=-1), dim=-1)
    out = _pv_out(p[..., :s], v_cache) + _pv_out(p[..., s:], v_new)
    return out.reshape(b, hq, t, d).to(q.dtype)
