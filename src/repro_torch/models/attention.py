"""Attention for prefill and decode, through the flash-attention kernels.

Port of ``repro.models.attention``: :func:`blockwise_attention` (:116) and
:func:`decode_attention` (:220) keep their JAX masks, and both route to
``kernels.flash_attention`` — the CUDA kernels for tensors on the card,
their plain PyTorch versions for tensors on the CPU.  A decode cache of
:class:`~repro_torch.kvq.PackedKVBlock` leaves goes to the packed-KV kernel
(B5), which folds the scales as the JAX ``qk_logits`` / ``pv_out`` packed
branches (:36-63) do; a float cache to B2.  Prefill attends over the fresh
float K/V (B2), as in JAX.  The JAX GQA wrapper (``kernels/ops.py:333``)
only vmapped a single-head kernel over heads; the port's kernels index
heads themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention, packed_flash_attention
from repro_torch.kvq import PackedKVBlock

__all__ = ["blockwise_attention", "decode_attention"]


def _rows(value, b: int, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device).expand(b).contiguous()


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_lens=None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); ``q_offset`` is the absolute
    position of q[0], ``kv_lens`` (B,) the valid key length of each
    right-padded row (default: all Skv)."""
    b, skv = q.shape[0], k.shape[2]
    kv_len = _rows(skv if kv_lens is None else kv_lens, b, q.device)
    return flash_attention(q, k, v, kv_len, _rows(q_offset, b, q.device),
                           causal=causal)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """q (B, Hq, 1, D) over caches (B, Hkv, S, D), float tensors or
    :class:`PackedKVBlock` leaves: tokens < pos (scalar or (B,), per row)
    are valid, and the query sits at position pos - 1."""
    b = q.shape[0]
    pos = _rows(pos, b, q.device)
    if isinstance(k_cache, PackedKVBlock):
        return packed_flash_attention(q, k_cache.qm, k_cache.scale, v_cache.qm,
                                      v_cache.scale, pos, pos - 1, causal=True)
    return flash_attention(q, k_cache, v_cache, pos, pos - 1, causal=True)
