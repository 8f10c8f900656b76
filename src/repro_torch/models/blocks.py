"""Decoder block of the dense attention family: full attention + SiLU FFN.

Port of the ``attn_full`` / dense-FFN pieces of ``repro.models.blocks``:
``_ffn`` (:91), ``_qkv`` (:107), ``_attn_seq`` (:118), ``layer_seq``
(:131), ``init_layer_cache`` (:182), ``fill_kv_cache`` (:221),
``_attn_decode`` (:344) and ``layer_decode`` (:604), with the packed-KV
entries of ``_kv_entry`` (:174).  A layer's weights
live in :class:`Layer` (parameter names as in the JAX tree); the cache of
a layer is ``{'k', 'v'}``, each a float tensor (B, Hkv, S_c, D) or a
:class:`~repro_torch.kvq.PackedKVBlock` (int8 ``qm`` (B, Hkv, S_c, D) and
f32 ``scale`` (B, Hkv, S_c, 1)), updated in place.  Every write quantizes
its fresh K/V with :func:`~repro_torch.kvq.quantize_like` first, then
writes the same slots of every child.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kvq import PackedKVBlock, init_packed_kv, quantize_like

from .attention import blockwise_attention, decode_attention
from .layers import dense, rms_norm, rope

__all__ = ["Layer", "layer_seq", "layer_decode", "init_layer_cache",
           "fill_kv_cache"]

SUPPORTED_KINDS = ("attn_full",)


def _weight(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


class _Attn(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, dh = cfg.d_model, cfg.d_head
        self.wq = _weight((d, cfg.n_heads * dh), device)
        self.wk = _weight((d, cfg.n_kv_heads * dh), device)
        self.wv = _weight((d, cfg.n_kv_heads * dh), device)
        self.wo = _weight((cfg.n_heads * dh, d), device)


class _FFN(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.w1 = _weight((d, ff), device)
        self.w3 = _weight((d, ff), device)
        self.w2 = _weight((ff, d), device)


class Layer(nn.Module):
    """One ``attn_full`` decoder layer: norm1, attn {wq, wk, wv, wo},
    norm2, ffn {w1, w3, w2}.  Projection weights are raw (d_in, d_out)
    parameters or, once packed, :class:`PackedDSBPWeight` modules."""

    def __init__(self, cfg, kind: str, device):
        super().__init__()
        if kind not in SUPPORTED_KINDS or cfg.n_experts:
            raise NotImplementedError(
                f"the port serves dense {SUPPORTED_KINDS} layers; {kind!r}"
                f"{' with MoE' if cfg.n_experts else ''} is not ported yet")
        self.norm1 = _weight((cfg.d_model,), device)
        self.attn = _Attn(cfg, device)
        self.norm2 = _weight((cfg.d_model,), device)
        self.ffn = _FFN(cfg, device)


# ---------------- ffn ----------------

def _ffn(ffn: _FFN, x, quant):
    h1 = dense(ffn.w1, x, quant)
    h3 = dense(ffn.w3, x, quant)
    h = torch.nn.functional.silu(h1.to(torch.float32)).to(x.dtype) * h3
    return dense(ffn.w2, h, quant)


def _mlp_part(layer: Layer, x, cfg, quant):
    return x + _ffn(layer.ffn, rms_norm(layer.norm2, x, cfg.norm_eps), quant)


# ---------------- attention, sequence mode ----------------

def _qkv(attn: _Attn, y, cfg, quant, positions):
    b, s, _ = y.shape
    dh = cfg.d_head
    q = dense(attn.wq, y, quant).reshape(b, s, cfg.n_heads, dh)
    k = dense(attn.wk, y, quant).reshape(b, s, cfg.n_kv_heads, dh)
    v = dense(attn.wv, y, quant).reshape(b, s, cfg.n_kv_heads, dh)
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions, cfg.rope_theta)
    return q, k, v.transpose(1, 2).contiguous()


def _attn_seq(layer: Layer, x, cfg, quant, positions, lengths=None):
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    q, k, v = _qkv(layer.attn, y, cfg, quant, positions)
    o = blockwise_attention(q, k, v, causal=True, kv_lens=lengths)
    b, s, _ = x.shape
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    x = x + dense(layer.attn.wo, o.to(x.dtype), quant)
    return x, (k, v)


def layer_seq(layer: Layer, x, cfg, quant, positions, lengths=None):
    """One layer in sequence mode: returns (x_out, (k, v)) — the layer's
    keys and values for cache construction.  ``lengths`` (B,) marks
    right-padded rows: keys at/after each row's length are masked."""
    x, kv = _attn_seq(layer, x, cfg, quant, positions, lengths)
    return _mlp_part(layer, x, cfg, quant), kv


# ---------------- caches ----------------

def init_layer_cache(cfg, batch: int, max_len: int, device, kv=None) -> dict:
    """One {'k', 'v'} cache entry: float tensors, or packed blocks when a
    resolved ``kv`` spec (:class:`~repro_torch.kvq.KVQuantConfig`) is set."""
    shp = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    if kv is not None:
        return {"k": init_packed_kv(shp, kv, device), "v": init_packed_kv(shp, kv, device)}
    return {"k": torch.zeros(shp, dtype=torch.float32, device=device),
            "v": torch.zeros(shp, dtype=torch.float32, device=device)}


def _leaf_pairs(entry, fresh):
    """(cache tensor, fresh tensor) pairs of one cache leaf: the two
    children of a packed leaf, or the float tensor itself."""
    if isinstance(entry, PackedKVBlock):
        return ((entry.qm, fresh.qm), (entry.scale, fresh.scale))
    return ((entry, fresh),)


def _fill_slot_sources(lengths: torch.Tensor, s: int):
    """Cache slot r of row b receives the K/V of the LAST valid token whose
    absolute position is r (mod S_c): ``(src (B, S_c) token index, ok)``."""
    r = torch.arange(s, dtype=torch.int64, device=lengths.device)
    last = lengths.to(torch.int64)[:, None] - 1
    src = last - torch.remainder(last - r[None, :], s)
    return src, src >= 0


def fill_kv_cache(cache: dict, k, v, lengths, slots=None, rows=None) -> dict:
    """Write prefill K/V (B, H, L, D) into the cache in place: all rows, or
    fresh rows ``rows`` into cache rows ``slots`` (one each).  ``lengths``
    is an int or a vector of right-padded prompt lengths of the rows
    written; slots that hold no valid token are zeroed, as a fresh cache
    holds them.  The fresh K/V quantize as a whole before rows are taken,
    so the per-tensor scale spans every row of the prefill, as in JAX's
    fresh cache."""
    _, h, l, _ = k.shape
    b = k.shape[0] if rows is None else len(rows)
    s = cache["k"].shape[2]
    lengths = torch.as_tensor(lengths, device=cache["k"].device).expand(b)
    src, ok = _fill_slot_sources(lengths, s)
    keep = ok[:, None, :, None]
    for name, fresh in (("k", k), ("v", v)):
        fresh = quantize_like(cache[name], fresh)
        for leaf, fl in _leaf_pairs(cache[name], fresh):
            if rows is not None:
                fl = fl[torch.as_tensor(rows, device=fl.device)]
            idx = src.clamp(0, l - 1)[:, None, :, None].expand(b, h, s, fl.shape[-1])
            zero = torch.zeros((), dtype=fl.dtype, device=fl.device)
            vals = torch.where(keep, torch.gather(fl, 2, idx), zero).to(leaf.dtype)
            if slots is None:
                leaf.copy_(vals)
            else:
                leaf[torch.as_tensor(slots, device=leaf.device)] = vals
    return cache


# ---------------- decode ----------------

def _attn_decode(layer: Layer, x, cfg, quant, cache: dict, pos: torch.Tensor):
    """x: (B, 1, d); pos: (B,) int32 absolute position of the incoming
    token per row (ragged slots advance independently).  The new K/V are
    written into the cache in place at slot pos % S_c."""
    b = x.shape[0]
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    q, k, v = _qkv(layer.attn, y, cfg, quant, pos[:, None])
    s_c = cache["k"].shape[2]
    slot = (pos % s_c).to(torch.int64)
    bidx = torch.arange(b, device=x.device)
    for name, fresh in (("k", k), ("v", v)):
        # every lane's token quantizes together (idle lanes included)
        fresh = quantize_like(cache[name], fresh)
        for leaf, fl in _leaf_pairs(cache[name], fresh):
            leaf[bidx, :, slot] = fl[:, :, 0]
    o = decode_attention(q, cache["k"], cache["v"], pos + 1)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.d_head)
    return x + dense(layer.attn.wo, o.to(x.dtype), quant)


def layer_decode(layer: Layer, x, cfg, cache: dict, pos, quant=None):
    """One decode step through one layer; the cache updates in place."""
    x = _attn_decode(layer, x, cfg, quant, cache, pos)
    return _mlp_part(layer, x, cfg, quant)
