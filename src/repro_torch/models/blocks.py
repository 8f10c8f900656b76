"""Decoder block of the dense attention family: full attention + SiLU FFN.

Port of the ``attn_full`` / dense-FFN pieces of ``repro.models.blocks``:
``_ffn`` (:91), ``_qkv`` (:107), ``_attn_seq`` (:118), ``layer_seq``
(:131), ``init_layer_cache`` (:182), ``fill_kv_cache`` (:221),
``_attn_decode`` (:344) and ``layer_decode`` (:604), with the packed-KV
entries of ``_kv_entry`` (:174); and the paged cache's
``init_layer_cache_paged`` (:194), ``_scatter_pool`` (:248), the paged
writes ``write_kv_blocks`` (:267), ``fill_kv_cache_paged`` (:303) and
``rollback_kv_cache_paged`` (:563) as one :func:`write_kv_blocks` over a
plan, ``_attn_decode_paged`` (:392) / ``layer_decode_paged`` (:625) and
``_attn_verify_paged`` (:479) / ``layer_verify_paged`` (:507); and the
dense verify of speculative decoding, ``_attn_verify`` (:419) /
``layer_verify`` (:450) and ``rollback_kv_cache`` (:537).  A layer's
weights live in
:class:`Layer` (parameter names as in the JAX tree); the cache of a layer
is ``{'k', 'v'}``, each a float tensor (B, Hkv, S_c, D) in the model
dtype (f32 or bf16, JAX's ``_kv_entry``) or a
:class:`~repro_torch.kvq.PackedKVBlock` (int8 ``qm`` (B, Hkv, S_c, D) and
f32 ``scale`` (B, Hkv, S_c, 1)), updated in place.  Every write quantizes
its fresh K/V with :func:`~repro_torch.kvq.quantize_like` first, then
writes the same slots of every child.

A paged layer's cache is a block pool ``{'k', 'v'}`` of (NB, Hkv, bs, D)
leaves shared by every lane.  The JAX scatter routes masked entries to the
scratch block, so its index lists hold duplicates; on the card an index
put with duplicate indices has no defined order, so the port writes only
the unmasked entries: a :class:`WritePlan` computed once per step on the
host, from the block tables and positions the scheduler holds, and shared
by every layer (they share one ring length).  The plan is what tells JAX's
three paged writes apart: :func:`write_plan` gives decode's and
commit-on-accept's entries, :func:`fill_plan` a prompt fill's, with its
``write_start`` prefix skip.

The Griffin hybrid adds two kinds: ``attn_local``, whose cache is a ring
of :func:`cache_len` = min(max_len, window) slots (JAX :168; prefill masks
the window, decode reads the first min(pos + 1, S_c) slots, which are the
ones JAX's ``_ring_decode_attention`` (:380) keeps valid once S_c <=
window), and ``rglru`` (JAX :78-81): norm1, the recurrent block
(:mod:`.recurrent`), norm2, ffn, whose cache is a dense per-lane state
``{'h', 'conv'}`` in the paged pool as well (:194-204).  A recurrent
step replaces the entries of that dict with new tensors and never
writes into the old ones; :func:`select_state_step` (:573) and
:func:`freeze_state` (:590) select rows exactly.

The Mamba-2 family adds ``ssd`` (JAX :82-83): norm1 and the SSD block
(:mod:`.ssd`) only, no norm2 and no FFN; its cache is a dense per-lane
state ``{'h', 'conv'}`` like the RG-LRU's, and it follows the same rules
(JAX :158-161, :472-474, :530-532, :618-620, :647-649).

An MoE config (``cfg.n_experts``) gives its attention layers a
:class:`~.moe.MoE` in place of the FFN (JAX :74-75): ``_mlp_part`` (:98)
routes through :func:`~.moe.moe_ffn`, with the caller's ``no_drop`` in
sequence mode and ``no_drop=True`` on every cached path (decode, verify,
paged and chunk steps, JAX :464-645).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.packed import PackedDSBPWeight
from repro_torch.kvq import PackedKVBlock, init_packed_kv, quantize_like

from .attention import (blockwise_attention, decode_attention, gather_kv_view,
                        paged_decode_attention, verify_attention)
from .layers import dense, param_dtype, rms_norm, rope
from .layers import weight as _weight
from .moe import MoE, moe_ffn
from .recurrent import RGLRU, init_rglru_state, rglru_block, rglru_decode_step, rglru_verify
from .ssd import SSD, init_ssd_state, ssd_block, ssd_decode_step, ssd_verify

__all__ = ["Layer", "layer_seq", "layer_decode", "init_layer_cache",
           "fill_kv_cache", "layer_verify", "kv_slots", "rollback_kv_cache",
           "init_layer_cache_paged", "WritePlan", "write_plan", "fill_plan",
           "write_kv_blocks", "layer_decode_paged", "layer_verify_paged",
           "pool_entries", "restore_pool_entries", "pool_block_size", "cache_len", "KIND_HAS_KV",
           "select_state_step", "freeze_state"]

SUPPORTED_KINDS = ("attn_full", "attn_local", "rglru", "ssd")
KIND_HAS_KV = {"attn_full": True, "attn_local": True, "rglru": False, "ssd": False}


def cache_len(cfg, kind: str, max_len: int) -> int:
    """A KV layer's ring length S_c: the window of an ``attn_local`` layer
    when it is shorter than ``max_len``, else ``max_len``."""
    if kind == "attn_local" and cfg.window:
        return min(max_len, cfg.window)
    return max_len


def _window(cfg, kind: str) -> int:
    return cfg.window if kind == "attn_local" else 0


class _Attn(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, dh, dt = cfg.d_model, cfg.d_head, param_dtype(cfg)
        self.wq = _weight((d, cfg.n_heads * dh), device, dt)
        self.wk = _weight((d, cfg.n_kv_heads * dh), device, dt)
        self.wv = _weight((d, cfg.n_kv_heads * dh), device, dt)
        self.wo = _weight((cfg.n_heads * dh, d), device, dt)


class _FFN(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, param_dtype(cfg)
        self.w1 = _weight((d, ff), device, dt)
        self.w3 = _weight((d, ff), device, dt)
        self.w2 = _weight((ff, d), device, dt)


def out_features(w) -> int:
    """Output columns of a projection weight, raw (d_in, d_out) or packed."""
    return w.n if isinstance(w, PackedDSBPWeight) else w.shape[-1]


class Layer(nn.Module):
    """One decoder layer of kind ``attn_full`` / ``attn_local`` (norm1,
    attn {wq, wk, wv, wo}, norm2, and ffn {w1, w3, w2} or, with
    ``cfg.n_experts``, moe (:class:`~.moe.MoE`)), ``rglru`` (norm1, rec
    (:class:`~.recurrent.RGLRU`), norm2, ffn) or ``ssd`` (norm1, ssd
    (:class:`~.ssd.SSD`)), as JAX ``init_layer`` (:66).  Projection
    weights are raw (d_in, d_out) parameters (an expert stack (E, d_in,
    d_out)) or, once packed, :class:`PackedDSBPWeight` modules."""

    def __init__(self, cfg, kind: str, device):
        super().__init__()
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f"the port serves {SUPPORTED_KINDS} layers; {kind!r} is not "
                f"ported yet (ROADMAP A6)")
        self.kind = kind
        self.norm1 = _weight((cfg.d_model,), device, param_dtype(cfg))
        if kind == "ssd":  # no norm2 and no FFN (JAX :82-83)
            self.ssd = SSD(cfg, device)
            return
        if kind == "rglru":
            self.rec = RGLRU(cfg, device)
        else:
            self.attn = _Attn(cfg, device)
        self.norm2 = _weight((cfg.d_model,), device, param_dtype(cfg))
        if cfg.n_experts and kind != "rglru":
            self.moe = MoE(cfg, device)
        else:
            self.ffn = _FFN(cfg, device)

    @property
    def has_kv(self) -> bool:
        return KIND_HAS_KV[self.kind]

    def kv_heads(self, cfg) -> int:
        """The KV heads this layer's weights produce (a rank's share)."""
        return out_features(self.attn.wk) // cfg.d_head


# ---------------- ffn ----------------

def _ffn(ffn: _FFN, x, quant):
    h1 = dense(ffn.w1, x, quant, name="w1")
    h3 = dense(ffn.w3, x, quant, name="w3")
    h = torch.nn.functional.silu(h1.to(torch.float32)).to(x.dtype) * h3
    return dense(ffn.w2, h, quant, name="w2")


def _mlp_part(layer: Layer, x, cfg, quant, no_drop=True):
    """norm2 and the FFN, or the MoE: ``no_drop`` is the sequence path's
    choice (JAX :98); every cached path serves with nothing dropped."""
    y = rms_norm(layer.norm2, x, cfg.norm_eps)
    if hasattr(layer, "moe"):
        return x + moe_ffn(layer.moe, y, cfg, quant, no_drop)
    return x + _ffn(layer.ffn, y, quant)


def _residual(layer: Layer, x, o, cfg, quant):
    """A state layer's cached-path output ``o`` added to the stream, then
    norm2 and the FFN where the layer has them (an ``ssd`` layer has
    none)."""
    x = x + o
    return x if layer.kind == "ssd" else _mlp_part(layer, x, cfg, quant)


# ---------------- attention, sequence mode ----------------

def _qkv(attn: _Attn, y, cfg, quant, positions):
    """q (B, Hq, S, D), k, v (B, Hkv, S, D) with the head counts of the
    weights held here: all of them, or this rank's under a mesh."""
    b, s, _ = y.shape
    dh = cfg.d_head
    q = dense(attn.wq, y, quant, name="wq").reshape(b, s, -1, dh)
    k = dense(attn.wk, y, quant, name="wk").reshape(b, s, -1, dh)
    v = dense(attn.wv, y, quant, name="wv").reshape(b, s, -1, dh)
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions, cfg.rope_theta)
    return q, k, v.transpose(1, 2).contiguous()


def _attn_seq(layer: Layer, x, cfg, quant, positions, lengths=None):
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    q, k, v = _qkv(layer.attn, y, cfg, quant, positions)
    o = blockwise_attention(q, k, v, causal=True, window=_window(cfg, layer.kind),
                            kv_lens=lengths)
    b, s, _ = x.shape
    o = o.transpose(1, 2).reshape(b, s, -1)
    x = x + dense(layer.attn.wo, o.to(x.dtype), quant, name="wo")
    return x, (k, v)


def layer_seq(layer: Layer, x, cfg, quant, positions, lengths=None, no_drop=False):
    """One layer in sequence mode: returns (x_out, aux), aux the layer's
    keys and values (k, v) for cache construction, or a recurrent layer's
    end state {h, conv} from a zero state.  ``lengths`` (B,) marks
    right-padded rows: keys at/after each row's length are masked, and
    recurrent state freezes across the pad.  ``no_drop`` lifts the MoE's
    capacity (a prefill passes True)."""
    if layer.kind == "ssd":
        y = rms_norm(layer.norm1, x, cfg.norm_eps)
        o, st = ssd_block(layer.ssd, y, cfg, quant, chunk=cfg.ssd_chunk, lengths=lengths)
        return x + o, st
    if layer.kind == "rglru":
        y = rms_norm(layer.norm1, x, cfg.norm_eps)
        o, st = rglru_block(layer.rec, y, cfg, quant, lengths=lengths)
        return _mlp_part(layer, x + o, cfg, quant, no_drop), st
    x, kv = _attn_seq(layer, x, cfg, quant, positions, lengths)
    return _mlp_part(layer, x, cfg, quant, no_drop), kv


# ---------------- caches ----------------

def _init_state(cfg, kind: str, batch: int, device) -> dict:
    """A state layer's zero state {h, conv} of ``batch`` lanes."""
    return (init_ssd_state if kind == "ssd" else init_rglru_state)(batch, cfg, device)


def init_layer_cache(cfg, batch: int, max_len: int, device, kv=None,
                     n_kv_heads: int | None = None, kind: str = "attn_full") -> dict:
    """One {'k', 'v'} cache entry of :func:`cache_len` slots: float
    tensors, or packed blocks when a resolved ``kv`` spec
    (:class:`~repro_torch.kvq.KVQuantConfig`) is set; or a recurrent
    layer's zero state {h, conv} (``kv`` does not apply).  ``n_kv_heads``
    is the layer's own (a rank's under a mesh; default
    ``cfg.n_kv_heads``)."""
    if not KIND_HAS_KV[kind]:
        return _init_state(cfg, kind, batch, device)
    shp = (batch, n_kv_heads or cfg.n_kv_heads, cache_len(cfg, kind, max_len), cfg.d_head)
    if kv is not None:
        return {"k": init_packed_kv(shp, kv, device), "v": init_packed_kv(shp, kv, device)}
    return {"k": torch.zeros(shp, dtype=param_dtype(cfg), device=device),
            "v": torch.zeros(shp, dtype=param_dtype(cfg), device=device)}


def _children(leaf):
    """The tensors of one cache leaf: both children of a packed leaf, or
    the float tensor itself."""
    return (leaf.qm, leaf.scale) if isinstance(leaf, PackedKVBlock) else (leaf,)


def _leaf_pairs(entry, fresh):
    """(cache tensor, fresh tensor) pairs of one cache leaf."""
    return zip(_children(entry), _children(fresh))


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

def _ring_len(layer: Layer, pos, s_c: int):
    """The valid slots of a decode read at positions ``pos`` (B,): pos + 1,
    bounded by the ring length for an ``attn_local`` ring (after it wraps,
    every slot holds one of the last S_c <= window positions)."""
    n = pos + 1
    return torch.clamp(n, max=s_c) if layer.kind == "attn_local" else n


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
    o = decode_attention(q, cache["k"], cache["v"], pos + 1, kv_len=_ring_len(layer, pos, s_c))
    o = o.transpose(1, 2).reshape(b, 1, -1)
    return x + dense(layer.attn.wo, o.to(x.dtype), quant, name="wo")


def _rec_decode(layer: Layer, x, cfg, quant, state: dict):
    """A state layer's decode step: (x, the new state)."""
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    if layer.kind == "ssd":
        o, new = ssd_decode_step(layer.ssd, y, state, cfg, quant)
    else:
        o, new = rglru_decode_step(layer.rec, y, state, cfg, quant)
    return _residual(layer, x, o, cfg, quant), new


def layer_decode(layer: Layer, x, cfg, cache: dict, pos, quant=None):
    """One decode step through one layer; the cache updates in place (a
    recurrent layer's entries are replaced by its new state)."""
    if not layer.has_kv:
        x, new = _rec_decode(layer, x, cfg, quant, cache)
        cache.update(new)
        return x
    x = _attn_decode(layer, x, cfg, quant, cache, pos)
    return _mlp_part(layer, x, cfg, quant)


# ---------------- verify (speculative decoding) ----------------

def _ring_slots(posb: torch.Tensor, t: int, s_c: int):
    """(row index (B, 1), ring slots (B, T)) of tokens pos .. pos+T-1,
    distinct within a row while T <= S_c (the engine's contract)."""
    b = posb.shape[0]
    j = torch.arange(t, device=posb.device)
    return (torch.arange(b, device=posb.device)[:, None],
            torch.remainder(posb.to(torch.int64)[:, None] + j[None, :], s_c))


def _verify_attend(layer: Layer, x, cfg, quant, like: dict, ck, cv, posb):
    """The attention half of a T-token verify: the queries at positions
    pos .. pos+T-1 attend over the history ``ck`` / ``cv`` (entries below
    pos valid) plus the T fresh K/V, causally.  Quantize first: the fresh
    K/V attend in the representation of the cache leaves ``like``, so a
    verify equals T chained decode steps token for token.  Returns (x,
    fresh K, fresh V), the fresh K/V in that representation."""
    b, t, _ = x.shape
    positions = posb[:, None] + torch.arange(t, device=x.device)[None, :]
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    q, k, v = _qkv(layer.attn, y, cfg, quant, positions)
    kq = quantize_like(like["k"], k)
    vq = quantize_like(like["v"], v)
    o = verify_attention(q, kq, vq, ck, cv, posb, window=_window(cfg, layer.kind))
    o = o.transpose(1, 2).reshape(b, t, -1)
    return x + dense(layer.attn.wo, o.to(x.dtype), quant, name="wo"), kq, vq


def _attn_verify(layer: Layer, x, cfg, quant, cache: dict, posb):
    """Dense verify attention over the cache (slots below pos), then all T
    fresh entries written, in place."""
    x, kq, vq = _verify_attend(layer, x, cfg, quant, cache, cache["k"], cache["v"], posb)
    rows, slots = _ring_slots(posb, x.shape[1], cache["k"].shape[2])
    for name, fresh in (("k", kq), ("v", vq)):
        for leaf, fl in _leaf_pairs(cache[name], fresh):
            leaf[rows, :, slots] = fl.transpose(1, 2).to(leaf.dtype)
    return x


def _rec_verify(layer: Layer, x, cfg, quant, state: dict):
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    if layer.kind == "ssd":
        o, new, steps = ssd_verify(layer.ssd, y, cfg, quant, state)
    else:
        o, new, steps = rglru_verify(layer.rec, y, cfg, quant, state)
    return _residual(layer, x, o, cfg, quant), new, steps


def layer_verify(layer: Layer, x, cfg, cache: dict, pos, quant=None):
    """T tokens through one layer in verify mode (x (B, T, d), ``pos`` (B,)
    the position of token 0 of each row); the cache advances by all T
    tokens, in place.  Returns (x, steps): what a rollback needs of an
    attention layer is the old content of its slots (:func:`kv_slots`,
    taken before), so ``steps`` is empty; a recurrent layer's are its
    per-step states, for :func:`select_state_step`."""
    if not layer.has_kv:
        x, new, steps = _rec_verify(layer, x, cfg, quant, cache)
        cache.update(new)
        return x, steps
    x = _attn_verify(layer, x, cfg, quant, cache, pos)
    return _mlp_part(layer, x, cfg, quant), {}


def kv_slots(cache: dict, pos, n: int) -> dict:
    """Copies of ring slots pos .. pos+n-1 of every row of one layer's
    cache, every child of every leaf: {'k': [(B, n, H, D) ...], 'v': ...}.
    What a round overwrites and :func:`rollback_kv_cache` puts back."""
    rows, slots = _ring_slots(pos, n, cache["k"].shape[2])
    return {name: [leaf[rows, :, slots] for leaf in _children(cache[name])]
            for name in ("k", "v")}


def rollback_kv_cache(cache: dict, old: dict, keep, pos, n_new: int) -> dict:
    """Roll one layer's verify-advanced cache back to its accepted prefix,
    in place: row b keeps its first ``keep[b]`` (>= 1) of the ``n_new``
    fresh entries at ring slots (pos + j) % S_c, and every other of those
    slots gets its pre-round content ``old`` (:func:`kv_slots`) back, bit
    for bit.  The JAX function selects between the old and the new cache
    (its values); this one rewrites the round's slots in place."""
    rows, slots = _ring_slots(pos, n_new, cache["k"].shape[2])
    keep = torch.as_tensor(keep, device=slots.device).to(torch.int64)
    kept = (torch.arange(n_new, device=slots.device)[None, :] < keep[:, None])[:, :, None, None]
    for name in ("k", "v"):
        for leaf, saved in zip(_children(cache[name]), old[name]):
            leaf[rows, :, slots] = torch.where(kept, leaf[rows, :, slots], saved)
    return cache


# ---------------- paged cache: block pools through block tables ----------------

def init_layer_cache_paged(cfg, num_blocks: int, block_size: int, device,
                           kv=None, kind: str = "attn_full", batch: int = 0) -> dict:
    """One layer's block pool ``{'k', 'v'}`` (NB, Hkv, bs, D): no batch
    axis; lanes address it through their block tables.  A recurrent
    layer keeps its dense state of ``batch`` lanes (nothing to page in an
    O(1) state)."""
    if not KIND_HAS_KV[kind]:
        return _init_state(cfg, kind, batch, device)
    shp = (num_blocks, cfg.n_kv_heads, block_size, cfg.d_head)
    if kv is not None:
        return {"k": init_packed_kv(shp, kv, device), "v": init_packed_kv(shp, kv, device)}
    return {"k": torch.zeros(shp, dtype=param_dtype(cfg), device=device),
            "v": torch.zeros(shp, dtype=param_dtype(cfg), device=device)}


def pool_block_size(cache: list[dict]) -> int:
    """The block size of a paged cache: the slot axis of its first pool
    (1 when the model has no KV layer)."""
    return next((c["k"].shape[2] for c in cache if "k" in c), 1)


def to_host(x) -> np.ndarray:
    """A host (numpy) copy of a table, position or length vector."""
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


class WritePlan(NamedTuple):
    """The unmasked entries of one paged cache write, as device index
    vectors (n,): fresh token ``tok`` of lane ``row`` goes to row ``off``
    of pool block ``phys``."""
    row: torch.Tensor
    tok: torch.Tensor
    phys: torch.Tensor
    off: torch.Tensor


def _plan(table, rows, toks, slots, block_size: int, device) -> WritePlan:
    table = to_host(table)
    phys = table[rows, slots // block_size]
    return WritePlan(*(torch.as_tensor(np.asarray(a, np.int64), device=device)
                       for a in (rows, toks, phys, slots % block_size)))


def write_plan(table, pos, write_len, t: int, s_c: int, *, block_size: int,
               device) -> WritePlan:
    """The entries of T fresh tokens per lane (JAX ``write_kv_blocks``'
    mask, which ``rollback_kv_cache_paged`` reuses with ``keep``): token j
    < ``write_len[b]`` of lane b, at absolute position ``pos[b] + j`` (ring
    slot ``(pos + j) % s_c``).  Host numpy, no device sync."""
    b = to_host(table).shape[0]
    posb = np.broadcast_to(to_host(pos).astype(np.int64), (b,))
    j = np.arange(t, dtype=np.int64)[None, :]
    abs_pos = posb[:, None] + j
    mask = j < np.broadcast_to(to_host(write_len).astype(np.int64), (b,))[:, None]
    rows, toks = np.nonzero(mask)
    return _plan(table, rows, toks, abs_pos[rows, toks] % s_c, block_size, device)


def fill_plan(table, lengths, s_c: int, *, block_size: int, device,
              write_start=None) -> WritePlan:
    """The entries of a prompt fill (JAX ``fill_kv_cache_paged``): ring
    slot r of lane b receives the last valid prompt token at a position congruent to r (as
    :func:`_fill_slot_sources`), unless that position lies below
    ``write_start[b]``."""
    b = to_host(table).shape[0]
    last = np.broadcast_to(to_host(lengths).astype(np.int64), (b,))[:, None] - 1
    r = np.arange(s_c, dtype=np.int64)[None, :]
    src = last - np.mod(last - r, s_c)
    ok = src >= 0
    if write_start is not None:
        ok &= src >= to_host(write_start).astype(np.int64)[:, None]
    rows, slots = np.nonzero(ok)
    return _plan(table, rows, src[rows, slots], slots, block_size, device)


def _scatter_pool(pool_leaf, plan: WritePlan, vals) -> None:
    """THE block-table scatter every paged cache write goes through, in
    place: ``vals`` (B, H, T, D) fresh entries, only the plan's."""
    pool_leaf[plan.phys, :, plan.off] = vals[plan.row, :, plan.tok].to(pool_leaf.dtype)


def write_kv_blocks(pool: dict, k, v, plan: WritePlan) -> dict:
    """Write the ``plan``'s fresh K/V entries through the block table, in
    place — the one cache-write helper behind paged decode, prefill fill
    and commit-on-accept.  ``k``/``v`` (B, H, T, D) float, or packed values
    of the pool's spec (passed through)."""
    for name, fresh in (("k", k), ("v", v)):
        # the whole fresh tensor quantizes before the plan selects entries:
        # the per-tensor scale spans every lane of the step, as in JAX
        fresh = quantize_like(pool[name], fresh)
        for leaf, fl in _leaf_pairs(pool[name], fresh):
            _scatter_pool(leaf, plan, fl)
    return pool


def pool_entries(pool: dict, plan: WritePlan) -> dict:
    """Copies of the pool rows a ``plan`` writes, every child of every leaf:
    {'k': [(n, H, D) ...], 'v': ...}."""
    return {name: [leaf[plan.phys, :, plan.off] for leaf in _children(pool[name])]
            for name in ("k", "v")}


def restore_pool_entries(pool: dict, plan: WritePlan, saved: dict) -> dict:
    """Put :func:`pool_entries`' copies back, in place."""
    for name in ("k", "v"):
        for leaf, old in zip(_children(pool[name]), saved[name]):
            leaf[plan.phys, :, plan.off] = old
    return pool


def _attn_decode_paged(layer: Layer, x, cfg, quant, pool: dict, table, posb,
                       plan: WritePlan):
    """Paged twin of :func:`_attn_decode`: the fresh K/V of every lane
    quantize together, the plan's entries go through the block table, and
    attention reads the pool through ``table`` (B, MB) on the device with
    B6/B7 (no gathered view).  Lanes the plan leaves out (idle, or mid
    chunked prefill) write nothing; their output is discarded."""
    b = x.shape[0]
    y = rms_norm(layer.norm1, x, cfg.norm_eps)
    q, k, v = _qkv(layer.attn, y, cfg, quant, posb[:, None])
    write_kv_blocks(pool, k, v, plan)
    s_c = table.shape[1] * pool["k"].shape[2]
    o = paged_decode_attention(q, pool["k"], pool["v"], table, posb,
                               kv_len=_ring_len(layer, posb, s_c))
    o = o.transpose(1, 2).reshape(b, 1, -1)
    return x + dense(layer.attn.wo, o.to(x.dtype), quant, name="wo")


def layer_decode_paged(layer: Layer, x, cfg, pool: dict, table, pos,
                       plan: WritePlan, quant=None, live=None):
    """One paged decode step through one layer; the pool updates in place.
    ``table`` (B, S_c / bs) and ``pos`` (B,) on the device, ``plan`` the
    step's :func:`write_plan` for this layer's ring.  A recurrent layer's
    lanes advance where ``live`` (B,) is set and keep their state bit for
    bit elsewhere (:func:`freeze_state`)."""
    if not layer.has_kv:
        x, new = _rec_decode(layer, x, cfg, quant, pool)
        pool.update(freeze_state(pool, new, live))
        return x
    x = _attn_decode_paged(layer, x, cfg, quant, pool, table, pos, plan)
    return _mlp_part(layer, x, cfg, quant)


def _attn_verify_paged(layer: Layer, x, cfg, quant, pool: dict, table, posb,
                       s_c: int):
    """Paged verify attention with deferred writes: the T queries attend
    the pool's gathered view plus the T fresh K/V; nothing is written, and
    the fresh K/V come back (already quantized, so a later commit replays
    this pass's exact values) for a later :func:`write_kv_blocks`."""
    ck = gather_kv_view(pool["k"], table, s_c)  # both children of a packed pool
    cv = gather_kv_view(pool["v"], table, s_c)
    x, kq, vq = _verify_attend(layer, x, cfg, quant, pool, ck, cv, posb)
    return x, {"k": kq, "v": vq}


def layer_verify_paged(layer: Layer, x, cfg, pool: dict, table, pos, quant=None,
                       s_c: int = 0):
    """T tokens through one layer in paged verify mode (chunked prefill
    rides this path): returns (x, steps) with the fresh per-layer K/V in
    ``steps`` (:func:`write_kv_blocks` commits what is kept), or a
    recurrent layer's per-step states (:func:`select_state_step`).
    Nothing is written."""
    if not layer.has_kv:
        x, _, steps = _rec_verify(layer, x, cfg, quant, pool)
        return x, steps
    x, steps = _attn_verify_paged(layer, x, cfg, quant, pool, table, pos, s_c)
    return _mlp_part(layer, x, cfg, quant), steps


# ---------------- recurrent state: exact row selection ----------------

def _rows_mask(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return m.reshape(-1, *([1] * (like.ndim - 1)))


def freeze_state(old: dict, new: dict, write_len) -> dict:
    """Rows with ``write_len`` > 0 take ``new``, the rest keep ``old`` bit
    for bit: how paged decode and verify freeze the state of idle and
    chunk-phase lanes (their KV twin writes nothing)."""
    m = torch.as_tensor(write_len, device=new["h"].device) > 0
    return {k: torch.where(_rows_mask(m, n), n, old[k].to(n.dtype)) for k, n in new.items()}


def select_state_step(steps: dict, keep, old: dict | None = None) -> dict:
    """Per-row state after the accepted prefix: entry ``keep[b] - 1`` of
    every per-step leaf (B, T, ...) of a verify pass.  With ``old`` (the
    pre-verify state), rows with ``keep`` 0 keep it bit for bit."""
    h = steps["h"]
    keep = torch.as_tensor(keep, device=h.device).to(torch.int64)
    idx = torch.clamp(keep - 1, min=0)
    rows = torch.arange(h.shape[0], device=h.device)
    picked = {k: leaf[rows, idx] for k, leaf in steps.items()}
    return picked if old is None else freeze_state(old, picked, keep)
