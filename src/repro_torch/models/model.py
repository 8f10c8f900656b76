"""LM assembly: embedding -> decoder layers -> final norm -> head.

Port of the dense main path of ``repro.models.model``: :func:`init` (:46),
``embed_tokens`` (:76), ``_head`` (:94), ``forward`` (:125),
``init_cache(kv=)`` (:182), ``_prefill_trunk`` / ``prefill(lengths=, kv=)``
(:206, :242), ``decode_step`` (:370, per-row ``pos``), the dense
``verify_step(collect_rollback=)`` (:450) and ``rollback_cache`` (:505) of
speculative decoding, and the paged
cache's ``init_paged_cache`` (:286), ``prefill_paged`` (:314),
``decode_step_paged`` (:405), ``verify_step_paged`` (:539) and
``rollback_cache_paged`` (:581).  Under a mesh (``parallel``) a rank's
layers hold its head and column shards, its caches its own rows and KV
heads, and :meth:`Model.head` assembles the vocab over 'model'.  The JAX
``lax.scan`` over stacked units becomes a loop over ``Model.layers``
(layer i is unit i // P at pattern position i % P); ``remat`` and ``scan_unroll`` are JAX compile
knobs and have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.core.packed import PackedDSBPWeight
from repro_torch.kvq import kv_policy_cfg
from repro_torch.parallel.context import gather_columns

from . import blocks
from .layers import Quant, rms_norm

__all__ = ["Model", "init", "shared"]

NEG_INF = -1e30


def _step_inputs(table, pos, max_len: int, block_size: int, device):
    """A paged step's device inputs, uploaded once for every layer: the
    block table cut to the ring's ``max_len // block_size`` entries and
    the (B,) positions."""
    nb = max_len // block_size
    if nb * block_size != max_len:
        raise ValueError(f"cache length {max_len} not a multiple of block size "
                         f"{block_size}")
    tab = blocks.to_host(table)
    b = tab.shape[0]
    posb = np.broadcast_to(blocks.to_host(pos).astype(np.int32), (b,))
    return (torch.as_tensor(np.ascontiguousarray(tab[:, :nb], np.int32), device=device),
            torch.as_tensor(np.array(posb), device=device), posb)


class Model(nn.Module):
    """Parameters (JAX tree names): ``embed`` (Vp, d), ``final_norm`` (d,),
    ``lm_head`` (d, Vp), ``layers[i]`` (:class:`blocks.Layer`).  The
    constructor allocates them uninitialized; :func:`init` or
    ``repro_torch.bridge`` fills them."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        if cfg.frontend != "none" or cfg.tie_embeddings or cfg.dtype != "float32":
            raise NotImplementedError(
                "the port serves untied float32 text decoders; frontend "
                f"{cfg.frontend!r}, tie_embeddings={cfg.tie_embeddings}, dtype "
                f"{cfg.dtype!r} are not ported yet")
        self.cfg = cfg
        vp, d = cfg.padded_vocab_size, cfg.d_model
        self.embed = blocks._weight((vp, d), device)
        self.final_norm = blocks._weight((d,), device)
        self.lm_head = blocks._weight((d, vp), device)
        kinds = list(cfg.pattern) * cfg.n_units + list(cfg.tail)
        self.layers = nn.ModuleList(blocks.Layer(cfg, kind, device) for kind in kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def default_quant(self) -> Quant:
        return Quant(self.cfg.quant, self.cfg.quant_method)

    # ---------------- embedding / head ----------------

    def embed_tokens(self, tokens: torch.Tensor):
        """tokens (B, S) -> (x (B, S, d), positions (S,))."""
        x = self.embed[tokens]
        return x, torch.arange(x.shape[1], device=x.device)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocab; padded rows masked to -1e30.
        Under a mesh a rank holds its own vocab columns of ``lm_head`` (the
        JAX placement) and the logits assemble over 'model'."""
        logits = gather_columns(torch.matmul(x, self.lm_head.to(x.dtype)), "lm_head",
                                self.cfg.padded_vocab_size)
        vp, v = self.cfg.padded_vocab_size, self.cfg.vocab_size
        if vp != v:
            valid = torch.arange(logits.shape[-1], device=logits.device) % vp < v
            logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        return logits

    # ---------------- sequence mode ----------------

    def forward(self, tokens: torch.Tensor, quant: Quant | None = None) -> torch.Tensor:
        """Sequence-mode logits (B, S, Vp)."""
        quant = self.default_quant() if quant is None else quant
        x, positions = self.embed_tokens(tokens)
        for layer in self.layers:
            x, _ = blocks.layer_seq(layer, x, self.cfg, quant, positions)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps))

    def prefill_trunk(self, tokens: torch.Tensor, lengths=None,
                      quant: Quant | None = None):
        """The prompt forward: returns (per-row last-valid-token logits
        (B, 1, Vp), per-layer (k, v), fill_len) with fill_len the (B,)
        lengths, or the int prompt width when ``lengths`` is None."""
        quant = self.default_quant() if quant is None else quant
        x, positions = self.embed_tokens(tokens)
        length = x.shape[1]
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
        kvs = []
        for layer in self.layers:
            x, kv = blocks.layer_seq(layer, x, self.cfg, quant, positions, lengths)
            kvs.append(kv)
        x = rms_norm(self.final_norm, x, self.cfg.norm_eps)
        if lengths is None:
            x_last = x[:, -1:]
        else:  # per-row last valid position, not the pad slot
            idx = (lengths.to(torch.int64) - 1).clamp(0, length - 1)
            x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return self.head(x_last), kvs, (length if lengths is None else lengths)

    # ---------------- caches / serving ----------------

    def cache_entry_name(self, i: int) -> str:
        """The JAX cache-tree name of layer i's entry (``units.<pattern
        position>`` or ``tail.<j>``), the key of a per-entry KV spec."""
        p = len(self.cfg.pattern)
        base = self.cfg.n_units * p
        return f"units.{i % p}" if i < base else f"tail.{i - base}"

    def cache_tree(self, cache: list[dict]) -> dict:
        """The per-layer cache grouped by JAX cache entry: ``{"units": [the
        layers at pattern position p, ...], "tail": [[layer], ...]}`` (no
        copy), the granularity of ``repro_torch.obs.health``."""
        tree = {"units": [[] for _ in self.cfg.pattern], "tail": [[] for _ in self.cfg.tail]}
        for i, c in enumerate(cache):
            fam, _, j = self.cache_entry_name(i).partition(".")
            tree[fam][int(j)].append(c)
        return tree

    def init_cache(self, batch: int, max_len: int, kv=None) -> list[dict]:
        """Per-layer ``{'k', 'v'}`` caches; ``kv`` an optional KV-quant spec
        (preset name / bits / config, or a mapping keyed ``units.<i>`` /
        ``tail.<i>`` with a ``default``) makes them packed."""
        return [blocks.init_layer_cache(self.cfg, batch, max_len, self.device,
                                        kv=kv_policy_cfg(kv, self.cache_entry_name(i)),
                                        n_kv_heads=layer.kv_heads(self.cfg))
                for i, layer in enumerate(self.layers)]

    def prefill(self, tokens: torch.Tensor, max_len: int, lengths=None,
                quant: Quant | None = None, kv=None):
        """Run the prompt; returns (last-valid-position logits, a fresh
        cache of ``max_len`` slots holding each row's prefix, fill_len)."""
        logits, kvs, fill_len = self.prefill_trunk(tokens, lengths, quant)
        cache = self.init_cache(tokens.shape[0], max_len, kv=kv)
        for c, (k, v) in zip(cache, kvs):
            blocks.fill_kv_cache(c, k, v, fill_len)
        return logits, cache, fill_len

    def decode_step(self, tokens: torch.Tensor, cache: list[dict], pos,
                    quant: Quant | None = None):
        """One token per row: tokens (B, 1), pos an int or (B,) absolute
        position of each row's token.  The cache updates in place; returns
        (logits (B, 1, Vp), cache)."""
        quant = self.default_quant() if quant is None else quant
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device).expand(b)
        x = self.embed[tokens]
        for layer, c in zip(self.layers, cache):
            x = blocks.layer_decode(layer, x, self.cfg, c, pos, quant)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps)), cache

    # ---------------- speculative verification ----------------

    def verify_step(self, tokens: torch.Tensor, cache: list[dict], pos,
                    quant: Quant | None = None, collect_rollback: bool = False):
        """T tokens per row in one forward (token j of row b at position
        pos[b] + j; T <= the cache length): logits (B, T, Vp) equal to T
        chained :meth:`decode_step` calls, the cache advanced by all T
        tokens in place.  With ``collect_rollback`` also the old content
        of the T slots of every layer (:meth:`kv_slots`, taken before the
        writes), for :meth:`rollback_cache`.  Returns (logits, cache) or
        (logits, cache, rollback)."""
        quant = self.default_quant() if quant is None else quant
        b, t = tokens.shape[:2]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device).expand(b)
        rollback = self.kv_slots(cache, pos, t) if collect_rollback else None
        x = self.embed[tokens]
        for layer, c in zip(self.layers, cache):
            x = blocks.layer_verify(layer, x, self.cfg, c, pos, quant)
        logits = self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps))
        return (logits, cache, rollback) if collect_rollback else (logits, cache)

    def kv_slots(self, cache: list[dict], pos, n: int) -> list[dict]:
        """Copies of ring slots pos .. pos+n-1 of every row and layer (every
        child of a packed leaf): what a speculative round overwrites, a
        few kilobytes per row and layer."""
        b = cache[0]["k"].shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b)
        return [blocks.kv_slots(c, pos, n) for c in cache]

    def rollback_cache(self, cache: list[dict], rollback: list[dict], keep, pos,
                       n_new: int) -> list[dict]:
        """Roll a :meth:`verify_step`-advanced cache back to the accepted
        prefix in place: row b keeps its first ``keep[b]`` (1 .. n_new)
        verified tokens, and the slots of the rest get ``rollback`` (their
        content before the round) back, so the cache equals the pre-round
        cache plus the accepted writes, bit for bit."""
        b = cache[0]["k"].shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b)
        for c, old in zip(cache, rollback):
            blocks.rollback_kv_cache(c, old, keep, pos, n_new)
        return cache

    # ---------------- paged cache ----------------

    def init_paged_cache(self, num_blocks: int, block_size: int, kv=None) -> list[dict]:
        """Per-layer block pools ``{'k', 'v'}`` (NB, Hkv, bs, D), shared by
        every lane and addressed through per-lane block tables; one block
        id spans ``block_size`` ring slots of every layer at once."""
        return [blocks.init_layer_cache_paged(
                    self.cfg, num_blocks, block_size, self.device,
                    kv=kv_policy_cfg(kv, self.cache_entry_name(i)))
                for i in range(len(self.layers))]

    def prefill_paged(self, tokens: torch.Tensor, cache: list[dict], table, max_len: int,
                      lengths=None, write_start=None, quant: Quant | None = None):
        """Prompt admission into the block pools: the same trunk as
        :meth:`prefill` (the same logits), each layer's K/V scattered
        through ``table`` (B_adm, MB) in place; ``write_start`` (B_adm,)
        skips positions below it (prefix hits stay shared).  Returns
        (logits, cache, fill_len)."""
        logits, kvs, fill_len = self.prefill_trunk(tokens, lengths, quant)
        bs = cache[0]["k"].shape[2]
        # the plan from the host's lengths: no device-to-host copy
        plan = blocks.fill_plan(table, fill_len if lengths is None else lengths, max_len,
                                block_size=bs, device=self.device, write_start=write_start)
        for c, (k, v) in zip(cache, kvs):
            blocks.write_kv_blocks(c, k, v, plan)
        return logits, cache, fill_len

    def decode_step_paged(self, tokens: torch.Tensor, cache: list[dict], table, pos,
                          write_len, max_len: int, quant: Quant | None = None):
        """One token per lane through the block pools: ``table`` (B, MB),
        ``pos`` and ``write_len`` (B,) as host arrays (the plan of the
        step's writes is computed once on the host; the table and the
        positions go to the device once for all layers).  Lanes with
        ``write_len`` 0 write nothing and their logits are to be ignored.
        Returns (logits (B, 1, Vp), cache)."""
        quant = self.default_quant() if quant is None else quant
        bs = cache[0]["k"].shape[2]
        tab, posd, posb = _step_inputs(table, pos, max_len, bs, self.device)
        plan = blocks.write_plan(table, posb, write_len, 1, max_len, block_size=bs,
                                 device=self.device)
        x = self.embed[tokens]
        for layer, c in zip(self.layers, cache):
            x = blocks.layer_decode_paged(layer, x, self.cfg, c, tab, posd, plan, quant)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps)), cache

    def verify_step_paged(self, tokens: torch.Tensor, cache: list[dict], table, pos,
                          max_len: int, quant: Quant | None = None):
        """T tokens per lane (token j of lane b at position pos[b] + j) in
        one forward with deferred commit: returns (logits (B, T, Vp),
        steps), ``steps`` the per-layer fresh K/V for
        :meth:`rollback_cache_paged`.  Nothing is written."""
        quant = self.default_quant() if quant is None else quant
        bs = cache[0]["k"].shape[2]
        tab, posd, _ = _step_inputs(table, pos, max_len, bs, self.device)
        x = self.embed[tokens]
        steps = []
        for layer, c in zip(self.layers, cache):
            x, st = blocks.layer_verify_paged(layer, x, self.cfg, c, tab, posd, quant,
                                              s_c=max_len)
            steps.append(st)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps)), steps

    def rollback_cache_paged(self, cache: list[dict], table, steps, keep, pos,
                             max_len: int) -> list[dict]:
        """Commit the first ``keep[b]`` fresh entries of each lane of a
        :meth:`verify_step_paged` pass (0 freezes a lane), in place."""
        bs = cache[0]["k"].shape[2]
        plan = blocks.write_plan(table, pos, keep, steps[0]["k"].shape[2], max_len,
                                 block_size=bs, device=self.device)
        for c, st in zip(cache, steps):
            blocks.write_kv_blocks(c, st["k"], st["v"], plan)
        return cache


def init(cfg: ArchConfig, *, seed: int = 0, device=None) -> Model:
    """Random weights with the JAX package's shapes and scales: every
    projection and embedding ~ N(0, 1) * d_in**-0.5, norms 1.  Drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device (the
    numbers differ from ``jax.random``'s; parity tests bridge weights)."""
    device = resolve_device(device)
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "final_norm" or name.endswith("norm1") or name.endswith("norm2"):
                p.fill_(1.0)
            else:  # embed rows are (Vp, d): its fan-in is d as well
                fan_in = cfg.d_model if name == "embed" else p.shape[0]
                p.normal_(generator=gen).mul_(fan_in ** -0.5)
    return model


def shared(model: Model, cfg: ArchConfig | None = None) -> Model:
    """A second :class:`Model` over the SAME tensors as ``model`` (no copy,
    nothing allocated: it is built on the meta device and then handed the
    parameters and packed containers of ``model``), under ``cfg`` (default
    ``model.cfg``).  Swapping a projection of one (packing it, or
    replacing its container) leaves the other as it was: the JAX package's
    functional trees, where a packed tree shares the raw tree's other
    leaves.  The policy loop runs its trial models and its float
    reference this way over one resident raw model."""
    view = Model(cfg or model.cfg, torch.device("meta"))
    for mod_name, module in model.named_modules():
        if isinstance(module, PackedDSBPWeight):
            continue  # set as its parent's child below
        target = view.get_submodule(mod_name) if mod_name else view
        for name, p in module.named_parameters(recurse=False):
            setattr(target, name, p)
        for name, child in module.named_children():
            if isinstance(child, PackedDSBPWeight):
                delattr(target, name)
                setattr(target, name, child)
    return view
