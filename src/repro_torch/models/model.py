"""LM assembly: embedding -> decoder layers -> final norm -> head.

Port of the dense main path of ``repro.models.model``: :func:`init` (:46),
``embed_tokens`` (:76), ``_head`` (:94), ``forward`` (:125),
``init_cache(kv=)`` (:182), ``_prefill_trunk`` / ``prefill(lengths=, kv=)``
(:206, :242) and ``decode_step`` (:370, per-row ``pos``).  The JAX
``lax.scan`` over stacked units becomes a loop over ``Model.layers``
(layer i is unit i // P at pattern position i % P); ``remat`` and ``scan_unroll`` are JAX compile
knobs and have no counterpart here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.kvq import kv_policy_cfg

from . import blocks
from .layers import Quant, rms_norm

__all__ = ["Model", "init"]

NEG_INF = -1e30


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
        """Logits over the padded vocab; padded rows masked to -1e30."""
        logits = torch.matmul(x, self.lm_head.to(x.dtype))
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

    def init_cache(self, batch: int, max_len: int, kv=None) -> list[dict]:
        """Per-layer ``{'k', 'v'}`` caches; ``kv`` an optional KV-quant spec
        (preset name / bits / config, or a mapping keyed ``units.<i>`` /
        ``tail.<i>`` with a ``default``) makes them packed."""
        return [blocks.init_layer_cache(self.cfg, batch, max_len, self.device,
                                        kv=kv_policy_cfg(kv, self.cache_entry_name(i)))
                for i in range(len(self.layers))]

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
