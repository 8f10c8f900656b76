"""LM assembly: embedding -> decoder layers -> final norm -> head.

Port of the dense main path of ``repro.models.model``: :func:`init` (:46),
``embed_tokens`` (:76), ``_head`` (:94), ``forward(no_drop=)`` (:125),
``init_cache(kv=)`` (:182), ``_prefill_trunk`` / ``prefill(lengths=, kv=)``
(:206, :242), ``decode_step`` (:370, per-row ``pos``), the dense
``verify_step(collect_rollback=)`` (:450) and ``rollback_cache`` (:505) of
speculative decoding, and the paged
cache's ``init_paged_cache`` (:286), ``prefill_paged`` (:314),
``decode_step_paged`` (:405), ``verify_step_paged`` (:539) and
``rollback_cache_paged`` (:581).  The Griffin hybrid's layers
(``rglru``, ``attn_local``) and tied embeddings (``_head`` :94 reads
``embed.T``) run through all of them: each KV layer keeps its own ring
length (``blocks.cache_len``, as JAX :425-430), the paged steps plan
their writes and cut their tables once per ring length, and recurrent
state rides in the same per-layer list (``select_state_step`` in the
rollbacks, JAX :505-537 and :581-613).  Under a mesh (``parallel``) a rank's
layers hold its head and column shards, its caches its own rows and KV
heads, and :meth:`Model.head` assembles the vocab over 'model'.  The JAX
``lax.scan`` over stacked units becomes a loop over ``Model.layers``
(layer i is unit i // P at pattern position i % P); ``scan_unroll`` is a
JAX compile knob with no counterpart here, and ``remat`` checkpoints each
layer of :func:`loss_fn`'s forward (JAX checkpoints each unit, :139).
An MoE config's layers carry :class:`~.moe.MoE` blocks; the prefill and every cached step run them with
nothing dropped (JAX :221, :230).  The Mamba-2 family's ``ssd`` layers
carry their state like the RG-LRU's; a model of only such layers has no
KV entry at all, and its head masks the padded vocab columns as every
head does (mamba2-370m: 50,280 of 50,432).  :func:`init` with ``pack=`` draws and
packs one layer at a time, for models larger than the card in f32.

The two modality frontends (JAX :37-41, :76-91, :358-367) are stubs over
the dense stack, as in the reference: ``audio_codebooks`` (musicgen-large)
takes (B, S, K) codebook ids, sums K embedding rows at offsets ``k * Vp``
and reads K heads of Vp columns each (``embed`` and ``lm_head`` have
``_vocab_rows`` = K * Vp rows, and the head masks the pad columns of every
block); ``vlm_patches`` (llava-next-34b) prepends precomputed
``image_embeds`` (B, S_img, d) to the text embeddings, and ``lengths``
count embedded positions, the image prefix included.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.core.packed import PackedDSBPWeight
from repro_torch.kvq import kv_policy_cfg
from repro_torch.parallel.context import gather_columns

from . import blocks
from .layers import Quant, param_dtype, rms_norm, weight
from .packing import pack_weights_int8

__all__ = ["Model", "init", "shared", "loss_fn", "check_trainable"]

NEG_INF = -1e30


def _vocab_rows(cfg: ArchConfig) -> int:
    """Embedding / head rows: the padded vocab (times the codebooks for
    audio), JAX ``_vocab_rows``."""
    if cfg.frontend == "audio_codebooks":
        return cfg.padded_vocab_size * cfg.n_codebooks
    return cfg.padded_vocab_size


def _step_tables(table, scs, block_size: int, device) -> dict:
    """A paged step's block tables on the device, uploaded once for every
    layer: for each ring length S_c of the model, the (B, S_c / bs) int32
    table (one table entry spans ``block_size`` ring slots of every KV
    layer, so a shorter ring reads the first entries)."""
    tab = blocks.to_host(table)
    out = {}
    for s_c in scs:
        nb = s_c // block_size
        if nb * block_size != s_c:
            raise ValueError(f"cache length {s_c} not a multiple of block size "
                             f"{block_size}")
        out[s_c] = torch.as_tensor(np.ascontiguousarray(tab[:, :nb], np.int32),
                                   device=device)
    return out


def _host_pos(table, pos) -> np.ndarray:
    b = blocks.to_host(table).shape[0]
    return np.array(np.broadcast_to(blocks.to_host(pos).astype(np.int32), (b,)))


class Model(nn.Module):
    """Parameters (JAX tree names): ``embed`` (Vp, d), ``final_norm`` (d,),
    ``lm_head`` (d, Vp) unless the embeddings are tied (the head is then
    ``embed.T``), ``layers[i]`` (:class:`blocks.Layer`); an audio model's
    ``embed`` and ``lm_head`` have K * Vp rows / columns.  The constructor
    allocates them uninitialized; :func:`init` or ``repro_torch.bridge``
    fills them.

    ``cfg.dtype`` "bfloat16" gives bf16 parameters, activations and KV
    caches (JAX ``init``, :33-55), with the f32 leaves JAX keeps (the
    RG-LRU's ``lam`` / ``ba`` / ``bx``, the SSD's ``a_log`` / ``dt_bias`` /
    ``d_skip``, recurrent ``h`` states); the DSBP GEMM runs in f32 between
    a cast of its input and of its output, as JAX's method does.

    The cache is one entry per layer: a KV layer's ``{'k', 'v'}`` (dense:
    (B, Hkv, S_c, D) with S_c = :func:`blocks.cache_len`; paged: a block
    pool) or a recurrent layer's per-lane state ``{'h', 'conv'}``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r}: a model is float32 or bfloat16")
        self.cfg = cfg
        rows, d, dt = _vocab_rows(cfg), cfg.d_model, param_dtype(cfg)
        self.embed = weight((rows, d), device, dt)
        self.final_norm = weight((d,), device, dt)
        if not cfg.tie_embeddings:
            self.lm_head = weight((d, rows), device, dt)
        kinds = list(cfg.pattern) * cfg.n_units + list(cfg.tail)
        self.layers = nn.ModuleList(blocks.Layer(cfg, kind, device) for kind in kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def default_quant(self) -> Quant:
        return Quant(self.cfg.quant, self.cfg.quant_method)

    def ring_lens(self, max_len: int) -> list:
        """Each layer's ring length S_c under ``max_len`` (None for a
        recurrent layer)."""
        return [blocks.cache_len(self.cfg, layer.kind, max_len) if layer.has_kv else None
                for layer in self.layers]

    def kv_ring_lens(self, max_len: int) -> list[int]:
        """The distinct ring lengths of the KV layers, ascending (JAX's
        ``Engine._kv_scs``)."""
        return sorted({s for s in self.ring_lens(max_len) if s is not None})

    # ---------------- embedding / head ----------------

    def embed_tokens(self, tokens: torch.Tensor, image_embeds=None):
        """tokens (B, S) (audio: (B, S, K) codebook ids) -> (x (B, S', d),
        positions (S',)); ``image_embeds`` (B, S_img, d) of a vlm model go
        in front of the text, so S' = S_img + S."""
        x = self.embed_step(tokens)
        if self.cfg.frontend == "vlm_patches":
            if image_embeds is None:
                raise ValueError("a vlm_patches model takes image_embeds (B, S_img, d)")
            img = torch.as_tensor(image_embeds, device=x.device).to(x.dtype)
            x = torch.cat([img, x], dim=1)
        return x, torch.arange(x.shape[1], device=x.device)

    def embed_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding of sequence and step mode alike: (B, T) ids
        -> (B, T, d); audio (B, T, K) codebook ids, row ``tok + k * Vp``
        of each codebook k, summed over k (JAX ``_embed_step``)."""
        if self.cfg.frontend == "audio_codebooks":
            k = self.cfg.n_codebooks
            offs = torch.arange(k, dtype=tokens.dtype, device=tokens.device)
            return self.embed[tokens + offs * self.cfg.padded_vocab_size].sum(dim=2)
        return self.embed[tokens]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocab; padded rows masked to -1e30 (in
        every codebook block of an audio head: ``col % Vp < V``).  Tied
        embeddings read ``embed.T`` (a plain matmul, as JAX's
        ``_head``).  Under a mesh a rank holds its own vocab columns of
        ``lm_head`` (the JAX placement) and the logits assemble over
        'model'."""
        if self.cfg.tie_embeddings:
            logits = torch.matmul(x, self.embed.to(x.dtype).T)
        else:
            logits = gather_columns(torch.matmul(x, self.lm_head.to(x.dtype)), "lm_head",
                                    _vocab_rows(self.cfg))
        vp, v = self.cfg.padded_vocab_size, self.cfg.vocab_size
        if vp != v:
            valid = torch.arange(logits.shape[-1], device=logits.device) % vp < v
            logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        return logits

    # ---------------- sequence mode ----------------

    def forward(self, tokens: torch.Tensor, quant: Quant | None = None,
                no_drop: bool = False, image_embeds=None) -> torch.Tensor:
        """Sequence-mode logits (B, S, Vp) (audio: K * Vp columns; vlm:
        S_img + S positions).  ``no_drop=True`` lifts the MoE capacity (JAX
        :126), so a row's logits do not depend on the rest of its batch."""
        quant = self.default_quant() if quant is None else quant
        x, positions = self.embed_tokens(tokens, image_embeds)
        for layer in self.layers:
            x, _ = blocks.layer_seq(layer, x, self.cfg, quant, positions, no_drop=no_drop)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps))

    def prefill_trunk(self, tokens: torch.Tensor, lengths=None,
                      quant: Quant | None = None, image_embeds=None):
        """The prompt forward: returns (per-row last-valid-token logits
        (B, 1, Vp), per-layer aux — (k, v) of a KV layer, the end state of
        a recurrent one — and fill_len) with fill_len the (B,) lengths, or
        the int prompt width when ``lengths`` is None.  ``lengths`` count
        embedded positions: a vlm row's image prefix is part of them."""
        quant = self.default_quant() if quant is None else quant
        x, positions = self.embed_tokens(tokens, image_embeds)
        length = x.shape[1]
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
        auxs = []
        for layer in self.layers:
            x, aux = blocks.layer_seq(layer, x, self.cfg, quant, positions, lengths,
                                      no_drop=True)
            auxs.append(aux)
        x = rms_norm(self.final_norm, x, self.cfg.norm_eps)
        if lengths is None:
            x_last = x[:, -1:]
        else:  # per-row last valid position, not the pad slot
            idx = (lengths.to(torch.int64) - 1).clamp(0, length - 1)
            x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return self.head(x_last), auxs, (length if lengths is None else lengths)

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
        """Per-layer caches: ``{'k', 'v'}`` of each KV layer's ring length,
        zero ``{'h', 'conv'}`` of each recurrent one; ``kv`` an optional
        KV-quant spec (preset name / bits / config, or a mapping keyed
        ``units.<i>`` / ``tail.<i>`` with a ``default``) makes the KV ones
        packed."""
        return [blocks.init_layer_cache(self.cfg, batch, max_len, self.device,
                                        kv=kv_policy_cfg(kv, self.cache_entry_name(i)),
                                        n_kv_heads=layer.kv_heads(self.cfg) if layer.has_kv
                                        else None, kind=layer.kind)
                for i, layer in enumerate(self.layers)]

    def fill_cache(self, cache: list[dict], auxs, fill_len, slots=None, rows=None) -> list[dict]:
        """Write a prefill's per-layer aux into the cache in place: all rows,
        or fresh rows ``rows`` into cache rows ``slots`` (one each); a KV
        layer through :func:`blocks.fill_kv_cache`, a recurrent one's end
        state row for row."""
        for layer, c, aux in zip(self.layers, cache, auxs):
            if layer.has_kv:
                blocks.fill_kv_cache(c, *aux, fill_len, slots=slots, rows=rows)
            elif slots is None:
                c.update(aux)
            else:
                sl = torch.as_tensor(slots, device=self.device)
                for name, leaf in c.items():
                    leaf[sl] = aux[name][rows].to(leaf.dtype)
        return cache

    def prefill(self, tokens: torch.Tensor, max_len: int, lengths=None,
                quant: Quant | None = None, kv=None, image_embeds=None):
        """Run the prompt; returns (last-valid-position logits, a fresh
        cache of ``max_len`` positions holding each row's prefix, fill_len)."""
        logits, auxs, fill_len = self.prefill_trunk(tokens, lengths, quant, image_embeds)
        cache = self.init_cache(tokens.shape[0], max_len, kv=kv)
        return logits, self.fill_cache(cache, auxs, fill_len), fill_len

    def decode_step(self, tokens: torch.Tensor, cache: list[dict], pos,
                    quant: Quant | None = None):
        """One token per row: tokens (B, 1) (audio: (B, 1, K)), pos an int
        or (B,) absolute position of each row's token.  The cache updates
        in place; returns (logits (B, 1, Vp), cache)."""
        quant = self.default_quant() if quant is None else quant
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device).expand(b)
        x = self.embed_step(tokens)
        for layer, c in zip(self.layers, cache):
            x = blocks.layer_decode(layer, x, self.cfg, c, pos, quant)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps)), cache

    # ---------------- recurrent state: keep and restore ----------------

    def state_refs(self, cache: list[dict]) -> list:
        """The current state tensors of every recurrent layer (a shallow
        copy of its dict; None for KV layers): no copy of any tensor, since
        a step replaces state and never writes into it."""
        return [None if layer.has_kv else dict(c) for layer, c in zip(self.layers, cache)]

    def restore_states(self, cache: list[dict], refs: list) -> list[dict]:
        """Put back the recurrent states of :meth:`state_refs` (or of
        :meth:`kv_slots` / :meth:`pool_entries`), in place; KV layers are
        left as they are."""
        for layer, c, r in zip(self.layers, cache, refs):
            if not layer.has_kv:
                c.update(r)
        return cache

    def undo_draft(self, cache: list[dict], saved: list, pos, n: int) -> list[dict]:
        """Undo a speculative draft's writes to a dense cache before the
        verify, in place, from :meth:`kv_slots`' ``saved``: recurrent
        layers get their pre-round state back, and ``attn_local`` rings
        their slots pos .. pos+n-1.  On a ring those slots hold live
        history once it has wrapped (slot r reads as the last position
        below pos congruent to r), which the verify's earlier queries still
        attend; a full-length cache needs nothing, since the verify masks
        every slot at or past pos there."""
        b = _batch(cache)
        posd = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b)
        zero = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.restore_states(cache, saved)
        for layer, c, old in zip(self.layers, cache, saved):
            if layer.kind == "attn_local":
                blocks.rollback_kv_cache(c, old, zero, posd, n)
        return cache

    # ---------------- speculative verification ----------------

    def verify_step(self, tokens: torch.Tensor, cache: list[dict], pos,
                    quant: Quant | None = None, collect_rollback: bool = False,
                    saved: list | None = None):
        """T tokens per row in one forward (token j of row b at position
        pos[b] + j; T <= every ring length): logits (B, T, Vp) equal to T
        chained :meth:`decode_step` calls, the cache advanced by all T
        tokens in place.  With ``collect_rollback`` also what
        :meth:`rollback_cache` needs: per KV layer the old content of its
        T slots (:meth:`kv_slots`, taken before the writes, or ``saved``
        when the caller took them earlier), per recurrent layer the pass's
        per-step states.  Returns (logits, cache) or (logits, cache,
        rollback)."""
        quant = self.default_quant() if quant is None else quant
        b, t = tokens.shape[:2]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device).expand(b)
        rollback = None
        if collect_rollback:
            rollback = list(saved if saved is not None else self.kv_slots(cache, pos, t))
        x = self.embed_step(tokens)
        for i, (layer, c) in enumerate(zip(self.layers, cache)):
            x, steps = blocks.layer_verify(layer, x, self.cfg, c, pos, quant)
            if rollback is not None and not layer.has_kv:
                rollback[i] = steps
        logits = self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps))
        return (logits, cache, rollback) if collect_rollback else (logits, cache)

    def kv_slots(self, cache: list[dict], pos, n: int) -> list:
        """What a speculative round overwrites: copies of ring slots pos ..
        pos+n-1 of every row of each KV layer (every child of a packed
        leaf, a few kilobytes per row and layer), and the state of each
        recurrent layer (:meth:`state_refs`, no copy)."""
        b = _batch(cache)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b)
        return [blocks.kv_slots(c, pos, n) if r is None else r
                for c, r in zip(cache, self.state_refs(cache))]

    def rollback_cache(self, cache: list[dict], rollback: list, keep, pos,
                       n_new: int) -> list[dict]:
        """Roll a :meth:`verify_step`-advanced cache back to the accepted
        prefix in place: row b keeps its first ``keep[b]`` (1 .. n_new)
        verified tokens.  KV layers get the old content of the rejected
        slots back (``rollback`` from :meth:`kv_slots`), recurrent layers
        take the per-step state at ``keep[b] - 1`` of the verify pass, so
        the cache equals the pre-round cache plus the accepted tokens, bit
        for bit."""
        b = _batch(cache)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b)
        for layer, c, old in zip(self.layers, cache, rollback):
            if layer.has_kv:
                blocks.rollback_kv_cache(c, old, keep, pos, n_new)
            else:
                c.update(blocks.select_state_step(old, keep))
        return cache

    # ---------------- paged cache ----------------

    def init_paged_cache(self, num_blocks: int, block_size: int, kv=None,
                         batch: int = 0) -> list[dict]:
        """Per-layer block pools ``{'k', 'v'}`` (NB, Hkv, bs, D), shared by
        every lane and addressed through per-lane block tables (one block
        id spans ``block_size`` ring slots of every KV layer at once), and
        the dense zero state of ``batch`` lanes of each recurrent layer."""
        return [blocks.init_layer_cache_paged(
                    self.cfg, num_blocks, block_size, self.device,
                    kv=kv_policy_cfg(kv, self.cache_entry_name(i)), kind=layer.kind,
                    batch=batch)
                for i, layer in enumerate(self.layers)]

    def write_plans(self, table, pos, write_len, t: int, max_len: int, *,
                    block_size: int) -> dict:
        """One :func:`blocks.write_plan` per ring length S_c of the model:
        T tokens per lane from ``pos``, the first ``write_len[b]`` of lane b."""
        return {s_c: blocks.write_plan(table, pos, write_len, t, s_c, block_size=block_size,
                                       device=self.device)
                for s_c in self.kv_ring_lens(max_len)}

    def pool_entries(self, cache: list[dict], plans: dict, max_len: int) -> list:
        """Copies of the pool rows ``plans`` write (:meth:`write_plans`) of
        each KV layer, and each recurrent layer's state (no copy): what a
        paged speculative draft overwrites."""
        return [blocks.pool_entries(c, plans[s]) if r is None else r
                for c, s, r in zip(cache, self.ring_lens(max_len), self.state_refs(cache))]

    def restore_pool_entries(self, cache: list[dict], plans: dict, saved: list,
                             max_len: int) -> list[dict]:
        """Put :meth:`pool_entries`' copies and states back, in place."""
        self.restore_states(cache, saved)
        for c, s, old in zip(cache, self.ring_lens(max_len), saved):
            if s is not None:
                blocks.restore_pool_entries(c, plans[s], old)
        return cache

    def insert_states(self, cache: list[dict], src: list[dict], rows, lanes) -> list[dict]:
        """Write rows ``rows`` of the recurrent states in ``src`` (the
        per-layer output of :meth:`prefill_paged`) into the lanes ``lanes``
        of the pool's recurrent layers, in place; KV layers were written
        through the block tables already (JAX ``_cache_insert``, mode
        'src').  ``src`` None writes zeros: a lane that starts a chunked
        prefill from the pristine state (mode 'pool')."""
        if not len(lanes):
            return cache
        ln = torch.as_tensor(np.asarray(lanes, np.int64), device=self.device)
        rw = None if src is None else torch.as_tensor(np.asarray(rows, np.int64),
                                                      device=self.device)
        for i, (layer, c) in enumerate(zip(self.layers, cache)):
            if layer.has_kv:
                continue
            for name, leaf in c.items():
                leaf[ln] = 0 if src is None else src[i][name][rw].to(leaf.dtype)
        return cache

    def prefill_paged(self, tokens: torch.Tensor, cache: list[dict], table, max_len: int,
                      lengths=None, write_start=None, quant: Quant | None = None):
        """Prompt admission into the block pools: the same trunk as
        :meth:`prefill` (the same logits), each KV layer's K/V scattered
        through ``table`` (B_adm, MB) in place; ``write_start`` (B_adm,)
        skips positions below it (prefix hits stay shared).  Returns
        (logits, per-layer entries, fill_len): the pools of the KV layers,
        and in place of each recurrent layer's lane state the admitted
        rows' end states (B_adm, ...), for :meth:`insert_states`, as JAX's
        ``prefill_paged`` returns them."""
        logits, auxs, fill_len = self.prefill_trunk(tokens, lengths, quant)
        bs = blocks.pool_block_size(cache)
        # the plans from the host's lengths: no device-to-host copy
        lens = fill_len if lengths is None else lengths
        plans = {s_c: blocks.fill_plan(table, lens, s_c, block_size=bs, device=self.device,
                                       write_start=write_start)
                 for s_c in self.kv_ring_lens(max_len)}
        out = list(cache)
        for i, (c, s_c, aux) in enumerate(zip(cache, self.ring_lens(max_len), auxs)):
            if s_c is None:
                out[i] = aux
            else:
                blocks.write_kv_blocks(c, *aux, plans[s_c])
        return logits, out, fill_len

    def decode_step_paged(self, tokens: torch.Tensor, cache: list[dict], table, pos,
                          write_len, max_len: int, quant: Quant | None = None):
        """One token per lane through the block pools: ``table`` (B, MB),
        ``pos`` and ``write_len`` (B,) as host arrays (the plan of the
        step's writes is computed once per ring length on the host; the
        tables and the positions go to the device once for all layers).
        Lanes with ``write_len`` 0 write nothing, keep their recurrent
        state, and their logits are to be ignored.  Returns (logits (B, 1,
        Vp), cache)."""
        quant = self.default_quant() if quant is None else quant
        bs = blocks.pool_block_size(cache)
        scs = self.ring_lens(max_len)
        tabs = _step_tables(table, self.kv_ring_lens(max_len), bs, self.device)
        posb = _host_pos(table, pos)
        posd = torch.as_tensor(posb, device=self.device)
        plans = self.write_plans(table, posb, write_len, 1, max_len, block_size=bs)
        live = None
        if any(s is None for s in scs):
            live = torch.as_tensor(blocks.to_host(write_len) > 0, device=self.device)
        x = self.embed_step(tokens)
        for layer, c, s_c in zip(self.layers, cache, scs):
            x = blocks.layer_decode_paged(layer, x, self.cfg, c, tabs.get(s_c), posd,
                                          plans.get(s_c), quant, live=live)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps)), cache

    def verify_step_paged(self, tokens: torch.Tensor, cache: list[dict], table, pos,
                          max_len: int, quant: Quant | None = None):
        """T tokens per lane (token j of lane b at position pos[b] + j) in
        one forward with deferred commit: returns (logits (B, T, Vp),
        steps), ``steps`` the per-layer fresh K/V or per-step recurrent
        states for :meth:`rollback_cache_paged`.  Nothing is written."""
        quant = self.default_quant() if quant is None else quant
        bs = blocks.pool_block_size(cache)
        scs = self.ring_lens(max_len)
        tabs = _step_tables(table, self.kv_ring_lens(max_len), bs, self.device)
        posd = torch.as_tensor(_host_pos(table, pos), device=self.device)
        x = self.embed_step(tokens)
        steps = []
        for layer, c, s_c in zip(self.layers, cache, scs):
            x, st = blocks.layer_verify_paged(layer, x, self.cfg, c, tabs.get(s_c), posd,
                                              quant, s_c=s_c or 0)
            steps.append(st)
        return self.head(rms_norm(self.final_norm, x, self.cfg.norm_eps)), steps

    def rollback_cache_paged(self, cache: list[dict], table, steps, keep, pos,
                             max_len: int) -> list[dict]:
        """Commit the first ``keep[b]`` fresh entries of each lane of a
        :meth:`verify_step_paged` pass (0 freezes a lane), in place: KV
        layers write them through the tables, recurrent layers take the
        state at step ``keep[b] - 1`` (the old state where ``keep`` is 0)."""
        bs = blocks.pool_block_size(cache)
        scs = self.ring_lens(max_len)
        t = next(st["k"].shape[2] if s is not None else st["h"].shape[1]
                 for st, s in zip(steps, scs))
        plans = self.write_plans(table, pos, keep, t, max_len, block_size=bs)
        keep_d = None
        for c, st, s_c in zip(cache, steps, scs):
            if s_c is not None:
                blocks.write_kv_blocks(c, st["k"], st["v"], plans[s_c])
                continue
            if keep_d is None:
                keep_d = torch.as_tensor(np.asarray(blocks.to_host(keep), np.int64),
                                         device=self.device)
            c.update(blocks.select_state_step(st, keep_d, old=c))
        return cache


# ---------------- training ----------------

def check_trainable(model: Model) -> None:
    """What neither package trains: a packed projection (its int8
    mantissas take no gradient; JAX's ``value_and_grad`` refuses integer
    leaves), and a model under a rank mesh (ROADMAP A13).  Every family
    and frontend trains."""
    from repro_torch.parallel.context import active_ctx

    if active_ctx() is not None:
        raise NotImplementedError("training under a rank mesh waits for ROADMAP A13")
    packed = [n for n, m in model.named_modules() if isinstance(m, PackedDSBPWeight)]
    if packed:
        raise ValueError(f"{model.cfg.name}: a packed projection does not train "
                         f"({packed[0]}, ...): train the raw model, pack after")


def _layer_out(layer, x, cfg, quant, positions):
    return blocks.layer_seq(layer, x, cfg, quant, positions)[0]


def _ce(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean next-token cross entropy in f32 (JAX ``_ce``, :154): over
    ``mask``'s weight when given (at least 1)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(model: Model, batch: dict, quant: Quant | None = None):
    """Next-token cross entropy in sequence mode, with gradients through
    every layer (JAX ``loss_fn``, :164-177); returns (loss, {"loss":
    loss}).  ``batch`` holds ``tokens`` and ``labels`` (B, S) and an
    optional ``loss_mask``, numpy arrays or tensors; an audio model's are
    (B, S, K) codebook ids, its logits read as K heads of Vp columns and
    no mask; a vlm model's ``image_embeds`` (B, S_img, d) go in front of
    the text, and the loss (and mask) cover the text positions only.  MoE
    layers drop past their capacity, as JAX's ``forward`` does.
    Projections run the model's quant method; a raw weight under a DSBP
    method takes its straight-through product (QAT).  ``cfg.remat``
    recomputes each layer's forward in the backward
    (``torch.utils.checkpoint``), so under remat every projection's
    forward kernel runs twice per step."""
    cfg = model.cfg
    check_trainable(model)
    quant = model.default_quant() if quant is None else quant
    dev = model.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    mask = batch.get("loss_mask")
    mask = None if mask is None else torch.as_tensor(mask, device=dev)
    x, positions = model.embed_tokens(tokens, batch.get("image_embeds"))
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.layers:
        if remat:
            x = torch.utils.checkpoint.checkpoint(_layer_out, layer, x, cfg, quant, positions,
                                                  use_reentrant=False)
        else:
            x = _layer_out(layer, x, cfg, quant, positions)
    logits = model.head(rms_norm(model.final_norm, x, cfg.norm_eps))
    if cfg.frontend == "audio_codebooks":
        b, s, _ = logits.shape
        loss = _ce(logits.reshape(b, s, cfg.n_codebooks, cfg.padded_vocab_size), labels)
    else:
        if cfg.frontend == "vlm_patches":  # the loss past the image prefix
            logits = logits[:, batch["image_embeds"].shape[1]:]
        loss = _ce(logits, labels, mask)
    return loss, {"loss": loss}


def _batch(cache: list[dict]) -> int:
    """The rows of a dense cache (every leaf has the batch axis first)."""
    return next(iter(cache[0].values())).shape[0]


def _draw(module: nn.Module, cfg: ArchConfig, gen: torch.Generator) -> None:
    """Draw ``module``'s own parameters (all of them, or only its direct
    ones when it is the :class:`Model`) in registration order, each in f32
    and then rounded to its own dtype (JAX's ``.astype(dt)``): a bf16
    parameter is drawn into an f32 tensor of its shape alone, so the draws
    are the f32 model's and the peak is one parameter in f32 beyond the
    layer."""
    params = (module.named_parameters(recurse=False) if isinstance(module, Model)
              else module.named_parameters())
    for name, p in params:
        if p.dtype == torch.float32:
            _draw_f32(name, p, cfg, gen)
        else:
            f = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            p.copy_(_draw_f32(name, f, cfg, gen))
            del f


def _draw_f32(name: str, p: torch.Tensor, cfg: ArchConfig, gen: torch.Generator):
    """Draw the f32 tensor ``p`` in place as parameter ``name``; returns it."""
    leaf = name.rpartition(".")[2]
    if leaf in ("final_norm", "norm1", "norm2"):
        p.fill_(1.0)
    elif leaf in ("ba", "bx"):
        p.zero_()
    elif leaf == "lam":
        p.uniform_(2.0, 6.0, generator=gen)
    elif leaf == "a_log":  # an SSD head's decay rate A = -U(1, 16)
        p.uniform_(1.0, 16.0, generator=gen).log_()
    elif leaf == "dt_bias":  # softplus(dt_bias) ~ U(1e-3, 0.1)
        p.uniform_(1e-3, 1e-1, generator=gen).expm1_().log_()
    elif leaf == "d_skip":
        p.fill_(1.0)
    elif leaf == "conv_w":
        p.normal_(generator=gen).mul_(0.1)
    else:  # embed rows are (K * Vp, d): its fan-in is d as well
        fan_in = cfg.d_model if name == "embed" else p.shape[-2]
        p.normal_(generator=gen).mul_(fan_in ** -0.5)
    return p


def init(cfg: ArchConfig, *, seed: int = 0, device=None, pack=None) -> Model:
    """Random weights with the JAX package's shapes and scales: every
    projection and embedding ~ N(0, 1) * d_in**-0.5 (an expert stack's
    d_in is its second-to-last axis: ``w1`` / ``w3`` and the router at
    d**-0.5, ``w2`` at ff**-0.5), norms 1; a recurrent block's ``conv_w``
    ~ N(0, 1) * 0.1, ``lam`` ~ U(2, 6), ``ba`` and ``bx`` zero (JAX
    ``init_rglru_block``); an SSD block's ``conv_w`` the same, ``a_log`` =
    log U(1, 16), ``dt_bias`` = log(expm1(U(1e-3, 0.1))), ``d_skip`` 1
    (JAX ``init_ssd_block``).  Drawn from a ``torch.Generator`` seeded with
    ``seed`` on the target device (the numbers differ from
    ``jax.random``'s; parity tests bridge weights).

    The model is built on the meta device and drawn one layer at a time:
    each layer is allocated and drawn from the one generator in the order
    above.  ``pack`` (a ``PRESETS`` name, a ``QuantizedMatmulConfig`` or a
    ``DSBPPolicy``) packs each layer as :func:`models.packing.pack_weights_int8`
    packs it before the next is drawn, so the peak is the packed model
    plus one layer in the model dtype (a model larger than the card in
    f32 fits packed); a bf16 model's parameters are drawn in f32 one at a
    time and rounded (:func:`_draw`), and packing reads the bf16-rounded
    weights (JAX ``core/quantized.py:131``).  The result equals ``init``
    followed by ``pack_weights_int8``, bit for bit, in either dtype."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Model(cfg, torch.device("meta"))
    with torch.no_grad():
        for name, p in list(model.named_parameters(recurse=False)):
            setattr(model, name, weight(p.shape, device, p.dtype))
        _draw(model, cfg, gen)
        for i, layer in enumerate(model.layers):
            _draw(layer.to_empty(device=device), cfg, gen)
            if pack is not None:
                pack_weights_int8(model, pack, under=f"layers.{i}")
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
