"""The speculation round: draft -> verify -> accept -> rollback (port of
``repro.spec.decode``).

Per round, for every row b at position ``pos[b]`` with last committed
token ``tok[b]``:

  draft    gamma = spec_k decode steps of the MSB-slice draft
           (:func:`.draft.draft_quant`) propose d_1 .. d_gamma;
  verify   ONE target forward over the gamma + 1 inputs [tok, d_1 ..
           d_gamma] gives the target's greedy tokens t_0 .. t_gamma, what
           gamma + 1 non-speculative steps would have sampled;
  accept   the longest prefix with d_j == t_{j-1} (m matches) commits
           t_0 .. t_m: every committed token is the target's own argmax
           over the verify logits, so the stream is the non-speculative one
           up to float round-off between the batched verify pass and
           sequential decode;
  rollback the cache keeps the m + 1 accepted inputs and is restored bit
           for bit past them.

JAX jits the round with the cache donated, and its draft decodes into a
value copy of the cache that the round throws away.  The port's steps
update caches in place, and no cache or pool is copied per round: the
round saves the bytes of the ring slots the draft and the verify write
(pos .. pos + gamma of every row, every layer, every child of a packed
leaf: kilobytes) and the recurrent layers' states (by reference: a step
replaces state and never writes into it), lets the draft write in place,
and puts back what it must: the states right after the draft, so the
verify starts from the pre-round state.
  dense    the verify masks every slot >= pos (``verify_attention``), so
           the draft's stale writes are invisible to it, and it rewrites
           all gamma + 1 slots; the rollback puts the pre-round bytes back
           into the rejected ones.  A wrapped ``attn_local`` ring and
           recurrent state are the exceptions: their pre-round content goes
           back right after the draft (``Model.undo_draft``).
  paged    the engine splits the 1 + spec_k slots of every live lane
           copy-on-write before the round, so no shared block is written;
           the draft's slots are restored right after the draft, and the
           verify's deferred writes commit the accepted prefix only.
Either way the cache after a round equals JAX's bit for bit: the
pre-round bytes plus the accepted writes.  With ``kv_draft_bits`` the
draft reads :func:`~repro_torch.kvq.kv_narrow_view` of the cache, a
narrowed copy it writes at the narrow width and that is dropped after the
draft (the one copy per round).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import finite_flags
from repro_torch.kvq import kv_narrow_view
from repro_torch.models import blocks
from repro_torch.models.layers import Quant

from .draft import DEFAULT_DRAFT_BITS, draft_quant

__all__ = ["acceptance_summary", "greedy_accept", "build_spec_round",
           "build_spec_round_paged"]


def acceptance_summary(accepted_hist, spec_k: int, slot_accepted=None,
                       slot_rounds=None) -> dict:
    """Summary of one serve's accepted-length histogram
    (``accepted_hist[j]`` = rounds that committed j tokens, j in [0,
    spec_k + 1]): the histogram as a list and ``mean_accepted``; with the
    dense scheduler's per-slot sums also ``slot_mean_accepted``."""
    hist = np.asarray(accepted_hist, np.int64)
    out = {
        "accepted_hist": hist.tolist(),
        "mean_accepted": (float(np.dot(hist, np.arange(spec_k + 2)))
                          / max(int(hist.sum()), 1)),
    }
    if slot_accepted is not None and slot_rounds is not None:
        out["slot_mean_accepted"] = [
            float(a) / max(int(n), 1)
            for a, n in zip(slot_accepted, slot_rounds)]
    return out


def greedy_accept(draft: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``keep (B,)`` in [1, gamma + 1]: 1 + the number of leading positions
    where ``draft (B, gamma)`` equals ``target (B, gamma + 1)`` (the target
    token at slot j is the successor the draft guessed at j + 1)."""
    match = (draft == target[:, : draft.shape[1]]).to(torch.int32)
    return 1 + torch.cumprod(match, dim=1).sum(dim=1)


def _check(spec_k: int):
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")


def _finite(logits: torch.Tensor) -> torch.Tensor:
    """The numeric guard's per-lane verdict over a verify pass's logits
    (B, T, V): True where every value is finite, on the device."""
    return finite_flags(logits) == 0


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    from repro_torch.serve.engine import sample_tokens  # local: engine imports spec

    return sample_tokens(logits)


def _target(logits: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    b, t, v = logits.shape
    return _greedy(logits.reshape(b * t, v)).reshape(b, t).to(like.dtype)


def build_spec_round(cfg, spec_k: int, draft_bits=DEFAULT_DRAFT_BITS,
                     draft_method: str | None = "dsbp_ref", guard: bool = False,
                     kv_draft_bits: int | None = None):
    """The round ``(model, cache, tok (B,), pos (B,)) -> (target (B,
    gamma + 1), keep (B,), cache)`` over a dense per-slot cache, updated in
    place.  ``cfg`` is the serving config (its preset and method run the
    verify); ``draft_method`` the draft forward's method (None: the
    serving one).  ``guard=True`` appends a 4th output, ``finite`` (B,)
    bool on the device: the per-lane all-finiteness of the VERIFY logits
    (the draft's are not guarded: a bad draft only lowers acceptance).
    The rollback runs for every lane first, so a lane the guard then
    quarantines leaves its slots as the round found them plus its
    accepted writes."""
    _check(spec_k)

    def spec_round(model, cache, tok, pos):
        quant = Quant(cfg.quant, cfg.quant_method)
        dquant = draft_quant(model, cfg, draft_bits, draft_method)
        # the slots the draft and the verify write: their pre-round bytes;
        # and the recurrent layers' pre-round states, by reference
        saved = model.kv_slots(cache, pos, spec_k + 1)
        dcache = cache if kv_draft_bits is None else kv_narrow_view(cache, kv_draft_bits)
        t, drafts = tok, []
        for j in range(spec_k):
            lg, dcache = model.decode_step(t[:, None], dcache, pos + j, dquant)
            t = _greedy(lg[:, -1]).to(tok.dtype)
            drafts.append(t)
        del dcache
        # the verify starts from the pre-round cache: recurrent states and
        # ring slots put back (elsewhere its attention masks the draft's
        # KV writes, and it rewrites every one of them)
        model.undo_draft(cache, saved, pos, spec_k + 1)
        draft = torch.stack(drafts, dim=1)                        # (B, gamma)
        toks = torch.cat([tok[:, None], draft], dim=1)            # (B, gamma + 1)
        logits, cache, rollback = model.verify_step(toks, cache, pos, quant,
                                                    collect_rollback=True, saved=saved)
        target = _target(logits, tok)
        keep = greedy_accept(draft, target)
        model.rollback_cache(cache, rollback, keep, pos, spec_k + 1)
        if guard:
            return target, keep, cache, _finite(logits)
        return target, keep, cache

    return spec_round


def build_spec_round_paged(cfg, spec_k: int, draft_bits=DEFAULT_DRAFT_BITS,
                           draft_method: str | None = "dsbp_ref", max_len: int = 0,
                           guard: bool = False, kv_draft_bits: int | None = None):
    """Paged twin of :func:`build_spec_round`: ``(model, cache, table, tok,
    pos, live) -> (target, keep, cache)`` with ``cache`` the block pools,
    ``table`` (B, W) the lanes' block tables and ``pos`` / ``live`` (B,)
    host arrays (``live`` 0 masks idle and chunk lanes: they write nothing
    and commit nothing).  Commit-on-accept: the verify defers its writes
    and :meth:`~repro_torch.models.model.Model.rollback_cache_paged` writes
    the ``keep`` accepted entries through the tables.  ``guard=True``
    appends the verify logits' per-lane finiteness mask, as the dense
    round does."""
    _check(spec_k)

    def spec_round(model, cache, table, tok, pos, live):
        quant = Quant(cfg.quant, cfg.quant_method)
        dquant = draft_quant(model, cfg, draft_bits, draft_method)
        live = blocks.to_host(live).astype(np.int32)
        # the pool rows the draft writes (the engine split them copy-on-
        # write): saved before the draft, put back right after it
        plans = model.write_plans(table, pos, live * spec_k, spec_k, max_len,
                                  block_size=blocks.pool_block_size(cache))
        saved = model.pool_entries(cache, plans, max_len)
        dcache = cache if kv_draft_bits is None else kv_narrow_view(cache, kv_draft_bits)
        t, drafts = tok, []
        posh = blocks.to_host(pos).astype(np.int32)
        for j in range(spec_k):
            lg, dcache = model.decode_step_paged(t[:, None], dcache, table, posh + j, live,
                                                 max_len, dquant)
            t = _greedy(lg[:, -1]).to(tok.dtype)
            drafts.append(t)
        del dcache
        model.restore_pool_entries(cache, plans, saved, max_len)
        draft = torch.stack(drafts, dim=1)
        toks = torch.cat([tok[:, None], draft], dim=1)
        logits, steps = model.verify_step_paged(toks, cache, table, posh, max_len, quant)
        target = _target(logits, tok)
        keep = greedy_accept(draft, target) * torch.as_tensor(live, device=target.device)
        cache = model.rollback_cache_paged(cache, table, steps, keep.cpu().numpy(), posh,
                                           max_len)
        if guard:
            return target, keep, cache, _finite(logits)
        return target, keep, cache

    return spec_round
