"""Self-speculative decoding from one packed container (port of
``repro.spec``).

  draft.py   -- the MSB-slice draft model: the same packed containers with
                their aligned mantissas cut to the top bits
                (:func:`repro_torch.core.packed.draft_view`), derived per
                projection at call time and freed after, so the draft adds
                no weight bytes
  decode.py  -- one speculation round: draft k tokens with the draft view,
                verify them in ONE target forward
                (:meth:`repro_torch.models.model.Model.verify_step`), accept
                the longest matching greedy prefix, roll the cache back
                past it

``serve.Engine`` runs rounds in both schedulers through
``ServeConfig.spec_k`` / ``spec_draft_bits``; every committed token is the
target model's own argmax, so the served stream is the non-speculative
greedy stream.
"""
from .decode import (acceptance_summary, build_spec_round, build_spec_round_paged,
                     greedy_accept)
from .draft import DEFAULT_DRAFT_BITS, draft_params, draft_quant, resolve_draft_bits

__all__ = ["DEFAULT_DRAFT_BITS", "acceptance_summary", "build_spec_round",
           "build_spec_round_paged", "draft_params", "draft_quant", "greedy_accept",
           "resolve_draft_bits"]
