"""Per-entry KV-cache bitwidth pricing.

Port of ``repro.policy.kv_bits``.  The packed KV cache
(:mod:`repro_torch.kvq`) quantizes K/V at write time with the paper's
aligned-mantissa machinery; how many aligned bits one cache entry needs is
governed by the distribution of per-element alignment shifts inside each
quantization group (the whole ``d_head`` vector of one token in one KV
head).  An element shifted by ``s`` under a ``mbits``-bit probe decompose
has ``s + mbits + 1`` significant positions; an aligned width of ``bits``
keeps ``bits - 1`` magnitude bits, so the truncation drops
``max(s + mbits + 2 - bits, 0)`` of them.

:func:`collect_kv_stats` gathers those shift histograms in one prefill per
calibration batch (:meth:`~repro_torch.models.model.Model.prefill` into a
float cache of ``max_len == seq``), per cache-entry name (``units.{pos}`` /
``tail.{i}``, the :func:`repro_torch.kvq.kv_policy_cfg` granularity).  As
in JAX, where one entry is one stacked leaf, the per-tensor probe scale
spans every layer of the entry.  :func:`price_kv_bits` then keeps the fine
preset where coarse storage destroys the most mantissa in the bytes that
matter, until a KV-byte budget is spent.  The result plugs into
:meth:`~repro_torch.policy.policy.DSBPPolicy.with_kv` and
``ServeConfig.kv_quant``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dsbp import MAX_SHIFT, group_shifts
from repro_torch.core.formats import decompose, get_format, per_tensor_scale
from repro_torch.kvq import KVQuantConfig, resolve_kv_spec
from repro_torch.models.layers import Quant

__all__ = ["KVEntryStats", "collect_kv_stats", "kv_dropped_bits",
           "price_kv_bits"]


@dataclasses.dataclass
class KVEntryStats:
    """Shift statistics of one cache entry's K/V vectors."""

    name: str                # cache-entry key: "units.{pos}" / "tail.{i}"
    mbits: int               # probe format mantissa bits (shift basis)
    shift_hist: np.ndarray   # (MAX_SHIFT+1,) per-element shifts (nz only)
    nz: int                  # nonzero elements observed
    total: int               # elements observed
    groups: int              # (token, head) vectors observed
    bytes_per_token: float   # float K+V cache bytes one token costs here

    @property
    def nz_frac(self) -> float:
        return self.nz / max(self.total, 1)


@torch.inference_mode()
def collect_kv_stats(model, cfg, batches,
                     probe: str = "e5m7") -> dict[str, KVEntryStats]:
    """One-pass KV calibration: prefill each batch into a FLOAT cache and
    histogram the alignment shifts of every K/V leaf, keyed by cache-entry
    name; the counts stay on the device until the end.  ``probe`` is the
    decompose format whose fields feed the shift extraction (``e5m7``
    matches the widest KV preset)."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"KV calibration drives plain token batches; "
            f"frontend={cfg.frontend!r}")
    f = get_format(probe)
    quant = Quant(cfg.quant, cfg.quant_method)
    acc: dict[str, dict] = {}
    for b in batches:
        toks = torch.as_tensor(np.asarray(b), dtype=torch.int64, device=model.device)
        bsz, seq = int(toks.shape[0]), int(toks.shape[1])
        # max_len == seq: every ring slot holds a real token, so the leaf
        # statistics are over written positions only (no zero-fill skew)
        _, cache, _ = model.prefill(toks, seq, quant=quant)
        by_entry: dict[str, list] = {}
        for i, c in enumerate(cache):
            if "k" in c:  # K/V entries only: recurrent state is not a KV leaf
                by_entry.setdefault(model.cache_entry_name(i), []).append(c)
        for name, entries in by_entry.items():
            bpt = 0.0
            for leaf_name in ("k", "v"):
                # the entry's leaf as JAX stacks it: (R, B, H, S, D)
                leaf = torch.stack([e[leaf_name] for e in entries])
                x = leaf.reshape(-1, leaf.shape[-1]).to(torch.float32)
                fields = decompose(x * per_tensor_scale(x, f), f)
                shift, _, nz = group_shifts(fields["e_unb"][..., None, :],
                                            fields["m_int"][..., None, :])
                ent = acc.setdefault(name, {
                    "shift_hist": torch.zeros(MAX_SHIFT + 2, dtype=torch.int64,
                                              device=x.device),
                    "nz": 0, "total": 0, "groups": 0, "bpt": 0.0})
                idx = torch.where(nz, shift, MAX_SHIFT + 1).reshape(-1).to(torch.int64)
                ent["shift_hist"].index_add_(0, idx, torch.ones_like(idx))
                ent["nz"] = ent["nz"] + nz.sum()
                ent["total"] += nz.numel()
                ent["groups"] += x.shape[0]
                bpt += leaf.numel() * leaf.element_size() / (bsz * seq)
            acc[name]["bpt"] = bpt  # the last batch's, as JAX's
    return {
        name: KVEntryStats(
            name=name, mbits=f.mbits,
            shift_hist=ent["shift_hist"][: MAX_SHIFT + 1].cpu().numpy(),
            nz=int(ent["nz"]), total=ent["total"], groups=ent["groups"],
            bytes_per_token=float(ent["bpt"]))
        for name, ent in acc.items()
    }


def kv_dropped_bits(stats: KVEntryStats, spec) -> float:
    """Mean mantissa bits an aligned ``spec.bits`` store drops per nonzero
    element of this entry, off the shift histogram (relative pricing
    metric — the probe's mantissa width is the basis, so comparisons are
    across entries and widths, not an absolute error bound)."""
    spec = resolve_kv_spec(spec)
    s = np.arange(stats.shift_hist.size, dtype=np.float64)
    dropped = np.maximum(s + (stats.mbits + 2) - spec.bits, 0.0)
    h = stats.shift_hist.astype(np.float64)
    return float((dropped * h).sum() / max(h.sum(), 1.0))


def price_kv_bits(stats: dict[str, KVEntryStats], *, fine="kv8",
                  coarse="kv4", budget_frac_fine: float = 0.5):
    """Per-entry KV specs from the collected statistics.

    Entries are ranked by ``byte_share × dropped-bits-at-coarse`` (where
    coarse storage destroys the most mantissa in the KV bytes that
    matter); the top ranks store at ``fine`` until their cumulative
    float-byte share exceeds ``budget_frac_fine``, the rest at ``coarse``.
    Returns ``(artifact, info)``: ``artifact`` maps entry names to
    :class:`~repro_torch.kvq.KVQuantConfig` plus a ``"default"`` entry at the
    coarse spec — the exact mapping shape ``ServeConfig.kv_quant`` and
    :meth:`DSBPPolicy.with_kv` consume — and ``info`` is JSON-able
    provenance (scores, assignment by preset-style name, modeled bytes).
    """
    fine = resolve_kv_spec(fine)
    coarse = resolve_kv_spec(coarse)
    if fine is None or coarse is None or coarse.bits > fine.bits:
        raise ValueError(
            f"need concrete specs with coarse.bits <= fine.bits; got "
            f"fine={fine} coarse={coarse}")
    if not stats:
        raise ValueError("no KV entries in the statistics — the model has "
                         "no attention caches to price")
    total_bytes = sum(s.bytes_per_token for s in stats.values())
    share = {n: s.bytes_per_token / max(total_bytes, 1e-12)
             for n, s in stats.items()}
    scores = {n: share[n] * kv_dropped_bits(s, coarse)
              for n, s in stats.items()}
    order = sorted(stats, key=lambda n: -scores[n])
    artifact: dict[str, KVQuantConfig] = {}
    fine_share = 0.0
    for name in order:
        if scores[name] > 0 and fine_share + share[name] <= budget_frac_fine:
            artifact[name] = fine
            fine_share += share[name]
        else:
            artifact[name] = coarse
    assignment = {n: f"kv{artifact[n].bits}/{artifact[n].fmt}" for n in order}
    # modeled packed bytes/token: bits/8 of the float-width int8 mantissas
    # plus one f32 scale per d_head group is dominated by the mantissa
    # term; report the mantissa ratio (the gate measures the real thing)
    avg_bits = sum(share[n] * artifact[n].bits for n in order)
    info = {
        "fine": f"kv{fine.bits}/{fine.fmt}",
        "coarse": f"kv{coarse.bits}/{coarse.fmt}",
        "budget_frac_fine": budget_frac_fine,
        "fine_byte_share": fine_share,
        "avg_kv_bits_byte_weighted": avg_bits,
        "scores": {n: round(scores[n], 6) for n in order},
        "assignment": assignment,
    }
    artifact = dict(artifact)
    artifact["default"] = coarse
    return artifact, info
