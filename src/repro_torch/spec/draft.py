"""The draft model: the packed containers' MSB-slice view (port of
``repro.spec.draft``).

The draft is not a second checkpoint: it is the SAME
:class:`~repro_torch.core.packed.PackedDSBPWeight` containers with their
aligned mantissas cut to the top ``draft_bits`` magnitude bits and the group
scales rescaled by exactly the dropped power of two
(:func:`~repro_torch.core.packed.draft_view`).  JAX traces the view of the
whole tree inside its jitted round, so it never becomes a second weight
tree; the port runs eagerly, so :func:`draft_quant` derives the view of
ONE projection just before its GEMM and drops it after (a
:class:`DraftMethod` around the draft's quantized-linear method).  The
engine's containers are never copied or modified.

``draft_bits`` is an int (uniform) or a per-layer artifact: a dict mapping
projection path keys to widths, with an optional ``"default"``.  The keys
are JAX's, the stacked tree's paths (``units/<pattern position>/attn/wq``,
``units/<p>/ffn/w1``, ``tail/<j>/...``): every repeat of a pattern position
shares its key, so layer i of the port (unit i // P at position i % P)
resolves ``units/<i % P>/...``.
"""
from __future__ import annotations

from repro_torch.core.packed import PackedDSBPWeight, QuantMethod, draft_view
from repro_torch.models.layers import Quant

__all__ = ["DEFAULT_DRAFT_BITS", "resolve_draft_bits", "stacked_key", "projection_keys",
           "draft_params", "DraftMethod", "draft_quant"]

DEFAULT_DRAFT_BITS = 4


def resolve_draft_bits(spec, path_key: str) -> int:
    """Draft width for one projection path under an int / dict spec."""
    if isinstance(spec, dict):
        bits = spec.get(path_key, spec.get("default", DEFAULT_DRAFT_BITS))
    else:
        bits = spec
    bits = int(bits)
    if not 1 <= bits <= 7:
        raise ValueError(f"draft bits for {path_key!r} must be in [1, 7], "
                         f"got {bits}")
    return bits


def stacked_key(cfg, module_name: str) -> str:
    """JAX's stacked path of the port's module path: module
    ``layers.<i>.<sub>.<name>`` is ``units/<i % P>/<sub>/<name>``, or
    ``tail/<j>/...`` for the layers after the ``n_units * P`` of the
    scanned stack.  THE mapping from the port's per-layer modules to the
    keys of per-layer artifacts (draft widths, ``DSBPPolicy`` entries,
    calibration statistics)."""
    parts = module_name.split(".")
    if parts[0] != "layers":
        raise ValueError(f"projection {module_name!r} outside the layers")
    p = len(cfg.pattern)
    base = cfg.n_units * p
    i = int(parts[1])
    unit = f"units/{i % p}" if i < base else f"tail/{i - base}"
    return "/".join([unit, *parts[2:]])


def projection_keys(model):
    """(JAX path key, container) of every packed projection of ``model``,
    keyed by :func:`stacked_key`."""
    for name, mod in model.named_modules():
        if isinstance(mod, PackedDSBPWeight):
            yield stacked_key(model.cfg, name), mod


def draft_params(model, draft_bits=DEFAULT_DRAFT_BITS) -> dict:
    """The draft's width of every packed projection, keyed by the container
    object itself: {container: resolved bits}.  JAX's ``draft_params``
    returns the views of the whole tree; here the widths are the whole
    artifact, and :class:`DraftMethod` derives each view when its GEMM
    runs.  Raw (unpacked) projections are absent: the draft equals the
    target there, as in JAX."""
    return {pw: resolve_draft_bits(draft_bits, key)
            for key, pw in projection_keys(model)}


class DraftMethod(QuantMethod):
    """A quantized-linear method that runs ``method`` on the draft view of
    each packed weight, at the width ``widths`` gives it; the view is a
    temporary of the call.  Not registered: :func:`draft_quant` builds one
    per round."""

    name = "draft"

    def __init__(self, method: QuantMethod, widths: dict):
        self.method = method
        self.widths = widths

    def weight_view(self, w):
        """The draft's view of one weight: a packed container at its draft
        width, a raw weight as it is.  The weight-only consumers read it,
        the RG-LRU's ``wa`` / ``wx`` and the MoE's expert stacks (JAX's
        draft tree views every container, those included)."""
        return draft_view(w, self.widths[w]) if isinstance(w, PackedDSBPWeight) else w

    def apply(self, w, x, cfg, name=None):
        return self.method.apply(self.weight_view(w), x, cfg, name=name)


def draft_quant(model, cfg, draft_bits=DEFAULT_DRAFT_BITS,
                draft_method: str | None = "dsbp_ref") -> Quant:
    """The draft forward's :class:`Quant`: the serving config's preset
    under ``draft_method`` (None: the serving method; ignored for a float
    model, as JAX's), each packed projection through its draft view."""
    method = cfg.quant_method
    if draft_method is not None and cfg.quant is not None:
        method = draft_method
    quant = Quant(cfg.quant, method)
    quant.method = DraftMethod(quant.method, draft_params(model, draft_bits))
    return quant
