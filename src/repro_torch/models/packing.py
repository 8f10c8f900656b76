"""The offline weight pass: pack a model's projections into DSBP
containers, once and in place.

Port of ``repro.serve.engine.pack_weights_int8`` (:229) and its
``PROJ_NAMES``.  It sits below both of its callers: the serving engine
packs a raw model at ``Engine.__init__``, and ``models.model.init(pack=)``
packs each layer as it draws it."""
from __future__ import annotations

import torch

from repro_torch.core.packed import pack_weights_sharded
from repro_torch.core.quantized import PRESETS, pack_weights
from repro_torch.parallel import sharding as SH
from repro_torch.spec.draft import stacked_key

__all__ = ["PROJ_NAMES", "pack_weights_int8"]

# projection leaf names that carry a DSBP-quantizable GEMM
PROJ_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "w_in", "w_gate", "w_out",
    "wa", "wx",
})


def pack_weights_int8(model, preset="precise", mesh=None, under: str | None = None) -> dict:
    """Offline DSBP pass over every projection, run ONCE and in place:
    each raw 2-D projection parameter named in :data:`PROJ_NAMES` (with at
    least one full group of rows) becomes a :class:`PackedDSBPWeight` on
    the same device.  Returns the average packed weight width (incl. the
    sign bit) and the number of projections packed.

    ``preset`` is a ``PRESETS`` name, a ``QuantizedMatmulConfig`` (one
    config everywhere) or a :class:`~repro_torch.policy.DSBPPolicy`: each
    projection packs under ``policy.config_for`` of its stacked key
    (``units/<i % P>/attn/wq``, :func:`repro_torch.spec.draft.stacked_key`),
    and projections the policy does not cover stay raw.

    With ``mesh`` (a rank mesh) each projection becomes this rank's shard
    (``parallel.sharding.serve_cuts``): its columns pack straight into
    kernel layout (:func:`pack_weights_sharded`, bit-identical to slicing
    the global pack), a row-parallel weight packs whole and keeps its
    group-aligned K rows (the per-column scales span the whole K), and the
    global raw weight is freed.

    An expert stack (E, d_in, d_out) packs as one container with a
    leading E axis, as JAX's.  ``under`` (a module name, e.g.
    ``layers.3``) packs only the projections inside that module:
    ``models.model.init(pack=)`` packs each layer as it draws it."""
    policy = preset if hasattr(preset, "config_for") else None
    if policy is None and isinstance(preset, str):
        if preset not in PRESETS:
            raise ValueError(f"unknown quant preset {preset!r}: valid presets "
                             f"are {sorted(PRESETS)}; pass a "
                             f"repro_torch.policy.DSBPPolicy for per-layer configs "
                             f"(serving then runs with quant='policy')")
        preset = PRESETS[preset]
    if policy is not None and mesh is not None:
        raise NotImplementedError("a DSBPPolicy under a mesh is not ported yet "
                                  "(ROADMAP A13)")
    cuts = SH.serve_cuts(model.cfg, mesh) if mesh is not None else {}
    bits_sum, groups, layers = 0, 0, 0
    root = model if under is None else model.get_submodule(under)
    for mod_name, module in list(root.named_modules(prefix=under or "")):
        for name, p in list(module.named_parameters(recurse=False)):
            if name not in PROJ_NAMES or p.ndim < 2:
                continue
            cfg = preset
            if policy is not None:
                cfg = policy.config_for(stacked_key(model.cfg, f"{mod_name}.{name}"))
                if cfg is None:
                    continue
            if p.shape[-2] < cfg.weight_cfg.group_size:
                continue
            cut = cuts.get(name)
            if cut is None:
                pw = pack_weights(p.data, cfg)
            else:
                pw = pack_weights_sharded(p.data, cfg, mesh, cols=cut.cols)
                if cut.rows != slice(0, cut.k):
                    pw = pw.slice(rows=cut.rows)
            delattr(module, name)  # frees the raw weight as we go
            setattr(module, name, pw)
            bits_sum += int((pw.bits.to(torch.int64) + 1).sum())
            groups += pw.bits.numel()
            layers += 1
    return {"avg_w_bits": bits_sum / max(groups, 1), "layers_packed": layers}
