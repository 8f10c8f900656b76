"""Carry weights from the JAX package into the port, as numpy arrays.

Nothing here imports the JAX package: the caller turns its trees into
nested dicts/lists of numpy arrays (``np.asarray`` on each leaf) and a
packed container into its four arrays plus its static fields.

* :func:`model_from_jax` builds a :class:`~repro_torch.models.model.Model`
  from a JAX param tree ``{"embed", "final_norm": {"scale"}, "lm_head",
  "units": [...], "tail": [...]}``.  Unit leaves carry a leading ``R``
  axis (the scanned stack) and are split per layer: layer ``r * P + p``
  is unit ``r`` at pattern position ``p``; tail layers follow.  A packed
  projection leaf is a dict with the keys of :func:`packed_from_jax`.
* :func:`packed_from_jax` turns a JAX ``PackedDSBPWeight``'s children and
  static fields into the port's container.
* :func:`cache_from_jax` turns a JAX KV cache tree ``{"units": [...],
  "tail": [...]}`` into the port's per-layer ``{'k', 'v'}`` list; a packed
  leaf (a JAX ``PackedKVBlock``) arrives as a dict of its ``qm``/``scale``
  children and static ``bits``/``fmt`` and becomes a
  :class:`~repro_torch.kvq.PackedKVBlock`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.packed import LAYOUT_VERSION, PackedDSBPWeight
from repro_torch.core.quantized import PRESETS, QuantizedMatmulConfig
from repro_torch.kvq import PackedKVBlock
from repro_torch.models.model import Model

__all__ = ["model_from_jax", "packed_from_jax", "cache_from_jax"]

_PACKED_KEYS = ("ka", "kscale", "tscale", "bits")


def packed_from_jax(ka, kscale, tscale, bits, *, k: int, n: int,
                    group_size: int, cfg: QuantizedMatmulConfig | str,
                    version: int = LAYOUT_VERSION, device=None) -> PackedDSBPWeight:
    """A JAX v2 container as the port's: the same children (``ka`` int8
    (..., K', N), ``kscale`` (..., n_g, N), ``tscale``, ``bits``) and
    static fields; ``cfg`` is a preset name or the port's config."""
    if version != LAYOUT_VERSION:
        raise ValueError(f"only layout v{LAYOUT_VERSION} containers bridge; "
                         f"got v{version}")
    if isinstance(cfg, str):
        cfg = PRESETS[cfg]
    t = [torch.tensor(np.asarray(a), device=device)
         for a in (ka, kscale, tscale, bits)]
    return PackedDSBPWeight(*t, k=int(k), n=int(n), group_size=int(group_size),
                            cfg=cfg, version=version)


def _leaf(value, index, device):
    """One layer's slice of a (possibly stacked) leaf as a tensor or
    packed container."""
    if isinstance(value, dict) and "ka" in value:
        arrays = {key: np.asarray(value[key]) for key in _PACKED_KEYS}
        if index is not None:
            arrays = {key: a[index] for key, a in arrays.items()}
        meta = {key: value[key] for key in ("k", "n", "group_size", "cfg")}
        return packed_from_jax(**arrays, **meta,
                               version=value.get("version", LAYOUT_VERSION),
                               device=device)
    a = np.asarray(value)
    return torch.tensor(a if index is None else a[index], device=device)


def _set(module, name: str, value) -> None:
    if isinstance(value, PackedDSBPWeight):
        delattr(module, name)
        setattr(module, name, value)
    else:
        getattr(module, name).data.copy_(value.to(torch.float32))


def _fill_layer(layer, tree: dict, index, device) -> None:
    _set(layer, "norm1", _leaf(tree["norm1"]["scale"], index, device))
    _set(layer, "norm2", _leaf(tree["norm2"]["scale"], index, device))
    for name in ("wq", "wk", "wv", "wo"):
        _set(layer.attn, name, _leaf(tree["attn"][name], index, device))
    for name in ("w1", "w3", "w2"):
        _set(layer.ffn, name, _leaf(tree["ffn"][name], index, device))


def model_from_jax(params: dict, cfg: ArchConfig, *, device) -> Model:
    """The port's model holding the JAX tree's weights (explicit device:
    the bridge serves tests and tools, which say where they run)."""
    device = torch.device(device)
    model = Model(cfg, device)
    with torch.no_grad():
        _set(model, "embed", _leaf(params["embed"], None, device))
        _set(model, "final_norm", _leaf(params["final_norm"]["scale"], None, device))
        _set(model, "lm_head", _leaf(params["lm_head"], None, device))
        p_len = len(cfg.pattern)
        for p, unit in enumerate(params["units"]):
            for r in range(cfg.n_units):
                _fill_layer(model.layers[r * p_len + p], unit, r, device)
        base = cfg.n_units * p_len
        for i, tree in enumerate(params["tail"]):
            _fill_layer(model.layers[base + i], tree, None, device)
    return model


def _kv_leaf(value, index, device):
    """One layer's K or V cache leaf: a float tensor, or a packed block
    from a dict of the JAX container's children and static fields."""
    if isinstance(value, dict) and "qm" in value:
        qm, scale = (np.asarray(value[key]) for key in ("qm", "scale"))
        if index is not None:
            qm, scale = qm[index], scale[index]
        return PackedKVBlock(torch.tensor(qm, device=device),
                             torch.tensor(scale, device=device),
                             bits=int(value["bits"]), fmt=str(value["fmt"]))
    a = np.asarray(value)
    return torch.tensor(a if index is None else a[index], device=device)


def cache_from_jax(cache: dict, cfg: ArchConfig, *, device) -> list[dict]:
    """The port's per-layer KV cache holding a JAX cache tree's contents
    (unit leaves carry the stacked ``R`` axis, split per layer as the
    weights are)."""
    device = torch.device(device)
    p_len = len(cfg.pattern)
    base = cfg.n_units * p_len
    out: list = [None] * (base + len(cfg.tail))
    for p, unit in enumerate(cache["units"]):
        for r in range(cfg.n_units):
            out[r * p_len + p] = {n: _kv_leaf(unit[n], r, device) for n in ("k", "v")}
    for i, entry in enumerate(cache["tail"]):
        out[base + i] = {n: _kv_leaf(entry[n], None, device) for n in ("k", "v")}
    return out
