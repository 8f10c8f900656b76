"""Carry weights from the JAX package into the port, as numpy arrays.

Nothing here imports the JAX package: the caller turns its trees into
nested dicts/lists of numpy arrays (``np.asarray`` on each leaf) and a
packed container into its four arrays plus its static fields.

* :func:`model_from_jax` builds a :class:`~repro_torch.models.model.Model`
  from a JAX param tree ``{"embed", "final_norm": {"scale"}, "lm_head"
  (absent when the embeddings are tied), "units": [...], "tail": [...]}``.
  Unit leaves carry a leading ``R`` axis (the scanned stack) and are split
  per layer: layer ``r * P + p`` is unit ``r`` at pattern position ``p``;
  tail layers follow.  An attention layer carries ``attn`` and ``ffn``
  (or, in an MoE config, ``moe``: ``router`` and the expert stacks
  ``w1`` / ``w3`` / ``w2``, raw or packed with their leading E axis), a
  recurrent one ``rec`` (``w_in`` ... ``bx``) and ``ffn``, an SSD one
  ``ssd`` (``w_in``, ``conv_w``, ``w_out``, ``a_log``, ``dt_bias``,
  ``d_skip``) and no ``norm2`` or ``ffn``.  A packed
  projection leaf is a dict with the keys of :func:`packed_from_jax`.
* :func:`packed_from_jax` turns a JAX ``PackedDSBPWeight``'s children and
  static fields into the port's container.
* :func:`to_tensor` carries one array, of any dtype the JAX trees hold
  (bfloat16 included, bit for bit); every port leaf takes its JAX
  leaf's dtype.
* :func:`model_from_checkpoint` reads a param tree that JAX's
  ``checkpoint.store.save`` wrote (float, or packed by
  ``pack_weights_int8``) through the port's store and builds the model
  from it: weights cross as files.
* :func:`cache_from_jax` turns a JAX KV cache tree ``{"units": [...],
  "tail": [...]}`` into the port's per-layer list of ``{'k', 'v'}`` (KV
  layers) and ``{'h', 'conv'}`` (recurrent state) entries; a packed
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

__all__ = ["model_from_jax", "model_from_checkpoint", "packed_from_jax", "cache_from_jax",
           "to_tensor", "to_numpy"]


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, bit for bit: a bfloat16
    array (numpy's ``ml_dtypes.bfloat16``, which ``torch.tensor`` refuses)
    travels as its 16-bit patterns.  A tensor passes as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; a bfloat16 one as float32 values (exact),
    since numpy has no bfloat16 of its own."""
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

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
    t = [to_tensor(a, device) for a in (ka, kscale, tscale, bits)]
    return PackedDSBPWeight(*t, k=int(k), n=int(n), group_size=int(group_size),
                            cfg=cfg, version=version)


def _leaf(value, index, device):
    """One layer's slice of a (possibly stacked) leaf as a tensor or
    packed container."""
    if isinstance(value, dict) and "ka" in value:
        arrays = {key: _array(value[key]) for key in _PACKED_KEYS}
        if index is not None:
            arrays = {key: a[index] for key, a in arrays.items()}
        meta = {key: value[key] for key in ("k", "n", "group_size", "cfg")}
        return packed_from_jax(**arrays, **meta,
                               version=value.get("version", LAYOUT_VERSION),
                               device=device)
    a = _array(value)
    return to_tensor(a if index is None else a[index], device)


def _array(value):
    return value if isinstance(value, torch.Tensor) else np.asarray(value)


def _set(module, name: str, value) -> None:
    if isinstance(value, PackedDSBPWeight):
        delattr(module, name)
        setattr(module, name, value)
        return
    p = getattr(module, name)
    if p.dtype != value.dtype:
        raise ValueError(f"{name}: the JAX leaf is {value.dtype}, the port's parameter "
                         f"{p.dtype} (a config of another dtype?)")
    p.data.copy_(value)


_REC_NAMES = ("w_in", "w_gate", "w_out", "conv_w", "wa", "wx", "lam", "ba", "bx")
_SSD_NAMES = ("w_in", "conv_w", "w_out", "a_log", "dt_bias", "d_skip")


def _fill_layer(layer, tree: dict, index, device) -> None:
    _set(layer, "norm1", _leaf(tree["norm1"]["scale"], index, device))
    if layer.kind == "ssd":  # norm1 and the block: no norm2, no FFN
        for name in _SSD_NAMES:
            _set(layer.ssd, name, _leaf(tree["ssd"][name], index, device))
        return
    _set(layer, "norm2", _leaf(tree["norm2"]["scale"], index, device))
    if layer.kind == "rglru":
        for name in _REC_NAMES:
            _set(layer.rec, name, _leaf(tree["rec"][name], index, device))
    else:
        for name in ("wq", "wk", "wv", "wo"):
            _set(layer.attn, name, _leaf(tree["attn"][name], index, device))
    if hasattr(layer, "moe"):  # the router and the (E, ...) expert stacks
        for name in ("router", "w1", "w3", "w2"):
            _set(layer.moe, name, _leaf(tree["moe"][name], index, device))
        return
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
        if not cfg.tie_embeddings:
            _set(model, "lm_head", _leaf(params["lm_head"], None, device))
        p_len = len(cfg.pattern)
        for p, unit in enumerate(params["units"]):
            for r in range(cfg.n_units):
                _fill_layer(model.layers[r * p_len + p], unit, r, device)
        base = cfg.n_units * p_len
        for i, tree in enumerate(params["tail"]):
            _fill_layer(model.layers[base + i], tree, None, device)
    return model


def _nest(flat: dict) -> dict:
    """``{"a/b/0/c": leaf}`` -> nested dicts, with lists where every key
    of a level is an index (``units`` / ``tail``)."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def _packed_meta(tree, layer, preset) -> None:
    """Give every packed projection dict under ``tree`` (one layer's
    subtree) the static fields the store does not keep: the logical K of
    ``layer``'s parameter of that name, N, the group size, and ``preset``
    as its config."""
    def walk(node, path):
        for name, v in node.items():
            if not isinstance(v, dict):
                continue
            if "ka" in v:
                k = layer.get_parameter(".".join(path + [name])).shape[-2]
                v.update(k=k, n=v["ka"].shape[-1],
                         group_size=v["ka"].shape[-2] // v["kscale"].shape[-2], cfg=preset)
            else:
                walk(v, path + [name])

    walk(tree, [])


def model_from_checkpoint(ckpt_dir: str, cfg: ArchConfig, *, device, step=None) -> Model:
    """The port's model from a JAX param tree on disk (``store.save(dir,
    step, params)`` in the JAX package, the newest step unless ``step``),
    read by :func:`repro_torch.checkpoint.store.restore_flat_tensors`
    (bfloat16 leaves bit for bit) and rebuilt into the nested tree
    :func:`model_from_jax` takes.  Packed projections get the config
    ``cfg.quant`` (else "precise"), which the store does not record."""
    from repro_torch.checkpoint import store

    preset = cfg.quant if isinstance(cfg.quant, str) else "precise"
    flat, _ = store.restore_flat_tensors(ckpt_dir, step=step)
    tree = {"units": [], "tail": [], **_nest(flat)}  # an empty list stores no leaf
    meta = Model(cfg, torch.device("meta"))
    for p, unit in enumerate(tree["units"]):
        _packed_meta(unit, meta.layers[p], preset)
    base = cfg.n_units * len(cfg.pattern)
    for i, sub in enumerate(tree["tail"]):
        _packed_meta(sub, meta.layers[base + i], preset)
    return model_from_jax(tree, cfg, device=device)


def _kv_leaf(value, index, device):
    """One layer's K or V cache leaf: a float tensor, or a packed block
    from a dict of the JAX container's children and static fields."""
    if isinstance(value, dict) and "qm" in value:
        qm, scale = (np.asarray(value[key]) for key in ("qm", "scale"))
        if index is not None:
            qm, scale = qm[index], scale[index]
        return PackedKVBlock(to_tensor(qm, device), to_tensor(scale, device),
                             bits=int(value["bits"]), fmt=str(value["fmt"]))
    a = np.asarray(value)
    return to_tensor(a if index is None else a[index], device)


def cache_from_jax(cache: dict, cfg: ArchConfig, *, device) -> list[dict]:
    """The port's per-layer cache holding a JAX cache tree's contents
    (unit leaves carry the stacked ``R`` axis, split per layer as the
    weights are): K/V entries, and the ``{h, conv}`` state of recurrent
    layers."""
    device = torch.device(device)
    p_len = len(cfg.pattern)
    base = cfg.n_units * p_len
    out: list = [None] * (base + len(cfg.tail))
    for p, unit in enumerate(cache["units"]):
        for r in range(cfg.n_units):
            out[r * p_len + p] = {n: _kv_leaf(leaf, r, device) for n, leaf in unit.items()}
    for i, entry in enumerate(cache["tail"]):
        out[base + i] = {n: _kv_leaf(leaf, None, device) for n, leaf in entry.items()}
    return out
