"""Packed DSBP KV-cache representation.

Port of ``repro.kvq.packed_kv``, with the speculative draft's narrow view
:func:`kv_narrow_view`.  K/V vectors are
quantized at cache-write time with the paper's aligned-mantissa machinery
and stored as

  qm     int8  (..., S, D)   aligned mantissas, sign applied — the axes of
                             the float cache leaf they replace
  scale  f32   (..., S, 1)   per-(token, head) power-of-two group scale

with static ``(bits, fmt)``.  The group is the whole ``d_head`` vector of
one token in one KV head (n_g = 1), so every slot index of a cache write
applies to both children unchanged.  ``bits`` counts sign + magnitude, so
``kv8`` stores exactly int8.  The stored scale is ``2**(E_max-(B-1)) /
tscale``, a quotient of powers of two: folding it into the attention
products after the integer operand is widened is exact, so attention over
the packed cache equals attention over ``dequantize()`` bit for bit.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from repro_torch.core.dsbp import align_group, group_shifts
from repro_torch.core.formats import decompose, get_format, per_tensor_scale

__all__ = [
    "KV_MIN_BITS",
    "KV_MAX_BITS",
    "KVQuantConfig",
    "KV_PRESETS",
    "PackedKVBlock",
    "init_packed_kv",
    "kv_cache_nbytes",
    "kv_narrow_view",
    "kv_policy_cfg",
    "quantize_kv",
    "quantize_like",
    "resolve_kv_spec",
    "tree_has_packed_kv",
]

# int8 storage: 1 sign bit + up to 7 magnitude bits.
KV_MIN_BITS, KV_MAX_BITS = 2, 8


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """One KV-cache quantization spec: ``bits`` total aligned width incl.
    the sign bit, in [2, 8]; ``fmt`` the FP decompose format feeding the
    alignment (``e5m7`` keeps the most mantissa before alignment)."""

    bits: int = 8
    fmt: str = "e5m7"

    def __post_init__(self):
        if not KV_MIN_BITS <= int(self.bits) <= KV_MAX_BITS:
            raise ValueError(
                f"kv bits must be in [{KV_MIN_BITS}, {KV_MAX_BITS}] "
                f"(sign + 1..7 aligned magnitude bits, int8 storage); "
                f"got {self.bits}")
        get_format(self.fmt)  # raises on unknown format names


KV_PRESETS: dict[str, KVQuantConfig] = {
    "kv8": KVQuantConfig(bits=8, fmt="e5m7"),
    "kv6": KVQuantConfig(bits=6, fmt="e5m7"),
    "kv4": KVQuantConfig(bits=4, fmt="e4m3"),
}


def resolve_kv_spec(spec):
    """None (float cache), a :data:`KV_PRESETS` name, an int bitwidth,
    True (``kv8``) or a config -> None or a :class:`KVQuantConfig`."""
    if spec is None or isinstance(spec, KVQuantConfig):
        return spec
    if isinstance(spec, bool):
        return KV_PRESETS["kv8"] if spec else None
    if isinstance(spec, int):
        return KVQuantConfig(bits=spec)
    if isinstance(spec, str):
        if spec in KV_PRESETS:
            return KV_PRESETS[spec]
        raise ValueError(
            f"unknown kv_quant preset {spec!r}; valid presets: "
            f"{sorted(KV_PRESETS)} (or an int bitwidth in "
            f"[{KV_MIN_BITS}, {KV_MAX_BITS}])")
    raise TypeError(f"kv_quant spec must be None, str, int or KVQuantConfig; "
                    f"got {type(spec).__name__}")


def kv_policy_cfg(kv, name: str):
    """Per-cache-entry config: ``kv`` is one spec for every entry, or a
    mapping of entry names (``units.<i>`` / ``tail.<i>``, plus
    ``default``) to specs."""
    if kv is None:
        return None
    if isinstance(kv, Mapping):
        return resolve_kv_spec(kv.get(name, kv.get("default")))
    return resolve_kv_spec(kv)


class PackedKVBlock:
    """Quantized KV-cache leaf: int8 aligned mantissas ``qm`` (..., S, D)
    and pow2 group scales ``scale`` (..., S, 1), both sharing every
    leading axis.  Cache writes update both children in place."""

    __slots__ = ("qm", "scale", "bits", "fmt")

    def __init__(self, qm: torch.Tensor, scale: torch.Tensor, *, bits: int, fmt: str):
        self.qm = qm
        self.scale = scale
        self.bits = bits
        self.fmt = fmt

    @property
    def shape(self):
        return self.qm.shape

    @property
    def ndim(self) -> int:
        return self.qm.ndim

    @property
    def device(self) -> torch.device:
        return self.qm.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.qm, self.scale))

    @property
    def cfg(self) -> KVQuantConfig:
        return KVQuantConfig(bits=self.bits, fmt=self.fmt)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Dense float view — the reference path; serving attention folds
        ``scale`` into its products instead (bit-identical)."""
        return self.qm.to(dtype) * self.scale.to(dtype)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"PackedKVBlock(bits={self.bits}, fmt={self.fmt!r}, qm={tuple(self.shape)})"


def init_packed_kv(shape, cfg: KVQuantConfig, device) -> PackedKVBlock:
    """Zero packed leaf for a float leaf of ``shape`` (..., S, D): zero
    scales dequantize to exact zeros, as the float cache's zero init."""
    return PackedKVBlock(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device),
        bits=cfg.bits, fmt=cfg.fmt)


def quantize_kv(x: torch.Tensor, cfg: KVQuantConfig) -> PackedKVBlock:
    """Quantize fresh K/V ``x (..., D)`` at cache-write time: FP decompose
    under one per-tensor pow2 scale (over the whole of ``x``), the
    per-(token, head) max-exponent shifts, then alignment to ``bits-1``
    magnitude bits sharing ``2**(E_max-(B-1))``.  The stored scale folds
    the tensor scale back in (pow2 / pow2, exact)."""
    f = get_format(cfg.fmt)
    tscale = per_tensor_scale(x, f)
    fields = decompose(x.to(torch.float32) * tscale, f)
    # group axis = the whole trailing D: insert n_g = 1
    sign, e_unb, m_int = (fields[k][..., None, :] for k in ("sign", "e_unb", "m_int"))
    shift, e_max, _ = group_shifts(e_unb, m_int)
    b = torch.full(e_max.shape, cfg.bits - 1, dtype=torch.int32, device=x.device)
    a, scale = align_group(sign, m_int, f.mbits, shift, e_max, b)
    return PackedKVBlock(a[..., 0, :].to(torch.int8), (scale / tscale).to(torch.float32),
                         bits=cfg.bits, fmt=cfg.fmt)


def quantize_like(cache_leaf, fresh):
    """THE write-path contract: every cache write quantizes its fresh K/V
    to the cache leaf's representation first.  A float leaf takes a dtype
    cast; a packed leaf :func:`quantize_kv` at its spec; already-packed
    fresh values of the same spec pass through untouched."""
    if isinstance(cache_leaf, PackedKVBlock):
        if isinstance(fresh, PackedKVBlock):
            if (fresh.bits, fresh.fmt) != (cache_leaf.bits, cache_leaf.fmt):
                raise ValueError(
                    f"packed KV spec mismatch: cache ({cache_leaf.bits}b, "
                    f"{cache_leaf.fmt}) vs fresh ({fresh.bits}b, {fresh.fmt})")
            return fresh
        return quantize_kv(fresh, cache_leaf.cfg)
    if isinstance(fresh, PackedKVBlock):
        raise TypeError("packed K/V written into a float cache leaf")
    return fresh.to(cache_leaf.dtype)


def kv_narrow_view(cache, draft_bits: int):
    """Narrow-KV draft view (port of ``repro.kvq.kv_narrow_view``, :249):
    every :class:`PackedKVBlock` leaf keeps only the top ``draft_bits - 1``
    magnitude bits, ``qm >> s`` (arithmetic: floor division of the 2's
    complement mantissas) and ``scale * 2**s`` (exact, pow2 times pow2)
    with ``s = bits - draft_bits``, at ``bits = draft_bits``.  Float leaves,
    and packed leaves already at most ``draft_bits`` wide, pass through as
    the same objects.

    ``cache`` is a list of per-layer ``{'k', 'v'}`` entries (or one entry);
    the result has the same structure.  JAX traces this view inside its
    jitted draft; here each narrowed leaf is a new tensor pair of the
    cache's size (a copy at the narrow width, which the draft then writes
    at that width through :func:`quantize_like`), dropped by the caller
    after the draft."""
    if not KV_MIN_BITS <= int(draft_bits) <= KV_MAX_BITS:
        raise ValueError(
            f"kv draft bits must be in [{KV_MIN_BITS}, {KV_MAX_BITS}], "
            f"got {draft_bits}")

    def narrow(leaf):
        if not isinstance(leaf, PackedKVBlock):
            return leaf
        s = max(int(leaf.bits) - int(draft_bits), 0)
        if s == 0:
            return leaf
        # 2**s is an exact f32 (s <= 6): the same product as JAX's exp2i
        return PackedKVBlock(leaf.qm >> s, leaf.scale * float(2 ** s),
                             bits=int(draft_bits), fmt=leaf.fmt)

    if isinstance(cache, Mapping):
        return {name: narrow(leaf) for name, leaf in cache.items()}
    return [{name: narrow(leaf) for name, leaf in entry.items()} for entry in cache]


def _kv_leaves(cache):
    """The K/V leaves of a cache: a list of per-layer ``{'k', 'v'}``
    dicts (or one such dict)."""
    layers = [cache] if isinstance(cache, Mapping) else cache
    for entry in layers:
        for name in ("k", "v"):
            if name in entry:
                yield entry[name]


def kv_cache_nbytes(cache) -> int:
    """Device bytes of a cache's K/V leaves, from the actual dtypes (int8
    mantissas + f32 scales for packed leaves)."""
    return sum(leaf.nbytes if isinstance(leaf, PackedKVBlock)
               else leaf.numel() * leaf.element_size() for leaf in _kv_leaves(cache))


def tree_has_packed_kv(cache) -> bool:
    return any(isinstance(leaf, PackedKVBlock) for leaf in _kv_leaves(cache))
