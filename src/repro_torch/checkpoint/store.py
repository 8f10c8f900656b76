"""Atomic checkpoints in the JAX package's on-disk layout.

Port of ``repro.checkpoint.store``.  Layout:  <dir>/step_<N:08d>/
           manifest.msgpack   — step, sorted keys, shapes, dtypes
           host<k>.npz        — this host's leaves (numpy ``.npy`` members)

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or :class:`~repro_torch.core.packed.PackedDSBPWeight` containers
(their four children ``ka``, ``kscale``, ``tscale``, ``bits``, in JAX's
attribute order).  A leaf's key is its path joined by ``/``: dict keys,
sequence indices and attribute names as strings, dict keys taken in sorted
order, as ``jax.tree_util`` flattens a dict.  So a tree of the same nesting
has the same keys, and the same files, in both packages.

A bfloat16 leaf is written as JAX writes one (numpy has no bfloat16 of its
own: the member holds the 16-bit patterns as ``|V2`` and the manifest says
``bfloat16``) and read back bit for bit from those bytes.  (JAX's own
``restore`` cannot cast ``|V2`` back; its ``restore_flat`` returns the
bytes.)

The manifest is msgpack: the card's machine has no ``msgpack`` package, so
the subset :func:`save` writes (maps, strings, non-negative and negative
ints, arrays) has its own encoder and decoder here, byte for byte what
``msgpack.packb`` writes for it.

Fault tolerance, as JAX's: the step directory is written under a ``.tmp``
name and renamed (a crash mid-save never corrupts the newest checkpoint),
``restore(step=None)`` takes the newest complete step, and
:func:`reshard_leaf` re-slices a leaf saved in shards for another mesh
size.  Layout-v1 packed checkpoints (fields ``a (N, n_g, G)`` / ``scale
(N, n_g)``) restore into v2 containers through :func:`_upgrade_packed_leaf`,
a pure permutation.
"""
from __future__ import annotations

import os
import shutil
import struct

import numpy as np
import torch

from repro_torch.core.packed import PackedDSBPWeight

__all__ = ["save", "restore", "restore_flat", "restore_flat_tensors", "latest_step",
           "reshard_leaf", "packb", "unpackb"]

_SEP = "/"
_PACKED_FIELDS = ("ka", "kscale", "tscale", "bits")


# ---------------------------------------------------------------------------
# msgpack, the subset the manifest uses
# ---------------------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, tags, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8 (str
    only), 16 or 32-bit form of ``tags``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, lim in tags:
        if n < lim:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"the manifest codec writes no {obj!r}")
    if isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                                     (0xDB, ">I", 1 << 32)), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the manifest codec writes no {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, strings, ints and lists."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
         0xDC: (">H", "list"), 0xDD: (">I", "list"),
         0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: bytes, i: int):
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if tag in _FIXED:
        fmt = _FIXED[tag]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if 0xA0 <= tag < 0xC0:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag < 0xA0:
        kind, n = "list", tag & 0x0F
    elif 0x80 <= tag < 0x90:
        kind, n = "map", tag & 0x0F
    elif tag in _LENS:
        fmt, kind = _LENS[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack tag 0x{tag:02x} is not in the manifest codec's subset")
    if kind == "str":
        return buf[i:i + n].decode("utf-8"), i + n
    if kind == "list":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    d = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        d[k], i = _unpack(buf, i)
    return d, i


def unpackb(buf: bytes):
    """``msgpack.unpackb(buf)`` for what :func:`packb` writes."""
    obj, end = _unpack(bytes(buf), 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the manifest")
    return obj


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _children(node):
    """(key, child) pairs of an inner node, in JAX's flatten order; None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, PackedDSBPWeight):
        return [(f, getattr(node, f)) for f in _PACKED_FIELDS]
    return None


def _flatten(tree, prefix: str = ""):
    """[(path key, leaf)] in JAX's order; None is an empty subtree."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += _flatten(v, f"{prefix}{_SEP}{k}" if prefix else k)
    return out


def _unflatten(like, leaves, prefix: str = ""):
    """``like``'s structure with each leaf taken from ``leaves[key]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, f"{prefix}{_SEP}{i}" if prefix else str(i))
               for i, v in enumerate(like)]
        return type(like)(out)
    if isinstance(like, PackedDSBPWeight):
        kids = {f: leaves[f"{prefix}{_SEP}{f}" if prefix else f] for f in _PACKED_FIELDS}
        return PackedDSBPWeight(*(kids[f] for f in _PACKED_FIELDS), k=like.k, n=like.n,
                                group_size=like.group_size, cfg=like.cfg,
                                version=like.version)
    return leaves[prefix]


def _contig(a: np.ndarray) -> np.ndarray:
    """``a`` C-contiguous, 0-d kept 0-d (``np.ascontiguousarray`` makes
    it 1-d)."""
    return a if a.flags.c_contiguous else a.copy(order="C")


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array ``np.savez`` writes; a bfloat16 tensor as its
    16-bit patterns in a ``|V2`` array, as JAX's bfloat16 arrays land."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree, host: int = 0) -> str:
    """Atomic save; returns the final directory path."""
    flat = {}
    dtypes = {}
    for key, leaf in _flatten(tree):
        arr = _to_numpy(leaf)
        flat[key] = arr
        dtypes[key] = _dtype_name(leaf, arr)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"host{host}.npz"), **flat)
    manifest = {
        "step": int(step),
        "keys": sorted(flat),
        "shapes": {k: [int(s) for s in v.shape] for k, v in flat.items()},
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.msgpack")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _open(ckpt_dir: str, step: int | None, host: int):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    return manifest, np.load(os.path.join(d, f"host{host}.npz")), step


def _load(data, manifest: dict, key: str) -> np.ndarray:
    """One stored array, a bfloat16 one as ``|V2`` bytes reinterpreted
    as int16 patterns (``_as_leaf`` views them as bfloat16)."""
    arr = data[key]
    if manifest["dtypes"].get(key) == "bfloat16" or arr.dtype.kind == "V":
        return _contig(arr).view(np.int16)
    return arr


# layout-v2 field name -> the v1 field it derives from
_V1_SOURCES = {"ka": "a", "kscale": "scale"}


def _v1_source_key(key: str, data) -> str | None:
    """The v1 checkpoint key that can derive ``key``, if ``key`` names a
    layout-v2 packed field and the old field is present in ``data``."""
    base, _, name = key.rpartition(_SEP)
    prefix = base + _SEP if base else ""
    src = _V1_SOURCES.get(name)
    if src is not None and prefix + src in data:
        return prefix + src
    return None


def _upgrade_packed_leaf(key: str, data) -> np.ndarray:
    """A layout-v2 packed field from a layout-v1 checkpoint: ``ka (...,
    K', N)`` from ``a (..., N, n_g, G)``, ``kscale (..., n_g, N)`` from
    ``scale (..., N, n_g)`` — a pure permutation, bit-exact."""
    src = data[_v1_source_key(key, data)]
    if key.rpartition(_SEP)[2] == "ka":
        lead, (n, ng, g) = src.shape[:-3], src.shape[-3:]
        return src.reshape(*lead, n, ng * g).swapaxes(-1, -2)
    return src.swapaxes(-1, -2)


def _as_leaf(arr: np.ndarray, like, stored_bf16: bool):
    """``arr`` in the type, dtype and device of the template leaf (a
    bfloat16 leaf restores into a tensor: numpy has no bfloat16)."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(_contig(arr))
        t = t.view(torch.bfloat16) if stored_bf16 else t
        return t.to(device=like.device, dtype=like.dtype)
    if stored_bf16:
        raise TypeError("a bfloat16 leaf restores into a tensor template, not numpy")
    return arr.astype(np.asarray(like).dtype)


def restore(ckpt_dir: str, tree_like, step: int | None = None, host: int = 0):
    """Restore into the structure of ``tree_like``; returns (tree, step).
    Each leaf takes its template's dtype (and, for a tensor, its device);
    packed containers come back as new containers with the template's
    static fields, v1 fields relayouted on the way."""
    manifest, data, step = _open(ckpt_dir, step, host)
    flat_like = _flatten(tree_like)
    missing = [k for k, _ in flat_like
               if k not in manifest["keys"] and _v1_source_key(k, data) is None]
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    leaves = {}
    for key, like in flat_like:
        if key in data:
            arr = _load(data, manifest, key)
            bf16 = manifest["dtypes"].get(key) == "bfloat16"
        else:
            arr, bf16 = _upgrade_packed_leaf(key, data), False
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != model {tuple(like.shape)}")
        leaves[key] = _as_leaf(arr, like, bf16)
    return _unflatten(tree_like, leaves), step


def restore_flat(ckpt_dir: str, step: int | None = None, host: int = 0):
    """The raw ``{path key: np.ndarray}`` mapping of a checkpoint, without
    a template; returns (flat dict, step).  A bfloat16 leaf comes back as
    its ``|V2`` bytes, as JAX's ``restore_flat`` returns it (its dtype is
    in the manifest: :func:`restore_flat_tensors` reads it)."""
    manifest, data, step = _open(ckpt_dir, step, host)
    return {k: data[k] for k in manifest["keys"]}, step


def restore_flat_tensors(ckpt_dir: str, step: int | None = None, host: int = 0):
    """:func:`restore_flat` as tensors of each leaf's stored dtype, a
    bfloat16 leaf bit for bit; returns (flat dict, step)."""
    manifest, data, step = _open(ckpt_dir, step, host)
    out = {}
    for k in manifest["keys"]:
        t = torch.from_numpy(_contig(_load(data, manifest, k)))
        if manifest["dtypes"][k] == "bfloat16":
            t = t.view(torch.bfloat16)
        out[k] = t
    return out, step


def reshard_leaf(shards: list, axis: int, new_parts: int) -> list:
    """Elastic resharding: re-slice a leaf saved as ``len(shards)`` slices
    along ``axis`` into ``new_parts`` slices (another mesh size)."""
    full = np.concatenate([_to_numpy(s) for s in shards], axis=axis)
    if full.shape[axis] % new_parts:
        raise ValueError(f"new mesh of {new_parts} does not divide dim {full.shape[axis]}")
    return np.split(full, new_parts, axis=axis)
