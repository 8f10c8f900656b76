"""Which shard of each parameter and cache a rank of a mesh holds.

Port of the serving rules of ``repro.parallel.sharding``: ``batch_axes``
(:29), ``serve_pspecs`` (:212) as :func:`serve_cuts` — the rank's slice of
each parameter instead of a PartitionSpec, since an SPMD rank holds only
its own shard — and the dense rule of ``cache_pspecs`` (:141) as
:func:`cache_rows`.

:func:`serve_cuts` is the port's one tensor-parallel plan (JAX's
``parallel.context._GATHERED``), the Megatron split: column shards over
'model' for wq/wk/wv/w1/w3/lm_head, group-aligned K-row shards
for wo/w2, everything else (embeddings, norms) replicated; a split falls
back to replication where its dim does not divide, as in JAX.  One thing
differs: GSPMD may cut an attention projection through a head, because it
computes attention over the whole mesh; an SPMD rank computes attention on
the heads it holds, so the attention weights split by whole heads — the
same split of q heads on wq and wo, and on wk/wv the KV heads those q
heads read.  Where the KV heads do not divide over 'model' (GQA with fewer
KV heads than ranks), each rank keeps the KV-head columns its q heads
need, shared with the ranks whose q heads need the same ones.  Where the
q heads do not divide, or a rank's slice of wo would not be group-aligned,
attention replicates.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from repro_torch.core.packed import PackedDSBPWeight

__all__ = ["GROUP", "Cut", "batch_axes", "serve_cuts", "cut_weight", "shard_model",
           "cache_rows"]

GROUP = 64  # the DSBP group size (kernels.dsbp_fused.GROUP)


@dataclasses.dataclass(frozen=True)
class Cut:
    """A rank's slice ``[rows, cols]`` of a global ``(k, n)`` parameter,
    and the mesh axes that split its rows (the partial outputs fold over
    ``k_axis``) and its columns."""
    k: int
    n: int
    rows: slice
    cols: slice
    k_axis: str | None = None
    n_axis: str | None = None


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes that split token rows (data parallelism)."""
    return ("data",)


def _even(mesh, axis: str, dim: int) -> slice:
    size, c = mesh.shape[axis], mesh.coords[axis]
    return slice(c * dim // size, (c + 1) * dim // size)


def serve_cuts(cfg, mesh) -> dict[str, Cut]:
    """This rank's :class:`Cut` of every planned parameter of a dense
    decoder (keyed by weight name; every layer has the same shapes).
    Parameters without an entry replicate."""
    d, dh, ff, vp = cfg.d_model, cfg.d_head, cfg.d_ff, cfg.padded_vocab_size
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    rep = hq // hkv
    ax = "model"  # the plan's one tensor-parallel axis
    msz = mesh.shape.get(ax, 1)

    def whole(k, n):
        return Cut(k, n, slice(0, k), slice(0, n))

    cuts = {name: whole(k, n) for name, (k, n) in {
        "wq": (d, hq * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh), "wo": (hq * dh, d),
        "w1": (d, ff), "w3": (d, ff), "w2": (ff, d), "lm_head": (d, vp)}.items()}
    if msz == 1:
        return cuts
    # attention: whole q heads per rank, wo's rows group-aligned, and a
    # local GQA map (each rank's q heads read a run of its KV heads)
    per = hq // msz if hq % msz == 0 else 0
    if per and (per * dh) % GROUP == 0 and (per % rep == 0 or rep % per == 0):
        c = mesh.coords[ax]
        h0, h1 = c * per, (c + 1) * per
        q = slice(h0 * dh, h1 * dh)
        kv = slice(h0 // rep * dh, ((h1 - 1) // rep + 1) * dh)
        kv_axis = ax if hkv % msz == 0 else None
        cuts["wq"] = Cut(d, hq * dh, slice(0, d), q, None, ax)
        for name in ("wk", "wv"):
            cuts[name] = Cut(d, hkv * dh, slice(0, d), kv, None, kv_axis)
        cuts["wo"] = Cut(hq * dh, d, q, slice(0, d), ax, None)
    # SiLU FFN: w1/w3 columns and w2's rows over the same (group-aligned) split
    if ff % (GROUP * msz) == 0:
        f = _even(mesh, ax, ff)
        for name in ("w1", "w3"):
            cuts[name] = Cut(d, ff, slice(0, d), f, None, ax)
        cuts["w2"] = Cut(ff, d, f, slice(0, d), ax, None)
    if vp % msz == 0:
        cuts["lm_head"] = Cut(d, vp, slice(0, d), _even(mesh, ax, vp), None, ax)
    return cuts


def cut_weight(w, cut: Cut):
    """The rank's slice of a global raw tensor or packed container (a
    copy, so the global one can be freed); anything not of the cut's
    global shape, or cut to the whole of it, is returned as it is."""
    packed = isinstance(w, PackedDSBPWeight)
    if ((w.k, w.n) if packed else tuple(w.shape[-2:])) != (cut.k, cut.n) or (
            cut.rows == slice(0, cut.k) and cut.cols == slice(0, cut.n)):
        return w
    if packed:
        return w.slice(rows=cut.rows, cols=cut.cols)
    return nn.Parameter(w.data[..., cut.rows, cut.cols].clone(), requires_grad=False)


def shard_model(model, cuts: dict[str, Cut]) -> None:
    """Replace, in place, every planned parameter of ``model`` that still
    has its global shape by this rank's slice (raw tensors and packed
    containers alike)."""
    for module in list(model.modules()):
        names = [n for n, _ in module.named_parameters(recurse=False)]
        names += [n for n, m in module.named_children() if isinstance(m, PackedDSBPWeight)]
        for name in names:
            if name in cuts:
                w = cut_weight(getattr(module, name), cuts[name])
                delattr(module, name)
                setattr(module, name, w)


def cache_rows(mesh, batch: int) -> slice | None:
    """The dense cache rule: the rows (slots) this rank holds — its even
    share over 'data' when the batch divides, else None (every rank holds
    every row).  KV heads follow the layer's own wk shard."""
    dsz = mesh.shape.get("data", 1)
    if dsz == 1 or batch % dsz:
        return None
    return _even(mesh, "data", batch)
