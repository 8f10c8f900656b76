"""The sharding context a multi-rank engine runs its model calls under.

Port of ``repro.parallel.context``: :func:`active_ctx` (:49) /
:func:`sharding_ctx` (:66) as a ``contextvars`` context.  The JAX context
holds a ``Mesh`` that GSPMD partitions one program over; this one holds a
rank mesh (:class:`repro_torch.launch.mesh.RankMesh`: this rank's
coordinates, the axis sizes and one process group per axis), the batch
axes that split the rows of the call's activations, and the plan as the
engine cut the weights — each projection's ``(k_axis, n_axis)`` from
``parallel.sharding.serve_cuts``, the port's one copy of the
tensor-parallel plan (JAX's ``_GATHERED`` / ``tp_axes_for``, :36-57, with
the divisibility fallbacks applied).

Not ported: ``constrain``, ``gather_unit_params`` and ``anchor_batch``
(:84-153).  They pin GSPMD's choices for one program over the whole mesh
(FSDP gathers at use, the residual stream's batch sharding); an SPMD rank
holds its shards where it computes with them and has nothing to pin.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch

__all__ = ["sharding_ctx", "active_ctx", "ShardingCtx", "fold_partials",
           "gather_columns"]

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh_ctx",
                                                      default=None)


class ShardingCtx(NamedTuple):
    mesh: object                 # repro_torch.launch.mesh.RankMesh
    batch_axes: tuple            # axes splitting this call's activation rows
    plan: dict                   # name -> (k_axis, n_axis) as the weights were cut


def active_ctx() -> ShardingCtx | None:
    """The active sharding context, or None (single-device semantics).
    Read by the 'dsbp_fused_sharded' method and the float paths of
    ``models.layers.dense`` / ``Model.head``."""
    return _CTX.get()


@contextlib.contextmanager
def sharding_ctx(mesh, batch_axes: tuple = (), plan: dict | None = None):
    """Run model calls under ``mesh``: ``batch_axes`` name the axes whose
    ranks hold different activation rows in these calls (the input scale
    of every quantized projection is then reduced over them), ``plan`` the
    weights' cut."""
    token = _CTX.set(ShardingCtx(mesh, tuple(batch_axes), dict(plan or {})))
    try:
        yield
    finally:
        _CTX.reset(token)


def _axes(name):
    ctx = active_ctx()
    if ctx is None:
        return None, (None, None)
    return ctx, ctx.plan.get(name, (None, None))


def fold_partials(y: torch.Tensor, name: str | None) -> torch.Tensor:
    """A float (unquantized) projection's output: the row-parallel partial
    products of this rank's K shard summed over the plan's k_axis (one
    ``all_reduce``); unchanged for any other projection."""
    ctx, (k_axis, _) = _axes(name)
    if k_axis is None:
        return y
    return ctx.mesh.all_reduce(y.contiguous(), "sum", k_axis)


def gather_columns(y: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """This rank's column shard ``y (..., n/s)`` of a column-parallel
    output as the whole ``(..., n)``: placed in a zero-filled buffer at the
    rank's offset and summed over the plan's n_axis (gloo cannot
    all_gather CUDA tensors; adding zeros is exact)."""
    ctx, (_, n_axis) = _axes(name)
    if n_axis is None:
        return y
    n_l = y.shape[-1]
    full = y.new_zeros(*y.shape[:-1], n)
    j = ctx.mesh.coords[n_axis] * n_l
    full[..., j:j + n_l] = y
    return ctx.mesh.all_reduce(full, "sum", n_axis)
