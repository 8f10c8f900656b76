"""Rank meshes over ``torch.distributed``, and a launcher for their ranks.

The port's counterpart of ``repro.launch.mesh``, which builds JAX device
meshes (16x16 per pod) that one program partitions with GSPMD.  Here a mesh
is SPMD: every rank is a process that runs the same program on its own
shards, and a :class:`RankMesh` is one rank's view of the grid — its
coordinates along the named axes (``("data", "model")``), the axis sizes,
and one process group per axis for the collectives that cross it.

* :func:`make_mesh` builds that view over an initialized default process
  group.  Every rank must call it, with the same shape, at the same point:
  ``new_group`` is collective over the whole world.  A mesh of one rank
  needs no process group at all (its collectives are the identity).
* :func:`spawn` starts ``D*M`` processes with the ``spawn`` start method
  (a parent that has initialized CUDA cannot fork), rendezvous through a
  ``FileStore`` in a temporary directory (no TCP port, so concurrent
  launches never collide), and sets a timeout on every process group: a
  collective that one rank misses fails there instead of hanging.  A rank
  that raises makes :func:`spawn` raise.

Backend rule: ``nccl`` when every rank has a card of its own, ``gloo``
otherwise — on the CPU, and when ranks share one card (NCCL refuses two
ranks on one device; gloo stages CUDA tensors through the host).
"""
from __future__ import annotations

import collections
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["RankMesh", "make_mesh", "spawn", "backend_for", "rank_device",
           "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = timedelta(seconds=300)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class RankMesh:
    """One rank's view of a named process grid (row-major: rank =
    ``np.ravel_multi_index(coords, shape)``).  ``collectives`` counts the
    collectives this rank entered, by ``"<op>:<axis>"``."""

    def __init__(self, shape, axes, rank: int, groups: dict, device=None):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in shape)))
        self.rank = int(rank)
        self.coords = dict(zip(self.axes, (int(c) for c in
                                           np.unravel_index(rank, tuple(shape)))))
        self.groups = groups  # axis -> ProcessGroup, for axes of size > 1
        self.device = torch.device(device) if device is not None else None
        self.collectives: collections.Counter = collections.Counter()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def all_reduce(self, t: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        """In-place ``all_reduce`` of ``t`` over ``axis`` ('sum' or 'max');
        the identity along an axis of one rank.  Returns ``t``."""
        if self.shape[axis] > 1:
            dist.all_reduce(t, op=_OPS[op], group=self.groups[axis])
            self.collectives[f"{op}:{axis}"] += 1
        return t

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return f"RankMesh(rank={self.rank}, coords={self.coords}, shape={self.shape})"


# one mesh per (shape, axes) and default group: new_group is collective, so
# an Engine built later on one rank than on another must find the groups
# made already (spawn makes them before the rank function runs)
_MESHES: dict = {}


def make_mesh(shape, axes=("data", "model"), *, device=None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> RankMesh:
    """This rank's :class:`RankMesh` of ``shape`` over the initialized
    default process group (whose world size must be ``prod(shape)``).
    Groups are made once per process and shape, every axis's groups in the
    same order on every rank; ``shape`` of one rank needs no group."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} needs one size per axis name {axes}")
    n = math.prod(shape)
    if n == 1:
        return RankMesh(shape, axes, 0, {}, device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh_shape {shape} needs an initialized torch.distributed process "
            f"group of {n} ranks (repro_torch.launch.mesh.spawn starts one); "
            f"none is initialized")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh_shape {shape} needs {n} ranks; the process group "
                           f"has {dist.get_world_size()}")
    key = (shape, axes, id(dist.group.WORLD))
    mesh = _MESHES.get(key)
    if mesh is None:
        rank = dist.get_rank()
        grid = np.arange(n).reshape(shape)
        groups = {}
        for i, axis in enumerate(axes):
            if shape[i] == 1:
                continue
            for ranks in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                group = dist.new_group(ranks.tolist(), timeout=timeout)
                if rank in ranks:
                    groups[axis] = group
        mesh = _MESHES[key] = RankMesh(shape, axes, rank, groups, device)
    return mesh


def backend_for(device: torch.device, world: int) -> str:
    """The process-group backend for ``world`` ranks computing on
    ``device``'s type: NCCL only when each rank has a card of its own."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, world: int) -> torch.device:
    """Rank ``rank``'s device: its own card when there are enough, else the
    first card (ranks then time-slice it); the CPU for a CPU run."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank if world <= torch.cuda.device_count() else 0)


def _rank_main(rank, world, shape, axes, device, store_path, timeout_s, fn, args, results):
    try:
        dev = rank_device(torch.device(device), rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        timeout = timedelta(seconds=timeout_s)
        backend = backend_for(torch.device(device), world)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timeout,
                                device_id=dev if backend == "nccl" else None)
        mesh = make_mesh(shape, axes, device=dev, timeout=timeout)
        # pickled by value here: a tensor sent as is would share its storage
        # through this process, which may have exited when it is read
        results.put((rank, True, pickle.dumps(fn(mesh, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, mesh_shape, *args, device="cuda", store_dir=None,
          timeout: timedelta = DEFAULT_TIMEOUT,
          deadline_s: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` in ``prod(mesh_shape)`` fresh processes,
    one per rank, each with its ('data', 'model') :class:`RankMesh`; returns the ranks'
    results in rank order.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  ``timeout`` bounds every collective;
    ``deadline_s`` (optional) the whole run.  Raises if any rank fails,
    after stopping every rank."""
    world = math.prod(int(s) for s in mesh_shape)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, tuple(mesh_shape), ("data", "model"), str(device),
                                   store_path, timeout.total_seconds(), fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        end = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                    elif end is not None and time.monotonic() > end:
                        failure = f"ranks still running after {deadline_s} s"
                    continue
                if ok:
                    out[rank] = pickle.loads(payload)
                else:
                    failure = f"rank {rank} failed:\n{payload}"
            if failure is None:
                for p in procs:
                    p.join(timeout=timeout.total_seconds())
                bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
                if bad:
                    failure = f"ranks exited with codes {bad}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn of mesh {tuple(mesh_shape)}: {failure}")
    return [out[r] for r in range(world)]
