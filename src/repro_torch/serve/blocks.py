"""Block-pool bookkeeping for the paged KV cache.

Port of ``repro.serve.blocks``: ``SCRATCH_BLOCK``, ``BlockError``,
``block_span`` (:53), ``blocks_written`` (:58), ``BlockAllocator`` (:67,
with the atomic copy-on-write entry ``ensure_writable``, :160) and
``PrefixCache`` (:195, hash-chained over block-aligned token runs, LRU
``evict_one``, ``forget``, ``drop_all``) are host-side numpy and port
nearly verbatim; ``copy_blocks`` (:297) becomes an in-place torch copy of
blocks ``src`` onto ``dst`` in every KV leaf of the per-layer pool list,
both children of a packed leaf included.

Layout contract (as in the JAX package):

* Physical block 0 is the SCRATCH block: never allocated.  The allocator
  counts it, so a pool of N blocks holds N-1 blocks of real KV.
* A block table row is a dense int32 vector; logical block j of a lane
  (ring slots ``[j*bs, (j+1)*bs)``) lives at ``table[j]``, unallocated
  entries stay 0.
* A block is writable only while its refcount is 1: writers call
  :meth:`BlockAllocator.ensure_writable` first, which splits shared
  blocks (the caller copies their contents with :func:`copy_blocks`).

``PrefixCache`` chains Python ``hash`` over token tuples, as the JAX
package does, so the two allocators see the same hits within one process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kvq import PackedKVBlock

__all__ = ["SCRATCH_BLOCK", "BlockAllocator", "PrefixCache", "BlockError",
           "copy_blocks", "blocks_written", "block_span"]

SCRATCH_BLOCK = 0


class BlockError(RuntimeError):
    """Raised when the pool cannot satisfy an allocation (exhaustion)."""


def block_span(n_tokens: int, block_size: int) -> int:
    """Logical blocks needed to hold ``n_tokens`` ring slots."""
    return -(-int(n_tokens) // int(block_size))


def blocks_written(pos: int, n_tokens: int, s_c: int, block_size: int):
    """Logical block indices a write of ``n_tokens`` starting at absolute
    position ``pos`` touches in a ring of ``s_c`` slots — the set COW must
    make writable before the step."""
    slots = (pos + np.arange(int(n_tokens))) % int(s_c)
    return sorted(set((slots // int(block_size)).tolist()))


class BlockAllocator:
    """Fixed pool of ``num_blocks`` physical blocks with refcounts; block 0
    (SCRATCH_BLOCK) is reserved and never handed out."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 scratch + 1 usable), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> low ids 1st
        self._ref = np.zeros(num_blocks, np.int32)
        self._ref[SCRATCH_BLOCK] = 1  # permanently pinned
        self.peak_used = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Allocated blocks, scratch excluded."""
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def refcounts(self) -> np.ndarray:
        return self._ref.astype(np.int64)

    def free_list(self) -> tuple:
        """Snapshot of the free list (ids, pop order last)."""
        return tuple(self._free)

    def shared_blocks(self) -> int:
        """Blocks physically shared right now (refcount > 1)."""
        return int(np.sum(self._ref[1:] > 1))

    @property
    def utilization(self) -> float:
        """Used fraction of the usable pool (scratch block 0 excluded)."""
        return self.used_blocks / max(self.num_blocks - 1, 1)

    def stats(self) -> dict:
        """Point-in-time gauges (the obs recorder samples them every paged
        scheduler iteration)."""
        return {"used": self.used_blocks,
                "free": self.free_blocks,
                "shared": self.shared_blocks(),
                "peak_used": self.peak_used,
                "utilization": self.utilization}

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise BlockError(
                f"KV block pool exhausted: need {n}, have {len(self._free)} "
                f"free of {self.num_blocks - 1} usable")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self._ref[b] == 0
            self._ref[b] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return out

    def share(self, bid: int) -> int:
        """Take an additional reference on an allocated block."""
        if bid == SCRATCH_BLOCK or self._ref[bid] == 0:
            raise ValueError(f"cannot share unallocated block {bid}")
        self._ref[bid] += 1
        return bid

    def free(self, bids) -> None:
        """Drop one reference per id; blocks return to the pool at zero.
        Scratch entries (unallocated table slots) are ignored."""
        for bid in bids:
            if bid == SCRATCH_BLOCK:
                continue
            if self._ref[bid] <= 0:
                raise ValueError(f"double free of block {bid}")
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                self._free.append(int(bid))

    def ensure_writable(self, table: np.ndarray, logical_blocks):
        """Copy-on-write: make every ``table[j]`` for j in
        ``logical_blocks`` exclusively owned, allocating replacements for
        shared entries.  Mutates ``table`` in place and returns
        ``(src_ids, dst_ids)``, the copies the caller issues with
        :func:`copy_blocks`.  Atomic: replacements are allocated up front,
        so a BlockError leaves the table and refcounts untouched."""
        shared = []
        for j in logical_blocks:
            bid = int(table[j])
            if bid == SCRATCH_BLOCK:
                raise ValueError(
                    f"write into unallocated logical block {j} (table holds "
                    f"scratch) — the admission reservation is too small")
            if self._ref[bid] > 1:
                shared.append(j)
        fresh = self.alloc(len(shared))  # raises BEFORE any mutation
        src, dst = [], []
        for j, nb in zip(shared, fresh):
            bid = int(table[j])
            self._ref[bid] -= 1  # still > 0: other holders remain
            table[j] = nb
            src.append(bid)
            dst.append(nb)
        return src, dst


@dataclasses.dataclass
class _PrefixEntry:
    bid: int          # physical block id (cache holds one reference)
    tick: int         # LRU stamp


class PrefixCache:
    """Hash-chained block-aligned prefix cache over prompt tokens:
    ``lookup`` returns the physical ids of the longest cached chain of
    full blocks prefixing a prompt, ``register`` inserts a lane's full
    blocks (the cache takes a reference on each), ``evict_one`` releases
    the least-recently-used entry nobody else references."""

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self._by_hash: dict = {}   # chain-hash -> _PrefixEntry
        self._tick = 0
        self.hits = 0              # block-level hit count (stats)
        self.lookups = 0

    def _chain(self, tokens: np.ndarray):
        """Yield (chain_hash, block index) per full block of ``tokens``."""
        bs = self.alloc.block_size
        h = hash("prefix-root")
        for j in range(len(tokens) // bs):
            blk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            h = hash((h, blk))
            yield h, j

    def lookup(self, tokens: np.ndarray) -> list[int]:
        """Longest cached full-block chain for this prompt; each returned
        id already carries a new reference for the caller."""
        self._tick += 1
        out = []
        for h, _ in self._chain(np.asarray(tokens)):
            e = self._by_hash.get(h)
            if e is None:
                break
            e.tick = self._tick
            out.append(self.alloc.share(e.bid))
            self.hits += 1
        self.lookups += 1
        return out

    def register(self, tokens: np.ndarray, table: np.ndarray) -> int:
        """Insert every full block of ``tokens`` (physical ids from
        ``table``) not yet cached; returns how many entries were added."""
        self._tick += 1
        added = 0
        for h, j in self._chain(np.asarray(tokens)):
            if h in self._by_hash:
                self._by_hash[h].tick = self._tick
                continue
            bid = int(table[j])
            if bid == SCRATCH_BLOCK:
                break  # not materialized
            self._by_hash[h] = _PrefixEntry(bid=self.alloc.share(bid),
                                            tick=self._tick)
            added += 1
        return added

    def evict_one(self) -> bool:
        """Release the LRU entry whose block only the cache still holds
        (refcount 1); False when nothing is evictable."""
        cand = [(e.tick, h) for h, e in self._by_hash.items()
                if self.alloc.refcount(e.bid) == 1]
        if not cand:
            return False
        _, h = min(cand)
        self.alloc.free([self._by_hash.pop(h).bid])
        return True

    def forget(self, bid: int) -> bool:
        """Drop the cache's entry (and its reference) for block ``bid``
        regardless of LRU order, so a writer about to overwrite it can own
        it in place.  False when no entry holds ``bid``."""
        for h, e in self._by_hash.items():
            if e.bid == bid:
                del self._by_hash[h]
                self.alloc.free([bid])
                return True
        return False

    def block_ids(self) -> list[int]:
        """Physical ids the cache holds a reference on (one per entry)."""
        return [e.bid for e in self._by_hash.values()]

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    def drop_all(self) -> None:
        for e in self._by_hash.values():
            self.alloc.free([e.bid])
        self._by_hash.clear()


def _pool_leaves(pool):
    """The block-axis-leading KV tensors of a per-layer pool list: float
    ``k``/``v`` pools and both children of packed ones."""
    for entry in pool:
        if "k" not in entry:
            continue  # a recurrent layer's lane state: nothing in blocks
        for name in ("k", "v"):
            leaf = entry[name]
            if isinstance(leaf, PackedKVBlock):
                yield leaf.qm
                yield leaf.scale
            else:
                yield leaf


def copy_blocks(pool, src, dst):
    """COW copy on the device, in place: blocks ``src`` of every KV leaf
    of ``pool`` (a list of per-layer ``{'k', 'v'}`` pools, block axis
    first) are copied onto blocks ``dst``.  The index vectors are built
    once and shared by every leaf."""
    if not len(src):
        return pool
    leaves = list(_pool_leaves(pool))
    dev = leaves[0].device
    s = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    d = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    for leaf in leaves:
        leaf[d] = leaf[s]
    return pool
