"""Host-side paged KV-cache bookkeeping: refcounted free-list allocator.

Port of ``repro.serving.paged`` (pure host code, copied).

The device-side pool is built by each model's ``init_paged_cache`` (the
``init_cache`` pytree with the batch axis reinterpreted as blocks) and is
addressed through the scatter/gather primitives in ``repro_torch.core.paging``.
This module owns the allocation policy: a sequence is admitted with
``blocks_for(prompt + max_new)`` blocks (so it can never run out
mid-flight) and returns them the moment it finishes — which is what lets
the scheduler admit a waiting request immediately instead of stalling
until the whole static batch drains (vLLM-style continuous batching; the
serving posture GLM-5 §3.6 assumes for agentic workloads).

Blocks are REFCOUNTED so the prefix cache (``repro_torch.serving.prefix_cache``)
can alias one physical block into many sequences' block tables: ``alloc``
hands out blocks at refcount 1, ``retain`` adds a reference (a new reader
of a shared prefix), ``release`` drops one and only returns the block to
the free list when the count reaches zero.  ``free`` is the strict
variant — it requires exclusive ownership (refcount 1) and exists for the
cache-off path where sharing would be a bug.  A shared block must never
be written; a sequence that needs to diverge inside one copies it first
(copy-on-write — the device copy lives in the engine, the ownership swap
here).

When the free list runs dry ``alloc`` asks an optional ``evictor`` (the
prefix cache's LRU) to release cached, unreferenced blocks before giving
up with ``CacheFull``.  The evictor protocol has a second, optional half:
``demote_hook`` — registered by a spill tier (``repro_torch.serving.spill``),
called by the evictor with a victim's token path, block id, and version
stamp JUST BEFORE the block is released under allocation pressure, so the
block's bytes can be gathered to host memory first (eviction becomes
"demote", not "forget").  The hook is advisory: it must not allocate from
or mutate this pool, and eviction proceeds identically whether or not it
is registered (the tier only ADDS a place the bytes survive).

Blocks are also VERSION-TAGGED: the allocator carries a monotonically
increasing weight ``version`` (bumped by ``set_version`` when the engine
applies a trainer weight push) and every block is stamped with the
version current when it was allocated — which, under the engine's
drain-barrier push protocol (a push applies only when no sequence is
in flight), is exactly the version of the weights that WROTE its KV.
The prefix cache consults ``block_version`` so admission never aliases
KV computed under older weights into a newer forward; stale blocks are
not eagerly freed on a push — they age out through the LRU evictor
(incremental invalidation instead of a full cache reset).  A freed
block loses its stamp; re-allocation restamps at the current version.

Invariants (tested in tests/test_paged_serving.py + test_prefix_cache.py):
  * every block is either free or allocated, never both (conservation:
    ``free_blocks + used_blocks == num_blocks`` at all times);
  * ``alloc`` never hands out a block twice before its refcount hits 0;
  * ``release`` rejects blocks that are not allocated (double-release of
    an exclusively-held block frees it once, then errors);
  * ``free`` rejects double-frees, foreign blocks, and shared blocks;
  * ``alloc`` raises ``CacheFull`` rather than over-committing.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.paging import blocks_for  # noqa: F401  (re-export)
from repro_torch.obs.metrics import MetricsRegistry, StatsView


class CacheFull(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class PagedKVCache:
    """Refcounted free-list allocator over ``num_blocks`` blocks."""

    def __init__(self, num_blocks: int, block_size: int,
                 registry: Optional[MetricsRegistry] = None,
                 faults=None):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # deterministic fault injection (repro_torch.faults): the "alloc" point
        # raises CacheFull here so an injected alloc-fail storm exercises
        # the REAL pressure paths (retry-cold, stall, shedding) end to end
        self.faults = faults
        # telemetry: allocation counters as a registry-backed view, plus
        # free/used gauges kept current for snapshot()/dashboards (the
        # engine shares its registry here, so pool pressure shows up next
        # to the TTFT histograms it causes)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stats = StatsView(self.registry, "kv",
                               ["blocks_allocated", "blocks_recycled"])
        self.registry.set_gauge("kv.free_blocks", num_blocks)
        self.registry.set_gauge("kv.used_blocks", 0)
        # LIFO free list, seeded so pop() hands out low ids first (makes
        # allocation order deterministic and easy to read in tests).
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        # Called with the shortfall when alloc cannot be satisfied; should
        # release() cached blocks and return how many it let go.
        self.evictor: Optional[Callable[[int], int]] = None
        # The evictor protocol's demote half: called by the evictor with
        # (token_path, block, version) just before a cached block is
        # released under pressure.  A spill tier registers here to gather
        # the block's bytes to host memory first; None = evict-as-forget.
        self.demote_hook: Optional[
            Callable[[tuple, int, int], bool]] = None
        # weight version stamped onto blocks at alloc time (the version of
        # the weights that write their KV, under the drain-barrier push
        # protocol); bumped by set_version on an applied weight push
        self.version = 0
        self._bver: Dict[int, int] = {}

    def _sync_gauges(self) -> None:
        self.registry.set_gauge("kv.free_blocks", len(self._free))
        self.registry.set_gauge("kv.used_blocks", len(self._ref))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        """Current reference count (0 for free/unknown blocks)."""
        return self._ref.get(block, 0)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    # ------------------------------------------------------------- versions
    def set_version(self, version: int) -> None:
        """Bump the allocator's weight version (an applied weight push).

        Blocks already allocated keep their old stamp — they hold KV
        computed under the previous weights and must never be aliased
        into a newer forward (``PrefixCache.match`` enforces this)."""
        if version < self.version:
            raise ValueError(f"weight versions are monotone: "
                             f"{version} < {self.version}")
        self.version = version

    def block_version(self, block: int) -> int:
        """Version stamped when ``block`` was allocated (-1 if free)."""
        return self._bver.get(block, -1)

    def stale_blocks(self) -> int:
        """Allocated blocks stamped with an older version than current."""
        return sum(1 for v in self._bver.values() if v != self.version)

    def restamp(self, blocks: List[int], version: int) -> None:
        """Overwrite the version stamp of allocated ``blocks``.

        The migration import path: a block scattered into this pool from
        a FOREIGN pool holds KV written under the SOURCE engine's
        weights, so its stamp must be the source's version, not the
        version current when the destination allocated the landing
        block.  Preserving the true writer version is what lets the
        radix tree keep (or refuse) migrated KV correctly across weight
        pushes.  Monotonicity bounds it at the allocator's current
        version — KV from the future cannot exist."""
        bad = [b for b in blocks if b not in self._ref]
        if bad:
            raise ValueError(f"restamp: blocks {bad} are not allocated")
        if version > self.version:
            raise ValueError(f"restamp: version {version} is ahead of the "
                             f"allocator's current {self.version}")
        for b in blocks:
            self._bver[b] = version

    # ------------------------------------------------------------ lifetime
    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` blocks off the free list at refcount 1.

        Asks the evictor (if registered) to release cached blocks first;
        raises CacheFull if still short."""
        if n <= 0:
            raise ValueError(f"alloc({n}): need a positive block count")
        if self.faults is not None and self.faults.fires("alloc"):
            raise CacheFull(f"injected alloc failure "
                            f"(alloc@{self.faults.calls['alloc'] - 1})")
        if n > len(self._free) and self.evictor is not None:
            self.evictor(n - len(self._free))
        if n > len(self._free):
            raise CacheFull(f"need {n} blocks, only {len(self._free)} free "
                            f"(capacity {self.num_blocks})")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
            self._bver[b] = self.version
        self.stats["blocks_allocated"] += n
        self._sync_gauges()
        return blocks

    def retain(self, blocks: List[int]) -> None:
        """Add one reference to each block (aliasing a shared prefix).

        Atomic: validates the whole batch before mutating.  A block may
        appear at most once per call — the same validation ``release``
        and ``free`` apply, so a buggy caller cannot create references
        in one call that ``release`` then refuses to drop in one call."""
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate blocks in retain(): {blocks}")
        bad = [b for b in blocks if b not in self._ref]
        if bad:
            raise ValueError(f"retain: blocks {bad} are not allocated")
        for b in blocks:
            self._ref[b] += 1

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block; frees those that reach zero.

        Atomic: validates the whole batch before mutating.  A block may
        appear at most once per call (a sequence owns each block once)."""
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate blocks in release(): {blocks}")
        bad = [b for b in blocks if b not in self._ref]
        if bad:
            raise ValueError(f"release: blocks {bad} are not allocated")
        recycled = 0
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                del self._bver[b]
                self._free.append(b)
                recycled += 1
        if recycled:
            self.stats["blocks_recycled"] += recycled
            self._sync_gauges()

    def free(self, blocks: List[int]) -> None:
        """Strict release: every block must be exclusively held (ref 1).

        The cache-off path uses this so an accidental alias (a bug there)
        fails loudly instead of silently dropping a reader's data."""
        bad = [b for b in blocks if b not in self._ref]
        if bad:
            raise ValueError(f"blocks {bad} are not currently allocated")
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate blocks in free(): {blocks}")
        shared = [b for b in blocks if self._ref[b] != 1]
        if shared:
            raise ValueError(f"blocks {shared} are shared (refcount > 1); "
                             f"use release()")
        for b in blocks:
            del self._ref[b]
            del self._bver[b]
            self._free.append(b)
        self.stats["blocks_recycled"] += len(blocks)
        self._sync_gauges()
