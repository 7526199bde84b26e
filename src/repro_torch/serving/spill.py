"""Host-RAM spill tier for the radix prefix cache: demote, don't forget.

Port of ``repro.serving.spill``.  The radix tree's LRU evictor reclaims
cold prefixes under allocation pressure; without a second tier every
reclaimed block means a future request re-prefills tokens the engine
already computed once.  ``HostSpillTier`` turns eviction from "forget"
into "demote":

* **Demote** (the allocator's ``demote_hook``, fired by
  ``PrefixCache.evict`` just before a cold leaf's block is released):
  copy the block's rows of every pool leaf into PINNED host tensors,
  keyed by the radix node's full TOKEN PATH and stamped with the block's
  weight version.  The copies are asynchronous on the serve thread's
  current stream and an event marks their end: the block may be
  reallocated and overwritten at once, because every later write to it is
  ordered after the copy on that stream.
* **Restore** (``PrefixCache.match`` on a spilled-prefix hit): allocate
  landing blocks, copy the host rows back and write them IN PLACE into the
  preallocated pool tensors (``index_copy_``), on the same stream after
  the demote's event, so the step that reads the blocks comes after the
  write.  The landing blocks are ``restamp``-ed to the entry's writer
  version and handed to the radix tree: admission aliases them exactly
  like a warm hit.  (The reference scatters with one donated jit padded
  to a power-of-two block count, its pad lanes writing a trash row: those
  exist for XLA's jit cache and have no counterpart here.)

Spill is BYTE-EXACT: a copy out and a copy back of the raw pool rows, no
quantization, so every greedy parity oracle holds with the tier on.

Weight-version contract: an entry carries the version of the weights that
WROTE its KV.  A lookup whose entry is stale (a weight push landed since
the demote) DROPS the entry (``spill.dropped_stale``) and reports a miss;
blocks already stale at eviction are never demoted.  Capacity is bounded
in blocks (``REPRO_SPILL_BLOCKS``); past it the OLDEST entry is dropped
(``spill.dropped_capacity``).  Re-demoting a key refreshes its entry.

Obs: ``spill.demotions`` / ``spill.restores`` / ``spill.restored_blocks``
/ ``spill.dropped_stale`` / ``spill.dropped_capacity`` counters,
``spill.demote_ms`` / ``spill.restore_ms`` (host time of the call: the
copies are asynchronous) and ``spill.bytes`` / ``spill.restored_bytes``
histograms, and ``spill.blocks`` / ``spill.capacity`` gauges, all in the
engine's registry.
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.obs.metrics import MetricsRegistry

# spill payloads are bytes, not milliseconds: decade buckets 64 KiB..64 MiB
BYTES_BUCKETS = [2.0 ** p for p in range(16, 27)]


def pool_leaves(pool: dict) -> List[torch.Tensor]:
    """The paged leaves of a pool in a fixed order: every tensor of the
    (nested) dict, leaf shape ``(L * stride, block_size, *feat)``; the
    hybrid's per-slot ``ssm`` state is not paged and is left out."""
    out: List[torch.Tensor] = []
    for name, v in pool.items():
        if name == "ssm":
            continue
        out.extend(pool_leaves(v) if isinstance(v, dict) else [v])
    return out


def _rows(leaf: torch.Tensor, stride: int, blocks: Sequence[int]
          ) -> torch.Tensor:
    """Row ids of ``blocks`` in every layer of a layer-major leaf, layer
    by layer: ``(L * n,)``."""
    L = leaf.shape[0] // stride
    bl = torch.as_tensor(list(blocks), dtype=torch.long)
    rows = torch.arange(L)[:, None] * stride + bl[None, :]
    return rows.reshape(-1).to(leaf.device)


def gather_rows(pool: dict, stride: int, blocks: Sequence[int]
                ) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
    """Copy ``blocks``' rows of every pool leaf to host memory: one tensor a
    leaf shaped ``(L, n, block_size, *feat)``.  From the card the copies
    are asynchronous into pinned memory on the current stream, and the
    returned event marks their end (None on the CPU, where they are done
    on return): synchronise it before the host reads them."""
    out = []
    ev = None
    leaves = pool_leaves(pool)
    for leaf in leaves:
        L = leaf.shape[0] // stride
        part = leaf.index_select(0, _rows(leaf, stride, blocks)).reshape(
            (L, len(blocks)) + tuple(leaf.shape[1:]))
        if leaf.device.type == "cpu":
            out.append(part)
            continue
        host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
        host.copy_(part, non_blocking=True)
        out.append(host)
    if leaves and leaves[0].device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(leaves[0].device))
    return out, ev


def scatter_rows(pool: dict, stride: int, blocks: Sequence[int],
                 hosts: Sequence[Sequence[torch.Tensor]],
                 ready: Sequence[Optional[torch.cuda.Event]]) -> None:
    """Write host rows back into ``blocks`` of every pool leaf, in place.
    ``hosts[j]`` holds the leaves' rows of one or more consecutive blocks
    (``(L, n_j, block_size, *feat)``, ``sum n_j == len(blocks)``), made by
    ``gather_rows``; ``ready[j]`` is its copy-out event, which the current
    stream waits for before the copy back reads the pinned buffer."""
    leaves = pool_leaves(pool)
    dev = leaves[0].device
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        for ev in ready:
            if ev is not None:
                stream.wait_event(ev)
    for li, leaf in enumerate(leaves):
        parts = [h[li].to(dev, non_blocking=True) for h in hosts]
        data = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        leaf.index_copy_(0, _rows(leaf, stride, blocks),
                         data.reshape((-1,) + tuple(leaf.shape[1:])))


class _SpillEntry:
    """One demoted block: per-pool-leaf host tensors shaped
    ``(L, 1, block_size, *feat)``, their copy-out event, the weight version
    that wrote the KV, and the byte count (accounting only)."""
    __slots__ = ("leaves", "ready", "version", "nbytes")

    def __init__(self, leaves: List[torch.Tensor],
                 ready: Optional[torch.cuda.Event], version: int):
        self.leaves = leaves
        self.ready = ready
        self.version = version
        self.nbytes = sum(a.numel() * a.element_size() for a in leaves)


class HostSpillTier:
    """Second KV-cache tier: cold radix blocks in pinned host memory.

    ``engine`` is anything with the serving pool contract: ``.kv`` (the
    ``PagedKVCache`` whose blocks are demoted and restored) and ``.pool``
    (the layer-major pool, leaves ``(L * (num_blocks + 1), block_size,
    *feat)``).  ``attach`` wires the tier into a ``PrefixCache`` and its
    allocator; everything runs on the thread that owns the engine."""

    def __init__(self, engine, *, capacity_blocks: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        from repro_torch.flags import spill_blocks
        self.engine = engine
        self.kv = engine.kv
        cap = spill_blocks() if capacity_blocks is None else capacity_blocks
        self.capacity_blocks = cap if cap > 0 else None
        self.registry = registry if registry is not None \
            else self.kv.registry
        # insertion-ordered: popitem(last=False) drops the OLDEST entry
        # under capacity pressure; re-demote refreshes via move_to_end
        self._entries: "collections.OrderedDict[Tuple[int, ...], " \
            "_SpillEntry]" = collections.OrderedDict()
        self._stride = self.kv.num_blocks + 1
        self.registry.set_gauge("spill.capacity",
                                0 if self.capacity_blocks is None
                                else self.capacity_blocks)
        self._sync_gauges()

    # ------------------------------------------------------------- queries
    @property
    def spilled_blocks(self) -> int:
        return len(self._entries)

    @property
    def spilled_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def has(self, path: Tuple[int, ...]) -> bool:
        return path in self._entries

    def _sync_gauges(self) -> None:
        self.registry.set_gauge("spill.blocks", len(self._entries))

    # -------------------------------------------------------------- demote
    def demote(self, path: Tuple[int, ...], block: int,
               version: int) -> bool:
        """Copy ``block``'s pool rows to host, keyed by the radix node's
        token path (registered as ``PagedKVCache.demote_hook``; the caller
        releases the block afterwards).  Stale blocks are refused: lookup
        drops anything older than the allocator's version, so they could
        never be restored.  Returns True when the entry landed."""
        if version != self.kv.version:
            return False
        t0 = time.perf_counter()
        leaves, ready = gather_rows(self.engine.pool, self._stride, [block])
        ent = _SpillEntry(leaves, ready, version)
        self._entries[path] = ent
        self._entries.move_to_end(path)
        reg = self.registry
        reg.inc("spill.demotions")
        reg.observe("spill.demote_ms", (time.perf_counter() - t0) * 1e3)
        reg.observe("spill.bytes", float(ent.nbytes),
                    boundaries=BYTES_BUCKETS)
        while self.capacity_blocks is not None \
                and len(self._entries) > self.capacity_blocks:
            self._entries.popitem(last=False)       # the oldest drops
            reg.inc("spill.dropped_capacity")
        self._sync_gauges()
        return True

    # -------------------------------------------------------------- lookup
    def lookup(self, path: Tuple[int, ...]) -> Optional[_SpillEntry]:
        """Entry for ``path`` at the CURRENT weight version, or None.  A
        stale entry (a weight push since the demote) is DROPPED here and
        never restored."""
        ent = self._entries.get(path)
        if ent is None:
            return None
        if ent.version != self.kv.version:
            del self._entries[path]
            self.registry.inc("spill.dropped_stale")
            self._sync_gauges()
            return None
        return ent

    # ------------------------------------------------------------- restore
    def restore(self, keyed: List[Tuple[Tuple[int, ...], _SpillEntry]],
                blocks: List[int]) -> None:
        """Write a chain of spilled entries into landing ``blocks`` (already
        allocated by the caller, in position order) in place, restamp them
        to the writer version and consume the entries.  MUST run on the
        engine's owning thread."""
        assert keyed and len(keyed) == len(blocks)
        t0 = time.perf_counter()
        scatter_rows(self.engine.pool, self._stride, blocks,
                     [ent.leaves for _, ent in keyed],
                     [ent.ready for _, ent in keyed])
        version = keyed[0][1].version
        nbytes = sum(ent.nbytes for _, ent in keyed)
        self.kv.restamp(blocks, version)
        for path, _ in keyed:
            self._entries.pop(path, None)           # moved back to the pool
        reg = self.registry
        reg.inc("spill.restores")
        reg.inc("spill.restored_blocks", len(blocks))
        reg.observe("spill.restore_ms", (time.perf_counter() - t0) * 1e3)
        reg.observe("spill.restored_bytes", float(nbytes),
                    boundaries=BYTES_BUCKETS)
        self._sync_gauges()

    # ------------------------------------------------------------- wiring
    def attach(self, prefix) -> None:
        """Wire the tier into a ``PrefixCache`` and its allocator: the
        allocator's ``demote_hook`` feeds demotions, the tree's ``spill``
        attribute drives restores inside ``match``."""
        if prefix.kv is not self.kv:
            raise ValueError("spill tier and prefix cache must share one "
                             "allocator")
        self.kv.demote_hook = self.demote
        prefix.spill = self

    def clear(self) -> None:
        """Drop every spilled entry (benchmark hygiene, engine respawn)."""
        self._entries.clear()
        self._sync_gauges()
