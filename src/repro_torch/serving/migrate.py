"""KV-block migration between disaggregated serving engines.

Port of ``repro.serving.migrate``.  The paged layout makes prefill/decode
disaggregation a BLOCK COPY, not a re-layout: both engines address the
same layer-major pools — leaf shape ``(num_layers * stride, block_size,
*feat)`` with ``stride = num_blocks + 1`` — so shipping a prefix from the
prefill tier into the decode tier is

  1. ``extract`` (ON THE SOURCE SERVE THREAD): radix-match the prompt in
     the source engine's prefix cache (``match`` retains the blocks on
     our behalf), copy the matched rows of every pool leaf into pinned
     host memory (asynchronous on the source thread's stream, an event
     marking their end), release the source references.  The payload is
     self-contained: the source engine can evict, crash, or respawn the
     moment extract returns and the migration still lands.
  2. ``install`` (ON THE DESTINATION SERVE THREAD): allocate landing
     blocks from the decode pool, wait (on the device) for the payload's
     copy-out event, copy the rows back and write them IN PLACE into the
     decode pool (``index_copy_``; the reference's donated jit padded to
     a power-of-two bucket exists for XLA's jit cache and has no
     counterpart here), ``restamp`` the landing blocks with the SOURCE
     version (the weights that actually wrote the KV — what keeps radix
     reuse correct across weight pushes), and hand ownership to the
     decode engine's prefix cache via ``insert``.

``migrate`` wraps the two halves in the robustness contract: a
deterministic ``xfer`` fault point (``repro_torch.faults``; ``=x``
parameterized means a transfer that STALLS the install half for ``x``
seconds rather than dying outright), a per-attempt wall-clock timeout
bounding the WHOLE attempt — checked after extract AND after install, so
a wedged destination trips it too — bounded retries with exponential
backoff, and a typed ``MigrationFailed`` when the budget is exhausted,
which the disagg router (``repro_torch.serving.disagg``) answers by
falling back to colocated prefill: a dead transfer path degrades
throughput, never correctness.

Refcount contract: extract is net-zero on the source pool (match
retains, extract releases); install either completes the ownership
transfer into the destination tree or releases every landing block — no
interleaving of faults, retries, and evictions can leak a block or free
one twice in either pool.

Threading: the channel is policy-free about threads — ``run_src`` /
``run_dst`` inject how to reach each engine's owning thread
(``AsyncFrontend.call`` in the live server; direct invocation in
synchronous tests).  The migrate() caller (the router thread) never
touches engine state directly.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Set

import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serving.errors import MigrationFailed
from repro_torch.serving.paged import CacheFull
from repro_torch.serving.spill import (BYTES_BUCKETS, gather_rows,
                                       pool_leaves, scatter_rows)


@dataclasses.dataclass
class MigrationPayload:
    """A self-contained host-staged KV prefix: ``tokens`` (the matched
    prefix), one host tensor per pool leaf shaped ``(L, n_blocks,
    block_size, *feat)`` (pinned when it came from the card), the weight
    version that wrote the KV, and the event that marks the end of the
    copy out (None on the CPU; synchronise it before the host reads the
    tensors)."""
    tokens: List[int]
    leaves: List[torch.Tensor]
    version: int
    n_blocks: int
    nbytes: int
    ready: Optional[torch.cuda.Event] = None


class MigrationChannel:
    """Block-table + pool-slice migration from ``src`` into ``dst``.

    Both engines must share ``block_size`` and pool structure (same
    model config); pool CAPACITY may differ — block ids are translated
    through the landing allocation, never assumed equal."""

    def __init__(self, src, dst, *,
                 timeout_s: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 faults=None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 run_src: Optional[Callable] = None,
                 run_dst: Optional[Callable] = None):
        from repro_torch.flags import (migrate_backoff_s, migrate_retries,
                                       migrate_timeout_s)
        if src.prefix is None or dst.prefix is None:
            raise ValueError(
                "migration needs prefix_cache=True on BOTH engines (the "
                "radix tree is both the source of truth for what KV "
                "exists and the owner of migrated blocks; hybrid "
                "recurrent state cannot migrate as blocks)")
        if src.block_size != dst.block_size:
            raise ValueError(f"block_size mismatch: src {src.block_size} "
                             f"!= dst {dst.block_size}")
        src_leaves = pool_leaves(src.pool)
        dst_leaves = pool_leaves(dst.pool)
        if len(src_leaves) != len(dst_leaves) or any(
                a.shape[1:] != b.shape[1:] or a.dtype != b.dtype
                or a.shape[0] // (src.kv.num_blocks + 1)
                != b.shape[0] // (dst.kv.num_blocks + 1)
                for a, b in zip(src_leaves, dst_leaves)):
            raise ValueError("pool structure mismatch: src and dst must "
                             "be built from the same model config/dtype")
        self.src = src
        self.dst = dst
        self.timeout_s = migrate_timeout_s() if timeout_s is None \
            else timeout_s
        self.max_retries = migrate_retries() if max_retries is None \
            else max_retries
        self.backoff_s = migrate_backoff_s() if backoff_s is None \
            else backoff_s
        self.faults = faults
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._run_src = run_src if run_src is not None else (lambda fn: fn())
        self._run_dst = run_dst if run_dst is not None else (lambda fn: fn())
        # recent landing block ids (per successful install), so the
        # benchmark can prove migrated blocks are the ones radix-reused
        self._recent: collections.deque = collections.deque(maxlen=256)

    # ------------------------------------------------------------- extract
    def extract(self, tokens: Sequence[int]) -> MigrationPayload:
        """Stage the longest cached prefix of ``tokens`` to host memory.

        MUST run on the thread that owns ``src`` (its serve thread).
        Net-zero on the source pool: ``match`` retains, we release after
        the host copy — the payload outlives any source-side event."""
        src = self.src
        m, blocks = src.prefix.match(tokens)
        if m == 0:
            raise MigrationFailed(
                f"source has no cached prefix for a {len(tokens)}-token "
                f"prompt (evicted or never prefilled)")
        try:
            version = src.kv.version
            leaves, ready = gather_rows(src.pool, src.kv.num_blocks + 1,
                                        blocks)
        finally:
            src.kv.release(blocks)
        return MigrationPayload(
            tokens=[int(t) for t in tokens[:m]], leaves=leaves,
            version=version, n_blocks=len(blocks),
            nbytes=sum(a.numel() * a.element_size() for a in leaves),
            ready=ready)

    # ------------------------------------------------------------- install
    def install(self, payload: MigrationPayload) -> List[int]:
        """Land a payload in ``dst``'s pool and hand ownership to its
        prefix cache.  MUST run on the thread that owns ``dst``.

        Returns the landing block ids (owned by the tree, NOT by the
        caller).  Raises ``MigrationFailed`` on version skew and wraps
        pool pressure (``CacheFull`` after eviction) the same way."""
        dst = self.dst
        if payload.version != dst.kv.version:
            # skewed tiers: KV written under other weights would either
            # violate restamp monotonicity (source ahead) or be dead
            # weight the tree refuses to match (source behind)
            raise MigrationFailed(
                f"version skew: payload v{payload.version} vs decode "
                f"pool v{dst.kv.version} (a weight push landed on one "
                f"tier only); re-extract after the tiers converge")
        n = payload.n_blocks
        try:
            blocks = dst.kv.alloc(n)
        except CacheFull as e:
            raise MigrationFailed(
                f"decode pool cannot land {n} migrated blocks: {e}") from e
        installed = False
        try:
            scatter_rows(dst.pool, dst.kv.num_blocks + 1, blocks,
                         [payload.leaves], [payload.ready])
            dst.kv.restamp(blocks, payload.version)
            installed = True
            # ownership transfer: the tree adopts our references (and
            # releases duplicates it already holds fresh copies of)
            dst.prefix.insert(payload.tokens, blocks)
        except Exception:
            if not installed:
                dst.kv.release(blocks)
            raise
        self._recent.append(list(blocks))
        return blocks

    # ------------------------------------------------------------- migrate
    def migrate(self, tokens: Sequence[int]) -> List[int]:
        """Extract + install with the full robustness contract: ``xfer``
        fault injection, a WHOLE-attempt timeout (extract + install —
        a destination install that wedges trips it, not just a slow
        extract), bounded retries with exponential backoff.  Returns
        the landing block ids; raises ``MigrationFailed`` once the
        retry budget is spent."""
        reg, tr = self.registry, self.tracer
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                reg.inc("disagg.migration_retries")
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            t0 = time.perf_counter()
            tr.begin("xfer", attempt=attempt, tokens=len(tokens))
            try:
                stall = 0.0
                if self.faults is not None and self.faults.enabled \
                        and self.faults.fires("xfer"):
                    stall = self.faults.param("xfer", 0.0)
                    if stall <= 0:
                        raise MigrationFailed(
                            f"injected xfer fault "
                            f"(call {self.faults.calls['xfer'] - 1})")
                    # =x parameterized: a STALLED destination transfer,
                    # not a dead one — the install half wedges for x
                    # seconds and must be failed by the whole-attempt
                    # timeout check below, never by an eager raise here
                payload = self._run_src(lambda: self.extract(tokens))
                if time.perf_counter() - t0 > self.timeout_s:
                    # nothing installed yet: the attempt is cleanly
                    # abandonable — source refs were already released
                    raise MigrationFailed(
                        f"migration attempt {attempt} exceeded "
                        f"{self.timeout_s}s before install")

                def _install():
                    if stall > 0:
                        time.sleep(stall)
                    return self.install(payload)

                blocks = self._run_dst(_install)
                if time.perf_counter() - t0 > self.timeout_s:
                    # the attempt wedged INSIDE install.  The install
                    # itself landed, so nothing leaks — the destination
                    # tree owns the blocks and a retry dedupes through
                    # insert() — but the ATTEMPT is declared failed:
                    # callers sized their latency budget to timeout_s,
                    # and an attempt that blew it must consume a retry
                    # exactly like one that died before install.
                    raise MigrationFailed(
                        f"migration attempt {attempt} exceeded "
                        f"{self.timeout_s}s (stalled install)")
            except Exception as e:      # noqa: BLE001 - retried, typed below
                last = e
                tr.end("xfer", error=repr(e))
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            tr.end("xfer", blocks=len(blocks), bytes=payload.nbytes)
            reg.inc("disagg.migrations")
            reg.inc("disagg.migrated_blocks", len(blocks))
            reg.inc("disagg.migrated_tokens", len(payload.tokens))
            reg.observe("disagg.migrate_ms", dt_ms)
            reg.observe("disagg.migrate_bytes", float(payload.nbytes),
                        boundaries=BYTES_BUCKETS)
            return blocks
        reg.inc("disagg.migration_failures")
        if isinstance(last, MigrationFailed):
            raise MigrationFailed(
                f"migration failed after {self.max_retries + 1} attempts: "
                f"{last}") from last
        raise MigrationFailed(
            f"migration failed after {self.max_retries + 1} attempts "
            f"(last: {last!r})") from last

    def recent_migrated_blocks(self) -> Set[int]:
        """Union of landing block ids over recent successful installs
        (bounded window) — the measurement hook for 'migrated blocks are
        the ones the decode tier radix-reuses'."""
        return {b for blocks in self._recent for b in blocks}
