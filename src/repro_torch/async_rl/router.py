"""DP-aware routing (GLM-5 §4.1.2).

Port of ``repro.async_rl.router`` (host code, copied as it is).

Multi-turn agent rollouts share prefixes turn-over-turn; KV reuse requires
every request of a rollout to land on the SAME data-parallel rank.  A
stateful consistent-hash ring maps rollout-id -> DP rank, stable across
turns, plus lightweight dynamic rebalancing of the hash space when ranks
diverge in load.  Tracks simulated KV-prefix reuse so the benchmark can
compare against round-robin routing.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from collections import defaultdict
from typing import Dict, List, Optional


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class DPRouter:
    def __init__(self, n_ranks: int, vnodes: int = 64,
                 rebalance_threshold: float = 1.5):
        self.n_ranks = n_ranks
        self.vnodes = vnodes
        self.rebalance_threshold = rebalance_threshold
        self._ring: List[tuple] = []            # (hash, rank)
        self._lock = threading.Lock()
        self.load: Dict[int, int] = defaultdict(int)       # open rollouts
        self._pinned: Dict[str, int] = {}
        self._kv: Dict[int, Dict[str, int]] = defaultdict(dict)
        self._dead: set = set()                 # ranks dropped from ring
        self.stats = {"hits": 0, "misses": 0, "reused_tokens": 0,
                      "prefill_tokens": 0, "rebalances": 0,
                      "dropped_ranks": 0, "restored_ranks": 0,
                      "repinned_rollouts": 0}
        for r in range(n_ranks):
            for v in range(vnodes):
                self._ring.append((_hash(f"rank{r}:v{v}"), r))
        self._ring.sort()

    def _ring_lookup(self, key: str) -> int:
        if not self._ring:
            raise RuntimeError("DPRouter: no healthy ranks in the ring "
                               f"(all {self.n_ranks} dropped)")
        h = _hash(key)
        i = bisect.bisect(self._ring, (h,)) % len(self._ring)
        return self._ring[i][1]

    # --------------------------------------------------------- rank health
    def drop_rank(self, rank: int) -> None:
        """Remove a crashed rank's vnodes from the ring: its keyspace
        reroutes to the surviving ranks IMMEDIATELY (before this fix a
        dead rank kept receiving its keyspace forever).  Rollouts pinned
        to it are unpinned — their next ``route`` lands on a healthy
        rank — and its simulated KV is gone with the process, so the
        cache table and load count are cleared.  Idempotent; wired to
        the disagg router's health signal via
        ``repro_torch.serving.disagg.bind_dp_router``."""
        with self._lock:
            if rank in self._dead:
                return
            self._dead.add(rank)
            self._ring = [(h, r) for h, r in self._ring if r != rank]
            orphans = [rid for rid, r in self._pinned.items() if r == rank]
            for rid in orphans:
                del self._pinned[rid]
            self.stats["repinned_rollouts"] += len(orphans)
            self._kv.pop(rank, None)
            self.load[rank] = 0
            self.stats["dropped_ranks"] += 1

    def restore_rank(self, rank: int) -> None:
        """Re-add a recovered rank's vnodes (the fail-back half of the
        health signal).  Existing pins stay put — only NEW rollouts hash
        onto the restored keyspace; the rank starts with a cold KV
        table, which the hit/miss stats then reflect honestly."""
        with self._lock:
            if rank not in self._dead:
                return
            self._dead.discard(rank)
            for v in range(self.vnodes):
                bisect.insort(self._ring, (_hash(f"rank{rank}:v{v}"), rank))
            self.stats["restored_ranks"] += 1

    def healthy_ranks(self) -> List[int]:
        with self._lock:
            return [r for r in range(self.n_ranks) if r not in self._dead]

    def route(self, rollout_id: str) -> int:
        """Stable rank for a rollout (consistent hash + pin)."""
        with self._lock:
            if rollout_id in self._pinned:
                return self._pinned[rollout_id]
            rank = self._ring_lookup(rollout_id)
            # dynamic rebalance: if target rank is overloaded vs mean,
            # remap NEW rollouts to the least-loaded rank (pinning keeps
            # existing rollouts put — no KV migration).  Dead ranks are
            # never rebalance targets.
            alive = [r for r in range(self.n_ranks) if r not in self._dead]
            mean = max(1.0, sum(self.load[r] for r in alive) / len(alive))
            if self.load[rank] > self.rebalance_threshold * mean:
                rank = min(alive, key=lambda r: self.load[r])
                self.stats["rebalances"] += 1
            self._pinned[rollout_id] = rank
            self.load[rank] += 1
            return rank

    def request(self, rollout_id: str, context_len: int) -> int:
        """Serve one turn: returns incremental prefill tokens after KV reuse."""
        rank = self.route(rollout_id)
        with self._lock:
            cached = self._kv[rank].get(rollout_id, 0)
            if cached and cached <= context_len:
                self.stats["hits"] += 1
                inc = context_len - cached
                self.stats["reused_tokens"] += cached
            else:
                self.stats["misses"] += 1
                inc = context_len
            self._kv[rank][rollout_id] = context_len
            self.stats["prefill_tokens"] += inc
        return inc

    def finish(self, rollout_id: str):
        with self._lock:
            rank = self._pinned.pop(rollout_id, None)
            if rank is not None:
                self.load[rank] -= 1
                self._kv[rank].pop(rollout_id, None)


class RoundRobinRouter(DPRouter):
    """Baseline: no affinity — each request may land anywhere (KV misses)."""

    def __init__(self, n_ranks: int):
        super().__init__(n_ranks)
        self._i = 0

    def route(self, rollout_id: str) -> int:
        with self._lock:
            self._i = (self._i + 1) % self.n_ranks
            return self._i

    def request(self, rollout_id: str, context_len: int) -> int:
        rank = self.route(rollout_id)
        with self._lock:
            cached = self._kv[rank].get(rollout_id, 0)
            if cached and cached <= context_len:
                self.stats["hits"] += 1
                inc = context_len - cached
                self.stats["reused_tokens"] += cached
            else:
                self.stats["misses"] += 1
                inc = context_len
            self._kv[rank][rollout_id] = context_len
            self.stats["prefill_tokens"] += inc
        return inc
