"""Heartbeat-driven rollout fault tolerance (GLM-5 §3.6.3).

Port of ``repro.async_rl.heartbeat`` (pure host code).

Rollout servers emit heartbeats; the monitor terminates + deregisters
servers whose heartbeat lapses, so retries route only to healthy servers —
a single-server incident never stalls end-to-end RL.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 2.0,
                 on_evict: Optional[Callable[[str], None]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 faults=None):
        self.timeout_s = timeout_s
        # deterministic fault injection (repro_torch.faults): the "beat"
        # point DROPS heartbeats, so an injected storm makes a healthy
        # server lapse — exercising the real eviction path end to end
        self.faults = faults
        self._last: Dict[str, float] = {}
        self._healthy: Dict[str, bool] = {}
        self._lock = threading.Lock()
        self._on_evict = on_evict
        self.evictions: List[str] = []
        # beat-age histogram + eviction counter + healthy gauge land in
        # the orchestrator's shared registry: a lapsing server shows up
        # as a fat beat-age tail BEFORE it crosses timeout_s
        self.registry = registry if registry is not None else MetricsRegistry()
        self.registry.set_gauge("heartbeat.healthy_servers", 0)

    def _sync_gauge_locked(self) -> None:
        self.registry.set_gauge(
            "heartbeat.healthy_servers",
            sum(1 for ok in self._healthy.values() if ok))

    def register(self, server_id: str):
        with self._lock:
            self._last[server_id] = time.monotonic()
            self._healthy[server_id] = True
            self._sync_gauge_locked()

    def deregister(self, server_id: str):
        """Drop a server from the table entirely — clean shutdown, or a
        crash the worker reports about ITSELF on the way out.  Unlike an
        eviction (a lapse the monitor discovered) a deregistered server
        simply stops existing: it is not counted healthy, never shows up
        in ``evictions``, and a later sweep won't flag it as a lapse it
        already told us about."""
        with self._lock:
            self._last.pop(server_id, None)
            self._healthy.pop(server_id, None)
            self._sync_gauge_locked()

    def beat(self, server_id: str):
        if self.faults is not None and self.faults.enabled \
                and self.faults.fires("beat"):
            return                       # injected: the heartbeat is lost
        with self._lock:
            if self._healthy.get(server_id):
                self._last[server_id] = time.monotonic()

    def sweep(self) -> List[str]:
        """Evict servers whose heartbeat lapsed; returns evicted ids."""
        now = time.monotonic()
        evicted = []
        with self._lock:
            for sid, ok in list(self._healthy.items()):
                if not ok:
                    continue
                age = now - self._last[sid]
                self.registry.observe("heartbeat.beat_age_ms", age * 1e3)
                if age > self.timeout_s:
                    self._healthy[sid] = False
                    evicted.append(sid)
            if evicted:
                self._sync_gauge_locked()
        for sid in evicted:
            self.evictions.append(sid)
            self.registry.inc("heartbeat.evictions")
            if self._on_evict:
                self._on_evict(sid)
        return evicted

    def healthy_servers(self) -> List[str]:
        with self._lock:
            return [s for s, ok in self._healthy.items() if ok]

    def is_healthy(self, server_id: str) -> bool:
        with self._lock:
            return self._healthy.get(server_id, False)
