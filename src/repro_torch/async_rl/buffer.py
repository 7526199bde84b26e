"""Trajectory buffer with staleness filtering and group assembly.

Port of ``repro.async_rl.buffer`` (host code, copied as it is).

Implements the §4.1.2 data-hygiene rules between rollout and trainer:
 * staleness drop: discard samples whose oldest rollout weight version lags
   the current trainer version by more than τ;
 * env-failure handling per GRPO group: pad with repeated valid samples if
   more than half the group is valid, drop the whole group otherwise.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.async_rl.tito import Trajectory


class TrajectoryBuffer:
    def __init__(self, group_size: int, staleness_tau: int = 4,
                 max_ready: int = 32):
        self.group_size = group_size
        self.tau = staleness_tau
        self.max_ready = max_ready
        self._groups: Dict[str, List[Trajectory]] = defaultdict(list)
        self._ready: List[List[Trajectory]] = []
        self._lock = threading.Lock()
        self.stats = {"received": 0, "stale_dropped": 0,
                      "env_failures": 0, "groups_dropped": 0,
                      "groups_padded": 0, "groups_ready": 0,
                      "stale_groups_popped": 0}

    def add(self, group_key: str, traj: Trajectory, current_version: int):
        with self._lock:
            self.stats["received"] += 1
            if current_version - traj.version_min > self.tau:
                self.stats["stale_dropped"] += 1
                return
            self._groups[group_key].append(traj)
            if len(self._groups[group_key]) >= self.group_size:
                self._finalize(group_key)

    def _finalize(self, key: str):
        group = self._groups.pop(key)
        valid = [t for t in group if not t.env_failure]
        n_fail = len(group) - len(valid)
        self.stats["env_failures"] += n_fail
        if len(valid) <= self.group_size // 2:
            self.stats["groups_dropped"] += 1
            return
        if len(valid) < self.group_size:          # pad by repeating valid
            self.stats["groups_padded"] += 1
            i = 0
            while len(valid) < self.group_size:
                valid.append(valid[i % len(valid)])
                i += 1
        self._ready.append(valid)
        self.stats["groups_ready"] += 1

    def pop_groups(self, n: int, current_version: int = None
                   ) -> List[List[Trajectory]]:
        """Pop up to n groups; re-checks staleness at POP time (groups can
        age in the queue while the trainer races ahead — §4.1.2)."""
        with self._lock:
            out = []
            keep = []
            for g in self._ready:
                if current_version is not None and any(
                        current_version - t.version_min > self.tau
                        for t in g):
                    self.stats["stale_groups_popped"] += 1
                    continue
                if len(out) < n:
                    out.append(g)
                else:
                    keep.append(g)
            self._ready = keep
            return out

    def has_capacity(self) -> bool:
        with self._lock:
            return len(self._ready) < self.max_ready

    def n_ready(self) -> int:
        with self._lock:
            return len(self._ready)
