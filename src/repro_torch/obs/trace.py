"""Per-request / per-step tracing, exportable as Chrome trace-event JSON.

The continuous engine's behavior under mixed agentic traffic — chunked
prefills interleaving with decode, speculative rounds, weight-push drain
barriers — is fundamentally a *timeline* artifact; counters alone cannot
show why one request's TTFT blew past the SLO.  ``Tracer`` records:

* **engine-step spans** (``B``/``E`` pairs): one per ``step()``, with
  batch occupancy, waiting-queue depth, live tokens, and pool utilization
  attached as args;
* **request lifecycle instants**: ``req.submit`` -> ``req.admitted``
  (cached tokens + block count attached) -> ``req.prefill`` per chunk ->
  ``req.first_token`` -> ``req.spec_round`` per speculative verification
  -> ``req.finished`` (``out_version`` attached);
* **engine events**: ``jit.compile`` whenever an engine jit actually
  traces (the recompile hazard, now first-class), ``push.requested`` /
  ``push.applied`` with the drain duration.

The export (``Tracer.export``) is the Chrome trace-event format —
``{"traceEvents": [...]}`` with microsecond ``ts`` — directly loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

**Gating**: tracing defaults off and is enabled per engine
(``ContinuousEngine(tracer=Tracer(enabled=True))``) or process-wide via
``REPRO_TRACE=1`` (``repro_torch.flags.trace_enabled``).  Disabled, every hook
is one attribute check — no buffer growth, no timestamps taken, no
behavior change (the oracle parity suites run byte-identical either way).

``validate_chrome_trace`` is the schema checker CI runs against an
exported trace: required keys, non-decreasing ``ts``, strictly matched
``B``/``E`` stacks per thread, and a complete lifecycle for every
finished request.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional


class Tracer:
    """Bounded in-memory trace-event buffer (thread-safe appends)."""

    def __init__(self, enabled: bool = False, limit: Optional[int] = None):
        if limit is None:
            from repro_torch.flags import trace_buffer_limit
            limit = trace_buffer_limit()
        self.enabled = enabled
        self.limit = limit
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._tids: Dict[int, int] = {}          # thread ident -> small tid

    # -------------------------------------------------------------- plumbing
    def now_us(self) -> float:
        """Microseconds since tracer epoch (also the TTFT clock base)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.limit:
                self.dropped += 1
                return
            self._events.append(ev)

    # ------------------------------------------------------------ recording
    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "i", "s": "t",
                    "ts": self.now_us(), "pid": 0, "tid": self._tid(),
                    "args": args})

    def begin(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "B", "ts": self.now_us(),
                    "pid": 0, "tid": self._tid(), "args": args})

    def end(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "E", "ts": self.now_us(),
                    "pid": 0, "tid": self._tid(), "args": args})

    # -------------------------------------------------------------- reading
    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0

    def export(self, path: Optional[str] = None) -> dict:
        """Freeze the buffer into a Chrome trace object; optionally write
        it to ``path``.  Events are sorted by ``ts`` (appends from client
        threads can interleave slightly out of order)."""
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
        obj = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(obj, f)
        return obj


# --------------------------------------------------------------- validation
_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")
_LIFECYCLE_PRELUDE = ("req.submit", "req.admitted", "req.first_token")


def validate_chrome_trace(obj: dict) -> List[str]:
    """Schema-check an exported trace; returns a list of problems
    (empty == valid).  Checks:

    * top level is ``{"traceEvents": [...]}``;
    * every event carries name/ph/ts/pid/tid, numeric non-negative ts;
    * ``ts`` is non-decreasing across the file (export sorts);
    * ``B``/``E`` spans match as a stack per (pid, tid), names agreeing;
    * every ``req.finished`` request id also has ``req.submit``,
      ``req.admitted`` and ``req.first_token`` events (the full
      lifecycle of a served request).
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["top level must be a dict with a 'traceEvents' list"]
    events = obj["traceEvents"]
    last_ts = float("-inf")
    stacks: Dict[tuple, List[str]] = {}
    seen: Dict[str, set] = {}                    # event name -> {req ids}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED_KEYS if k not in ev]
        if missing:
            problems.append(f"event {i}: missing keys {missing}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ts < last_ts:
            problems.append(f"event {i}: ts {ts} < previous {last_ts}")
        last_ts = ts
        ph = ev["ph"]
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(f"event {i}: E '{ev['name']}' with no "
                                f"open span on {key}")
            elif stack[-1] != ev["name"]:
                problems.append(f"event {i}: E '{ev['name']}' closes "
                                f"'{stack[-1]}' on {key}")
                stack.pop()
            else:
                stack.pop()
        elif ph not in ("i", "I", "X", "C", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
        rid = (ev.get("args") or {}).get("req")
        if rid is not None:
            seen.setdefault(ev["name"], set()).add(rid)
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed spans on {key}: {stack}")
    for rid in sorted(seen.get("req.finished", set())):
        for name in _LIFECYCLE_PRELUDE:
            if rid not in seen.get(name, set()):
                problems.append(f"request {rid}: finished without a "
                                f"'{name}' event")
    return problems


def validate_trace_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load {path}: {e}"]
    return validate_chrome_trace(obj)
