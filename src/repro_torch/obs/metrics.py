"""Process-local metrics registry: counters, gauges, bucket histograms.

The serving and async-RL layers are judged by latency/throughput SLOs —
TTFT/TPOT percentiles, rollout staleness, tail behavior under weight
pushes (GLM-5 §3.6 / §4.1) — but until this module the live engine could
only expose ad-hoc ``stats`` dicts and the percentiles lived exclusively
in the analytic ``pd_sim`` simulator.  ``MetricsRegistry`` is the one
place every layer reports to:

* **Counters** — monotone event counts (``inc``).  The scattered stats
  dicts in ``scheduler.py`` / ``prefix_cache.py`` / ``paged.py`` are now
  ``StatsView``s over registry counters, so nothing is counted twice and
  every historical ``eng.stats["decode_steps"]`` read keeps working.
* **Gauges** — last-write-wins instantaneous values (``set_gauge``), e.g.
  pool occupancy.
* **Histograms** — fixed-bucket distribution sketches (``observe``):
  p50/p95/p99 by linear interpolation inside the owning bucket, without
  ever storing samples — O(len(buckets)) memory no matter how many
  requests flow through.  This is how live TTFT/TPOT percentiles are
  derived (``ContinuousEngine`` observes per-request latencies; the
  benchmarks read ``registry.summary("engine.ttft_ms")``).

``snapshot()`` freezes everything into plain nested dicts (JSON-ready —
``benchmarks/run.py --json`` embeds one per suite); ``delta(prev)``
subtracts a previous snapshot's counters so a benchmark can isolate its
timed region without resetting shared state.

Thread safety: one lock around every mutation — the registry is shared
by the ``AsyncFrontend`` serve thread, client submit threads, and rollout
workers.  All operations are host-side dict updates, orders of magnitude
cheaper than the engine steps they instrument.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Iterator, List, Mapping, Optional

# Log-spaced default buckets for millisecond latencies: 50µs .. 60s.
# Percentile resolution is the bucket width, so the spacing tracks the
# "each bucket ~2-2.5x the last" rule production histogram systems use.
DEFAULT_TIME_BUCKETS_MS: List[float] = [
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0,
    30000.0, 60000.0,
]


class Histogram:
    """Fixed-bucket histogram: percentiles without storing samples.

    ``boundaries`` are upper edges of the first ``len(boundaries)``
    buckets; one overflow bucket catches everything beyond.  Exact
    ``min``/``max``/``sum``/``count`` ride along, and clamp the
    interpolation so p0/p100 are exact and the overflow bucket never
    extrapolates past an observed value.
    """

    __slots__ = ("boundaries", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, boundaries: Optional[Iterable[float]] = None):
        bs = sorted(float(b) for b in (
            boundaries if boundaries is not None else DEFAULT_TIME_BUCKETS_MS))
        if not bs:
            raise ValueError("histogram needs at least one bucket boundary")
        self.boundaries = bs
        self.counts = [0] * (len(bs) + 1)        # +1: overflow bucket
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (0 <= q <= 100).

        Walks the cumulative bucket counts to the bucket owning the
        target rank, then linearly interpolates inside it — error is
        bounded by that bucket's width.  Exact observed min/max clamp
        both ends (the overflow bucket interpolates toward ``vmax``
        instead of infinity)."""
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile out of range: {q}")
        target = q / 100.0 * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.boundaries[i - 1] if i > 0 else self.vmin
            hi = self.boundaries[i] if i < len(self.boundaries) else self.vmax
            lo = max(lo, self.vmin)
            hi = min(hi, self.vmax)
            if target <= cum + c:
                frac = (target - cum) / c
                return float(lo + (hi - lo) * max(0.0, min(1.0, frac)))
            cum += c
        return float(self.vmax)

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Names -> counters / gauges / histograms, with snapshot & delta."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- counters
    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_counter(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name] = value

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # --------------------------------------------------------------- gauges
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    # ----------------------------------------------------------- histograms
    def histogram(self, name: str,
                  boundaries: Optional[Iterable[float]] = None) -> Histogram:
        """Get-or-create; ``boundaries`` only applies on creation."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(boundaries)
            return h

    def observe(self, name: str, value: float,
                boundaries: Optional[Iterable[float]] = None) -> None:
        h = self.histogram(name, boundaries)
        with self._lock:
            h.observe(value)

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
            return h.percentile(q) if h is not None else 0.0

    def summary(self, name: str) -> Dict[str, float]:
        with self._lock:
            h = self._hists.get(name)
            return h.summary() if h is not None else Histogram([1]).summary()

    def reset_histograms(self, prefix: Optional[str] = None) -> None:
        """Re-zero histograms (all, or those under ``prefix.``), keeping
        their bucket boundaries.  Benchmarks call this after a warm-up
        pass so compile-time latencies don't pollute the timed region's
        percentiles (counters reset separately via ``StatsView.reset``)."""
        with self._lock:
            for name, h in list(self._hists.items()):
                if (prefix is None or name == prefix
                        or name.startswith(prefix + ".")):
                    self._hists[name] = Histogram(h.boundaries)

    # ------------------------------------------------------ snapshot / delta
    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict freeze of every metric (JSON-serializable)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary() for k, h in self._hists.items()},
            }

    def delta(self, prev: Mapping[str, dict]) -> Dict[str, dict]:
        """Counters since ``prev`` (an earlier ``snapshot()``); gauges and
        histogram summaries are reported as-of-now (distribution sketches
        cannot be subtracted; benchmarks wanting clean histograms use a
        fresh registry or fresh metric names)."""
        cur = self.snapshot()
        pc = prev.get("counters", {})
        cur["counters"] = {k: v - pc.get(k, 0)
                           for k, v in cur["counters"].items()}
        return cur


class StatsView(Mapping):
    """A stats-dict façade over registry counters.

    The pre-obs engine exposed ``self.stats = {"decode_steps": 0, ...}``
    and tests/benchmarks read and reset it freely.  ``StatsView`` keeps
    that exact surface — ``stats[k]``, ``stats[k] += 1``, ``dict(stats)``,
    iteration — while every scalar lives in the shared registry under
    ``<prefix>.<key>``, so the same numbers show up in ``snapshot()``,
    benchmark JSON, and the stats dict with no double accounting.

    Non-scalar entries (``admit_steps``'s bounded deque) are held locally
    and passed through untouched.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Iterable[str], local: Optional[Dict] = None):
        self._registry = registry
        self._prefix = prefix
        self._local = dict(local or {})
        self._keys = [k for k in keys if k not in self._local]
        for k in self._keys:                    # materialize zeros eagerly:
            registry.inc(self._name(k), 0)      # dict(view) shows every key

    def _name(self, key: str) -> str:
        return f"{self._prefix}.{key}"

    # ------------------------------------------------------- mapping surface
    def __getitem__(self, key: str):
        if key in self._local:
            return self._local[key]
        if key not in self._keys:
            raise KeyError(key)
        return self._registry.counter(self._name(key))

    def __setitem__(self, key: str, value) -> None:
        if key in self._local:
            self._local[key] = value
            return
        if key not in self._keys:
            self._keys.append(key)
        self._registry.set_counter(self._name(key), value)

    def __iter__(self) -> Iterator[str]:
        yield from self._keys
        yield from self._local

    def __len__(self) -> int:
        return len(self._keys) + len(self._local)

    def __contains__(self, key) -> bool:
        return key in self._local or key in self._keys

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"StatsView({dict(self)!r})"

    def reset(self, values: Optional[Mapping] = None) -> None:
        """Zero every scalar (or load ``values``); clear local deques.

        Supports the benchmark idiom ``eng.stats = {k: 0 ...}`` via the
        owner's property setter."""
        values = values or {}
        for k in self._keys:
            v = values.get(k, 0)
            self._registry.set_counter(self._name(k), int(v))
        for k, cur in self._local.items():
            if hasattr(cur, "clear"):
                cur.clear()
                v = values.get(k)
                if v is not None and hasattr(v, "__iter__") \
                        and hasattr(cur, "extend"):
                    cur.extend(v)
            elif k in values:
                self._local[k] = values[k]
