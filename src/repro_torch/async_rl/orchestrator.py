"""Multi-Task Rollout Orchestrator (GLM-5 §4.1.1).

Port of ``repro.async_rl.orchestrator`` (host code: the rollout engines
it drives run the kernels).  A worker's sampling stream is seeded with
``hash(sid) % 2**31``, as in the reference: it follows
``PYTHONHASHSEED``, so two processes' runs differ.

Central component between the slime-style trainer and heterogeneous task
services.  Each TASK registers rollout + reward logic as an independent
service; the orchestrator controls per-task sampling ratios, drives worker
threads against the rollout engines (with heartbeats + DP-aware routing),
standardizes everything into the unified Trajectory representation, and
feeds the staleness-filtered group buffer the trainer consumes.

Fully asynchronous: rollout workers never block on the trainer; the trainer
trains whenever enough groups are ready (§4.1.1 threshold).
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.async_rl.buffer import TrajectoryBuffer
from repro_torch.async_rl.heartbeat import HeartbeatMonitor
from repro_torch.async_rl.rollout import RolloutEngine
from repro_torch.async_rl.router import DPRouter
from repro_torch.async_rl.tito import TitoGateway, Trajectory


@dataclasses.dataclass
class TaskService:
    """One registered task microservice: problem sampler + reward fn."""
    name: str
    sample_problem: Callable[[np.random.Generator], dict]
    # (problem, generated tokens) -> (reward, env_failure)
    reward: Callable[[dict, np.ndarray], tuple]
    max_new: int = 16
    ratio: float = 1.0


class Orchestrator:
    def __init__(self, engines: List[RolloutEngine], *, group_size: int = 4,
                 staleness_tau: int = 4, seed: int = 0,
                 env_failure_rate: float = 0.0, backend: str = "loop",
                 serving_kw: Optional[dict] = None, faults=None):
        if backend not in ("loop", "serving"):
            raise ValueError(f"backend must be 'loop' or 'serving', "
                             f"got {backend!r}")
        self.engines = engines
        # unify the TITO gateway across engines: rollouts may be routed to
        # any engine and fragments must land in one place
        self.gateway = engines[0].gateway
        for e in engines[1:]:
            e.gateway = self.gateway
        # ...and the metrics registry likewise: rollout durations, beat
        # ages, and group latencies from every engine/worker aggregate
        # into one snapshot (getattr: engine test doubles need not carry
        # one — the orchestrator then keeps its own)
        from repro_torch.obs.metrics import MetricsRegistry
        self.registry = getattr(engines[0], "registry", None)
        if self.registry is None:
            self.registry = MetricsRegistry()
        for e in engines[1:]:
            e.registry = self.registry
        self.buffer = TrajectoryBuffer(group_size, staleness_tau)
        self.group_size = group_size
        self.router = DPRouter(n_ranks=len(engines))
        # deterministic fault injection (repro_torch.faults): "worker" crashes
        # a rollout worker mid-loop (the existing self-deregistration
        # path), "beat" drops heartbeats (threaded into the monitor)
        from repro_torch.faults import FaultInjector
        self.faults = FaultInjector.from_env() if faults is None else faults
        self.monitor = HeartbeatMonitor(timeout_s=5.0,
                                        registry=self.registry,
                                        faults=self.faults)
        self.tasks: Dict[str, TaskService] = {}
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._group_ids = itertools.count()
        self.env_failure_rate = env_failure_rate
        # 'loop' = per-token re-forward (RolloutEngine.generate);
        # 'serving' = the AsyncFrontend path (generate_async): workers
        # SHARE the engine's continuous decode batch + radix prefix
        # cache, so the G rollouts of a group prefill their common
        # prompt once and weight pushes land without a cache reset
        self.backend = backend
        self.serving_kw = dict(serving_kw or {})
        self.current_version = lambda: max(e.version for e in engines)
        self.completed = 0
        self.worker_errors: List[str] = []
        self._lock = threading.Lock()

    def register(self, task: TaskService):
        self.tasks[task.name] = task

    def _pick_task(self) -> TaskService:
        names = list(self.tasks)
        ratios = np.array([self.tasks[n].ratio for n in names], np.float64)
        ratios /= ratios.sum()
        return self.tasks[self._rng.choice(names, p=ratios)]

    def set_ratio(self, name: str, ratio: float):
        """Dynamic task-mix adjustment (paper: 'automated, dynamic
        adjustment of task sampling ratios')."""
        self.tasks[name].ratio = ratio

    def _rollout_group(self, worker_rng: np.random.Generator,
                       beat: Optional[Callable[[], None]] = None):
        """One GRPO group: G rollouts of the same problem.

        ``beat`` fires between rollouts — a group is ``group_size``
        generations back-to-back, easily longer than the heartbeat
        timeout, and a worker that only beats once per GROUP looks
        dead to the sweep while it is merely mid-group."""
        task = self._pick_task()
        problem = task.sample_problem(worker_rng)
        gkey = f"{task.name}-g{next(self._group_ids)}"
        t_group = time.perf_counter()
        for _ in range(self.group_size):
            if beat is not None:
                beat()
            rid = self.gateway.new_rollout(task.name)
            rank = self.router.route(rid)
            engine = self.engines[rank % len(self.engines)]
            self.router.request(rid, len(problem["prompt"]))
            if self.backend == "serving":
                gen = engine.generate_async(rid, problem["prompt"],
                                            task.max_new, **self.serving_kw)
            else:
                gen = engine.generate(rid, problem["prompt"], task.max_new)
            fail = bool(worker_rng.random() < self.env_failure_rate)
            reward, env_fail = (0.0, True) if fail else task.reward(problem,
                                                                    gen)
            traj = self.gateway.finish(rid, task.name, problem["prompt"],
                                       reward, env_failure=env_fail or fail)
            self.router.finish(rid)
            self.buffer.add(gkey, traj, self.current_version())
        # group wall time is the §4.1.1 straggler signal: one stuck
        # rollout inflates the p99 here long before throughput moves
        self.registry.observe("orchestrator.group_ms",
                              (time.perf_counter() - t_group) * 1e3)
        self.registry.inc("orchestrator.groups")
        with self._lock:
            self.completed += self.group_size

    def _worker(self, wid: int):
        sid = f"rollout-worker-{wid}"
        self.monitor.register(sid)
        rng = np.random.default_rng(hash(sid) % (2 ** 31))
        while not self._stop.is_set():
            self.monitor.beat(sid)
            if not self.buffer.has_capacity():   # backpressure: stay fresh
                time.sleep(0.005)
                continue
            try:
                if self.faults.enabled:
                    # injected worker crash: same exit as a real one —
                    # the error is recorded and the worker deregisters
                    # itself from the heartbeat table on the way out
                    self.faults.check("worker", rid=wid)
                self._rollout_group(rng, beat=lambda: self.monitor.beat(sid))
            except Exception as e:   # noqa: BLE001
                import traceback
                with self._lock:
                    self.worker_errors.append(
                        f"{sid}: {e}\n{traceback.format_exc()}")
                # take ourselves out of the heartbeat table NOW — a dead
                # worker left registered is a zombie the sweep only
                # discovers timeout_s later (and wait_for_groups would
                # spin its full timeout against zero live workers)
                self.monitor.deregister(sid)
                return

    def start(self, n_workers: int = 2):
        for w in range(n_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def wait_for_groups(self, n: int, timeout_s: float = 300) -> bool:
        """Block until ``n`` groups are ready.  Returns False on timeout;
        raises RuntimeError as soon as EVERY worker has crashed (no more
        groups are ever coming — spinning out the timeout just hides the
        tracebacks sitting in ``worker_errors``)."""
        t0 = time.monotonic()
        while self.buffer.n_ready() < n:
            if time.monotonic() - t0 > timeout_s:
                return False
            self.monitor.sweep()
            if self._threads and not any(t.is_alive() for t in self._threads):
                with self._lock:
                    errs = list(self.worker_errors)
                if errs:
                    raise RuntimeError(
                        f"all {len(self._threads)} rollout workers crashed "
                        f"before {n} groups were ready:\n" + "\n".join(errs))
                return self.buffer.n_ready() >= n
            time.sleep(0.01)
        return True
