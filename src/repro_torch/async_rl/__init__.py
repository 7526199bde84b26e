"""Asynchronous RL infrastructure (port of ``repro.async_rl``): rollout
engines over the serving front-end or the loop backend, the TITO gateway,
the staleness-filtered trajectory buffer, the DP-aware router, the
heartbeat monitor, the multi-task orchestrator and the IS trainer."""
from repro_torch.async_rl.buffer import TrajectoryBuffer  # noqa: F401
from repro_torch.async_rl.heartbeat import HeartbeatMonitor  # noqa: F401
from repro_torch.async_rl.orchestrator import (Orchestrator,  # noqa: F401
                                               TaskService)
from repro_torch.async_rl.rollout import RolloutEngine  # noqa: F401
from repro_torch.async_rl.router import (DPRouter,  # noqa: F401
                                         RoundRobinRouter)
from repro_torch.async_rl.tito import (TitoGateway, ToyTokenizer,  # noqa: F401
                                       Trajectory)
from repro_torch.async_rl.trainer import AsyncTrainer  # noqa: F401
