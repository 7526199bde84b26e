"""Asynchronous RL infrastructure (port of ``repro.async_rl``).  Only the
heartbeat monitor is ported so far: the disaggregated server probes its
tiers with it.  Rollout, trainer, orchestrator, buffer, TITO and the DP
router come with the RL layers."""
from repro_torch.async_rl.heartbeat import HeartbeatMonitor  # noqa: F401
