"""Process-wide environment readers of the port.

A copy of the readers in the JAX package's ``repro.flags`` that the serving
layers use (the engine, the front-end, the host spill tier, migration and
the disaggregated server), under the same environment variable names and
defaults.  There is no reader
that chooses a kernel implementation: the tensor's device decides (see
``repro_torch.kernels.paged_attention.ops``).
"""
import os


def trace_enabled() -> bool:
    """Process-wide default for serving trace capture (``REPRO_TRACE``).

    ``1``/``true``/``yes`` turns every newly-constructed engine's
    ``Tracer`` on.  Off (the default) the tracer hooks are single attribute
    checks.  An explicit ``ContinuousEngine(tracer=...)`` always wins."""
    return os.environ.get("REPRO_TRACE", "0").lower() in ("1", "true", "yes")


def trace_buffer_limit() -> int:
    """Max buffered trace events per ``Tracer`` (``REPRO_TRACE_BUFFER``,
    default 200000); beyond it new events are counted as dropped."""
    return int(os.environ.get("REPRO_TRACE_BUFFER", "200000"))


def admit_steps_window() -> int:
    """Bound on the ``stats["admit_steps"]`` history deque
    (``REPRO_ADMIT_STEPS_WINDOW``, default 4096 admissions)."""
    return int(os.environ.get("REPRO_ADMIT_STEPS_WINDOW", "4096"))


def fault_spec() -> str:
    """Deterministic fault-injection spec (``REPRO_FAULTS``, default "");
    see ``repro_torch.faults`` for the grammar."""
    return os.environ.get("REPRO_FAULTS", "")


def fault_seed() -> int:
    """Seed for probabilistic (``~p``) fault clauses
    (``REPRO_FAULTS_SEED``, default 0)."""
    return int(os.environ.get("REPRO_FAULTS_SEED", "0"))


def max_waiting_default() -> int:
    """Default bound on ``ContinuousEngine``'s waiting queue
    (``REPRO_MAX_WAITING``, default 1024; ``<= 0`` means unbounded)."""
    return int(os.environ.get("REPRO_MAX_WAITING", "1024"))


def admit_window() -> int:
    """Head-of-line scan window for admission (``REPRO_ADMIT_WINDOW``,
    default 4; 0 restores strict FCFS)."""
    return int(os.environ.get("REPRO_ADMIT_WINDOW", "4"))


def default_spec_steps() -> int:
    """Default MTP speculative draft depth for ``ContinuousEngine``
    (``REPRO_SPEC_STEPS``, default 0 = speculation off); an explicit
    ``spec_steps=`` always wins."""
    return int(os.environ.get("REPRO_SPEC_STEPS", "0"))


def frontend_wait_s() -> float:
    """Idle-wait granularity of the ``AsyncFrontend`` serve thread
    (``REPRO_FRONTEND_WAIT_S``, seconds, default 0.05).  Submissions and
    pushes notify the thread at once; this only bounds the wake-up latency
    against a lost notification."""
    return float(os.environ.get("REPRO_FRONTEND_WAIT_S", "0.05"))


def max_restarts_default() -> int:
    """Bound on ``AsyncFrontend`` supervisor engine restarts
    (``REPRO_MAX_RESTARTS``, default 3); past it the front-end marks itself
    crashed and refuses new submissions."""
    return int(os.environ.get("REPRO_MAX_RESTARTS", "3"))


def pd_threshold_default() -> int:
    """Prompt-length cutoff of the disaggregated router
    (``REPRO_PD_THRESHOLD``, tokens, default 64): prompts at least this
    long prefill on the prefill tier and migrate their KV blocks; shorter
    ones prefill colocated on the decode engine.  An explicit
    ``DisaggServer(pd_threshold=...)`` always wins."""
    return int(os.environ.get("REPRO_PD_THRESHOLD", "64"))


def migrate_timeout_s() -> float:
    """Wall-clock budget of one KV-block migration attempt, extract and
    install together (``REPRO_MIGRATE_TIMEOUT_S``, seconds, default 5.0)."""
    return float(os.environ.get("REPRO_MIGRATE_TIMEOUT_S", "5.0"))


def migrate_retries() -> int:
    """Retries of a migration beyond its first attempt
    (``REPRO_MIGRATE_RETRIES``, default 2); then ``MigrationFailed``."""
    return int(os.environ.get("REPRO_MIGRATE_RETRIES", "2"))


def migrate_backoff_s() -> float:
    """Base backoff between migration retries, doubled each attempt
    (``REPRO_MIGRATE_BACKOFF_S``, seconds, default 0.01)."""
    return float(os.environ.get("REPRO_MIGRATE_BACKOFF_S", "0.01"))


def tier_restarts_default() -> int:
    """Bound on prefill-tier respawns by ``DisaggServer``
    (``REPRO_TIER_RESTARTS``, default 2); past it the tier stays down and
    the server serves colocated."""
    return int(os.environ.get("REPRO_TIER_RESTARTS", "2"))


def spill_enabled() -> bool:
    """Process-wide default of the host-RAM KV spill tier
    (``REPRO_SPILL_ENABLE``): ``1``/``true``/``yes`` attaches a
    ``HostSpillTier`` to every new prefix-cached ``ContinuousEngine``.  An
    explicit ``ContinuousEngine(spill=...)`` always wins."""
    return os.environ.get("REPRO_SPILL_ENABLE",
                          "0").lower() in ("1", "true", "yes")


def spill_blocks() -> int:
    """Capacity of the host spill tier in blocks (``REPRO_SPILL_BLOCKS``,
    default 512; ``<= 0`` means unbounded).  An explicit
    ``ContinuousEngine(spill_blocks=...)`` always wins."""
    return int(os.environ.get("REPRO_SPILL_BLOCKS", "512"))
