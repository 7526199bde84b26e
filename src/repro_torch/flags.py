"""Process-wide environment readers of the port.

A copy of the readers in the JAX package's ``repro.flags`` that the serving
slice uses, under the same environment variable names.  There is no reader
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
