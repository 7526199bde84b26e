"""LR schedules matching the GLM-5 recipe (Appendix A): linear warmup then
cosine decay to a floor; constant and linear options for mid-training/DSA
stages.  Port of ``repro.optim.schedule``, computed on Python floats (the
reference's fp32 arithmetic agrees to fp32 rounding)."""
from __future__ import annotations

import math


def warmup_cosine(step, *, peak: float, floor: float, warmup: int,
                  total: int) -> float:
    step = float(step)
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * prog))


def linear(step, *, start: float, end: float, total: int) -> float:
    prog = min(max(float(step) / max(total, 1), 0.0), 1.0)
    return start + (end - start) * prog


def constant(step, *, value: float) -> float:
    return float(value)
