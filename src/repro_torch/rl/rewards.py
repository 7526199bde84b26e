"""Binary outcome rewards (GLM-5 §3.2: "domain and source-specific judge
models or evaluation systems to produce binary outcome rewards").

Port of ``repro.rl.rewards`` (numpy host code, copied as it is)."""
from __future__ import annotations

import numpy as np


def exact_match_reward(generated: np.ndarray, target: np.ndarray,
                       eos: int = 0) -> float:
    """1.0 iff the generated tokens match the target up to EOS."""
    gen = list(generated)
    if eos in gen:
        gen = gen[:gen.index(eos)]
    return float(len(gen) == len(target) and
                 all(int(a) == int(b) for a, b in zip(gen, target)))


def prefix_reward(generated: np.ndarray, target: np.ndarray) -> float:
    """Fraction of correct prefix — a denser shaping variant for ablations."""
    n = min(len(generated), len(target))
    if n == 0:
        return 0.0
    hit = 0
    for a, b in zip(generated[:n], target[:n]):
        if int(a) == int(b):
            hit += 1
        else:
            break
    return hit / len(target)
