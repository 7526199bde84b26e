"""Needle-in-a-haystack long-context task generators.

Port of ``repro.data.needle`` (host code, copied as it is).

Synthetic analogues of the paper's long-context benchmarks (Table 3:
MQ-NIAH / MV-NIAH / SQuAD-128k; Table 5/6: RULER) used to measure DSA's
retrieval fidelity against the dense baseline:

A sequence is filler tokens with K embedded (key -> value) records:
    ... f f f [SEP] k1 v1 v2 [SEP] f f ... [QUERY] k1 -> ? ?
The model (or the attention mechanism directly, for the mechanism-level
benchmark) must retrieve the values for the queried key.  Accuracy = exact
match over value tokens.  Scales to arbitrary context length, fully
deterministic given seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

SEP, QUERY = 1, 2
RESERVED = 3


@dataclass
class NeedleBatch:
    tokens: np.ndarray        # (B, S) int32
    targets: np.ndarray       # (B, S)
    loss_mask: np.ndarray     # (B, S) — 1 on answer positions
    answer_pos: np.ndarray    # (B, n_value) indices of answer positions
    answer_vals: np.ndarray   # (B, n_value)


def needle_batch(batch: int, seq_len: int, vocab: int, *,
                 n_needles: int = 4, n_value: int = 2,
                 seed: int = 0) -> NeedleBatch:
    rng = np.random.default_rng(seed)
    toks = rng.integers(RESERVED, vocab, size=(batch, seq_len)).astype(np.int32)
    tail = 2 + n_value + 1
    targets = np.zeros_like(toks)
    mask = np.zeros((batch, seq_len), np.float32)
    ans_pos = np.zeros((batch, n_value), np.int64)
    ans_val = np.zeros((batch, n_value), np.int64)
    for b in range(batch):
        keys = rng.choice(np.arange(RESERVED, vocab), size=n_needles,
                          replace=False)
        vals = rng.integers(RESERVED, vocab, size=(n_needles, n_value))
        # place needles in the body (not the last tail tokens)
        pos = rng.choice(np.arange(1, seq_len - tail - (n_value + 2)),
                         size=n_needles, replace=False)
        for k, v, p in zip(keys, vals, pos):
            toks[b, p] = SEP
            toks[b, p + 1] = k
            toks[b, p + 2:p + 2 + n_value] = v
        qi = rng.integers(0, n_needles)
        qs = seq_len - tail
        toks[b, qs] = QUERY
        toks[b, qs + 1] = keys[qi]
        toks[b, qs + 2:qs + 2 + n_value] = vals[qi]
        # next-token prediction: the answer tokens must be predicted from
        # the positions immediately before them
        targets[b, :-1] = toks[b, 1:]
        mask[b, qs + 1:qs + 1 + n_value] = 1.0
        ans_pos[b] = np.arange(qs + 2, qs + 2 + n_value)
        ans_val[b] = vals[qi]
    return NeedleBatch(tokens=toks, targets=targets, loss_mask=mask,
                       answer_pos=ans_pos, answer_vals=ans_val)


def needle_accuracy(pred_tokens: np.ndarray, nb: NeedleBatch) -> float:
    """pred_tokens (B,S) greedy next-token predictions aligned to inputs."""
    hit = 0
    for b in range(pred_tokens.shape[0]):
        want = nb.answer_vals[b]
        got = pred_tokens[b, nb.answer_pos[b] - 1]
        hit += int((want == got).all())
    return hit / pred_tokens.shape[0]
