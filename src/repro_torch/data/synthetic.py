"""Deterministic synthetic LM corpus (port of ``repro.data.synthetic``'s
``make_markov`` / ``markov_stream`` / ``lm_batch``; the RL toy tasks come
with the RL slice).

``markov_stream`` draws from an order-1 Markov chain over the vocab with
``branching`` successors a state: real sequential structure
(learnable; loss decreases well below the unigram entropy), deterministic
given the seed.  The reference builds the dense (V, V) transition matrix
and its row cumsums, 16.4 GB each at V = 64000; here each state keeps only
its successors, sorted by id, with their probabilities and cumulative
sums.  The stream is the reference's token for token: the same RNG draws
in the same order, and ``np.cumsum`` over a dense row adds exact zeros
between successors, so the cumulative values at the successors are the
same floats; a draw no cumulative value exceeds gives state 0, as the
reference's argmax over an all-False row does.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def make_markov(vocab_size: int, seed: int = 0, branching: int = 8
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Each state's ``branching`` successors, sorted by id (V, branching)
    int64, and their transition probabilities (V, branching) float32 (the
    nonzero entries of the reference's dense row, in column order)."""
    rng = np.random.default_rng(seed)
    succ = np.empty((vocab_size, branching), np.int64)
    prob = np.empty((vocab_size, branching), np.float32)
    for s in range(vocab_size):
        nxt = rng.choice(vocab_size, size=branching, replace=False)
        w = rng.dirichlet(np.ones(branching) * 0.5)
        order = np.argsort(nxt)
        succ[s] = nxt[order]
        prob[s] = w[order]
    return succ, prob


def markov_stream(vocab_size: int, seq_len: int, batch: int, *,
                  seed: int = 0, stream_seed: Optional[int] = None,
                  branching: int = 8) -> Iterator[np.ndarray]:
    """Yields (batch, seq_len+1) int32 — slice [:-1] tokens / [1:] targets.

    ``seed`` fixes the LANGUAGE (transition matrix); ``stream_seed`` the
    sample stream (defaults to seed+1)."""
    succ, prob = make_markov(vocab_size, seed, branching=branching)
    cum = np.cumsum(prob, axis=1)
    rng = np.random.default_rng(seed + 1 if stream_seed is None
                                else stream_seed)
    rows = np.arange(batch)
    while True:
        out = np.empty((batch, seq_len + 1), np.int32)
        state = rng.integers(0, vocab_size, size=batch)
        out[:, 0] = state
        for t in range(1, seq_len + 1):
            u = rng.random(batch)[:, None]
            hit = cum[state] > u
            first = hit.argmax(axis=1)
            state = np.where(hit.any(axis=1), succ[state, first], 0)
            out[:, t] = state
        yield out


def lm_batch(stream_it) -> dict:
    arr = next(stream_it)
    return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}
