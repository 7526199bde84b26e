"""Synthetic multi-hop search environment (BrowseComp / §4.2.3 analogue).

Port of ``repro.agents.search_env`` (host code, copied as it is).

A hidden chain e0 -> e1 -> ... -> answer; the agent follows it with
`search(entity)` tool calls.  Two effects reproduce the paper's Figure-8
dynamics:

1. **Budget**: every round's cost includes re-prefilling the current
   context, so an unmanaged context makes cumulative cost quadratic in
   rounds — the agent runs out of token budget before finishing long
   chains.  Folding old observations (keep-recent-k) keeps rounds cheap.
2. **Long-context degradation** (§4.2.4 "accuracy degrades substantially
   beyond ~100k"): the probability of mis-reading an observation grows
   linearly once the live context exceeds ``degrade_start`` — a failed
   read wastes the round (no progress).

Discard-all resets the context; WITHOUT a carried note the agent loses its
chain position and restarts from hop 0 (the note mechanism models the
agent writing a progress summary — enabled for the paper-style strategies).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.agents.context_mgmt import Context, Round


@dataclasses.dataclass
class SearchEnv:
    question: str
    q_tokens: int
    chain: List[str]
    answer: str
    obs_tokens: int
    rng: np.random.Generator
    degrade_start: int = 100_000
    degrade_scale: int = 400_000
    # mutable episode state
    hop: int = 0
    seen_restarts: int = 0

    def check(self, answer: str) -> bool:
        return answer == self.answer


def make_env(rng: np.random.Generator, *, hops: int = 8,
             obs_tokens: int = 600, q_tokens: int = 80,
             degrade_start: int = 100_000) -> SearchEnv:
    n = int(rng.integers(0, 10 ** 6))
    chain = [f"e{n}_{i}" for i in range(hops + 1)]
    return SearchEnv(question=f"multi-hop from {chain[0]}",
                     q_tokens=q_tokens, chain=chain, answer=chain[-1],
                     obs_tokens=obs_tokens, rng=rng,
                     degrade_start=degrade_start)


def scripted_agent(env: SearchEnv, ctx: Context, *, r_tokens: int = 120,
                   a_tokens: int = 20) -> Tuple[Round, Optional[str]]:
    """One round of a competent-but-degradable agent."""
    from repro_torch.agents.context_mgmt import Strategy
    # a discard-all restart loses working context: with a carried note the
    # agent regresses a few hops (must re-derive recent facts); without a
    # note it starts the chain over
    if ctx.restarts > env.seen_restarts:
        regressions = ctx.restarts - env.seen_restarts
        env.seen_restarts = ctx.restarts
        env.hop = max(0, env.hop - 3 * regressions) \
            if ctx.note_tokens > 0 else 0
    live_tokens = Strategy().tokens(ctx)
    p_err = 0.0
    if live_tokens > env.degrade_start:
        p_err = min(0.9, (live_tokens - env.degrade_start)
                    / env.degrade_scale)
    if env.hop >= len(env.chain) - 1:
        return Round(reasoning="answer", action="final", observation="",
                     r_tokens=r_tokens, a_tokens=a_tokens, o_tokens=0), \
            env.answer
    ent = env.chain[env.hop]
    if env.rng.random() < p_err:
        obs = f"{ent}->???"          # degraded read: no progress
    else:
        obs = f"{ent}->{env.chain[env.hop + 1]}"
        env.hop += 1
    return Round(reasoning="follow", action=f"search({ent})",
                 observation=obs, r_tokens=r_tokens, a_tokens=a_tokens,
                 o_tokens=env.obs_tokens), None
