"""Context management for search agents (GLM-5 §4.2.4, Figure 8).

Port of ``repro.agents.context_mgmt`` (host code, copied as it is).

A trajectory is (q, r_1, a_1, o_1, ..., r_n, a_n, o_n): reasoning, action,
observation per round.  Strategies:

* ``KeepRecentK`` — fold observations older than the most recent k rounds to
  the placeholder "Tool result is omitted to save tokens." (paper k=5).
* ``DiscardAll`` — when context exceeds threshold T, drop the whole
  tool-call history and restart with a fresh context (DeepSeek-V3.2 style).
* ``Hierarchical`` — keep-recent-k continuously; additionally discard-all
  when total context exceeds T (paper: T=32k, the Fig. 8 winner).

Implemented over token-count accounting so the benchmark can replay the
paper's budget-vs-accuracy comparison on the synthetic multi-hop env.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

FOLDED = "<omitted>"
FOLDED_COST = 1


@dataclasses.dataclass
class Round:
    reasoning: str
    action: str
    observation: str
    r_tokens: int
    a_tokens: int
    o_tokens: int


@dataclasses.dataclass
class Context:
    question: str
    q_tokens: int
    rounds: List[Round] = dataclasses.field(default_factory=list)
    restarts: int = 0
    note_tokens: int = 0      # carried summary after discard-all


class Strategy:
    name = "none"

    def add_round(self, ctx: Context, rnd: Round) -> Context:
        ctx.rounds.append(rnd)
        return self.manage(ctx)

    def manage(self, ctx: Context) -> Context:
        return ctx

    def tokens(self, ctx: Context) -> int:
        t = ctx.q_tokens + ctx.note_tokens
        for r in ctx.rounds:
            t += r.r_tokens + r.a_tokens + r.o_tokens
        return t


class NoManagement(Strategy):
    name = "none"


class KeepRecentK(Strategy):
    name = "keep_recent_k"

    def __init__(self, k: int = 5):
        self.k = k

    def manage(self, ctx: Context) -> Context:
        for r in ctx.rounds[:-self.k] if self.k else ctx.rounds:
            if r.observation != FOLDED:
                r.observation = FOLDED
                r.o_tokens = FOLDED_COST
        return ctx


class DiscardAll(Strategy):
    name = "discard_all"

    def __init__(self, threshold: int = 32768, carry_tokens: int = 64):
        self.threshold = threshold
        self.carry = carry_tokens

    def manage(self, ctx: Context) -> Context:
        if self.tokens(ctx) > self.threshold:
            ctx.rounds = []
            ctx.restarts += 1
            ctx.note_tokens = min(ctx.note_tokens + self.carry,
                                  4 * self.carry)
        return ctx


class Hierarchical(Strategy):
    """keep-recent-k + discard-all at threshold T (GLM-5's combination)."""
    name = "hierarchical"

    def __init__(self, k: int = 5, threshold: int = 32768,
                 carry_tokens: int = 64):
        self.keep = KeepRecentK(k)
        self.discard = DiscardAll(threshold, carry_tokens)

    def manage(self, ctx: Context) -> Context:
        ctx = self.keep.manage(ctx)
        return self.discard.manage(ctx)


def run_episode(env, agent_fn, strategy: Strategy, *, budget_tokens: int,
                max_rounds: int = 128) -> Tuple[bool, dict]:
    """Drive an agent over ``env`` until it answers, the token BUDGET is
    exhausted, or rounds run out.  ``agent_fn(env, ctx)`` -> (Round, answer
    or None).  Returns (correct, stats)."""
    ctx = Context(question=env.question, q_tokens=env.q_tokens)
    spent = ctx.q_tokens
    rounds = 0
    while rounds < max_rounds:
        rnd, answer = agent_fn(env, ctx)
        spent += rnd.r_tokens + rnd.a_tokens + rnd.o_tokens \
            + strategy.tokens(ctx)          # prefill cost of the context
        if spent > budget_tokens:
            return False, {"rounds": rounds, "spent": spent,
                           "restarts": ctx.restarts, "out_of_budget": True}
        ctx = strategy.add_round(ctx, rnd)
        rounds += 1
        if answer is not None:
            return env.check(answer), {"rounds": rounds, "spent": spent,
                                       "restarts": ctx.restarts,
                                       "out_of_budget": False}
    return False, {"rounds": rounds, "spent": spent,
                   "restarts": ctx.restarts, "out_of_budget": False}
