"""Agent-session serving API: multi-turn conversations over the prefix cache.

Port of ``repro.serving.session`` (pure host code over the engine).

An agentic client re-submits its WHOLE conversation every turn; without
reuse, turn N pays a prefill quadratic in history (the cost GLM-5 §3.6
engineers around).  ``AgentSession`` wraps a ``ContinuousEngine`` whose
radix prefix cache already holds the conversation's KV blocks from
previous turns: ``send(tokens)`` submits ``history + tokens`` as an
ordinary request, the engine matches the history in the radix tree and
prefills ONLY the new user message (plus the reply's first token), and the
session then PINS the grown conversation's blocks — an extra reference via
``PagedKVCache.retain`` — so LRU eviction under memory pressure can never
reclaim a live conversation between turns.  ``close()`` drops the pin,
returning the blocks to normal cache lifetime.

Turn accounting (``last_turn``) exposes prefilled vs reused token counts —
the numbers a prefix-cache benchmark aggregates.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.serving.scheduler import ContinuousEngine


class AgentSession:
    """One multi-turn conversation pinned into the engine's prefix cache."""

    def __init__(self, engine: ContinuousEngine, *,
                 temperature: float = 0.0):
        if engine.prefix is None:
            raise ValueError("AgentSession needs an engine with "
                             "prefix_cache=True (and a non-hybrid family: "
                             "recurrent state cannot be re-aliased)")
        self.engine = engine
        self.temperature = temperature
        self.tokens: List[int] = []       # full conversation so far
        self._pinned: List[int] = []      # blocks we hold a reference on
        self.turns = 0
        self.last_turn: Dict[str, int] = {}
        self._closed = False

    # ----------------------------------------------------------------- api
    def send(self, user_tokens: Sequence[int], *, max_new: int = 32,
             temperature: Optional[float] = None) -> np.ndarray:
        """Append ``user_tokens`` to the conversation, generate a reply.

        The engine prefills only the suffix the radix cache has not seen —
        for turn N+1 that is the new user message (everything earlier was
        cached when turn N retired)."""
        if self._closed:
            raise RuntimeError("session is closed")
        prompt = self.tokens + [int(t) for t in user_tokens]
        req = Request(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                      temperature=self.temperature if temperature is None
                      else temperature)
        before = dict(self.engine.stats)
        self.engine.serve([req])
        self.tokens = prompt + [int(t) for t in req.out]
        self._repin()
        self.turns += 1
        self.last_turn = {
            "prompt_tokens": len(prompt),
            "prefill_tokens": self.engine.stats["prefill_tokens"]
            - before["prefill_tokens"],
            "cached_tokens": self.engine.stats["cached_tokens"]
            - before["cached_tokens"],
            "new_tokens": int(len(req.out)),
            # MTP speculative decode accounting (0/0 when spec_steps=0):
            # this turn's drafted vs accepted token counts
            "draft_tokens": self.engine.stats["draft_tokens"]
            - before["draft_tokens"],
            "accepted_tokens": self.engine.stats["accepted_tokens"]
            - before["accepted_tokens"],
            # live turn latency (ms): TTFT covers the suffix prefill this
            # turn actually paid, so cache hits show up as TTFT drops
            "ttft_ms": (req.ttft_s or 0.0) * 1e3,
            "latency_ms": ((req.t_finish - req.t_submit) * 1e3
                           if req.t_submit and req.t_finish else 0.0),
        }
        return req.out

    def close(self) -> None:
        """Unpin the conversation; its blocks age out of the cache via LRU."""
        if self._pinned:
            self.engine.kv.release(self._pinned)
            self._pinned = []
        self._closed = True

    @property
    def pinned_blocks(self) -> int:
        return len(self._pinned)

    # ------------------------------------------------------------ internal
    def _repin(self) -> None:
        """Swap the pin to the grown conversation's cached blocks.

        match() retains on our behalf; the previous turn's pin is released
        afterwards so the blocks shared by both turns never hit zero."""
        old = self._pinned
        _, self._pinned = self.engine.prefix.match(self.tokens)
        if old:
            self.engine.kv.release(old)
