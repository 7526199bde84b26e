"""Token-In-Token-Out gateway (GLM-5 §4.1.2).

Port of ``repro.async_rl.tito`` (host code, copied as it is).

The trainer must optimize EXACTLY the token stream the rollout engine
sampled.  The TITO gateway sits between agents and the inference engine,
records every generated fragment's token ids + per-token logprobs + the
weight version that produced them, and assembles trajectories for the
learner without any text round-trip.

``TextRoundTrip`` implements the text-in-text-out BASELINE the paper warns
about: trajectories are detokenized and re-tokenized with a merge-ambiguous
toy tokenizer, which corrupts token boundaries at a measurable rate — the
``rl_async`` benchmark shows the resulting action/credit misalignment.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Fragment:
    tokens: np.ndarray          # (t,) int32 sampled tokens
    logprobs: np.ndarray        # (t,) float32 rollout logprobs (behavior)
    weight_version: int


@dataclasses.dataclass
class Trajectory:
    rollout_id: str
    task: str
    prompt: np.ndarray
    tokens: np.ndarray          # generated tokens (concatenated fragments)
    logprobs: np.ndarray        # rollout logprobs, aligned 1:1 with tokens
    versions: List[int]         # weight versions per fragment (w0..wk)
    reward: float = 0.0
    env_failure: bool = False
    loss_mask: Optional[np.ndarray] = None   # 0 on tool/env tokens

    @property
    def version_min(self) -> int:
        return min(self.versions) if self.versions else 0


class TitoGateway:
    """Accumulates fragments per rollout id; assembles trajectories."""

    def __init__(self):
        self._frags: Dict[str, List[Fragment]] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()

    def new_rollout(self, task: str) -> str:
        rid = f"{task}-{next(self._ids)}"
        with self._lock:
            self._frags[rid] = []
        return rid

    def record(self, rollout_id: str, tokens: np.ndarray,
               logprobs: np.ndarray, weight_version: int):
        frag = Fragment(np.asarray(tokens, np.int32),
                        np.asarray(logprobs, np.float32),
                        weight_version)
        with self._lock:
            self._frags[rollout_id].append(frag)

    def finish(self, rollout_id: str, task: str, prompt: np.ndarray,
               reward: float, env_failure: bool = False,
               loss_mask: Optional[np.ndarray] = None) -> Trajectory:
        with self._lock:
            frags = self._frags.pop(rollout_id, [])
        toks = (np.concatenate([f.tokens for f in frags])
                if frags else np.zeros(0, np.int32))
        lps = (np.concatenate([f.logprobs for f in frags])
               if frags else np.zeros(0, np.float32))
        return Trajectory(rollout_id=rollout_id, task=task,
                          prompt=np.asarray(prompt, np.int32),
                          tokens=toks, logprobs=lps,
                          versions=[f.weight_version for f in frags],
                          reward=reward, env_failure=env_failure,
                          loss_mask=loss_mask)


# ---------------------------------------------------------------------------
# text-in-text-out baseline (the failure mode TITO exists to avoid)
# ---------------------------------------------------------------------------

class ToyTokenizer:
    """Merge-ambiguous tokenizer: any adjacent pair (a, a+1) with even ``a``
    detokenizes to the same surface string as the single merged token
    M(a) = vocab + a//2 — so decode->encode is NOT the identity (encode
    greedily prefers the merged token).  This mirrors real BPE boundary
    ambiguity."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def decode(self, tokens: Sequence[int]) -> List[str]:
        out = []
        for t in tokens:
            t = int(t)
            if t >= self.vocab:           # merged token
                a = (t - self.vocab) * 2
                out.append(f"<{a}.{a+1}>")
            else:
                out.append(f"<{t}>")
        return out

    def encode(self, pieces: List[str]) -> np.ndarray:
        # greedy re-merge: "<a>","<a+1>" with even a becomes the merged id
        toks: List[int] = []
        flat: List[int] = []
        for p in pieces:
            if "." in p:
                a, b = p[1:-1].split(".")
                flat += [int(a), int(b)]
            else:
                flat.append(int(p[1:-1]))
        i = 0
        while i < len(flat):
            if (i + 1 < len(flat) and flat[i] % 2 == 0
                    and flat[i + 1] == flat[i] + 1):
                toks.append(self.vocab + flat[i] // 2)
                i += 2
            else:
                toks.append(flat[i])
                i += 1
        return np.asarray(toks, np.int32)


def text_roundtrip(traj: Trajectory, tok: ToyTokenizer) -> Trajectory:
    """Re-tokenize a trajectory through text (the TITO-less baseline)."""
    new_tokens = tok.encode(tok.decode(traj.tokens))
    n = len(new_tokens)
    # logprob alignment is now by POSITION, which is wrong when merges
    # happened — exactly the corruption the paper describes.
    lps = traj.logprobs[:n] if n <= len(traj.logprobs) else np.pad(
        traj.logprobs, (0, n - len(traj.logprobs)))
    return dataclasses.replace(traj, tokens=new_tokens, logprobs=lps)


def misalignment_rate(traj: Trajectory, tok: ToyTokenizer) -> float:
    """Fraction of positions whose token id changed after the round-trip."""
    rt = text_roundtrip(traj, tok)
    n = min(len(rt.tokens), len(traj.tokens))
    if len(traj.tokens) == 0:
        return 0.0
    same = sum(int(a == b) for a, b in zip(rt.tokens[:n], traj.tokens[:n]))
    return 1.0 - same / len(traj.tokens)
