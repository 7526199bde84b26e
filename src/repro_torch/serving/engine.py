"""STATIC-batching serving engine: the reference oracle.

Port of ``repro.serving.engine``.  Left-pads every prompt in a batch to the
batch max and decodes lock-step over a contiguous cache until the LONGEST
``max_new`` finishes.  It is the numerically simple oracle that the
continuous engine's greedy outputs are compared with
(``ServingEngine(max_batch=1)`` serves one request at a time).  Sampling
runs on the host with numpy, as in the reference, so greedy ties break by
``np.argmax`` in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model


# eq=False: requests are identities, not values (queue and slot lookups
# compare by identity; numpy prompts would make __eq__ ambiguous)
@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray
    max_new: int = 32
    temperature: float = 0.0
    # completion deadline, seconds relative to t_submit (None = none)
    deadline_s: Optional[float] = None
    out: Optional[np.ndarray] = None
    # per-token behavior logprobs of ``out``: the reference fills them
    # under capture_logprobs=True; None here until logprob capture is
    # ported with the RL layers
    out_logprobs: Optional[np.ndarray] = None
    # weight version the whole generation ran under
    out_version: Optional[int] = None
    # telemetry: engine-unique id and perf_counter stamps
    rid: Optional[int] = None
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    # terminal state: exactly one of ``out`` / ``error`` is set;
    # status is ok | failed | cancelled | deadline | shed
    error: Optional[Exception] = None
    status: str = "ok"

    @property
    def finished(self) -> bool:
        return self.out is not None or self.error is not None

    @property
    def ttft_s(self) -> Optional[float]:
        """Time-to-first-token (seconds); None until the first token."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time-per-output-token AFTER the first (seconds)."""
        if self.t_first is None or self.t_finish is None or self.out is None:
            return None
        n = len(self.out)
        return (self.t_finish - self.t_first) / (n - 1) if n > 1 else 0.0


def sample_token(logits_row: np.ndarray, temperature: float, rng) -> int:
    """Greedy argmax (temperature<=0) or softmax sampling for one request,
    shared by the static and continuous engines."""
    if temperature <= 0:
        return int(logits_row.argmax())
    p = np.exp((logits_row - logits_row.max()) / temperature)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0, device=None):
        self.device = resolve_device(device)
        first = next(params.parameters())
        if first.device.type != self.device.type:
            raise ValueError(f"params live on {first.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = params
        self.dtype = first.dtype
        self.max_batch = max_batch
        self.max_len = max_len
        self._rng = np.random.default_rng(seed)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Static batching: pad prompts, joint prefill, step decode."""
        for i in range(0, len(requests), self.max_batch):
            self._serve_batch(requests[i:i + self.max_batch])
        return requests

    def _serve_batch(self, batch: List[Request]) -> None:
        B = len(batch)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        cache = self.model.init_cache(self.cfg, B, self.max_len, self.dtype,
                                      self.device)
        logits, cache = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device), cache)
        max_new = max(r.max_new for r in batch)
        outs = [[] for _ in range(B)]
        tok = self._sample(logits, batch)
        for step in range(max_new):
            for i in range(B):
                outs[i].append(int(tok[i, 0]))
            logits, cache = self.model.decode_step(
                self.params, torch.from_numpy(tok).to(self.device), cache,
                plen + step)
            tok = self._sample(logits, batch)
        for i, r in enumerate(batch):
            r.out = np.asarray(outs[i][:r.max_new], np.int32)

    def _sample(self, logits: torch.Tensor, batch) -> np.ndarray:
        lg = logits[:, -1].float().cpu().numpy()
        out = np.zeros((len(batch), 1), np.int32)
        for i, r in enumerate(batch):
            out[i, 0] = sample_token(lg[i], r.temperature, self._rng)
        return out
