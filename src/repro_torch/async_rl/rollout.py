"""Rollout engine: versioned policy snapshots + autoregressive sampling.

Port of ``repro.async_rl.rollout``.  The inference-engine stand-in.  Holds
a weight snapshot with a VERSION number; the trainer pushes new weights
every K updates (§4.1.1).  Sampling runs in a numerics regime that
intentionally differs from training (bf16 weights — the paper's
FP8-rollout analogue), so rollout logprobs != training logprobs and the
IcePop/double-sided-IS machinery has real work.

Generation can proceed mid-trajectory across a weight push — fragments
record the version that produced them (TITO metadata), feeding the
staleness filter.

Two generation paths:

* ``generate`` — the per-rollout loop (full-context re-forward each
  token through ``transformer.logits``: K9 in every layer, its bf16 route
  in the default regime): simple, fragment-granular weight staleness, no
  KV cache.
* ``generate_batch`` / ``generate_async`` — the SERVING path: rollouts go
  through an ``AsyncFrontend`` over a ``ContinuousEngine`` (K1 decode
  steps, K2 spans) with the radix prefix cache, so a group that shares a
  system prompt (the GRPO shape — N rollouts per task) prefills it ONCE
  and every sequence decodes through the paged KV cache.  The front-end's
  serve thread owns the engine: many rollout workers submit CONCURRENTLY
  and multiplex into one decode batch, and ``push_weights`` hands new
  snapshots straight through — applied at the engine's drain barrier with
  version-tagged incremental prefix-cache invalidation.  Per-token
  behavior logprobs come back on the request (``capture_logprobs``) and
  are recorded through the same TITO gateway, one fragment per rollout
  stamped with the EXACT snapshot version that produced it
  (``Request.out_version``).

The snapshot is a model of its own in ``engine_dtype``, made by copying
the trainer's parameters on the pushing thread: never the trainer's
tensors, whose values the optimizer changes in place (a cast to a dtype
they already have would alias them), and a new model at every push, since
the engine keeps serving the old one until it drains.  The copy has
finished on the card before the snapshot is handed to any other thread,
whatever stream that thread runs on.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.async_rl.tito import TitoGateway
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.obs.metrics import MetricsRegistry


class RolloutEngine:
    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, *,
                 engine_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 gateway: Optional[TitoGateway] = None,
                 registry: Optional[MetricsRegistry] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = get_model(cfg)
        self.engine_dtype = engine_dtype
        # shared with the serving engine under the front-end (rollout
        # durations, weight-push staleness, and the engine's TTFT/TPOT
        # histograms land in ONE snapshot)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self.version = 0
        self._params = self._copy(params)
        self._rng = np.random.default_rng(seed)
        self.gateway = gateway or TitoGateway()
        self._seed = seed
        self._frontend = None         # lazy AsyncFrontend over the engine
        self._serving_kw = None
        # the frontend build runs under its OWN lock: its serve thread
        # owns the engine afterwards, so nothing here ever blocks a
        # weight push on an in-flight batch
        self._serving_lock = threading.Lock()

    @torch.no_grad()
    def _copy(self, params: torch.nn.Module) -> torch.nn.Module:
        """A new model in ``engine_dtype`` on this engine's device holding
        the values of ``params`` (a copy, whatever their dtype)."""
        src = dict(params.named_parameters())
        out = type(params)(self.cfg, device=self.device,
                           dtype=self.engine_dtype)
        for name, p in out.named_parameters():
            p.copy_(src[name])
        out.requires_grad_(False)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def push_weights(self, params: torch.nn.Module, version: int):
        """Trainer -> inference weight sync (the NCCL broadcast stand-in).

        Forwards straight into the serving front-end (when built): the
        engine applies the snapshot at its drain barrier and invalidates
        the prefix cache INCREMENTALLY via block version tags — in-flight
        rollouts finish at their admitted version, new ones pick up this
        one, and nothing resets."""
        cast = self._copy(params)
        with self._lock:
            self._params = cast
            self.version = version
            fe = self._frontend
        if fe is not None:
            fe.push_weights(cast, version)

    def snapshot(self):
        with self._lock:
            return self._params, self.version

    def _step(self, params: torch.nn.Module, buf: np.ndarray,
              cur: int) -> np.ndarray:
        """fp32 logits at position ``cur - 1`` of the padded buffer (a
        causal forward: the padding after ``cur`` reads nothing)."""
        toks = torch.from_numpy(buf).to(self.device)
        with torch.no_grad():
            logits = self.model.logits(params, toks)
        return logits[0, cur - 1].float().cpu().numpy()

    def generate(self, rollout_id: str, prompt: np.ndarray, max_new: int,
                 *, temperature: float = 1.0, eos: int = 0,
                 fragment_size: int = 8) -> np.ndarray:
        """Sample ``max_new`` tokens autoregressively; records fragments
        (tokens + rollout logprobs + weight version) through the TITO
        gateway.  Weight pushes between fragments are picked up mid-
        trajectory — that's the async off-policy condition."""
        t_start = time.perf_counter()
        buf_len = len(prompt) + max_new
        # round up to a small set of bucket lengths (the reference's one
        # compile a bucket; here the same forward shapes)
        bucket = 16
        buf_len = ((buf_len + bucket - 1) // bucket) * bucket
        buf = np.zeros((1, buf_len), np.int64)
        buf[0, :len(prompt)] = prompt
        cur = len(prompt)
        out = []
        frag_toks, frag_lps = [], []
        params, version = self.snapshot()
        for i in range(max_new):
            if i > 0 and i % fragment_size == 0:
                self.gateway.record(rollout_id, np.array(frag_toks),
                                    np.array(frag_lps), version)
                frag_toks, frag_lps = [], []
                params, version = self.snapshot()
            logits = self._step(params, buf, cur)
            logits = logits / max(temperature, 1e-6)
            logp = logits - _logsumexp(logits)
            p = np.exp(logp)
            p /= p.sum()
            tok = int(self._rng.choice(len(logp), p=p))
            frag_toks.append(tok)
            frag_lps.append(float(logp[tok]))
            out.append(tok)
            buf[0, cur] = tok
            cur += 1
            if tok == eos:
                break
        if frag_toks:
            self.gateway.record(rollout_id, np.array(frag_toks),
                                np.array(frag_lps), version)
        self._observe_rollout(t_start, len(out), version)
        return np.asarray(out, np.int32)

    def _observe_rollout(self, t_start: float, n_tokens: int,
                         version: int) -> None:
        """Per-rollout telemetry: wall duration (the §4.1 slow/stuck-
        rollout signal), token count, and weight-push staleness — how many
        pushes landed since the version this rollout LAST sampled under
        (0 = perfectly fresh; the buffer's τ filter drops > tau)."""
        self.registry.observe("rollout.duration_ms",
                              (time.perf_counter() - t_start) * 1e3)
        self.registry.inc("rollout.rollouts")
        self.registry.inc("rollout.tokens", n_tokens)
        self.registry.observe("rollout.staleness", self.version - version,
                              boundaries=[0, 1, 2, 4, 8, 16, 32])

    # ------------------------------------------------------- engine-backed
    def serving_frontend(self, *, max_batch: int = 8, block_size: int = 16,
                         num_blocks: int = 256, max_len: int = 512):
        """The async front-end this rollout worker decodes through (built
        lazily, shared by every worker thread hitting this engine — its
        serve thread owns one paged ``ContinuousEngine`` whose radix
        prefix cache persists across batches, so a system prompt shared
        across GRPO groups stays resident between calls)."""
        kw = dict(max_batch=max_batch, block_size=block_size,
                  num_blocks=num_blocks, max_len=max_len)
        with self._serving_lock:
            if self._frontend is None:
                from repro_torch.serving.frontend import AsyncFrontend
                from repro_torch.serving.scheduler import ContinuousEngine
                with self._lock:
                    params, version = self._params, self.version
                # seed follows the worker so DP ranks sample distinct
                # streams, exactly like the generate() path
                eng = ContinuousEngine(
                    self.cfg, params, capture_logprobs=True,
                    seed=self._seed, weight_version=version,
                    registry=self.registry, device=self.device, **kw)
                self._frontend = AsyncFrontend(eng)
                self._serving_kw = kw
            elif kw != self._serving_kw:
                raise ValueError(
                    f"serving engine already built with {self._serving_kw},"
                    f" got {kw}: engine geometry is fixed per worker")
            return self._frontend

    def serving_engine(self, **kw):
        """The paged engine under the front-end (stats/introspection; the
        front-end's serve thread owns all mutation)."""
        return self.serving_frontend(**kw).engine

    def generate_batch(self, rollout_ids: Sequence[str],
                       prompts: Sequence[np.ndarray], max_new: int, *,
                       temperature: float = 1.0,
                       **engine_kw) -> List[np.ndarray]:
        """Serve a batch of rollouts through the prefix-cached front-end.

        Rollouts sharing a prompt prefix (system prompt, few-shot header)
        prefill it once.  Submission is non-exclusive — other workers'
        rollouts and trainer weight pushes interleave freely — and each
        fragment is recorded at the version its OWN request actually ran
        under (a push landing mid-batch splits the batch across snapshots
        cleanly instead of blocking behind it)."""
        fe = self.serving_frontend(**engine_kw)
        t_start = time.perf_counter()
        handles = [fe.submit(p, max_new=max_new, temperature=temperature)
                   for p in prompts]
        outs = []
        for rid, h in zip(rollout_ids, handles):
            r = fe.result(h)
            self.gateway.record(rid, r.out, r.out_logprobs, r.out_version)
            self._observe_rollout(t_start, len(r.out), r.out_version)
            outs.append(r.out)
        return outs

    def generate_async(self, rollout_id: str, prompt: np.ndarray,
                       max_new: int, *, temperature: float = 1.0,
                       **engine_kw) -> np.ndarray:
        """One rollout through the front-end: submit, block on the
        result, record the TITO fragment at the producing version.

        The worker thread blocks, but GENERATION does not — all
        concurrent callers' requests share the engine's decode batch, so
        a slow group elsewhere never serializes this one (the
        decoupled-generation posture ``Orchestrator`` workers use)."""
        fe = self.serving_frontend(**engine_kw)
        t_start = time.perf_counter()
        h = fe.submit(prompt, max_new=max_new, temperature=temperature)
        r = fe.result(h)
        self.gateway.record(rollout_id, r.out, r.out_logprobs,
                            r.out_version)
        self._observe_rollout(t_start, len(r.out), r.out_version)
        return r.out


def _logsumexp(x: np.ndarray) -> float:
    m = float(np.max(x))
    return m + float(np.log(np.sum(np.exp(x - m))))
