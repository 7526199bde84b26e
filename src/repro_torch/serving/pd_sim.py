"""Prefill-Decode disaggregation + tail-latency simulator (GLM-5 §3.6.2).

Port of ``repro.serving.pd_sim`` (numpy only, copied so the port imports
nothing of the JAX package).

Discrete-event queueing model of the RL rollout serving fleet.  Requests
are multi-turn: each turn needs a prefill (context-length dependent) and a
stream of decode steps.  Two deployments:

* ``colocated`` — prefills and decodes share the same servers; a running
  prefill blocks decode progress on that server (the interference the
  paper describes);
* ``pd_disaggregated`` — dedicated prefill servers and decode servers;
  decodes are never preempted.

Also models MTP speculative decode (accept_length× fewer decode steps) and
FP8/bf16 rollout speed (per-token latency scale) so the benchmark can
reproduce the §3.6.2 tail-latency claims qualitatively.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Workload:
    n_rollouts: int = 64
    turns: int = 4
    prefill_tokens_per_turn: int = 4096
    decode_tokens_mean: int = 256
    decode_tokens_tail: int = 2048     # long-tail samples
    tail_frac: float = 0.1


@dataclasses.dataclass
class ServingConfig:
    n_servers: int = 8
    pd_disaggregated: bool = False
    prefill_frac: float = 0.25         # of servers, when disaggregated
    prefill_tok_per_s: float = 50_000.0
    decode_tok_per_s: float = 100.0    # per stream
    accept_length: float = 1.0         # MTP speedup (tokens per step)
    dtype_speed: float = 1.0           # FP8 ~ 1.6x vs bf16=1.0
    # continuous vs static batching on the decode servers.  Static batching
    # decodes lock-step: a stream occupies its server until the LONGEST of
    # ``decode_batch`` co-scheduled streams finishes (the padding waste the
    # paged ContinuousEngine removes); continuous frees capacity the moment
    # the stream's own tokens are done.
    continuous_batching: bool = True
    decode_batch: int = 8              # lock-step group size when static


def simulate(w: Workload, s: ServingConfig, seed: int = 0) -> Dict[str, float]:
    rng = np.random.default_rng(seed)
    n_servers = s.n_servers
    if s.pd_disaggregated:
        n_prefill = max(1, round(n_servers * s.prefill_frac))
        n_decode = n_servers - n_prefill
    else:
        n_prefill = n_decode = n_servers   # shared pool

    # per-server busy-until clocks.  Colocated: ONE pool — a decode queues
    # behind any prefill occupying its server (the §3.6.2 interference).
    # Disaggregated: separate pools — decodes never wait on prefills.
    if s.pd_disaggregated:
        prefill_free = [0.0] * n_prefill
        decode_free = [0.0] * n_decode
    else:
        shared = [0.0] * n_servers
        prefill_free = decode_free = shared
    finish_times = []

    decode_rate = s.decode_tok_per_s * s.accept_length * s.dtype_speed
    prefill_rate = s.prefill_tok_per_s * s.dtype_speed

    # colocated interference: prefills steal a rho-fraction of the pool's
    # capacity from ongoing decode streams (heavy prefills preempt decodes
    # on the same server — §3.6.2).  rho = prefill share of total work.
    exp_decode = (w.tail_frac * w.decode_tokens_tail
                  + (1 - w.tail_frac) * w.decode_tokens_mean)
    work_p = w.prefill_tokens_per_turn / prefill_rate
    work_d = exp_decode / decode_rate
    rho = work_p / (work_p + work_d)
    decode_slowdown = 1.0 / max(0.05, 1.0 - rho) \
        if not s.pd_disaggregated else 1.0

    # dedicated rng for hypothetical lock-step co-residents, so the SAME
    # seed samples the SAME workload under both batching policies
    peer_rng = np.random.default_rng(seed + 0x5EED)

    def draw_ntok() -> int:
        if peer_rng.random() < w.tail_frac:
            return w.decode_tokens_tail
        return max(1, int(peer_rng.exponential(w.decode_tokens_mean)))

    ideals = []
    for r in range(w.n_rollouts):
        t = 0.0
        ideal = 0.0
        is_tail = rng.random() < w.tail_frac
        for turn in range(w.turns):
            ntok = (w.decode_tokens_tail if is_tail
                    else max(1, int(rng.exponential(w.decode_tokens_mean))))
            # prefill occupies a server exclusively
            pi = int(np.argmin(prefill_free))
            start = max(t, prefill_free[pi])
            pf_time = w.prefill_tokens_per_turn / prefill_rate
            prefill_free[pi] = start + pf_time
            t = start + pf_time
            # decode: the stream finishes after its own tokens; the SERVER
            # is held longer under static batching (lock-step with the
            # longest of decode_batch co-resident streams).
            di = int(np.argmin(decode_free))
            start = max(t, decode_free[di])
            dec_time = ntok / decode_rate * decode_slowdown
            if s.continuous_batching:
                occupy = dec_time
            else:
                group_max = max([ntok] + [draw_ntok()
                                          for _ in range(s.decode_batch - 1)])
                occupy = group_max / decode_rate * decode_slowdown
            decode_free[di] = start + occupy
            t = start + dec_time
            ideal += pf_time + ntok / decode_rate
        finish_times.append(t)
        ideals.append(ideal)

    ft = np.array(finish_times)
    slow = ft / np.maximum(np.array(ideals), 1e-9)
    return {
        "mean_s": float(ft.mean()),
        "p50_s": float(np.percentile(ft, 50)),
        "p95_s": float(np.percentile(ft, 95)),
        "p99_s": float(np.percentile(ft, 99)),
        "max_s": float(ft.max()),      # the step-stalling straggler
        # per-rollout slowdown vs its zero-queueing ideal: decode-continuity
        # metric — the §3.6.2 'long-horizon samples progress continuously'
        "p99_slowdown": float(np.percentile(slow, 99)),
        "mean_slowdown": float(slow.mean()),
    }
