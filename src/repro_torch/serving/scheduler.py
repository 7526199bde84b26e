"""Continuous-batching scheduler over the paged KV cache (GLM-5 §3.6).

Port of ``repro.serving.scheduler.ContinuousEngine`` for the dense and MoE
families (GQA or MLA attention, with or without DSA) and the hybrid family
(Mamba-2 layers and one shared attention block).  Iteration-level
scheduling: the engine keeps ``max_batch`` decode slots and, every step,

  1. retires sequences that produced their ``max_new`` tokens, handing
     their KV blocks to the radix prefix cache (or back to the free list
     when the cache is off);
  2. admits waiting requests into free slots once a slot AND blocks for the
     request's whole lifetime are available — aliasing the longest cached
     prefix (refcounted, read-only) and copy-on-write forking a block
     matched only part-way — probing a bounded head-of-line window behind
     a stalled head, and shedding when the pool is wedged;
  3. advances chunked prefills (one ``prefill_chunk`` span per slot);
  4. runs ONE batched decode step for every decoding sequence.

Both phases read the cache blocks in place: decode steps through K1
(``paged_decode_gqa``) or, for MLA, K3 (``paged_decode_mla``), prefill
spans through K2 (``paged_prefill_gqa``) or K4 (``paged_prefill_mla``); a
GQA layer with DSA scores its indexer keys through K5
(``paged_indexer_scores_kernel``) / K6 (``paged_prefill_indexer``) and
attends the top-k tokens it gathers through the table;
``attn_impl="ref"`` switches both phases to the ``paged_view`` gather
oracle.  With the DSA block selector a GQA layer's spans gather the view
on either route and attend through K8 (the reference has no in-place span
for that selector; ``prefill_gather_bytes_saved`` then counts MLA and
token-selector configs only, as the reference's does).  The pool's leaves
are whatever the model's ``init_paged_cache`` builds (``k``/``v`` for GQA,
the latent ``c``/``kr`` for MLA, ``k_idx`` on a DSA layer): the COW fork,
the per-token byte count and the gather-bytes stats walk every leaf.

The hybrid family pages its shared block's KV like everyone else but
carries per-slot Mamba-2 state (the pool's ``ssm`` leaves, ``(L, slots,
...)``): admission zeroes the slot's state, a prefill span threads the one
slot's state through its exact-length span, and a decode step puts back
the state of slots still mid-chunked-prefill (their old rows only).
Recurrent state cannot be recovered from KV blocks, so the prefix cache is
forced off, and speculation is refused (a partial accept cannot roll the
state back); the COW fork and the per-token byte count skip the ``ssm``
leaves.

MTP speculative decode (``spec_steps=n``, GLM-5 §2.1 / Table 2): every
step emits up to ``n + 1`` tokens a slot.  Each slot keeps the trunk
hidden state at its last cached position (``h_last``, from the prefill
span or the last round); the shared MTP head drafts ``n`` tokens from it
(``serving.speculative.mtp_draft``) and ONE batched S = n+1 span
(``transformer.verify_step``, the paged span path at per-row starts)
verifies [pending, drafts], writes their KV and returns every position's
logits and hidden state.  The accept length is 1 + the greedy-matching
draft prefix, the depth capped per slot at ``max_new - len(out) - 1``;
rejected drafts are rolled back by truncating the slot's length
(``_rollback``): their KV stays as dead values in blocks the slot owns
alone, rewritten by the next span before any mask admits them, and the
table's ``ceil(n / block_size)`` extra columns send writes past a slot's
lifetime blocks to the trash block.  Greedy tokens equal those of
``spec_steps=0`` (in fp32; in bf16 a span and a decode step sum in other
orders, so near-ties may differ).  Speculation is greedy-only.
``draft_tokens`` / ``accepted_tokens`` / ``spec_rounds`` and
``rolling_accept_length`` track Table 2's quantity; ``step_token_budget``
holds admission back when live slots × the rolling accept length would
pass the budget.

Logprob capture (the TITO contract of RL rollouts): with
``capture_logprobs=True`` every emitted token's logprob lands in
``Request.out_logprobs``, in the sampling convention (log-softmax of
logits / max(t, 1e-6): greedy tokens carry lp ~= 0), the convention of
``RolloutEngine.generate``, so engine-backed and loop-backed behaviour
logprobs compare in the IS ratios; ``true_logprobs=True`` (which needs
capture) records the model's temperature-1 logprob of every emitted token
instead.  A speculative round under capture moves the (B, n+1, V) verify
logits to the host and gives accepted drafts and the bonus token their
logprobs from them; without capture it moves only their argmax, as the
reference does.

Differences from the reference, all deliberate:

* the pool is a set of preallocated tensors updated IN PLACE (the
  reference threads it through donated jits); the ``compiles`` stat is
  kept for its key and stays 0 — nothing is traced;
* logits cross to the host every step and sampling stays on the host with
  the numpy generator, as in the reference, so greedy ties break alike;
* the host spill tier (``spill=True``, ``serving.spill.HostSpillTier``)
  demotes evicted blocks into pinned host tensors and restores them in
  place on a radix hit; it attaches to prefix-cached engines only, as in
  the reference;
* ``respawn`` (the front-end's supervised restart) releases the dead
  engine's pool before the fresh engine allocates its own, so two pools
  never sit on the card together; the dead engine serves nothing after;
* a slot's ``h_last`` stays on the device in the model's dtype (the
  reference moves it to the host as fp32 every round).
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paging import copy_block_strided
from repro_torch.device import resolve_device
from repro_torch.faults import FaultInjector
from repro_torch.kernels.paged_attention.ops import check_impl
from repro_torch.models import get_model
from repro_torch.obs.metrics import MetricsRegistry, StatsView
from repro_torch.obs.trace import Tracer
from repro_torch.serving.engine import Request, sample_token
from repro_torch.serving.errors import (DeadlineExceeded, EngineOverloaded,
                                        RequestCancelled, RequestShed)
from repro_torch.serving.paged import CacheFull, PagedKVCache, blocks_for
from repro_torch.serving.prefix_cache import PrefixCache


class _Active:
    """One in-flight sequence: its request, blocks, sampling state, and —
    while its prompt is still being chunk-prefilled — the prefill cursor."""
    __slots__ = ("req", "blocks", "out", "lps", "pending", "pending_lp",
                 "row", "pos", "version", "h_last")

    def __init__(self, req: Request, blocks: List[int], row: np.ndarray,
                 pos: int, version: int = 0):
        self.req = req
        self.blocks = blocks
        self.version = version               # weight version at admission
        self.out: List[int] = []
        self.lps: List[float] = []           # logprobs of ``out`` (capture)
        self.pending: Optional[int] = None   # None: prompt not fully prefilled
        self.pending_lp = 0.0
        self.row = row                       # full block-table row
        self.pos = pos                       # next prefill position
        # (D,) trunk hidden at the last CACHED position: the next MTP
        # draft's input (spec_steps only), on the device
        self.h_last: Optional[torch.Tensor] = None


class ContinuousEngine:
    """Paged-KV continuous-batching engine with radix prefix reuse."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 block_size: int = 16, num_blocks: int = 64,
                 max_len: int = 512, seed: int = 0,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 capture_logprobs: bool = False,
                 attn_impl: Optional[str] = None,
                 spec_steps: Optional[int] = None,
                 weight_version: int = 0,
                 true_logprobs: bool = False,
                 step_token_budget: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 max_waiting: Optional[int] = None,
                 admit_hol_window: Optional[int] = None,
                 spill: Optional[bool] = None,
                 spill_blocks: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 device=None):
        if cfg.family not in ("dense", "moe", "hybrid"):
            raise NotImplementedError(
                f"ContinuousEngine supports the transformer and hybrid "
                f"families, got {cfg.family!r} (the static ServingEngine "
                f"serves the ssm family)")
        if spec_steps is None:
            from repro_torch.flags import default_spec_steps
            spec_steps = default_spec_steps()
        if spec_steps < 0:
            raise ValueError(f"spec_steps must be >= 0, got {spec_steps}")
        if spec_steps > 0:
            if cfg.family == "hybrid":
                raise ValueError(
                    "spec_steps > 0 is unsupported for the hybrid family: "
                    "a partial accept cannot roll back recurrent state "
                    "(KV rollback is a length truncation; mamba2 state "
                    "advanced over rejected drafts is unrecoverable)")
            if cfg.mtp is None:
                raise ValueError("spec_steps > 0 needs an MTP head "
                                 "(cfg.mtp is None)")
            if not cfg.mtp.share_params and \
                    spec_steps > cfg.mtp.num_predict:
                raise ValueError(
                    f"spec_steps={spec_steps} exceeds the "
                    f"{cfg.mtp.num_predict} separately-trained MTP layers "
                    f"(share_params=False has no layer to draft beyond)")
        if true_logprobs and not capture_logprobs:
            raise ValueError("true_logprobs=True records per-token logprobs"
                             " and therefore needs capture_logprobs=True")
        if step_token_budget is not None and step_token_budget < 1:
            raise ValueError("step_token_budget must be >= 1, got "
                             f"{step_token_budget}")
        if prefill_chunk is not None and (
                prefill_chunk <= 0 or prefill_chunk % block_size):
            raise ValueError("prefill_chunk must be a positive multiple of "
                             f"block_size, got {prefill_chunk}")
        self.device = resolve_device(device)
        first = next(params.parameters())
        if first.device.type != self.device.type:
            raise ValueError(f"params live on {first.device}, the engine "
                             f"runs on {self.device}")
        self.attn_impl = check_impl("kernel" if attn_impl is None
                                    else attn_impl)
        self.model = get_model(cfg)
        from repro_torch.flags import (admit_steps_window, admit_window,
                                       max_waiting_default, spill_enabled,
                                       trace_enabled)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=trace_enabled())
        self._admit_window = admit_steps_window()
        if max_waiting is None:
            max_waiting = max_waiting_default()
        self.max_waiting = max_waiting if max_waiting > 0 else None
        self.admit_hol_window = admit_window() \
            if admit_hol_window is None else admit_hol_window
        self.faults = FaultInjector.from_env() if faults is None else faults
        self.cfg = cfg
        self.params = params
        self.spec_steps = spec_steps
        self.step_token_budget = step_token_budget
        self.weight_version = weight_version
        self._pending_push: Optional[tuple] = None
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_blocks = max(1, max_len // block_size)   # capacity per seq
        # a verify span writes up to spec_steps positions past a slot's
        # lifetime blocks (the batched span has one shape): the extra
        # columns point at the trash block
        self.table_width = self.max_blocks + -(-spec_steps // block_size)
        self.kv = PagedKVCache(num_blocks, block_size,
                               registry=self.registry, faults=self.faults)
        self.kv.set_version(weight_version)
        # everything a supervisor needs to rebuild this engine after a
        # crash (``respawn``), as RESOLVED values so a respawn does not
        # depend on flags changed since; params and version come from the
        # live state at respawn time
        self._spill_on = spill_enabled() if spill is None else bool(spill)
        self._init_kw = dict(
            max_batch=max_batch, block_size=block_size,
            num_blocks=num_blocks, max_len=max_len, seed=seed,
            prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
            capture_logprobs=capture_logprobs, attn_impl=attn_impl,
            spec_steps=spec_steps, true_logprobs=true_logprobs,
            step_token_budget=step_token_budget,
            max_waiting=0 if self.max_waiting is None else self.max_waiting,
            admit_hol_window=self.admit_hol_window,
            spill=self._spill_on, spill_blocks=spill_blocks,
            device=self.device)
        self.prefill_chunk = prefill_chunk
        self.capture_logprobs = capture_logprobs
        self.true_logprobs = true_logprobs
        self.hybrid = cfg.family == "hybrid"
        # recurrent state is not reconstructible from KV blocks: no reuse
        self.prefix = PrefixCache(self.kv) \
            if (prefix_cache and not self.hybrid) else None
        self.trash = num_blocks          # reserved scratch block: idle slots
        # pool dtype follows the params (bf16 on the card, fp32 for parity)
        per_slot = dict(batch=max_batch) if self.hybrid else {}
        self.pool = self.model.init_paged_cache(cfg, num_blocks + 1,
                                                block_size, first.dtype,
                                                self.device, **per_slot)
        # demote-instead-of-forget: needs the radix tree (entries are keyed
        # by token path) and the pool above (restores write into it), so a
        # hybrid or cache-off engine gets no tier
        self.spill_tier = None
        if self._spill_on and self.prefix is not None:
            from repro_torch.serving.spill import HostSpillTier
            self.spill_tier = HostSpillTier(self,
                                            capacity_blocks=spill_blocks)
            self.spill_tier.attach(self.prefix)
        self.tables = np.full((max_batch, self.table_width), self.trash,
                              np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.slots: List[Optional[_Active]] = [None] * max_batch
        self.waiting: collections.deque = collections.deque()
        self._rng = np.random.default_rng(seed)
        self._stats = StatsView(
            self.registry, "engine",
            ["steps", "prefills", "decode_steps", "decode_tokens",
             "prefill_tokens", "cached_tokens", "cow_forks", "chunk_steps",
             "gather_bytes_saved", "prefill_gather_bytes_saved",
             "weight_pushes",
             # speculative decode: drafted and accepted tokens; rounds are
             # (slot, step) verifications that drafted at least one token
             "draft_tokens", "accepted_tokens", "spec_rounds",
             # admissions deferred by the step-token budget; "compiles" is
             # kept for the reference's key set: nothing is traced
             "budget_deferrals", "compiles",
             "cancels", "deadline_expired", "sheds", "overloads",
             "admit_skips", "request_faults"],
            local={"admit_steps":
                   collections.deque(maxlen=self._admit_window)})
        self._next_rid = 0
        self._push_t0: Optional[float] = None
        self._in_place = self.attn_impl != "ref"
        # the block selector's GQA spans gather the view on either route
        self._prefill_in_place = self._in_place and not (
            cfg.dsa is not None and cfg.dsa.selector == "block"
            and cfg.attention_type != "mla")
        self._token_bytes = self._pool_token_bytes()

    # ------------------------------------------------------------ telemetry
    @property
    def stats(self):
        """The historical stats dict, as a registry-backed ``StatsView``."""
        return self._stats

    @stats.setter
    def stats(self, values) -> None:
        self._stats.reset(values)

    def latency_summary(self) -> dict:
        """Live per-request latency distributions (ms): TTFT, TPOT, total
        latency and queue wait — fixed-bucket histogram summaries."""
        return {name: self.registry.summary(f"engine.{name}")
                for name in ("ttft_ms", "tpot_ms", "latency_ms",
                             "queue_ms")}

    def _kv_leaves(self):
        """Every paged leaf of the pool, (L*stride, bs, *f) with stride =
        num_blocks + 1: not the hybrid's per-slot ``ssm`` state."""
        for name, leaves in self.pool.items():
            if name != "ssm":
                yield from leaves.values()

    def _pool_token_bytes(self) -> int:
        """Bytes of KV state per token position, summed over layers/leaves
        (the recurrent ssm state excluded: it is per slot, never
        gathered)."""
        stride = self.kv.num_blocks + 1
        tot = 0
        for leaf in self._kv_leaves():
            layers = leaf.shape[0] // stride
            tot += layers * int(np.prod(leaf.shape[2:], dtype=np.int64)) \
                * leaf.element_size()
        return tot

    def _device_ints(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _cow(self, src: int, dst: int) -> None:
        """Copy block ``src`` -> ``dst`` in every layer of every leaf, in
        place (the COW fork moves L·block_size rows, not the pool)."""
        stride = self.kv.num_blocks + 1
        for leaf in self._kv_leaves():
            copy_block_strided(leaf, src, dst, stride)

    # ------------------------------------------------------------ scheduler
    def validate(self, req: Request) -> None:
        """Reject requests the engine could never serve (size, sampling)."""
        if self.spec_steps and req.temperature > 0:
            raise ValueError(
                "speculative decoding is greedy-only: acceptance compares "
                "drafts against the model's argmax (submit temperature=0 "
                "requests or build the engine with spec_steps=0)")
        need = len(req.prompt) + req.max_new
        if need > self.max_blocks * self.block_size:
            raise ValueError(
                f"request needs {need} token slots > max_len "
                f"{self.max_blocks * self.block_size}")
        if blocks_for(need, self.block_size) > self.kv.num_blocks:
            raise CacheFull(
                f"request needs {blocks_for(need, self.block_size)} blocks "
                f"> pool capacity {self.kv.num_blocks}")

    def submit(self, req: Request) -> None:
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            self.stats["overloads"] += 1
            raise EngineOverloaded(
                f"waiting queue full ({len(self.waiting)} >= max_waiting "
                f"{self.max_waiting}); retry later or raise "
                f"REPRO_MAX_WAITING")
        self.validate(req)
        req.rid = self._next_rid
        self._next_rid += 1
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.tracer.instant("req.submit", req=req.rid,
                            prompt_tokens=len(req.prompt),
                            max_new=req.max_new)
        self.waiting.append(req)

    # -------------------------------------------------------- weight pushes
    def push_weights(self, params, version: int) -> bool:
        """Hand the engine a new weight snapshot (same module structure and
        dtypes).  Applied at the DRAIN BARRIER: while any sequence is in
        flight the push is deferred — admission pauses, live sequences
        finish under their admitted weights, and the swap happens the
        moment the engine drains.  Returns True when applied immediately."""
        if version < self.weight_version:
            raise ValueError(f"weight versions are monotone: push {version}"
                             f" < current {self.weight_version}")
        pend = self._pending_push
        if pend is not None and version < pend[1]:
            raise ValueError(f"weight versions are monotone: push {version}"
                             f" < pending {pend[1]}")
        self._pending_push = (params, version)
        if self._push_t0 is None:
            self._push_t0 = time.perf_counter()
        self.tracer.instant("push.requested", version=version)
        return self._apply_push_if_drained()

    def _apply_push_if_drained(self) -> bool:
        if self._pending_push is None or \
                any(s is not None for s in self.slots):
            return False
        params, version = self._pending_push
        self._pending_push = None
        self.params = params
        self.weight_version = version
        drain_ms = (time.perf_counter() - self._push_t0) * 1e3 \
            if self._push_t0 is not None else 0.0
        self._push_t0 = None
        self.registry.observe("engine.push_drain_ms", drain_ms)
        self.tracer.instant("push.applied", version=version,
                            drain_ms=drain_ms)
        # cached blocks keep their old stamps: match() refuses them,
        # insert() refreshes hot paths, evict() takes stale blocks first
        self.kv.set_version(version)
        self.stats["weight_pushes"] += 1
        return True

    def serve(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.waiting or any(s is not None for s in self.slots):
            self.step()
        self._apply_push_if_drained()     # push arrived on the last step
        return requests

    def step(self) -> None:
        """One iteration: retire -> apply drained weight push -> admit ->
        chunk prefill -> batched decode."""
        tr = self.tracer
        if tr.enabled:
            tr.begin("engine.step",
                     occupancy=sum(1 for s in self.slots if s is not None),
                     waiting=len(self.waiting),
                     live_tokens=int(self.lengths.sum()),
                     pool_used=self.kv.used_blocks,
                     pool_free=self.kv.free_blocks,
                     phase="spec" if self.spec_steps else "decode")
        if self.faults.enabled:
            if self.faults.fires("slow"):
                time.sleep(self.faults.param("slow", 0.02))
            self.faults.check("step")
        self._expire_deadlines()
        self._retire()
        self._apply_push_if_drained()
        self._admit()
        self._prefill_chunks()
        if self.spec_steps:
            self._spec_decode_active()
        else:
            self._decode_active()
        self.stats["steps"] += 1
        if tr.enabled:
            tr.end("engine.step")
        self.registry.set_gauge(
            "engine.pool_utilization",
            self.kv.used_blocks / self.kv.num_blocks)

    def reset_cache(self) -> None:
        """Drop every cached prefix block and spilled entry (benchmark
        hygiene; a weight push does not need this, see ``push_weights``)."""
        if self.prefix is not None:
            self.prefix.clear()
        if self.spill_tier is not None:
            self.spill_tier.clear()

    @property
    def busy(self) -> bool:
        return bool(self.waiting) or self._pending_push is not None \
            or any(s is not None for s in self.slots)

    @property
    def cached_blocks(self) -> int:
        return self.prefix.cached_blocks if self.prefix is not None else 0

    @property
    def stale_cached_blocks(self) -> int:
        """Cached blocks orphaned by a weight push, awaiting lazy LRU
        reclamation (0 when the prefix cache is off)."""
        return self.prefix.stale_cached_blocks \
            if self.prefix is not None else 0

    @property
    def spilled_blocks(self) -> int:
        """Blocks resident in the host spill tier (0 when spill is off):
        ``cached_blocks + spilled_blocks`` is the prefix cache's capacity
        in effect."""
        return self.spill_tier.spilled_blocks \
            if self.spill_tier is not None else 0

    # --------------------------------------------------------------- retire
    def _retire(self) -> None:
        for i, s in enumerate(self.slots):
            if s is not None and s.pending is not None \
                    and len(s.out) + 1 >= s.req.max_new:
                s.out.append(s.pending)     # final token needs no decode
                s.lps.append(s.pending_lp)
                self._finish(i)

    def _finish(self, i: int) -> None:
        s = self.slots[i]
        assert s.version == self.weight_version, (s.version,
                                                  self.weight_version)
        s.req.out_version = s.version
        s.req.out = np.asarray(s.out[:s.req.max_new], np.int32)
        if self.capture_logprobs:
            s.req.out_logprobs = np.asarray(s.lps[:s.req.max_new],
                                            np.float32)
        s.req.t_finish = time.perf_counter()
        reg = self.registry
        if s.req.t_submit is not None:
            reg.observe("engine.latency_ms",
                        (s.req.t_finish - s.req.t_submit) * 1e3)
            ttft = s.req.ttft_s
            if ttft is not None:
                reg.observe("engine.ttft_ms", ttft * 1e3)
        tpot = s.req.tpot_s
        if tpot is not None and len(s.req.out) > 1:
            reg.observe("engine.tpot_ms", tpot * 1e3)
        self.tracer.instant("req.finished", req=s.req.rid,
                            version=s.version,
                            new_tokens=int(len(s.req.out)))
        if self.prefix is not None:
            # KV exists for the prompt plus every DECODED token (the final
            # sampled token was never forwarded)
            kv_len = int(self.lengths[i])
            toks = list(map(int, s.req.prompt)) + s.out[:kv_len
                                                        - len(s.req.prompt)]
            ncover = blocks_for(kv_len, self.block_size)
            self.prefix.insert(toks[:kv_len], s.blocks[:ncover])
            if s.blocks[ncover:]:
                self.kv.release(s.blocks[ncover:])
        else:
            self.kv.free(s.blocks)
        self.slots[i] = None
        self.tables[i] = self.trash
        self.lengths[i] = 0

    # ------------------------------------------------------ fault tolerance
    _FAIL_KINDS = {"cancelled": ("cancels", "req.cancelled"),
                   "deadline": ("deadline_expired", "req.deadline_expired"),
                   "shed": ("sheds", "req.shed"),
                   "failed": ("request_faults", "req.failed")}

    def _fail_waiting(self, req: Request, error: Exception,
                      status: str) -> None:
        """Terminally fail a request that never reached a slot."""
        req.error = error
        req.status = status
        req.t_finish = time.perf_counter()
        counter, event = self._FAIL_KINDS[status]
        self.stats[counter] += 1
        self.tracer.instant(event, req=req.rid, error=repr(error))

    def _retire_slot_error(self, i: int, error: Exception, status: str,
                           donate: bool) -> None:
        """Retire slot ``i`` mid-flight with a typed error; with
        ``donate`` the KV written so far seeds the radix tree, otherwise
        the blocks are released uncached.  Retirement never leaks."""
        s = self.slots[i]
        req = s.req
        kv_len = int(self.lengths[i]) if s.pending is not None else s.pos
        donate = donate and self.prefix is not None and kv_len > 0 \
            and s.version == self.weight_version
        if donate:
            toks = (list(map(int, req.prompt)) + s.out)[:kv_len]
            ncover = blocks_for(kv_len, self.block_size)
            self.prefix.insert(toks, s.blocks[:ncover])
            if s.blocks[ncover:]:
                self.kv.release(s.blocks[ncover:])
        elif self.prefix is not None:
            self.kv.release(s.blocks)
        else:
            self.kv.free(s.blocks)
        self.slots[i] = None
        self.tables[i] = self.trash
        self.lengths[i] = 0
        req.error = error
        req.status = status
        req.t_finish = time.perf_counter()
        counter, event = self._FAIL_KINDS[status]
        self.stats[counter] += 1
        self.tracer.instant(event, req=req.rid, slot=i, kv_len=kv_len,
                            donated=bool(donate), error=repr(error))

    def _isolate_fault(self, req: Request, error: Exception) -> None:
        """A fault attributable to ONE request kills that request with a
        typed terminal error and leaves the engine serving."""
        slot = next((i for i, s in enumerate(self.slots)
                     if s is not None and s.req is req), None)
        if slot is not None:
            self._retire_slot_error(slot, error, "failed", donate=False)
        else:
            self._fail_waiting(req, error, "failed")

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()

        def expired(r: Request) -> bool:
            return r.deadline_s is not None and r.t_submit is not None \
                and now - r.t_submit > r.deadline_s

        for i, s in enumerate(self.slots):
            if s is not None and expired(s.req):
                self._retire_slot_error(
                    i, DeadlineExceeded(
                        f"request {s.req.rid} exceeded deadline_s="
                        f"{s.req.deadline_s} mid-flight"),
                    "deadline", donate=True)
        for r in [r for r in self.waiting if expired(r)]:
            self.waiting.remove(r)
            self._fail_waiting(
                r, DeadlineExceeded(f"request {r.rid} exceeded deadline_s="
                                    f"{r.deadline_s} while queued"),
                "deadline")

    def cancel(self, rid: int) -> bool:
        """Cancel one request by id, queued or mid-flight (a mid-flight
        cancellation donates its blocks to the prefix cache).  False if the
        rid is unknown or already terminal."""
        for r in self.waiting:
            if r.rid == rid:
                self.waiting.remove(r)
                self._fail_waiting(
                    r, RequestCancelled(f"request {rid} cancelled while "
                                        f"queued"), "cancelled")
                return True
        for i, s in enumerate(self.slots):
            if s is not None and s.req.rid == rid:
                self._retire_slot_error(
                    i, RequestCancelled(f"request {rid} cancelled "
                                        f"mid-flight"),
                    "cancelled", donate=True)
                return True
        return False

    def respawn(self) -> "ContinuousEngine":
        """A FRESH engine with this engine's geometry and policy (the
        supervisor's restart path: pool, block tables and prefix cache are
        rebuilt; in-flight KV died with the crash), over the same
        ``nn.Module`` (no copy of the weights).  Its weights are the newest
        this engine was handed: a push still waiting at the drain barrier
        wins over the running params.  The registry, tracer and fault
        injector are SHARED, so counters, traces and the injection schedule
        run on (a ``crash@3`` clause does not fire again at the new
        engine's step 3).  This engine's pool and slots are released first:
        it is dead, and its pool must not sit on the card beside the new
        one."""
        params, version = (self._pending_push
                           if self._pending_push is not None
                           else (self.params, self.weight_version))
        self.pool = {}
        self.slots = [None] * self.max_batch
        if self.spill_tier is not None:
            self.spill_tier.clear()
        return ContinuousEngine(self.cfg, params, weight_version=version,
                                registry=self.registry, tracer=self.tracer,
                                faults=self.faults, **self._init_kw)

    # ---------------------------------------------------------------- admit
    def _admit(self) -> None:
        if self._pending_push is not None:
            return          # draining toward the weight-push barrier
        while self.waiting and None in self.slots:
            if not self._step_budget_allows():
                self.stats["budget_deferrals"] += 1
                return
            head = self.waiting[0]
            try:
                admitted = self._try_admit(head)
            except Exception as e:
                # attributable to THIS request: isolate it, keep serving
                self.waiting.popleft()
                self._isolate_fault(head, e)
                continue
            if admitted:
                self.waiting.popleft()
                continue
            if self._admit_from_window():
                continue
            self._shed_if_wedged()
            return

    def _admit_from_window(self) -> bool:
        """Out-of-order admission behind a stalled head: try up to
        ``admit_hol_window`` queued requests for one that fits."""
        limit = min(self.admit_hol_window, len(self.waiting) - 1)
        for k in range(1, limit + 1):
            req = self.waiting[k]
            try:
                ok = self._try_admit(req)
            except Exception as e:
                del self.waiting[k]
                self._isolate_fault(req, e)
                return True
            if ok:
                del self.waiting[k]
                self.stats["admit_skips"] += 1
                return True
        return False

    def _shed_if_wedged(self) -> None:
        """Admission failed with an EMPTY engine: shed the deepest-queued
        request with a typed error instead of wedging forever."""
        if any(s is not None for s in self.slots) or not self.waiting:
            return
        req = self.waiting.pop()
        self._fail_waiting(
            req, RequestShed(
                f"pool exhausted with an empty engine "
                f"({self.kv.free_blocks}/{self.kv.num_blocks} blocks free "
                f"after eviction; pinned by sessions?): shed request "
                f"{req.rid} at queue depth {len(self.waiting) + 1}"),
            "shed")

    def _step_budget_allows(self) -> bool:
        """Accept-length-aware slot budgeting (``step_token_budget``): each
        live slot emits up to ``spec_steps + 1`` tokens a step; admission
        projects ``live + 1`` slots at the rolling accept length
        (``spec_steps + 1`` until one is measured) and defers past the
        budget.  The first slot is always admitted."""
        if self.step_token_budget is None:
            return True
        live = sum(1 for s in self.slots if s is not None)
        if live == 0:
            return True
        per_slot = 1.0
        if self.spec_steps:
            est = self.rolling_accept_length
            per_slot = est if est > 0 else float(self.spec_steps + 1)
        return (live + 1) * per_slot <= self.step_token_budget

    def _try_admit(self, req: Request) -> bool:
        if self.faults.enabled:
            self.faults.check("admit", rid=req.rid)
        bs = self.block_size
        plen = len(req.prompt)
        m, mblocks = (self.prefix.match(req.prompt, limit=plen - 1)
                      if self.prefix is not None else (0, []))
        n_full, partial = m // bs, m % bs
        total = blocks_for(plen + req.max_new, bs)
        n_fresh = total - n_full
        try:
            fresh = self.kv.alloc(n_fresh) if n_fresh > 0 else []
        except CacheFull:
            # the match's own refs may pin evictable blocks: retry cold
            if mblocks:
                self.kv.release(mblocks)
                m, mblocks, n_full, partial = 0, [], 0, 0
                try:
                    fresh = self.kv.alloc(total)
                except CacheFull:
                    return False
            else:
                return False
        owned = mblocks + fresh
        installed = False
        try:
            if partial:
                # the match ends inside a shared block: fork it so the
                # suffix write never touches the cached copy
                src, dst = mblocks[-1], fresh[0]
                self._cow(src, dst)
                self.kv.release([src])
                blocks = mblocks[:n_full] + fresh
                owned = blocks
                self.stats["cow_forks"] += 1
            else:
                blocks = mblocks + fresh
            assert all(self.kv.block_version(b) == self.weight_version
                       for b in blocks), "stale block aliased into admission"
            slot = self.slots.index(None)
            row = np.full((self.table_width,), self.trash, np.int32)
            row[:len(blocks)] = blocks
            if self.hybrid:     # a fresh sequence starts from zero state
                for leaf in self.pool["ssm"].values():
                    leaf[:, slot].zero_()
            s = _Active(req, blocks, row, pos=m,
                        version=self.weight_version)
            self.slots[slot] = s
            installed = True
            self.stats["prefills"] += 1
            self.stats["cached_tokens"] += m
            self.stats["prefill_tokens"] += plen - m
            self.stats["admit_steps"].append(self.stats["steps"])
            if req.t_submit is not None:
                self.registry.observe(
                    "engine.queue_ms",
                    (time.perf_counter() - req.t_submit) * 1e3)
            self.tracer.instant("req.admitted", req=req.rid, slot=slot,
                                cached_tokens=m, blocks=len(blocks),
                                version=self.weight_version)
            if self.prefill_chunk is None:
                self._prefill_span(slot, s, span=plen - m)  # whole suffix
        except Exception:
            if not installed:
                self.kv.release(owned)
            raise
        return True

    # ---------------------------------------------------------- prefill
    def _prefill_span(self, slot: int, s: _Active, span: int) -> None:
        """Prefill ``span`` token positions starting at ``s.pos`` (an exact
        span: K2 masks by the start offset); samples the first token and
        installs the decode view on the final span."""
        if self.faults.enabled:
            self.faults.check("prefill", rid=s.req.rid)
        bs = self.block_size
        prompt, plen = s.req.prompt, len(s.req.prompt)
        start = s.pos
        real = min(plen - start, span)
        assert real > 0 and start + real <= self.max_blocks * bs
        toks = self._device_ints(np.asarray(prompt[start:start + real])[None])
        table = self._device_ints(s.row[None])
        starts = self._device_ints(np.asarray([start]))
        # the hybrid threads this slot's recurrent state (views of its rows,
        # updated in place) beside the shared KV pool
        cache = self.pool if not self.hybrid else {
            "ssm": {k: v[:, slot:slot + 1]
                    for k, v in self.pool["ssm"].items()},
            "kv": self.pool["kv"]}
        if self.spec_steps:
            # the same span, with the trunk hidden states the first MTP
            # draft chains from
            logits, hid, _ = self.model.verify_step(
                self.params, toks, cache, starts, block_tables=table,
                paged_impl=self.attn_impl)
        else:
            logits, _ = self.model.prefill(
                self.params, toks, cache, block_tables=table,
                cache_index=starts, paged_impl=self.attn_impl)
        if self._prefill_in_place:
            # traffic the in-place span avoided vs the padded-view gather
            live = ((start + real - 1) // bs + 1) * bs
            self.stats["prefill_gather_bytes_saved"] += \
                (self.table_width * bs - live) * self._token_bytes
        self.tracer.instant("req.prefill", req=s.req.rid, start=start,
                            span=real)
        s.pos = start + real
        if s.pos >= plen:                       # final span: sample token 1
            lg = logits[0, real - 1].float().cpu().numpy()
            s.pending, s.pending_lp = self._sample(lg, s.req.temperature)
            if self.spec_steps:                 # the first draft's input
                s.h_last = hid[0, real - 1]
            self.tables[slot] = s.row
            self.lengths[slot] = plen
            if s.req.t_first is None:           # the TTFT stamp
                s.req.t_first = time.perf_counter()
            self.tracer.instant("req.first_token", req=s.req.rid)

    def _prefill_chunks(self) -> None:
        if self.prefill_chunk is None:
            return
        for i, s in enumerate(self.slots):
            if s is not None and s.pending is None:
                try:
                    self._prefill_span(i, s, span=self.prefill_chunk)
                except Exception as e:
                    # this slot's request alone: retire it (no donation)
                    self._retire_slot_error(i, e, "failed", donate=False)
                    continue
                self.stats["chunk_steps"] += 1

    # ----------------------------------------------------------- decode
    def _decode_active(self) -> None:
        # slots still prefilling present trash rows / length 0; a slot whose
        # pending token completes the request waits for _retire
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.pending is not None
                  and len(s.out) + 1 < s.req.max_new]
        if not active:
            return
        # a decode step must not advance the recurrent state of slots
        # whose prompt is still mid-chunked-prefill: keep their old rows
        held = None
        if self.hybrid:
            prefilling = [i for i, s in enumerate(self.slots)
                          if s is not None and s.pending is None]
            if prefilling:
                rows = torch.tensor(prefilling, device=self.device)
                held = (rows, {k: v.index_select(1, rows)
                               for k, v in self.pool["ssm"].items()})
        tok = np.zeros((self.max_batch, 1), np.int32)
        for i in active:
            tok[i, 0] = self.slots[i].pending
        logits, _ = self.model.decode_step(
            self.params, self._device_ints(tok), self.pool,
            self._device_ints(self.lengths),
            block_tables=self._device_ints(self.tables),
            paged_impl=self.attn_impl)
        if held is not None:
            rows, old = held
            for k, v in self.pool["ssm"].items():
                v.index_copy_(1, rows, old[k])
        if self._in_place:
            # traffic the in-place decode avoided vs the full-view gather:
            # the kernel reads each row's live blocks; the plain version
            # (CPU tensors) runs every row to the batch's longest
            bs = self.block_size
            if self.device.type == "cpu":
                live = self.max_batch * (int(max(self.lengths)) // bs + 1) \
                    * bs
            else:
                live = sum(int(l) // bs + 1 for l in self.lengths) * bs
            view = self.max_batch * self.max_blocks * bs
            self.stats["gather_bytes_saved"] += \
                (view - live) * self._token_bytes
        lg = logits[:, 0].float().cpu().numpy()
        for i in active:
            s = self.slots[i]
            s.out.append(s.pending)
            s.lps.append(s.pending_lp)
            self.lengths[i] += 1            # pending now lives in the cache
            s.pending, s.pending_lp = self._sample(lg[i], s.req.temperature)
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(active)

    # ------------------------------------------------------- speculative
    @property
    def rolling_accept_length(self) -> float:
        """Mean accepted tokens a speculative round so far (Table 2's accept
        length; 1.0 = every draft rejected, spec_steps + 1 = all accepted).
        Rounds near a request's budget cap draft fewer tokens (never none),
        slightly deflating the mean."""
        r = self.stats["spec_rounds"]
        return self.stats["accepted_tokens"] / r if r else 0.0

    def _spec_decode_active(self) -> None:
        """One speculative round for every decoding slot: the MTP head
        drafts ``n`` tokens a slot, [pending, drafts] is verified as ONE
        batched S = n+1 span, the greedy-matching prefix is accepted and
        the rest rolled back.  A slot's draft depth is capped at
        ``max_new - len(out) - 1`` (deeper accepts could not be emitted),
        which keeps every trusted verify position inside its lifetime
        blocks; the span still runs at full width, a capped slot's deeper
        writes land in its own dead tail or the trash columns, and their
        logits are never read."""
        from repro_torch.serving.speculative import mtp_draft
        n = self.spec_steps
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.pending is not None
                  and len(s.out) + 1 < s.req.max_new]
        if not active:
            return
        dtype = next(self.params.parameters()).dtype
        h = torch.zeros((self.max_batch, 1, self.cfg.d_model), dtype=dtype,
                        device=self.device)
        tok = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch, 1), np.int32)
        for i in active:
            s = self.slots[i]
            h[i, 0] = s.h_last
            tok[i, 0] = s.pending
            pos[i, 0] = self.lengths[i] - 1      # h_last's position
        tok_d = self._device_ints(tok)
        with torch.no_grad():
            drafts = mtp_draft(self.params, h, tok_d, self._device_ints(pos),
                               n).to(torch.int32)
        logits, hid, _ = self.model.verify_step(
            self.params, torch.cat([tok_d, drafts], dim=1), self.pool,
            self._device_ints(self.lengths),
            block_tables=self._device_ints(self.tables),
            paged_impl=self.attn_impl)
        if self._prefill_in_place:
            # the span reads each row's blocks in place; the gather would
            # move the whole padded view (post-span coverage a row)
            bs = self.block_size
            live = sum((int(l) + n) // bs + 1 for l in self.lengths) * bs
            self.stats["prefill_gather_bytes_saved"] += \
                max(0, self.max_batch * self.table_width * bs - live) \
                * self._token_bytes
        verify = logits.argmax(-1).cpu().numpy()            # (B, n+1)
        drafts = drafts.cpu().numpy()                       # (B, n)
        # full-vocab logits cross to the host ONLY for logprob capture
        lg = logits.float().cpu().numpy() if self.capture_logprobs else None
        for i in active:
            s = self.slots[i]
            L = int(self.lengths[i])
            n_i = min(n, s.req.max_new - len(s.out) - 1)
            matches = 0
            while matches < n_i and drafts[i, matches] == verify[i, matches]:
                matches += 1
            acc = 1 + matches
            s.out.append(s.pending)             # the guaranteed token
            s.lps.append(s.pending_lp)
            for j in range(1, acc):             # accepted draft tokens
                s.out.append(int(drafts[i, j - 1]))
                s.lps.append(self._sample(lg[i, j - 1],
                                          s.req.temperature)[1]
                             if self.capture_logprobs else 0.0)
            self._rollback(i, s, L + acc)
            # the bonus token: the model's own choice after the accept point
            if self.capture_logprobs:
                s.pending, s.pending_lp = self._sample(lg[i, acc - 1],
                                                       s.req.temperature)
            else:
                s.pending, s.pending_lp = int(verify[i, acc - 1]), 0.0
            s.h_last = hid[i, acc - 1]
            # the active filter guarantees len(out) + 1 < max_new, so every
            # processed slot drafted at least one token
            assert n_i >= 1, (i, n_i)
            self.stats["spec_rounds"] += 1
            self.stats["draft_tokens"] += n_i
            self.stats["accepted_tokens"] += acc
            self.stats["decode_tokens"] += acc
            self.tracer.instant("req.spec_round", req=s.req.rid,
                                drafted=n_i, accepted=acc)
        self.stats["decode_steps"] += 1

    def _rollback(self, i: int, s: _Active, new_len: int) -> None:
        """Roll rejected drafts out of the paged cache: truncate the slot's
        length to the accept point.  No block changes hands: admission
        allocated the request's whole lifetime, the draft-depth cap keeps
        every trusted position inside it and the extra table columns route
        deeper writes to trash, so refcounts and COW state are untouched;
        rejected positions' KV stays as dead values in blocks the slot owns
        alone (the next span rewrites them before any mask admits them),
        and ``_finish`` hands the prefix cache only the blocks covering the
        truncated length."""
        assert new_len <= len(s.blocks) * self.block_size, \
            (new_len, len(s.blocks))
        self.lengths[i] = new_len

    # ----------------------------------------------------------- sampling
    def _sample(self, row: np.ndarray, temperature: float):
        """(token, its logprob): 0.0 without capture; with
        ``true_logprobs`` the model's temperature-1 logprob; else the
        sampling convention, log-softmax of row / max(t, 1e-6) (greedy
        tokens carry lp ~= 0), as ``RolloutEngine.generate`` records."""
        tok = sample_token(row, temperature, self._rng)
        if not self.capture_logprobs:
            return tok, 0.0
        z = row - row.max()
        if not self.true_logprobs:
            z = z / max(temperature, 1e-6)
        return tok, float(z[tok] - np.log(np.exp(z).sum()))
