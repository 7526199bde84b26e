"""MTP speculative decoding and the accept-length measurement (GLM-5
Table 2).

Port of ``repro.serving.speculative``.  The MTP layer is the draft model:
from the trunk hidden state at the current position it proposes ``n``
future tokens, feeding its own drafts back in (why the paper's parameter
sharing matters: a layer trained on step-1 inputs alone sees its step-2/3
inputs out of distribution).  The full model verifies the drafts; the
accept length is 1 + the greedy-matching prefix.

Two verification paths:

* ``impl="paged"`` (default), the serving path: the prompt is prefilled
  once into a paged block pool and every round verifies only the ``n``
  drafts as an S = n span at per-row starts through the paged span path
  (K2 / K4, and K6 on a GQA + DSA layer), as ``ContinuousEngine(
  spec_steps=...)`` does every step;
* ``impl="ref"``, the oracle: the whole model over prefix + drafts every
  round (O(prefix²) over a decode), kept to check the paged path.

As in the reference, the head's block and the trunk here run dense
(``sparse=False``); the engine's rounds use the model's default.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import mtp as mtp_mod
from repro_torch.layers.common import embed, logits_from_hidden
from repro_torch.models import transformer as T
from repro_torch.serving.paged import blocks_for


@torch.no_grad()
def mtp_draft(model: T.Transformer, h_last: torch.Tensor,
              last_token: torch.Tensor, positions: torch.Tensor, n: int
              ) -> torch.Tensor:
    """h_last (B, 1, D) the trunk hidden at the last accepted position,
    last_token (B, 1), positions (B, 1) h_last's.  Returns the greedy
    drafts (B, n) int64."""
    cfg = model.cfg

    def apply_block(blk, x, pos):
        return T.apply_block(blk, x, cfg, pos, sparse=False)[0]

    h, tok, drafts = h_last, last_token, []
    for j in range(n):
        e = embed(model.embed, tok, cfg)
        h = mtp_mod.mtp_step(model.mtp, cfg, h, e, positions + j, j,
                             apply_block)
        tok = logits_from_hidden(model.embed, h, cfg).argmax(-1)
        drafts.append(tok[:, 0])
    return torch.stack(drafts, dim=1)


@torch.no_grad()
def verify_and_accept(model: T.Transformer, prefix: torch.Tensor,
                      drafts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``impl="ref"`` oracle's verification: the whole model over
    prefix + drafts.  Returns (accept_len (B,), the model's greedy token
    at each draft slot (B, n))."""
    n = drafts.shape[1]
    toks = torch.cat([prefix, drafts.to(prefix.dtype)], dim=1)
    logits = T.logits(model, toks, sparse=False)
    P = prefix.shape[1]
    # the greedy choice for draft slot j comes from position P-1+j
    verify = logits[:, P - 1:P - 1 + n].argmax(-1)
    return mtp_mod.speculative_accept_length(drafts, verify), verify


@torch.no_grad()
def _measure_ref(model: T.Transformer, prompts: torch.Tensor,
                 n_steps: int) -> Dict[str, object]:
    """The oracle loop: the full ``hidden`` and a full verification every
    round.  As in the engine (and MTP training), the model's greedy next
    token comes first, then the head chains ``n`` drafts from (trunk hidden
    at the last position, embedding of that next token); each round splices
    [next, verify tokens] (teacher-forced on the drafts)."""
    cfg = model.cfg
    B, P = prompts.shape
    n = cfg.mtp.num_predict
    toks = prompts
    total = 0.0
    for _ in range(n_steps):
        h, _, _ = T.hidden(model, toks, sparse=False)
        last_h = h[:, -1:]
        nxt = logits_from_hidden(model.embed, last_h, cfg).argmax(-1) \
            .to(toks.dtype)                                     # (B, 1)
        positions = torch.full((B, 1), toks.shape[1] - 1,
                               device=toks.device)
        drafts = mtp_draft(model, last_h, nxt, positions, n)
        acc, verify = verify_and_accept(model, torch.cat([toks, nxt], 1),
                                        drafts)
        total += float(acc.float().mean())
        toks = torch.cat([toks, nxt, verify.to(toks.dtype)], dim=1)
    return {"accept_length": total / n_steps, "speculative_steps": n,
            "tokens": toks[:, P:].cpu().numpy().astype(np.int32)}


@torch.no_grad()
def _measure_paged(model: T.Transformer, prompts: torch.Tensor,
                   n_steps: int, block_size: int,
                   attn_impl: str) -> Dict[str, object]:
    """Incremental verification over a paged pool: prefill once, then each
    round (a) verify the n drafts as an S = n+1 span [next, drafts] at the
    live length, (b) splice the round's verify tokens by forwarding
    [next, verify] over the same positions (overwriting rejected drafts'
    KV), which also gives the next round's trunk hidden and last logits."""
    cfg = model.cfg
    dev = prompts.device
    B, P = prompts.shape
    n = cfg.mtp.num_predict
    mb = blocks_for(P + n_steps * (n + 1), block_size)
    pool = T.init_paged_cache(cfg, B * mb + 1, block_size,
                              next(model.parameters()).dtype, dev)
    tables = torch.arange(B * mb, dtype=torch.int32,
                          device=dev).reshape(B, mb)

    def span(toks, lens):
        lg, h, _ = T.verify_step(model, toks, pool, lens, sparse=False,
                                 block_tables=tables, paged_impl=attn_impl)
        return lg, h

    logits, h = span(prompts, torch.zeros((B,), dtype=torch.int32,
                                          device=dev))
    last_logits, h_last, L = logits[:, -1], h[:, -1:], P
    total, out = 0.0, []
    for _ in range(n_steps):
        # the engine's protocol: "pending" = the model's greedy next token,
        # drafts chain from (h_last, emb(pending)), the training pairing
        nxt = last_logits.argmax(-1)[:, None]
        drafts = mtp_draft(model, h_last, nxt,
                           torch.full((B, 1), L - 1, device=dev), n)
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        lg_d, _ = span(torch.cat([nxt, drafts], 1), lens)
        # the greedy choice for draft slot j comes from span position j
        verify = lg_d[:, :n].argmax(-1)
        total += float(mtp_mod.speculative_accept_length(drafts, verify)
                       .float().mean())
        splice = torch.cat([nxt, verify], dim=1)
        lg_v, h_v = span(splice, lens)
        last_logits, h_last = lg_v[:, -1], h_v[:, -1:]
        L += n + 1
        out.append(splice.cpu().numpy().astype(np.int32))
    return {"accept_length": total / n_steps, "speculative_steps": n,
            "tokens": np.concatenate(out, axis=1)}


def measure_accept_length(model: T.Transformer, prompts: torch.Tensor, *,
                          n_steps: int = 8, impl: str = "paged",
                          block_size: int = 16,
                          attn_impl: str = "kernel") -> Dict[str, object]:
    """Mean accept length over a batch of prompts (B, P), ``n_steps``
    speculative rounds each, greedy everywhere.  ``impl="paged"`` verifies
    through the paged span path (``attn_impl``: ``"kernel"``, or ``"ref"``
    for the gather oracle), ``impl="ref"`` re-runs the whole model.  Both
    return the spliced verify tokens under ``"tokens"``, equal between the
    two.  These are the model's greedy choices TEACHER-FORCED on each
    round's drafts, not the free-running greedy rollout unless every draft
    accepts (the engine, which re-anchors at the accept point every round,
    is the rollout)."""
    if impl == "ref":
        return _measure_ref(model, prompts, n_steps)
    if impl != "paged":
        raise ValueError(f"impl must be 'paged' or 'ref', got {impl!r}")
    return _measure_paged(model, prompts, n_steps, block_size, attn_impl)
