"""PyTorch port, the speculative round in bf16 against the JAX package.

The reference keeps a slot's ``h_last`` on the host as fp32 and builds the
draft input ``h`` as fp32 (``repro/serving/scheduler.py``, the spec round),
so JAX promotes the MTP head's concat, projection and block to fp32 against
the bf16 weights (``repro/core/mtp.py``: ``mtp_step``).  The port keeps
``h_last`` on the device in the model's dtype.  GLM-5's smoke config with
its MTP head (MLA + DSA + MoE, ``spec_steps=3``) runs here in bf16 through
both ``ContinuousEngine``s from the same weights (fp32 weights rounded to
bf16 once, to nearest even, in both packages):

* the first speculative round's drafts, the port's against JAX's, for
  every active slot, step by step while the drafts so far agree, wherever
  the reference's draft logits have a top-2 margin of at least 1e-3
  (computed from the reference's own draft chain on the round's inputs);
* the engines' greedy tokens, request by request, up to the first position
  where the reference's bf16 logits over the prompt and its tokens have a
  top-2 margin under 1e-3 (past a near-tie bf16 rounding may pick either
  token and the continuations part).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import mtp as jmtp
from repro.layers.common import embed as jembed
from repro.layers.common import logits_from_hidden as jlogits_from_hidden
from repro.models import get_model
from repro.models import transformer as jtfm
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.serving import ContinuousEngine, Request
from repro_torch.serving import speculative as tspec

SPEC = 3
MARGIN = 1e-3
_KW = dict(max_batch=4, block_size=8, num_blocks=48, max_len=64)


def _port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def _workload(vocab):
    rng = np.random.default_rng(11)
    return [(rng.integers(3, vocab, size=k).astype(np.int32), m)
            for k, m in zip((13, 6, 19, 9), (8, 8, 8, 8))]


def _jax_draft_logits(params, cfg, h, tok, pos, n):
    """The reference's ``mtp_draft`` chain, with each step's logits: h
    (B, 1, D) fp32 as its engine builds it."""
    apply_block = lambda p, x, ps: jtfm.apply_block(   # noqa: E731
        p, x, cfg, ps, "global", False, sparse=False)[0]
    h, tok = jnp.asarray(h), jnp.asarray(tok)
    out = []
    for j in range(n):
        e = jembed(params["embed"], tok, cfg)
        h = jmtp.mtp_step(params["mtp"], cfg, h, e, jnp.asarray(pos) + j, j,
                          apply_block)
        lg = jlogits_from_hidden(params["embed"], h, cfg)
        tok = jnp.argmax(lg, axis=-1)
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, axis=1)                       # (B, n, V)


def _margin(lg):
    top = np.sort(lg, axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.fixture(scope="module")
def served():
    jcfg = get_smoke_config("glm5_744b").replace(moe_impl="dense")
    params32, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params32)
    model = from_jax_params(jax.tree.map(np.asarray, params32),
                            _port_cfg(jcfg), device="cpu").to(torch.bfloat16)
    work = _workload(jcfg.vocab_size)

    jeng = JaxEngine(jcfg, params, spec_steps=SPEC, **_KW)
    jrounds, inner = [], jeng._spec_round

    def record(p, h, tok, pos, *rest):
        out = inner(p, h, tok, pos, *rest)
        jrounds.append((np.asarray(h), np.asarray(tok), np.asarray(pos),
                        np.asarray(out[0])))
        return out
    jeng._spec_round = record
    jreqs = [JaxRequest(prompt=p, max_new=m) for p, m in work]
    jeng.serve(jreqs)

    trounds, draft = [], tspec.mtp_draft

    def record_port(m, h, tok, pos, n):
        out = draft(m, h, tok, pos, n)
        trounds.append((h.float().numpy(), tok.numpy(), pos.numpy(),
                        out.numpy()))
        return out
    tspec.mtp_draft = record_port
    try:
        teng = ContinuousEngine(model.cfg, model, spec_steps=SPEC,
                                device="cpu", **_KW)
        treqs = [Request(prompt=p, max_new=m) for p, m in work]
        teng.serve(treqs)
    finally:
        tspec.mtp_draft = draft
    return dict(jcfg=jcfg, params=params, model=model, jrounds=jrounds,
                trounds=trounds,
                jout=[np.asarray(r.out) for r in jreqs],
                tout=[np.asarray(r.out) for r in treqs], work=work)


def test_first_round_drafts_match_jax(served):
    """The port's draft head on the reference's first-round inputs, as the
    port's engine hands them to it (``h`` in the model's dtype), against the
    reference's drafts.  The two engines' trunks round differently in bf16,
    so their ``h_last`` differ by a few bf16 ulps; the head is held on the
    same ``h`` (bf16 values, which the reference widens to fp32)."""
    (jh, jtok, jpos, jdrafts), (_, ttok, tpos, _) = \
        served["jrounds"][0], served["trounds"][0]
    live = np.flatnonzero(jpos[:, 0] > 0)
    assert live.size > 0
    np.testing.assert_array_equal(ttok[live], jtok[live])
    np.testing.assert_array_equal(tpos[live], jpos[live])
    model = served["model"]
    dtype = next(model.parameters()).dtype
    tdrafts = tspec.mtp_draft(
        model, torch.from_numpy(np.array(jh)).to(dtype),
        torch.from_numpy(jtok.astype(np.int32)),
        torch.from_numpy(jpos.astype(np.int32)), SPEC).numpy()
    lg = _jax_draft_logits(served["params"], served["jcfg"], jh, jtok, jpos,
                           SPEC)
    np.testing.assert_array_equal(lg.argmax(-1)[live], jdrafts[live])
    margin = _margin(lg)
    compared = 0
    for i in live:
        for j in range(SPEC):
            if margin[i, j] < MARGIN:
                break
            assert tdrafts[i, j] == jdrafts[i, j], \
                (f"slot {i} draft {j}: port {tdrafts[i, j]} vs JAX "
                 f"{jdrafts[i, j]} (reference margin {margin[i, j]})")
            compared += 1
    assert compared >= live.size


def test_greedy_tokens_match_jax(served):
    params, jcfg = served["params"], served["jcfg"]
    compared = 0
    for (prompt, _), jo, to in zip(served["work"], served["jout"],
                                   served["tout"]):
        toks = np.concatenate([prompt, jo]).astype(np.int32)[None]
        lg = np.asarray(jtfm.logits(params, jnp.asarray(toks), jcfg),
                        np.float32)[0, len(prompt) - 1:-1]
        margin = _margin(lg)
        for t in range(len(jo)):
            if margin[t] < MARGIN:
                break
            assert to[t] == jo[t], (f"token {t}: port {to[t]} vs JAX "
                                    f"{jo[t]} (reference margin "
                                    f"{margin[t]})")
            compared += 1
    assert compared > 0
