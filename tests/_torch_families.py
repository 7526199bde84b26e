"""Shared setup of the port's serving-layer tests (``test_torch_frontend``,
``test_torch_fault_tolerance``, ``test_torch_spill``,
``test_torch_pd_disagg``): the reference tests' small family configs, the
JAX weights, and the port's model carrying the same weights
(``repro_torch.bridge.from_jax_params``), fp32 on the CPU.

Cross-framework token equality is claimed only where every generated
position's top-2 logit margin (teacher-forced through the port's model) is
at least ``MARGIN``: ``margin_ok`` decides which requests are compared.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DSAConfig, MTPConfig
from repro.models import get_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.models import get_model as port_model

MARGIN = 1e-4
MTP = MTPConfig(num_predict=3, share_params=True)


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def family_cfg(name: str, mtp: bool = False):
    """The reference serving tests' ``_family_cfg``: gqa / dsa (Yi smoke,
    2 heads of 32, vocab 256), mla (GLM-5 smoke without experts, one
    dense-MLP layer first), hybrid (zamba2 smoke, N 8); ``mtp`` adds the
    shared 3-step MTP head of ``test_async_frontend.py``."""
    head = MTP if mtp else None
    if name in ("gqa", "dsa"):
        return get_smoke_config("yi_6b").replace(
            d_model=128, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab_size=256, mtp=head,
            dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=32,
                          block_size=16) if name == "dsa" else None)
    if name == "hybrid":
        return get_smoke_config("zamba2_2p7b").replace(
            d_model=128, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab_size=256, ssm_state=8, dsa=None)
    return get_smoke_config("glm5_744b").replace(            # mla
        d_model=128, num_heads=2, num_kv_heads=2, d_ff=256,
        vocab_size=256, num_experts=0, num_shared_experts=0,
        first_k_dense=1, mtp=head)


@functools.lru_cache(maxsize=None)
def family(name: str, mtp: bool = False):
    """(JAX cfg, JAX params, the port's model with the same weights)."""
    jcfg = family_cfg(name, mtp)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    return jcfg, params, model


def margin_ok(model, prompt, out, margin: float = MARGIN) -> bool:
    """Every position that chose ``out`` has a top-2 logit margin of at
    least ``margin`` under teacher forcing (the port's full forward)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(out)[:-1]])
    with torch.no_grad():
        lg = port_model(model.cfg).logits(
            model, torch.from_numpy(seq.astype(np.int64))[None])[0]
    top2 = lg[len(prompt) - 1:].topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= margin).all())


def assert_tokens_match(model, prompts, port_outs, ref_outs) -> int:
    """Port tokens equal the reference's wherever the margin holds; returns
    how many requests were compared (at least one, or the check is void)."""
    compared = 0
    for p, a, b in zip(prompts, port_outs, ref_outs):
        if margin_ok(model, p, b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            compared += 1
    assert compared > 0, "no request had a top-2 margin to compare"
    return compared
