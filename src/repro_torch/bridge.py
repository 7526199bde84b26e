"""Weights carried across from the JAX package.

``from_jax_params`` takes the reference's parameter pytree — nested dicts
of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` of
``repro.models.get_model(cfg).init(key, cfg)[0]`` — and returns the port's
``Transformer`` holding the same weights.  The reference stacks every
pattern slot ``slotJ`` on a leading ``n_groups`` axis for its layer scan;
layer ``first_k_dense + g*P + j`` of the port takes index ``g`` of
``slotJ``.  Both packages keep matrices as (in, out) and compute
``x @ W``, so no weight is transposed.  This module never imports JAX: it
only reads numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


def _jax_leaf(params, cfg: ModelConfig, key: str) -> np.ndarray:
    parts = key.split(".")
    if parts[0] != "layers":
        node = params
        for p in parts:
            node = node[p]
        return np.asarray(node)
    i, rest = int(parts[1]), parts[2:]
    g = None
    if i < cfg.first_k_dense:
        node = params[f"dense_{i}"]
    else:
        g, j = divmod(i - cfg.first_k_dense, len(cfg.attention_pattern))
        node = params[f"slot{j}"]
    for p in rest:
        node = node[p]
    node = np.asarray(node)
    return node if g is None else node[g]


def _n_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_elements(v) for v in tree.values())
    return int(np.asarray(tree).size)


def from_jax_params(params_np: dict, cfg: ModelConfig, device=None,
                    dtype=torch.float32) -> Transformer:
    """The reference's parameters as the port's model on ``device``."""
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype)
    state = {k: torch.tensor(_jax_leaf(params_np, cfg, k))
             for k in model.state_dict()}
    # every reference weight must land somewhere: a leaf the port has no
    # home for (an indexer, an MTP head) would otherwise be dropped silently
    n_port = sum(t.numel() for t in state.values())
    n_ref = _n_elements(params_np)
    if n_port != n_ref:
        raise ValueError(f"the reference tree holds {n_ref} weights, the "
                         f"port's model takes {n_port}")
    model.load_state_dict(state, strict=True)
    return model
