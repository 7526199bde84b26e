"""Weights carried across from the JAX package.

``from_jax_params`` takes the reference's parameter pytree — nested dicts
of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` of
``repro.models.get_model(cfg).init(key, cfg)[0]`` — and returns the port's
model (``Transformer`` for families ``dense``, ``moe`` and ``vlm``,
``SSMModel`` for ``ssm``, ``HybridModel`` for ``hybrid``, ``EncDecModel``
for ``audio``) holding the same weights.  The reference's ssm and hybrid
models stack every layer leaf on a leading ``layers`` axis
(``stack_init``): layer ``i`` of the port takes index ``i`` of
``params["layers"][...]``; the hybrid's ``shared_attn`` block and
``final_norm`` are read as they are.  The encoder-decoder stacks its
``encoder`` and ``decoder`` trees the same way: the port's
``encoder.i`` / ``decoder.i`` take index ``i`` of them; ``enc_pos``,
``enc_final_norm`` and ``final_norm`` are read as they are.  Its transformer stacks every
pattern slot ``slotJ`` on a leading ``n_groups`` axis for its layer scan;
layer ``first_k_dense + g*P + j`` of the port takes index ``g`` of
``slotJ`` (an MoE slot's expert tensors are ``(n_groups, E, in, out)``, so
index ``g`` leaves the port's ``(E, in, out)``).  MLA, MoE and DSA-indexer
leaves (``idx``: ``wq_idx``, ``wk_idx``, ``w_head``) keep the reference's
names, and so does the MTP head (``mtp``: ``h_norm``, ``e_norm``,
``proj`` and its block, indexer included).  Both packages keep matrices
as (in, out) and
compute ``x @ W``, so no weight is transposed.  This module never imports
JAX: it only reads numpy arrays.

``gdn_from_jax_params`` does the same for one GDN / SimpleGDN layer of the
reference's ablation (``repro.layers.gdn.build_gdn``'s flat dict of
leaves; ``layers.gdn.GDN`` keeps its names).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.gdn import GDN
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.hybrid import HybridModel
from repro_torch.models.ssm_model import SSMModel
from repro_torch.models.transformer import Transformer

_MODEL = {"ssm": SSMModel, "hybrid": HybridModel, "audio": EncDecModel}
_STACKED = ("encoder", "decoder")     # the encoder-decoder's layer stacks


def _jax_leaf(params, cfg: ModelConfig, key: str) -> np.ndarray:
    parts = key.split(".")
    if parts[0] in _STACKED:
        node = params[parts[0]]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    if parts[0] != "layers":
        node = params
        for p in parts:
            node = node[p]
        return np.asarray(node)
    i, rest = int(parts[1]), parts[2:]
    g = None
    if cfg.family in _MODEL:
        node, g = params["layers"], i
    elif i < cfg.first_k_dense:
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
                    dtype=torch.float32) -> torch.nn.Module:
    """The reference's parameters as the port's model on ``device``."""
    cls = _MODEL.get(cfg.family, Transformer)
    model = cls(cfg, device=resolve_device(device), dtype=dtype)
    state = {k: torch.tensor(_jax_leaf(params_np, cfg, k))
             for k in model.state_dict()}
    # every reference weight must land somewhere: a leaf the port has no
    # home for would otherwise be dropped silently
    n_port = sum(t.numel() for t in state.values())
    n_ref = _n_elements(params_np)
    if n_port != n_ref:
        raise ValueError(f"the reference tree holds {n_ref} weights, the "
                         f"port's model takes {n_port}")
    model.load_state_dict(state, strict=True)
    return model


def gdn_from_jax_params(params_np: dict, cfg: ModelConfig,
                        simple: bool = False, device=None,
                        dtype=torch.float32) -> GDN:
    """The reference's GDN (``simple``: SimpleGDN) leaves as the port's
    layer on ``device``."""
    layer = GDN(cfg, simple, device=resolve_device(device), dtype=dtype)
    state = {k: torch.tensor(np.asarray(params_np[k]))
             for k in layer.state_dict()}
    n_port = sum(t.numel() for t in state.values())
    n_ref = _n_elements(params_np)
    if n_port != n_ref:
        raise ValueError(f"the reference layer holds {n_ref} weights, the "
                         f"port's takes {n_port}")
    layer.load_state_dict(state, strict=True)
    return layer
