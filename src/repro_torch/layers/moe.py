"""Mixture-of-Experts FFN: routed top-k experts + shared expert, and the
reference's capacity-bounded expert-parallel path.

Port of ``repro.layers.moe``.  The router is a softmax over
``num_experts`` in fp32, top-k with the gates renormalized to sum to 1,
plus the Switch-style load-balance auxiliary loss.  Three paths compute
the experts' part:

* ``_routed`` (``moe_impl`` ``auto`` off an EP mesh, and ``dense``): the
  reference's ``_moe_dense`` function (every token's k selected expert
  outputs, weighted by their gates and summed in top-k order), computing
  only the (token, expert) pairs the router chose: the tokens of each
  chosen expert are grouped and run through that expert's SwiGLU as one
  matrix product.  It reads the per-expert counts back to the host and
  loops over the chosen experts in Python.
* ``_moe_dense``: all experts on all tokens, the reference's oracle (32x
  the routed work at 256 experts); the tests hold the other two to it.
* the expert-parallel path (``moe_impl="expert_parallel"``, or ``auto``
  on a mesh whose 'model' axis is larger than 1 and divides the experts:
  the reference's ``use_ep`` rule): each 'model' rank takes its experts'
  tokens with the capacity-bounded, sort-free dispatch (one-hot, cumsum,
  slot, trash row; ``_dispatch_local``), runs them as one batched product
  (E_local, C, D), and the partial outputs are summed over 'model'.  It
  has fixed shapes and reads nothing back to the host.  An expert takes
  at most ``capacity = ceil(T k / E * capacity_factor)`` tokens; later
  assignments, in token-major order, are dropped, as in the reference.

The reference's combine adds each slot's weighted output into its token's
row (``y.at[tok].add``); on the card an ``index_add_`` adds with atomics,
so a token's terms would be summed in another order from run to run.  The
port's combine is a gather instead: each (token, k) assignment reads its
slot's weighted output (a zero row where it was dropped), and a token's k
terms are summed in top-k order, fp32, the same order every run.

On one rank (the host mesh, or no mesh with ``expert_parallel``) the
rank holds every expert, ``E_local = E``; the sum over 'model' is a real
collective on the mesh's 'model' group and ``aux`` is averaged over the
batch axes (the reference's ``psum`` / ``pmean``).  A mesh of more than
one rank raises ``NotImplementedError``: the sharded step is not ported.

Ties in the router: ``jax.lax.top_k`` puts the lower expert index first
among equal probabilities; ``torch.topk`` promises no order, so the port
ranks with a stable descending sort, which keeps index order among equals.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import _empty
from repro_torch.sharding.rules import mesh_axes

ROUTER_SCALE = 0.02     # the reference's explicit init scale for ``router``


class MoE(nn.Module):
    """Router, stacked expert weights (E, in, out) and the shared expert."""

    AXES = {"router": ("embed", None),
            "w_gate": ("experts", "embed_fsdp", "moe_mlp"),
            "w_up": ("experts", "embed_fsdp", "moe_mlp"),
            "w_down": ("experts", "moe_mlp", "embed_fsdp"),
            "ws_gate": ("embed_fsdp", "mlp"), "ws_up": ("embed_fsdp", "mlp"),
            "ws_down": ("mlp", "embed_fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = _empty(D, E, **kw)
        self.w_gate = _empty(E, D, Fe, **kw)
        self.w_up = _empty(E, D, Fe, **kw)
        self.w_down = _empty(E, Fe, D, **kw)
        if cfg.num_shared_experts:
            Fs = Fe * cfg.num_shared_experts
            self.ws_gate = _empty(D, Fs, **kw)
            self.ws_up = _empty(D, Fs, **kw)
            self.ws_down = _empty(Fs, D, **kw)


def router_topk(params: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D) -> gates (T, k) fp32, expert ids (T, k) int64, aux loss.

    Experts are ranked by probability, the lower id first among equals."""
    logits = x.float() @ params.router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, idx = order.values[:, :k], order.indices[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: E * sum_e f_e * p_e
    E = cfg.num_experts
    me = probs.mean(0)
    one_hot = F.one_hot(idx, E).float().sum(1)           # (T, E)
    ce = one_hot.mean(0) / k
    aux = E * (me * ce).sum()
    return gates, idx, aux


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, x: torch.Tensor,
                activation: str) -> torch.Tensor:
    """x (C, D) through one expert, or (E, C, D) through E experts at
    once (stacked weights, a batched product): returns x's shape."""
    h = x @ w_up
    if activation == "swiglu":
        h = F.silu(x @ w_gate) * h
    elif activation == "relu2":
        h = F.relu(h).square()
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ w_down


def _routed(params: MoE, x2d: torch.Tensor, gates: torch.Tensor,
            idx: torch.Tensor, activation: str) -> torch.Tensor:
    """Sum over each token's k chosen experts of gate * expert(x), running
    each chosen expert once on the tokens routed to it.  The k outputs of a
    token are summed in top-k order, as the reference sums them."""
    T, k = idx.shape
    flat = idx.reshape(-1)                       # (T*k,) slot t*k + j
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=params.w_up.shape[0])
    sel = torch.empty((T * k, x2d.shape[1]), dtype=x2d.dtype,
                      device=x2d.device)
    at = 0
    # one host read of the per-expert counts decides the loop
    for e, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        slots = order[at:at + n]
        at += n
        sel[slots] = _expert_ffn(params.w_gate[e], params.w_up[e],
                                 params.w_down[e], x2d[slots // k],
                                 activation)
    sel = sel.reshape(T, k, -1)
    return (sel * gates[..., None].to(sel.dtype)).sum(1)


def _moe_dense(params: MoE, x2d: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle path: run all experts on all tokens (small E only)."""
    gates, idx, aux = router_topk(params, x2d, cfg)
    T, D = x2d.shape
    outs = _expert_ffn(params.w_gate, params.w_up, params.w_down,
                       x2d.expand(cfg.num_experts, T, D),
                       cfg.mlp_activation)                      # (E, T, D)
    sel = outs.transpose(0, 1).gather(
        1, idx[..., None].expand(T, idx.shape[1], D))           # (T, k, D)
    y = (sel * gates[..., None].to(sel.dtype)).sum(1)
    return y.to(x2d.dtype), aux


def _dispatch_local(idx: torch.Tensor, gates: torch.Tensor, T: int,
                    e_lo: int, E_local: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch for the experts in [e_lo, e_lo+E_local).

    Returns (token_gather_idx (E_local, C), slot_gate (E_local, C), dest
    (T*k,)): the token in each expert's slot (T, a zero row, where empty)
    and its gate, and the flat slot each (token, k) assignment went to
    (E_local * C, the trash row, where it is not local or was dropped).
    An assignment's slot is the number of earlier assignments, in
    token-major order, to its expert; past ``capacity`` it is dropped."""
    k = idx.shape[1]
    flat_e = idx.reshape(-1)                     # (T*k,)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=idx.device).repeat_interleave(k)
    local = (flat_e >= e_lo) & (flat_e < e_lo + E_local)
    le = torch.where(local, flat_e - e_lo, E_local)   # E_local = trash row
    # position of each assignment within its expert (stable order)
    onehot = F.one_hot(le, E_local + 1).int()         # (Tk, El+1)
    pos = onehot.cumsum(0) * onehot
    slot = pos.sum(-1) - 1                        # (Tk,) 0-based within expert
    ok = local & (slot < capacity)
    dest = torch.where(ok, le * capacity + slot, E_local * capacity)
    # every assignment that is not placed writes the trash row, all with
    # the same value (T, gate 0): the duplicates are harmless, the row is
    # cut off
    gather_tok = torch.full((E_local * capacity + 1,), T, dtype=torch.long,
                            device=idx.device)
    gather_tok[dest] = torch.where(ok, flat_t, T)
    gate_buf = flat_g.new_zeros(E_local * capacity + 1)
    gate_buf[dest] = torch.where(ok, flat_g, 0.0)
    return (gather_tok[:-1].reshape(E_local, capacity),
            gate_buf[:-1].reshape(E_local, capacity), dest)


def _moe_ep_shard(params: MoE, x2d: torch.Tensor, cfg: ModelConfig,
                  e_lo: int, E_local: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 'model' rank's part: x2d (T, D) -> (this rank's experts' sum of
    each token's weighted outputs (T, D) fp32, aux)."""
    T, D = x2d.shape
    gates, idx, aux = router_topk(params, x2d, cfg)
    capacity = max(1, int(math.ceil(
        T * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)))
    tok_idx, slot_gate, dest = _dispatch_local(idx, gates, T, e_lo, E_local,
                                               capacity)
    x_pad = torch.cat([x2d, x2d.new_zeros(1, D)])
    xe = x_pad[tok_idx]                                   # (E_local, C, D)
    experts = slice(e_lo, e_lo + E_local)
    ye = _expert_ffn(params.w_gate[experts], params.w_up[experts],
                     params.w_down[experts], xe, cfg.mlp_activation)
    weighted = (ye * slot_gate[..., None].to(ye.dtype)).reshape(-1, D)
    weighted = torch.cat([weighted.float(), x2d.new_zeros(
        1, D, dtype=torch.float32)])          # the trash row: dropped ones
    # combine: a gather of each assignment's slot, summed in top-k order
    return weighted[dest.reshape(T, -1)].sum(1), aux


def _moe_ep(params: MoE, x2d: torch.Tensor, cfg: ModelConfig,
            mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel path on one rank: every expert local, the sum
    over the mesh's 'model' group, ``aux`` averaged over its batch axes."""
    E = params.w_up.shape[0]
    y, aux = _moe_ep_shard(params, x2d, cfg, 0, E)
    if mesh is not None:
        y = funcol.all_reduce(y, "sum", mesh.get_group("model"))
        for a in ("pod", "data"):
            if a in mesh_axes(mesh):
                g = mesh.get_group(a)
                aux = funcol.all_reduce(aux, "sum", g) / g.size()
    return y.to(x2d.dtype), aux


def _use_ep(cfg: ModelConfig, tokens: int, mesh=None) -> bool:
    """The reference's rule: ``expert_parallel``, or ``auto`` on a mesh
    whose 'model' axis is larger than 1 and divides the experts, and the
    tokens divide over the batch axes."""
    sizes = mesh_axes(mesh) if mesh is not None else {}
    model = sizes.get("model", 1)
    batch = sizes.get("pod", 1) * sizes.get("data", 1)
    return (cfg.moe_impl == "expert_parallel"
            or (cfg.moe_impl == "auto" and "model" in sizes
                and cfg.num_experts % model == 0 and model > 1)) \
        and tokens % batch == 0


def apply_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig, *,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss scalar)."""
    B, S, D = x.shape
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"MoE on a mesh of {mesh.size()} ranks: the sharded step is not "
            f"ported (one rank only)")
    x2d = x.reshape(B * S, D)
    if _use_ep(cfg, B * S, mesh):
        y2d, aux = _moe_ep(params, x2d, cfg, mesh)
    else:
        gates, idx, aux = router_topk(params, x2d, cfg)
        y2d = _routed(params, x2d, gates, idx,
                      cfg.mlp_activation).to(x.dtype)
    if cfg.num_shared_experts:
        h = x2d @ params.ws_up
        g = x2d @ params.ws_gate
        y2d = y2d + (F.silu(g) * h) @ params.ws_down
    return y2d.reshape(B, S, D), aux * cfg.router_aux_coef
