"""Selective state-space layers: Mamba-1 (falcon-mamba) and Mamba-2
(zamba2).

Port of ``repro.layers.ssm``.  The reference runs its time scans with
``lax.scan`` (``_mamba1_scan``, ``_mamba2_scan``); here both are K11:
Mamba-1's through ``kernels.mamba_scan.kernel.mamba1_scan`` (the model
form: the kernel discretizes dA = exp(dt·A) and dBx = (dt·x)·B itself) in
prefill, in the S = 1 decode step and in the training forward, with a
plain recomputing backward; Mamba-2's through ``mamba2_scan`` (the
head-shared form: one dt and one scalar A a head, so one exponential a
head and step) in prefill, decode and the training forward, with a plain
backward by the chunked form.  Decode carries (conv_state, ssm_state) per
layer: O(1) per token.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.layers.common import _empty, rmsnorm
from repro_torch.sharding.rules import (batch_placements, is_placed,
                                        local_apply, partial_over, split_dim)


def _scan(scan, dt, A, xs, Bc, Cc, h0, channels: int):
    """K11 (``scan``: Mamba-1's or the head-shared form) on each rank's
    local tensors where its inputs are placed: the batch over ('pod',
    'data') and the channels (Mamba-1's 'ssm_inner', Mamba-2's heads) over
    'model' where they divide; B and C are read whole by every 'model'
    rank, so their gradients are parts of a sum over it."""
    if not is_placed(dt, A, xs, Bc, Cc, h0):
        return scan(dt, A, xs, Bc, Cc, h0)
    mesh = next(t for t in (dt, A, xs, Bc, Cc, h0)
                if is_placed(t)).device_mesh
    B = dt.shape[0]
    chan = batch_placements(mesh, B, model_dim=2, size=channels)
    state = batch_placements(mesh, B, model_dim=1, size=channels)
    rows = batch_placements(mesh, B)
    a = tuple(Shard(0) if p == Shard(2) else Replicate() for p in chan)
    batch_axes = [n for n, p in zip(mesh.mesh_dim_names, rows)
                  if p.is_shard()]
    a_grad = partial_over(a, mesh, batch_axes)
    bc_grad = partial_over(rows, mesh, ["model"] if chan != rows else [])
    return local_apply(scan, (dt, A, xs, Bc, Cc, h0),
                       (chan, a, chan, rows, rows, state), (chan, state),
                       grad_placements=(chan, a_grad, chan, bc_grad,
                                        bc_grad, state), mesh=mesh)


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, C), w (W, C) depthwise.  Returns (silu(y), new conv state
    (B, W-1, C)); the taps are summed tap 0 first, in the model's dtype,
    as the reference."""
    B, S, C = x.shape
    W = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((B, W - 1, C))
    xx = torch.cat([conv_state, x], dim=1)                # (B, W-1+S, C)
    y = sum(xx[:, i:i + S] * w[i] for i in range(W))
    y = y + bias
    return F.silu(y), xx[:, -(W - 1):]


class Mamba1(nn.Module):
    """The nine leaves of the reference's ``build_mamba1``, with its shapes
    and logical axes (Muon reads them)."""

    AXES = {"in_proj": ("embed_fsdp", "ssm_inner"),
            "conv_w": ("conv", "ssm_inner"), "conv_b": ("ssm_inner",),
            "x_proj": ("ssm_inner", None), "dt_proj": ("lora", "ssm_inner"),
            "dt_bias": ("ssm_inner",), "A_log": ("ssm_inner", "ssm_state"),
            "D": ("ssm_inner",), "out_proj": ("ssm_inner", "embed_fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        D, E, N, R, W = (cfg.d_model, d_inner(cfg), cfg.ssm_state,
                         dt_rank(cfg), cfg.ssm_conv)
        kw = dict(device=device, dtype=dtype)
        self.in_proj = _empty(D, 2 * E, **kw)
        self.conv_w = _empty(W, E, **kw)
        self.conv_b = _empty(E, **kw)
        self.x_proj = _empty(E, R + 2 * N, **kw)
        self.dt_proj = _empty(R, E, **kw)
        self.dt_bias = _empty(E, **kw)
        self.A_log = _empty(E, N, **kw)
        self.D = _empty(E, **kw)
        self.out_proj = _empty(E, D, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's inits (``sharding/rules.Builder``): matrices
        normal * shape[0]^-1/2, ``conv_w`` normal / W, ``conv_b`` and
        ``dt_bias`` zeros, ``D`` ones, ``A_log`` = log(1..N) on every
        channel."""
        for name, p in self.named_parameters():
            if name in ("conv_b", "dt_bias"):
                p.zero_()
            elif name == "D":
                p.fill_(1.0)
            elif name == "A_log":
                n = torch.arange(1, p.shape[1] + 1, dtype=torch.float32,
                                 device=p.device)
                p.copy_(torch.log(n).expand(p.shape))
            else:
                scale = 1.0 / p.shape[0] if name == "conv_w" \
                    else p.shape[0] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                        * scale)


def apply_mamba1(m: Mamba1, x: torch.Tensor, cfg: ModelConfig, *,
                 state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D).  ``state`` = {'conv': (B, W-1, E), 'ssm': (B, E, N)} for
    decode; returns (out, new state or None).  The new ssm state is cast to
    the dtype of the one given (bf16 serving keeps a bf16 state between
    steps, as the reference)."""
    B = x.shape[0]
    E, N, R = d_inner(cfg), cfg.ssm_state, dt_rank(cfg)
    xs, z = (x @ m.in_proj).chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xs, new_conv = causal_conv(xs, m.conv_w, m.conv_b, conv_state)
    dt_low, Bc, Cc = (xs @ m.x_proj).split([R, N, N], dim=-1)
    dt = F.softplus(dt_low @ m.dt_proj + m.dt_bias)           # (B, S, E)
    A = -torch.exp(m.A_log.float())                           # (E, N)
    h0 = state["ssm"] if state is not None else \
        torch.zeros((B, E, N), dtype=torch.float32, device=x.device)
    ys, hT = _scan(scan_kernel.mamba1_scan, dt, A, xs, Bc, Cc, h0, E)
    y = ys.to(x.dtype) + xs * m.D
    y = y * F.silu(z)
    out = y @ m.out_proj
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": hT.to(state["ssm"].dtype)}
    return out, new_state


def mamba1_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                 device=None) -> dict:
    E, N, W = d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((batch, W - 1, E), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, E, N), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Mamba-2 (scalar A per head; ngroups = 1)
# ---------------------------------------------------------------------------

def n_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


class Mamba2(nn.Module):
    """The eight leaves of the reference's ``build_mamba2``, with its shapes
    and logical axes."""

    AXES = {"in_proj": ("embed_fsdp", "ssm_inner"), "conv_w": ("conv", None),
            "conv_b": (None,), "A_log": (None,), "dt_bias": (None,),
            "D": (None,), "gate_norm": ("embed",),
            "out_proj": ("ssm_inner", "embed_fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        D, E, N, W = cfg.d_model, d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
        H = n_heads(cfg)
        kw = dict(device=device, dtype=dtype)
        self.in_proj = _empty(D, 2 * E + 2 * N + H, **kw)
        self.conv_w = _empty(W, E + 2 * N, **kw)
        self.conv_b = _empty(E + 2 * N, **kw)
        self.A_log = _empty(H, **kw)
        self.dt_bias = _empty(H, **kw)
        self.D = _empty(H, **kw)
        self.gate_norm = _empty(E, **kw)
        self.out_proj = _empty(E, D, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's inits: matrices normal * shape[0]^-1/2,
        ``conv_w`` normal / W, ``conv_b`` and ``dt_bias`` zeros, ``D`` and
        ``gate_norm`` ones, ``A_log`` = log(1..H)."""
        for name, p in self.named_parameters():
            if name in ("conv_b", "dt_bias"):
                p.zero_()
            elif name in ("D", "gate_norm"):
                p.fill_(1.0)
            elif name == "A_log":
                p.copy_(torch.log(torch.arange(1, p.shape[0] + 1,
                                               dtype=torch.float32,
                                               device=p.device)))
            else:
                scale = 1.0 / p.shape[0] if name == "conv_w" \
                    else p.shape[0] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                        * scale)


def apply_mamba2(m: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                 state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D).  ``state`` = {'conv': (B, W-1, E+2N), 'ssm': (B, H, P,
    N)} for decode; returns (out, new state or None), the new ssm state in
    the dtype of the one given (K11 writes it so).  dt and the scan in
    fp32, ``y + x·D`` a head, then the gated RMSNorm over all of E, as the
    reference."""
    B, S, _ = x.shape
    E, N, P = d_inner(cfg), cfg.ssm_state, cfg.ssm_head_dim
    H = E // P
    z, xBC, dt_raw = (x @ m.in_proj).split([E, E + 2 * N, H], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = causal_conv(xBC, m.conv_w, m.conv_b, conv_state)
    xs, Bc, Cc = xBC.split([E, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + m.dt_bias)               # (B, S, H)
    A = -torch.exp(m.A_log.float())                           # (H,)
    h0 = state["ssm"] if state is not None else \
        torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    xs = xs.contiguous()
    ys, hT = _scan(scan_kernel.mamba2_scan, dt, A, xs, Bc, Cc, h0, H)
    y = ys + split_dim(xs, 2, (H, P)).float() * m.D[:, None]
    y = y.reshape(B, S, E).to(x.dtype)
    y = rmsnorm(y * F.silu(z), m.gate_norm, cfg.norm_eps)
    out = y @ m.out_proj
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": hT}
    return out, new_state


def mamba2_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                 device=None) -> dict:
    E, N, W = d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((batch, W - 1, E + 2 * N), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, n_heads(cfg), cfg.ssm_head_dim, N),
                               dtype=dtype, device=device)}
