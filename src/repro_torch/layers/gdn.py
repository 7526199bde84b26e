"""Gated DeltaNet (GDN) and SimpleGDN linear-attention variants.

Port of ``repro.layers.gdn``, the efficient-attention ablation of GLM-5
§2.1.2 / Table 5:

* **GDN** [Yang et al., ICLR'24]: a gated linear recurrence with the delta
  rule, S_t = g_t S_{t-1} (I - β_t k_t k_tᵀ) + β_t v_t k_tᵀ, y_t = S_t q_t,
  with a short causal conv on the queries and an explicit gate (extra
  parameters: ``w_gate``, ``conv_w``, ``conv_b``);
* **SimpleGDN** (GLM-5's proposal): the Q/K/V projections map straight
  into the recurrence, no conv and no gate matrix; the decay is one
  learned scalar a head (``decay``, through a sigmoid).

``GDN(cfg, simple)`` holds the reference's ``build_gdn`` leaves, with
their shapes, logical axes (``AXES``) and init scales
(``reset_parameters``).  ``_delta_scan`` is the reference's ``lax.scan``
as a plain fp32 loop over time with its einsums; the reference has no
Pallas kernel for it, so neither has the port.  ``apply_gdn`` is the
reference's forward for both forms, its queries' conv the port's
``layers.ssm.causal_conv``.  Only the reference's ablation benchmark
(``benchmarks/attn_ablation.py``) uses the layer: no arch of the
registry has it.  ``bridge.gdn_from_jax_params`` carries a reference
layer's weights over.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.common import _empty
from repro_torch.layers.ssm import causal_conv

GATE_SCALE = 0.02     # the reference's explicit scale of w_beta and w_gate


class GDN(nn.Module):
    """One GDN (``simple=False``) or SimpleGDN layer's weights, (in, out)
    layout, under the reference's names."""

    AXES = {"wq": ("embed_fsdp", "heads"), "wk": ("embed_fsdp", "heads"),
            "wv": ("embed_fsdp", "heads"), "wo": ("heads", "embed_fsdp"),
            "w_beta": ("embed", None), "decay": (None,),
            "w_gate": ("embed", None), "conv_w": ("conv", "heads"),
            "conv_b": ("heads",)}

    def __init__(self, cfg: ModelConfig, simple: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        D, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.simple = cfg, simple
        self.wq = _empty(D, H * dh, **kw)
        self.wk = _empty(D, H * dh, **kw)
        self.wv = _empty(D, H * dh, **kw)
        self.wo = _empty(H * dh, D, **kw)
        self.w_beta = _empty(D, H, **kw)
        if simple:
            self.decay = _empty(H, **kw)
        else:
            self.w_gate = _empty(D, H, **kw)
            self.conv_w = _empty(cfg.ssm_conv, H * dh, **kw)
            self.conv_b = _empty(H * dh, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's inits: matrices normal * shape[0]^-1/2,
        ``w_beta`` and ``w_gate`` normal * 0.02, ``conv_w`` normal /
        ssm_conv, ``decay`` and ``conv_b`` zeros."""
        for name, p in self.named_parameters():
            if name in ("decay", "conv_b"):
                p.zero_()
                continue
            scale = {"w_beta": GATE_SCALE, "w_gate": GATE_SCALE,
                     "conv_w": 1.0 / self.cfg.ssm_conv}.get(
                name, p.shape[0] ** -0.5)
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                    * scale)


def build_gdn(cfg: ModelConfig, simple: bool = False,
              generator: Optional[torch.Generator] = None, device=None,
              dtype=torch.float32) -> GDN:
    """A random layer with the reference's scales (``generator`` on
    ``device``; by default one seeded with 0).  The numbers differ from
    the reference's: carry its weights over with
    ``bridge.gdn_from_jax_params``."""
    dev = resolve_device(device)
    layer = GDN(cfg, simple, device=dev, dtype=dtype)
    if dev.type != "meta":
        layer.reset_parameters(generator if generator is not None else
                               torch.Generator(device=dev).manual_seed(0))
    return layer


def _delta_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                beta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, S, H, dh); beta, g (B, S, H) -> y (B, S, H, dh) fp32:
    the delta-rule recurrence a step at a time from S_0 = 0."""
    B, S, H, dh = q.shape
    q, k, v, beta, g = (a.float() for a in (q, k, v, beta, g))
    state = q.new_zeros((B, H, dh, dh))
    ys = []
    for t in range(S):
        kt, bt, gt = k[:, t], beta[:, t, :, None, None], g[:, t, :, None, None]
        kk = torch.einsum("bhd,bhe->bhde", kt, kt)
        state = gt * (state - bt * torch.einsum("bhde,bhef->bhdf", state, kk))
        state = state + bt * torch.einsum("bhd,bhe->bhde", v[:, t], kt)
        ys.append(torch.einsum("bhde,bhe->bhd", state, q[:, t]))
    return torch.stack(ys, dim=1)


def apply_gdn(params: GDN, x: torch.Tensor, cfg: ModelConfig, *,
              simple: bool = False) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): L2-normed queries (after the causal conv,
    GDN only) and keys, β = sigmoid(x w_beta), the gate sigmoid(x w_gate)
    (GDN) or sigmoid(decay) a head (SimpleGDN), the delta scan, then
    ``wo``."""
    B, S, _ = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    q = (x @ params.wq).reshape(B, S, H, dh)
    k = (x @ params.wk).reshape(B, S, H, dh)
    v = (x @ params.wv).reshape(B, S, H, dh)
    if not simple:
        qf, _ = causal_conv(q.reshape(B, S, H * dh), params.conv_w,
                            params.conv_b)
        q = qf.reshape(B, S, H, dh)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-6)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-6)
    beta = torch.sigmoid(x @ params.w_beta)                  # (B, S, H)
    if simple:
        g = torch.sigmoid(params.decay).expand(B, S, H)
    else:
        g = torch.sigmoid(x @ params.w_gate)
    y = _delta_scan(q, k, v, beta, g).to(x.dtype)
    return y.reshape(B, S, H * dh) @ params.wo
