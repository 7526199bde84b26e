"""Plain versions of K11, the selective scan (port of
``repro.kernels.mamba_scan.ref``, whose oracle is
``layers/ssm._mamba1_scan``, and of the reference's Mamba-2 scan
``layers/ssm._mamba2_scan``).

    h[t] = dA[t] * h[t-1] + dBx[t],   y[t] = sum_n h[t] * C[t]

in fp32 from h[-1] = h0, in three forms:

* ``reference(dA, dBx, C, h0)``: the Pallas kernel's contract, dA and dBx
  (B, S, E, N), C (B, S, N), h0 (B, E, N) -> y (B, S, E), hT (B, E, N),
  both in ``dA.dtype``;
* ``scan_model(dt, A, x, Bc, Cc, h0)``: the tensors ``apply_mamba1`` has,
  dt and x (B, S, E), A (E, N) fp32, Bc and Cc (B, S, N), h0 (B, E, N) ->
  y (B, S, E), hT (B, E, N) in fp32.  It discretizes as the reference
  does (``discretize``), one time step at a time, so no (B, S, E, N)
  tensor is made;
* ``scan_heads(dt, A, x, Bc, Cc, h0)``: the head-shared (Mamba-2) form of
  ``layers.ssm.apply_mamba2``, one dt and one A a head: dt (B, S, H) and A
  (H,) fp32, x (B, S, H·P), Bc and Cc (B, S, N), h0 (B, H, P, N) -> y
  (B, S, H, P) in fp32 and hT in ``h0.dtype``, stepped as the reference's
  ``_mamba2_scan`` (dA = exp(dt·A), then (x·dt)·B).

``scan_model_grads`` is the gradient of ``scan_model``: the adjoint
recursion ``g_h[t] = dA[t+1] * g_h[t+1] + C[t] * g_y[t]``, with the states
recomputed ``BWD_CHUNK`` time steps at a time from states kept at the
chunks' starts.  ``scan_heads_grads`` is the gradient of ``scan_heads``,
with no loop over time: one dA a head and step lets a chunk of L steps
unroll into a masked product (the chunked, "dual" form of Mamba-2),

    y = (M ∘ C Bᵀ) · (x·dt) + C · decay · h_start,
    M[t, s] = exp(sum_{s<r<=t} dt_r·A)  (s <= t),

and the chunks' states pass from chunk to chunk by the same masked
product over the chunks' total decays; ``torch.autograd.grad`` of that
form gives the gradient.  Every decay is the exponential of a segment sum
taken by a cumulative sum over a masked (L, L) tensor (``_segsum``), never
the difference of two long cumulative sums: dt·A reaches about -100 a
step at A = -80, so such a difference would lose the short-range decays
that matter.  These run the CPU tests, the model on CPU tensors,
``chip_smoke.py``'s plain route and the autograd Functions' backwards.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BWD_CHUNK = 64      # time steps whose states the backward holds at once


def reference(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas ``mamba_scan`` contract in plain PyTorch."""
    h = h0.float()
    ys = []
    for t in range(dA.shape[1]):
        h = dA[:, t].float() * h + dBx[:, t].float()
        ys.append((h * C[:, t, None].float()).sum(-1))
    return torch.stack(ys, 1).to(dA.dtype), h.to(dA.dtype)


def discretize(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
               Bc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt and x (..., E), A (E, N), Bc (..., N) -> dA = exp(dt·A) and
    dBx = (dt·x)·B (..., E, N) in fp32, the reference's order of products
    (``layers/ssm.apply_mamba1``)."""
    dtf = dt.float()
    dA = torch.exp(dtf[..., None] * A.float())
    dBx = (dtf * x.float())[..., None] * Bc.float()[..., None, :]
    return dA, dBx


def scan_model(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's form of K11 in plain PyTorch: -> (y, hT) in fp32."""
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dA, dBx = discretize(dt[:, t], A, x[:, t], Bc[:, t])
        h = dA * h + dBx
        ys.append((h * Cc[:, t, None].float()).sum(-1))
    return torch.stack(ys, 1), h


def scan_heads(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head-shared form of K11 in plain PyTorch, a step at a time:
    -> (y (B, S, H, P) fp32, hT (B, H, P, N) in h0.dtype)."""
    B, S, H = dt.shape
    xh = x.reshape(B, S, H, -1).float()
    dtf, Bf, Cf = dt.float(), Bc.float(), Cc.float()
    dA = torch.exp(dtf * A.float())                       # (B, S, H)
    h = h0.float()
    ys = []
    for t in range(S):
        x_dt = xh[:, t] * dtf[:, t, :, None]              # (B, H, P)
        h = dA[:, t, :, None, None] * h \
            + x_dt[..., None] * Bf[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, 1), h.to(h0.dtype)


def scan_model_grads(dt, A, x, Bc, Cc, h0, g_y: torch.Tensor,
                     g_hT: Optional[torch.Tensor]):
    """Gradients of ``scan_model``'s (y, hT) against (dt, A, x, Bc, Cc, h0),
    in fp32.  One pass keeps the state at every chunk's start; then, chunk
    by chunk from the end, the chunk's states are recomputed and the
    adjoint G = dL/dh walks back through it, so memory holds a few
    (B, BWD_CHUNK, E, N) tensors and S / BWD_CHUNK states, never the whole
    history."""
    B, S, E = dt.shape
    chunk = BWD_CHUNK
    dtf, xf, Bf, Cf, Af = (t.float() for t in (dt, x, Bc, Cc, A))
    gy = g_y.float()
    starts = list(range(0, S, chunk))
    h = h0.float()
    saved = []
    for t0 in starts:
        saved.append(h)
        dA, dBx = discretize(dtf[:, t0:t0 + chunk], Af, xf[:, t0:t0 + chunk],
                             Bf[:, t0:t0 + chunk])
        for k in range(dA.shape[1]):
            h = torch.addcmul(dBx[:, k], dA[:, k], h)
    G = torch.zeros_like(h) if g_hT is None else g_hT.float().clone()
    g_dt, g_x = torch.empty_like(dtf), torch.empty_like(xf)
    g_B, g_C = torch.empty_like(Bf), torch.empty_like(Cf)
    g_A = torch.zeros_like(Af)
    for t0, h_start in zip(reversed(starts), reversed(saved)):
        t1 = min(t0 + chunk, S)
        dtc, xc = dtf[:, t0:t1], xf[:, t0:t1]
        dA, dBx = discretize(dtc, Af, xc, Bf[:, t0:t1])
        hs = [h_start]                    # hs[k] = the state before step k
        for k in range(t1 - t0):
            hs.append(torch.addcmul(dBx[:, k], dA[:, k], hs[-1]))
        H = torch.stack(hs, 1)
        Gs = torch.empty_like(dA)         # Gs[:, k] = dL/dh at step t0 + k
        for k in reversed(range(t1 - t0)):
            G = torch.addcmul(G, gy[:, t0 + k, :, None], Cf[:, t0 + k, None])
            Gs[:, k] = G
            G = G * dA[:, k]
        g_C[:, t0:t1] = torch.einsum("bke,bken->bkn", gy[:, t0:t1], H[:, 1:])
        q = Gs * H[:, :-1] * dA           # dL/d(dt·A)
        g_dtx = (Gs * Bf[:, t0:t1, None, :]).sum(-1)     # dL/d(dt·x)
        g_B[:, t0:t1] = torch.einsum("bken,bke->bkn", Gs, dtc * xc)
        g_dt[:, t0:t1] = (q * Af).sum(-1) + g_dtx * xc
        g_x[:, t0:t1] = g_dtx * dtc
        g_A += torch.einsum("bken,bke->en", q, dtc)
    return g_dt, g_A, g_x, g_B, g_C, G


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L) with [t, s] = sum_{s<r<=t} a[r] for s <= t
    and -inf above the diagonal (exp gives 0 there): a cumulative sum over
    (L, L) copies of a, each masked to the steps after s."""
    L = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, L)              # [r, s] = a[r]
    after = torch.ones(L, L, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~after, 0.0).cumsum(-2)
    return x.masked_fill(~after.logical_or(
        torch.eye(L, dtype=torch.bool, device=a.device)), float("-inf"))


def scan_heads_chunked(dt, A, x, Bc, Cc, h0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scan_heads`` by the chunked form, fp32 in and out, differentiable:
    chunks of ``BWD_CHUNK`` steps (fewer where S is shorter), a ragged last
    chunk padded with dt = 0 (dA = 1 and x·dt = 0: the state passes
    through unchanged).  Its tensors are (B, H, S/L, L, L) decays and
    (B, H, S/L + 1, P, N) states; it loops over nothing."""
    B, S, H = dt.shape
    N = Bc.shape[-1]
    P = x.shape[-1] // H
    L = min(BWD_CHUNK, S)
    nc = -(-S // L)
    pad = nc * L - S
    X = x.reshape(B, S, H, P) * dt[..., None]             # x·dt
    a = dt * A                                            # log dA
    if pad:
        X = torch.nn.functional.pad(X, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        Bc = torch.nn.functional.pad(Bc, (0, 0, 0, pad))
        Cc = torch.nn.functional.pad(Cc, (0, 0, 0, pad))
    Xh = X.reshape(B, nc, L, H, P).permute(0, 3, 1, 2, 4)   # (B, H, nc, L, P)
    ah = a.reshape(B, nc, L, H).permute(0, 3, 1, 2)        # (B, H, nc, L)
    Bk = Bc.reshape(B, 1, nc, L, N)
    Ck = Cc.reshape(B, 1, nc, L, N)
    M = torch.exp(_segsum(ah))                            # (B, H, nc, L, L)
    # within a chunk: y[t] = sum_{s<=t} M[t, s] (C[t]·B[s]) X[s]
    y = (M * (Ck @ Bk.transpose(-1, -2))) @ Xh
    # each chunk's own end state, from 0: sum_s M[L-1, s] X[s] B[s]^T
    ends = (Xh * M[..., -1, :, None]).transpose(-1, -2) @ Bk
    # the states at the chunks' starts, and hT: h0 and the end states
    # folded by the chunks' total decays
    totals = torch.nn.functional.pad(ah.sum(-1), (1, 0))   # (B, H, nc+1)
    states = torch.cat([h0[:, :, None], ends], 2)         # (B, H, nc+1, P, N)
    states = (torch.exp(_segsum(totals)) @ states.reshape(B, H, nc + 1, -1)
              ).reshape(B, H, nc + 1, P, N)
    # from the chunk's start state: exp(sum_{r<=t} a[r]) C[t]·h_start
    y = y + torch.exp(ah.cumsum(-1))[..., None] \
        * (Ck @ states[:, :, :-1].transpose(-1, -2))
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, P)[:, :S]
    return y, states[:, :, -1]


def scan_heads_grads(dt, A, x, Bc, Cc, h0, g_y: Optional[torch.Tensor],
                     g_hT: Optional[torch.Tensor]):
    """Gradients of ``scan_heads``' (y, hT) against (dt, A, x, Bc, Cc, h0),
    in fp32: ``torch.autograd.grad`` of ``scan_heads_chunked`` recomputed
    from the inputs (never from the forward's outputs).  A cotangent that
    is None (not both) counts as 0; its output is then not
    differentiated."""
    ins = [t.detach().float().requires_grad_() for t in
           (dt, A, x, Bc, Cc, h0)]
    with torch.enable_grad():
        y, hT = scan_heads_chunked(*ins)
        outs = [(o, g.float()) for o, g in ((y, g_y), (hT, g_hT))
                if g is not None]
        return torch.autograd.grad([o for o, _ in outs], ins,
                                   [g for _, g in outs])
