"""PyTorch port: the arithmetic of two tensor-core tiles, written out in
plain PyTorch on the CPU and held against the JAX package's Pallas kernels
in interpret mode.  The CUDA tiles themselves run only on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); these tests show that
their numerics, not only their code, stay within the port's bounds.

* K4's bf16 tile (``csrc/paged_mla.cu``, ``mla_span_kernel``): q_lat
  rounded to bf16 once as it is staged, exact bf16 x bf16 products summed
  in fp32, scores scaled in fp32, the online softmax over rounds of 32
  keys in the log2 domain, P rounded to bf16 for PV while l sums the
  unrounded p, out = acc / max(l, 1e-20) in fp32; held against the Pallas
  ``paged_prefill_mla`` (fp32 throughout) at the bf16 bound, 2e-2 scaled
  by min(1, max|reference|), at H 16, lora 512 / rope 64, over ragged rows
  (a trash row, a span from position 0, one mid-block, one across a block
  edge), the pools and q_rope bf16 values in both.
* K9's fp32 tile (``csrc/tf32_tile.cuh``): a bitwise emulation of
  ``cvt.rna.tf32.f32`` (10 explicit mantissa bits, ties away from zero);
  big + small reconstructs x to 2^-22 relative; attention with QK^T and PV
  as the three TF32 products the tile sums (big.big + big.small +
  small.big, each product exact in fp32) against the Pallas
  ``flash_attention`` at 1e-5 (atol and rtol), causal, windowed,
  soft-capped, with q_offset and not causal; one TF32 product alone misses
  that bound, so the test does see the two small terms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk9
from repro.kernels.paged_attention.prefill import \
    paged_prefill_mla as jax_prefill_mla

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# K4: the bf16 MLA tile
# ---------------------------------------------------------------------------

def mla_tile_arithmetic(q_lat, q_rope, c_pool, kr_pool, tables, starts, *,
                        heads, scale, keys=32):
    """K4's bf16 tile in plain PyTorch: q_lat (B, S*H, lora) fp32, q_rope
    and the pools bf16 values -> (B, S*H, lora) fp32."""
    B, SH, L = q_lat.shape
    bs = c_pool.shape[1]
    q = torch.cat([_bf16(q_lat), q_rope.float()], dim=-1)      # staged bf16
    qpos = starts.long()[:, None] + torch.arange(SH)[None] // heads
    out = torch.zeros_like(q_lat)
    for b in range(B):
        hi = min(int(qpos[b].max()), tables.shape[1] * bs - 1)
        m = torch.full((SH,), NEG_INF)
        l = torch.zeros(SH)
        acc = torch.zeros(SH, L)
        for r0 in range(0, hi + 1, keys):
            pos = torch.arange(r0, r0 + keys)
            live = pos <= hi
            p_ = pos.clamp(max=hi)
            slot = tables[b, p_ // bs].long() * bs + p_ % bs
            c = c_pool.reshape(-1, L)[slot].float()
            k = torch.cat([c, kr_pool.reshape(-1, kr_pool.shape[-1])[slot]
                           .float()], dim=-1)
            c = torch.where(live[:, None], c, torch.zeros_like(c))
            s = (q[b] @ k.T) * scale * LOG2E
            ok = live[None] & (pos[None] <= qpos[b][:, None])
            s = torch.where(ok, s, torch.full_like(s, -torch.inf))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + _bf16(p) @ c
            m = m_new
        out[b] = acc / l.clamp_min(1e-20)[:, None]
    return out


def _mla_inputs(seed, H, L, R, bs, S, starts, mb):
    rng = np.random.default_rng(seed)
    B = len(starts)
    live = [0] + [(s + S - 1) // bs + 1 for s in starts[1:]]   # row 0: trash
    nb = sum(live) + 1
    tables = np.full((B, mb), nb - 1, np.int32)
    ids, at = rng.permutation(nb - 1), 0
    for b, n in enumerate(live):
        tables[b, :n] = ids[at:at + n]
        at += n

    def bf16_values(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return _bf16(x).numpy()
    return (rng.standard_normal((B, S * H, L)).astype(np.float32),
            bf16_values(B, S * H, R), bf16_values(nb, bs, L),
            bf16_values(nb, bs, R), tables, np.asarray(starts, np.int32))


@pytest.mark.parametrize("bs", [8, 16])
def test_mla_tile_arithmetic_matches_pallas(bs):
    H, L, R, S = 16, 512, 64, 5
    scale = 192 ** -0.5
    starts = [0, 0, bs + bs // 2, 2 * bs - 2]
    mb = (max(starts) + S - 1) // bs + 1
    ins = _mla_inputs(bs, H, L, R, bs, S, starts, mb)
    want = np.asarray(jax_prefill_mla(*map(jnp.asarray, ins), heads=H,
                                      scale=scale, interpret=True))
    got = mla_tile_arithmetic(*map(torch.from_numpy, ins), heads=H,
                              scale=scale).numpy()
    assert np.isfinite(got).all()
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max abs err {err} > {bound}"
    assert err > 0.0          # the roundings are there


# ---------------------------------------------------------------------------
# K9: the fp32 tile by 3xTF32
# ---------------------------------------------------------------------------

def cvt_rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` bit for bit on finite fp32: keep 10 explicit
    mantissa bits, rounding to nearest with ties away from zero (adding
    half of the dropped 13 bits' range to the magnitude, then clearing
    them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = cvt_rna_tf32(x)
    return big, cvt_rna_tf32(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, products=3):
    """a @ b as the tile sums it: big.big + big.small + small.big (the
    small terms first), each product of TF32 values exact in fp32; with
    ``products=1`` the single TF32 product."""
    ab, as_ = split_tf32(a)
    bb, bs_ = split_tf32(b)
    if products == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs_ + ab @ bb


def tf32_tile_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, products=3):
    """K9's fp32 tile in plain PyTorch: q (BH, Sq, d), k/v (BH, Sk, d) ->
    (BH, Sq, d); scores scaled, soft-capped, masked, softmax's unnormalised
    p times V by 3xTF32, divided by max(l, 1e-20)."""
    Sq, Sk, d = q.shape[1], k.shape[1], q.shape[2]
    s = matmul_3xtf32(q, k.transpose(1, 2), products) * d ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, torch.full_like(s, -torch.inf))
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return matmul_3xtf32(p, v, products) / l.clamp_min(1e-20)


def test_cvt_rna_tf32_rounds_and_splits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.integers(-20, 20, 20000))
                         .astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):          # both are TF32 values
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    rel = ((x.double() - big.double() - small.double()).abs()
           / x.double().abs())
    assert rel.max().item() <= 2.0 ** -22
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    # ties go away from zero: 1 + 2^-11 is halfway between 1 and 1 + 2^-10
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                        1 + 3 * 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10])
    assert torch.equal(cvt_rna_tf32(tie), want)


def _bh(x, G=1):
    if G > 1:
        x = np.repeat(x, G, axis=2)
    B, S, H, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, d)


@pytest.mark.parametrize("Sq,Sk,kw", [
    (70, 70, dict(causal=True)),
    (70, 70, dict(causal=True, window=24, softcap=30.0)),
    (40, 90, dict(causal=True, q_offset=50)),
    (40, 90, dict(causal=True, q_offset=50, window=32)),
    (50, 90, dict(causal=False, softcap=20.0)),
])
def test_tf32_tile_attention_matches_pallas(Sq, Sk, kw):
    B, H, KVH, d = 2, 4, 2, 64
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((B, Sq, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, d)).astype(np.float32)
    qb, kb, vb = _bh(q), _bh(k, H // KVH), _bh(v, H // KVH)
    want = np.asarray(jk9.flash_attention(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb), interpret=True,
        **kw))
    args = [torch.from_numpy(x) for x in (qb, kb, vb)]
    got = tf32_tile_attention(*args, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = tf32_tile_attention(*args, products=1, **kw).numpy()
    assert np.abs(one - want).max() > 1e-5 + 1e-5 * np.abs(want).max()
