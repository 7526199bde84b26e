"""PyTorch port: the arithmetic of two redesigned kernels, written out in
plain PyTorch on the CPU and held against the JAX package's Pallas kernels
in interpret mode.  The CUDA kernels themselves run only on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); these tests show that
their numerics, not only their code, stay within the port's bounds.

* K1's split-KV decode (``csrc/paged_attention.cu``, ``decode_split``): a
  row's live range [lo, hi] (lo the window's first position, hi its query's
  position, at most the table's last) cut into ``parts`` runs of whole pool
  blocks, ceil(blocks / parts) a run; each run's (m, l, acc) in the log2
  domain from fp32 scores (scaled, soft-capped c*tanh(s/c)), an empty run
  m = NEG_INF and l = 0; the runs folded by exp2(m_j - M) weights and
  divided by max(l, 1e-20); in bf16 (the tensor-core body) P rounded to
  bf16 for P V, l summing the fp32 p.  Held against the Pallas
  ``paged_decode_gqa`` at parts 1, 2, 3, 8 and 16 over an idle slot
  (length 0 on the trash block), lengths shorter than parts x bs (empty
  runs), ragged lengths, window and softcap, block sizes 8 and 32, head dims 64 and 128: fp32 at
  1e-5, bf16 inputs (and the output rounded to bf16) at the bf16 bound
  2e-2 x min(1, max|reference|).
* K10's fp32 tile by 3xTF32 (``csrc/chunked_ce.cu``, ``ce_tf32``): the
  logits as the three TF32 products the tile sums (big.big + big.small +
  small.big, ``cvt.rna.tf32.f32`` bit for bit), soft-capped, per 128-id
  vocab tile a max, a sum of exp and the target's logit (0 for a target
  outside [0, V)), folded per token as the combine pass folds them; held
  against the Pallas ``chunked_ce`` at 1e-5 relative on both sums, Tk a
  multiple of 128 (the Pallas kernel gives NaN on a ragged token block),
  ragged V, softcap 0 and 30, a partial mask.  One TF32 product alone
  misses the bound at D 512 with logits of scale 8 on these inputs (its
  error is of random sign and averages over tokens: at unit-scale logits
  it stays under the bound on the sums).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_ce.kernel import chunked_ce as jax_chunked_ce
from repro.kernels.paged_attention.kernel import \
    paged_decode_gqa as jax_decode_gqa
from test_torch_tile_numerics import cvt_rna_tf32, matmul_3xtf32

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# K1: the split-KV decode
# ---------------------------------------------------------------------------

def split_decode_arithmetic(q, k_pool, v_pool, tables, seq_lens, *, parts,
                            window=0, softcap=0.0, p_bf16=False):
    """K1's split and fold in plain PyTorch, fp32: q (B, KVH, G, d), pools
    (nb, bs, KVH, d), tables (B, mb), seq_lens (B,) -> (B, KVH, G, d).
    ``p_bf16``: P rounded to bf16 for P V while l sums the fp32 p, as the
    bf16 body's tensor-core product takes it."""
    B, KVH, G, d = q.shape
    bs, mb = k_pool.shape[1], tables.shape[1]
    scale = d ** -0.5
    out = torch.zeros(B, KVH, G, d)
    for b in range(B):
        qpos = int(seq_lens[b])
        lo = max(qpos - window + 1, 0) if window > 0 else 0
        hi = min(qpos, mb * bs - 1)
        blo = lo // bs
        nblk = hi // bs - blo + 1 if hi >= lo else 0
        per = -(-nblk // parts)
        for h in range(KVH):
            ms, ls, accs = [], [], []
            for j in range(parts):
                first = max(lo, (blo + j * per) * bs)
                last = min(hi, (blo + (j + 1) * per) * bs - 1)
                if last < first:                       # an empty run
                    ms.append(torch.full((G,), NEG_INF))
                    ls.append(torch.zeros(G))
                    accs.append(torch.zeros(G, d))
                    continue
                pos = torch.arange(first, last + 1)
                rows = tables[b, pos // bs].long() * bs + pos % bs
                k = k_pool.reshape(-1, KVH, d)[rows, h].float()
                v = v_pool.reshape(-1, KVH, d)[rows, h].float()
                s = (q[b, h].float() @ k.T) * scale
                if softcap > 0:
                    s = softcap * torch.tanh(s / softcap)
                s = s * LOG2E
                m = s.amax(-1).clamp_min(NEG_INF)
                p = torch.exp2(s - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append((_bf16(p) if p_bf16 else p) @ v)
            m_all = torch.stack(ms)                    # (parts, G)
            wts = torch.exp2(m_all - m_all.amax(0))
            lsum = (wts * torch.stack(ls)).sum(0)
            acc = (wts[..., None] * torch.stack(accs)).sum(0)
            out[b, h] = acc / lsum.clamp_min(1e-20)[:, None]
    return out


# (name, KVH, G, d, bs, mb, lens, window, softcap)
DECODE_CASES = {
    "idle-and-ragged": (2, 4, 64, 8, 6, [0, 1, 7, 8, 19, 47], 0, 0.0),
    "shorter-than-runs": (2, 4, 128, 8, 12, [0, 3, 9, 17, 30], 0, 0.0),
    "window-softcap": (2, 2, 64, 8, 10, [0, 5, 21, 40, 79], 12, 30.0),
    "block-32": (1, 8, 128, 32, 5, [0, 31, 32, 77, 159], 0, 0.0),
    "block-32-window": (2, 4, 64, 32, 4, [0, 2, 63, 100, 127], 40, 20.0),
}


def _decode_inputs(name):
    KVH, G, d, bs, mb, lens, _, _ = DECODE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    B = len(lens)
    live = [0] + [n // bs + 1 for n in lens[1:]]       # row 0: idle slot
    nb = sum(live) + 1
    tables = np.full((B, mb), nb - 1, np.int32)         # trash: last block
    ids, at = rng.permutation(nb - 1), 0
    for b, n in enumerate(live):
        tables[b, :n] = ids[at:at + n]
        at += n
    k = rng.standard_normal((nb, bs, KVH, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, KVH, d)).astype(np.float32)
    q = rng.standard_normal((B, KVH, G, d)).astype(np.float32)
    return q, k, v, tables, np.asarray(lens, np.int32)


@functools.lru_cache(maxsize=None)
def _decode_reference(name, dtype):
    """The Pallas kernel's output (fp32) on the case's inputs, rounded to
    bf16 values first for ``dtype`` bfloat16."""
    q, k, v, tables, lens = _decode_inputs(name)
    *_, window, softcap = DECODE_CASES[name]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jax_decode_gqa(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                         jnp.asarray(tables), jnp.asarray(lens),
                         window=window, softcap=softcap, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("parts", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_arithmetic_matches_pallas(dtype, name, parts):
    q, k, v, tables, lens = map(torch.from_numpy, _decode_inputs(name))
    *_, window, softcap = DECODE_CASES[name]
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    got = split_decode_arithmetic(q, k, v, tables, lens, parts=parts,
                                  window=window, softcap=softcap,
                                  p_bf16=dtype == "bfloat16")
    if dtype == "bfloat16":
        got = _bf16(got)
    want = _decode_reference(name, dtype)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.isfinite(got[0]).all()                   # the idle slot
    err = float(np.abs(got - want).max())
    bound = 1e-5 if dtype == "float32" else \
        2e-2 * min(1.0, float(np.abs(want).max()))
    assert err <= bound, f"max abs err {err} > {bound}"


def test_split_decode_cuts_whole_blocks_and_empty_runs():
    """The runs are whole blocks, in order, covering the live range once;
    past the range's blocks a run is empty."""
    q, k, v, tables, lens = map(torch.from_numpy,
                                _decode_inputs("shorter-than-runs"))
    # lens 3 at bs 8 is one block: 15 of 16 runs are empty, and the fold
    # equals the single run's result
    one = split_decode_arithmetic(q[1:2], k, v, tables[1:2], lens[1:2],
                                  parts=1)
    many = split_decode_arithmetic(q[1:2], k, v, tables[1:2], lens[1:2],
                                   parts=16)
    torch.testing.assert_close(many, one, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# K10: the fp32 tile by 3xTF32
# ---------------------------------------------------------------------------

def ce_tile_arithmetic(h, w, targets, mask, *, softcap=0.0, products=3,
                       block_v=128):
    """K10's fp32 route in plain PyTorch: h (Tk, D), w (D, V), targets,
    mask (Tk,) -> (loss_sum, count); logits by ``products`` TF32 products,
    per-vocab-tile partials, the combine pass's fold."""
    V = w.shape[1]
    z = matmul_3xtf32(h, w, products)
    if softcap > 0:
        z = softcap * torch.tanh(z / softcap)
    tgt = targets.long()
    ms, ls, ts = [], [], []
    for v0 in range(0, V, block_v):
        zt = z[:, v0:v0 + block_v]
        m = zt.amax(-1)
        ms.append(m)
        ls.append(torch.exp(zt - m[:, None]).sum(-1))
        cols = torch.arange(v0, v0 + zt.shape[1])
        hit = cols[None, :] == tgt[:, None]
        ts.append(torch.where(hit, zt, torch.zeros_like(zt)).sum(-1))
    m_all = torch.stack(ms)
    M = m_all.amax(0)
    L = (torch.stack(ls) * torch.exp(m_all - M)).sum(0)
    nll = M + torch.log(L.clamp_min(1e-30)) - torch.stack(ts).sum(0)
    return (nll * mask).sum(), mask.sum()


def _ce_inputs(seed, Tk, D, V, scale=1.0, masked=0.3, outside=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((Tk, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * scale / np.sqrt(D)).astype(np.float32)
    t = rng.integers(0, V, Tk).astype(np.int32)
    if outside:                     # targets outside [0, V) contribute 0
        t[:3] = [-1, V, V + 7]
    m = (rng.random(Tk) >= masked).astype(np.float32)
    return h, w, t, m


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("Tk,D,V,softcap,outside", [
    (128, 96, 1000, 0.0, False),
    (256, 64, 333, 30.0, False),
    (128, 160, 129, 0.0, True),
    (256, 128, 777, 30.0, True),
])
def test_ce_tile_arithmetic_matches_pallas(Tk, D, V, softcap, outside):
    ins = _ce_inputs(Tk + D + V, Tk, D, V, outside=outside)
    want = [float(x) for x in jax_chunked_ce(*map(jnp.asarray, ins),
                                             softcap=softcap,
                                             interpret=True)]
    loss, count = ce_tile_arithmetic(*map(torch.from_numpy, ins),
                                     softcap=softcap)
    assert np.isfinite(float(loss))
    assert _rel(loss, want[0]) <= 1e-5
    assert _rel(count, want[1]) <= 1e-5


def test_ce_single_tf32_product_misses_the_bound():
    """At D 512 and logits of scale 8 (no cap) three products hold 1e-5
    relative on the loss sum and one product does not: the test sees the
    two small terms."""
    ins = _ce_inputs(0, 128, 512, 777, scale=8.0, masked=0.0)
    want = float(jax_chunked_ce(*map(jnp.asarray, ins), interpret=True)[0])
    args = [torch.from_numpy(x) for x in ins]
    three = ce_tile_arithmetic(*args)[0]
    one = ce_tile_arithmetic(*args, products=1)[0]
    assert _rel(three, want) <= 1e-5
    assert _rel(one, want) > 1e-5


def test_tf32_split_is_exact_to_two_terms():
    """big + small reconstructs the fp32 operand to 2^-22 relative, so
    3xTF32 products differ from fp32 ones by what small.small drops."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    three = matmul_3xtf32(a, b).double()
    one = cvt_rna_tf32(a).double() @ cvt_rna_tf32(b).double()
    scale = (a.double().abs() @ b.double().abs())
    assert ((three - exact).abs() / scale).max().item() < 2e-6
    assert ((one - exact).abs() / scale).max().item() > 2e-5
