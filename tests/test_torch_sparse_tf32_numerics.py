"""PyTorch port: the arithmetic of K8's fp32 route, the 3xTF32 tile
(``csrc/tf32_tile.cuh`` with ``csrc/block_sparse.cu``'s layout), written
out in plain PyTorch on the CPU and held against the JAX package.  The CUDA
tile itself runs only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``); this file shows that its numerics, not only its code,
stay within the port's bounds.

The tile's walk: a tile of 64 packed rows (row r: token r // G, head
r % G of one KV head) of one query block lists the attended ids that can
admit one of its keys (id >= 0, block start <= the tile's last query,
< T), flattens their keys (flat key t: block list[t // bs], offset
t % bs), cuts them into rounds of 32 and the rounds into ``parts`` runs;
each run's (m, l, acc) comes from QK^T and PV as the three TF32 products
the tile sums (big.big + big.small + small.big, ``cvt.rna.tf32.f32`` bit
for bit), scores scaled in fp32, soft-capped, masked (-inf past T or after
the query's position), in the log2 domain; the runs fold as the combine
pass folds them, and a row with no key gets 0 or, with ``empty_mean``, the
mean of V over all nb * bs keys its query block lists.

* Against the Pallas ``block_sparse_attention`` in interpret mode (queries
  from position 0, -1 ids skipped, the diagonal block and earlier ones),
  ``empty_mean`` off, softcap 0 and 30, parts 1, 2 and 4: at 1e-5.
* Against the XLA ``repro.core.dsa.sparse_block_attention``, ``empty_mean``
  on, queries from per-row starts (q_start != 0), dqk != dv, invalid
  blocks, a query block that sees no key: at 1e-5.
* One TF32 product alone misses the 1e-5 bound, so the tests do see the
  two small terms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsa as jdsa
from repro.kernels.sparse_attention import ops as jops
from repro.kernels.sparse_attention.kernel import \
    block_sparse_attention as pallas_sparse
from test_torch_tile_numerics import matmul_3xtf32

LOG2E = 1.4426950408889634
NEG_INF = -1e30
ROWS, KEYS = 64, 32      # packed rows a tile, keys a round


def sparse_tf32_arithmetic(q, k, v, block_idx, q_start, *, block_size,
                           softcap=0.0, empty_mean=False, parts=1,
                           products=3):
    """K8's fp32 tile in plain PyTorch: q (B, S, H, dqk), k (B, T, KVH,
    dqk), v (B, T, KVH, dv), block_idx (B, S / bs, nb) (a negative id
    skipped, standing for block -id - 1), q_start (B,) -> (B, S, H, dv)."""
    B, S, H, dqk = q.shape
    T, KVH, dv = k.shape[1], k.shape[2], v.shape[-1]
    G, bs, nb = H // KVH, block_size, block_idx.shape[2]
    scale = dqk ** -0.5
    out = torch.zeros((B, S, H, dv))
    for b in range(B):
        for n in range(S // bs):
            ids = [int(i) for i in block_idx[b, n]]
            for kvh in range(KVH):
                # the mean of V over every listed block, skipped ones too
                blocks = [i if i >= 0 else -i - 1 for i in ids]
                pos_all = (torch.tensor(blocks)[:, None] * bs
                           + torch.arange(bs)).reshape(-1).clamp(max=T - 1)
                mean = v[b, pos_all, kvh].mean(0)
                for r0 in range(0, bs * G, ROWS):
                    r = torch.arange(r0, min(r0 + ROWS, bs * G))
                    tok, head = n * bs + r // G, kvh * G + r % G
                    qpos = int(q_start[b]) + tok
                    q_last = int(qpos.max())
                    listed = [i for i in ids
                              if i >= 0 and i * bs <= q_last and i * bs < T]
                    flat = (torch.tensor(listed, dtype=torch.long)[:, None]
                            * bs + torch.arange(bs)).reshape(-1)
                    rounds = -(-flat.numel() // KEYS)
                    qr = q[b, tok, head]
                    runs = []
                    for part in range(parts):
                        m = torch.full((len(r),), NEG_INF)
                        l = torch.zeros(len(r))
                        acc = torch.zeros(len(r), dv)
                        for rd in range(rounds * part // parts,
                                        rounds * (part + 1) // parts):
                            pos = flat[rd * KEYS:(rd + 1) * KEYS]
                            there = pos < T
                            kk = torch.where(there[:, None],
                                             k[b, pos.clamp(max=T - 1), kvh],
                                             0.0)
                            vv = torch.where(there[:, None],
                                             v[b, pos.clamp(max=T - 1), kvh],
                                             0.0)
                            s = matmul_3xtf32(qr, kk.T, products) * scale
                            if softcap > 0:
                                s = softcap * torch.tanh(s / softcap)
                            s = s * LOG2E
                            ok = there[None] & (pos[None] <= qpos[:, None])
                            s = torch.where(ok, s, -torch.inf)
                            m_new = torch.maximum(m, s.amax(-1))
                            alpha = torch.exp2(m - m_new)
                            p = torch.exp2(s - m_new[:, None])
                            l = l * alpha + p.sum(-1)
                            acc = acc * alpha[:, None] \
                                + matmul_3xtf32(p, vv, products)
                            m = m_new
                        runs.append((m, l, acc))
                    if parts == 1:
                        m, l, acc = runs[0]
                        o = acc / l.clamp_min(1e-20)[:, None]
                        L = l
                    else:               # the combine pass's fold
                        M = torch.stack([m_ for m_, _, _ in runs]).amax(0)
                        w = [torch.exp2(m_ - M) for m_, _, _ in runs]
                        L = sum(w_ * l_ for w_, (_, l_, _) in zip(w, runs))
                        o = sum(w_[:, None] * a_
                                for w_, (_, _, a_) in zip(w, runs))
                        safe = torch.where(L > 0, L, 1.0)
                        o = torch.where(L[:, None] > 0, o / safe[:, None],
                                        0.0)
                    if empty_mean:
                        o = torch.where(L[:, None] > 0, o, mean[None])
                    out[b, tok, head] = o
    return out


def _pallas_inputs(seed, bs, nb, B=2, H=4, KVH=2, d=64):
    """Queries from 0: the diagonal block and earlier ones a query block,
    repeats mapped to -1 (tests/test_kernels.py's ids), shared by the heads
    of a row."""
    rng = np.random.default_rng(seed)
    S = T = 4 * bs
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    nqb = S // bs
    diag = np.broadcast_to(np.arange(nqb)[None, :, None], (B, nqb, 1))
    rnd = rng.integers(0, nqb, (B, nqb, nb - 1))
    bidx = np.array(jops.dedupe_blocks(jnp.asarray(
        np.concatenate([diag, np.minimum(rnd, diag)], -1).astype(np.int32))))
    return q, k, v, bidx


def _to_bh(x, G=1):
    """(B, S, heads, d) -> (B * heads * G, S, d), each head repeated G
    times (K/V for the Pallas kernel's query heads)."""
    x = np.repeat(x, G, axis=2)
    B, S, Hh, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * Hh, S,
                                                                 d))


@pytest.mark.parametrize("bs,nb,softcap", [(16, 3, 0.0), (16, 4, 30.0),
                                           (32, 2, 30.0)])
def test_sparse_tf32_tile_matches_pallas(bs, nb, softcap):
    q, k, v, bidx = _pallas_inputs(bs + nb, bs, nb)
    B, S, H, d = q.shape
    G = H // k.shape[2]
    want = np.asarray(pallas_sparse(
        jnp.asarray(_to_bh(q)), jnp.asarray(_to_bh(k, G)),
        jnp.asarray(_to_bh(v, G)), jnp.asarray(np.repeat(bidx, H, axis=0)),
        block_size=bs, softcap=softcap, interpret=True))
    want = want.reshape(B, H, S, d).transpose(0, 2, 1, 3)
    t = [torch.from_numpy(a) for a in (q, k, v, bidx)]
    start = torch.zeros(B, dtype=torch.int32)
    for parts in (1, 2, 4):
        got = sparse_tf32_arithmetic(*t, start, block_size=bs,
                                     softcap=softcap, parts=parts).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = sparse_tf32_arithmetic(*t, start, block_size=bs, softcap=softcap,
                                 products=1).numpy()
    assert np.abs(one - want).max() > 1e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("starts,softcap", [((0, 37), 0.0), ((48, 90), 30.0)])
def test_sparse_tf32_tile_matches_xla_with_empty_mean(starts, softcap):
    """q_start != 0, dqk 48 != dv 32, invalid blocks (negative ids in the
    kernel's form), query block 1 of row 0 with none valid: its rows take
    the mean of V over its listed blocks, as the reference's softmax over
    all-NEG_INF scores gives."""
    rng = np.random.default_rng(sum(starts))
    B, S, T, H, KVH, dqk, dv, bs, nb = 2, 64, 160, 8, 2, 48, 32, 16, 3
    q = rng.standard_normal((B, S, H, dqk)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, dqk)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, dv)).astype(np.float32)
    nqb = S // bs
    bidx = np.stack([[rng.permutation(T // bs)[:nb] for _ in range(nqb)]
                     for _ in range(B)]).astype(np.int32)
    valid = rng.random((B, nqb, nb)) > 0.3
    valid[0, 1] = False
    pos = (np.asarray(starts)[:, None] + np.arange(S)).astype(np.int32)
    kvp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want = np.asarray(jdsa.sparse_block_attention(
        *map(jnp.asarray, (q, k, v, bidx, valid, pos, kvp)), bs,
        softcap=softcap))
    ids = np.where(valid, bidx, -bidx - 1).astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, ids)]
    start = torch.tensor(starts, dtype=torch.int32)
    for parts in (1, 2, 4):
        got = sparse_tf32_arithmetic(*t, start, block_size=bs,
                                     softcap=softcap, empty_mean=True,
                                     parts=parts).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the empty query block took the mean, not 0
    rows = got[0, bs:2 * bs]
    assert np.abs(rows).max() > 0
