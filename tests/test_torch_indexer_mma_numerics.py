"""PyTorch port: the arithmetic of K6's bf16 route, the tensor-core span
body (``csrc/indexer_mma.cuh``'s ``span_kernel``), written out in plain
PyTorch on the CPU and held against the JAX package's Pallas
``paged_prefill_indexer`` in interpret mode.  The CUDA body itself runs
only on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this
file shows that its numerics, not only its code, stay within the port's
bounds.

The body's arithmetic: q and the keys are bf16 values; each key's dot
with each head's query sums exact bf16 x bf16 products in fp32, 16 dims a
k-step (one m16n8k16 product a step, the k-steps in order); the epilogue
takes the accumulator as it lies in a quad's four threads: thread t holds
heads n*8 + 2t and n*8 + 2t + 1 of each n-tile n, sums w * (ReLU(dot) *
scale) over them by fused multiply-adds in that order, and two xor
shuffles add the four threads' sums ((t0 + t1) + (t2 + t3)).  A dead
block (one that starts after the span's last position) is NEG_INF and
never read; an idle slot (a row of length 0 whose table is all the trash
block) reads the trash block and stays finite.

Held against the Pallas kernel (fp32 throughout, fed the same bf16 values)
at the bf16 bound, 2e-2 scaled by min(1, max|reference|), the dead blocks
equal; the top-k sets the selector takes from both agree except at
near-ties of the k-th score; Hi 8, 16 and 32 (1, 2 and 4 n-tiles: at 8,
zamba2's 8 x 64, each thread's two heads are the token's whole share of
its quad), Di 64 and 128, blocks of 8 and 16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.prefill import \
    paged_prefill_indexer as jax_prefill_indexer

NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _fma(a, b, c):
    """fp32 fused multiply-add: a*b + c rounded once (the product of two
    fp32 values is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def indexer_mma_arithmetic(q_idx, w_head, k_pool, tables, starts, *, heads):
    """K6's tensor-core body in plain PyTorch: q_idx (B, S*Hi, Di) and
    k_pool (nb, bs, Di) bf16 values, w_head (B, S*Hi) fp32, tables (B, mb),
    starts (B,) -> scores (B, S, mb*bs) fp32."""
    B, SH, Di = q_idx.shape
    Hi, S = heads, SH // heads
    bs, mb = k_pool.shape[1], tables.shape[1]
    scale = torch.tensor(Di ** -0.5, dtype=torch.float32)
    out = torch.full((B, S, mb * bs), NEG_INF)
    for b in range(B):
        live = ((int(starts[b]) + S - 1) // bs + 1) * bs   # first dead
        n_live = min(live, mb * bs)
        pos = torch.arange(n_live)
        keys = k_pool[tables[b, pos // bs].long(), pos % bs]   # (P, Di)
        q = q_idx[b].reshape(S, Hi, Di)
        dot = torch.zeros(S, Hi, n_live)
        for ks in range(0, Di, 16):                 # one k-step a product
            dot = dot + torch.einsum("shd,pd->shp", q[..., ks:ks + 16],
                                     keys[:, ks:ks + 16])
        v = torch.relu(dot) * scale                 # (S, Hi, P)
        w = w_head[b].reshape(S, Hi, 1)
        quad = []
        for t in range(4):                          # a quad's four threads
            s = torch.zeros(S, n_live)
            for n in range(Hi // 8):
                for u in range(2):
                    h = n * 8 + 2 * t + u
                    s = _fma(w[:, h].expand(S, n_live), v[:, h], s)
            quad.append(s)
        out[b, :, :n_live] = (quad[0] + quad[1]) + (quad[2] + quad[3])
    return out


def _inputs(seed, Hi, Di, bs, S, starts, mb):
    """Disjoint shuffled tables, row 0 an idle slot (every entry the trash
    block); q and the pool bf16 values; softmaxed head weights."""
    rng = np.random.default_rng(seed)
    B = len(starts)
    live = [0] + [(st + S - 1) // bs + 1 for st in starts[1:]]
    nb = sum(live) + 1
    tables = np.full((B, mb), nb - 1, np.int32)
    perm, at = rng.permutation(nb - 1), 0
    for b, n in enumerate(live):
        tables[b, :n] = perm[at:at + n]
        at += n

    def bf16_values(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return _bf16(x).numpy()
    w = torch.softmax(torch.from_numpy(
        rng.standard_normal((B, S, Hi)).astype(np.float32)), -1)
    return (bf16_values(B, S * Hi, Di), w.reshape(B, S * Hi).numpy(),
            bf16_values(nb, bs, Di), tables, np.asarray(starts, np.int32))


def _topk_sets(scores, qpos, k):
    """The selector's choice per row: the k best positions at or before the
    query's, ties to the lower index (a stable descending sort)."""
    P = scores.shape[-1]
    masked = torch.where(torch.arange(P)[None] <= qpos[:, None], scores,
                         -torch.inf)
    idx = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    sel = torch.zeros_like(masked, dtype=torch.bool)
    return sel.scatter_(1, idx[:, :k], True) & (masked > -torch.inf), masked


@pytest.mark.parametrize("Hi,Di", [(16, 64), (32, 128), (8, 64)])
@pytest.mark.parametrize("bs", [8, 16])
def test_indexer_mma_arithmetic_matches_pallas(Hi, Di, bs):
    S = 12
    starts = [0, 0, bs + bs // 2, 2 * bs, 5 * bs - 3]
    mb = (max(starts) + S) // bs + 2          # blocks past every span: dead
    ins = _inputs(Hi + Di + bs, Hi, Di, bs, S, starts, mb)
    want = np.array(jax_prefill_indexer(*map(jnp.asarray, ins), heads=Hi,
                                          interpret=True))
    got = indexer_mma_arithmetic(*map(torch.from_numpy, ins),
                                 heads=Hi).numpy()
    dead = want <= -1e29
    assert dead.any() and np.array_equal(got <= -1e29, dead)
    assert np.isfinite(got[0]).all()                  # the idle slot
    bound = 2e-2 * min(1.0, float(np.abs(np.where(dead, 0, want)).max()))
    err = float(np.abs(np.where(dead, 0, got - want)).max())
    assert err <= bound, f"max abs err {err} > {bound}"
    # the selector's top-k sets: equal but where a score lies within the
    # bound of the k-th
    k = 24
    for b, st in enumerate(starts):
        qpos = torch.from_numpy(st + np.arange(S))
        g_sel, _ = _topk_sets(torch.from_numpy(got[b]), qpos, k)
        w_sel, masked = _topk_sets(torch.from_numpy(want[b]), qpos, k)
        kth = masked.topk(k, dim=-1).values[:, -1:]
        differ = g_sel ^ w_sel
        assert not (differ & ((masked - kth).abs() > bound)).any()
