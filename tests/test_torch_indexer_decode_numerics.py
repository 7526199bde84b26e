"""PyTorch port: the arithmetic of K5's bf16 route, the decode form of the
indexer tensor-core body (``csrc/indexer_mma.cuh``, ``decode_kernel``,
through ``csrc/paged_indexer.cu``), written out in plain PyTorch on the
CPU and held against the JAX package's Pallas
``paged_indexer_scores_kernel`` in interpret mode and against the port's
plain K5.  The CUDA body itself runs only on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this file shows that
its numerics, not only its code, stay within the port's bounds.

The decode form gives each warp of a CTA the row's one token and keys of
its own, but a key's arithmetic is the span body's at one token
(``test_torch_indexer_mma_numerics.indexer_mma_arithmetic`` with S = 1):
each key's dot with each head's query sums exact bf16 x bf16 products in
fp32, 16 dims a k-step (one m16n8k16 product a step, the k-steps in
order); thread t of a quad holds heads n*8 + 2t and n*8 + 2t + 1 of each
n-tile n and sums w * (ReLU(dot) * scale) over them by fused
multiply-adds in that order; two xor shuffles add the quad's four sums
((t0 + t1) + (t2 + t3)).  A dead block (one that starts after the row's
position) is exactly NEG_INF and never read; an idle slot (length 0, its
table all the trash block) reads the trash block and stays finite.

Held against the Pallas kernel (fp32 throughout, fed the same bf16
values) and the plain K5 at the bf16 bound, 2e-2 scaled by
min(1, max|reference|), the dead blocks equal; the top-2048 sets the
selector takes agree except at near-ties of the 2048th score; Yi-6B's
16 x 64, GLM-5's 32 x 128 and zamba2 + DSA's 8 x 64 (one n-tile of
heads) indexer shapes, blocks of 16 and 32, a view of 2560 positions.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_indexer_scores_kernel as jax_indexer_scores
from repro_torch.kernels.paged_attention import kernel as K5
from test_torch_indexer_mma_numerics import (_inputs, _topk_sets,
                                             indexer_mma_arithmetic)

TOP_K = 2048
VIEW = 2560


def indexer_decode_arithmetic(q_idx, w_head, k_pool, tables, seq_lens):
    """K5's tensor-core decode form in plain PyTorch: q_idx (B, Hi, Di) and
    k_pool (nb, bs, Di) bf16 values, w_head (B, Hi) fp32, tables (B, mb),
    seq_lens (B,) -> scores (B, mb*bs) fp32."""
    return indexer_mma_arithmetic(q_idx, w_head, k_pool, tables, seq_lens,
                                  heads=q_idx.shape[1])[:, 0]


@functools.lru_cache(maxsize=None)
def _case(Hi, Di, bs):
    """Row 0 an idle slot; one position, mid-view, past the top-k, the
    view's last position; the Pallas kernel's and the plain K5's scores."""
    lens = [0, 1, 700, 2200, VIEW - 1]
    ins = _inputs(Hi + Di + bs, Hi, Di, bs, 1, lens, VIEW // bs)
    want = np.array(jax_indexer_scores(*map(jnp.asarray, ins),
                                       interpret=True))
    plain = K5.paged_indexer_scores_plain(
        *map(torch.from_numpy, ins)).numpy()
    return ins, want, plain


@pytest.mark.parametrize("Hi,Di", [(16, 64), (32, 128), (8, 64)])
@pytest.mark.parametrize("bs", [16, 32])
def test_indexer_decode_arithmetic_matches_pallas(Hi, Di, bs):
    ins, want, plain = _case(Hi, Di, bs)
    got = indexer_decode_arithmetic(*map(torch.from_numpy, ins)).numpy()
    dead = want <= -1e29
    assert dead.any() and np.array_equal(got <= -1e29, dead)
    assert (got[dead] == np.float32(-1e30)).all()      # NEG_INF exactly
    assert np.isfinite(got[0]).all()                   # the idle slot
    bound = 2e-2 * min(1.0, float(np.abs(np.where(dead, 0, want)).max()))
    for ref in (want, plain):
        err = float(np.abs(np.where(dead, 0, got - ref)).max())
        assert err <= bound, f"max abs err {err} > {bound}"
    # the selector's top-2048 sets: equal but where a score lies within
    # the bound of the 2048th
    lens = ins[-1]
    g_sel, _ = _topk_sets(torch.from_numpy(got), torch.from_numpy(lens),
                          TOP_K)
    w_sel, masked = _topk_sets(torch.from_numpy(want),
                               torch.from_numpy(lens), TOP_K)
    kth = masked.topk(TOP_K, dim=-1).values[:, -1:]
    differ = g_sel ^ w_sel
    assert not (differ & ((masked - kth).abs() > bound)).any()
