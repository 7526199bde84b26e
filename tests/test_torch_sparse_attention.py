"""PyTorch port, K8 (block-sparse attention) and its entry points, on the
CPU against the JAX package.

The same numpy-seeded inputs, in fp32:

* the plain K8 (what the wrapper runs on CPU tensors, reached through
  ``ops.sparse_attend``) and the port's oracle ``ref.reference`` against
  the Pallas ``block_sparse_attention`` in interpret mode, on
  ``tests/test_kernels.py``'s three (block size, nb, softcap) cases (the
  diagonal block plus earlier ones, de-duplicated) and on a GQA case with
  -1 ids, through ``sparse_attend`` against the reference's; atol 3e-5;
* ``core.dsa.sparse_block_attention`` (K8's model form: queries from a
  per-row start, q/k head dim != v head dim, invalid blocks, a query block
  with none valid, softcap) against the JAX function, values and the
  gradients of q, k and v through the plain backward; atol 2e-5;
* ``dedupe_blocks`` element for element;
* on CPU tensors the wrapper runs the plain version and counts no launch;
  the kernel's argument check refuses them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsa as jdsa
from repro.kernels.sparse_attention import ops as jops
from repro.kernels.sparse_attention.kernel import \
    block_sparse_attention as pallas_sparse
from repro_torch.core import dsa as tdsa
from repro_torch.kernels.sparse_attention import kernel as K8
from repro_torch.kernels.sparse_attention import ops, ref

TOL = 3e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _pallas_case(bs, nb, seed):
    """tests/test_kernels.py's inputs: the diagonal block and earlier
    random ones a query block, duplicates mapped to -1."""
    rng = np.random.default_rng(seed)
    BH, S, T, d = 2, 4 * bs, 4 * bs, 64
    q = rng.standard_normal((BH, S, d)).astype(np.float32)
    k = rng.standard_normal((BH, T, d)).astype(np.float32)
    v = rng.standard_normal((BH, T, d)).astype(np.float32)
    nqb = S // bs
    diag = np.broadcast_to(np.arange(nqb)[None, :, None], (BH, nqb, 1))
    rnd = rng.integers(0, nqb, (BH, nqb, nb - 1))
    bidx = np.asarray(jops.dedupe_blocks(jnp.asarray(
        np.concatenate([diag, np.minimum(rnd, diag)], -1).astype(np.int32))))
    return q, k, v, bidx


@pytest.mark.parametrize("bs,nb,softcap", [(64, 2, 0.0), (64, 3, 50.0),
                                           (128, 2, 0.0)])
def test_plain_k8_matches_pallas_interpret(bs, nb, softcap):
    q, k, v, bidx = _pallas_case(bs, nb, bs + nb)
    want = pallas_sparse(*map(jnp.asarray, (q, k, v, bidx)), block_size=bs,
                         softcap=softcap)
    t = [torch.from_numpy(a.copy()) for a in (q, k, v, bidx)]
    _close(ref.reference(*t, block_size=bs, softcap=softcap).numpy(), want)
    # the model-layout entry point: one head per batch row
    got = ops.sparse_attend(t[0][:, :, None], t[1][:, :, None],
                            t[2][:, :, None], t[3], block_size=bs,
                            softcap=softcap)
    _close(got[:, :, 0].numpy(), want)


def test_plain_k8_gqa_matches_reference_sparse_attend():
    """GQA (8 query heads on 2 KV heads: the port's kernel maps heads, the
    reference repeats K/V), ids shared by the heads of a row, -1 ids and a
    repeated id (de-duplicated), softcap."""
    rng = np.random.default_rng(5)
    B, bs, H, KVH, d = 2, 32, 8, 2, 32
    S = T = 4 * bs
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    bidx = np.asarray([[[0, -1, 0], [1, 0, -1], [2, 0, 1], [3, 1, 1]],
                       [[0, 2, -1], [0, 1, 3], [-1, 2, 0], [3, 2, 0]]],
                      np.int32)
    want = jops.sparse_attend(*map(jnp.asarray, (q, k, v, bidx)),
                              block_size=bs, softcap=30.0, impl="pallas")
    got = ops.sparse_attend(*[torch.from_numpy(a) for a in (q, k, v, bidx)],
                            block_size=bs, softcap=30.0)
    _close(got.numpy(), want)


def test_dedupe_blocks_matches_jax():
    rng = np.random.default_rng(6)
    bidx = rng.integers(-1, 5, (3, 4, 6)).astype(np.int32)
    want = jops.dedupe_blocks(jnp.asarray(bidx))
    np.testing.assert_array_equal(
        ops.dedupe_blocks(torch.from_numpy(bidx)).numpy(), np.asarray(want))


def _block_inputs(seed, B=2, S=64, T=128, H=4, KVH=2, dqk=24, dv=16, bs=16,
                  nb=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dqk)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, dqk)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, dv)).astype(np.float32)
    nqb, nkb = S // bs, T // bs
    bidx = np.stack([[rng.permutation(nkb)[:nb] for _ in range(nqb)]
                     for _ in range(B)]).astype(np.int32)
    valid = rng.random((B, nqb, nb)) > 0.3
    valid[0, 1] = False                     # a query block with none valid
    return q, k, v, bidx, valid


@pytest.mark.parametrize("starts,softcap", [((0, 0), 0.0), ((37, 64), 50.0)])
def test_sparse_block_attention_matches_jax(starts, softcap):
    """K8's model form (the plain version on CPU tensors): q_start != 0,
    dqk != dv, queries that see no key take the mean of the gathered V as
    the reference's softmax over all-NEG_INF scores does; values and
    gradients."""
    q, k, v, bidx, valid = _block_inputs(7)
    B, S = q.shape[:2]
    T, bs = k.shape[1], 16
    pos = (np.asarray(starts)[:, None] + np.arange(S)).astype(np.int32)
    kvp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    g = np.random.default_rng(8).standard_normal(
        (B, S, q.shape[2], v.shape[-1])).astype(np.float32)

    def jfn(q_, k_, v_):
        out = jdsa.sparse_block_attention(
            q_, k_, v_, jnp.asarray(bidx), jnp.asarray(valid),
            jnp.asarray(pos), jnp.asarray(kvp), bs, softcap=softcap)
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tdsa.sparse_block_attention(
        tq, tk, tv, torch.from_numpy(bidx), torch.from_numpy(valid),
        torch.from_numpy(pos), bs, softcap=softcap)
    _close(got.detach().numpy(), want, 2e-5)
    got.backward(torch.from_numpy(g))
    for t, jg in zip((tq, tk, tv), jgrads):
        _close(t.grad.numpy(), jg, 2e-5)


def test_k8_wrapper_runs_plain_on_cpu_and_kernel_check_refuses_it():
    """CPU tensors run the plain version (no launch counted); the kernel's
    argument check refuses them."""
    q, k, v, bidx, _ = _block_inputs(9, dqk=64, dv=64)
    t = [torch.from_numpy(a) for a in (q, k, v, bidx)]
    start = torch.zeros((2,), dtype=torch.int32)
    before = K8.block_sparse_attention.launches
    got = K8.block_sparse_attention(*t, start, block_size=16)
    want = K8.block_sparse_attention_plain(*t, start, block_size=16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert K8.block_sparse_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        K8.check_cuda_args(*t, start, 16)
