"""PyTorch port, MLA: plain K3/K4 vs the Pallas kernels, and ``core/mla.py``.

* The port's plain K3 (``paged_decode_mla_plain``) and K4
  (``paged_prefill_mla_plain``) — what the kernel wrappers run on CPU
  tensors — are held against the reference's Pallas kernels in interpret
  mode and against both packages' gather oracles, on the same numpy-seeded
  fp32 inputs: ragged rows (a trash row of length 0, 1, bs-1, bs, deep),
  shuffled tables, spans starting mid-block; two geometries (the GLM-5
  smoke dims H 4 / lora 32 / rope 16, and H 8 / lora 64 / rope 16), block
  sizes 8 and 16.  Tolerance atol 1e-5 (fp32, other summation order).
* ``mla_qkv``, ``apply_mla``, ``mla_decode_absorbed`` and
  ``mla_decode_paged`` (kernel and ref paths, a step and a span) on weights
  bridged from the JAX model agree with the reference's at rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import mla as jmla
from repro.kernels.paged_attention import ref as jref
from repro.kernels.paged_attention.kernel import \
    paged_decode_mla as jax_decode_mla
from repro.kernels.paged_attention.prefill import \
    paged_prefill_mla as jax_prefill_mla
from repro.models import get_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.core import mla as tmla
from repro_torch.kernels.paged_attention import kernel as K3
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import prefill as K4
from repro_torch.kernels.paged_attention import ref as tref

ATOL = 1e-5
RTOL_MODEL, ATOL_MODEL = 1e-4, 1e-5
GEOMETRIES = [(4, 32, 16), (8, 64, 16)]          # (H, lora, rope)
B, MB, S = 5, 5, 6
SCALE = 48 ** -0.5


def _inputs(seed, H, L, R, bs, span=None):
    """Latent pools with a trash block at the end and disjoint shuffled
    tables; decode row 0 is an idle slot (all trash, length 0)."""
    rng = np.random.default_rng(seed)
    nb = B * MB + 1
    c = rng.standard_normal((nb, bs, L)).astype(np.float32)
    kr = rng.standard_normal((nb, bs, R)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * MB].reshape(B, MB).astype(np.int32)
    rows = H if span is None else span * H
    q_lat = rng.standard_normal((B, rows, L)).astype(np.float32)
    q_rope = rng.standard_normal((B, rows, R)).astype(np.float32)
    if span is None:
        tables[0] = nb - 1
        pos = np.asarray([0, 1, bs - 1, bs, MB * bs - 1], np.int32)
    else:
        pos = np.asarray([0, bs - 1, bs + 3, 2, MB * bs - span], np.int32)
    return q_lat, q_rope, c, kr, tables, pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("H,L,R", GEOMETRIES)
def test_plain_mla_decode_matches_pallas_and_gather(H, L, R, bs):
    q_lat, q_rope, c, kr, tables, lens = _inputs(0, H, L, R, bs)
    want = np.asarray(jax_decode_mla(*_j(q_lat, q_rope, c, kr, tables, lens),
                                     scale=SCALE, interpret=True))
    got = K3.paged_decode_mla_plain(*_t(q_lat, q_rope, c, kr, tables, lens),
                                    scale=SCALE)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.isfinite(got.numpy()[0]).all()          # the trash row
    # gather oracles of both packages and the dispatch, model layout
    ql, qr = q_lat[:, None], q_rope[:, None]          # (B, 1, H, ·)
    want_ref = np.asarray(jref.paged_mla_reference(
        *_j(ql, qr, c, kr, tables, lens), scale=SCALE))
    got_ref = tref.paged_mla_reference(*_t(ql, qr, c, kr, tables, lens),
                                       scale=SCALE)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy()[1:], want_ref[1:, 0], atol=ATOL,
                               rtol=0)
    for impl in ("kernel", "ref"):
        got_ops = ops.paged_mla_attend(*_t(ql, qr, c, kr, tables, lens),
                                       scale=SCALE, impl=impl)
        np.testing.assert_allclose(got_ops.numpy()[1:], want_ref[1:],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("H,L,R", GEOMETRIES)
def test_plain_mla_prefill_matches_pallas_and_gather(H, L, R, bs):
    q_lat, q_rope, c, kr, tables, starts = _inputs(1, H, L, R, bs, span=S)
    want = np.asarray(jax_prefill_mla(
        *_j(q_lat, q_rope, c, kr, tables, starts), heads=H, scale=SCALE,
        interpret=True))
    got = K4.paged_prefill_mla_plain(
        *_t(q_lat, q_rope, c, kr, tables, starts), heads=H, scale=SCALE)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # model layout (B, S, H, ·): packed row i*H + h
    ql, qr = q_lat.reshape(B, S, H, L), q_rope.reshape(B, S, H, R)
    want_ref = np.asarray(jref.paged_mla_prefill_reference(
        *_j(ql, qr, c, kr, tables, starts), scale=SCALE))
    got_ref = tref.paged_mla_prefill_reference(
        *_t(ql, qr, c, kr, tables, starts), scale=SCALE)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy().reshape(B, S, H, L), want_ref,
                               atol=ATOL, rtol=0)
    for impl in ("kernel", "ref"):
        got_ops = ops.paged_mla_prefill(*_t(ql, qr, c, kr, tables, starts),
                                        scale=SCALE, impl=impl)
        np.testing.assert_allclose(got_ops.numpy(), want_ref, atol=ATOL,
                                   rtol=0)


def test_mla_kernel_argument_check_refuses_cpu_and_bad_shapes():
    q_lat, q_rope, c, kr, tables, lens = _t(*_inputs(2, 4, 32, 16, 8))
    with pytest.raises(ValueError):                   # not a CUDA tensor
        K3.check_cuda_mla_args(q_lat, q_rope, c, kr, tables, lens)
    with pytest.raises(ValueError):                   # S*H not a multiple
        K4.paged_prefill_mla_plain(q_lat, q_rope, c, kr, tables, lens,
                                   heads=3, scale=SCALE)


# ---------------------------------------------------------------------------
# core/mla.py on bridged weights
# ---------------------------------------------------------------------------

def _port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@pytest.fixture(scope="module")
def layer():
    """The attention weights of layer 0 of the GLM-5 smoke MLA baseline, in
    both packages, and an input sequence."""
    jcfg = get_smoke_config("glm5_744b").replace(dsa=None, mtp=None)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            _port_cfg(jcfg), device="cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    return jcfg, params["dense_0"]["attn"], model.layers[0].attn, model.cfg, x


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL_MODEL,
                               atol=ATOL_MODEL)


def test_mla_qkv_and_apply_mla_match_jax(layer):
    jcfg, jp, tp, cfg, x = layer
    pos = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32),
                          x.shape[:2]).copy()
    want = jmla.mla_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tmla.mla_qkv(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)
    _close(tmla.apply_mla(tp, torch.from_numpy(x), cfg,
                          positions=torch.from_numpy(pos)).numpy(),
           jmla.apply_mla(jp, jnp.asarray(x), jcfg,
                          positions=jnp.asarray(pos)))


def test_mla_decode_absorbed_matches_jax(layer):
    jcfg, jp, tp, cfg, x = layer
    m = cfg.mla
    Bn, T, split = x.shape[0], 16, 7
    jc = jnp.zeros((Bn, T, m.kv_lora_dim))
    jk = jnp.zeros((Bn, T, m.qk_rope_dim))
    tc = torch.zeros((Bn, T, m.kv_lora_dim))
    tk = torch.zeros((Bn, T, m.qk_rope_dim))
    for lo, hi in ((0, split), (split, split + 1), (split + 1, x.shape[1])):
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (Bn, hi - lo)).copy()
        want, jc, jk = jmla.mla_decode_absorbed(
            jp, jnp.asarray(x[:, lo:hi]), jcfg, c_cache=jc, kr_cache=jk,
            cache_index=jnp.asarray(lo, jnp.int32),
            positions=jnp.asarray(pos))
        got, tc2, tk2 = tmla.mla_decode_absorbed(
            tp, torch.from_numpy(x[:, lo:hi]), cfg, c_cache=tc,
            kr_cache=tk, cache_index=lo, positions=torch.from_numpy(pos))
        assert tc2 is tc and tk2 is tk                # written in place
        _close(got.numpy(), want)
        _close(tc.numpy(), jc)
        _close(tk.numpy(), jk)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_mla_decode_paged_matches_jax(layer, impl):
    jcfg, jp, tp, cfg, x = layer
    m = cfg.mla
    Bn, bs, mb = x.shape[0], 4, 4
    nb = Bn * mb + 1
    tables = np.random.default_rng(4).permutation(nb - 1)[:Bn * mb] \
        .reshape(Bn, mb).astype(np.int32)
    jc = jnp.zeros((nb, bs, m.kv_lora_dim))
    jk = jnp.zeros((nb, bs, m.qk_rope_dim))
    tc = torch.zeros((nb, bs, m.kv_lora_dim))
    tk = torch.zeros((nb, bs, m.qk_rope_dim))
    # a span starting at 0, a span starting mid-block, then one step
    for lo, hi in ((0, 6), (6, 10), (10, 11)):
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (Bn, hi - lo)).copy()
        want, jc, jk = jmla.mla_decode_paged(
            jp, jnp.asarray(x[:, lo:hi]), jcfg, c_pool=jc, kr_pool=jk,
            block_tables=jnp.asarray(tables), positions=jnp.asarray(pos),
            impl=impl if impl == "ref" else None)
        got, _, _ = tmla.mla_decode_paged(
            tp, torch.from_numpy(x[:, lo:hi]), cfg, c_pool=tc, kr_pool=tk,
            block_tables=torch.from_numpy(tables),
            positions=torch.from_numpy(pos), impl=impl)
        _close(got.numpy(), want)
        _close(tc.numpy(), jc)
        _close(tk.numpy(), jk)
