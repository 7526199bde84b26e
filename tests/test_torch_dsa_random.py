"""PyTorch port, DSA's randomized top-k (``deterministic_topk=False``).

The reference adds ``jax.random.uniform(jax.random.key(0), shape, fp32,
0, 1e-6)`` to the masked indexer scores before ``lax.top_k`` (the
RL-determinism study, GLM-5 §3.2).  The port draws its noise from a torch
generator seeded alike (``core.dsa.topk_noise``); here that function is
replaced by the reference's draw, so both packages see the same noise and
must select the same tokens:

* ``select_topk`` on all-tied and heavily tied scores: indices and
  validity equal the reference's element for element, under keys 1 and 2,
  and the two keys select differently (``tests/test_dsa.py``'s "differs
  on ties"); the port's own ``topk_noise`` at two seeds too, and at one
  seed twice the same;
* ``dsa_attention`` (S a multiple of the chunk: the reference scans and
  draws the same (B, q_chunk, T) for every chunk; S not a multiple: one
  (B, S, T) draw, which the port slices for its ragged chunks),
  ``dsa_decode_paged`` ((B, 1, T)) and ``dsa_prefill_paged`` (one (B, S,
  T) draw over the span, sliced for its chunks of 16) against the
  reference's at S > q_chunk, 2e-5; the draws' shapes are the reference's,
  and each case's selection differs from the deterministic one somewhere
  (the zero scores of keys every indexer head's ReLU cuts tie at the
  top-k boundary);
* logits at rtol 1e-4 for the Yi-6B, gemma2 and zamba2 smoke configs
  with DSA (top-k 64 < T) and the randomized top-k;
* the port's ``ContinuousEngine`` against JAX's, greedy tokens where the
  top-2 margin is >= 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DSAConfig as JaxDSAConfig
from repro.core import dsa as jdsa
from repro.models import get_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import from_jax_params
from repro_torch.core import dsa as tdsa
from repro_torch.models import get_model as port_get_model
from repro_torch.serving import ContinuousEngine, Request
from test_torch_dsa import (ATOL_MODEL, MARGIN, RTOL_MODEL, _close, _j,
                            _paged_setup, _qkv, _t, port_cfg)
from _torch_threads import one_torch_thread  # noqa: F401


def _random(cfg):
    """``cfg`` (either package's) with the randomized top-k."""
    return cfg.replace(dsa=dataclasses.replace(cfg.dsa,
                                               deterministic_topk=False))


def _jax_draw(shape, key=0):
    return np.array(jax.random.uniform(jax.random.key(key), tuple(shape),
                                       jnp.float32, 0.0, 1e-6))


@pytest.fixture
def jax_noise(monkeypatch):
    """``core.dsa.topk_noise`` replaced by the reference's draw; yields
    the shapes drawn."""
    shapes = []

    def draw(shape, device):
        shapes.append(tuple(shape))
        return torch.from_numpy(_jax_draw(shape)).to(device)
    monkeypatch.setattr(tdsa, "topk_noise", draw)
    yield shapes


# ---------------------------------------------------------------------------
# select_topk
# ---------------------------------------------------------------------------

def _tied_scores():
    """All tied, and small integers with exact zeros and masked runs."""
    rng = np.random.default_rng(3)
    heavy = np.round(rng.standard_normal((2, 8, 64)) * 2).astype(np.float32)
    heavy[:, :, 40:] = np.maximum(heavy[:, :, 40:], 0.0)
    mask = np.ones((2, 8, 64), bool)
    mask[:, 3, 10:30] = False
    return [(np.zeros((1, 4, 64), np.float32), np.ones((1, 4, 64), bool), 8),
            (heavy, mask, 16)]


@pytest.mark.parametrize("case", [0, 1], ids=["all_tied", "heavy_ties"])
def test_select_topk_with_the_references_noise(case):
    scores, mask, k = _tied_scores()[case]
    picks = []
    for key in (1, 2):
        want_idx, want_valid = jdsa.select_topk(
            *_j(scores, mask), k, deterministic=False,
            noise_key=jax.random.key(key))
        idx, valid = tdsa.select_topk(*_t(scores, mask), k,
                                      torch.from_numpy(_jax_draw(
                                          scores.shape, key)))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
        picks.append(idx.numpy())
    assert not np.array_equal(*picks)            # two keys differ on ties
    det, _ = tdsa.select_topk(*_t(scores, mask), k)
    assert not np.array_equal(det.numpy(), picks[0])


def test_topk_noise_is_fixed_by_its_seed(monkeypatch):
    scores = torch.zeros((1, 4, 64))
    mask = torch.ones((1, 4, 64), dtype=torch.bool)
    a = tdsa.topk_noise((1, 4, 64), "cpu")
    assert a.dtype == torch.float32 and 0 <= a.min() and a.max() < 1e-6
    assert torch.equal(a, tdsa.topk_noise((1, 4, 64), "cpu"))
    picks = []
    for seed in (1, 2):
        monkeypatch.setattr(tdsa, "TOPK_NOISE_SEED", seed)
        noise = tdsa.topk_noise(scores.shape, "cpu")
        picks.append(tdsa.select_topk(scores, mask, 8, noise)[0])
    assert not torch.equal(*picks)


# ---------------------------------------------------------------------------
# the DSA functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def random_layer():
    """Layer 0 of the Yi-6B smoke config with DSA (top-k 64, 2 indexer
    heads x 16) and the randomized top-k, in both packages."""
    jcfg = _random(get_smoke_config("yi_6b"))
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    jidx = jax.tree.map(lambda a: a[0], params["slot0"]["idx"])
    return jcfg, jidx, model.layers[0].idx, model.cfg


def _deterministic(cfg):
    return cfg.replace(dsa=dataclasses.replace(cfg.dsa,
                                               deterministic_topk=True))


@pytest.mark.parametrize("S,ref_chunk,chunk,draw", [
    (256, 64, 64, (2, 64, 256)),      # scanned: one draw, every chunk
    (100, 0, 32, (2, 100, 100)),      # one block: sliced, ragged chunks
    (100, 256, 256, (2, 100, 100))])
def test_dsa_attention_with_the_references_noise(random_layer, jax_noise, S,
                                                 ref_chunk, chunk, draw):
    jcfg, jidx, tidx, cfg = random_layer
    H, KVH, dh = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    q, k, v = _qkv(30 + S, B=2, S=S, T=S, H=H, KVH=KVH, dh=dh)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ki = rng.standard_normal((2, S, jcfg.dsa.index_head_dim)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jdsa.dsa_attention(jidx, *_j(q, k, v, x, ki, pos, pos), jcfg,
                              q_chunk=ref_chunk)
    with torch.no_grad():
        got = tdsa.dsa_attention(tidx, *_t(q, k, v, x, ki, pos, pos), cfg,
                                 q_chunk=chunk)
        det = tdsa.dsa_attention(tidx, *_t(q, k, v, x, ki, pos, pos),
                                 _deterministic(cfg), q_chunk=chunk)
    assert jax_noise == [draw]
    _close(got.numpy(), want)
    assert not np.allclose(det.numpy(), got.numpy(), rtol=0, atol=1e-4)


def test_dsa_attention_loss_path_with_the_references_noise(random_layer,
                                                           jax_noise):
    """The training form (checkpointed chunks, the indexer KL): the
    scanned reference's noise at S 256 in chunks of 128."""
    jcfg, jidx, tidx, cfg = random_layer
    S = 256
    H, KVH, dh = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    q, k, v = _qkv(40, B=1, S=S, T=S, H=H, KVH=KVH, dh=dh)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((1, S, jcfg.d_model)).astype(np.float32)
    ki = rng.standard_normal((1, S, jcfg.dsa.index_head_dim)) \
        .astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want, want_kl = jdsa.dsa_attention(
        jidx, *_j(q, k, v, x, ki, pos, pos), jcfg, q_chunk=128,
        with_indexer_loss=True)
    with torch.no_grad():
        got, kl = tdsa.dsa_attention(tidx, *_t(q, k, v, x, ki, pos, pos),
                                     cfg, q_chunk=128,
                                     with_indexer_loss=True)
    assert jax_noise == [(1, 128, S)]
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(kl), float(want_kl), rtol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_dsa_decode_paged_with_the_references_noise(random_layer, jax_noise,
                                                    impl):
    jcfg, jidx, tidx, cfg = random_layer
    B, mb, bs = 4, 8, 16
    rng, kp, vp, kip, tables = _paged_setup(50, jcfg, B, mb, bs)
    lens = np.asarray([0, 70, 90, mb * bs - 1], np.int32)   # top-k 64
    q = rng.standard_normal((B, 1, jcfg.num_heads, jcfg.head_dim)) \
        .astype(np.float32)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    qpos = lens[:, None].copy()
    args = (q, kp, vp, x, kip, tables, lens, qpos)
    want = jdsa.dsa_decode_paged(jidx, *_j(*args), jcfg)
    with torch.no_grad():
        got = tdsa.dsa_decode_paged(tidx, *_t(*args), cfg, impl=impl)
        det = tdsa.dsa_decode_paged(tidx, *_t(*args), _deterministic(cfg),
                                    impl=impl)
    assert jax_noise == [(B, 1, mb * bs)]
    _close(got.numpy(), want)
    assert not np.allclose(det.numpy(), got.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_dsa_prefill_paged_with_the_references_noise(random_layer, jax_noise,
                                                     impl):
    jcfg, jidx, tidx, cfg = random_layer
    B, mb, bs, S = 3, 8, 16, 37
    rng, kp, vp, kip, tables = _paged_setup(51, jcfg, B, mb, bs)
    starts = np.asarray([0, 70, mb * bs - S], np.int32)
    pos = starts[:, None] + np.arange(S, dtype=np.int32)[None]
    q = rng.standard_normal((B, S, jcfg.num_heads, jcfg.head_dim)) \
        .astype(np.float32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    args = (q, kp, vp, x, kip, tables, pos)
    want = jdsa.dsa_prefill_paged(jidx, *_j(*args), jcfg)
    with torch.no_grad():
        got = tdsa.dsa_prefill_paged(tidx, *_t(*args), cfg, impl=impl,
                                     q_chunk=16)
        det = tdsa.dsa_prefill_paged(tidx, *_t(*args), _deterministic(cfg),
                                     impl=impl, q_chunk=16)
    assert jax_noise == [(B, S, mb * bs)]           # one draw, 3 chunks
    _close(got.numpy(), want)
    assert not np.allclose(det.numpy(), got.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the models and the engine
# ---------------------------------------------------------------------------

def _model_cfg(name):
    if name == "yi_dsa":
        return _random(get_smoke_config("yi_6b"))
    if name == "gemma2_dsa":       # DSA on the global layers only
        return _random(get_smoke_config("gemma2_2b").replace(
            sliding_window=16))
    return _random(get_smoke_config("zamba2_2p7b"))


@pytest.mark.parametrize("name,S", [("yi_dsa", 256), ("yi_dsa", 100),
                                    ("gemma2_dsa", 256), ("zamba2_dsa", 200)])
def test_logits_with_the_references_noise(jax_noise, name, S):
    jcfg = _model_cfg(name)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    cfg = port_cfg(jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    toks = np.random.default_rng(12).integers(3, jcfg.vocab_size, (2, S))
    want = get_model(jcfg).logits(params, jnp.asarray(toks, jnp.int32), jcfg)
    M = port_get_model(cfg)
    with torch.no_grad():
        got = M.logits(model, torch.from_numpy(toks))
    assert jax_noise                                 # the noise was drawn
    _close(got.numpy(), want, rtol=RTOL_MODEL, atol=ATOL_MODEL)


def _margin_ok(model, prompt, out):
    seq = torch.from_numpy(np.concatenate([prompt, out[:-1]]).astype(np.int64))
    with torch.no_grad():
        lg = port_get_model(model.cfg).logits(model, seq[None])[
            0, len(prompt) - 1:]
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= MARGIN).all())


def test_engine_with_the_references_noise_matches_jax_engine(jax_noise):
    """GQA + DSA (top-k 16 of prompts up to 48 tokens), chunked prefill
    (spans of 16) and whole prompts, through both packages'
    ``ContinuousEngine`` with the same scheduling."""
    dsa = JaxDSAConfig(index_heads=2, index_head_dim=16, top_k=16,
                       block_size=16, deterministic_topk=False)
    jcfg = get_smoke_config("yi_6b").replace(
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256, dsa=dsa)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    rng = np.random.default_rng(16)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 40, 9, 48)]
    max_new = [6, 4, 5, 3]
    kw = dict(max_batch=2, block_size=8, num_blocks=40, max_len=64)
    compared = 0
    for chunk in (16, None):
        want = [JaxRequest(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        JaxEngine(jcfg, params, prefill_chunk=chunk, **kw).serve(want)
        eng = ContinuousEngine(model.cfg, model, prefill_chunk=chunk,
                               device="cpu", **kw)
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        eng.serve(reqs)
        for p, a, b in zip(prompts, reqs, want):
            assert a.status == "ok"
            if _margin_ok(model, p, b.out):
                compared += 1
                np.testing.assert_array_equal(a.out, b.out,
                                              err_msg=f"chunk {chunk}")
    assert jax_noise and compared >= 4
