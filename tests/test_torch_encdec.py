"""PyTorch port: the encoder-decoder (family ``audio``, whisper-base's
smoke config: 2 + 2 layers, 4 heads of 32, 64 frames) against the JAX
package.

The reference's ``encoder`` / ``decoder`` trees (each leaf stacked on a
``layers`` axis) are carried over by ``from_jax_params``; the frame
embeddings are ``0.01 · N(0, 1)`` from a numpy seed, as
``tests/test_models.py`` makes them:

* the bridge: every reference weight lands in the port's model, layer
  ``i`` of each stack from index ``i``;
* ``encode`` (bidirectional self-attention through K9, not causal) and the
  logits without a cache (the decoder's causal self-attention and
  cross-attention over the 64 frames, both through K9) against the
  reference's, fp32 rtol 1e-4;
* the loss and every gradient against ``jax.value_and_grad`` of the
  reference's ``loss``: the loss within rtol 1e-5, every gradient within
  rtol 1e-4 and 1e-5 of its leaf's max;
* ``prefill`` + ``decode_step`` over the contiguous cache: the logits
  against the reference's (run with a cache that holds no ``enc_out``, so
  the reference encodes the frames: its own ``init_cache`` gives an
  all-zero ``enc_out`` that its ``hidden`` reads in place of the frames),
  greedy tokens equal to JAX's where the top-2 margin is >= 1e-3, and
  decode = forward (each step's logits against the full forward's);
* ``launch.steps``' ``make_prefill_step`` / ``make_serve_step`` against the
  reference's; ``launch.train`` refusing the family (no frames).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import encdec as jencdec
from repro.models import get_model
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import encdec
from test_torch_dsa import MARGIN, port_cfg
from _torch_threads import one_torch_thread  # noqa: F401

B, S, NEW = 2, 24, 6


def _close(got, want, rtol=1e-4, atol=1e-5):
    """rtol, and atol as a share of max |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    jcfg = get_smoke_config("whisper_base")
    assert jcfg.family == "audio"
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    fe = (0.01 * rng.standard_normal((B, jcfg.encoder_seq_len,
                                      jcfg.d_model))).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32),
             "frontend_embeds": fe}
    return jcfg, params, params_np, model, batch


def test_bridge_places_every_leaf(pair):
    jcfg, _, params_np, model, _ = pair
    assert len(model.encoder) == jcfg.encoder_layers
    assert len(model.decoder) == jcfg.num_layers
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _jax_leaf(params_np, model.cfg, n))
    np.testing.assert_array_equal(model.decoder[1].cross.wq.numpy(),
                                  params_np["decoder"]["cross"]["wq"][1])


def test_encode_and_logits_match_jax(pair):
    jcfg, params, _, model, batch = pair
    fe = batch["frontend_embeds"]
    want_enc = jencdec.encode(params, jnp.asarray(fe), jcfg)
    want = jencdec.logits(params, jnp.asarray(batch["tokens"]), jcfg,
                          frontend_embeds=jnp.asarray(fe))
    with torch.no_grad():
        enc = encdec.encode(model, torch.from_numpy(fe))
        got = model(torch.from_numpy(batch["tokens"]), torch.from_numpy(fe))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=1e-4,
                               atol=1e-5)
    assert got.shape == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_loss_and_grads_match_jax(pair):
    jcfg, params, _, model, batch = pair
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jencdec.loss(p, jb, jcfg), has_aux=True))(params)
    model.requires_grad_(True)
    try:
        total, metrics = encdec.loss(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
        total.backward()
        assert set(metrics) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(jm[key]), rtol=1e-5, atol=1e-7)
        g_np = jax.tree.map(np.asarray, jg)
        for n, p in model.named_parameters():
            _close(p.grad.numpy(), _jax_leaf(g_np, model.cfg, n))
    finally:
        model.requires_grad_(False)
        model.zero_grad(set_to_none=True)


def _margin_ok(lg):
    top2 = torch.from_numpy(np.asarray(lg)).topk(2, dim=-1).values
    return bool(((top2[..., 0] - top2[..., 1]) >= MARGIN).all())


def test_prefill_decode_match_jax_and_forward(pair):
    jcfg, params, _, model, batch = pair
    toks, fe = batch["tokens"], batch["frontend_embeds"]
    T = S + NEW + 2
    jcache, _ = jencdec.init_cache(jcfg, B, T)
    jl, jcache = jencdec.prefill(params, jnp.asarray(toks), jcfg,
                                 {"self": jcache["self"]},
                                 frontend_embeds=jnp.asarray(fe))
    cache = encdec.init_cache(model.cfg, B, T, device="cpu")
    tl, cache = encdec.prefill(model, torch.from_numpy(toks), cache,
                               frontend_embeds=torch.from_numpy(fe))
    _close(tl.numpy(), jl)
    jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    seq, jlogits, tlogits = [toks], [jl], [tl]
    for step in range(NEW):
        jl, jcache = jencdec.decode_step(params, jtok, jcfg, jcache,
                                         jnp.asarray(S + step, jnp.int32))
        tl, cache = encdec.decode_step(model, ttok, cache, S + step)
        _close(tl.numpy(), jl)
        seq.append(ttok.numpy().astype(np.int32))
        jlogits.append(jl)
        tlogits.append(tl)
        jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    # greedy tokens equal where every step's top-2 margin holds
    jl_all = np.concatenate([np.asarray(x) for x in jlogits], axis=1)
    compared = 0
    for b in range(B):
        if _margin_ok(jl_all[b]):
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(x)[b] for x in seq[1:]]),
                jl_all[b, :-1].argmax(-1))
            compared += 1
    assert compared > 0, "no row had a top-2 margin to compare"
    # decode = forward: step t's logits are the forward's at S - 1 + t
    with torch.no_grad():
        full = encdec.logits(model, torch.from_numpy(np.concatenate(seq, 1)),
                             frontend_embeds=torch.from_numpy(fe))
    steps = torch.cat(tlogits, dim=1)
    _close(steps.numpy(), full[:, S - 1:].numpy())


def test_launch_steps_match_jax(pair):
    jcfg, params, _, model, batch = pair
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "frontend_embeds")}
    want = jax_prefill_step(jcfg)(params, jb)
    got = make_prefill_step(model)(
        {k: torch.from_numpy(batch[k]) for k in jb})
    _close(got.numpy(), want)
    T = S + 4
    jcache, _ = jencdec.init_cache(jcfg, B, T)
    _, jcache = jencdec.prefill(params, jb["tokens"], jcfg,
                                {"self": jcache["self"]},
                                frontend_embeds=jb["frontend_embeds"])
    cache = encdec.init_cache(model.cfg, B, T, device="cpu")
    encdec.prefill(model, torch.from_numpy(batch["tokens"]), cache,
                   frontend_embeds=torch.from_numpy(batch["frontend_embeds"]))
    tok = batch["targets"][:, -1:]
    want, _ = jax_serve_step(jcfg)(params, jnp.asarray(tok), jcache,
                                   jnp.asarray(S, jnp.int32))
    got, _ = make_serve_step(model)(torch.from_numpy(tok), cache, S)
    _close(got.numpy(), want)


def test_trainer_refuses_audio_without_frames():
    with pytest.raises(ValueError, match="frame embeddings"):
        ttrain.main(["--arch", "whisper-base", "--smoke", "--steps", "1",
                     "--device", "cpu"])
