"""The port's trainer against the reference's trainer, step by step.

``repro_torch.launch.train.train`` (its own loop: the Markov corpus
through the prefetch pipeline, the warm-up cosine schedule, the train
step, a checkpoint after every step) and the reference's trainer step
(``repro.launch.train``'s: ``jax.value_and_grad`` of the loss, the global
norm clip, Muon(+Split) with ``TrainConfig``'s weight decay, the learning
rate from ``warmup_cosine``) train the Yi-6B smoke config at 2 layers,
dense and with its DSA, from the same weights on the same batches: lr
2e-3 on the cosine with no warm-up, 3 steps, seed 0.  The reference's
step runs on the port's per-layer tree through a stacking shim
(``test_torch_async_rl._stacker``): Muon on its stacked tree sends the
norm scales of the scanned layers to Newton-Schulz (ROADMAP queue 3).

Each step's loss within 1e-5 relative; the parameters after each step,
read back from the trainer's checkpoints, within ``chip_smoke.py``'s
``train_parity`` bound of the reference's: 1e-3 x lr for every element,
plus, on an AdamW leaf, lr x min(2, 2 x sum |dg| / 1e-8) a step so far,
where the two trainers' clipped gradients of each step so far differ by
dg (AdamW's direction is a function of every gradient so far, each
within 2 / eps Lipschitz where |g| is near eps = 1e-8: at the published
vocabulary one of the 16.4M embedding elements, its gradient ~5e-11,
moved 0.47 % of a step apart in the first step).  The port's gradients are the ones its trainer handed Muon
(recorded around ``muon.global_norm_clip``): a recomputed gradient is not
bitwise the trainer's, and AdamW magnifies a gap of 1e-11 near eps.  Whether the loss falls over the 3 steps is the reference's
behaviour, whichever way it goes: the test records it and holds the port
to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import get_model
from repro.optim import muon as jmuon
from repro.optim import schedule as jschedule
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic
from repro_torch.data.pipeline import lm_generator
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.optim import muon
from test_torch_async_rl import _stacker
from test_torch_train import _ref_axes, port_cfg
from _torch_threads import one_torch_thread  # noqa: F401

LR, STEPS, SEED, BATCH, SEQ = 2e-3, 3, 0, 4, 128


def _reference_run(jcfg, params, specs, cfg, names):
    """The reference trainer's step on the per-layer tree for ``STEPS``
    steps; returns (losses, [params after each step], [clipped grads of
    each step]) as numpy by port name."""
    params_np = jax.tree.map(np.asarray, params)
    flat = {n: jnp.asarray(_jax_leaf(params_np, cfg, n)) for n in names}
    flat_specs = {n: _ref_axes(specs, cfg, n) for n in names}
    stack = _stacker(params, cfg)
    model = get_model(jcfg)
    tc = JaxTrainConfig(batch_size=BATCH, seq_len=SEQ, learning_rate=LR,
                        warmup_steps=0, total_steps=STEPS, seed=SEED)

    @jax.jit
    def train_step(p, opt_state, batch, lr):
        def loss_fn(q):
            return model.loss(stack(q), batch, jcfg)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        grads, _ = jmuon.global_norm_clip(grads, tc.grad_clip)
        p, opt_state = jmuon.update(
            p, grads, flat_specs, opt_state, lr=lr, cfg=jcfg,
            weight_decay=tc.weight_decay, split=tc.muon_split)
        return p, opt_state, loss, grads

    state = jmuon.init(flat)
    losses, after, grads = [], [], []
    # the port's corpus, which the trainer reads: the reference's builds
    # a dense V x V transition matrix (16 GB at V 64000); the two streams
    # are equal (test_torch_train.py::test_markov_stream_matches_reference)
    gen = lm_generator(jcfg.vocab_size, SEQ, BATCH, seed=SEED, steps=STEPS)
    for i, batch in enumerate(gen):
        lr = jschedule.warmup_cosine(i, peak=LR, floor=LR * 0.1, warmup=0,
                                     total=STEPS)
        flat, state, loss, g = train_step(
            flat, state, {k: jnp.asarray(v) for k, v in batch.items()}, lr)
        losses.append(float(loss))
        after.append({n: np.asarray(v) for n, v in flat.items()})
        grads.append({n: np.asarray(v) for n, v in g.items()})
    return losses, after, grads


@pytest.mark.parametrize("dsa,vocab", [(False, None), (True, None),
                                       (False, 64000)],
                         ids=["dense", "dsa", "dense_vocab64000"])
def test_trainer_steps_match_reference_trainer(dsa, vocab, tmp_path,
                                               monkeypatch):
    jcfg = get_smoke_config("yi_6b").replace(num_layers=2)
    if not dsa:
        jcfg = jcfg.replace(dsa=None)
    if vocab:
        jcfg = jcfg.replace(vocab_size=vocab)
    params, specs = get_model(jcfg).init(jax.random.key(SEED), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_cfg(jcfg), device="cpu")
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    axes = T.param_axes(model)
    want_losses, want_after, want_grads = _reference_run(
        jcfg, params, specs, cfg, names)

    # the clipped gradients each of the trainer's steps hands Muon
    used, clip = [], muon.global_norm_clip

    def recording_clip(grads, max_norm):
        grads, norm = clip(grads, max_norm)
        used.append({n: g.numpy().copy() for n, g in grads.items()})
        return grads, norm
    monkeypatch.setattr(muon, "global_norm_clip", recording_clip)
    tc = TrainConfig(batch_size=BATCH, seq_len=SEQ, learning_rate=LR,
                     warmup_steps=0, total_steps=STEPS, seed=SEED)
    hist = ttrain.train(cfg, tc, device="cpu", model=model, log_every=1,
                        ckpt_dir=str(tmp_path), ckpt_every=1)
    losses = [h["loss"] for h in hist]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert len(used) == STEPS
    like = {"params": model.state_dict()}
    slack, dg_sum = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for i, grads in enumerate(used):
        got, step = ckpt.restore(tmp_path / f"step_{i + 1}", like)
        assert step == i + 1
        for n in names:
            want = want_after[i][n]
            diff = np.abs(got["params"][n].numpy() - want)
            allowed = 1e-3 * LR
            if not muon._is_muon_param(axes[n], want.shape):
                # this step's AdamW direction reads every gradient so far
                dg_sum[n] = dg_sum[n] + np.abs(grads[n] - want_grads[i][n])
                slack[n] = slack[n] + LR * np.minimum(2 * dg_sum[n] / 1e-8,
                                                      2.0)
                allowed = allowed + slack[n]
            assert (diff <= allowed).all(), (
                f"step {i + 1} {n}: max diff {diff.max()}")
    # the reference's own trend, which the port follows: recorded, either
    # way (ROADMAP queue 3, PR 30's 2-layer trainer)
    print(f"losses {'dsa' if dsa else 'dense'}: reference {want_losses} "
          f"port {losses}")
    assert (losses[-1] < losses[0]) == (want_losses[-1] < want_losses[0])


def test_save_async_snapshots_cpu_tensors(tmp_path):
    """``save_async`` writes the values at the call, not those a trainer
    writes into the same CPU tensors while its thread runs (a CPU
    tensor's ``numpy()`` shares its storage)."""
    w = torch.arange(1 << 20, dtype=torch.float32)
    t = ckpt.save_async(tmp_path / "step_1", {"params": {"w": w}}, step=1)
    w.add_(1.0)                      # the next step, in place
    t.join()
    got, step = ckpt.restore(tmp_path / "step_1", {"params": {"w": w}})
    assert step == 1
    assert torch.equal(got["params"]["w"], w - 1.0)


def test_markov_tables_are_shared_and_read_only():
    """Every stream of one language reads one cached, read-only table."""
    a = synthetic.make_markov(97, 3)
    assert a is synthetic.make_markov(97, 3)
    assert not a[0].flags.writeable and not a[1].flags.writeable
    assert synthetic.make_markov(97, 4) is not a
