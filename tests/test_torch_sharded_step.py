"""The port's step on more than one rank against the reference's.

Four gloo processes on the CPU form a (2, 2) ``('data', 'model')`` mesh
over a ``FileStore`` (``_torch_sharded_worker.py``); one JAX process on
four host devices forms the same mesh (``_torch_sharded_reference.py``,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  Both start once
for the file and run side by side.  The cases (``_torch_sharded_cases``):
Yi-6B smoke without DSA (dense GQA), GLM-5 smoke (MLA + DSA + MoE + MTP,
the expert-parallel MoE at 'model' 2, capacity 1.25, so assignments drop)
and zamba2 smoke (the hybrid), fp32, weights from numpy seed 0 in the
reference's tree, carried over to the port by ``bridge.from_jax_params``.

The port's parameters, batches and caches are placed
(``sharding.rules.place_params`` / ``place_batch``,
``launch.specs.place_cache``) and its ``launch.steps`` run on them: the
prefill step, one serve step against a filled cache, then two train steps
(Muon with ``muon_sharded_ns``).  The reference's steps run under
``jax.jit`` with its rules' ``in_shardings``.  Bounds: each step's loss
within 1e-5 relative; the parameters after each step within
``chip_smoke.py``'s ``train_parity`` bound (1e-3 x lr an element, plus on
an AdamW leaf lr x min(2, 2 x sum |dg| / 1e-8), dg the two sides' clipped
gradients' difference so far: AdamW's direction is 2 / eps Lipschitz
where a gradient is near eps); logits at rtol 1e-4 (atol 1e-5).  GLM-5's
first MoE layer alone: the same number of dropped assignments, counted
shard by shard by each side's own dispatch (and some), its output within
3e-5 (the EP bound of ``test_torch_moe_ep.py``).  For the dense and the
hybrid model the sharded steps also equal the port's one-rank steps
(plain tensors, no mesh) within the same bounds; GLM-5's cannot, as its
drops depend on the mesh.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_sharded_cases as C
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import dsa as tdsa
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import get_model
from repro_torch.optim import muon
from _torch_sharded_worker import _fill
from _torch_threads import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
RTOL, ATOL = 1e-4, 1e-5
EP_TOL = 3e-5
ONE_RANK = ("yi_6b", "zamba2_2p7b")
TIMEOUT = 600


def _weights(jcfg, rng) -> dict:
    """The reference's parameter tree (its abstract init's leaves) filled
    from ``rng``: norm scales and ``D`` near 1, the SSM biases and
    ``A_log`` small, the embedding at 1, the router and the indexer's
    head weights at the reference's 0.02, the conv filter at 1 / width,
    every other matrix at fan-in^-1/2."""
    abstract, _ = jax_model(jcfg).init(jax.random.key(0), jcfg,
                                       abstract=True)

    def leaf(path, a):
        name, z = path[-1].key, rng.standard_normal(a.shape)
        if name.endswith("norm") or name == "D":
            z = 1.0 + 0.1 * z
        elif name in ("conv_b", "dt_bias", "A_log"):
            z = 0.1 * z
        else:
            z = z * {"embedding": 1.0, "router": 0.02, "w_head": 0.02,
                     "conv_w": 1.0 / a.shape[-2]}.get(name,
                                                      a.shape[-2] ** -0.5)
        return z.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _inputs() -> dict:
    """The weights (numpy, seed 0, in the reference's tree), the batches,
    the prompts and the filled caches of every case."""
    rng = np.random.default_rng(0)
    out = {}
    for name in C.CASES:
        jcfg = jax_smoke_config(name).replace(**C.OVERRIDES[name])
        params = _weights(jcfg, rng)
        out.update(C.flatten(params, f"{name}/params"))
        cfg = get_smoke_config(name).replace(**C.OVERRIDES[name])
        model = from_jax_params(params, cfg, device="cpu")
        out[f"{name}/names"] = np.array([n for n, _ in
                                         model.named_parameters()])
        V = cfg.vocab_size
        out[f"{name}/prefill/tokens"] = rng.integers(
            0, V, (C.BATCH, C.PREFILL), dtype=np.int32)
        out[f"{name}/serve/token"] = rng.integers(0, V, (C.BATCH, 1),
                                                  dtype=np.int32)
        cache = get_model(cfg).init_cache(cfg, C.BATCH, C.CACHE_LEN,
                                          device="cpu")
        for k, v in C.flatten(cache, f"{name}/cache").items():
            scale = 0.1 if k.endswith("/ssm") else 1.0
            out[k] = (rng.standard_normal(v.shape) * scale).astype(v.dtype)
        for i in range(C.STEPS):
            toks = rng.integers(0, V, (C.BATCH, C.SEQ + 1), dtype=np.int32)
            mask = (rng.random((C.BATCH, C.SEQ)) < 0.9).astype(np.float32)
            out[f"{name}/batch{i}/tokens"] = toks[:, :-1]
            out[f"{name}/batch{i}/targets"] = toks[:, 1:]
            out[f"{name}/batch{i}/loss_mask"] = mask
    # tokens that share a direction, so the router sends most of them to
    # the same experts and the capacity drops assignments; 0.1 the scale
    # of test_torch_moe_ep.py's inputs
    D, a = get_smoke_config("glm5_744b").d_model, C.EP_X_SHARED
    x = rng.standard_normal((C.BATCH, C.SEQ, D)) + a * rng.standard_normal(D)
    out["ep/x"] = (0.1 * x / np.sqrt(1 + a * a)).astype(np.float32)
    return out


def _one_rank(name, data) -> dict:
    """The port's steps on plain tensors, without a mesh."""
    cfg = get_smoke_config(name).replace(**C.OVERRIDES[name])
    M = get_model(cfg)
    model = from_jax_params(C.unflatten(data, f"{name}/params"), cfg,
                            device="cpu")
    res = {"prefill": make_prefill_step(model)({"tokens": torch.from_numpy(
        data[f"{name}/prefill/tokens"])}).numpy()}
    cache = M.init_cache(cfg, C.BATCH, C.CACHE_LEN, device="cpu")
    _fill(cache, data, f"{name}/cache")
    logits, _ = make_serve_step(model)(torch.from_numpy(
        data[f"{name}/serve/token"]), cache, C.CACHE_INDEX)
    res["serve"] = logits.numpy()
    params = dict(model.named_parameters())
    grads, clip = [], muon.global_norm_clip

    def recording_clip(g, max_norm):
        g, norm = clip(g, max_norm)
        grads.append({k: v.numpy().copy() for k, v in g.items()})
        return g, norm
    muon.global_norm_clip = recording_clip
    try:
        state = muon.init(params, M.param_axes(model))
        step = make_train_step(model, train_cfg=TrainConfig(), lr=C.LR)
        for i in range(C.STEPS):
            batch = {k: torch.from_numpy(data[f"{name}/batch{i}/{k}"])
                     for k in ("tokens", "targets", "loss_mask")}
            state, metrics = step(state, batch)
            res[f"loss{i}"] = float(metrics["loss"])
            for n, p in params.items():
                res[f"params{i}/{n}"] = p.detach().numpy().copy()
                res[f"grads{i}/{n}"] = grads[-1][n]
    finally:
        muon.global_norm_clip = clip
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results, the port's sharded results, the
    port's one-rank results): the reference's process and the four gloo
    ranks run side by side while this process runs the one-rank steps."""
    d = tmp_path_factory.mktemp("sharded")
    data = _inputs()
    np.savez(d / "inputs.npz", **data)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}",
               OMP_NUM_THREADS="1")
    # each process writes its output to a file (a pipe left unread while
    # this process works could fill and stop it)
    logs = [d / f"{n}.log" for n in ["reference"] + [f"rank{r}" for r in
                                                     range(C.WORLD)]]
    procs = []
    try:
        with open(logs[0], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(TESTS / "_torch_sharded_reference.py"),
                 str(d / "inputs.npz"), str(d / "reference.npz")],
                env=dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
                    "--xla_force_host_platform_device_count=4")),
                stdout=out, stderr=subprocess.STDOUT))
        for r in range(C.WORLD):
            with open(logs[r + 1], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(TESTS / "_torch_sharded_worker.py"),
                     str(r), str(d / "store"), str(d / "inputs.npz"),
                     str(d / "port.npz")],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        one = {name: _one_rank(name, data) for name in ONE_RANK}
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return (data, np.load(d / "reference.npz"), np.load(d / "port.npz"),
            one)


def _within_train_parity(name, got, want, axes):
    """``train_parity``'s bound on the parameters after every step; got /
    want map ``params{i}/<n>`` and ``grads{i}/<n>`` to arrays."""
    slack, dg_sum = {}, {}
    for i in range(C.STEPS):
        for n, ax in axes.items():
            w = want[f"params{i}/{n}"]
            diff = np.abs(got[f"params{i}/{n}"] - w)
            allowed = 1e-3 * C.LR
            if not muon._is_muon_param(ax, w.shape):
                dg_sum[n] = dg_sum.get(n, 0.0) + np.abs(
                    got[f"grads{i}/{n}"] - want[f"grads{i}/{n}"])
                slack[n] = slack.get(n, 0.0) + C.LR * np.minimum(
                    2 * dg_sum[n] / 1e-8, 2.0)
                allowed = allowed + slack[n]
            assert (diff <= allowed).all(), (
                f"{name} step {i + 1} {n}: max diff {diff.max()}")


def _case(res, name):
    """The ``name/`` entries of a results file, without the prefix."""
    return {k[len(name) + 1:]: res[k] for k in res.files
            if k.startswith(name + "/")}


def _axes(name):
    cfg = get_smoke_config(name).replace(**C.OVERRIDES[name])
    M = get_model(cfg)
    return M.param_axes(M.init(cfg, device="meta"))


@pytest.mark.parametrize("name", C.CASES)
def test_train_loss_matches_reference(runs, name):
    _, ref, port, _ = runs
    for i in range(C.STEPS):
        np.testing.assert_allclose(port[f"{name}/loss{i}"],
                                   ref[f"{name}/loss{i}"], rtol=1e-5)


@pytest.mark.parametrize("name", C.CASES)
def test_train_params_match_reference(runs, name):
    _, ref, port, _ = runs
    _within_train_parity(name, _case(port, name), _case(ref, name),
                         _axes(name))


@pytest.mark.parametrize("name", C.CASES)
def test_prefill_logits_match_reference(runs, name):
    _, ref, port, _ = runs
    np.testing.assert_allclose(port[f"{name}/prefill"],
                               ref[f"{name}/prefill"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", C.CASES)
def test_serve_logits_match_reference(runs, name):
    _, ref, port, _ = runs
    np.testing.assert_allclose(port[f"{name}/serve"], ref[f"{name}/serve"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ONE_RANK)
def test_sharded_steps_equal_one_rank(runs, name):
    _, _, port, one = runs
    got, one = _case(port, name), one[name]
    for what in ("prefill", "serve"):
        np.testing.assert_allclose(got[what], one[what], rtol=RTOL,
                                   atol=ATOL)
    for i in range(C.STEPS):
        np.testing.assert_allclose(got[f"loss{i}"], one[f"loss{i}"],
                                   rtol=1e-5)
    _within_train_parity(name, got, one, _axes(name))


def test_indexer_warmup_on_the_mesh(runs):
    """``freeze="all_but_indexer"`` on the placed GLM-5: the frozen leaves
    bitwise as they were, every indexer leaf moved (the mesh's own
    invariants: the reference's warm-up is ``benchmarks.common.train_lm``
    on one device, held in ``test_torch_dsa_warmup.py``)."""
    _, _, port, _ = runs
    assert float(port["glm5_744b/warmup/frozen_max"]) == 0.0
    assert float(port["glm5_744b/warmup/indexer_min"]) > 0.0


def test_topk_noise_is_the_whole_batch_draw_sliced():
    """A rank's randomized top-k noise is its rows of the draw at the
    whole batch's shape, as the reference draws once for the batch: one
    (B, S, T) draw where S is not a multiple of the query chunk, one (B,
    q_chunk, T) for every chunk where it is."""
    dsa = dataclasses.replace(get_smoke_config("glm5_744b").dsa,
                              deterministic_topk=False)
    B, T, chunk = 4, 48, 16
    for S, want in ((40, tdsa.topk_noise((B, 40, T), "cpu")[:, 16:32]),
                    (64, tdsa.topk_noise((B, chunk, T), "cpu"))):
        for lo in (0, 2):
            got = tdsa._chunk_noise(dsa, 2, S, T, chunk, "cpu",
                                    (B, lo, lo + 2))(16, 32)
            torch.testing.assert_close(got, want[lo:lo + 2], rtol=0, atol=0)


def test_ep_layer_drops_match_reference(runs):
    _, ref, port, _ = runs
    assert int(port["ep/drops"]) == int(ref["ep/drops"]) > 0
    np.testing.assert_allclose(port["ep/y"], ref["ep/y"], atol=EP_TOL,
                               rtol=EP_TOL)
    np.testing.assert_allclose(port["ep/aux"], ref["ep/aux"], rtol=1e-5)


def test_dense_layer_matches_reference(runs):
    """The dense path on placed tensors against the reference's on the
    mesh: the same output, and the load-balance loss of the whole batch
    (the EP path's is the mean of its batch shards')."""
    _, ref, port, _ = runs
    np.testing.assert_allclose(port["dense/y"], ref["dense/y"],
                               atol=EP_TOL, rtol=EP_TOL)
    np.testing.assert_allclose(port["dense/aux"], ref["dense/aux"],
                               rtol=1e-5)
