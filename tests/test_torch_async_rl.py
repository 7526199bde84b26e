"""PyTorch port, the asynchronous RL loop on the CPU: ``pack_groups``,
``AsyncTrainer``, ``RolloutEngine`` and the ``Orchestrator``.

With the reference tests' tiny GQA config (``tests/_torch_families.py``)
and its JAX weights bridged into the port, fp32, against the JAX package:

* ``pack_groups``: the reference's arrays, element for element (prompts
  of several lengths left-padded, long ones cut from the left, loss masks);
* ``AsyncTrainer.train_on`` on hand-built groups against JAX's
  ``AsyncTrainer``, a step at a time: loss, kept, ratio and grad_norm
  within 1e-5 relative,
  every parameter after the step within ``test_torch_train.py``'s Muon
  bound (rtol 1e-4, atol 1e-6 of the leaf's max; the AdamW leaves also
  1 % of one AdamW step, ``_assert_same_params``).  JAX's trainer runs on
  the port's one-leaf-per-layer tree (its forward stacks it back into the
  reference's layout), as ``test_torch_train.py`` compares Muon: on the
  reference's stacked tree Muon would orthogonalize the stacked norm
  scales (ROADMAP queue 3);
  then the push at ``push_every``: the engines get the trainer's version
  and values, and the optimizer restarts from zeros;
* the slice as a whole: two rounds of rollouts through
  ``generate_batch`` (one fp32 engine, temperature 1, two GRPO groups of
  four on a shared prefix), each followed by ``train_on`` and a push,
  against the same loop in the JAX package: tokens, behaviour logprobs
  (1e-4), versions, the trainer's metrics and the parameters;
* mirrors of ``tests/test_async_frontend.py``'s orchestrator tests (a
  crashed worker deregisters and ``wait_for_groups`` raises, a group beats
  between rollouts, the happy path, the serving backend running whole
  groups, an unknown backend refused) and of
  ``tests/test_fault_tolerance.py``'s ``worker`` / ``beat`` env-spec test,
  also with the two points armed explicitly.

Every front-end is closed and every orchestrator stopped in a
``finally``; every wait has a timeout.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import family
from repro.async_rl.rollout import RolloutEngine as JaxRollout
from repro.async_rl.tito import Trajectory as JaxTraj
from repro.async_rl.trainer import AsyncTrainer as JaxTrainer
from repro.async_rl.trainer import pack_groups as jax_pack
from repro.models import get_model as jax_model
from repro.rl.rewards import prefix_reward
from repro_torch.async_rl import (AsyncTrainer, HeartbeatMonitor,
                                  Orchestrator, RolloutEngine, TaskService,
                                  TitoGateway, Trajectory)
from repro_torch.async_rl.trainer import pack_groups
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.faults import FaultInjector
from repro_torch.models import transformer as T
from test_torch_train import _ref_axes

T_OUT = 60.0


# ---------------------------------------------------------------------------
# the reference's trainer on the port's per-layer tree
# ---------------------------------------------------------------------------

def _stacker(params, cfg):
    """flat {port name: array} -> the reference's stacked tree (``slotJ``
    leaves stacked over the pattern groups, ``dense_i`` as they are)."""
    P = len(cfg.attention_pattern)
    ng = (cfg.num_layers - cfg.first_k_dense) // P

    def names(path):
        keys = [p.key for p in path]
        top, rest = keys[0], ".".join(keys[1:])
        if top.startswith("slot"):
            j = int(top[4:])
            return [f"layers.{cfg.first_k_dense + g * P + j}.{rest}"
                    for g in range(ng)]
        if top.startswith("dense_"):
            return f"layers.{int(top[6:])}.{rest}"
        return ".".join(keys)

    def stack(flat):
        def leaf(path, _):
            n = names(path)
            return jnp.stack([flat[x] for x in n]) if isinstance(n, list) \
                else flat[n]
        return jax.tree_util.tree_map_with_path(leaf, params)
    return stack


class _StackedModel:
    """The reference model's ``logits`` over a per-layer tree."""

    def __init__(self, model, stack):
        self.model, self.stack = model, stack

    def logits(self, flat, tokens, cfg):
        return self.model.logits(self.stack(flat), tokens, cfg)


class _StackedEngine:
    """A reference ``RolloutEngine`` fed per-layer pushes."""

    def __init__(self, engine, stack):
        self.engine, self.stack = engine, stack

    def push_weights(self, flat, version):
        self.engine.push_weights(self.stack(flat), version)


def _pair(engines=(), jax_engines=(), **kw):
    """(port trainer, JAX trainer) from the same weights; the port's model
    is a fresh copy."""
    jcfg, params, base = family("gqa")
    params_np = jax.tree.map(np.asarray, params)
    model = from_jax_params(params_np, base.cfg, device="cpu")
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    _, specs = jax_model(jcfg).init(jax.random.key(0), jcfg, abstract=True)
    flat = {n: jnp.asarray(_jax_leaf(params_np, cfg, n)) for n in names}
    flat_specs = {n: _ref_axes(specs, cfg, n) for n in names}
    stack = _stacker(params, cfg)
    jt = JaxTrainer(jcfg, flat, flat_specs,
                    engines=[_StackedEngine(e, stack) for e in jax_engines],
                    **kw)
    jt.model = _StackedModel(jt.model, stack)
    pt = AsyncTrainer(cfg, model, T.param_axes(model), engines=list(engines),
                      device="cpu", **kw)
    return pt, jt


def _assert_same_params(pt, jt):
    """``test_torch_train.py``'s Muon bound on every parameter; the AdamW
    leaves (vocabulary and norms) also within 1 % of one AdamW step
    (lr x 1e-2): an element whose gradient is near AdamW's eps (1e-8)
    moves by lr x g / (|g| + eps), which the gradient's last bits set
    (measured: 7.8e-3 of a step on 2 of the 32768 unembedding elements).
    A wrong sign, bias correction or moment would move a whole step."""
    for n, p in pt.params.named_parameters():
        want = np.asarray(jt.params[n])
        step = pt.lr * 1e-2 if n in pt.opt_state.second else 0.0
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-4,
            atol=1e-6 * max(np.abs(want).max(), 1e-30) + step, err_msg=n)


def _assert_same_metrics(mp, mj):
    assert set(mp) == set(mj)
    for k in ("loss", "kept", "ratio", "grad_norm", "mean_reward"):
        np.testing.assert_allclose(mp[k], mj[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert mp["version"] == mj["version"]


# ---------------------------------------------------------------------------
# pack_groups and one step
# ---------------------------------------------------------------------------

def _groups(seed, cls, *, plen=8, lens=(3, 7), n_groups=2, G=4, lps=None):
    """Hand-built GRPO groups: one prompt a group, tokens of ragged
    lengths, behaviour logprobs (given, or random), loss masks on some."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for g in range(n_groups):
        prompt = rng.integers(3, 256, size=plen + g).astype(np.int32)
        group = []
        for i in range(G):
            n = int(rng.integers(*lens))
            toks = rng.integers(3, 256, size=n).astype(np.int32)
            lp = (-rng.random(n) * 3).astype(np.float32)
            if lps is not None:
                lp = lps[k][:n].astype(np.float32)
            mask = (rng.random(n) > 0.2).astype(np.float32) if i == 1 \
                else None
            group.append(cls(rollout_id=f"r{k}", task="t", prompt=prompt,
                             tokens=toks, logprobs=lp, versions=[0],
                             reward=float(rng.random()), loss_mask=mask))
            k += 1
        out.append(group)
    return out


def test_pack_groups_matches_reference():
    for plen, pad in ((8, 8), (12, 4), (4, 6)):
        got = pack_groups(_groups(0, Trajectory, plen=plen), pad, plen)
        want = jax_pack(_groups(0, JaxTraj, plen=plen), pad, plen)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if isinstance(got[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k


def _on_policy_groups(model, seed, noise=0.05):
    """Groups whose behaviour logprobs are the model's own, perturbed, so
    the calibration mask keeps most tokens and drops a few."""
    plain = _groups(seed, Trajectory)
    batch = pack_groups(plain, 8, 8)
    with torch.no_grad():
        lg = T.logits(model, torch.from_numpy(batch["tokens"]).long())
    lp = torch.log_softmax(lg[:, 7:-1].float(), -1).gather(
        -1, torch.from_numpy(batch["tokens"][:, 8:]).long()[..., None])[..., 0]
    rng = np.random.default_rng(seed + 100)
    lp = lp.numpy() + rng.normal(0, noise, lp.shape).astype(np.float32)
    lp[0, 0] += 1.0                              # one token masked for sure
    return (_groups(seed, Trajectory, lps=lp), _groups(seed, JaxTraj, lps=lp))


def test_train_on_matches_jax_trainer_then_pushes_and_resets():
    """One step against JAX's trainer (metrics and every parameter), then
    the second: the push at ``push_every`` and the optimizer's reset."""
    _, _, base = family("gqa")
    eng = RolloutEngine(base.cfg, base, engine_dtype=torch.float32,
                        device="cpu")
    pt, jt = _pair(engines=[eng], lr=1e-3, push_every=2)
    for step in (1, 2):
        ours, ref = _on_policy_groups(pt.params, step)
        mp = pt.train_on(ours, pad_to=8, prompt_pad=8)
        _assert_same_metrics(mp, jt.train_on(ref, pad_to=8, prompt_pad=8))
        assert 0.5 < mp["kept"] < 1.0 and mp["grad_norm"] > 0
        snap, version = eng.snapshot()
        if step == 1:                 # no push yet; Muon state carried
            assert version == 0
            assert pt.opt_state.count == int(jt.opt_state.count) == 1
            assert any(m.abs().max() > 0
                       for m in pt.opt_state.momentum.values())
            _assert_same_params(pt, jt)
    assert version == 2 == pt.version
    for n, p in snap.named_parameters():
        torch.testing.assert_close(p, pt.params.get_parameter(n).detach(),
                                   rtol=0, atol=0)
    # the optimizer restarts after the push, as the reference's
    assert pt.opt_state.count == int(jt.opt_state.count) == 0
    assert all(not m.any() for m in pt.opt_state.momentum.values())
    assert all(not v.any() for v in pt.opt_state.second.values())
    _assert_same_params(pt, jt)


# ---------------------------------------------------------------------------
# the slice as a whole: rollouts -> train -> push, twice, against JAX
# ---------------------------------------------------------------------------

_SERVE = dict(max_batch=1, block_size=8, num_blocks=64, max_len=64)
_PLEN, _NEW, _G = 16, 6, 4


def _round(engine, gateway, problems, rnd):
    """One round: a GRPO group of ``_G`` rollouts a problem through
    ``generate_batch`` (one request at a time: the sampling order is the
    submission order whatever the serve thread's timing), rewarded by
    ``prefix_reward`` against the problem's answer."""
    cls = Trajectory if isinstance(gateway, TitoGateway) else JaxTraj
    groups, seen = [], []
    for prompt, answer in problems:
        rids = [gateway.new_rollout("copy") for _ in range(_G)]
        outs = engine.generate_batch(rids, [prompt] * _G, _NEW,
                                     temperature=1.0, **_SERVE)
        group = []
        for rid, out in zip(rids, outs):
            t = gateway.finish(rid, "copy", prompt,
                               prefix_reward(out, answer))
            assert isinstance(t, cls) and t.versions == [rnd]
            seen.append((np.asarray(t.tokens), np.asarray(t.logprobs),
                         list(t.versions)))
            group.append(t)
        groups.append(group)
    return groups, seen


def test_rollout_train_push_loop_matches_jax():
    jcfg, params, base = family("gqa")
    rng = np.random.default_rng(21)
    sys_p = rng.integers(3, 256, size=_PLEN - 4)
    problems = []
    for _ in range(2):
        x = rng.integers(3, 256, size=4)
        problems.append((np.concatenate([sys_p, x]).astype(np.int32), x))
    eng = RolloutEngine(base.cfg, base, engine_dtype=torch.float32, seed=5,
                        device="cpu")
    jeng = JaxRollout(jcfg, params, engine_dtype=jnp.float32, seed=5)
    pt, jt = _pair(engines=[eng], jax_engines=[jeng], lr=1e-3,
                   push_every=1)
    try:
        for rnd in range(2):
            groups, seen = _round(eng, eng.gateway, problems, rnd)
            jgroups, jseen = _round(jeng, jeng.gateway, problems, rnd)
            for (t, lp, v), (jt_, jlp, jv) in zip(seen, jseen):
                np.testing.assert_array_equal(t, jt_)
                np.testing.assert_allclose(lp, jlp, rtol=0, atol=1e-4)
                assert v == jv
            mp = pt.train_on(groups, pad_to=_NEW, prompt_pad=_PLEN)
            mj = jt.train_on(jgroups, pad_to=_NEW, prompt_pad=_PLEN)
            _assert_same_metrics(mp, mj)
            # rollouts by the weights the trainer holds: ratio ~ 1
            assert abs(mp["ratio"] - 1.0) < 1e-3 and mp["kept"] == 1.0
            assert eng.version == jeng.version == rnd + 1
        _assert_same_params(pt, jt)
        st = eng.serving_engine(**_SERVE).stats
        assert st["weight_pushes"] == 2 and st["cached_tokens"] > 0
    finally:
        for fe in (eng._frontend, jeng._frontend):
            if fe is not None:
                fe.close(timeout=T_OUT)


# ---------------------------------------------------------------------------
# orchestrator: mirrors of tests/test_async_frontend.py
# ---------------------------------------------------------------------------

class _StubEngine:
    """Duck-typed RolloutEngine: enough for the Orchestrator 'loop'
    backend without a model."""

    def __init__(self, delay_s: float = 0.0):
        self.gateway = TitoGateway()
        self.version = 0
        self.delay_s = delay_s

    def generate(self, rid, prompt, max_new, **kw):
        if self.delay_s:
            time.sleep(self.delay_s)
        toks = (np.arange(max_new, dtype=np.int32) % 5) + 3
        self.gateway.record(rid, toks, np.zeros(max_new, np.float32),
                            self.version)
        return toks


def _task(reward):
    return TaskService(
        name="t",
        sample_problem=lambda rng: {"prompt": np.asarray([1, 2, 3],
                                                         np.int32)},
        reward=reward, max_new=4)


def test_crashed_worker_deregisters_and_wait_raises():
    orch = Orchestrator([_StubEngine()], group_size=2)
    orch.register(_task(lambda prob, gen: (_ for _ in ()).throw(
        RuntimeError("reward service down"))))
    orch.start(n_workers=2)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rollout workers crashed"):
            orch.wait_for_groups(1, timeout_s=T_OUT)
        assert time.monotonic() - t0 < 30    # raised, did not spin
        assert len(orch.worker_errors) == 2
        # no zombies: crashed workers removed themselves from the table
        assert orch.monitor.healthy_servers() == []
        assert orch.monitor.sweep() == []
    finally:
        orch.stop()


def test_group_beats_between_rollouts():
    orch = Orchestrator([_StubEngine(delay_s=0.02)], group_size=4)
    orch.monitor = HeartbeatMonitor(timeout_s=0.05)
    orch.register(_task(lambda prob, gen: (1.0, False)))
    sid = "rollout-worker-0"
    orch.monitor.register(sid)
    rng = np.random.default_rng(0)
    beats = []

    def beat():
        beats.append(time.monotonic())
        orch.monitor.beat(sid)
        # a sweep mid-group (as wait_for_groups runs them) must not evict
        # a worker that is merely between rollouts of a slow group
        assert orch.monitor.sweep() == []

    orch._rollout_group(rng, beat=beat)  # 4 x 20ms > the 50ms timeout
    assert len(beats) == orch.group_size
    assert orch.monitor.is_healthy(sid)
    assert orch.buffer.n_ready() == 1


def test_wait_for_groups_happy_path_still_returns():
    orch = Orchestrator([_StubEngine()], group_size=2)
    orch.register(_task(lambda prob, gen: (1.0, False)))
    orch.start(n_workers=1)
    try:
        assert orch.wait_for_groups(1, timeout_s=T_OUT)
    finally:
        orch.stop()


def test_orchestrator_serving_backend_runs_groups():
    _, _, model = family("gqa")
    eng = RolloutEngine(model.cfg, model, seed=1, device="cpu")
    kw = dict(max_batch=4, block_size=8, num_blocks=64, max_len=64)
    orch = Orchestrator([eng], group_size=2, backend="serving",
                        serving_kw=kw)
    prompt = np.asarray([3, 4, 5, 6], np.int32)
    orch.register(TaskService(
        name="t", sample_problem=lambda rng: {"prompt": prompt},
        reward=lambda prob, gen: (float(len(gen)), False), max_new=4))
    try:
        orch.start(n_workers=2)
        assert orch.wait_for_groups(1, timeout_s=T_OUT), orch.worker_errors
    finally:
        orch.stop()
        if eng._frontend is not None:
            eng._frontend.close(timeout=T_OUT)
    group = orch.buffer.pop_groups(1)[0]
    assert len(group) == orch.group_size
    for t in group:
        assert t.versions == [0] and len(t.tokens) == 4
        assert t.logprobs.shape == t.tokens.shape
    assert eng.serving_engine(**kw).stats["prefills"] >= 2


def test_orchestrator_rejects_unknown_backend():
    with pytest.raises(ValueError):
        Orchestrator([_StubEngine()], backend="telepathy")


# ---------------------------------------------------------------------------
# the worker and beat fault points: mirror of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "worker@0..1,beat~0.5"])
def test_env_spec_orchestrator_worker_and_beat_points(spec):
    """``None`` reads ``REPRO_FAULTS`` as the reference test does (empty in
    a plain run); the second case arms both points: the first two worker
    iterations crash, so both workers die and the wait raises with the
    injected fault recorded."""
    faults = None if spec is None else FaultInjector(spec, seed=1)
    orch = Orchestrator([_StubEngine()], group_size=2, faults=faults)
    orch.register(_task(lambda prob, gen: (1.0, False)))
    orch.start(n_workers=2)
    try:
        # under an injected "worker" crash every worker may die before a
        # group completes — then wait MUST raise (with the injected
        # fault recorded), never spin out the timeout; without faults it
        # returns True.  "beat" drops are absorbed between rollouts.
        try:
            assert orch.wait_for_groups(1, timeout_s=T_OUT)
            assert spec is None or not orch.faults.fired.get("worker")
        except RuntimeError:
            assert any("injected fault" in e for e in orch.worker_errors)
            assert spec is not None or orch.faults.enabled
        # crashed workers deregistered themselves: no zombies, and the
        # sweep never evicts a registered-but-healthy worker
        assert orch.monitor.sweep() == []
    finally:
        orch.stop()
    if spec is not None:
        assert orch.faults.fired["worker"] == 2
        assert len(orch.worker_errors) == 2
