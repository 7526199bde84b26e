"""PyTorch port, the agents' context management and search environment
(``repro_torch.agents``) and the RL and long-context data
(``repro_torch.data.synthetic``'s toy tasks, ``repro_torch.data.needle``)
on the CPU.  All numpy host code.

Mirrors ``tests/test_substrate.py``'s needle and context-management tests,
and holds the port's copies against the JAX package's on the same seeds:
the toy tasks' prompts and answers and ``TASKS``, the needle batches and
their accuracy, and whole search-agent episodes (rounds, tokens spent,
restarts, correctness) under every strategy, at budgets that run out and
budgets that do not.
"""
import numpy as np
import pytest

from repro.agents import context_mgmt as jctx
from repro.agents import search_env as jenv
from repro.data import needle as jneedle
from repro.data import synthetic as jsyn
from repro_torch.agents import (DiscardAll, Hierarchical, KeepRecentK,
                                NoManagement, make_env, run_episode,
                                scripted_agent)
from repro_torch.agents.context_mgmt import FOLDED, Context, Round
from repro_torch.data import synthetic
from repro_torch.data.needle import needle_accuracy, needle_batch


# ---------------------------------------------------------------------------
# mirrors of tests/test_substrate.py
# ---------------------------------------------------------------------------

def test_needle_batch_targets():
    nb = needle_batch(4, 256, 128, seed=3)
    # oracle predictions = the true next tokens -> accuracy 1
    preds = np.roll(nb.tokens, -1, axis=1)
    assert needle_accuracy(preds, nb) == 1.0


def test_keep_recent_folds_old_observations():
    ctx = Context(question="q", q_tokens=10)
    strat = KeepRecentK(2)
    for i in range(5):
        ctx = strat.add_round(ctx, Round("r", "a", f"obs{i}", 5, 2, 100))
    assert sum(r.observation == FOLDED for r in ctx.rounds) == 3
    assert ctx.rounds[-1].observation == "obs4"


def test_hierarchical_discards_over_threshold():
    strat = Hierarchical(k=2, threshold=300)
    ctx = Context(question="q", q_tokens=10)
    for i in range(10):
        ctx = strat.add_round(ctx, Round("r", "a", "o", 30, 10, 50))
    assert ctx.restarts >= 1
    assert strat.keep.k == 2


# ---------------------------------------------------------------------------
# the port's copies against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["copy", "reverse", "sort"])
def test_toy_tasks_equal_reference(name):
    assert set(synthetic.TASKS) == set(jsyn.TASKS)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for n in (1, 4, 16):
        x, y = synthetic.TASKS[name](rng, n, 64)
        jx, jy = jsyn.TASKS[name](jrng, n, 64)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert (x >= 3).all() and (x < 64).all()


def test_needle_batches_equal_reference():
    for kw in (dict(batch=3, seq_len=128, vocab=64, seed=1),
               dict(batch=2, seq_len=512, vocab=1000, n_needles=6,
                    n_value=3, seed=4)):
        nb, jnb = needle_batch(**kw), jneedle.needle_batch(**kw)
        for field in ("tokens", "targets", "loss_mask", "answer_pos",
                      "answer_vals"):
            np.testing.assert_array_equal(getattr(nb, field),
                                          getattr(jnb, field), field)
        preds = np.roll(nb.tokens, -1, axis=1)
        preds[0, nb.answer_pos[0, 0] - 1] += 1        # one miss
        assert needle_accuracy(preds, nb) == \
            jneedle.needle_accuracy(preds, jnb) == \
            (kw["batch"] - 1) / kw["batch"]


_STRATEGIES = {
    "none": (NoManagement, jctx.NoManagement, {}),
    "keep_recent_k": (KeepRecentK, jctx.KeepRecentK, dict(k=5)),
    "discard_all": (DiscardAll, jctx.DiscardAll, dict(threshold=12000)),
    "hierarchical": (Hierarchical, jctx.Hierarchical,
                     dict(k=5, threshold=12000)),
}


@pytest.mark.parametrize("strategy", sorted(_STRATEGIES))
def test_search_episodes_equal_reference(strategy):
    ours_cls, ref_cls, kw = _STRATEGIES[strategy]
    results = []
    for seed in range(6):
        for budget in (40_000, 400_000):
            row = []
            for mk_env, agent, cls, runner in (
                    (make_env, scripted_agent, ours_cls, run_episode),
                    (jenv.make_env, jenv.scripted_agent, ref_cls,
                     jctx.run_episode)):
                env = mk_env(np.random.default_rng(seed), hops=12,
                             obs_tokens=900, degrade_start=20_000)
                row.append(runner(env, agent, cls(**kw),
                                  budget_tokens=budget))
            assert row[0] == row[1], (seed, budget, row)
            results.append(row[0])
    # the episodes exercise both outcomes
    assert {ok for ok, _ in results} == {True, False} or \
        strategy != "none"
    assert any(st["out_of_budget"] for _, st in results) or \
        strategy != "none"
