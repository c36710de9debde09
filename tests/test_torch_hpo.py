"""The port's GP-UCB search (``deep_q_learning_tpu_torch/hpo/bayesopt.py``, a
copy of the JAX package's numpy module) and its objectives over the port's
trainers, on the CPU.

* The spaces, the runtime set, the GP, ``optimize`` and ``optimize_batched``
  are held to the JAX module's: the same numpy objective and seed give
  identical trials (parameters and objectives exact).
* ``make_dqn_objective``: a repeated trial gives the same value, and trials
  that differ in runtime fields only reuse one ``Trainer``.
* ``make_population_objective``: candidates are grouped by their static
  fields, one ``PopulationTrainer`` a group, reused across rounds.
"""

import dataclasses

import numpy as np
import pytest

from deep_q_learning_tpu.hpo import bayesopt as jax_bo
from deep_q_learning_tpu_torch import config, train
from deep_q_learning_tpu_torch.hpo import bayesopt as bo

TINY = dict(num_envs=8, steps_per_superstep=8, hidden=(16, 16), batch_size=16,
            buffer_capacity=512, training_start=32, return_window=8, max_steps_in_episode=20)


def _objective(space):
    """A smooth numpy objective of the denormalised parameters, peaked
    inside the box."""
    def f(params):
        u = [(params[p.name] - p.low) / (p.high - p.low) for p in space]
        return -float(sum((x - 0.3 - 0.1 * i) ** 2 for i, x in enumerate(u)))
    return f


def test_spaces_and_runtime_fields_are_the_jax_modules():
    assert bo.SPACES.keys() == jax_bo.SPACES.keys()
    for name in bo.SPACES:
        assert [dataclasses.astuple(p) for p in bo.SPACES[name]] == [
            dataclasses.astuple(p) for p in jax_bo.SPACES[name]]
    assert bo._RUNTIME_PARAMS == jax_bo._RUNTIME_PARAMS
    assert bo.Param("x", 2, 15, integer=True).denorm(0.51) == jax_bo.Param(
        "x", 2, 15, integer=True).denorm(0.51)


def test_gp_predicts_as_the_jax_modules():
    rng = np.random.default_rng(0)
    x, y, q = rng.random((9, 4)), rng.standard_normal(9), rng.random((50, 4))
    ours, theirs = bo._GP(), jax_bo._GP()
    ours.fit(x, y)
    theirs.fit(x, y)
    for a, b in zip(ours.predict(q), theirs.predict(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("space", ["reference", "lunar"])
def test_optimize_gives_the_jax_trials(space):
    sp = bo.SPACES[space]
    kw = dict(num_trials=7, num_init=3, seed=11, num_candidates=512, verbose=False)
    ours = bo.optimize(_objective(sp), space=sp, **kw)
    theirs = jax_bo.optimize(_objective(jax_bo.SPACES[space]), space=jax_bo.SPACES[space], **kw)
    assert [(t.params, t.objective) for t in ours.trials] == [
        (t.params, t.objective) for t in theirs.trials]
    assert (ours.best_params, ours.best_objective) == (theirs.best_params, theirs.best_objective)


@pytest.mark.parametrize("space", ["reference", "lunar"])
def test_optimize_batched_gives_the_jax_trials(space):
    sp = bo.SPACES[space]
    kw = dict(num_trials=8, batch_q=3, seed=5, num_candidates=512, verbose=False)
    ours = bo.optimize_batched(lambda cs: [_objective(sp)(c) for c in cs], space=sp, **kw)
    jsp = jax_bo.SPACES[space]
    theirs = jax_bo.optimize_batched(lambda cs: [_objective(jsp)(c) for c in cs], space=jsp, **kw)
    assert len(ours.trials) == 8
    assert [(t.params, t.objective) for t in ours.trials] == [
        (t.params, t.objective) for t in theirs.trials]


def test_dqn_objective_repeats_and_reuses_its_trainer(monkeypatch):
    built = []
    real = train.Trainer

    def counted(*args, **kwargs):
        built.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(train, "Trainer", counted)
    cfg = dataclasses.replace(config.cartpole_vector(), **TINY)
    objective = bo.make_dqn_objective(cfg, env_steps_per_trial=128, train_seed=1, device="cpu")
    trial = {"gamma": 0.95, "eps_min": 0.05, "train_every": 2}
    first = objective(trial)
    assert np.isfinite(first) and objective(trial) == first  # a fresh init every trial
    objective({"gamma": 0.9, "eps_min": 0.1, "train_every": 3})  # runtime fields only
    assert len(built) == 1
    objective({"gamma": 0.9, "batch_size": 32})  # a static field: a second trainer
    assert len(built) == 2 and built[1].batch_size == 32


def test_population_objective_groups_by_static_fields_and_reuses_trainers():
    cfg = dataclasses.replace(config.lunar_per(), **TINY)
    assert cfg.target_tau is not None and cfg.max_grad_norm is not None
    objective = bo.make_population_objective(cfg, env_steps_per_trial=128, eval_envs=2,
                                             device="cpu")
    cands = [{"learning_rate": 1e-3, "target_tau": 0.01, "batch_size": 16},
             {"learning_rate": 3e-4, "target_tau": 0.005, "batch_size": 32},
             {"learning_rate": 5e-4, "target_tau": 0.002, "batch_size": 16}]
    values = objective(cands)
    assert len(values) == 3 and np.isfinite(values).all()
    trainers = dict(objective.trainers)
    assert sorted((dict(k[0])["batch_size"], k[1]) for k in trainers) == [(16, 2), (32, 1)]
    assert all(t.num_members == k[1] for k, t in trainers.items())
    assert objective(cands) == values  # fresh members, the same seeds
    assert all(objective.trainers[k] is t for k, t in trainers.items())
