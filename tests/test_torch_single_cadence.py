"""The single-learner ``lunar_per`` cadence against the JAX ``Trainer``, on
the CPU at a tiny cut (8 envs, batch 16, 16 vector steps a superstep,
``training_start`` 64, hidden (16, 16)).

Over 5 supersteps, every superstep, these counters must be equal exactly:
the learner updates in the superstep (``loss_count``), the updates and the
optimizer's count so far, the replay's ``total_adds``, ε, the PER β that
the sampler is given and the α the priorities are raised to, and the
learning rate, γ, n-step, ``train_every`` and τ the runner holds.  Episode
counts depend on the env draws (threefry against Philox) and are left out.

The same config as a one-member ``PopulationTrainer`` (the form that
solves, ``solves.py --population``) holds the same hyperparameters and
keeps the same counters.

The flagship ``lunar_jointed_per`` at ``tests/test_torch_jointed.py``'s
cut (8 envs, batch 16, 8 vector steps a superstep, ``training_start`` 32,
hidden (16, 16)) keeps the same counters as the JAX ``Trainer`` over 3
supersteps, its env step through the port's stepper
(``envs/graphed.py``).  The JAX side compiles the jointed superstep
(~27 s with its import and init on one CPU core) under a time limit of
``JAX_JOINTED_LIMIT_S``.
"""

import contextlib
import dataclasses
import signal
import time

import jax
import numpy as np
import pytest

from deep_q_learning_tpu import config as jax_config
from deep_q_learning_tpu.train import Trainer as JaxTrainer
from deep_q_learning_tpu_torch import config
from deep_q_learning_tpu_torch.algos.dqn import CADENCE_FIELDS, HyperParams
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.parallel import PopulationTrainer
from deep_q_learning_tpu_torch.train import Trainer

CUT = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 64, steps_per_superstep=16,
           training_start=64, hidden=(16, 16), return_window=4)
SUPERSTEPS = 5
JOINTED_CUT = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 32, steps_per_superstep=8,
                   training_start=32, hidden=(16, 16), return_window=4)
JOINTED_SUPERSTEPS = 3
JAX_JOINTED_LIMIT_S = 240


def _jax_opt_count(opt_state) -> int:
    """The count of the optimizer's Adam moments (inside optax's
    ``inject_hyperparams`` and ``chain``)."""
    counts = {int(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if jax.tree_util.keystr(path).endswith(".count")}
    assert len(counts) == 1, counts
    return counts.pop()


def _jax_records(preset="lunar_per", cut=CUT, supersteps=SUPERSTEPS):
    cfg = dataclasses.replace(getattr(jax_config, preset)(), **cut)
    tr = JaxTrainer(cfg).init(seed=1)
    recs = []
    for _ in range(supersteps):
        tr.runner, m = tr._superstep(tr.runner)
        r, h = tr.runner, tr.runner.hyper
        recs.append(dict(
            loss_count=int(m.loss_count), updates=int(r.train.updates),
            opt_count=_jax_opt_count(r.train.opt_state), total_adds=int(r.replay.total_adds),
            env_steps=int(m.env_steps), epsilon=np.float32(m.epsilon),
            beta=np.float32(h.per_beta), alpha=np.float32(tr.replay.alpha),
            learning_rate=np.float32(h.learning_rate), gamma=np.float32(h.gamma),
            n_step=tr.replay.n_step, train_every=int(h.train_every),
            tau=np.float32(h.target_tau),
        ))
    return recs


def _port_records(preset="lunar_per", cut=CUT, supersteps=SUPERSTEPS):
    cfg = dataclasses.replace(getattr(config, preset)(), **cut)
    tr = Trainer(cfg, device="cpu").init(seed=1)
    # what the superstep hands the sampler, call by call
    betas = []
    sample = tr.replay.sample_with_info

    def recording_sample(*args, beta=None, **kw):
        betas.append(beta)
        return sample(*args, beta=beta, **kw)

    tr.replay.sample_with_info = recording_sample
    td_kernels.reset_counts()
    recs = []
    for _ in range(supersteps):
        before = len(betas)
        m = tr.step()
        r, h = tr.runner, tr.runner.hyper
        beta = set(betas[before:])
        assert len(beta) <= 1, beta
        recs.append(dict(
            loss_count=m.loss_count, updates=r.train.updates,
            opt_count=r.train.opt_state.count, total_adds=r.replay.total_adds,
            env_steps=m.env_steps, epsilon=np.float32(m.epsilon),
            beta=np.float32(beta.pop() if beta else h.per_beta),
            alpha=np.float32(tr.replay.alpha),
            learning_rate=np.float32(h.learning_rate), gamma=np.float32(h.gamma),
            n_step=tr.replay.n_step, train_every=h.train_every, tau=np.float32(h.target_tau),
        ))
    # every update went through the fused TD loss (its plain version here)
    updates = recs[-1]["updates"]
    assert td_kernels.plain_calls == {"td_loss_fwd": updates, "td_loss_bwd": updates}
    return recs, tr


@pytest.fixture(scope="module")
def runs():
    return _jax_records(), _port_records()


def test_single_learner_cadence_matches_jax(runs):
    want, (got, _) = runs
    assert len(got) == len(want) == SUPERSTEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"superstep {i + 1}: port {g} != jax {w}"
    # the warm-up gate opens at vector step 8 (64 stored over 8 envs)
    assert [g["loss_count"] for g in got] == [9, 16, 16, 16, 16]


def test_single_learner_hyper_equals_one_member_population(runs):
    _, (got, tr) = runs
    cfg = tr.cfg
    pop = PopulationTrainer(cfg, 1, eval_envs=2, device="cpu")
    runner = pop.init(seed=1)
    single, member = tr.runner.hyper, runner.hyper
    for f in dataclasses.fields(HyperParams):
        value = getattr(member, f.name)
        if f.name in CADENCE_FIELDS:
            assert value == (getattr(single, f.name),), f.name
        else:
            assert np.float32(getattr(single, f.name)) == value.item(), f.name
    # the same cadence, superstep by superstep
    for g in got:
        runner, m = pop.step(runner)
        assert (m.env_steps, int(m.loss_count[0]), runner.train.updates[0],
                runner.train.opt_state.count[0], runner.replay.total_adds) == (
            g["env_steps"], g["loss_count"], g["updates"], g["opt_count"], g["total_adds"])
        assert np.float32(m.epsilon[0]) == g["epsilon"]


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise TimeoutError once ``seconds`` have passed (at the next Python
    bytecode: a compile running in XLA is not cut, its caller is)."""
    def expire(signum, frame):
        raise TimeoutError(f"the JAX side took over {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def test_jointed_learner_cadence_matches_jax():
    t0 = time.perf_counter()
    with _time_limit(JAX_JOINTED_LIMIT_S):
        want = _jax_records("lunar_jointed_per", JOINTED_CUT, JOINTED_SUPERSTEPS)
    assert time.perf_counter() - t0 < JAX_JOINTED_LIMIT_S
    got, tr = _port_records("lunar_jointed_per", JOINTED_CUT, JOINTED_SUPERSTEPS)
    assert tr.env_params.jointed and tr.venv.graphed
    assert len(got) == len(want) == JOINTED_SUPERSTEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"superstep {i + 1}: port {g} != jax {w}"
    # the warm-up gate opens at vector step 4 (32 stored over 8 envs)
    assert [g["loss_count"] for g in got] == [5, 8, 8]
