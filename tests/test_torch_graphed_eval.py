"""The greedy evaluator as an in-place graph of its step
(``algos/evaluate.py``) against its eager form, on the CPU, bitwise, and
against the JAX package's evaluator.

On the CPU the graphed evaluator calls its step directly where the card
replays the graph, on the same static buffers: the start states copied into
the pool and the running states, the step's draws taken from the generator
before each step, the accounting in place, the buffers reused by the next
evaluation.  Held against ``graphed=False`` (the eager loop around
``VectorEnv.step``), returns, lengths and ``truncated`` equal bit for bit:

  * the rigid lander (``lunar_per`` at a small width, its step drawing the
    engines' dispersion), CartPole (a step that draws nothing) and a
    3-member population (member ``m``'s envs at rows ``m·E``), each over
    two evaluations of one network and one of a new network, with
    ``max_steps`` cutting some episodes;
  * against the JAX evaluator (``lax.while_loop``): CartPole from the same
    64 start states with the same flax weights, returns, lengths and
    ``truncated`` exact (rewards of 1; the float32 dynamics agree to 1e-6,
    far from every termination threshold here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.algos.evaluate import build_evaluator as jax_build_evaluator
from deep_q_learning_tpu.envs.base import VectorEnv as JaxVectorEnv
from deep_q_learning_tpu.envs.cartpole import CartPole as JaxCartPole
from deep_q_learning_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu_torch.algos.evaluate import build_evaluator
from deep_q_learning_tpu_torch.config import DQNConfig, lunar_per
from deep_q_learning_tpu_torch.envs import CartPole, VectorEnv
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.parallel import PopulationTrainer
from deep_q_learning_tpu_torch.train import Trainer

LANDER = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 32, steps_per_superstep=8,
              training_start=32, hidden=(16, 16), return_window=4)
CARTPOLE = dict(env_id="CartPole-v1", num_envs=8, steps_per_superstep=8, batch_size=16,
                training_start=32, buffer_capacity=256, hidden=(16, 16), return_window=4)


def _equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _cfg(name):
    if name == "lander":
        return dataclasses.replace(lunar_per(), **LANDER)
    return DQNConfig(**CARTPOLE)


@pytest.mark.parametrize("name,max_steps", [("lander", 60), ("cartpole", 25)])
def test_graphed_evaluator_equals_eager(name, max_steps):
    cfg = _cfg(name)
    graphed = Trainer(cfg, device="cpu").init(seed=1)
    eager = Trainer(cfg, device="cpu", graphed_learner=False).init(seed=1)
    assert graphed._evaluate.graph is not None and eager._evaluate.graph is None
    graphed.step()
    eager.step()
    results = []
    for seed in (0, 0, 3):
        got = graphed.evaluate(seed=seed, max_steps=max_steps)
        _equal(got, eager.evaluate(seed=seed, max_steps=max_steps))
        results.append(got)
    _equal(results[0], results[1])  # the buffers start over: one seed, one result
    assert results[0].truncated.any() and not results[0].truncated.all()
    # a new network: the step is bound to the new runner's tensors
    graphed.init(seed=2)
    eager.init(seed=2)
    _equal(graphed.evaluate(seed=5, max_steps=max_steps),
           eager.evaluate(seed=5, max_steps=max_steps))


def test_graphed_population_evaluator_equals_eager():
    cfg = dataclasses.replace(lunar_per(), **LANDER)
    trainers = [PopulationTrainer(cfg, 3, eval_envs=4, device="cpu", graphed_learner=g)
                for g in (True, False)]
    assert trainers[0]._evaluate.graph is not None and trainers[1]._evaluate.graph is None
    runners = [t.init(seed=4) for t in trainers]
    for t, r in zip(trainers, runners):
        t.step(r)
    for seed in (1, 2):
        got, want = (t.evaluate(r, seed=seed, max_steps=30) for t, r in zip(trainers, runners))
        assert got.returns.shape == (3, 4)
        _equal(got, want)
    runners = [t.init(seed=6) for t in trainers]
    _equal(*(t.evaluate(r, seed=0, max_steps=30) for t, r in zip(trainers, runners)))


def test_graphed_evaluator_refuses_a_function():
    evaluate = build_evaluator(VectorEnv(CartPole(), 4), CartPole().default_params(), 10)
    with pytest.raises(TypeError, match="bound to a module"):
        evaluate(lambda obs: obs[:, :2], torch.Generator().manual_seed(0))


class _FixedStartCartPole(CartPole):
    """The port's CartPole whose resets start from given values."""

    def __init__(self, init):
        self.init = init

    def reset_draws(self, generator, n):
        return torch.from_numpy(self.init).to(generator.device)


class _FixedStartJax:
    """The JAX vector CartPole whose reset returns given start states."""

    def __init__(self, init):
        self.venv = JaxVectorEnv(JaxCartPole(), init.shape[0])
        self.init, self.num_envs = init, init.shape[0]

    def reset(self, key, params):
        x, x_dot, theta, theta_dot = (jnp.asarray(self.init[:, i]) for i in range(4))
        state = JaxCartPoleState(x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot,
                                 t=jnp.zeros((self.num_envs,), jnp.int32))
        return jax.vmap(self.venv.env.get_obs, in_axes=(0, None))(state, params), state

    def step(self, *args, **kwargs):
        return self.venv.step(*args, **kwargs)


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_evaluator_matches_jax_evaluator(graphed):
    n, max_steps = 64, 30
    init = np.random.default_rng(0).uniform(-0.05, 0.05, (n, 4)).astype(np.float32)
    net = FlaxQNetwork(num_actions=2, hidden=(16, 16))
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, 4)))
    jax_env = _FixedStartJax(init)
    want = jax.jit(jax_build_evaluator(jax_env, jax_env.venv.env.default_params(), net,
                                       max_steps))(params, jax.random.PRNGKey(0))
    env = _FixedStartCartPole(init)
    evaluate = build_evaluator(VectorEnv(env, n), env.default_params(), max_steps,
                               graphed=graphed)
    got = evaluate(QNetwork.from_flax_params(jax.tree.map(np.asarray, params)),
                   torch.Generator().manual_seed(0))
    assert (evaluate.graph is not None) is graphed
    _equal([x.numpy() for x in got], [np.asarray(x) for x in want])
    assert got.truncated.any() and not got.truncated.all()
