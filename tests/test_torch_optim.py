"""The port's optimizer (optax semantics) and ε-greedy against the JAX
package.

Optimizer: 3 steps from the same params and gradients, with the global-norm
clip active on every step; params compared at rtol 1e-6 (float32; the
adam bias corrections round the same way, summation orders differ)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_q_learning_tpu.algos.dqn import epsilon_greedy as jax_epsilon_greedy
from deep_q_learning_tpu.algos.dqn import make_optimizer as jax_make_optimizer
from deep_q_learning_tpu_torch.algos.dqn import (
    HyperParams,
    epsilon_by_schedule,
    epsilon_greedy,
    make_optimizer,
)
from deep_q_learning_tpu_torch.config import DQNConfig, lunar_per

SHAPES = {"a": (5, 3), "b": (3,), "c": (4, 2)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [
        {k: (20.0 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        for _ in range(3)
    ]
    return params, grads


@pytest.mark.parametrize(
    "name,max_grad_norm", [("adam", 10.0), ("adamw", 10.0), ("rmsprop", 10.0), ("sgd", None)]
)
def test_optimizer_matches_optax(name, max_grad_norm):
    cfg = DQNConfig(optimizer=name, learning_rate=3e-4, max_grad_norm=max_grad_norm)
    params, grads = _trees(0)

    jopt = jax_make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    for g in grads:
        if max_grad_norm is not None:
            norm = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g.values()))
            assert norm > max_grad_norm  # the clip is active
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)

    opt = make_optimizer(cfg)
    keys = sorted(SHAPES)
    tp = [torch.tensor(params[k]) for k in keys]
    state = opt.init(tp)
    h = HyperParams.from_config(cfg)
    for g in grads:
        opt.apply([torch.tensor(g[k]) for k in keys], state, tp, h.learning_rate, h.max_grad_norm)
    assert state.count == 3
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_learning_rate_is_read_at_run_time():
    cfg = DQNConfig(optimizer="sgd", learning_rate=1.0)
    opt = make_optimizer(cfg)
    p = [torch.ones(2)]
    state = opt.init(p)
    opt.apply([torch.ones(2)], state, p, learning_rate=0.25)
    assert torch.equal(p[0], torch.full((2,), 0.75))


def test_epsilon_greedy_matches_jax_with_injected_u():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((512, 4)).astype(np.float32)
    q[:8] = 1.0  # ties: the first maximum wins
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (512,)))
    for eps in (0.0, 0.3, 1.0):
        want = np.asarray(jax_epsilon_greedy(key, jnp.asarray(q), jnp.float32(eps)))
        got = epsilon_greedy(None, torch.tensor(q), float(np.float32(eps)), u=torch.tensor(u))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_epsilon_schedules():
    cfg = lunar_per()  # linear_step from 1.0 to 0.01 over 300k env steps
    assert epsilon_by_schedule(cfg, 0, None) == 1.0
    assert epsilon_by_schedule(cfg, 150_000, None) == pytest.approx(0.505)
    assert epsilon_by_schedule(cfg, 10**9, None) == pytest.approx(0.01)
    exp = dataclasses.replace(cfg, eps_schedule="exp_episode", num_envs=4, eps_decay=0.5)
    eps = epsilon_by_schedule(exp, 0, torch.tensor(8))  # 2 episodes per env
    assert float(eps) == pytest.approx(0.25)
