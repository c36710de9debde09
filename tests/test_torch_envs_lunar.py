"""The port's rigid LunarLander against the JAX env on matched states.

Reset: the same random draws (recomputed from the JAX key) go into both.
Step: states are taken along a JAX rollout (half heuristic landers, half
random), converted with ``state_from_numpy``, and stepped once by both
with the same action and the same dispersion draw.  Tolerances:
  * observations atol 1e-5 (float32; sin/cos differ in the last ulp
    between XLA and PyTorch: the measured gap is ~1e-7);
  * rewards and shaping potentials atol 1e-4.  A reward is the difference
    of two shaping potentials of magnitude up to a few hundred, whose
    float32 ulp is 1.5e-5..3e-5; XLA's own shaping differs from a numpy
    evaluation of the same formula on the same observation by 3e-5;
  * flags exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs.heuristic import heuristic_action
from deep_q_learning_tpu.envs.lunar_lander import LunarLander as JaxLander
from deep_q_learning_tpu.envs.wrappers import TimeFractionObs as JaxTimeFraction
from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs, VectorEnv, make_env
from deep_q_learning_tpu_torch.envs.lunar_lander import (
    CHUNKS,
    H,
    INITIAL_RANDOM,
    ResetDraws,
    state_from_numpy,
)

N_ENVS, T_STEPS = 16, 400


def _jax_env(**params):
    env = JaxTimeFraction(JaxLander())
    return env, env.default_params().replace(jointed=False, **params)


def _port_env(**params):
    env = TimeFractionObs(LunarLander())
    return env, dataclasses.replace(env.default_params(), jointed=False, **params)


@pytest.fixture(scope="module")
def jax_env():
    return _jax_env()


@pytest.fixture(scope="module")
def port_env():
    return _port_env()


def _reset_draws(key):
    """The draws JaxLander.reset_env takes from ``key``."""
    terrain_key, kick_key, wind_key, _ = jax.random.split(key, 4)
    return (
        jax.random.uniform(terrain_key, (CHUNKS + 1,), minval=0.0, maxval=H / 2.0),
        jax.random.uniform(kick_key, (2,), minval=-INITIAL_RANDOM, maxval=INITIAL_RANDOM),
        jax.random.randint(wind_key, (2,), -9999, 9999),
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("random_terrain", [True, False])
def test_reset_matches_jax(random_terrain):
    env_j, p_j = _jax_env(random_terrain=random_terrain)
    env_t, p_t = _port_env(random_terrain=random_terrain)
    keys = jax.random.split(jax.random.PRNGKey(11), N_ENVS)
    obs_j, st_j = jax.vmap(env_j.reset, (0, None))(keys, p_j)
    terrain, kick, wind = (np.asarray(x) for x in jax.vmap(_reset_draws)(keys))
    draws = ResetDraws(
        terrain=torch.tensor(terrain),
        kick=torch.tensor(kick),
        wind=torch.from_numpy(wind.astype(np.int32)),
    )
    obs_t, st_t = env_t.reset_env(None, N_ENVS, p_t, draws)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=1e-5)
    np.testing.assert_allclose(st_t.terrain.numpy(), np.asarray(st_j.terrain), atol=1e-6)
    np.testing.assert_allclose(
        st_t.prev_shaping.numpy(), np.asarray(st_j.prev_shaping), atol=1e-4, rtol=0
    )
    assert np.array_equal(st_t.wind_idx.numpy(), np.asarray(st_j.wind_idx))


def _jax_rollout(env, p):
    """Pre-step states, actions, dispersion draws and JAX step outputs for
    every (t, env) of a rollout while the env's first episode lasts."""
    obs, st = jax.jit(jax.vmap(env.reset, (0, None)))(
        jax.random.split(jax.random.PRNGKey(5), N_ENVS), p
    )
    step = jax.jit(jax.vmap(env.step, (0, 0, 0, None)))
    disp_of = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0)))
    heur = jax.jit(jax.vmap(heuristic_action))
    rng = np.random.default_rng(5)
    alive = np.ones(N_ENVS, bool)
    rows = []
    for t in range(T_STEPS):
        acts = np.where(
            np.arange(N_ENVS) < N_ENVS // 2,
            np.asarray(heur(obs[:, :8])),
            rng.integers(0, 4, N_ENVS),
        ).astype(np.int32)
        keys = jax.random.split(jax.random.PRNGKey(1000 + t), N_ENVS)
        out = step(keys, st, jnp.asarray(acts), p)
        rows.append((_np(st), acts, np.asarray(disp_of(keys)), _np(out), alive.copy()))
        alive &= ~(np.asarray(out[3]) | np.asarray(out[4]))
        obs, st = out[0], out[1]
    return rows


@pytest.fixture(scope="module", params=[False, True], ids=["calm", "wind"])
def rollout(request):
    """(enable_wind, rollout): gymnasium v3's wind/turbulence on and off."""
    return request.param, _jax_rollout(*_jax_env(enable_wind=request.param))


def _stack_alive(rows):
    def cat(get):
        return np.concatenate([get(r)[r[4]] for r in rows])

    states = jax.tree.map(
        lambda *leaves: np.concatenate([l[r[4]] for l, r in zip(leaves, rows)]),
        *[r[0] for r in rows],
    )
    return (
        states,
        cat(lambda r: r[1]),
        cat(lambda r: r[2]),
        [cat(lambda r, i=i: r[3][i]) for i in (0, 2, 3, 4)],
    )


def test_step_matches_jax_along_rollout(rollout):
    wind, rows = rollout
    env, p = _port_env(enable_wind=wind)
    states, actions, disp, (obs_j, rew_j, term_j, trunc_j) = _stack_alive(rows)
    assert len(actions) > 1000
    st = state_from_numpy(states)
    obs, new_st, rew, term, trunc = env.step_env(
        None, st, torch.from_numpy(actions), p, torch.from_numpy(disp)
    )
    np.testing.assert_allclose(obs.numpy(), obs_j, atol=1e-5)
    np.testing.assert_allclose(rew.numpy(), rew_j, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(term.numpy(), term_j)
    np.testing.assert_array_equal(trunc.numpy(), trunc_j)
    # the rollout covers flight, leg contact, crashes and landings at rest
    assert obs_j[:, 6].any() and term_j.any() and (rew_j == 100.0).any()
    if wind:  # the wind index advances only while airborne
        np.testing.assert_array_equal(
            new_st.wind_idx.numpy() - st.wind_idx.numpy(), 1 - (states.leg1 | states.leg2)
        )


def test_state_from_numpy_single_instance(jax_env):
    env, p = jax_env
    _, st = env.reset(jax.random.PRNGKey(2), p)
    batched = state_from_numpy(_np(st))
    assert batched.x.shape == (1,) and batched.terrain.shape == (1, CHUNKS)
    assert batched.t.dtype == torch.int32 and batched.leg1.dtype == torch.bool


def test_vector_env_autoreset_keeps_pre_reset_next_obs(port_env):
    env, p = port_env
    venv = VectorEnv(env, 8)
    g = torch.Generator().manual_seed(0)
    obs, states = venv.reset(g, p)
    pool = venv.fresh_pool(g, p)
    actions = torch.full((8,), 2, dtype=torch.int32)  # main engine: flies off
    for _ in range(400):
        new_obs, states, tr = venv.step(g, states, actions, p, prev_obs=obs, fresh=pool)
        done = tr.terminated | tr.truncated
        assert torch.equal(tr.obs, obs)
        assert torch.equal(new_obs[done], pool[0][done])
        assert torch.equal(new_obs[~done], tr.next_obs[~done])
        obs = new_obs
        if done.any():
            break
    assert done.any()


def test_jointed_engine_and_other_envs_raise():
    env = LunarLander()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env.reset_env(torch.Generator(), 2, env.default_params())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_env("CartPole-v1")
    with pytest.raises(ValueError):
        make_env("Pong-v0")
    _, params = make_env("LunarLander-v2", True, 1000, {"jointed": False, "vel_iters": 9})
    assert not params.jointed and params.max_steps_in_episode == 1000
