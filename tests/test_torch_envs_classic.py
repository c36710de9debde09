"""The port's classic-control envs (CartPole, Acrobot, MountainCar) against
the JAX envs, on the CPU.

Step: states are taken along one JAX rollout per env (module-scoped), half
the envs on a policy that reaches the env's end (CartPole balanced until
the 500-step cut or the track's edge, Acrobot and MountainCar pumped up to
the goal) and half on random actions, with JAX's own auto-reset.  Every
pre-step state goes through the JAX ``step_env`` (vmapped) and the port's
batched one.  Tolerances:
  * CartPole and MountainCar: observations and states atol 1e-6 (one Euler
    step in float32; XLA's sin/cos differ from PyTorch's in the last ulp);
  * Acrobot: four RK4 stages of trigonometry, and XLA fuses multiply-adds
    where PyTorch does not.  The ``acrobot_f64`` fixture runs the same JAX
    code in float64 (``jax.enable_x64``) and measures JAX's own float32
    error per field; the port is held to 4x that (plus 1e-7).  Angles are
    compared through their cos and sin: a state next to ±pi can wrap to
    -pi on one side and +pi on the other;
  * rewards exact; flags exact, except on states whose decisive quantity
    (|x| or |theta| of CartPole, the tip height of Acrobot, the position of
    MountainCar) lies within 1e-6 of its threshold: those are counted and
    bounded (at most 0.1 % of the steps).
Reset: injected ``draws`` against the formula and against the JAX reset
of the same key (exact); ``reset_batch`` by distribution.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs import Acrobot as JaxAcrobot
from deep_q_learning_tpu.envs import CartPole as JaxCartPole
from deep_q_learning_tpu.envs import MountainCar as JaxMountainCar
from deep_q_learning_tpu.envs.wrappers import TimeFractionObs as JaxTimeFraction
from deep_q_learning_tpu_torch.envs import (
    Acrobot,
    CartPole,
    MountainCar,
    TimeFractionObs,
    VectorEnv,
    available_envs,
    make_env,
)

N_ENVS = 32
NEAR = 1e-6  # a flag may differ only this close to its threshold
NEAR_SHARE = 1e-3
F64_MULTIPLE, F64_FLOOR = 4.0, 1e-7


def _cartpole_policy(st, rng):
    return (np.asarray(st.theta) + 0.5 * np.asarray(st.theta_dot) > 0).astype(np.int32)


def _acrobot_policy(st, rng):  # torque along the second joint's rate pumps energy
    return np.where(np.asarray(st.dtheta2) > 0, 2, 0).astype(np.int32)


def _mountain_car_policy(st, rng):  # push along the velocity
    return np.where(np.asarray(st.velocity) >= 0, 2, 0).astype(np.int32)


# env id: (JAX env, port env, reset range, reset width, policy, rollout steps)
ENVS = {
    "CartPole-v1": (JaxCartPole, CartPole, 0.05, 4, _cartpole_policy, 600),
    "Acrobot-v1": (JaxAcrobot, Acrobot, 0.1, 4, _acrobot_policy, 600),
    "MountainCar-v0": (JaxMountainCar, MountainCar, None, 1, _mountain_car_policy, 300),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(env, jax_state):
    """The port's batched state from a JAX state whose leaves are numpy."""
    _, template = env.reset_env(None, 1, env.default_params(), _draws(env, 1))
    return type(template)(**{
        f.name: torch.tensor(np.asarray(getattr(jax_state, f.name)))
        for f in dataclasses.fields(template)
    })


def _draws(env, n, seed=0):
    """Injected reset draws, already on the env's reset range."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 4), generator=g)
    if isinstance(env, MountainCar):
        return u[:, 0] * 0.2 - 0.6
    lo = 0.05 if isinstance(env, CartPole) else 0.1
    return u * (2 * lo) - lo


@functools.cache
def _rollout(env_id):
    """Pre-step states, actions and the JAX step's outputs along a rollout."""
    jax_cls, _, _, _, policy, steps = ENVS[env_id]
    env = jax_cls()
    p = env.default_params()
    reset = jax.jit(env.reset_batch, static_argnums=1)
    step = jax.jit(jax.vmap(env.step_env, (None, 0, 0, None)))
    _, st = reset(jax.random.PRNGKey(0), N_ENVS, p)
    rng = np.random.default_rng(0)
    num_actions = env.num_actions
    rows = []
    for t in range(steps):
        acts = np.where(
            np.arange(N_ENVS) < N_ENVS // 2, policy(st, rng), rng.integers(0, num_actions, N_ENVS)
        ).astype(np.int32)
        out = step(jax.random.PRNGKey(0), st, jnp.asarray(acts), p)
        rows.append((_np(st), acts, _np(out)))
        done = np.asarray(out[3]) | np.asarray(out[4])
        _, fresh = reset(jax.random.PRNGKey(t + 1), N_ENVS, p)
        st = jax.tree.map(lambda f, s: jnp.where(done, f, s), fresh, out[1])
    cat = lambda get: jax.tree.map(lambda *x: np.concatenate(x), *[get(r) for r in rows])  # noqa: E731
    return cat(lambda r: r[0]), np.concatenate([r[1] for r in rows]), cat(lambda r: r[2])


@pytest.fixture(scope="module", params=list(ENVS))
def rollout(request):
    return (request.param, *_rollout(request.param))


@pytest.fixture(scope="module")
def acrobot_f64():
    """JAX's float32 Acrobot step against the same JAX code in float64 on
    the rollout's states: the largest gap per field."""
    states, actions, out = _rollout("Acrobot-v1")
    env = JaxAcrobot()
    with jax.enable_x64(True):
        wide = jax.tree.map(lambda x: x.astype(np.float64) if x.dtype == np.float32 else x, states)
        out64 = _np(jax.jit(jax.vmap(env.step_env, (None, 0, 0, None)))(
            jax.random.PRNGKey(0), wide, jnp.asarray(actions), env.default_params()))
    f32 = dict(_acrobot_fields(out[1]))
    f64 = dict(_acrobot_fields(out64[1]))
    gaps = {name: float(np.abs(f32[name] - f64[name]).max()) for name in f32}
    return gaps


def _acrobot_fields(st):
    """(name, values): angles through their cos and sin, then the rates."""
    fields = []
    for name in ("theta1", "theta2"):
        a = np.asarray(getattr(st, name), np.float64)
        fields += [(f"cos {name}", np.cos(a)), (f"sin {name}", np.sin(a))]
    for name in ("dtheta1", "dtheta2"):
        fields.append((name, np.asarray(getattr(st, name), np.float64)))
    return fields


def _near_threshold(env_id, new_state):
    """Steps whose decisive quantity lies within NEAR of its threshold."""
    if env_id == "CartPole-v1":
        p = JaxCartPole().default_params()
        return (np.abs(np.abs(new_state.x) - p.x_threshold) < NEAR) | (
            np.abs(np.abs(new_state.theta) - p.theta_threshold) < NEAR)
    if env_id == "Acrobot-v1":
        t1, t2 = np.asarray(new_state.theta1, np.float64), np.asarray(new_state.theta2, np.float64)
        return np.abs(-np.cos(t1) - np.cos(t1 + t2) - 1.0) < NEAR
    return np.abs(new_state.position - JaxMountainCar().default_params().goal_position) < NEAR


def _check_flags(env_id, got, want):
    """Flags exact except near a threshold; returns the count near one."""
    near = _near_threshold(env_id, want[1])
    for i in (3, 4):
        differ = got[i].numpy() != want[i]
        assert not (differ & ~near).any(), (env_id, i, np.flatnonzero(differ & ~near))
    assert near.mean() <= NEAR_SHARE, (env_id, near.sum())
    same = (got[3].numpy() == want[3]) & (got[4].numpy() == want[4])
    np.testing.assert_array_equal(got[2].numpy()[same], want[2][same])
    return int(near.sum())


def test_step_matches_jax_along_rollout(rollout, acrobot_f64):
    env_id, states, actions, want = rollout
    env = ENVS[env_id][1]()
    got = env.step_env(None, _port_state(env, states), torch.from_numpy(actions), env.default_params())
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    assert got[2].shape == (len(actions),) and got[1].t.dtype == torch.int32
    # the rollout covers terminations and time-limit truncations
    assert want[3].sum() > 10 and want[4].sum() > 10, (want[3].sum(), want[4].sum())
    np.testing.assert_array_equal(got[1].t.numpy(), want[1].t)
    if env_id == "Acrobot-v1":
        f32_gaps = acrobot_f64
        port = dict(_acrobot_fields(got[1]))
        for name, values in _acrobot_fields(want[1]):
            gap = float(np.abs(port[name] - values).max())
            assert gap <= F64_MULTIPLE * f32_gaps[name] + F64_FLOOR, (name, gap, f32_gaps[name])
        bound = F64_MULTIPLE * max(f32_gaps.values()) + F64_FLOOR
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=bound, rtol=0)
    else:
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6, rtol=0)
        for f in dataclasses.fields(got[1]):
            np.testing.assert_allclose(
                getattr(got[1], f.name).numpy(), getattr(want[1], f.name), atol=1e-6, rtol=0,
                err_msg=f.name)
    _check_flags(env_id, got, want)


def test_acrobot_float32_error_is_small(acrobot_f64):
    """The premise of the Acrobot tolerance: JAX's own float32 step is within
    a few ulps of float64 on these states (measured ~3e-7..6e-7)."""
    gaps = acrobot_f64
    assert 0 < max(gaps.values()) < 1e-5, gaps


@pytest.mark.parametrize("env_id", list(ENVS))
def test_reset_from_draws_matches_formula_and_jax(env_id):
    jax_cls, cls, lo, width, _, _ = ENVS[env_id]
    env, jenv = cls(), jax_cls()
    p, jp = env.default_params(), jenv.default_params()
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    _, want = jax.vmap(jenv.reset_env, (0, None))(keys, jp)
    if width == 1:
        draws = jax.vmap(lambda k: jax.random.uniform(k, (), minval=-0.6, maxval=-0.4))(keys)
    else:
        draws = jax.vmap(lambda k: jax.random.uniform(k, (4,), minval=-lo, maxval=lo))(keys)
    obs, st = env.reset_env(None, 64, p, torch.tensor(np.asarray(draws)))
    for f in dataclasses.fields(st):
        np.testing.assert_array_equal(getattr(st, f.name).numpy(), np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    # the formula: the draws are the state, at t = 0 (and at rest for MountainCar)
    d = torch.tensor(np.asarray(draws))
    fields = [f.name for f in dataclasses.fields(st)][:-1]
    if width == 1:
        assert torch.equal(st.position, d) and not st.velocity.any()
    else:
        for i, name in enumerate(fields):
            assert torch.equal(getattr(st, name), d[:, i]), name
    assert st.t.dtype == torch.int32 and not st.t.any()
    assert torch.equal(obs, env.get_obs(st, p)) and obs.shape == (64, *env.obs_shape(p))


@pytest.mark.parametrize("env_id", list(ENVS))
def test_reset_batch_distribution(env_id):
    _, cls, lo, width, _, _ = ENVS[env_id]
    env = cls()
    p = env.default_params()
    n = 50_000
    g = torch.Generator().manual_seed(1)
    obs, st = env.reset_batch(g, n, p)
    obs2, _ = env.reset_batch(g, n, p)
    if width == 1:
        x, (a, b) = st.position[:, None], (-0.6, -0.4)
    else:
        x = torch.stack([getattr(st, f.name) for f in dataclasses.fields(st)][:4], dim=-1)
        a, b = -lo, lo
    assert x.dtype == torch.float32 and float(x.min()) >= a and float(x.max()) < b
    mean, sd = (a + b) / 2, (b - a) / 12**0.5
    assert (x.mean(0) - mean).abs().max() < 4 * sd / n**0.5, x.mean(0)
    assert (x.std(0) - sd).abs().max() < 0.02 * sd
    # consecutive resets of one env differ
    assert bool((obs != obs2).any(dim=-1).all())


@pytest.mark.parametrize("env_id", list(ENVS))
def test_vector_env_cheap_autoreset(env_id):
    """The per-frame auto-reset: no pool, one bulk reset draw
    (``reset_draws``) a step, taken before the step where it is injected
    (graphed) and inside ``reset_batch`` where it is not; finished envs
    restart at t = 0 and the transition keeps the true next observation."""
    env, p = make_env(env_id)
    assert env.batch_reset_cheap and env.injects_draws
    calls = []
    reset_draws = env.reset_draws
    env.reset_draws = lambda *a: calls.append(a) or reset_draws(*a)
    n = 64
    for graphed in (True, False):
        venv = VectorEnv(env, n, graphed=graphed)
        assert venv.graphed == graphed
        g = torch.Generator().manual_seed(2)
        obs, states = venv.reset(g, p)
        calls.clear()
        policy = ENVS[env_id][4]
        rng = np.random.default_rng(2)
        finished = 0
        for t in range(250):
            random = rng.integers(0, env.num_actions, n).astype(np.int32)
            actions = torch.from_numpy(np.where(np.arange(n) % 2 == 0, policy(states, rng), random))
            new_obs, states, tr = venv.step(g, states, actions, p, prev_obs=obs)
            done = tr.terminated | tr.truncated
            assert torch.equal(tr.obs, obs) and len(calls) == t + 1
            assert torch.equal(new_obs[~done], tr.next_obs[~done])
            assert (states.t[done] == 0).all() and (states.t[~done] > 0).all()
            assert torch.equal(new_obs, env.get_obs(states, p))
            finished += int(done.sum())
            obs = new_obs.clone()  # a graphed step's output is overwritten by the next
        assert finished > 0


@pytest.mark.parametrize("env_id", list(ENVS))
def test_time_fraction_wrapper_matches_jax(env_id):
    """``TimeFractionObs`` forwards ``reset_batch`` (the wrapped env's bulk
    draw, with the wrapper's observation), and steps as the JAX wrapper."""
    jax_cls, cls, *_ = ENVS[env_id]
    jenv, env = JaxTimeFraction(jax_cls()), TimeFractionObs(cls())
    jp, p = jenv.default_params(), env.default_params()
    inner = []
    reset_batch = env.env.reset_batch
    env.env.reset_batch = lambda *a: inner.append(a) or reset_batch(*a)
    env.reset_env = None  # the wrapper's own reset must not run
    obs, st = env.reset_batch(torch.Generator().manual_seed(0), 16, p)
    assert len(inner) == 1 and obs.shape == (16, env.obs_shape(p)[0])
    assert not obs[:, -1].any() and torch.equal(obs[:, :-1], env.env.get_obs(st, p))

    _, jst = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(4), 16, jp)
    jst = jst.replace(t=jnp.arange(16, dtype=jnp.int32) * 7)
    acts = np.random.default_rng(4).integers(0, jenv.num_actions, 16).astype(np.int32)
    want = _np(jax.vmap(jenv.step_env, (None, 0, 0, None))(
        jax.random.PRNGKey(0), jst, jnp.asarray(acts), jp))
    got = env.step_env(None, _port_state(env.env, _np(jst)), torch.from_numpy(acts), p)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[0][:, -1].numpy(), want[0][:, -1])


def test_mountain_car_energy_pumping_reaches_goal():
    """Bang-bang along the velocity climbs the hill within 200 steps from
    every start (``tests/test_envs_classic.py``), and pushing right alone
    never does."""
    env = MountainCar()
    p = env.default_params()
    g = torch.Generator().manual_seed(3)
    for pump, reaches in ((True, True), (False, False)):
        _, st = env.reset_env(g, 16, p)
        reached = torch.zeros(16, dtype=torch.bool)
        for _ in range(200):
            a = torch.where(st.velocity >= 0, 2, 0) if pump else torch.full((16,), 2)
            _, st, r, term, trunc = env.step_env(None, st, a.to(torch.int32), p)
            assert (r == -1.0).all() and (st.position >= -1.2).all() and (st.position <= 0.6).all()
            assert (st.velocity.abs() <= 0.07 + 1e-7).all()
            reached |= term
        assert bool(reached.all()) == reaches and bool(reached.any()) == reaches
        if not pump:
            assert bool(trunc.all())


def test_acrobot_torque_free_energy_is_conserved():
    """Without torque the RK4 integrator roughly conserves the two-link
    system's energy over 25 steps (5 s), as in ``tests/test_envs_classic.py``;
    a torque-free swing from rest near the bottom never reaches the goal."""
    env = Acrobot()
    p = env.default_params()

    def energy(st):
        t1, t2 = st.theta1.double(), st.theta2.double()
        w1, w2 = st.dtheta1.double(), st.dtheta2.double()
        d1 = 0.25 + (1 + 0.25 + 2 * 0.5 * torch.cos(t2)) + 2.0
        d2 = (0.25 + 0.5 * torch.cos(t2)) + 1.0
        ke = 0.5 * d1 * w1**2 + 0.5 * (0.25 + 1) * w2**2 + d2 * w1 * w2
        pe = 9.8 * (-0.5 * torch.cos(t1) - torch.cos(t1) - 0.5 * torch.cos(t1 + t2))
        return ke + pe

    _, st = env.reset_env(torch.Generator().manual_seed(1), 8, p)
    st = dataclasses.replace(st, theta1=torch.full((8,), 0.5), dtheta1=torch.linspace(-1, 1, 8))
    e0 = energy(st)
    nop = torch.ones(8, dtype=torch.int32)
    for _ in range(25):
        _, st, r, term, _ = env.step_env(None, st, nop, p)
        assert not term.any() and (r == -1.0).all()
    e1 = energy(st)
    assert ((e1 - e0).abs() < 0.25 * e0.abs() + 0.5).all(), (e0, e1)


def test_available_envs_and_classic_ids_build():
    assert available_envs() == ["Acrobot-v1", "CartPole-v1", "LunarLander-v2", "MountainCar-v0"]
    for env_id, (_, cls, *_rest) in ENVS.items():
        env, p = make_env(env_id, max_steps_in_episode=77)
        assert isinstance(env, cls) and p.max_steps_in_episode == 77
