"""R1's per-env body (``deep_q_learning_tpu_torch/csrc/lander_rigid.cuh``)
on the CPU: built by g++ (``-O2 -ffp-contract=off``, no fast math) through
``ops/build.py::cached_build`` into a host library that runs every env in
turn, and held against the JAX ``step_env`` and ``reset`` (vmapped) and the
port's plain versions (``LunarLander.step_env_reference`` and
``reset_env_reference``).

The states are ``tests/test_torch_envs_lunar.py``'s JAX rollouts (wind off
and on; flight, touchdowns on one leg and on both, leg overloads past
``J_CRASH``, landings at rest), and, for what those rollouts do not reach,
rollout states moved to it: to the screen's edges moving out, to the
episode's limit (the step runs with a limit of 300 frames) and tumbling
fast toward the ground (the hull's corners hit it).  Against JAX the
rigid engine's tolerances (tests/test_torch_envs_lunar.py): observations
atol 1e-5, rewards atol 1e-4, flags, counters and indices exact; the
shaping potentials atol 1e-4 plus 2 float32 ulps of their magnitude (the
edge states' reach |600|, where one ulp is 6.1e-5).  Against
the plain version every bit of every output on every lane: the host build
calls the C library's sinf, cosf, tanhf and sqrtf where PyTorch's CPU
kernels compute their own (they differ in the last ulp on some inputs,
sqrt's too), so the plain version runs with ``torch.sin``, ``torch.cos``,
``torch.tanh`` and ``torch.sqrt`` replaced by the C library's.  On the card
the kernel calls sincosf, sinf, tanhf and sqrtf, which are PyTorch's there
(chip_smoke.py holds them and the kernel bit for bit).

The vector step's entry (``lander_rigid.cuh::rigid_vector_env``: the step,
``done``, the auto-reset's selects from a reset pool and the time feature)
is held on the same states, with and without ``TimeFractionObs``, against
``VectorEnv._step``'s plain composition bit for bit, and against the JAX
package's ``VectorEnv.step`` (its selects and ``TimeFractionObs._augment``)
on the same states and pool: observations atol 1e-5, rewards 1e-4, the
potentials as above, flags, counters, indices and terrain rows exact.
"""

import ctypes
import dataclasses
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deep_q_learning_tpu.envs.base import VectorEnv as JaxVectorEnv
from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs, VectorEnv
from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs, rigid_cover
from deep_q_learning_tpu_torch.envs.lunar_lander import (
    CHUNKS,
    ResetDraws,
    _terrain_height,
    smoothed_terrain,
    state_from_numpy,
)
from deep_q_learning_tpu_torch.ops import build
from deep_q_learning_tpu_torch.ops import lander_kernels as lk
from test_torch_envs_lunar import (  # noqa: F401  (the rollout fixture)
    N_ENVS,
    _jax_env,
    _reset_draws,
    _stack_alive,
    rollout,
)

CXX_FLAGS = ("-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-Wall", "-Wno-unknown-pragmas")
MAX_STEPS = 300  # the step's episode limit, below the rollout's 400 frames
EDGES = 16  # states moved to each edge the rollouts do not reach
MATH = {"sin": 0, "cos": 1, "tanh": 2, "sqrt": 3}


@pytest.fixture(scope="module")
def host():
    source = build.CSRC_DIR / "lander_rigid.cuh"

    def compile_to(out: Path) -> None:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(out), str(source)], check=True,
                       capture_output=True, text=True)

    lib = ctypes.CDLL(str(build.cached_build(source, CXX_FLAGS, build.BUILD_DIR, compile_to)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lander_rigid_host.argtypes = [ptr, ptr, i32]
    lib.lander_rigid_vector_host.argtypes = [ptr, ptr, i32]
    lib.lander_math_host.argtypes = [ptr, ptr, i32, i32]
    lib.lander_rigid_sizes.argtypes = [ptr]
    lk.check_sizes(lib)
    return lib


def _host_launch(lib):
    def launch(io, consts, n):
        lib.lander_rigid_host(ctypes.byref(io), ctypes.byref(consts), n)
    return launch


def _host_vector_launch(lib):
    def launch(vio, consts, n):
        lib.lander_rigid_vector_host(ctypes.byref(vio), ctypes.byref(consts), n)
    return launch


class _LibmMath:
    """``torch.sin``, ``cos``, ``tanh`` and ``sqrt`` replaced by the C
    library's (through a host library's ``lander_math_host``,
    ``csrc/lander_frame.cuh``) while the block runs."""

    def __init__(self, lib):
        self.lib = lib

    def _fn(self, which):
        def fn(x):
            x = x.contiguous()
            out = torch.empty_like(x)
            self.lib.lander_math_host(x.data_ptr(), out.data_ptr(), x.numel(), which)
            return out
        return fn

    def __enter__(self):
        self.saved = {name: getattr(torch, name) for name in MATH}
        for name, which in MATH.items():
            setattr(torch, name, self._fn(which))

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(torch, name, fn)


def _params(wind, **kw):
    env = LunarLander()
    return env, dataclasses.replace(env.default_params(), jointed=False, enable_wind=wind, **kw)


def _bitwise_lanes(got, want):
    """Per lane: every bit of every output equal."""
    a, b = tree_leaves(list(got)), tree_leaves(list(want))
    assert len(a) == len(b)
    same = torch.ones(a[0].shape[0], dtype=torch.bool)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        same &= (x == y).reshape(x.shape[0], -1).all(1)
    return same


def _edge_states(states, keys_of, rng):
    """``EDGES`` rollout states moved to each edge the rollouts miss, with
    keys of their own: past the screen's right and left edges next frame,
    one frame before the episode's limit, and tumbling fast toward the
    ground, near enough that a hull corner hits it before a leg's contact
    can lift it."""
    n = len(states.x)
    pick = lambda: rng.choice(n, EDGES)  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    take = lambda idx: jax.tree.map(lambda a: a[idx], states)  # noqa: E731
    half = np.arange(EDGES) < EDGES // 2
    edge = take(pick())
    edge = edge.replace(x=f32(np.where(half, 19.99, 0.01)), vx=f32(np.where(half, 2.0, -2.0)))
    limit = take(pick())
    limit = limit.replace(t=np.full(EDGES, MAX_STEPS - 1, np.int32))
    tumble = take(pick())
    ground = _terrain_height(torch.tensor(tumble.terrain), torch.tensor(tumble.x)).numpy()
    tumble = tumble.replace(
        y=f32(ground + rng.uniform(0.97, 1.05, EDGES)), vy=f32(rng.uniform(-35.0, -25.0, EDGES)),
        angle=f32(rng.choice([-1.0, 1.0], EDGES) * rng.uniform(1.3, 1.6, EDGES)),
        leg1=np.zeros(EDGES, bool), leg2=np.zeros(EDGES, bool))
    moved = jax.tree.map(lambda *a: np.concatenate(a), edge, limit, tumble)
    return moved, keys_of(3 * EDGES)


@pytest.fixture(scope="module")
def step_inputs(rollout):  # noqa: F811
    """(wind, states, actions, draws, JAX outputs, JAX states): the
    rollout's states while each env's first episode lasts and the edge
    states, each stepped by the JAX env at an episode limit of MAX_STEPS."""
    wind, rows = rollout
    states, actions, disp, _ = _stack_alive(rows)
    keys = np.concatenate([
        np.asarray(jax.random.split(jax.random.PRNGKey(1000 + t), N_ENVS))[r[4]]
        for t, r in enumerate(rows)])
    rng = np.random.default_rng(20)
    edge, edge_keys = _edge_states(
        states, lambda k: np.asarray(jax.random.split(jax.random.PRNGKey(77), k)), rng)
    edge_actions = rng.integers(0, 4, len(edge.x)).astype(np.int32)
    disp_of = jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0))
    states = jax.tree.map(lambda a, b: np.concatenate([a, b]), states, edge)
    keys = np.concatenate([keys, edge_keys])
    actions = np.concatenate([actions, edge_actions])
    disp = np.concatenate([disp, np.asarray(disp_of(edge_keys))])
    env, p = _jax_env(enable_wind=wind)
    p = p.replace(max_steps_in_episode=MAX_STEPS)
    out = jax.jit(jax.vmap(env.step, (0, 0, 0, None)))(keys, states, actions, p)
    return wind, state_from_numpy(states), torch.from_numpy(actions), torch.from_numpy(disp), [
        np.asarray(out[i]) for i in range(5) if i != 1] + [out[1]], states


def test_host_body_matches_jax_and_plain(host, step_inputs):
    wind, st, actions, disp, (obs_j, rew_j, term_j, trunc_j, st_j), _ = step_inputs
    env, p = _params(wind, max_steps_in_episode=MAX_STEPS)
    cover = {k: int(v.sum()) for k, v in rigid_cover(env, p, st, actions, disp).items()}
    assert all(v > 0 for v in cover.values()), cover
    got = lk.rigid_call(_host_launch(host), p, state=st, action=actions, draws=disp)
    obs, new, rew, term, trunc = got
    np.testing.assert_allclose(obs.numpy(), obs_j[:, :8], atol=1e-5, rtol=0)
    np.testing.assert_allclose(rew.numpy(), rew_j, atol=1e-4, rtol=0)
    # the potentials of the edge states reach |600|, where 1e-4 is under 2 float32 ulps
    np.testing.assert_allclose(new.prev_shaping.numpy(), np.asarray(st_j.prev_shaping),
                               atol=1e-4, rtol=2.5e-7)
    np.testing.assert_array_equal(term.numpy(), term_j)
    np.testing.assert_array_equal(trunc.numpy(), trunc_j)
    for f in ("t", "sleep", "wind_idx", "torque_idx", "leg1", "leg2"):
        np.testing.assert_array_equal(getattr(new, f).numpy(), np.asarray(getattr(st_j, f)), f)
    with _LibmMath(host):
        want = env.step_env_reference(None, st, actions, p, disp)
    same = _bitwise_lanes(got, want)
    assert bool(same.all()), (int((~same).sum()), cover)
    # with the wind off the step keeps the indices it was given, as the plain version
    assert (new.wind_idx is st.wind_idx) == (want[1].wind_idx is st.wind_idx) == (not wind)
    assert new.terrain is st.terrain


@pytest.fixture(scope="module", params=[False, True], ids=["obs", "time_feature"])
def vector_case(request, host, step_inputs):
    """The vector step on step_inputs' states with a reset pool, the time
    feature off or on: (time_feature, wind, the port's env and params, the
    inputs, the host build's outputs, the JAX package's VectorEnv.step's
    outputs).  The JAX step draws each env's dispersion from its step key;
    the port's step takes the same uniforms as its draws, and the same pool
    (the JAX env's fresh_pool)."""
    feature = request.param
    wind, st, actions, _, _, states = step_inputs
    n = len(actions)
    env_j, p_j = _jax_env(enable_wind=wind)
    env_j = env_j if feature else env_j.env
    p_j = p_j.replace(max_steps_in_episode=MAX_STEPS)
    venv_j = JaxVectorEnv(env_j, n)
    key = jax.random.PRNGKey(123)
    step_key, _ = jax.random.split(key)
    disp_of = jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0))
    disp = torch.tensor(np.asarray(disp_of(jax.random.split(step_key, n))))
    fresh_j = jax.jit(venv_j.fresh_pool)(jax.random.PRNGKey(5), p_j)
    out_j = jax.jit(venv_j.step)(key, states, actions.numpy(), p_j, None, fresh_j)
    fresh = (torch.tensor(np.asarray(fresh_j[0])),
             state_from_numpy(jax.tree.map(np.asarray, fresh_j[1])))
    env, p = _params(wind, max_steps_in_episode=MAX_STEPS)
    port_env = TimeFractionObs(env) if feature else env
    got = lk.rigid_vector_call(_host_vector_launch(host), p, st, actions, disp, fresh, feature)
    return feature, wind, port_env, p, (st, actions, disp, fresh), got, out_j


def test_host_vector_step_is_the_plain_composition(host, vector_case):
    """Every bit of every output on every lane: the observation and state
    after the auto-reset, the pre-reset next_obs, the reward and the flags,
    against VectorEnv._step's plain composition on CPU tensors; the states
    end every way (crash, hull hit, out of bounds, rest, the episode's
    limit) and some go on."""
    feature, wind, port_env, p, (st, actions, disp, fresh), got, _ = vector_case
    env = port_env.env if feature else port_env
    cover = {k: int(v.sum()) for k, v in rigid_cover(env, p, st, actions, disp).items()}
    assert all(v > 0 for v in cover.values()), cover
    venv = VectorEnv(port_env, len(actions), graphed=False)
    prev_obs = torch.zeros_like(fresh[0])
    lk.reset_counts()
    with _LibmMath(host):
        out_obs, out_st, tr = venv._step(None, st, actions, p, prev_obs, fresh, disp)
    assert lk.plain_calls == {"rigid_step": 1} and lk.launches == {"rigid_step": 0}
    assert tr.obs is prev_obs and tr.action is actions
    want = (out_obs, out_st, tr.next_obs, tr.reward, tr.terminated, tr.truncated)
    same = _bitwise_lanes(got, want)
    assert bool(same.all()), (int((~same).sum()), cover)
    done = tr.terminated | tr.truncated
    assert bool(done.any()) and bool((~done).any())
    assert got[0].shape == (len(actions), 8 + feature) and got[1].leg1_body is None
    # every leaf of the state after the reset is a tensor of its own
    inputs = {id(t) for t in tree_leaves([st, fresh])}
    assert not any(id(t) in inputs for t in tree_leaves(list(got)))


def test_host_vector_step_matches_jax(vector_case):
    """Against the JAX package's VectorEnv.step (vmapped step, jnp.where
    selects, TimeFractionObs._augment) on the same states, draws and pool,
    at the rigid engine's tolerances."""
    feature, wind, _, _, (_, _, _, fresh), got, (obs_j, st_j, tr_j) = vector_case
    out_obs, out_st, next_obs, reward, term, trunc = got
    np.testing.assert_allclose(out_obs.numpy(), np.asarray(obs_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(next_obs.numpy(), np.asarray(tr_j.next_obs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reward.numpy(), np.asarray(tr_j.reward), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(term.numpy(), np.asarray(tr_j.terminated))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(tr_j.truncated))
    np.testing.assert_allclose(out_st.prev_shaping.numpy(), np.asarray(st_j.prev_shaping),
                               atol=1e-4, rtol=2.5e-7)
    np.testing.assert_array_equal(out_st.terrain.numpy(), np.asarray(st_j.terrain))
    for f in ("t", "sleep", "wind_idx", "torque_idx", "leg1", "leg2"):
        np.testing.assert_array_equal(getattr(out_st, f).numpy(), np.asarray(getattr(st_j, f)), f)
    done = (term | trunc).numpy()
    # the lanes that reset hold the pool's entry bit for bit
    np.testing.assert_array_equal(out_obs.numpy()[done], fresh[0].numpy()[done])
    assert out_obs.shape[1] == 8 + feature and 0 < done.sum() < len(done)


@pytest.mark.parametrize("wind", [False, True])
@pytest.mark.parametrize("random_terrain", [True, False])
def test_host_reset_frame_matches_jax_and_plain(host, wind, random_terrain):
    env_j, p_j = _jax_env(enable_wind=wind, random_terrain=random_terrain)
    env, p = _params(wind, random_terrain=random_terrain)
    keys = jax.random.split(jax.random.PRNGKey(31), 4 * N_ENVS)
    obs_j, st_j = jax.jit(jax.vmap(env_j.reset, (0, None)))(keys, p_j)
    terrain, kick, wind_draws = (np.asarray(x) for x in jax.vmap(_reset_draws)(keys))
    draws = ResetDraws(terrain=torch.tensor(terrain), kick=torch.tensor(kick),
                       wind=torch.from_numpy(wind_draws.astype(np.int32)))
    got = lk.rigid_call(_host_launch(host), p, terrain=smoothed_terrain(draws.terrain, p),
                        kick=draws.kick, wind=draws.wind)
    obs, st = got
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j)[:, :8], atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.prev_shaping.numpy(), np.asarray(st_j.prev_shaping),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(st.terrain.numpy(), np.asarray(st_j.terrain), atol=1e-6)
    for f in ("t", "sleep", "wind_idx", "torque_idx"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(st_j, f)), f)
    with _LibmMath(host):
        want = env.reset_env_reference(None, len(keys), p, draws)
    assert bool(_bitwise_lanes(got, want).all())


def test_step_and_reset_on_cpu_tensors_are_the_plain_version():
    env, p = _params(False)
    g = torch.Generator().manual_seed(4)
    lk.reset_counts()
    obs, st = env.reset_env(g, 16, p)
    assert lk.plain_calls == {"rigid_step": 1} and lk.launches == {"rigid_step": 0}
    actions = torch.randint(0, 4, (16,), generator=g, dtype=torch.int32)
    draws = env.step_draws(g, 16)
    got = env.step_env(None, st, actions, p, draws)
    want = env.step_env_reference(None, st, actions, p, draws)
    assert bool(_bitwise_lanes(got, want).all())
    assert lk.plain_calls == {"rigid_step": 2} and lk.launches == {"rigid_step": 0}
    # the jointed engine counts no rigid call
    env.reset_env(g, 2, dataclasses.replace(p, jointed=True))
    assert lk.plain_calls == {"rigid_step": 2}


class _FusedStub(LunarLander):
    """A rigid lander that says it fuses its vector step with a pool and
    records the calls instead of launching."""

    def __init__(self):
        self.calls = []

    def fuses_vector_step(self, params, state, fresh):
        return fresh is not None

    def vector_step(self, generator, state, action, params, fresh, draws=None, reset_draws=None,
                    time_feature=False):
        self.calls.append((draws, time_feature))
        return self.step_env_reference(None, state, action, params, draws)[:1] * 6


def test_vector_step_dispatch_is_configuration():
    """``VectorEnv._step`` takes the fused entry where the env says so and a
    pool is given (``TimeFractionObs`` forwarding it with its feature on),
    and the plain composition otherwise: without a pool, on CPU tensors,
    for the jointed engine, and under a wrapper of a wrapper."""
    env, p = _params(False)
    g = torch.Generator().manual_seed(3)
    obs, st = env.reset_env(g, 4, p)
    pool = (obs, st)
    assert not env.fuses_vector_step(p, st, pool)
    assert not TimeFractionObs(env).fuses_vector_step(p, st, pool)
    assert not env.fuses_vector_step(dataclasses.replace(p, jointed=True), st, pool)
    a, d = torch.zeros(4, dtype=torch.int32), env.step_draws(g, 4)
    for wrap, feature in ((False, False), (True, True)):
        stub = _FusedStub()
        venv = VectorEnv(TimeFractionObs(stub) if wrap else stub, 4, graphed=False)
        out_obs, _, tr = venv._step(None, st, a, p, obs, (obs, st), d)
        assert stub.calls == [(d, feature)] and tr.obs is obs and tr.action is a
        venv._step(None, st, a, p, obs, None, d, env.reset_draws(g, 4))  # no pool
        assert len(stub.calls) == 1
    assert not TimeFractionObs(TimeFractionObs(_FusedStub())).fuses_vector_step(p, st, pool)


def test_rigid_inputs_cover_the_step():
    """``lander_step_inputs`` (the smoke's states, here at a small size on the
    CPU): the lanes' shapes, the ending steps first, and what they cover."""
    env, p = _params(True, max_steps_in_episode=60)
    g = torch.Generator().manual_seed(2)
    st, actions, draws = lander_step_inputs(env, p, 256, g, envs=64, frames=80)
    assert st.x.shape == (256,) and st.terrain.shape == (256, CHUNKS) and draws.shape == (256, 2)
    assert actions.dtype == torch.int32 and st.x.is_contiguous()
    cover = rigid_cover(env, p, st, actions, draws)
    for name in ("flight", "one leg", "two legs", "overload", "rest", "truncated", "wind"):
        assert bool(cover[name].any()), name


def test_wrappers_check_their_inputs():
    """The kernel's wrappers refuse CPU tensors (``step_env`` and
    ``VectorEnv._step`` take the plain versions for those), a wrong dtype,
    a non-contiguous input, a wrong shape (a pool's observation without
    the time feature where it is asked for) and the jointed engine;
    nothing launches."""
    env, p = _params(False)
    obs, st = env.reset_env(torch.Generator().manual_seed(0), 4, p)
    a = torch.zeros(4, dtype=torch.int32)
    d = torch.zeros((4, 2))
    lk.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk.rigid_step_kernel(st, a, p, d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk.rigid_reset_kernel(st.terrain, d, torch.zeros((4, 2), dtype=torch.int32), p)
    with pytest.raises(TypeError, match="dtype"):
        lk.rigid_step_kernel(st, a.long(), p, d)
    with pytest.raises(TypeError, match="dtype"):
        lk.rigid_step_kernel(dataclasses.replace(st, vx=st.vx.double()), a, p, d)
    with pytest.raises(ValueError, match="contiguous"):
        lk.rigid_step_kernel(dataclasses.replace(
            st, terrain=torch.zeros((CHUNKS, 4)).t()), a, p, d)
    with pytest.raises(ValueError, match="shape"):
        lk.rigid_step_kernel(st, a, p, torch.zeros((5, 2)))
    with pytest.raises(ValueError, match="shape"):
        lk.rigid_reset_kernel(st.terrain, torch.zeros((4, 3)), torch.zeros((4, 2)).int(), p)
    with pytest.raises(ValueError, match="jointed"):
        lk.rigid_step_kernel(st, a, dataclasses.replace(p, jointed=True), d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk.rigid_vector_kernel(st, a, p, d, (obs, st))
    with pytest.raises(ValueError, match="shape"):
        lk.rigid_vector_kernel(st, a, p, d, (obs, st), time_feature=True)
    with pytest.raises(TypeError, match="dtype"):
        lk.rigid_vector_kernel(st, a, p, d, (obs, dataclasses.replace(st, t=st.t.long())))
    with pytest.raises(ValueError, match="jointed"):
        lk.rigid_vector_kernel(st, a, dataclasses.replace(p, jointed=True), d, (obs, st))
    assert lk.launches == {"rigid_step": 0} and lk.plain_calls == {"rigid_step": 0}


# ------------------------------------------------------------------- work
_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "sin", "cos", "tanh", "abs",
          "floor", "clamp", "clamp_min", "clamp_max", "minimum", "maximum", "reciprocal", "pow"}


def _is_one(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 and float(x) == 1.0
    return x == 1.0


class _CountArithmetic(TorchDispatchMode):
    """Float arithmetic of the plain version, one operation an element of an
    elementwise op's output; ``x * 1.0`` (how PyTorch writes ``1.0 / t``,
    after a reciprocal) counts nothing."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (isinstance(out, torch.Tensor) and out.is_floating_point() and name in _ARITH
                and not (name == "mul" and _is_one(args[1]))):
            self.ops += out.numel()
        return out


def _count(fn):
    count = _CountArithmetic()
    with count:
        out = fn()
    return count.ops, out


def _size(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("wind", [False, True])
def test_work_counts_what_the_code_does(wind):
    """``rigid_step_work``: the bytes of a call's inputs read and outputs
    written, and the plain version's arithmetic less its second evaluation
    of the observation (inside ``_shaping``; the kernel computes it once),
    for a step, for the reset frame (less the terrain's smoothing, which
    stays plain ops) and for the vector step with a reset pool, the time
    feature off and on."""
    env, p = _params(wind)
    n = 7
    g = torch.Generator().manual_seed(9)
    _, st = env.reset_env(g, n, p)
    actions = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32)
    draws = env.step_draws(g, n)
    ops, out = _count(lambda: env.step_env_reference(None, st, actions, p, draws))
    obs_ops, _ = _count(lambda: env.get_obs(out[1], p))
    nbytes, work_ops = lk.rigid_step_work(n, wind)
    assert work_ops == ops - obs_ops
    skipped = () if wind else ("wind_idx", "torque_idx")
    read = [getattr(st, f.name) for f in dataclasses.fields(st)
            if getattr(st, f.name) is not None and f.name not in skipped] + [actions, draws]
    inputs = {id(t) for t in tree_leaves(st)}
    written = [t for t in tree_leaves(list(out)) if id(t) not in inputs]
    assert nbytes == _size(read) + _size(written)

    rd = env.reset_draws(g, n)
    ops, (obs, fresh) = _count(lambda: env.reset_env_reference(None, n, p, rd))
    smooth_ops, _ = _count(lambda: smoothed_terrain(rd.terrain, p))
    nbytes, work_ops = lk.rigid_step_work(n, wind, reset=True)
    assert work_ops == ops - smooth_ops - obs_ops
    written = [t for t in tree_leaves([obs, fresh]) if t is not fresh.terrain]
    assert nbytes == _size([fresh.terrain, rd.kick, rd.wind]) + _size(written)

    # the vector step with a reset pool (its plain composition: the step,
    # the selects and the time feature), with and without the feature; the
    # selects read the wind indices with the wind off too
    for feature in (False, True):
        port_env = TimeFractionObs(env) if feature else env
        pool = port_env.reset_env(None, n, p, env.reset_draws(g, n))
        prev_obs = torch.zeros_like(pool[0])
        venv = VectorEnv(port_env, n, graphed=False)
        ops, out = _count(lambda: venv._step(None, st, actions, p, prev_obs, pool, draws))
        nbytes, work_ops = lk.rigid_step_work(n, wind, vector=True, time_feature=feature)
        assert work_ops == ops - obs_ops, feature
        out_obs, out_st, tr = out
        read = tree_leaves([st, actions, draws, pool])
        inputs = {id(t) for t in read + [prev_obs]}
        written = [t for t in tree_leaves([out_obs, out_st, tr]) if id(t) not in inputs]
        assert nbytes == _size(read) + _size(written), feature
