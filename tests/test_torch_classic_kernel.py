"""A1, C1 and M1's per-env bodies (``deep_q_learning_tpu_torch/csrc/
classic_envs.cuh``) on the CPU: built by g++ (``-O2 -ffp-contract=off``, no
fast math) through ``ops/build.py::cached_build`` into a host library that
runs every env in turn, and held against the JAX package's ``step_env``
(vmapped) and ``VectorEnv.step``, and against the port's plain versions
(``<Env>.step_env_reference`` and ``VectorEnv._step``'s composition).

The states are ``tests/test_torch_envs_classic.py``'s JAX rollouts (32 envs
each; terminations and time-limit truncations), and, for what those do not
reach, edge states: the 500- and 200-step limits; CartPole's |x| at 2.4 and
|theta| at 12 degrees, on them and one float past; Acrobot's tip near
height 1, angles at and across ±pi and both rates driven into their
clamps; MountainCar at the goal and at the left wall moving left.

Against the plain version every bit of every output on every lane: the
host build calls the C library's sinf and cosf where PyTorch's CPU kernels
compute their own (they differ in the last ulp on some inputs), so the
plain version runs with ``torch.sin`` and ``torch.cos`` replaced by the C
library's.  On the card the kernels call sincosf, which is PyTorch's there
(chip_smoke.py holds them and the kernels bit for bit).  Against JAX the
tolerances of ``tests/test_torch_envs_classic.py``: CartPole and
MountainCar observations and states atol 1e-6; Acrobot within 4x JAX's own
float32 error against its float64 evaluation of the same states (plus
1e-7), angles through their cos and sin; rewards exact and flags exact but
within 1e-6 of a threshold (at most 0.1 % of the lanes).

The vector entry (the step, ``done``, the reset from the injected draws,
the selects and the time feature) is held with and without
``TimeFractionObs`` against ``VectorEnv._step``'s plain composition bit for
bit, and against the JAX ``VectorEnv.step`` from the same key, whose reset
draws the host build is given.
"""

import ctypes
import dataclasses
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deep_q_learning_tpu.envs.base import VectorEnv as JaxVectorEnv
from deep_q_learning_tpu.envs.wrappers import TimeFractionObs as JaxTimeFraction
from deep_q_learning_tpu_torch.envs import CartPole, TimeFractionObs, VectorEnv
from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
from deep_q_learning_tpu_torch.ops import build
from deep_q_learning_tpu_torch.ops import classic_kernels as ck
from test_torch_envs_classic import (
    ENVS,
    F64_FLOOR,
    F64_MULTIPLE,
    _acrobot_fields,
    _check_flags,
    _draws,
    _np,
    _port_state,
    _rollout,
)

CXX_FLAGS = ("-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-Wall", "-Wno-unknown-pragmas")
EDGES = 16  # states of each kind of edge
F32 = np.float32


@pytest.fixture(scope="module")
def host():
    source = build.CSRC_DIR / "classic_envs.cuh"

    def compile_to(out: Path) -> None:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(out), str(source)], check=True,
                       capture_output=True, text=True)

    lib = ctypes.CDLL(str(build.cached_build(source, CXX_FLAGS, build.BUILD_DIR, compile_to)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.classic_envs_host.argtypes = [i32, i32, ptr, ptr, i32]
    lib.lander_math_host.argtypes = [ptr, ptr, i32, i32]
    lib.classic_envs_sizes.argtypes = [ptr]
    ck.check_sizes(lib)
    return lib


def _host_launch(lib, kernel):
    def launch(io, consts, n, vector):
        assert lib.classic_envs_host(ck.SPECS[kernel].index, vector, ctypes.byref(io),
                                     ctypes.byref(consts), n) == 0
    return launch


class _LibmTrig:
    """``torch.sin`` and ``torch.cos`` replaced by the C library's (through
    the host library's ``lander_math_host``, ``csrc/lander_frame.cuh``)
    while the block runs."""

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
        self.saved = torch.sin, torch.cos
        torch.sin, torch.cos = self._fn(0), self._fn(1)

    def __exit__(self, *exc):
        torch.sin, torch.cos = self.saved


def _bitwise_lanes(got, want):
    """Per lane: every bit of every output equal."""
    a, b = tree_leaves(list(got)), tree_leaves(list(want))
    assert len(a) == len(b)
    same = torch.ones(a[0].shape[0], dtype=torch.bool)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        same &= (x == y).reshape(x.shape[0], -1).all(1)
    return same


# ------------------------------------------------------------------ states
def _edge_states(env_id, states, rng):
    """Edge states of ``env_id`` (numpy fields of the JAX state), and what
    each kind is called, one name a lane."""
    n = len(states.t)
    take = lambda: jax.tree.map(lambda a: np.array(a[rng.choice(n, EDGES)]), states)  # noqa: E731
    side = np.where(np.arange(EDGES) % 2 == 0, 1.0, -1.0).astype(F32)
    kinds = []

    def kind(name, st):
        kinds.extend([name] * EDGES)
        return st

    limit = ENVS[env_id][0]().default_params().max_steps_in_episode
    at_limit = take()
    at_limit = kind("episode limit", at_limit.replace(t=np.full(EDGES, limit - 1, np.int32)))
    out = [at_limit]
    if env_id == "CartPole-v1":
        p = ENVS[env_id][0]().default_params()
        x, th = F32(p.x_threshold), F32(p.theta_threshold)
        on = np.arange(EDGES) < EDGES // 2  # on the bound; past it by a float
        for name, field, bound, rate in (("|x| at 2.4", "x", x, "x_dot"),
                                         ("|theta| at 12 deg", "theta", th, "theta_dot")):
            st = take()
            value = np.where(on, bound, np.nextafter(bound, F32(np.inf))) * side
            st = st.replace(**{field: value.astype(F32), rate: np.zeros(EDGES, F32)})
            out.append(kind(name, st))
    elif env_id == "Acrobot-v1":
        pi = F32(np.pi)
        st = take()  # at ±pi, and crossing it within the step
        theta = np.where(np.arange(EDGES) < EDGES // 2, pi, np.nextafter(pi, F32(0))) * side
        out.append(kind("angles at ±pi", st.replace(
            theta1=theta.astype(F32), theta2=(-theta).astype(F32),
            dtheta1=(side * rng.uniform(0.0, 3.0, EDGES)).astype(F32))))
        st = take()  # both rates driven into their clamps
        out.append(kind("rate clamps", st.replace(
            dtheta1=(side * F32(12.5)).astype(F32), dtheta2=(-side * F32(28.2)).astype(F32))))
        st = take()  # at rest with the tip near height 1
        theta1 = rng.uniform(2.0, 2.2, EDGES).astype(F32)
        out.append(kind("tip near 1", st.replace(
            theta1=theta1, theta2=np.zeros(EDGES, F32), dtheta1=np.zeros(EDGES, F32),
            dtheta2=np.zeros(EDGES, F32))))
    else:
        st = take()  # reaching the goal
        out.append(kind("goal", st.replace(
            position=rng.uniform(0.45, 0.5, EDGES).astype(F32),
            velocity=rng.uniform(0.02, 0.07, EDGES).astype(F32))))
        st = take()  # at the left wall moving left
        out.append(kind("left wall", st.replace(
            position=(F32(-1.2) + rng.uniform(0.0, 0.01, EDGES)).astype(F32),
            velocity=rng.uniform(-0.07, -0.02, EDGES).astype(F32))))
    return jax.tree.map(lambda *a: np.concatenate(a), *out), np.array(kinds)


@pytest.fixture(scope="module", params=list(ENVS))
def case(request):
    """One env's inputs and the JAX outputs: the rollout's pre-step states
    and the edge states, their actions, the JAX ``step_env`` of each, the
    JAX ``VectorEnv.step`` of all (without and with ``TimeFractionObs``)
    from one key and the reset draws that key gives, and for Acrobot the
    largest gap per field between JAX's float32 step and its float64
    evaluation on these states."""
    env_id = request.param
    jax_cls, port_cls, *_ = ENVS[env_id]
    jenv, env = jax_cls(), port_cls()
    jp = jenv.default_params()
    states, actions, _ = _rollout(env_id)
    rng = np.random.default_rng(24)
    edges, kinds = _edge_states(env_id, states, rng)
    states = jax.tree.map(lambda a, b: np.concatenate([a, b]), states, edges)
    actions = np.concatenate(
        [actions, rng.integers(0, env.num_actions, len(kinds)).astype(np.int32)])
    n = len(actions)
    step = jax.jit(jax.vmap(jenv.step_env, (None, 0, 0, None)))
    want = _np(step(jax.random.PRNGKey(0), states, jnp.asarray(actions), jp))
    key = jax.random.PRNGKey(11)
    _, reset_key = jax.random.split(key)
    _, fresh = jenv.reset_batch(reset_key, n, jp)
    fields = [f.name for f in dataclasses.fields(fresh)][:-1]
    draws = np.stack([np.asarray(getattr(fresh, f)) for f in fields[:ENVS[env_id][3]]], -1)
    draws = draws[:, 0] if draws.shape[1] == 1 else draws
    vec = {feature: _np(jax.jit(JaxVectorEnv(JaxTimeFraction(jenv) if feature else jenv,
                                             n).step)(key, states, jnp.asarray(actions), jp))
           for feature in (False, True)}
    gaps = None
    if env_id == "Acrobot-v1":
        with jax.enable_x64(True):
            wide = jax.tree.map(lambda x: x.astype(np.float64) if x.dtype == F32 else x, states)
            out64 = _np(step(jax.random.PRNGKey(0), wide, jnp.asarray(actions), jp))
        f64 = dict(_acrobot_fields(out64[1]))
        gaps = {name: float(np.abs(v - f64[name]).max()) for name, v in _acrobot_fields(want[1])}
    return types.SimpleNamespace(
        env_id=env_id, env=env, params=env.default_params(), states=states, kinds=kinds,
        port_states=_port_state(env, states), actions=torch.from_numpy(actions),
        want=want, vec=vec, draws=torch.from_numpy(np.ascontiguousarray(draws)), gaps=gaps)


def _host_step(host, c):
    return ck.classic_call(_host_launch(host, c.env.kernel), c.env.kernel, c.params,
                           c.port_states, c.actions)


def _host_vector(host, c, feature):
    return ck.classic_call(_host_launch(host, c.env.kernel), c.env.kernel, c.params,
                           c.port_states, c.actions, c.draws, feature)


def _assert_step_close(c, got, want):
    """``step_env``'s outputs against JAX's at the classic tolerances."""
    if c.env_id == "Acrobot-v1":
        port = dict(_acrobot_fields(got[1]))
        for name, values in _acrobot_fields(want[1]):
            gap = float(np.abs(port[name] - values).max())
            assert gap <= F64_MULTIPLE * c.gaps[name] + F64_FLOOR, (name, gap, c.gaps[name])
        bound = F64_MULTIPLE * max(c.gaps.values()) + F64_FLOOR
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=bound, rtol=0)
    else:
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6, rtol=0)
        for f in dataclasses.fields(got[1]):
            np.testing.assert_allclose(getattr(got[1], f.name).numpy(), getattr(want[1], f.name),
                                       atol=1e-6, rtol=0, err_msg=f.name)
    np.testing.assert_array_equal(got[1].t.numpy(), want[1].t)
    _check_all_flags(c, got, want)


def _check_all_flags(c, got, want):
    """``_check_flags`` on the rollout's lanes (flags exact but within 1e-6
    of a threshold, on at most 0.1 % of them); on the edge states, placed
    on the thresholds on purpose where both sides compute the same
    operands, flags and rewards exact."""
    rows = len(c.actions) - len(c.kinds)
    head = jax.tree.map(lambda a: a[:rows], want[1])
    _check_flags(c.env_id, (None, None, *(x[:rows] for x in got[2:5])),
                 (None, head, *(np.asarray(x)[:rows] for x in want[2:5])))
    for i in (2, 3, 4):
        np.testing.assert_array_equal(got[i][rows:].numpy(), np.asarray(want[i])[rows:])


def test_edge_states_reach_what_they_cover(case):
    """The edge states do what they are for in JAX's step: the limits
    truncate, the bounds (on them and one float past) end and do not end
    episodes, the angles wrap, the rates clamp, tips pass height 1, cars
    reach the goal and stop at the wall."""
    c = case
    at = lambda name: c.kinds == name  # noqa: E731
    rows = slice(len(c.actions) - len(c.kinds), None)
    st, term, trunc = c.want[1], c.want[3][rows], c.want[4][rows]
    edge = jax.tree.map(lambda a: a[rows], st)
    assert trunc[at("episode limit")].any() and (trunc | term)[at("episode limit")].all()
    if c.env_id == "CartPole-v1":
        for name in ("|x| at 2.4", "|theta| at 12 deg"):
            ends = term[at(name)]
            assert ends.any() and not ends.all(), name
    elif c.env_id == "Acrobot-v1":
        wrapped = np.abs(edge.theta1[at("angles at ±pi")]) > 3.0
        assert wrapped.any()
        assert np.isin(np.abs(edge.dtheta1[at("rate clamps")]), F32(4 * np.pi)).any()
        assert np.isin(np.abs(edge.dtheta2[at("rate clamps")]), F32(9 * np.pi)).any()
        tips = term[at("tip near 1")]
        assert tips.any() and not tips.all()
    else:
        assert term[at("goal")].any()
        wall = at("left wall")
        assert (edge.position[wall] == F32(-1.2)).any()
        assert (edge.velocity[wall][edge.position[wall] == F32(-1.2)] == 0).all()


def test_step_entry_is_the_plain_version(host, case):
    """The step entry against ``step_env_reference`` (the C library's sin
    and cos): every bit of every output on every lane; through
    ``step_env`` CPU tensors take the plain version, counted."""
    c = case
    got = _host_step(host, c)
    with _LibmTrig(host):
        want = c.env.step_env_reference(None, c.port_states, c.actions, c.params)
        ck.reset_counts()
        again = c.env.step_env(None, c.port_states, c.actions, c.params)
    kernel = c.env.kernel
    assert ck.plain_calls[kernel] == 1 and not any(ck.launches.values())
    same = _bitwise_lanes(got, want)
    assert bool(same.all()), (int((~same).sum()), c.kinds)
    assert bool(_bitwise_lanes(again, want).all())
    assert got[0].shape == (len(c.actions), ck.SPECS[kernel].obs)


def test_step_entry_matches_jax(host, case):
    _assert_step_close(case, _host_step(host, case), case.want)


@pytest.mark.parametrize("feature", [False, True], ids=["obs", "time_feature"])
def test_vector_entry_is_the_plain_composition(host, case, feature):
    """The vector entry against ``VectorEnv._step``'s plain composition on
    CPU tensors (the step, ``done``, ``reset_env`` from the same draws,
    ``tree_where``, ``TimeFractionObs._augment``): every bit of every
    output on every lane; some lanes reset and some go on."""
    c = case
    got = _host_vector(host, c, feature)
    port_env = TimeFractionObs(c.env) if feature else c.env
    venv = VectorEnv(port_env, len(c.actions), graphed=False)
    prev_obs = torch.zeros_like(got[0])
    with _LibmTrig(host):
        out_obs, out_st, tr = venv._step(None, c.port_states, c.actions, c.params, prev_obs,
                                         None, None, c.draws)
    assert tr.obs is prev_obs and tr.action is c.actions
    want = (out_obs, out_st, tr.next_obs, tr.reward, tr.terminated, tr.truncated)
    same = _bitwise_lanes(got, want)
    assert bool(same.all()), int((~same).sum())
    done = tr.terminated | tr.truncated
    assert bool(done.any()) and bool((~done).any())
    assert got[0].shape == (len(c.actions), ck.SPECS[c.env.kernel].obs + feature)
    # every leaf of the state after the reset is a tensor of its own
    inputs = {id(t) for t in tree_leaves([c.port_states, c.draws])}
    assert not any(id(t) in inputs for t in tree_leaves(list(got)))


@pytest.mark.parametrize("feature", [False, True], ids=["obs", "time_feature"])
def test_vector_entry_matches_jax(host, case, feature):
    """Against the JAX package's ``VectorEnv.step`` (vmapped step, one bulk
    reset draw, ``jnp.where`` selects, ``TimeFractionObs._augment``) from
    one key, the host build given that key's reset draws: the transition
    at the step's tolerances, and the state and observation after the
    reset likewise, the lanes that reset holding the draws' state bit for
    bit."""
    c = case
    out_obs, out_st, next_obs, reward, term, trunc = _host_vector(host, c, feature)
    obs_j, st_j, tr_j = c.vec[feature]
    width = ck.SPECS[c.env.kernel].obs
    _check_all_flags(c, (next_obs[:, :width], None, reward, term, trunc),
                     (tr_j.next_obs, c.want[1], tr_j.reward, tr_j.terminated, tr_j.truncated))
    agree = ((term.numpy() == tr_j.terminated) & (trunc.numpy() == tr_j.truncated))
    atol = 1e-6
    if c.env_id == "Acrobot-v1":
        atol = F64_MULTIPLE * max(c.gaps.values()) + F64_FLOOR
    np.testing.assert_allclose(next_obs.numpy(), tr_j.next_obs, atol=atol, rtol=0)
    np.testing.assert_allclose(out_obs.numpy()[agree], obs_j[agree], atol=atol, rtol=0)
    done = (term | trunc).numpy()
    assert done.any() and not done.all()
    np.testing.assert_array_equal(out_st.t.numpy()[agree], st_j.t[agree])
    for f in ck.SPECS[c.env.kernel].fields:
        got, want = getattr(out_st, f).numpy(), getattr(st_j, f)
        np.testing.assert_array_equal(got[done & agree], want[done & agree], f)
    if feature:  # XLA multiplies t by the reciprocal of max_steps: within an ulp
        np.testing.assert_allclose(next_obs[:, -1].numpy(), tr_j.next_obs[:, -1], atol=0,
                                   rtol=2.0**-23)
        np.testing.assert_array_equal(out_obs[done][:, -1].numpy(), np.zeros(done.sum(), F32))


# -------------------------------------------------------- the wrappers' side
def _small(env_id, n=8, seed=0):
    env = ENVS[env_id][1]()
    p = env.default_params()
    _, st = env.reset_env(None, n, p, _draws(env, n, seed))
    actions = torch.randint(0, env.num_actions, (n,), generator=torch.Generator().manual_seed(seed),
                            dtype=torch.int32)
    return env, p, st, actions


@pytest.mark.parametrize("env_id", list(ENVS))
def test_host_step_takes_strided_fields(host, env_id):
    """A reset's state fields are columns of its draws: the entries read
    every field, t too, with its stride, as from contiguous copies."""
    env, p, st, actions = _small(env_id, n=16, seed=1)
    leaves = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    strided = type(st)(**{k: torch.stack([v, v], 1)[:, 1] for k, v in leaves.items()})
    flat = type(st)(**{k: v.contiguous() for k, v in leaves.items()})
    assert not any(getattr(strided, k).is_contiguous() for k in leaves)
    launch = _host_launch(host, env.kernel)
    for draws in (None, _draws(env, 16, seed=2)):
        got = ck.classic_call(launch, env.kernel, p, strided, actions, draws)
        want = ck.classic_call(launch, env.kernel, p, flat, actions, draws)
        assert bool(_bitwise_lanes(got, want).all())


@pytest.mark.parametrize("env_id", list(ENVS))
def test_wrappers_check_their_inputs(env_id):
    """The kernels' wrappers refuse CPU tensors (``step_env`` and
    ``VectorEnv._step`` take the plain versions for those), a wrong dtype,
    a wrong shape and non-contiguous draws; nothing launches."""
    env, p, st, actions = _small(env_id)
    kernel = env.kernel
    draws = _draws(env, 8)
    ck.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ck.classic_step_kernel(kernel, st, actions, p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ck.classic_vector_kernel(kernel, st, actions, p, draws)
    with pytest.raises(TypeError, match="dtype"):
        ck.classic_step_kernel(kernel, st, actions.long(), p)
    with pytest.raises(TypeError, match="dtype"):
        ck.classic_step_kernel(kernel, dataclasses.replace(st, t=st.t.long()), actions, p)
    with pytest.raises(ValueError, match="shape"):
        ck.classic_vector_kernel(kernel, st, actions, p, torch.zeros((9, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        ck.classic_vector_kernel(kernel, st, actions, p, torch.zeros((draws.numel(), 8))[:, 0]
                                 if draws.dim() == 1 else torch.zeros((4, 8)).t())
    assert not any(ck.launches.values()) and not any(ck.plain_calls.values())


def _on_cuda(st):
    """A stand-in for a state on the card: its ``t`` says cuda."""
    return types.SimpleNamespace(t=types.SimpleNamespace(device=torch.device("cuda")))


@pytest.mark.parametrize("env_id", list(ENVS))
def test_vector_step_fuses_without_a_pool_on_the_card(env_id):
    """A classic env fuses its vector step on CUDA tensors without a pool
    (``TimeFractionObs`` forwarding it, a wrapper of a wrapper not), and
    not with a pool or on CPU tensors; the lander the other way round."""
    from deep_q_learning_tpu_torch.envs import LunarLander

    env, p, st, _ = _small(env_id)
    pool = env.reset_env(None, 8, p, _draws(env, 8))
    card = _on_cuda(st)
    assert env.fuses_vector_step(p, card, None)
    assert TimeFractionObs(env).fuses_vector_step(p, card, None)
    assert not TimeFractionObs(TimeFractionObs(env)).fuses_vector_step(p, card, None)
    assert not env.fuses_vector_step(p, card, pool)
    assert not env.fuses_vector_step(p, st, None)
    lander = LunarLander()
    lp = dataclasses.replace(lander.default_params(), jointed=False)
    lander_card = types.SimpleNamespace(x=types.SimpleNamespace(device=torch.device("cuda")))
    assert not lander.fuses_vector_step(lp, lander_card, None)
    assert lander.fuses_vector_step(lp, lander_card, pool)


class _Fused(CartPole):
    """CartPole that fuses its vector step everywhere and records the call,
    answering with the plain composition."""

    def __init__(self):
        self.calls = []

    def fuses_vector_step(self, params, state, fresh):
        return fresh is None

    def vector_step(self, generator, state, action, params, fresh, draws=None, reset_draws=None,
                    time_feature=False):
        self.calls.append((draws, reset_draws, time_feature))
        venv = VectorEnv(CartPole(), action.shape[0], graphed=False)
        out_obs, out_st, tr = venv._step(None, state, action, params, torch.zeros(0), None, draws,
                                         reset_draws)
        return out_obs, out_st, tr.next_obs, tr.reward, tr.terminated, tr.truncated


def test_fused_vector_step_keeps_the_eager_draws():
    """``VectorEnv._step`` without a pool and without draws takes the reset's
    draw from the generator before the fused call, as the plain
    composition's ``reset_batch`` draws it: the same numbers and the
    generator left where the plain composition leaves it; injected draws
    pass through; a pool takes the plain composition."""
    env, p, st, actions = _small("CartPole-v1", n=8, seed=3)
    obs = env.get_obs(st, p)
    fused = _Fused()
    outs = {}
    for name, e in (("fused", fused), ("plain", CartPole())):
        g = torch.Generator().manual_seed(5)
        outs[name] = VectorEnv(e, 8, graphed=False)._step(g, st, actions, p, obs, None)
        outs[name] += (torch.rand(3, generator=g),)
    (draws, reset_draws, feature), = fused.calls
    assert draws is None and not feature
    assert torch.equal(reset_draws, CartPole().reset_draws(torch.Generator().manual_seed(5), 8))
    assert torch.equal(outs["fused"][-1], outs["plain"][-1])
    assert torch.equal(outs["fused"][0], outs["plain"][0])
    given = env.reset_draws(torch.Generator().manual_seed(6), 8)
    VectorEnv(TimeFractionObs(fused), 8, graphed=False)._step(None, st, actions, p,
                                                              obs, None, None, given)
    assert fused.calls[-1][1] is given and fused.calls[-1][2]
    VectorEnv(fused, 8, graphed=False)._step(None, st, actions, p, obs, (obs, st), None)
    assert len(fused.calls) == 2


# ------------------------------------------------------------------- work
_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "sin", "cos", "abs", "clamp", "remainder",
          "pow"}


class _CountArithmetic(TorchDispatchMode):
    """Float arithmetic of the plain version, one operation an element of an
    elementwise op's output."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and func.overloadpacket.__name__ in _ARITH):
            self.ops += out.numel()
        return out


def _count(fn):
    count = _CountArithmetic()
    with count:
        out = fn()
    return count.ops, out


def _size(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("env_id", list(ENVS))
def test_work_counts_what_the_code_does(env_id):
    """``classic_step_work``: the bytes of a call's inputs read and outputs
    written, and the plain version's float arithmetic, for a step and for
    the vector step without a pool, the time feature off and on."""
    env, p, st, actions = _small(env_id, n=7, seed=4)
    st = type(st)(**{f.name: getattr(st, f.name).contiguous() for f in dataclasses.fields(st)})
    ops, out = _count(lambda: env.step_env_reference(None, st, actions, p))
    nbytes, work_ops = ck.classic_step_work(env.kernel, 7)
    assert work_ops == ops
    assert nbytes == _size(tree_leaves([st, actions])) + _size(tree_leaves(list(out)))
    draws = _draws(env, 7, seed=5)
    for feature in (False, True):
        port_env = TimeFractionObs(env) if feature else env
        venv = VectorEnv(port_env, 7, graphed=False)
        prev = torch.zeros((7, env.obs_shape(p)[0] + feature))
        ops, (out_obs, out_st, tr) = _count(
            lambda: venv._step(None, st, actions, p, prev, None, None, draws))
        nbytes, work_ops = ck.classic_step_work(env.kernel, 7, vector=True, time_feature=feature)
        assert work_ops == ops, feature
        written = tree_leaves([out_obs, out_st, tr.next_obs, tr.reward, tr.terminated,
                               tr.truncated])
        assert nbytes == _size(tree_leaves([st, actions, draws])) + _size(written), feature
