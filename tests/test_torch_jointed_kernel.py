"""J1's per-env body (``deep_q_learning_tpu_torch/csrc/lander_jointed.cuh``,
S1's ``lander_solver.cuh`` inside it) on the CPU: built by g++ (``-O2
-ffp-contract=off``, no fast math) through ``ops/build.py::cached_build`` into
a host library that runs every env's group of lanes in turn, and held against
the JAX jointed ``step_env`` and ``reset`` (vmapped) and the port's plain
versions (``LunarLander.step_env_reference`` and ``reset_env_reference``).

The states are ``tests/test_torch_lander_solver.py``'s JAX rollouts (flight,
touchdowns on one leg and on both, joint limits, hull hits, the settle
harness's lander asleep and coming to rest), and, for what those rollouts do
not reach, rollout states moved to it, the whole assembly rigidly: to the
screen's edges moving out, and to the episode's limit (the step runs with a
limit of MAX_STEPS frames).  Each step's actions are random and its
dispersion draws are the ones JAX's step takes from its key.

Against JAX the solver's gates (tests/test_torch_lander_solver.py): the
tight tolerances on at least 99 % of the lanes (observations 1e-5, positions
and angles 1e-5, velocities 1e-4, rewards and potentials 1e-4 plus 2 float32
ulps of their magnitude, accumulators 1e-5 + rtol 1e-4), and every lane
within 4x that field's float32 conditioning gap (JAX's float32 step against
the same JAX code in float64, measured here) plus the tight atol; the leg
contacts, the joints' limit states, t, the wind indices and the flags
exact; the sleep counter may differ only on lanes whose JAX speed lies
within the velocity tolerance of a sleep threshold, and on at most 1 % of
the lanes.  The reset frame at the jointed reset's tolerances of
tests/test_torch_envs_lunar.py (observations 1e-5, potentials 1e-4, bodies
1e-4, accumulators 1e-5 + rtol 1e-4, limit states exact).

Against the plain version every bit of every output on every lane: the host
build calls the C library's sinf, cosf, tanhf and sqrtf where PyTorch's CPU
kernels compute their own (they differ in the last ulp on some inputs, sqrt's
too), so the plain version runs with ``torch.sin``, ``torch.cos``,
``torch.tanh`` and ``torch.sqrt`` replaced by the C library's.  The host
build runs the kernel's lane groups, and with ``others`` every group runs
every pass its warp's loops would make it run, as on the card; on the card
J1 calls sincosf, sinf, tanhf and sqrtf, which are PyTorch's there
(chip_smoke.py holds J1 and the plain version bit for bit).
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

from deep_q_learning_tpu.envs.lunar_lander import LunarLander as JaxLander
from deep_q_learning_tpu_torch.envs import LunarLander
from deep_q_learning_tpu_torch.envs import lander_solver as ls
from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
from deep_q_learning_tpu_torch.envs.heuristic import jointed_cover
from deep_q_learning_tpu_torch.envs.lunar_lander import (
    LunarLanderParams,
    ResetDraws,
    smoothed_terrain,
    state_from_numpy,
)
from deep_q_learning_tpu_torch.ops import build
from deep_q_learning_tpu_torch.ops import jointed_kernels as jk
from test_torch_envs_lunar import _reset_draws
from test_torch_rigid_kernel import _LibmMath
from test_torch_lander_solver import (  # noqa: F401  (the rollout fixture)
    ACC,
    ACC_TOL,
    BODY,
    CONDITIONING,
    POS,
    POS_TOL,
    TIGHT_SHARE,
    VEL,
    VEL_TOL,
    _jax_params,
    rollout_states,
)

CXX_FLAGS = ("-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-Wall", "-Wno-unknown-pragmas")
MAX_STEPS = 300  # the step's episode limit, past the rollouts' 200 frames
EDGES = 16  # states moved to each edge the rollouts do not reach
OBS_TOL, REWARD_TOL, REWARD_RTOL = 1e-5, 1e-4, 2.5e-7
RAGGED = (1, 3, 33, 128)  # a group of lanes, a part-full warp, a warp and a group, a block's


@pytest.fixture(scope="module")
def host():
    source = build.CSRC_DIR / "lander_jointed.cuh"

    def compile_to(out: Path) -> None:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(out), str(source)], check=True,
                       capture_output=True, text=True)

    lib = ctypes.CDLL(str(build.cached_build(source, CXX_FLAGS, build.BUILD_DIR, compile_to)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lander_jointed_host.argtypes = [ptr, ptr, i32, i32]
    lib.lander_math_host.argtypes = [ptr, ptr, i32, i32]
    lib.lander_jointed_sizes.argtypes = [ptr]
    jk.check_sizes(lib)
    return lib


def _host_launch(lib, others=False):
    def launch(io, consts, n):
        lib.lander_jointed_host(ctypes.byref(io), ctypes.byref(consts), n, int(others))
    return launch


def _params(wind, **kw):
    return LunarLanderParams(vel_iters=VEL, pos_iters=POS, enable_wind=wind, **kw)


def _bitwise_lanes(got, want):
    """Per lane: every bit of every output equal, dtypes and shapes too."""
    a, b = tree_leaves(list(got)), tree_leaves(list(want))
    assert len(a) == len(b)
    same = torch.ones(a[0].shape[0], dtype=torch.bool)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        same &= (x == y).reshape(x.shape[0], -1).all(1)
    return same


def _edge_states(states, rng):
    """``EDGES`` rollout states moved to each edge the rollouts miss, the
    hull and both legs together: past the screen's right and left edges
    next frame, and one frame before the episode's limit."""
    n = len(states.x)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    take = lambda idx: jax.tree.map(lambda a: a[idx], states)  # noqa: E731
    edge = take(rng.choice(n, EDGES))
    half = np.arange(EDGES) < EDGES // 2
    dx = f32(np.where(half, 19.99, 0.01) - edge.x)
    vx = f32(np.where(half, 2.0, -2.0))

    def move(b):
        return b._replace(cx=f32(b.cx + dx), vx=vx)

    edge = edge.replace(x=f32(edge.x + dx), vx=vx, leg1_body=move(edge.leg1_body),
                        leg2_body=move(edge.leg2_body))
    limit = take(rng.choice(n, EDGES))
    limit = limit.replace(t=np.full(EDGES, MAX_STEPS - 1, np.int32))
    return jax.tree.map(lambda *a: np.concatenate(a), edge, limit)


@pytest.fixture(scope="module")
def step_states(rollout_states):  # noqa: F811
    """(numpy states, keys, actions, dispersion draws): the rollout lanes and
    the edge states, random actions, and the draws JAX's step takes from
    each lane's key."""
    rng = np.random.default_rng(21)
    states = jax.tree.map(lambda a, b: np.concatenate([a, b]), rollout_states,
                          _edge_states(rollout_states, rng))
    n = len(states.x)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(2024), n))
    actions = rng.integers(0, 4, n).astype(np.int32)
    draws = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0))(
        keys))
    return states, keys, actions, draws


def _jax_step(states, keys, actions, wind):
    p = _jax_params(enable_wind=wind).replace(max_steps_in_episode=MAX_STEPS)
    out = jax.jit(jax.vmap(JaxLander().step, (0, 0, 0, None)))(keys, states, actions, p)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_steps(step_states):
    """Per wind setting: JAX's float32 step and, per field, its float32
    conditioning gap (the largest over the lanes against the same JAX code
    in float64)."""
    states, keys, actions, _ = step_states
    out = {}
    for wind in (False, True):
        ref = _jax_step(states, keys, actions, wind)
        with jax.enable_x64(True):
            wide = jax.tree.map(lambda x: x.astype(np.float64) if x.dtype == np.float32 else x,
                                states)
            ref64 = _jax_step(wide, keys, actions, wind)
        n = len(states.x)
        out[wind] = ref, ref64, {name: float(np.abs(a - b).max()) for (name, _, a), (_, _, b)
                                 in zip(_step_fields(ref, n), _step_fields(ref64, n))}
    return out


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step_fields(out, n):
    """(name, (atol, rtol), float64 (n, k) values) of every float output of
    a step: JAX's tuple or the port's."""
    obs, st, reward = out[0], out[1], out[2]

    def col(x):
        return np.asarray(_as_np(x), np.float64).reshape(n, -1)

    yield "obs", (OBS_TOL, 0.0), col(obs)[:, :8]
    yield "reward", (REWARD_TOL, REWARD_RTOL), col(reward)
    yield "prev_shaping", (REWARD_TOL, REWARD_RTOL), col(st.prev_shaping)
    for f in ("x", "y", "angle"):
        yield f, (POS_TOL, 0.0), col(getattr(st, f))
    for f in ("vx", "vy", "omega"):
        yield f, (VEL_TOL, 0.0), col(getattr(st, f))
    for leg in ("leg1_body", "leg2_body"):
        for f in BODY:
            tol = VEL_TOL if f in ("vx", "vy", "w") else POS_TOL
            yield f"{leg}.{f}", (tol, 0.0), col(getattr(getattr(st, leg), f))
    for f in ("j1", "j2", "c1", "c2"):
        yield f, ACC_TOL, col(getattr(st.solver_acc, f))


def _check_vs_jax(got, ref, conditioning, n):
    """The module docstring's gates; returns the lanes past the tight
    tolerances and the largest gaps."""
    tight_bad = np.zeros(n, bool)
    gaps = {}
    for (name, (atol, rtol), g), (_, _, w) in zip(_step_fields(got, n), _step_fields(ref, n)):
        gap = np.abs(g - w)
        tight_bad |= (gap > atol + rtol * np.abs(w)).any(1)
        gaps[name] = float(gap.max())
        bound = CONDITIONING * conditioning[name] + atol + rtol * np.abs(w).max(1)
        far = gap.max(1) > bound
        assert not far.any(), (name, np.flatnonzero(far)[:5], gaps[name], conditioning[name])
    assert tight_bad.mean() <= 1 - TIGHT_SHARE, (int(tight_bad.sum()), n, gaps)
    st, st_j = got[1], ref[1]
    for i, name in ((3, "terminated"), (4, "truncated")):
        np.testing.assert_array_equal(_as_np(got[i]), np.asarray(ref[i]), err_msg=name)
    for f in ("leg1", "leg2", "t", "wind_idx", "torque_idx"):
        np.testing.assert_array_equal(_as_np(getattr(st, f)), getattr(st_j, f), err_msg=f)
    for f in ("s1", "s2"):
        np.testing.assert_array_equal(_as_np(getattr(st.solver_acc, f)),
                                      getattr(st_j.solver_acc, f), err_msg=f)
    # the sleep counter, from the end-of-step speeds: only near a threshold
    near = np.zeros(n, bool)
    for vx, vy, w in ((st_j.vx, st_j.vy, st_j.omega),
                      *((b.vx, b.vy, b.w) for b in (st_j.leg1_body, st_j.leg2_body))):
        near |= (np.abs(np.hypot(vx, vy) - ls.LIN_SLEEP_TOL) < VEL_TOL) | (
            np.abs(np.abs(w) - ls.ANG_SLEEP_TOL) < VEL_TOL)
    flipped = _as_np(st.sleep) != st_j.sleep
    assert not (flipped & ~near).any() and flipped.mean() <= 0.01, (flipped.sum(), near.sum())
    return int(tight_bad.sum()), gaps


def _port_inputs(step_states, lanes=None):
    states, _, actions, draws = step_states
    if lanes is not None:
        states = jax.tree.map(lambda a: a[lanes], states)
        actions, draws = actions[lanes], draws[lanes]
    return state_from_numpy(states), torch.tensor(actions), torch.tensor(draws)


def _lanes(n_all, n):
    """``n`` of the lanes, drawn with a fixed seed."""
    return np.sort(np.random.default_rng(n).choice(n_all, n, replace=False))


# ------------------------------------------------------------------ a step
@pytest.mark.parametrize("wind", [False, True], ids=["calm", "wind"])
def test_host_step_matches_jax_and_is_the_plain_version(host, step_states, jax_steps, wind):
    """Every lane: the host build within the solver's gates of JAX's
    jointed step, and bitwise the plain version with the C library's math,
    each group alone and with the others' passes."""
    state, actions, draws = _port_inputs(step_states)
    n = state.x.shape[0]
    env, p = LunarLander(), _params(wind, max_steps_in_episode=MAX_STEPS)
    with _LibmMath(host):
        cover = {k: int(v.sum()) for k, v in jointed_cover(env, p, state, actions, draws).items()}
        want = env.step_env_reference(None, state, actions, p, draws)
    assert all(v > 0 for v in cover.values()), cover
    for others in (False, True):
        got = jk.jointed_call(_host_launch(host, others), p, state=state, action=actions,
                              draws=draws)
        same = _bitwise_lanes(got, want)
        assert bool(same.all()), (others, int((~same).sum()), torch.nonzero(~same)[:10].flatten())
    ref, _, conditioning = jax_steps[wind]
    tight, gaps = _check_vs_jax(got, ref, conditioning, n)
    # with the wind off the step keeps the indices it was given, as the plain version
    assert (got[1].wind_idx is state.wind_idx) == (want[1].wind_idx is state.wind_idx) == (
        not wind)
    assert got[1].terrain is state.terrain
    print(f"wind {wind}: {n} lanes cover {cover}; vs JAX {tight} lanes past the tight "
          f"tolerances, largest gaps {gaps}, float32 conditioning {conditioning}")


@pytest.mark.parametrize("n", RAGGED)
def test_host_step_at_ragged_counts(host, step_states, n):
    """Ragged counts of envs, the wind on, each group alone and with the
    others' passes: bitwise the plain version."""
    lanes = _lanes(len(step_states[0].x), n)
    state, actions, draws = _port_inputs(step_states, lanes)
    env, p = LunarLander(), _params(True, max_steps_in_episode=MAX_STEPS)
    with _LibmMath(host):
        want = env.step_env_reference(None, state, actions, p, draws)
    for others in (False, True):
        got = jk.jointed_call(_host_launch(host, others), p, state=state, action=actions,
                              draws=draws)
        assert bool(_bitwise_lanes(got, want).all()), (n, others)


def test_host_step_with_vel_tol_and_gym_passes(host, step_states):
    """The velocity loop's early exit (vel_tol > 0) and gym's (180, 60)
    passes, on 256 lanes: bitwise the plain version, with the position
    passes each env ran reported in range."""
    lanes = _lanes(len(step_states[0].x), 256)
    state, actions, draws = _port_inputs(step_states, lanes)
    env = LunarLander()
    for p in (dataclasses.replace(_params(False), vel_tol=1e-4),
              LunarLanderParams(vel_iters=180, pos_iters=60)):
        with _LibmMath(host):
            want = env.step_env_reference(None, state, actions, p, draws)
        got = jk.jointed_call(_host_launch(host, True), p, state=state, action=actions,
                              draws=draws, return_pos_iters=True)
        assert bool(_bitwise_lanes(got[:5], want).all()), p
        ran = got[5]
        assert ran.dtype == torch.int32 and bool(((ran >= 1) & (ran <= p.pos_iters)).all())


# ------------------------------------------------------------ the reset frame
@pytest.mark.parametrize("wind", [False, True], ids=["calm", "wind"])
@pytest.mark.parametrize("random_terrain", [True, False], ids=["random", "flat"])
def test_host_reset_frame_matches_jax_and_is_the_plain_version(host, wind, random_terrain):
    env_j = JaxLander()
    p_j = _jax_params(enable_wind=wind, random_terrain=random_terrain)
    env, p = LunarLander(), _params(wind, random_terrain=random_terrain)
    keys = jax.random.split(jax.random.PRNGKey(31), 256)
    obs_j, st_j = jax.tree.map(np.asarray, jax.jit(jax.vmap(env_j.reset, (0, None)))(keys, p_j))
    terrain, kick, wind_draws = (np.asarray(x) for x in jax.vmap(_reset_draws)(keys))
    draws = ResetDraws(terrain=torch.tensor(terrain), kick=torch.tensor(kick),
                       wind=torch.from_numpy(wind_draws.astype(np.int32)))
    for others in (False, True):
        got = jk.jointed_call(_host_launch(host, others), p, terrain=smoothed_terrain(
            draws.terrain, p), kick=draws.kick, wind=draws.wind)
        with _LibmMath(host):
            want = env.reset_env_reference(None, len(keys), p, draws)
        assert bool(_bitwise_lanes(got, want).all()), others
    obs, st = got
    np.testing.assert_allclose(obs.numpy(), obs_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.prev_shaping.numpy(), st_j.prev_shaping, atol=1e-4, rtol=0)
    for leg in ("leg1_body", "leg2_body"):
        for f in BODY:
            np.testing.assert_allclose(getattr(getattr(st, leg), f).numpy(),
                                       getattr(getattr(st_j, leg), f), atol=1e-4, rtol=0)
    for f in ("j1", "j2", "c1", "c2"):
        np.testing.assert_allclose(getattr(st.solver_acc, f).numpy(),
                                   getattr(st_j.solver_acc, f), atol=1e-5, rtol=1e-4)
    for f in ("s1", "s2"):
        np.testing.assert_array_equal(getattr(st.solver_acc, f).numpy(),
                                      getattr(st_j.solver_acc, f), err_msg=f)
    for f in ("t", "sleep", "wind_idx", "torque_idx", "leg1", "leg2"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(st_j, f), err_msg=f)


# ---------------------------------------------------------- the dispatcher
def test_step_and_reset_on_cpu_tensors_are_the_plain_version(step_states):
    """On CPU tensors ``step_env`` and ``reset_env`` take the plain version,
    counted in ``plain_calls``; nothing launches."""
    lanes = _lanes(len(step_states[0].x), 16)
    state, actions, draws = _port_inputs(step_states, lanes)
    env, p = LunarLander(), _params(False)
    jk.reset_counts()
    got = env.step_env(None, state, actions, p, draws)
    want = env.step_env_reference(None, state, actions, p, draws)
    assert bool(_bitwise_lanes(got, want).all())
    g = torch.Generator().manual_seed(4)
    env.reset_env(g, 8, p)
    assert jk.plain_calls == {"jointed_step": 2} and jk.launches == {"jointed_step": 0}
    # the rigid engine counts no jointed call
    env.reset_env(g, 2, dataclasses.replace(p, jointed=False))
    assert jk.plain_calls == {"jointed_step": 2}


def test_wrappers_check_their_inputs(step_states):
    """The kernel's wrappers refuse CPU tensors (``step_env`` takes the
    plain version for those), a wrong dtype, a non-contiguous input, a wrong
    shape, a rigid state and the rigid engine; nothing launches."""
    lanes = _lanes(len(step_states[0].x), 4)
    st, a, d = _port_inputs(step_states, lanes)
    p = _params(False)
    rd = ResetDraws(terrain=torch.zeros((4, 12)), kick=torch.zeros((4, 2)),
                    wind=torch.zeros((4, 2), dtype=torch.int32))
    jk.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        jk.jointed_step_kernel(st, a, p, d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        jk.jointed_reset_kernel(st.terrain, rd, p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        jk.position_passes(p, st, a, d)
    with pytest.raises(TypeError, match="dtype"):
        jk.jointed_step_kernel(st, a.long(), p, d)
    acc = dataclasses.replace(st.solver_acc, s1=st.solver_acc.s1.long())
    with pytest.raises(TypeError, match="dtype"):
        jk.jointed_step_kernel(dataclasses.replace(st, solver_acc=acc), a, p, d)
    leg = dataclasses.replace(st.leg1_body, vx=st.leg1_body.vx.double())
    with pytest.raises(TypeError, match="dtype"):
        jk.jointed_step_kernel(dataclasses.replace(st, leg1_body=leg), a, p, d)
    with pytest.raises(ValueError, match="contiguous"):
        jk.jointed_step_kernel(st, a, p, torch.zeros((2, 4)).t())
    with pytest.raises(ValueError, match="shape"):
        jk.jointed_step_kernel(st, a, p, torch.zeros((5, 2)))
    with pytest.raises(ValueError, match="shape"):
        jk.jointed_reset_kernel(st.terrain, dataclasses.replace(rd, kick=torch.zeros((4, 3))), p)
    with pytest.raises(ValueError, match="is None"):
        jk.jointed_step_kernel(dataclasses.replace(st, solver_acc=None), a, p, d)
    with pytest.raises(ValueError, match="rigid"):
        jk.jointed_step_kernel(st, a, dataclasses.replace(p, jointed=False), d)
    assert jk.launches == {"jointed_step": 0} and jk.plain_calls == {"jointed_step": 0}


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


@pytest.mark.parametrize("wind", [False, True], ids=["calm", "wind"])
def test_work_counts_what_the_code_does(wind):
    """``jointed_step_work``: the bytes of a call's inputs read and outputs
    written, and the plain version's arithmetic (S1's count for the solve)
    less its second evaluation of the observation (inside ``_shaping``; the
    kernel computes it once), for a step and for the reset frame (less the
    terrain's smoothing, which stays plain ops), at a few passes."""
    env = LunarLander()
    p = LunarLanderParams(vel_iters=3, pos_iters=2, enable_wind=wind)
    n = 7
    g = torch.Generator().manual_seed(9)
    _, st = env.reset_env(g, n, p)
    actions = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32)
    draws = env.step_draws(g, n)
    ops, out = _count(lambda: env.step_env_reference(None, st, actions, p, draws))
    obs_ops, _ = _count(lambda: env.get_obs(out[1], p))
    nbytes, work_ops = jk.jointed_step_work(n, p.vel_iters, p.pos_iters, wind)
    assert work_ops == ops - obs_ops
    skipped = () if wind else ("wind_idx", "torque_idx")
    read = [t for f in dataclasses.fields(st) if f.name not in skipped
            for t in tree_leaves(getattr(st, f.name))] + [actions, draws]
    inputs = {id(t) for t in tree_leaves(st)}
    written = [t for t in tree_leaves(list(out)) if id(t) not in inputs]
    assert nbytes == _size(read) + _size(written)

    rd = env.reset_draws(g, n)
    ops, (obs, fresh) = _count(lambda: env.reset_env_reference(None, n, p, rd))
    smooth_ops, _ = _count(lambda: smoothed_terrain(rd.terrain, p))
    nbytes, work_ops = jk.jointed_step_work(n, p.vel_iters, p.pos_iters, wind, reset=True)
    assert work_ops == ops - smooth_ops - obs_ops
    written = [t for t in tree_leaves([obs, fresh]) if t is not fresh.terrain]
    assert nbytes == _size([fresh.terrain, rd.kick, rd.wind]) + _size(written)


def test_work_takes_the_passes_each_env_ran(step_states, host):
    """With per-env position passes (what ``position_passes`` reports), the
    work counts S1's operations for those passes."""
    lanes = _lanes(len(step_states[0].x), 32)
    state, actions, draws = _port_inputs(step_states, lanes)
    p = _params(False)
    ran = jk.jointed_call(_host_launch(host), p, state=state, action=actions, draws=draws,
                          return_pos_iters=True)[-1]
    full = jk.jointed_step_work(32, VEL, POS)
    taken = jk.jointed_step_work(32, VEL, ran)
    assert taken[0] == full[0]
    assert full[1] - taken[1] == int((POS - ran).sum()) * jk.sk.POS_PASS_OPS
    assert bool((ran < POS).any()), ran
