"""A1, C1 and M1, the classic-control envs' steps: the CUDA kernels
(``csrc/classic_envs.cu``, their bodies ``csrc/classic_envs.cuh``) and their
plain PyTorch versions (``envs/acrobot.py::Acrobot.step_env_reference``,
``envs/cartpole.py::CartPole.step_env_reference`` and
``envs/mountain_car.py::MountainCar.step_env_reference``; for the vector
step ``envs/base.py::VectorEnv._step``'s composition of the step,
``reset_env`` from the reset's draws, the auto-reset's ``tree_where`` and
``TimeFractionObs._augment``).

Not TPU kernels: the JAX package writes each env's step as scalar code for
one env (``deep_q_learning_tpu/envs/acrobot.py::step_env``,
``cartpole.py::step_env``, ``mountain_car.py::step_env``), and ``jax.vmap``
with XLA fuses it, the per-frame reset and the selects into the jitted
superstep.  The plain version runs the same arithmetic one elementwise
kernel at a time; each kernel runs an env's vector step in one launch, one
thread an env, and agrees with the plain version bit for bit: every value
comes from the same operations on the same operands (see the source).

:func:`classic_step_kernel` (``step_env``: observation, state, reward and
flags) and :func:`classic_vector_kernel` (``VectorEnv._step`` without a
pool: the step, ``done``, the reset from its draws, the selects of every
state field and of the observation, and the time feature) launch an env's
kernel on CUDA tensors, or raise; the envs call them for CUDA tensors and
run the plain versions on CPU tensors.  An env is named by its key of
:data:`SPECS` (``"acrobot"``, ``"cartpole"``, ``"mountain_car"``).
``launches`` counts kernel launches, ``plain_calls`` calls that took the
plain version, by env.  :func:`classic_step_work` gives the bytes and
operations of a call, of which ``ops.bound_us`` makes the bound.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.ops.build import load_library
from deep_q_learning_tpu_torch.ops.lander_kernels import Div, card_div
from deep_q_learning_tpu_torch.ops.td_kernels import _check, _device_kind, _launch

launches = {"acrobot": 0, "cartpole": 0, "mountain_car": 0}
plain_calls = {"acrobot": 0, "cartpole": 0, "mountain_car": 0}

# threads a block, by env: a warp, so that a small N spreads over SMs
THREADS = {"acrobot": 32, "cartpole": 32, "mountain_car": 32}
MAX_FIELDS = 4  # classic_envs.cuh::kMaxFields


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def _acrobot_consts(params) -> dict:
    from deep_q_learning_tpu_torch.envs import acrobot as ac

    # each as envs/acrobot.py writes it: Python folds it in double
    return dict(
        m1_lc1_sq=ac.M1 * ac.LC1**2, m2=ac.M2, l1_sq_lc2_sq=ac.L1**2 + ac.LC2**2,
        two_l1_lc2=2 * ac.L1 * ac.LC2, i1=ac.I1, i2=ac.I2,
        lc2_sq=ac.LC2**2, l1_lc2=ac.L1 * ac.LC2,
        m2_lc2_g=ac.M2 * ac.LC2 * ac.G, half_pi=math.pi / 2.0,
        neg_m2_l1_lc2=-ac.M2 * ac.L1 * ac.LC2, two_m2_l1_lc2=2 * ac.M2 * ac.L1 * ac.LC2,
        phi1_g=(ac.M1 * ac.LC1 + ac.M2 * ac.L1) * ac.G,
        m2_l1_lc2=ac.M2 * ac.L1 * ac.LC2, m2_lc2_sq_i2=ac.M2 * ac.LC2**2 + ac.I2,
        half_dt=ac.DT / 2, dt=ac.DT, sixth_dt=ac.DT / 6.0, two=2.0,
        low=-math.pi, span=math.pi - (-math.pi),
        max_vel1=ac.MAX_VEL_1, max_vel2=ac.MAX_VEL_2, goal=1.0,
        max_steps=int(params.max_steps_in_episode),
    )


def _cartpole_consts(p) -> dict:
    return dict(
        force_mag=p.force_mag, neg_force_mag=-p.force_mag,
        polemass_length=p.masspole * p.length, total_mass=p.masscart + p.masspole,
        gravity=p.gravity, masspole=p.masspole, length=p.length, four_thirds=4.0 / 3.0,
        tau=p.tau, x_threshold=p.x_threshold, theta_threshold=p.theta_threshold,
        max_steps=int(p.max_steps_in_episode),
    )


def _mountain_car_consts(p) -> dict:
    return dict(
        force=p.force, three=3.0, neg_gravity=-p.gravity, max_speed=p.max_speed,
        min_position=p.min_position, max_position=p.max_position, goal=p.goal_position,
        max_steps=int(p.max_steps_in_episode),
    )


# float32 operations an env of the plain versions (sin, cos, a division
# and a remainder count one each; selects, compares, casts and integer
# arithmetic none): the step; what the vector step's reset adds (get_obs of
# the fresh state); the time feature's division, once for the step's
# observation and once for the reset's.  tests/test_torch_classic_kernel.py
# holds these to a count of the plain versions' arithmetic
STEP_OPS = {"acrobot": 257, "cartpole": 30, "mountain_car": 9}
RESET_OPS = {"acrobot": 4, "cartpole": 0, "mountain_car": 0}
FEATURE_OPS = 2


@dataclasses.dataclass(frozen=True)
class Spec:
    index: int  # the host build's env number
    env_id: str
    fields: Tuple[str, ...]  # the float state fields, in the body's order
    obs: int  # observation width
    draws: int  # reset draws an env (MountainCar's are (N,))
    consts: Callable  # params -> the step's constants


SPECS = {
    "acrobot": Spec(0, "Acrobot-v1", ("theta1", "theta2", "dtheta1", "dtheta2"), 6, 4, _acrobot_consts),
    "cartpole": Spec(1, "CartPole-v1", ("x", "x_dot", "theta", "theta_dot"), 4, 4, _cartpole_consts),
    "mountain_car": Spec(2, "MountainCar-v0", ("position", "velocity"), 2, 1,
                         _mountain_car_consts),
}
DIVS = ("total_mass",)
INTS = ("max_steps",)


def classic_step_work(env: str, n: int, vector: bool = False,
                      time_feature: bool = False) -> Tuple[int, int]:
    """``(bytes, operations)`` of a call on ``n`` envs: every input read
    once and every output written once, and the plain version's float32
    operations.  A step reads the state, t and the action and writes the
    observation, the state, t, the reward and two one-byte flags; the
    vector step (``vector``) reads the reset's draws besides and writes the
    observation before the reset and after it, each with the time feature
    where asked."""
    spec = SPECS[env]
    fields, width = len(spec.fields), spec.obs + int(vector and time_feature)
    read = 4 * (fields + 2)
    written = 4 * (width + fields + 2) + 2
    if not vector:
        return n * (read + written), n * STEP_OPS[env]
    read += 4 * spec.draws
    written += 4 * width
    ops = STEP_OPS[env] + RESET_OPS[env] + (FEATURE_OPS if time_feature else 0)
    return n * (read + written), n * ops


# ---------------------------------------------------------------------------
# The C interface (classic_envs.cuh's structs, field for field)
# ---------------------------------------------------------------------------

_P, _F, _I, _L = ctypes.c_void_p, ctypes.c_float, ctypes.c_int32, ctypes.c_int64


class IO(ctypes.Structure):
    _fields_ = [
        ("state", _P * MAX_FIELDS), ("stride", _L * MAX_FIELDS), ("t", _P), ("t_stride", _L),
        ("action", _P), ("reset_draws", _P), ("next_obs", _P), ("out_obs", _P),
        ("state_out", _P * MAX_FIELDS), ("t_out", _P), ("reward", _P), ("terminated", _P),
        ("truncated", _P), ("time_div", Div), ("time_feature", _I),
    ]


@functools.cache
def consts_type(env: str):
    """The ctypes structure of ``env``'s ``Consts``, its fields in
    the order of its ``Spec.consts``."""
    from deep_q_learning_tpu_torch.envs import make_env

    _, params = make_env(SPECS[env].env_id)
    fields = [(name, Div if name in DIVS else (_I if name in INTS else _F))
              for name in SPECS[env].consts(params)]
    return type(f"{env}_consts", (ctypes.Structure,), {"_fields_": fields})


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def _consts_of(env: str, key: tuple) -> ctypes.Structure:
    k = consts_type(env)()
    for name, value in key:
        if name in DIVS:
            setattr(k, name, card_div(value))
        elif name in INTS:
            setattr(k, name, value)
        else:
            setattr(k, name, _f32(value))
    return k


def classic_consts(env: str, params) -> ctypes.Structure:
    """``env``'s ``Consts`` for ``params``: every float the float32 of the
    Python double the plain version meets (ctypes rounds once), a divisor
    with its reciprocal as PyTorch's CUDA division by a Python number takes
    it (``lander_kernels.card_div``: float32 of the double ``1 / c``; for
    CartPole's ``1.1`` that is not ``1.0f / float32(1.1)``)."""
    return _consts_of(env, tuple(SPECS[env].consts(params).items()))


def check_sizes(lib: ctypes.CDLL) -> None:
    """The library's ``sizeof`` of ``IO`` and of each env's ``Consts``
    equal these structures' (a field added on one side only fails here)."""
    sizes = (ctypes.c_int * 4)()
    lib.classic_envs_sizes(sizes)
    ours = (ctypes.sizeof(IO), *(ctypes.sizeof(consts_type(env)) for env in SPECS))
    if tuple(sizes) != ours:
        raise RuntimeError(f"classic_envs structs differ: library {tuple(sizes)}, Python {ours}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("classic_envs.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for env in SPECS:
        fn = getattr(lib, f"{env}_launch")
        fn.argtypes = [ptr, ptr, i32, i32, i32, ptr]
        fn.restype = i32
    lib.classic_envs_sizes.argtypes = [ptr]
    lib.classic_envs_sizes.restype = i32
    check_sizes(lib)
    return lib


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check_leaf(name: str, t: torch.Tensor, dtype, n: int, device) -> None:
    """Device, dtype and shape (n,) of a state field, which may be strided."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n,)}")


def _check_inputs(env: str, state, action, reset_draws=None) -> torch.device:
    spec = SPECS[env]
    device, n = action.device, action.shape[0]
    _check("action", action, torch.int32, (n,), device)
    for f in spec.fields:
        _check_leaf(f"state.{f}", getattr(state, f), torch.float32, n, device)
    _check_leaf("state.t", state.t, torch.int32, n, device)
    if reset_draws is not None:
        shape = (n, spec.draws) if spec.draws > 1 else (n,)
        _check("reset_draws", reset_draws, torch.float32, shape, device)
    return device


def classic_call(launch: Callable, env: str, params, state, action, reset_draws=None,
                 time_feature: bool = False):
    """The wrappers' body around ``launch(io, consts, n, vector)``, which
    runs an entry on the pointers of ``io``: the CUDA launcher on the card,
    the host build of ``classic_envs.cuh`` in the CPU tests.  A step
    (``reset_draws`` None) returns ``step_env``'s ``(obs, state, reward,
    terminated, truncated)``; the vector step ``VectorEnv._step``'s
    ``(out_obs, out_state)`` after the auto-reset from the reset's draws
    and its transition's ``next_obs`` (before the reset), ``reward``,
    ``terminated`` and ``truncated``, each observation ending in ``t /
    max_steps`` with ``time_feature``.  Allocates the outputs on the
    inputs' device; every state it returns holds new tensors."""
    spec = SPECS[env]
    device, n = action.device, action.shape[0]
    vector = reset_draws is not None
    width = spec.obs + int(vector and time_feature)

    def empty(dtype, *shape):
        return torch.empty((n, *shape), dtype=dtype, device=device)

    next_obs = empty(torch.float32, width)
    outs = [empty(torch.float32) for _ in spec.fields]
    t = empty(torch.int32)
    reward, terminated, truncated = empty(torch.float32), empty(torch.bool), empty(torch.bool)
    io = IO()
    for f, name in enumerate(spec.fields):
        leaf = getattr(state, name)
        io.state[f], io.stride[f] = leaf.data_ptr(), leaf.stride(0)
        io.state_out[f] = outs[f].data_ptr()
    io.t, io.t_stride = state.t.data_ptr(), state.t.stride(0)
    io.action, io.next_obs, io.t_out = action.data_ptr(), next_obs.data_ptr(), t.data_ptr()
    io.reward, io.terminated, io.truncated = (reward.data_ptr(), terminated.data_ptr(),
                                              truncated.data_ptr())
    steps = params.max_steps_in_episode
    io.time_div = card_div(steps)
    io.time_feature = int(vector and time_feature)
    out_obs = None
    if vector:
        out_obs = empty(torch.float32, width)
        io.reset_draws, io.out_obs = reset_draws.data_ptr(), out_obs.data_ptr()
    launch(io, classic_consts(env, params), n, int(vector))
    new_state = type(state)(**dict(zip(spec.fields, outs)), t=t)
    if vector:
        return out_obs, new_state, next_obs, reward, terminated, truncated
    return next_obs, new_state, reward, terminated, truncated


def _on_card(device: torch.device, env: str) -> Callable:
    """The launch of ``env``'s kernel on ``device``'s current stream, no
    sync (so a CUDA graph can capture it); raises for a device that is not
    CUDA."""
    if _device_kind(device) != "cuda":
        raise ValueError(f"the classic envs' kernels run on CUDA tensors, not on {device}; the "
                         f"plain version is envs/{env}.py's step_env_reference")
    fn = getattr(_lib(), f"{env}_launch")

    def launch(io, consts, n, vector):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _launch(fn, ctypes.byref(io), ctypes.byref(consts), n, vector, THREADS[env], stream)
    return launch


def classic_step_kernel(env: str, state, action: torch.Tensor, params):
    """``env``'s step on CUDA tensors (A1, C1 or M1's step entry):
    ``step_env``'s result; raises on tensors elsewhere."""
    device = _check_inputs(env, state, action)
    out = classic_call(_on_card(device, env), env, params, state, action)
    launches[env] += 1
    return out


def classic_vector_kernel(env: str, state, action: torch.Tensor, params,
                          reset_draws: torch.Tensor, time_feature: bool = False):
    """``env``'s vector step on CUDA tensors (the vector entry):
    ``VectorEnv._step`` without a pool, the resets from ``reset_draws``
    (``reset_draws``' draws), one launch; :func:`classic_call` says what it
    returns.  Raises on tensors elsewhere."""
    device = _check_inputs(env, state, action, reset_draws)
    out = classic_call(_on_card(device, env), env, params, state, action, reset_draws,
                       time_feature)
    launches[env] += 1
    return out
