"""R1, one frame of the rigid lander and the vector step around it: the
CUDA kernel (``csrc/lander_rigid.cu``, its body ``csrc/lander_rigid.cuh``)
and its plain PyTorch versions (``envs/lunar_lander.py::LunarLander.
step_env_reference`` and ``reset_env``'s physics frame; for the vector
step ``envs/base.py::VectorEnv._step``'s composition of the step, the
auto-reset's ``tree_where`` and ``TimeFractionObs._augment``).

Not a TPU kernel: the JAX package writes the rigid step as scalar code for
one env (``deep_q_learning_tpu/envs/lunar_lander.py::step_env`` with
``_physics_step``), and ``jax.vmap`` with XLA fuses it into the jitted
superstep.  The plain version runs the same arithmetic as ~700 elementwise
kernels a frame; the kernel runs the frame in one launch, one thread an
env, and agrees with the plain version bit for bit: every value comes from
the same operations on the same operands (see the source).

:func:`rigid_step_kernel` (a step: observation, state, reward and flags),
:func:`rigid_reset_kernel` (reset_env's frame with the kick, from the
smoothed terrain and the reset's draws) and :func:`rigid_vector_kernel`
(the vector step with a reset pool: the step, ``done``, the selects of
every state leaf and of the observation, and the time feature) launch the
kernel on CUDA tensors, or raise; ``envs/lunar_lander.py`` calls them for
CUDA tensors and runs the plain versions on CPU tensors.  ``launches``
counts kernel launches, ``plain_calls`` calls that took the plain
version, every entry alike.  :func:`rigid_step_work` gives the bytes and
operations of a call, of which ``ops.bound_us`` makes R1's bound.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.envs import lunar_lander as ll
from deep_q_learning_tpu_torch.envs.lander_solver import _f32_product
from deep_q_learning_tpu_torch.ops.build import load_library
from deep_q_learning_tpu_torch.ops.td_kernels import _check, _device_kind, _launch

launches = {"rigid_step": 0}
plain_calls = {"rigid_step": 0}

STATE_FIELDS = ("x", "y", "vx", "vy", "angle", "omega")

# bytes an env of a step: read 6 state floats, 2 one-byte leg flags, 11
# terrain heights, the shaping potential, t, sleep, the action and 2 draws
# (and the 2 wind indices with the wind on); write 8 observation floats, 6
# state floats, 2 flags, the potential, t, sleep, the reward and 2 flags
# (and the 2 indices).  The reset frame reads the terrain, the kick and the
# 2 wind draws, and writes the observation, the state, the potential, t,
# sleep and the 2 indices.
STEP_READ_BYTES = 4 * (6 + ll.CHUNKS + 1 + 2 + 1 + 2) + 2
STEP_WRITE_BYTES = 4 * (8 + 6 + 1 + 2 + 1) + 4
WIND_BYTES = 2 * 4 * 2
RESET_READ_BYTES = 4 * (ll.CHUNKS + 2 + 2)
RESET_WRITE_BYTES = 4 * (8 + 6 + 1 + 2 + 2) + 2
# bytes an env of the vector step: the step's reads with the wind indices
# always (the selects keep them), the pool's entry (6 state floats, 2
# flags, 11 terrain heights, the potential, t, sleep, 2 indices and 8
# observation floats); writes the pre-reset observation, the reward and 2
# flags, the observation after the reset and the state after it (6 floats,
# 2 flags, 11 heights, the potential, t, sleep, 2 indices).  The time
# feature adds a float to each observation read or written.
VECTOR_READ_BYTES = STEP_READ_BYTES + 4 * 2 + 4 * (6 + ll.CHUNKS + 1 + 2 + 2 + 8) + 2
VECTOR_WRITE_BYTES = 4 * 8 + 4 + 2 + 4 * 8 + 4 * (6 + ll.CHUNKS + 1 + 2 + 2) + 2
FEATURE_BYTES = 3 * 4
# float32 operations an env (sin, cos, tanh, sqrt and a division count one
# each; selects, compares and casts none): a step's dispersion, physics frame
# without the wind, observation, potential and reward; what the wind adds;
# the reset frame's (the kick, no dispersion, no reward).  The plain version
# computes the observation twice (get_obs, and again in _shaping; 10
# operations), the kernel once: tests/test_torch_rigid_kernel.py holds these
# to a count of the plain version's arithmetic less that repeat
STEP_OPS = 546
WIND_OPS = 20
RESET_OPS = 544
FEATURE_OPS = 1  # t / max_steps


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def rigid_step_work(n: int, enable_wind: bool = False, reset: bool = False,
                    vector: bool = False, time_feature: bool = False) -> Tuple[int, int]:
    """``(bytes, operations)`` of a call on ``n`` envs: every input read
    once and every output written once, and the plain version's float32
    operations (every env runs the same ones): a step, the reset frame, or
    (``vector``) the vector step with a reset pool, with or without the
    time feature."""
    wind_ops = WIND_OPS if enable_wind else 0
    if reset:
        return n * (RESET_READ_BYTES + RESET_WRITE_BYTES), n * (RESET_OPS + wind_ops)
    if vector:
        feature = FEATURE_BYTES if time_feature else 0
        return n * (VECTOR_READ_BYTES + VECTOR_WRITE_BYTES + feature), n * (
            STEP_OPS + wind_ops + (FEATURE_OPS if time_feature else 0))
    wind = WIND_BYTES if enable_wind else 0
    return n * (STEP_READ_BYTES + STEP_WRITE_BYTES + wind), n * (STEP_OPS + wind_ops)


# ---------------------------------------------------------------------------
# The C interface (lander_rigid.cuh's structs, field for field)
# ---------------------------------------------------------------------------

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int32


class Div(ctypes.Structure):
    _fields_ = [("c", _F), ("inv", _F)]


class IO(ctypes.Structure):
    _fields_ = [
        ("state", _P * 6), ("leg", _P * 2), ("terrain", _P), ("prev_shaping", _P), ("t", _P),
        ("sleep", _P), ("wind_idx", _P), ("torque_idx", _P), ("action", _P), ("draws", _P),
        ("kick", _P), ("wind_draws", _P), ("obs", _P), ("state_out", _P * 6),
        ("leg_out", _P * 2), ("shaping_out", _P), ("t_out", _P), ("sleep_out", _P),
        ("wind_out", _P), ("torque_out", _P), ("reward", _P), ("terminated", _P),
        ("truncated", _P),
    ]


class Pool(ctypes.Structure):
    _fields_ = [
        ("state", _P * 6), ("leg", _P * 2), ("terrain", _P), ("prev_shaping", _P), ("t", _P),
        ("sleep", _P), ("wind_idx", _P), ("torque_idx", _P), ("obs", _P),
    ]


class Out(ctypes.Structure):
    _fields_ = [
        ("obs", _P), ("state", _P * 6), ("leg", _P * 2), ("terrain", _P), ("prev_shaping", _P),
        ("t", _P), ("sleep", _P), ("wind_idx", _P), ("torque_idx", _P),
    ]


class VecIO(ctypes.Structure):
    _fields_ = [("step", IO), ("pool", Pool), ("out", Out), ("time_div", Div),
                ("time_feature", _I)]


DIVS = ("scale", "total_mass", "inertia", "chunk_w", "half_w", "half_h", "fps")
INTS = ("enable_wind", "sleep_frames", "max_steps")


def const_values(params) -> dict:
    """The step's constants as the plain version's float32 arithmetic meets
    them: each Python double (or constant expression of doubles, as the
    plain version writes it) rounded once to float32; a divisor as itself
    and its float32 reciprocal (:data:`DIVS`); the flags and counts
    (:data:`INTS`) as ints."""
    dt = 1.0 / ll.FPS
    return dict(
        scale=ll.SCALE, total_mass=ll.TOTAL_MASS, inertia=ll.INERTIA,
        chunk_w=ll.W / (ll.CHUNKS - 1), half_w=ll.W / 2.0, half_h=ll.H / 2.0, fps=ll.FPS,
        dispersion_scale=params.dispersion_scale, wind_power=params.wind_power,
        turbulence_power=params.turbulence_power,
        dt=dt, g_dt=_f32_product(params.gravity, dt), com_offset=ll.COM_OFFSET,
        wind_k1=0.02, wind_k2=math.pi * 0.01, main_y=ll.MAIN_ENGINE_Y_LOCATION / ll.SCALE,
        main_power=ll.MAIN_ENGINE_POWER, side_power=ll.SIDE_ENGINE_POWER,
        side_away=ll.SIDE_ENGINE_AWAY, side_height=ll.SIDE_ENGINE_HEIGHT,
        tip_x=[-ll.LEG_TIP_X, ll.LEG_TIP_X], tip_y=ll.LEG_TIP_Y,
        xi_max=ll.CHUNKS - 1 - 1e-6, contact_skin=ll.CONTACT_SKIN, slop=ll.SLOP,
        inv_mass=1.0 / ll.TOTAL_MASS, mu=ll.MU, neg_mu=-ll.MU, j_crash=ll.J_CRASH,
        hull_x=[ll.HULL_BOTTOM[0], ll.HULL_BOTTOM[1]], hull_y=ll.HULL_BOTTOM[2],
        hull_skin=0.01, lin_sleep=ll.LIN_SLEEP_TOL, ang_sleep=ll.ANG_SLEEP_TOL,
        pad_y=ll.HELIPAD_Y + ll.LEG_DOWN, height=ll.H,
        enable_wind=int(params.enable_wind), sleep_frames=ll.SLEEP_FRAMES,
        max_steps=int(params.max_steps_in_episode),
    )


def _consts_type():
    fields = []
    for name, value in const_values(ll.LunarLanderParams()).items():
        kind = Div if name in DIVS else (_I if name in INTS else _F)
        fields.append((name, kind * len(value) if isinstance(value, list) else kind))
    return type("RigidConsts", (ctypes.Structure,), {"_fields_": fields})


RigidConsts = _consts_type()


def _f32(x: float) -> float:
    return float(np.float32(x))


def card_div(c: float) -> Div:
    """The :class:`Div` of a Python number ``c`` that a tensor is divided
    by: ``float32(c)`` and the float32 of the double ``1 / c``, by which
    PyTorch's CUDA division by a Python number multiplies (on the H100 with
    torch 2.11, ``x / 1.1`` is ``x * float32(1 / 1.1)``; ``x * (1.0f /
    float32(1.1))`` differs from it on 79 % of 2^20 floats; the two
    reciprocals agree for R1's divisors and the presets' episode limits;
    ``artifacts/rigid_kernel/scalar_division.py``)."""
    return Div(_f32(c), _f32(1.0 / c))


@functools.lru_cache(maxsize=64)
def _consts_of(key: tuple) -> ctypes.Structure:
    k = RigidConsts()
    for name, value in key:
        if name in DIVS:
            setattr(k, name, card_div(value))
        elif name in INTS:
            setattr(k, name, value)
        elif isinstance(value, tuple):
            getattr(k, name)[:] = [_f32(v) for v in value]
        else:
            setattr(k, name, _f32(value))
    return k


def rigid_consts(params) -> ctypes.Structure:
    """:class:`RigidConsts` for ``params``, every float float32 (ctypes
    rounds a double to the nearest float32 once) and every divisor with
    its reciprocal as PyTorch's CUDA division by a Python float takes it
    (:func:`card_div`)."""
    key = tuple((name, tuple(v) if isinstance(v, list) else v)
                for name, v in const_values(params).items())
    return _consts_of(key)


def check_sizes(lib: ctypes.CDLL) -> None:
    """The library's ``sizeof(IO)``, ``sizeof(RigidConsts)`` and
    ``sizeof(VecIO)`` equal these structures' (a field added on one side
    only fails here)."""
    sizes = (ctypes.c_int * 3)()
    lib.lander_rigid_sizes(sizes)
    ours = (ctypes.sizeof(IO), ctypes.sizeof(RigidConsts), ctypes.sizeof(VecIO))
    if tuple(sizes) != ours:
        raise RuntimeError(f"lander_rigid structs differ: library {tuple(sizes)}, Python {ours}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("lander_rigid.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rigid_step_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.rigid_step_launch.restype = i32
    lib.rigid_vector_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.rigid_vector_launch.restype = i32
    lib.rigid_math_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.rigid_math_launch.restype = i32
    lib.lander_rigid_sizes.argtypes = [ptr]
    lib.lander_rigid_sizes.restype = i32
    check_sizes(lib)
    return lib


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check_step(state, action, draws, wind: bool) -> torch.device:
    device = state.x.device
    n = state.x.shape[0]
    for f in STATE_FIELDS + ("prev_shaping",):
        _check(f"state.{f}", getattr(state, f), torch.float32, (n,), device)
    for f in ("leg1", "leg2"):
        _check(f"state.{f}", getattr(state, f), torch.bool, (n,), device)
    for f in ("t", "sleep") + (("wind_idx", "torque_idx") if wind else ()):
        _check(f"state.{f}", getattr(state, f), torch.int32, (n,), device)
    _check("state.terrain", state.terrain, torch.float32, (n, ll.CHUNKS), device)
    _check("action", action, torch.int32, (n,), device)
    _check("draws", draws, torch.float32, (n, 2), device)
    return device


def _check_reset(terrain, kick, wind) -> torch.device:
    device = terrain.device
    n = terrain.shape[0]
    _check("terrain", terrain, torch.float32, (n, ll.CHUNKS), device)
    _check("kick", kick, torch.float32, (n, 2), device)
    _check("wind", wind, torch.int32, (n, 2), device)
    return device


def rigid_call(launch: Callable, params, state=None, action=None, draws=None, terrain=None,
               kick=None, wind=None):
    """The wrappers' body around ``launch(io, consts, n)``, which runs the
    frame on the pointers of ``io``: the CUDA launcher on the card, the
    host build of ``lander_rigid.cuh`` in the CPU tests.  A step (``state``,
    ``action``, ``draws``) returns ``step_env``'s ``(obs, state, reward,
    terminated, truncated)``; the reset frame (``terrain``, ``kick``,
    ``wind``: the smoothed terrain and the reset's draws) ``reset_env``'s
    ``(obs, state)``.  Allocates the outputs on the inputs' device; with the
    wind off a step's state keeps the wind indices it was given, and every
    state keeps its terrain tensor, as the plain version's do."""
    reset = state is None
    device = terrain.device if reset else state.x.device
    n = terrain.shape[0] if reset else state.x.shape[0]
    writes_wind = reset or params.enable_wind

    def empty(dtype, *shape):
        return torch.empty((n, *shape), dtype=dtype, device=device)

    obs = empty(torch.float32, 8)
    outs = [empty(torch.float32) for _ in STATE_FIELDS]
    legs = [empty(torch.bool), empty(torch.bool)]
    shaping, t, sleep = empty(torch.float32), empty(torch.int32), empty(torch.int32)
    wind_out = [empty(torch.int32), empty(torch.int32)] if writes_wind else None

    io = IO()
    io.obs = obs.data_ptr()
    io.state_out[:] = [o.data_ptr() for o in outs]
    io.leg_out[:] = [o.data_ptr() for o in legs]
    io.shaping_out, io.t_out, io.sleep_out = shaping.data_ptr(), t.data_ptr(), sleep.data_ptr()
    if writes_wind:
        io.wind_out, io.torque_out = wind_out[0].data_ptr(), wind_out[1].data_ptr()
    if reset:
        io.terrain = terrain.data_ptr()
        io.kick, io.wind_draws = kick.data_ptr(), wind.data_ptr()
        launch(io, rigid_consts(params), n)
        new_state = ll.LunarLanderState(
            **dict(zip(STATE_FIELDS, outs)), leg1=legs[0], leg2=legs[1], terrain=terrain,
            prev_shaping=shaping, t=t, sleep=sleep, wind_idx=wind_out[0],
            torque_idx=wind_out[1])
        return obs, new_state

    reward, terminated, truncated = empty(torch.float32), empty(torch.bool), empty(torch.bool)
    io.state[:] = [getattr(state, f).data_ptr() for f in STATE_FIELDS]
    io.leg[:] = [state.leg1.data_ptr(), state.leg2.data_ptr()]
    io.terrain = state.terrain.data_ptr()
    io.prev_shaping, io.t, io.sleep = (state.prev_shaping.data_ptr(), state.t.data_ptr(),
                                       state.sleep.data_ptr())
    if writes_wind:
        io.wind_idx, io.torque_idx = state.wind_idx.data_ptr(), state.torque_idx.data_ptr()
    io.action, io.draws = action.data_ptr(), draws.data_ptr()
    io.reward, io.terminated, io.truncated = (reward.data_ptr(), terminated.data_ptr(),
                                              truncated.data_ptr())
    launch(io, rigid_consts(params), n)
    wind_idx, torque_idx = wind_out if writes_wind else (state.wind_idx, state.torque_idx)
    new_state = dataclasses.replace(
        state, **dict(zip(STATE_FIELDS, outs)), leg1=legs[0], leg2=legs[1],
        prev_shaping=shaping, t=t, sleep=sleep, wind_idx=wind_idx, torque_idx=torque_idx)
    return obs, new_state, reward, terminated, truncated


def rigid_vector_call(launch: Callable, params, state, action, draws, fresh,
                      time_feature: bool = False):
    """The vector step's wrapper body around ``launch(vio, consts, n)``,
    which runs it on the pointers of the :class:`VecIO` ``vio``: the CUDA
    launcher on the card, the host build of ``lander_rigid.cuh`` in the CPU
    tests.  Returns ``VectorEnv._step``'s ``(out_obs, out_state)`` after the
    auto-reset from the pool ``fresh`` (``(fresh_obs, fresh_state)``; env
    ``i`` resets into entry ``i`` where its step ended) and its
    transition's ``next_obs`` (before the reset), ``reward``,
    ``terminated`` and ``truncated``; each observation ends in
    ``t / max_steps`` with ``time_feature``.  Allocates the outputs on the
    inputs' device; the state after the reset holds new tensors only."""
    device, n = state.x.device, state.x.shape[0]
    width = 8 + int(time_feature)
    fresh_obs, fresh_state = fresh

    def empty(dtype, *shape):
        return torch.empty((n, *shape), dtype=dtype, device=device)

    next_obs, out_obs = empty(torch.float32, width), empty(torch.float32, width)
    reward, terminated, truncated = empty(torch.float32), empty(torch.bool), empty(torch.bool)
    outs = [empty(torch.float32) for _ in STATE_FIELDS]
    legs = [empty(torch.bool), empty(torch.bool)]
    terrain, shaping = empty(torch.float32, ll.CHUNKS), empty(torch.float32)
    t, sleep, wind_idx, torque_idx = (empty(torch.int32) for _ in range(4))

    def ptrs(obj, fields):
        return [getattr(obj, f).data_ptr() for f in fields]

    io = IO()
    io.state[:] = ptrs(state, STATE_FIELDS)
    io.leg[:] = ptrs(state, ("leg1", "leg2"))
    (io.terrain, io.prev_shaping, io.t, io.sleep, io.wind_idx, io.torque_idx) = ptrs(
        state, ("terrain", "prev_shaping", "t", "sleep", "wind_idx", "torque_idx"))
    io.action, io.draws, io.obs = action.data_ptr(), draws.data_ptr(), next_obs.data_ptr()
    io.reward, io.terminated, io.truncated = (reward.data_ptr(), terminated.data_ptr(),
                                              truncated.data_ptr())
    pool = Pool()
    pool.state[:] = ptrs(fresh_state, STATE_FIELDS)
    pool.leg[:] = ptrs(fresh_state, ("leg1", "leg2"))
    (pool.terrain, pool.prev_shaping, pool.t, pool.sleep, pool.wind_idx, pool.torque_idx) = ptrs(
        fresh_state, ("terrain", "prev_shaping", "t", "sleep", "wind_idx", "torque_idx"))
    pool.obs = fresh_obs.data_ptr()
    out = Out()
    out.obs = out_obs.data_ptr()
    out.state[:] = [o.data_ptr() for o in outs]
    out.leg[:] = [o.data_ptr() for o in legs]
    (out.terrain, out.prev_shaping, out.t, out.sleep, out.wind_idx, out.torque_idx) = (
        x.data_ptr() for x in (terrain, shaping, t, sleep, wind_idx, torque_idx))
    steps = params.max_steps_in_episode
    vio = VecIO(step=io, pool=pool, out=out,
                time_div=card_div(steps),
                time_feature=int(time_feature))
    launch(vio, rigid_consts(params), n)
    out_state = dataclasses.replace(
        state, **dict(zip(STATE_FIELDS, outs)), leg1=legs[0], leg2=legs[1], terrain=terrain,
        prev_shaping=shaping, t=t, sleep=sleep, wind_idx=wind_idx, torque_idx=torque_idx)
    return out_obs, out_state, next_obs, reward, terminated, truncated


def _on_card(device: torch.device, entry: str) -> Callable:
    """The launch of the library's ``entry`` on ``device``'s current
    stream, no sync (so a CUDA graph can capture it); raises for a device
    that is not CUDA."""
    if _device_kind(device) != "cuda":
        raise ValueError(f"the rigid lander's kernel runs on CUDA tensors, not on {device}; the "
                         f"plain version is envs/lunar_lander.py::LunarLander.step_env_reference")
    fn = getattr(_lib(), entry)

    def launch(io, consts, n):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _launch(fn, ctypes.byref(io), ctypes.byref(consts), n, stream)
    return launch


def _launch_on(device: torch.device, params, **inputs):
    """``rigid_call`` on the card."""
    out = rigid_call(_on_card(device, "rigid_step_launch"), params, **inputs)
    launches["rigid_step"] += 1
    return out


def rigid_step_kernel(state, action: torch.Tensor, params, draws: torch.Tensor):
    """R1's step on CUDA tensors: ``LunarLander.step_env``'s result for the
    rigid engine, from the ``(N, 2)`` dispersion draws; raises on tensors
    elsewhere."""
    if params.jointed:
        raise ValueError("R1 steps the rigid lander; the jointed one steps through S1")
    device = _check_step(state, action, draws, params.enable_wind)
    return _launch_on(device, params, state=state, action=action, draws=draws)


def rigid_reset_kernel(terrain: torch.Tensor, kick: torch.Tensor, wind: torch.Tensor, params):
    """R1's reset frame on CUDA tensors: ``LunarLander.reset_env``'s result
    for the rigid engine from the smoothed ``(N, CHUNKS)`` terrain and the
    reset's kick and wind draws; raises on tensors elsewhere."""
    if params.jointed:
        raise ValueError("R1 steps the rigid lander; the jointed one steps through S1")
    device = _check_reset(terrain, kick, wind)
    return _launch_on(device, params, terrain=terrain, kick=kick, wind=wind)


def _check_pool(fresh, n: int, width: int, device: torch.device) -> None:
    fresh_obs, fresh_state = fresh
    _check("fresh_obs", fresh_obs, torch.float32, (n, width), device)
    for f in STATE_FIELDS + ("prev_shaping",):
        _check(f"fresh.{f}", getattr(fresh_state, f), torch.float32, (n,), device)
    for f in ("leg1", "leg2"):
        _check(f"fresh.{f}", getattr(fresh_state, f), torch.bool, (n,), device)
    for f in ("t", "sleep", "wind_idx", "torque_idx"):
        _check(f"fresh.{f}", getattr(fresh_state, f), torch.int32, (n,), device)
    _check("fresh.terrain", fresh_state.terrain, torch.float32, (n, ll.CHUNKS), device)


def rigid_vector_kernel(state, action: torch.Tensor, params, draws: torch.Tensor, fresh,
                        time_feature: bool = False):
    """R1's vector step on CUDA tensors: ``VectorEnv._step`` of the rigid
    lander with the reset pool ``fresh`` (``(fresh_obs, fresh_state)``),
    one launch; :func:`rigid_vector_call` says what it returns.  Raises on
    tensors elsewhere."""
    if params.jointed:
        raise ValueError("R1 steps the rigid lander; the jointed one steps through S1")
    device = _check_step(state, action, draws, True)
    _check_pool(fresh, state.x.shape[0], 8 + int(time_feature), device)
    out = rigid_vector_call(_on_card(device, "rigid_vector_launch"), params, state, action,
                            draws, fresh, time_feature)
    launches["rigid_step"] += 1
    return out


def device_math(x: torch.Tensor) -> torch.Tensor:
    """For checks, not on the main path: the card's ``sinf``, ``cosf``,
    ``sincosf``'s sine and cosine and ``tanhf`` of a CUDA float32 vector, the
    functions the kernel calls, as a ``(5, n)`` tensor."""
    _check("x", x, torch.float32, (x.shape[0],), x.device)
    if _device_kind(x.device) != "cuda":
        raise ValueError("device_math runs on CUDA tensors")
    out = torch.empty((5, x.shape[0]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch(_lib().rigid_math_launch, x.data_ptr(), out.data_ptr(), x.shape[0], stream)
    return out
