"""J1, one frame of the jointed lander: the CUDA kernel
(``csrc/lander_jointed.cu``, its body ``csrc/lander_jointed.cuh`` around S1's
``csrc/lander_solver.cuh``) and its plain PyTorch version
(``envs/lunar_lander.py::LunarLander.step_env_reference`` and
``reset_env_reference`` with the jointed engine).

Not a TPU kernel: the JAX package writes the jointed step as scalar code for
one env (``deep_q_learning_tpu/envs/lunar_lander.py::step_env`` with
``_physics_step_jointed``, and ``reset_env``'s physics frame), and
``jax.vmap`` with XLA fuses it into the jitted superstep.  The plain version
runs the frame around the solver as ~200 elementwise kernels and the solver
as S1; the kernel runs the whole frame in one launch, a group of four lanes
of a warp an env, and agrees with the plain version bit for bit: every value
comes from the same operations on the same operands (see the source).

:func:`jointed_step_kernel` (a step: observation, state, reward and flags)
and :func:`jointed_reset_kernel` (reset_env's frame with the kick, from the
smoothed terrain and the reset's draws) launch the kernel on CUDA tensors,
or raise; ``envs/lunar_lander.py`` calls them for CUDA tensors and runs the
plain version on CPU tensors.  ``launches`` counts kernel launches,
``plain_calls`` calls that took the plain version, both frames alike.
:func:`jointed_step_work` gives the bytes and operations of a call, of
which ``ops.bound_us`` makes J1's bound; :func:`position_passes`, for
measurements, the position passes each env of a call ran, which that count
takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Tuple, Union

import numpy as np
import torch

from deep_q_learning_tpu_torch.envs import lander_solver as ls
from deep_q_learning_tpu_torch.envs import lunar_lander as ll
from deep_q_learning_tpu_torch.ops import lander_kernels as lk
from deep_q_learning_tpu_torch.ops import solver_kernels as sk
from deep_q_learning_tpu_torch.ops.build import load_library
from deep_q_learning_tpu_torch.ops.td_kernels import _check, _device_kind, _launch

launches = {"jointed_step": 0}
plain_calls = {"jointed_step": 0}

STATE_FIELDS = lk.STATE_FIELDS
BODY_FIELDS = sk.BODY_FIELDS

# bytes an env: R1's frame (lander_kernels.py: the state, the terrain, the
# potential, t, sleep, the action and the draws in; the observation, the
# state, the potential, t, sleep, the reward and the flags out), and besides
# the legs' 12 body floats and the accumulators (8 joint floats, 2 int32
# limit states, 16 contact floats) in and out; the reset frame reads no legs
# and no accumulators
LEGS_ACC_BYTES = 4 * (12 + 8 + 2 + 16)
# float32 operations an env of the plain version around the solver (sin,
# cos, tanh, sqrt and a division count one each; selects, compares and
# casts none): a step's dispersion, the hull's COM, the engines, the hull's
# origin, the observation, the potential and the reward; what the wind
# adds; the reset frame's (the kick, no dispersion, no reward).  The solver
# is S1's count (solver_kernels.assembly_step_work).  The plain version
# computes the observation twice (get_obs, and again in _shaping; 10
# operations), the kernel once: tests/test_torch_jointed_kernel.py holds
# these to a count of the plain version's arithmetic less that repeat
STEP_OPS = 121
WIND_OPS = 16
RESET_OPS = 115


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def jointed_step_work(
    n: int, vel_iters: Union[int, torch.Tensor], pos_iters: Union[int, torch.Tensor],
    enable_wind: bool = False, reset: bool = False, vel_tol: float = 0.0,
) -> Tuple[int, int]:
    """``(bytes, operations)`` of a call on ``n`` envs: every input read
    once and every output written once, and the plain version's float32
    operations, S1's for the passes run (``vel_iters`` and ``pos_iters``
    the passes every env runs, or ``(n,)`` counts per env:
    :func:`position_passes`)."""
    frame_bytes, _ = lk.rigid_step_work(n, enable_wind, reset)
    nbytes = frame_bytes + n * LEGS_ACC_BYTES * (1 if reset else 2)
    ops = n * ((RESET_OPS if reset else STEP_OPS) + (WIND_OPS if enable_wind else 0))
    _, solver_ops = sk.assembly_step_work(n, vel_iters, pos_iters, vel_tol)
    return nbytes, ops + solver_ops


# ---------------------------------------------------------------------------
# The C interface (lander_jointed.cuh's structs, field for field)
# ---------------------------------------------------------------------------

_F, _I = ctypes.c_float, ctypes.c_int32


class IO(ctypes.Structure):
    _fields_ = [("frame", lk.IO), ("solver", sk.IO)]


class Consts(ctypes.Structure):
    _fields_ = [("frame", lk.RigidConsts), ("solver", sk.Consts), ("hull_cx", _F),
                ("hull_cy", _F), ("leg_x", _F * 2), ("leg_a", _F * 2), ("vel_iters", _I),
                ("pos_iters", _I)]


@functools.lru_cache(maxsize=64)
def _consts_of(params) -> ctypes.Structure:
    k = Consts()
    k.frame = lk.rigid_consts(params)
    k.solver = sk.solver_consts(1.0 / ls.FPS, float(params.gravity), float(params.vel_tol or 0.0))
    k.hull_cx, k.hull_cy = ls.HULL_CX, ls.HULL_CY
    sides = (-1.0, 1.0)
    k.leg_x[:] = [float(np.float32(ll.W / 2.0 - side * ll.LEG_AWAY)) for side in sides]
    k.leg_a[:] = [float(np.float32(side * 0.05)) for side in sides]
    k.vel_iters, k.pos_iters = int(params.vel_iters), int(params.pos_iters)
    return k


def jointed_consts(params) -> ctypes.Structure:
    """:class:`Consts` for ``params``: the frame's (``lander_kernels.
    rigid_consts``), the solver's (``solver_kernels.solver_consts`` of the
    step's dt, gravity and vel_tol) and the jointed frame's own, every float
    float32."""
    return _consts_of(params)


def check_sizes(lib: ctypes.CDLL) -> None:
    """The library's ``sizeof(IO)`` and ``sizeof(Consts)`` equal these
    structures' (a field added on one side only fails here)."""
    sizes = (ctypes.c_int * 2)()
    lib.lander_jointed_sizes(sizes)
    if (sizes[0], sizes[1]) != (ctypes.sizeof(IO), ctypes.sizeof(Consts)):
        raise RuntimeError(f"lander_jointed structs differ: library {tuple(sizes)}, Python "
                           f"{(ctypes.sizeof(IO), ctypes.sizeof(Consts))}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("lander_jointed.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.jointed_step_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.jointed_step_launch.restype = i32
    lib.lander_jointed_sizes.argtypes = [ptr]
    lib.lander_jointed_sizes.restype = i32
    check_sizes(lib)
    return lib


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check_step(state, action, draws, wind: bool) -> torch.device:
    device = lk._check_step(state, action, draws, wind)
    n = state.x.shape[0]
    for name in ("leg1_body", "leg2_body"):
        body = getattr(state, name)
        if body is None:
            raise ValueError(f"state.{name} is None: J1 steps the jointed lander")
        for f in BODY_FIELDS:
            _check(f"state.{name}.{f}", getattr(body, f), torch.float32, (n,), device)
    acc = state.solver_acc
    if acc is None:
        raise ValueError("state.solver_acc is None: J1 steps the jointed lander")
    for name, dtype, shape in (("j1", torch.float32, (n, 4)), ("j2", torch.float32, (n, 4)),
                               ("s1", torch.int32, (n,)), ("s2", torch.int32, (n,)),
                               ("c1", torch.float32, (n, 4, 2)),
                               ("c2", torch.float32, (n, 4, 2))):
        _check(f"state.solver_acc.{name}", getattr(acc, name), dtype, shape, device)
    return device


def jointed_call(launch: Callable, params, state=None, action=None, draws=None, terrain=None,
                 kick=None, wind=None, return_pos_iters: bool = False):
    """The wrappers' body around ``launch(io, consts, n)``, which runs the
    frame on the pointers of ``io``: the CUDA launcher on the card, the host
    build of ``lander_jointed.cuh`` in the CPU tests.  A step (``state``,
    ``action``, ``draws``) returns ``step_env``'s ``(obs, state, reward,
    terminated, truncated)``; the reset frame (``terrain``, ``kick``,
    ``wind``: the smoothed terrain and the reset's draws) ``reset_env``'s
    ``(obs, state)``; with ``return_pos_iters``, also the ``(N,)`` int32
    position passes each env ran.  Allocates the outputs on the inputs'
    device (three buffers, viewed per field); with the wind off a step's
    state keeps the wind indices it was given, and every state keeps its
    terrain tensor, as the plain version's do."""
    reset = state is None
    device = terrain.device if reset else state.x.device
    n = terrain.shape[0] if reset else state.x.shape[0]
    writes_wind = reset or params.enable_wind
    floats = torch.empty((52 * n,), dtype=torch.float32, device=device)
    ints = torch.empty((7 * n,), dtype=torch.int32, device=device)
    flags = torch.empty((4 * n,), dtype=torch.bool, device=device)
    part = lambda buf, i, k=1: buf[i * n:(i + k) * n]  # noqa: E731
    obs = part(floats, 0, 8).view(n, 8)
    outs = [part(floats, 8 + q) for q in range(6)]
    shaping, reward = part(floats, 14), part(floats, 15)
    leg_out = [part(floats, 16 + q) for q in range(12)]
    j_out = [part(floats, 28, 4).view(n, 4), part(floats, 32, 4).view(n, 4)]
    c_out = [part(floats, 36, 8).view(n, 4, 2), part(floats, 44, 8).view(n, 4, 2)]
    t, sleep = part(ints, 0), part(ints, 1)
    wind_out = [part(ints, 2), part(ints, 3)]
    s_out = [part(ints, 4), part(ints, 5)]
    pos_used = part(ints, 6)
    legs = [part(flags, 0), part(flags, 1)]
    terminated, truncated = part(flags, 2), part(flags, 3)

    io = IO()
    fio, sio = io.frame, io.solver
    fio.obs = obs.data_ptr()
    fio.state_out[:] = [o.data_ptr() for o in outs]
    fio.leg_out[:] = [o.data_ptr() for o in legs]
    fio.shaping_out, fio.t_out, fio.sleep_out = shaping.data_ptr(), t.data_ptr(), sleep.data_ptr()
    if writes_wind:
        fio.wind_out, fio.torque_out = wind_out[0].data_ptr(), wind_out[1].data_ptr()
    sio.body_out[6:] = [o.data_ptr() for o in leg_out]
    sio.j_out[:] = [o.data_ptr() for o in j_out]
    sio.s_out[:] = [o.data_ptr() for o in s_out]
    sio.c_out[:] = [o.data_ptr() for o in c_out]
    sio.pos_used = pos_used.data_ptr() if return_pos_iters else None
    if reset:
        fio.terrain = sio.terrain = terrain.data_ptr()
        fio.kick, fio.wind_draws = kick.data_ptr(), wind.data_ptr()
    else:
        fio.state[:] = [getattr(state, f).data_ptr() for f in STATE_FIELDS]
        fio.leg[:] = [state.leg1.data_ptr(), state.leg2.data_ptr()]
        fio.terrain = sio.terrain = state.terrain.data_ptr()
        fio.prev_shaping, fio.t, fio.sleep = (state.prev_shaping.data_ptr(), state.t.data_ptr(),
                                              state.sleep.data_ptr())
        if writes_wind:
            fio.wind_idx, fio.torque_idx = (state.wind_idx.data_ptr(),
                                            state.torque_idx.data_ptr())
        fio.action, fio.draws = action.data_ptr(), draws.data_ptr()
        fio.reward, fio.terminated, fio.truncated = (reward.data_ptr(), terminated.data_ptr(),
                                                     truncated.data_ptr())
        sio.body[6:] = [getattr(b, f).data_ptr() for b in (state.leg1_body, state.leg2_body)
                        for f in BODY_FIELDS]
        acc = state.solver_acc
        sio.j[:] = [acc.j1.data_ptr(), acc.j2.data_ptr()]
        sio.s[:] = [acc.s1.data_ptr(), acc.s2.data_ptr()]
        sio.c[:] = [acc.c1.data_ptr(), acc.c2.data_ptr()]
    launch(io, jointed_consts(params), n)

    fields = dict(zip(STATE_FIELDS, outs), leg1=legs[0], leg2=legs[1], prev_shaping=shaping,
                  t=t, sleep=sleep, leg1_body=ls.Body(*leg_out[:6]),
                  leg2_body=ls.Body(*leg_out[6:]),
                  solver_acc=ls.AssemblyAcc(j1=j_out[0], j2=j_out[1], s1=s_out[0], s2=s_out[1],
                                            c1=c_out[0], c2=c_out[1]))
    if reset:
        new_state = ll.LunarLanderState(**fields, terrain=terrain, wind_idx=wind_out[0],
                                        torque_idx=wind_out[1])
        out = (obs, new_state)
    else:
        wind_idx, torque_idx = wind_out if writes_wind else (state.wind_idx, state.torque_idx)
        new_state = dataclasses.replace(state, **fields, wind_idx=wind_idx,
                                        torque_idx=torque_idx)
        out = (obs, new_state, reward, terminated, truncated)
    return out + (pos_used,) if return_pos_iters else out


def _launch_on(device: torch.device, params, **inputs):
    """``jointed_call`` on the card: the kernel on ``device``'s current
    stream, no sync (so a CUDA graph can capture it)."""
    if _device_kind(device) != "cuda":
        raise ValueError(f"the jointed lander's kernel runs on CUDA tensors, not on {device}; "
                         f"the plain version is envs/lunar_lander.py::LunarLander."
                         f"step_env_reference")
    lib = _lib()

    def launch(io, consts, n):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _launch(lib.jointed_step_launch, ctypes.byref(io), ctypes.byref(consts), n, stream)

    out = jointed_call(launch, params, **inputs)
    launches["jointed_step"] += 1
    return out


def jointed_step_kernel(state, action: torch.Tensor, params, draws: torch.Tensor):
    """J1's step on CUDA tensors: ``LunarLander.step_env``'s result for the
    jointed engine, from the ``(N, 2)`` dispersion draws; raises on tensors
    elsewhere."""
    if not params.jointed:
        raise ValueError("J1 steps the jointed lander; the rigid one steps through R1")
    device = _check_step(state, action, draws, params.enable_wind)
    return _launch_on(device, params, state=state, action=action, draws=draws)


def jointed_reset_kernel(terrain: torch.Tensor, draws, params):
    """J1's reset frame on CUDA tensors: ``LunarLander.reset_env``'s result
    for the jointed engine from the smoothed ``(N, CHUNKS)`` terrain and the
    reset's draws (:class:`~deep_q_learning_tpu_torch.envs.lunar_lander.
    ResetDraws`: the kick and the wind indices); raises on tensors
    elsewhere."""
    if not params.jointed:
        raise ValueError("J1 steps the jointed lander; the rigid one steps through R1")
    device = lk._check_reset(terrain, draws.kick, draws.wind)
    return _launch_on(device, params, terrain=terrain, kick=draws.kick, wind=draws.wind)


def position_passes(params, state=None, action=None, draws=None, terrain=None,
                    reset_draws=None) -> torch.Tensor:
    """For measurements, not on the main path: one launch of J1 on CUDA
    tensors, a step (``state``, ``action``, ``draws``) or the reset frame
    (``terrain``, ``reset_draws``), that also writes the ``(N,)`` int32
    count of position passes each env ran (the early exit), which
    :func:`jointed_step_work` takes to count the work of this data."""
    if not params.jointed:
        raise ValueError("J1 steps the jointed lander; the rigid one steps through R1")
    if state is None:
        device = lk._check_reset(terrain, reset_draws.kick, reset_draws.wind)
        inputs = dict(terrain=terrain, kick=reset_draws.kick, wind=reset_draws.wind)
    else:
        device = _check_step(state, action, draws, params.enable_wind)
        inputs = dict(state=state, action=action, draws=draws)
    return _launch_on(device, params, return_pos_iters=True, **inputs)[-1]
