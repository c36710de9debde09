"""S1, one ``world.Step`` of the jointed lander: the CUDA kernel
(``csrc/lander_solver.cu``, its body ``csrc/lander_solver.cuh``) and its
plain PyTorch version (``envs/lander_solver.py::assembly_step_reference``).

Not a TPU kernel: the JAX package writes the solver as scalar code per env
(``deep_q_learning_tpu/envs/lander_solver.py::assembly_step``), and
``jax.vmap`` with XLA compiles its velocity and position loops into one
program inside the jitted superstep.  The plain version runs the same
arithmetic as tens of thousands of elementwise kernels a frame; the kernel
runs the whole step in one launch, one thread an env, and agrees with the
plain version operation for operation (see the source).

:func:`assembly_step_kernel` launches the kernel on CUDA tensors, or
raises; ``envs/lander_solver.py::assembly_step`` calls it for CUDA tensors
and runs the plain version on CPU tensors.  ``launches`` counts kernel
launches, and ``plain_calls`` counts calls that took the plain version.
:func:`assembly_step_work` gives the bytes and operations a call needs
(``ops.bound_us`` turns them into the least time the card could take), and
:func:`position_passes`, for measurements only, the position passes each
env of a call ran, which that count needs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple, Union

import numpy as np
import torch

from deep_q_learning_tpu_torch.envs import lander_solver as ls
from deep_q_learning_tpu_torch.ops.build import load_library
from deep_q_learning_tpu_torch.ops.td_kernels import _check, _device_kind, _launch

launches = {"assembly_step": 0}
plain_calls = {"assembly_step": 0}

BODY_FIELDS = ("cx", "cy", "a", "vx", "vy", "w")

# bytes an env: read 18 body floats, 11 terrain heights, 3 forces and the
# accumulators (8 joint floats, 2 int32 limit states, 16 contact floats);
# write 18 body floats, the accumulators and 4 one-byte flags
READ_BYTES = 4 * (18 + ls.CHUNKS + 3 + 8 + 2 + 16)
WRITE_BYTES = 4 * (18 + 8 + 2 + 16) + 4
# float32 operations an env, counted from the code (csrc/lander_solver.cuh,
# which computes every branch the plain version computes and selects; sin,
# cos, sqrt and a division count one each): the frame's collision,
# integration, per-frame terms, warm start, stores, position integration and
# sleep test; each velocity pass; each position pass; and what a velocity
# pass adds with vel_tol > 0 (16 differences, 16 absolute values, 15
# maxima).  tests/test_torch_solver_kernel.py holds them to a count of the
# plain version's arithmetic
FRAME_OPS = 895
VEL_PASS_OPS = 430
POS_PASS_OPS = 341
VEL_TOL_PASS_OPS = 47


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def _total(passes, n: int) -> int:
    if isinstance(passes, (int, np.integer)):
        return int(passes) * n
    return int(torch.as_tensor(passes).to(torch.int64).sum())


def assembly_step_work(
    n: int, vel_iters: Union[int, torch.Tensor], pos_iters: Union[int, torch.Tensor],
    vel_tol: float = 0.0, return_iters: bool = False,
) -> Tuple[int, int]:
    """``(bytes, operations)`` a call on ``n`` envs needs: every input read
    once and every output written once, and the float32 operations of the
    passes run.  ``vel_iters`` and ``pos_iters`` are the passes every env
    runs, or ``(n,)`` counts per env (what a call with ``vel_tol > 0`` and
    the position loop's early exit ran: ``return_iters`` and
    :func:`position_passes`).  ``return_iters`` adds the int32 count written
    per env."""
    vel, pos = _total(vel_iters, n), _total(pos_iters, n)
    per_vel = VEL_PASS_OPS + (VEL_TOL_PASS_OPS if vel_tol > 0 else 0)
    nbytes = n * (READ_BYTES + WRITE_BYTES + (4 if return_iters else 0))
    return nbytes, n * FRAME_OPS + vel * per_vel + pos * POS_PASS_OPS


# ---------------------------------------------------------------------------
# The C interface (lander_solver.cuh's structs, field for field)
# ---------------------------------------------------------------------------

_P, _F = ctypes.c_void_p, ctypes.c_float


class IO(ctypes.Structure):
    _fields_ = [
        ("body", _P * 18), ("terrain", _P), ("force", _P * 3), ("j", _P * 2), ("s", _P * 2),
        ("c", _P * 2), ("body_out", _P * 18), ("touch", _P * 2), ("hull_hit", _P),
        ("still", _P), ("j_out", _P * 2), ("s_out", _P * 2), ("c_out", _P * 2),
        ("used", _P), ("pos_used", _P),
    ]


def const_values(dt: float, gravity: float, vel_tol: float) -> dict:
    """The solver's constants as the plain version's float32 arithmetic
    meets them: each Python double (or sum or product of doubles, as the
    plain version writes it) rounded once to float32."""
    side = (-1.0, 1.0)
    chunk_w = ls.W / (ls.CHUNKS - 1)
    return dict(
        imh=ls.IMH, iih=ls.IIH, iml=ls.IML, iil=ls.IIL,
        imh_iml=ls.IMH + ls.IML, neg_iih=-ls.IIH, k33=ls.IIH + ls.IIL,
        neg_motor_mass=-ls.MOTOR_MASS,
        max_imp=dt * ls.MOTOR_TORQUE, neg_max_imp=-(dt * ls.MOTOR_TORQUE),
        mu=ls.MU, dt=dt, gravity=gravity, g_dt=ls._f32_product(dt, gravity),
        ra_x=0.0 - ls.HULL_CX, ra_y=0.0 - ls.HULL_CY, pa_x=-ls.HULL_CX, pa_y=-ls.HULL_CY,
        away=[s * ls.LEG_AWAY for s in side], down=ls.LEG_DOWN,
        ref=[s * 0.05 for s in side], motor_speed=[0.3 * s for s in side],
        lower=[0.4, -0.9], upper=[0.9, -0.4],
        leg_hw=ls.LEG_HW, leg_hh=ls.LEG_HH, neg_leg_hw=-ls.LEG_HW, neg_leg_hh=-ls.LEG_HH,
        hull_vx=[x - ls.HULL_CX for x, _ in ls.HULL_VERTS],
        hull_vy=[y - ls.HULL_CY for _, y in ls.HULL_VERTS],
        chunk_w=chunk_w, chunk_w_sq=chunk_w * chunk_w,
        total_radius=ls.TOTAL_RADIUS, linear_slop=ls.LINEAR_SLOP,
        angular_slop=ls.ANGULAR_SLOP, baumgarte=ls.BAUMGARTE,
        neg_max_linear_correction=-ls.MAX_LINEAR_CORRECTION,
        max_angular_correction=ls.MAX_ANGULAR_CORRECTION,
        neg_max_angular_correction=-ls.MAX_ANGULAR_CORRECTION,
        neg_3slop=-3.0 * ls.LINEAR_SLOP,
        max_translation_sq=ls.MAX_TRANSLATION**2, max_translation=ls.MAX_TRANSLATION,
        max_rotation=ls.MAX_ROTATION,
        lin_sleep_sq=ls.LIN_SLEEP_TOL**2, ang_sleep_sq=ls.ANG_SLEEP_TOL**2,
        det_eps=1e-12, block_eps=1e-3, vel_tol=vel_tol or 0.0,
    )


def _const_type():
    fields = []
    for name, value in const_values(0.02, -10.0, 0.0).items():
        fields.append((name, _F * len(value) if isinstance(value, list) else _F))
    return type("Consts", (ctypes.Structure,), {"_fields_": fields})


Consts = _const_type()


@functools.lru_cache(maxsize=64)
def solver_consts(dt: float, gravity: float, vel_tol: float) -> ctypes.Structure:
    """:class:`Consts` for one (dt, gravity, vel_tol), every value float32
    (ctypes rounds a double to the nearest float32 once)."""
    k = Consts()
    for name, value in const_values(dt, gravity, vel_tol).items():
        if isinstance(value, list):
            getattr(k, name)[:] = [float(np.float32(v)) for v in value]
        else:
            setattr(k, name, float(np.float32(value)))
    return k


def check_sizes(lib: ctypes.CDLL) -> None:
    """The library's ``sizeof(IO)`` and ``sizeof(Consts)`` equal these
    structures' (a field added on one side only fails here)."""
    sizes = (ctypes.c_int * 2)()
    lib.lander_solver_sizes(sizes)
    if (sizes[0], sizes[1]) != (ctypes.sizeof(IO), ctypes.sizeof(Consts)):
        raise RuntimeError(f"lander_solver structs differ: library {tuple(sizes)}, Python "
                           f"{(ctypes.sizeof(IO), ctypes.sizeof(Consts))}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("lander_solver.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.assembly_step_launch.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.assembly_step_launch.restype = i32
    lib.lander_solver_sizes.argtypes = [ptr]
    lib.lander_solver_sizes.restype = i32
    check_sizes(lib)
    return lib


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def _check_inputs(hull, leg1, leg2, terrain, fx, fy, torque, acc) -> torch.device:
    device = hull.cx.device
    n = hull.cx.shape[0]
    for name, body in (("hull", hull), ("leg1", leg1), ("leg2", leg2)):
        for f in BODY_FIELDS:
            _check(f"{name}.{f}", getattr(body, f), torch.float32, (n,), device)
    _check("terrain", terrain, torch.float32, (n, ls.CHUNKS), device)
    for name, t in (("fx", fx), ("fy", fy), ("torque", torque)):
        _check(name, t, torch.float32, (n,), device)
    for name, dtype, shape in (("j1", torch.float32, (n, 4)), ("j2", torch.float32, (n, 4)),
                               ("s1", torch.int32, (n,)), ("s2", torch.int32, (n,)),
                               ("c1", torch.float32, (n, 4, 2)),
                               ("c2", torch.float32, (n, 4, 2))):
        _check(f"acc.{name}", getattr(acc, name), dtype, shape, device)
    return device


def assembly_step_call(
    launch: Callable, hull, leg1, leg2, terrain, fx, fy, torque, gravity: float, acc,
    dt: float, vel_iters: int, pos_iters: int, vel_tol: float, return_iters: bool,
    return_pos_iters: bool = False,
):
    """The wrapper's body around ``launch(io, consts, n, vel_iters,
    pos_iters)``, which runs the solver on the pointers of ``io``: the CUDA
    launcher on the card, the host build of ``lander_solver.cuh`` in the
    CPU tests.  Allocates the outputs on the inputs' device (three
    buffers, viewed per field) and returns the plain version's tuple."""
    n = hull.cx.shape[0]
    device = hull.cx.device
    floats = torch.empty((42 * n,), dtype=torch.float32, device=device)
    ints = torch.empty((4 * n,), dtype=torch.int32, device=device)
    flags = torch.empty((4 * n,), dtype=torch.bool, device=device)
    part = lambda buf, i, k=1: buf[i * n:(i + k) * n]  # noqa: E731
    outs = [part(floats, i) for i in range(18)]
    j_out = [part(floats, 18, 4).view(n, 4), part(floats, 22, 4).view(n, 4)]
    c_out = [part(floats, 26, 8).view(n, 4, 2), part(floats, 34, 8).view(n, 4, 2)]
    s_out = [part(ints, 0), part(ints, 1)]
    used, pos_used = part(ints, 2), part(ints, 3)
    touch = [part(flags, 0), part(flags, 1)]
    hull_hit, still = part(flags, 2), part(flags, 3)

    io = IO()
    io.body[:] = [getattr(b, f).data_ptr() for b in (hull, leg1, leg2) for f in BODY_FIELDS]
    io.terrain = terrain.data_ptr()
    io.force[:] = [fx.data_ptr(), fy.data_ptr(), torque.data_ptr()]
    io.j[:] = [acc.j1.data_ptr(), acc.j2.data_ptr()]
    io.s[:] = [acc.s1.data_ptr(), acc.s2.data_ptr()]
    io.c[:] = [acc.c1.data_ptr(), acc.c2.data_ptr()]
    io.body_out[:] = [t.data_ptr() for t in outs]
    io.touch[:] = [t.data_ptr() for t in touch]
    io.hull_hit, io.still = hull_hit.data_ptr(), still.data_ptr()
    io.j_out[:] = [t.data_ptr() for t in j_out]
    io.s_out[:] = [t.data_ptr() for t in s_out]
    io.c_out[:] = [t.data_ptr() for t in c_out]
    io.used = used.data_ptr() if return_iters else None
    io.pos_used = pos_used.data_ptr() if return_pos_iters else None
    launch(io, solver_consts(float(dt), float(gravity), float(vel_tol or 0.0)), n,
           int(vel_iters), int(pos_iters))

    bodies = [ls.Body(*outs[6 * b:6 * b + 6]) for b in range(3)]
    new_acc = ls.AssemblyAcc(j1=j_out[0], j2=j_out[1], s1=s_out[0], s2=s_out[1],
                             c1=c_out[0], c2=c_out[1])
    out = (*bodies, touch[0], touch[1], hull_hit, still, new_acc)
    if return_iters:
        out += (used,)
    if return_pos_iters:
        out += (pos_used,)
    return out


def _launch_on(device: torch.device, *args):
    """``assembly_step_call`` on the card: the kernel on ``device``'s
    current stream, no sync (so a CUDA graph can capture it)."""
    if _device_kind(device) != "cuda":
        raise ValueError(f"assembly_step_kernel runs on CUDA tensors, not on {device}; the plain "
                         f"version is envs/lander_solver.py::assembly_step_reference")
    lib = _lib()

    def launch(io, consts, n, vel, pos):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _launch(lib.assembly_step_launch, ctypes.byref(io), ctypes.byref(consts), n, vel,
                    pos, stream)

    out = assembly_step_call(launch, *args)
    launches["assembly_step"] += 1
    return out


def assembly_step_kernel(
    hull, leg1, leg2, terrain, fx, fy, torque, gravity: float, acc=None,
    dt: float = 1.0 / ls.FPS, vel_iters: int = ls.VEL_ITERS, pos_iters: int = ls.POS_ITERS,
    vel_tol: float = 0.0, return_iters: bool = False,
):
    """S1 on CUDA tensors, with ``envs/lander_solver.py::assembly_step``'s
    signature and result; raises on tensors elsewhere."""
    if acc is None:
        acc = ls.zero_acc(hull.cx.shape[0], hull.cx.device)
    device = _check_inputs(hull, leg1, leg2, terrain, fx, fy, torque, acc)
    return _launch_on(device, hull, leg1, leg2, terrain, fx, fy, torque, gravity, acc, dt,
                      vel_iters, pos_iters, vel_tol, return_iters)


def position_passes(
    hull, leg1, leg2, terrain, fx, fy, torque, gravity: float, acc,
    dt: float = 1.0 / ls.FPS, vel_iters: int = ls.VEL_ITERS, pos_iters: int = ls.POS_ITERS,
    vel_tol: float = 0.0,
) -> torch.Tensor:
    """For measurements, not on the main path: one launch of S1 on CUDA
    tensors that also writes the ``(N,)`` int32 count of position passes
    each env ran (the early exit), which :func:`assembly_step_work` takes
    to count the work of this data."""
    device = _check_inputs(hull, leg1, leg2, terrain, fx, fy, torque, acc)
    return _launch_on(device, hull, leg1, leg2, terrain, fx, fy, torque, gravity, acc, dt,
                      vel_iters, pos_iters, vel_tol, False, True)[-1]
