"""S1, one ``world.Step`` of the jointed lander: the CUDA kernel
(``csrc/lander_solver.cu``, its body ``csrc/lander_solver.cuh``) and its
plain PyTorch version (``envs/lander_solver.py::assembly_step_reference``).

Not a TPU kernel: the JAX package writes the solver as scalar code per env
(``deep_q_learning_tpu/envs/lander_solver.py::assembly_step``), and
``jax.vmap`` with XLA compiles its velocity and position loops into one
program inside the jitted superstep.  The plain version runs the same
arithmetic as tens of thousands of elementwise kernels a frame; the kernel
runs the whole step in one launch, a group of four lanes of a warp an env,
and agrees with the plain version bit for bit: every value it keeps comes
from the same operations on the same operands (see the source).

:func:`assembly_step_kernel` launches the kernel on CUDA tensors, or
raises; ``envs/lander_solver.py::assembly_step`` calls it for CUDA tensors
and runs the plain version on CPU tensors.  ``launches`` counts kernel
launches, and ``plain_calls`` counts calls that took the plain version.
:func:`assembly_step_work` gives the bytes and the plain version's
operations of a call; :func:`needed_work`, for measurements only, the
operations the call needs on its data, of which ``ops.bound_us`` makes
S1's bound (the least time the card could take), and
:func:`position_passes`, likewise, the position passes each env of a call
ran, which both counts take.
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
# float32 operations an env of the plain version, which computes every
# branch and selects (sin, cos, sqrt and a division count one each): the
# frame's collision, integration, per-frame terms, warm start, stores,
# position integration and sleep test; each velocity pass; each position
# pass; and what a velocity pass adds with vel_tol > 0 (16 differences, 16
# absolute values, 15 maxima).  tests/test_torch_solver_kernel.py holds
# them to a count of the plain version's arithmetic.  The function needs
# fewer (needed_work below), and so does the kernel, which computes only
# the branches the selects keep and reuses sin and cos
FRAME_OPS = 895
VEL_PASS_OPS = 430
POS_PASS_OPS = 341
VEL_TOL_PASS_OPS = 47

# Operations of the plain version's branches that a select drops, counted
# as above (see envs/lander_solver.py):
#   _solve_joint: the 3x3 rows 18, new_z 1, the violated 2x2's right side 4
#     and rows 8, its -z 1, the point 2x2 rows 8; a joint whose limit is
#     inactive keeps only the point rows, an active one the 3x3 and new_z,
#     a violated one the 3x3's third row, new_z and the violated branch
JOINT_DROPS = {"inactive": 32, "active": 21, "violated": 20}
#   _joint_data, once a frame: the cofactors 27, det3 and its test 15, k13
#     and k23 6, which only the limit's rows read
JOINT_FRAME_DROP = 48
#   _solve_contacts: the block case 24 (b1, b2 and the case-1 solve 16,
#     case 2 4, case 3 4, each tried only if the one before fails) and the
#     sequential case 13
BLOCK_OPS, BLOCK_CASE1, BLOCK_CASE_OPS, SEQUENTIAL_OPS = 24, 16, 4, 13
#   _pos_contact, a corner with no contact: its separation 6, correction 3,
#   mass 3 and impulse 2
POS_CORNER_DROP = 14
#   _pos_joint: the lower limit's correction and error 5, the upper's 4
POS_LIMIT_OPS, POS_LOWER_OPS, POS_UPPER_OPS = 9, 5, 4
#   _integrate: the translation clamp's sqrt and division 2, the rotation's 1
#   _contact_data: the block determinant 3 where the block is ill-conditioned
TRANSLATION_CLAMP, ROTATION_CLAMP, BLOCK_DET = 2, 1, 3


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
    """``(bytes, operations)`` of a call on ``n`` envs: every input read
    once and every output written once, and the plain version's float32
    operations in the passes run.  ``vel_iters`` and ``pos_iters`` are the
    passes every env runs, or ``(n,)`` counts per env (what a call with
    ``vel_tol > 0`` and the position loop's early exit ran:
    ``return_iters`` and :func:`position_passes`).  ``return_iters`` adds the int32 count written
    per env."""
    vel, pos = _total(vel_iters, n), _total(pos_iters, n)
    per_vel = VEL_PASS_OPS + (VEL_TOL_PASS_OPS if vel_tol > 0 else 0)
    nbytes = n * (READ_BYTES + WRITE_BYTES + (4 if return_iters else 0))
    return nbytes, n * FRAME_OPS + vel * per_vel + pos * POS_PASS_OPS


def needed_work(
    hull, leg1, leg2, terrain, fx, fy, torque, gravity: float, acc, pos_passes,
    dt: float = 1.0 / ls.FPS, vel_iters: int = ls.VEL_ITERS, pos_iters: int = ls.POS_ITERS,
    vel_tol: float = 0.0, return_iters: bool = False,
) -> Tuple[int, int]:
    """For measurements, not on the main path: ``(bytes, operations)`` the
    call needs on this data, the yardstick of S1's bound.  The bytes and the
    passes are :func:`assembly_step_work`'s (``pos_passes``, ``(N,)``, the
    position passes each env ran: :func:`position_passes`); of the
    operations, those that the plain version's selects drop are left out,
    and sin and cos count once an env and angle (by its bits).

    Runs the plain version once on the same inputs, recording each select's
    condition where it is made (the branches of ``JOINT_DROPS`` and the
    rest above) and each sin and cos input.  The per-frame terms that feed
    only some passes' branches (the 2x2 determinant of a limit never
    violated, 4 a joint; the first two cofactor rows of a limit violated in
    every pass, 18) are still counted: at most 36 of an env's ~895 a frame."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = hull.cx.shape[0]
    device = hull.cx.device
    pos_passes = torch.as_tensor(pos_passes, device=device)
    state = {"conds": None, "vel": 0, "pos": -1}
    drops = []  # (velocity pass or None, position pass or None, (N,) operations)
    trig = []  # (function, position pass, input)

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name == "where" and state["conds"] is not None:
                state["conds"].append(args[0])
            elif name in ("sin", "cos"):
                trig.append((name, state["pos"], args[0]))
            return func(*args, **(kwargs or {}))

    def per_env(x):  # an (N,) or (2N,) count as (N,)
        return x.view(-1, n).sum(0)

    def i64(x):
        return x.to(torch.int64)

    def joint(conds, hv, lv, j, acc, dt):
        assert len(conds) == 6 and torch.equal(conds[3], j["limit_active"]), "_solve_joint"
        viol, active = conds[0], conds[3]
        ops = torch.where(~active, JOINT_DROPS["inactive"],
                          torch.where(viol, JOINT_DROPS["violated"], JOINT_DROPS["active"]))
        if state["vel"] == 0:
            ops = ops + JOINT_FRAME_DROP * i64(~active)
        drops.append((state["vel"], None, i64(ops)))

    def contacts(conds, lv, c, d, acc):
        assert len(conds) == 10 and torch.equal(conds[8], d["both"]), "_solve_contacts"
        ok_2, ok_b = conds[2], conds[3]
        block = BLOCK_CASE1 + BLOCK_CASE_OPS * (i64(~ok_b) + i64(~ok_b & ~ok_2))
        ops = torch.where(d["both"], SEQUENTIAL_OPS + BLOCK_OPS - block, BLOCK_OPS)
        drops.append((state["vel"], None, per_env(ops)))
        state["vel"] += 1

    def pos_contact(conds, lp, c):
        assert len(conds) == 4 and torch.equal(conds[0], c.active1), "_pos_contact"
        ops = POS_CORNER_DROP * (i64(~conds[0]) + i64(~conds[2]))
        drops.append((None, state["pos"], per_env(ops)))

    def pos_joint(conds, hp, lp, side):
        assert len(conds) == 5, "_pos_joint"
        at_upper, at_lower = conds[0], conds[1]
        kept = torch.where(at_lower, POS_LOWER_OPS, torch.where(at_upper, POS_UPPER_OPS, 0))
        drops.append((None, state["pos"], i64(POS_LIMIT_OPS - kept)))

    def integrate(conds, b, dt):
        assert len(conds) == 2, "_integrate"
        ops = TRANSLATION_CLAMP * i64(~conds[0]) + ROTATION_CLAMP * i64(~conds[1])
        drops.append((None, None, per_env(ops)))

    def contact_data(conds, legs, c):
        assert len(conds) == 1, "_contact_data"
        drops.append((None, None, per_env(BLOCK_DET * i64(~conds[0]))))

    def site(fn, count, before=None):
        def run(*args):
            if before is not None:
                before()
            state["conds"] = []
            out = fn(*args)
            conds, state["conds"] = state["conds"], None
            count(conds, *args)
            return out
        return run

    def next_pos():
        state["pos"] += 1

    sites = {"_solve_joint": (joint, None), "_solve_contacts": (contacts, None),
             "_pos_contact": (pos_contact, next_pos), "_pos_joint": (pos_joint, None),
             "_integrate": (integrate, None), "_contact_data": (contact_data, None)}
    saved = {name: getattr(ls, name) for name in sites}
    try:
        for name, (count, before) in sites.items():
            setattr(ls, name, site(saved[name], count, before))
        with Record():
            out = ls.assembly_step_reference(
                hull, leg1, leg2, terrain, fx, fy, torque, gravity, acc=acc, dt=dt,
                vel_iters=vel_iters, pos_iters=pos_iters, vel_tol=vel_tol, return_iters=True)
    finally:
        for name, fn in saved.items():
            setattr(ls, name, fn)
    vel_passes = out[8]

    dropped = torch.zeros(n, dtype=torch.int64, device=device)
    for vel, pos, ops in drops:
        if vel is not None:
            ops = ops * (vel < vel_passes)
        elif pos is not None:
            ops = ops * (pos < pos_passes)
        dropped += ops
    # sin and cos: every call of the passes run, less one an env and angle
    for name in ("sin", "cos"):
        keys = []
        for fn, pos, x in trig:
            if fn != name:
                continue
            rows = x.reshape(x.shape[0], -1)
            env = (torch.arange(rows.shape[0], device=device) % n)[:, None].expand_as(rows)
            ran = pos < pos_passes[env] if pos >= 0 else torch.ones_like(env, dtype=torch.bool)
            dropped += torch.bincount(env[ran], minlength=n)
            bits = rows.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            keys.append((env * 2**32 + bits)[ran])
        env_of = torch.unique(torch.cat(keys)) // 2**32
        dropped -= torch.bincount(env_of, minlength=n)

    nbytes, ops = assembly_step_work(n, vel_passes, pos_passes, vel_tol, return_iters)
    return nbytes, ops - int(dropped.sum())


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


def sqrt_threshold(slop: float) -> float:
    """The largest float32 x whose float32 square root is at most
    float32(slop): since a correctly rounded square root is monotone,
    ``sqrtf(x) <= slop`` holds exactly when ``x <= sqrt_threshold(slop)``
    (for every float32 x, NaN included), which lets the kernel's position
    pass test its joints' errors without the square root."""
    s = np.float32(slop)
    up = np.float32(np.inf)
    x = np.float32(s * s)
    while np.sqrt(np.nextafter(x, up)) <= s:
        x = np.nextafter(x, up)
    while np.sqrt(x) > s:
        x = np.nextafter(x, np.float32(0.0))
    return float(x)


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
        linear_slop_sq=sqrt_threshold(ls.LINEAR_SLOP),
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
    lib.fast_math_check_launch.argtypes = [ptr, ptr]
    lib.fast_math_check_launch.restype = i32
    check_sizes(lib)
    return lib


# floats the check below covers: every |a| < 105615 (kTrigFast) and every
# 2^-40 <= |b| <= 2^40 (kDivisorLo, kDivisorHi), both signs
FAST_MATH_VALUES = {
    "sincos": 2 * int(np.array(105615.0, np.float32).view(np.uint32)),
    "reciprocal": 2 * int(np.array(2.0**40, np.float32).view(np.uint32)
                          - np.array(2.0**-40, np.float32).view(np.uint32) + 1),
}


def fast_math_mismatches(device="cuda") -> dict:
    """For checks, not on any path of the program: the floats of each range
    (``FAST_MATH_VALUES``) whose branch-free result in the kernels' passes
    differs from the card's own in any bit: ``lander_solver.cuh::
    sincos_poly`` against ``sincosf``, and ``divisor_of``'s reciprocal
    against ``1.0f / b``.  Both must be 0 for S1 and J1 to keep their bits."""
    if _device_kind(torch.device(device)) != "cuda":
        raise ValueError("the check runs on the card")
    lib = _lib()
    out = torch.zeros((2,), dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _launch(lib.fast_math_check_launch, out.data_ptr(), stream)
    sincos, reciprocal = out.tolist()
    return {"sincos": sincos, "reciprocal": reciprocal}


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
