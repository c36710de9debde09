"""Jointed 3-body impulse solver for the LunarLander assembly, in batched
PyTorch — ``deep_q_learning_tpu/envs/lander_solver.py``.

The JAX module documents the model and carries its Box2D validation: the
hull and two legs on motorized revolute joints with angle limits, leg
boxes against the terrain with friction, stepped by Box2D 2.3.5's
sequential-impulse solver (velocity iterations over joints then contacts,
warm-started from the last frame's impulses; position iterations with
Box2D's early exit; the island sleep test).  This module ports it
operation for operation, with a leading ``N`` (env) axis on every tensor,
and is held against the JAX functions on matched states
(``tests/test_torch_lander_solver.py``), not against Box2D again.

Where it differs in form, the values are the same:

  * lookups by index are ``torch.gather``; the JAX module's one-hot
    contractions (``_onehot_pick``) work around the TPU's slow gathers and
    select the same elements;
  * within one velocity iteration the two legs' contact manifolds touch
    only their own leg, so both legs run as one batch of ``2N`` lanes
    (leg 1 first), which halves the contact solver's launches.  The
    joints share the hull and stay sequential, joint 1 then joint 2, as in
    Box2D;
  * terms that do not change over the iterations (the joints' 3x3
    cofactors, the contacts' cross terms) are computed once per frame;
  * the position loop runs every pass with the per-lane "done" mask, see
    ``assembly_step``.

Everything here is elementwise PyTorch: a frame at the preset iteration
counts is tens of thousands of kernel launches.  On the card the step
runs as one kernel instead, S1 (``csrc/lander_solver.cu``, bound in
``ops/solver_kernels.py``), which computes the same operations for one env
per thread: :func:`assembly_step` launches it on CUDA tensors and runs
:func:`assembly_step_reference`, the plain version kept here, on CPU
tensors.  The lander's step on the card runs S1's body inside its own
kernel, J1 (``ops/jointed_kernels.py``), so S1's launch serves its checks
and the plain jointed step (``LunarLander.step_env_reference``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# ---------------------------------------------------------------- world spec
FPS = 50.0
SCALE = 30.0
W = 600.0 / SCALE
CHUNKS = 11

# ------------------------------------------------- measured body constants
# (pybox2d 2.3.5 b2Body mass / COM inertia / localCenter of the published
# fixtures; provenance and the GetInertia trap: the JAX module)
HULL_M = 4.816666603088379
HULL_I = 0.8333148956298828 - HULL_M * 0.10130719095468521**2  # = 0.783881
HULL_CX, HULL_CY = 0.0, 0.10130719095468521  # localCenter (body frame)
LEG_M = 0.07111112028360367
LEG_I = 0.0017909470479935408  # about the leg COM (= leg origin)
LEG_HW = 2.0 / SCALE  # box half extents
LEG_HH = 8.0 / SCALE
LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
MU = 0.14142136  # sqrt(leg 0.2 x ground 0.1) — b2MixFriction

IMH, IIH = 1.0 / HULL_M, 1.0 / HULL_I
IML, IIL = 1.0 / LEG_M, 1.0 / LEG_I

# joints: leg i=-1 limits [0.4, 0.9] motorSpeed -0.3; i=+1 mirrored
MOTOR_TORQUE = 40.0
MOTOR_MASS = 1.0 / (IIH + IIL)

# ------------------------------------------------------- b2Settings (2.3.5)
TOTAL_RADIUS = 0.02  # b2_polygonRadius (0.01) x2: edge + polygon skins
LINEAR_SLOP = 0.005
ANGULAR_SLOP = 0.03490658503988889
BAUMGARTE = 0.2
MAX_LINEAR_CORRECTION = 0.2
MAX_ANGULAR_CORRECTION = 0.13962634015955555
MAX_TRANSLATION = 2.0
MAX_ROTATION = 1.570796326795
LIN_SLEEP_TOL = 0.01
ANG_SLEEP_TOL = 0.03490658503988889
SLEEP_FRAMES = 25  # b2_timeToSleep 0.5 s at 50 FPS

# gym's world.Step(1/FPS, 6*30, 2*30); presets may lower them (not below ~60
# velocity iterations: the joints give way, tests/test_lander_solver.py)
VEL_ITERS = 180
POS_ITERS = 60

# hull polygon vertices (body frame, m) for ground-contact detection
HULL_VERTS = tuple(
    (x / SCALE, y / SCALE)
    for x, y in ((-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17))
)


@dataclasses.dataclass
class Body:
    """Rigid bodies, one per env: COM world position, angle, COM linear
    velocity, angular velocity; each field ``(N,)`` float32."""

    cx: torch.Tensor
    cy: torch.Tensor
    a: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    w: torch.Tensor


@dataclasses.dataclass
class AssemblyAcc:
    """Warm-start accumulators carried across frames (b2's joint impulse and
    motor impulse, the contact normal and tangent impulses, and the joint
    limit state that gates the reset of the limit impulse)."""

    j1: torch.Tensor  # (N, 4) f32 [px, py, z, motor] of the side=-1 joint
    j2: torch.Tensor  # (N, 4) f32
    s1: torch.Tensor  # (N,) int32 limit state: -1 atLower / 0 inactive / +1 atUpper
    s2: torch.Tensor
    c1: torch.Tensor  # (N, 4, 2) f32 per-corner [normal, tangent] impulse, leg 1
    c2: torch.Tensor  # (N, 4, 2) f32


@dataclasses.dataclass
class LegContacts:
    """Up to two contact points for each leg box (its two deepest corners);
    every field ``(N,)``."""

    active1: torch.Tensor  # bool
    active2: torch.Tensor
    # contact frame (shared segment => same normal; else per point)
    nx1: torch.Tensor
    ny1: torch.Tensor
    nx2: torch.Tensor
    ny2: torch.Tensor
    # world corner points
    px1: torch.Tensor
    py1: torch.Tensor
    px2: torch.Tensor
    py2: torch.Tensor
    # corner locations in the leg's body frame (position re-projection)
    lx1: torch.Tensor
    ly1: torch.Tensor
    lx2: torch.Tensor
    ly2: torch.Tensor
    # supporting segment reference (position re-projection)
    sx1: torch.Tensor
    sh1: torch.Tensor
    sx2: torch.Tensor
    sh2: torch.Tensor
    block: torch.Tensor  # bool: both points on one segment -> 2x2 block solve
    idx1: torch.Tensor  # int64 corner index (0..3): warm-start identity
    idx2: torch.Tensor


def zero_acc(n: int, device=None) -> AssemblyAcc:
    """Accumulators of ``n`` fresh assemblies."""

    def z(*shape, dtype=torch.float32):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    return AssemblyAcc(
        j1=z(4), j2=z(4), s1=z(dtype=torch.int32), s2=z(dtype=torch.int32),
        c1=z(4, 2), c2=z(4, 2),
    )


def rot(a, x, y):
    c, s = torch.cos(a), torch.sin(a)
    return c * x - s * y, s * x + c * y


def hull_com(x, y, a):
    """Hull COM world position from the body-origin position gym reports."""
    ox, oy = rot(a, HULL_CX, HULL_CY)
    return x + ox, y + oy


def hull_origin(cx, cy, a):
    ox, oy = rot(a, HULL_CX, HULL_CY)
    return cx - ox, cy - oy


def _f32_product(a: float, b: float) -> float:
    """``a * b`` rounded as a float32 product of float32 operands — the
    value the JAX env gets from a float32 param times a Python constant."""
    return float(np.float32(a) * np.float32(b))


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` rounded once (PyTorch's ``float / tensor`` multiplies by
    the reciprocal, which rounds twice)."""
    return torch.full_like(t, num) / t


# --------------------------------------------------------------- terrain geom
def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[n, idx[n, ...]]`` for a ``(N, K)`` table and ``(N, ...)``
    int64 indices."""
    return table.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _segment(terrain, x):
    """Supporting terrain segment under world x: (index, x1, h1, nx, ny) with
    the unit normal pointing up (edge fixtures run left->right)."""
    chunk_w = W / (CHUNKS - 1)
    i0 = torch.clamp(torch.floor(x / chunk_w).to(torch.int64), 0, CHUNKS - 2)
    h1 = _take(terrain, i0)
    h2 = _take(terrain, i0 + 1)
    dy = h2 - h1
    inv = 1.0 / torch.sqrt(chunk_w * chunk_w + dy * dy)
    return i0, i0.to(torch.float32) * chunk_w, h1, -dy * inv, chunk_w * inv


def _corner_sep(terrain, px, py):
    """Effective separation (skin-adjusted) of a world point vs its
    supporting segment; returns (seg_idx, sep, x1, h1, nx, ny)."""
    seg, x1, h1, nx, ny = _segment(terrain, px)
    sep = (px - x1) * nx + (py - h1) * ny - TOTAL_RADIUS
    return seg, sep, x1, h1, nx, ny


def collide_leg(terrain: torch.Tensor, leg: Body) -> Tuple[LegContacts, torch.Tensor]:
    """Manifold for each leg box vs its terrain ``(N, CHUNKS)``: the two
    deepest of the four box corners.  Returns (contacts, touching) where
    touching mirrors gym's ``leg.ground_contact`` (any manifold point)."""
    corner = torch.arange(4, device=leg.cx.device)
    cxs = torch.where(corner % 2 == 0, -LEG_HW, LEG_HW).expand(leg.cx.shape[0], 4)
    cys = torch.where(corner < 2, -LEG_HH, LEG_HH).expand(leg.cx.shape[0], 4)
    wx, wy = rot(leg.a[:, None], cxs, cys)
    px = leg.cx[:, None] + wx
    py = leg.cy[:, None] + wy
    seg, sep, x1, h1, nx, ny = _corner_sep(terrain, px, py)

    # torch.argmin returns the first of equal minima, as jnp.argmin does
    # (a level leg on flat terrain has two corners at one depth)
    first = torch.argmin(sep, dim=1)
    masked = torch.where(corner == first[:, None], torch.inf, sep)
    second = torch.argmin(masked, dim=1)

    def pick(arr, idx):
        return arr.gather(1, idx[:, None])[:, 0]

    s1, s2 = pick(sep, first), pick(sep, second)
    c = LegContacts(
        active1=s1 <= 0.0,
        active2=s2 <= 0.0,
        nx1=pick(nx, first),
        ny1=pick(ny, first),
        nx2=pick(nx, second),
        ny2=pick(ny, second),
        px1=pick(px, first),
        py1=pick(py, first),
        px2=pick(px, second),
        py2=pick(py, second),
        lx1=pick(cxs, first),
        ly1=pick(cys, first),
        lx2=pick(cxs, second),
        ly2=pick(cys, second),
        sx1=pick(x1, first),
        sh1=pick(h1, first),
        sx2=pick(x1, second),
        sh2=pick(h1, second),
        block=pick(seg, first) == pick(seg, second),
        idx1=first,
        idx2=second,
    )
    return c, c.active1 | c.active2


def hull_touches(terrain: torch.Tensor, hull: Body) -> torch.Tensor:
    """Any hull polygon vertex within contact range of the terrain — gym's
    ``game_over`` BeginContact trigger."""
    c, s = torch.cos(hull.a), torch.sin(hull.a)
    hit = torch.zeros_like(hull.cx, dtype=torch.bool)
    for bx, by in HULL_VERTS:
        lx, ly = bx - HULL_CX, by - HULL_CY  # vertex relative to hull COM
        wx, wy = c * lx - s * ly, s * lx + c * ly
        _, sep, *_ = _corner_sep(terrain, hull.cx + wx, hull.cy + wy)
        hit = hit | (sep <= 0.0)
    return hit


# ------------------------------------------------------ per-frame constants
def _joint_data(ha, la, side: float) -> dict:
    """A revolute joint's arms, effective-mass terms and limit state at the
    start-of-step angles; the 3x3 and 2x2 solve terms the velocity
    iterations reuse."""
    rax, ray = rot(ha, 0.0 - HULL_CX, 0.0 - HULL_CY)  # anchor A = hull origin
    rbx, rby = rot(la, side * LEG_AWAY, LEG_DOWN)
    k11 = IMH + IML + IIH * ray * ray + IIL * rby * rby
    k12 = -IIH * rax * ray - IIL * rbx * rby
    k13 = -IIH * ray - IIL * rby
    k22 = IMH + IML + IIH * rax * rax + IIL * rbx * rbx
    k23 = IIH * rax + IIL * rbx
    k33 = IIH + IIL
    # pybox2d sets referenceAngle = angleB - angleA = i*0.05 at creation,
    # so the limit engages at rel = limit + i*0.05 (the JAX module)
    angle = la - ha - side * 0.05
    lower, upper = (0.4, 0.9) if side < 0 else (-0.9, -0.4)
    at_lower = angle <= lower
    at_upper = angle >= upper
    st = torch.where(at_lower, -1, torch.where(at_upper, 1, 0)).to(torch.int32)
    det3 = (
        k11 * (k22 * k33 - k23 * k23)
        - k12 * (k12 * k33 - k23 * k13)
        + k13 * (k12 * k23 - k22 * k13)
    )
    det2 = k11 * k22 - k12 * k12
    return dict(
        rax=rax, ray=ray, rbx=rbx, rby=rby,
        k11=k11, k12=k12, k13=k13, k22=k22, k23=k23,
        at_lower=at_lower, at_upper=at_upper, limit_active=at_lower | at_upper, st=st,
        motor_speed=0.3 * side,
        det3=torch.where(det3.abs() > 1e-12, det3, 1.0),
        det2=torch.where(det2.abs() > 1e-12, det2, 1.0),
        # Solve33 cofactors, row by row (b = -Cdot)
        c11=k22 * k33 - k23 * k23, c12=k13 * k23 - k12 * k33, c13=k12 * k23 - k13 * k22,
        c21=k23 * k13 - k12 * k33, c22=k11 * k33 - k13 * k13, c23=k13 * k12 - k11 * k23,
        c31=k12 * k23 - k22 * k13, c32=k12 * k13 - k11 * k23, c33=k11 * k22 - k12 * k12,
    )


def _contact_data(legs: Body, c: LegContacts) -> dict:
    r1x, r1y = c.px1 - legs.cx, c.py1 - legs.cy
    r2x, r2y = c.px2 - legs.cx, c.py2 - legs.cy
    cn1 = r1x * c.ny1 - r1y * c.nx1  # cross(r, n)
    cn2 = r2x * c.ny2 - r2y * c.nx2
    # tangent = cross(n, 1) = (ny, -nx)
    ct1 = r1x * (-c.nx1) - r1y * c.ny1
    ct2 = r2x * (-c.nx2) - r2y * c.ny2
    k11 = IML + IIL * cn1 * cn1
    k22 = IML + IIL * cn2 * cn2
    k12 = IML + IIL * cn1 * cn2
    # b2: fall back to sequential when the block K is ill-conditioned
    block_ok = c.block & (k11 * k22 - k12 * k12 > 1e-3 * k11 * k22)
    return dict(
        r1x=r1x, r1y=r1y, r2x=r2x, r2y=r2y, cn1=cn1, cn2=cn2,
        nm1=1.0 / (IML + IIL * cn1 * cn1),
        nm2=1.0 / (IML + IIL * cn2 * cn2),
        neg_tm1=-(1.0 / (IML + IIL * ct1 * ct1)),
        neg_tm2=-(1.0 / (IML + IIL * ct2 * ct2)),
        k11=k11, k22=k22, k12=k12, neg_k22=-k22,
        det=torch.where(block_ok, k11 * k22 - k12 * k12, 1.0),
        both=c.active1 & c.active2 & block_ok,
        f1=c.active1.to(torch.float32), f2=c.active2.to(torch.float32),
        # the sequential path's coupling of point 2 to point 1's impulse
        dot12=c.nx1 * c.nx2 + c.ny1 * c.ny2,
        iil_cn12=IIL * cn1 * cn2,
    )


# ------------------------------------------------------ velocity iterations
def _solve_joint(hv, lv, j, acc, dt):
    """One revolute-joint velocity iteration (b2RevoluteJoint 2.3.5)."""
    hvx, hvy, hw = hv
    lvx, lvy, lw = lv
    px_a, py_a, z_a, m_a = acc
    # motor (skipped only for equal limits, which never happens here)
    cdot = lw - hw - j["motor_speed"]
    imp = -MOTOR_MASS * cdot
    max_imp = dt * MOTOR_TORQUE
    new_m = torch.clamp(m_a + imp, -max_imp, max_imp)
    imp = new_m - m_a
    m_a = new_m
    hw = hw - IIH * imp
    lw = lw + IIL * imp

    # Cdot of the point constraint (after the motor update)
    bx = -(lvx - lw * j["rby"] - hvx + hw * j["ray"])
    by = -(lvy + lw * j["rbx"] - hvy - hw * j["rax"])
    bz = -(lw - hw)
    # --- limit+point 3x3 branch: Solve33 via cofactors
    det3 = j["det3"]
    ix = (bx * j["c11"] + by * j["c12"] + bz * j["c13"]) / det3
    iy = (bx * j["c21"] + by * j["c22"] + bz * j["c23"]) / det3
    iz = (bx * j["c31"] + by * j["c32"] + bz * j["c33"]) / det3
    new_z = z_a + iz
    # clamp cases: atLower requires accumulated z >= 0; atUpper z <= 0
    viol = (j["at_lower"] & (new_z < 0.0)) | (j["at_upper"] & (new_z > 0.0))
    # reduced 2x2 solve holding z at -z_a (b2's rhs trick)
    k11, k12, k22, det2 = j["k11"], j["k12"], j["k22"], j["det2"]
    rx = bx + z_a * j["k13"]
    ry = by + z_a * j["k23"]
    ix_l = torch.where(viol, (k22 * rx - k12 * ry) / det2, ix)
    iy_l = torch.where(viol, (k11 * ry - k12 * rx) / det2, iy)
    iz_l = torch.where(viol, -z_a, iz)
    # --- point-only 2x2 branch (limit inactive)
    ix_p = (k22 * bx - k12 * by) / det2
    iy_p = (k11 * by - k12 * bx) / det2

    active = j["limit_active"]
    dpx = torch.where(active, ix_l, ix_p)
    dpy = torch.where(active, iy_l, iy_p)
    dz = torch.where(active, iz_l, 0.0)

    px_a = px_a + dpx
    py_a = py_a + dpy
    z_a = z_a + dz
    hvx = hvx - IMH * dpx
    hvy = hvy - IMH * dpy
    hw = hw - IIH * (j["rax"] * dpy - j["ray"] * dpx + dz)
    lvx = lvx + IML * dpx
    lvy = lvy + IML * dpy
    lw = lw + IIL * (j["rbx"] * dpy - j["rby"] * dpx + dz)
    return (hvx, hvy, hw), (lvx, lvy, lw), (px_a, py_a, z_a, m_a)


def _solve_contacts(lv, c: LegContacts, d, acc):
    """One contact-manifold velocity iteration: friction per point, then
    normal (2x2 block when both points share a segment)."""
    lvx, lvy, lw = lv
    n1_a, n2_a, t1_a, t2_a = acc
    f1, f2 = d["f1"], d["f2"]

    # friction point 1 (tangent = (ny, -nx))
    tx1, ty1 = c.ny1, -c.nx1
    vt = (lvx - lw * d["r1y"]) * tx1 + (lvy + lw * d["r1x"]) * ty1
    lam = d["neg_tm1"] * vt
    max_f = MU * n1_a
    new_t = torch.clamp(t1_a + lam, -max_f, max_f)
    lam = (new_t - t1_a) * f1
    t1_a = t1_a + lam
    lvx = lvx + IML * lam * tx1
    lvy = lvy + IML * lam * ty1
    lw = lw + IIL * (d["r1x"] * lam * ty1 - d["r1y"] * lam * tx1)
    # friction point 2
    tx2, ty2 = c.ny2, -c.nx2
    vt = (lvx - lw * d["r2y"]) * tx2 + (lvy + lw * d["r2x"]) * ty2
    lam = d["neg_tm2"] * vt
    max_f = MU * n2_a
    new_t = torch.clamp(t2_a + lam, -max_f, max_f)
    lam = (new_t - t2_a) * f2
    t2_a = t2_a + lam
    lvx = lvx + IML * lam * tx2
    lvy = lvy + IML * lam * ty2
    lw = lw + IIL * (d["r2x"] * lam * ty2 - d["r2y"] * lam * tx2)

    # normal: block solve over accumulated impulses when both active
    vn1 = (lvx - lw * d["r1y"]) * c.nx1 + (lvy + lw * d["r1x"]) * c.ny1
    vn2 = (lvx - lw * d["r2y"]) * c.nx2 + (lvy + lw * d["r2x"]) * c.ny2
    k11, k12, k22 = d["k11"], d["k12"], d["k22"]
    # b = vn - K @ a
    b1 = vn1 - (k11 * n1_a + k12 * n2_a)
    b2 = vn2 - (k12 * n1_a + k22 * n2_a)
    # case enumeration as b2ContactSolver: the first matching case wins; if
    # none matches the accumulated impulses are kept, like Box2D's break
    x1_b = (d["neg_k22"] * b1 + k12 * b2) / d["det"]
    x2_b = (k12 * b1 - k11 * b2) / d["det"]
    ok_b = (x1_b >= 0.0) & (x2_b >= 0.0)  # case 1: both pushing
    x1_2 = -b1 * d["nm1"]  # case 2: point 1 only (vn2 must separate)
    ok_2 = (x1_2 >= 0.0) & (k12 * x1_2 + b2 >= 0.0)
    x2_3 = -b2 * d["nm2"]  # case 3: point 2 only
    ok_3 = (x2_3 >= 0.0) & (k12 * x2_3 + b1 >= 0.0)
    ok_4 = (b1 >= 0.0) & (b2 >= 0.0)  # case 4: both separating
    x1_blk = torch.where(
        ok_b, x1_b,
        torch.where(ok_2, x1_2, torch.where(ok_3, 0.0, torch.where(ok_4, 0.0, n1_a))),
    )
    x2_blk = torch.where(
        ok_b, x2_b,
        torch.where(ok_2, 0.0, torch.where(ok_3, x2_3, torch.where(ok_4, 0.0, n2_a))),
    )
    # sequential fallback (separate manifolds / ill-conditioned K)
    x1_seq = torch.clamp(n1_a - vn1 * d["nm1"], min=0.0)
    # vn2 after point 1's delta, for the sequential path
    d1s = (x1_seq - n1_a) * f1
    vn2_s = vn2 + (IML * d1s * d["dot12"] + d["iil_cn12"] * d1s)
    x2_seq = torch.clamp(n2_a - vn2_s * d["nm2"], min=0.0)
    x1 = torch.where(d["both"], x1_blk, x1_seq) * f1
    x2 = torch.where(d["both"], x2_blk, x2_seq) * f2
    dn1, dn2 = x1 - n1_a, x2 - n2_a
    lvx = lvx + IML * (dn1 * c.nx1 + dn2 * c.nx2)
    lvy = lvy + IML * (dn1 * c.ny1 + dn2 * c.ny2)
    lw = lw + IIL * (d["cn1"] * dn1 + d["cn2"] * dn2)
    return (lvx, lvy, lw), (x1, x2, t1_a, t2_a)


def _vel_iteration(hv, lv, j1, j2, c, d, ja1, ja2, ca, n, dt):
    """One velocity iteration in Box2D's island order: joint 1, joint 2,
    then both legs' contacts (one batch of 2N lanes, leg 1 first)."""
    hv, l1v, ja1 = _solve_joint(hv, tuple(x[:n] for x in lv), j1, ja1, dt)
    hv, l2v, ja2 = _solve_joint(hv, tuple(x[n:] for x in lv), j2, ja2, dt)
    lv = tuple(torch.cat([a, b]) for a, b in zip(l1v, l2v))
    lv, ca = _solve_contacts(lv, c, d, ca)
    return hv, lv, ja1, ja2, ca


def _warm_start(hv, lv, j1, j2, c, d, acc, n):
    """b2 InitVelocityConstraints: apply last frame's accumulated impulses
    and carry them into the iterations.  This is what makes statics work at
    finite iteration counts: the steady-state impulses build up across
    frames."""

    def joint_acc(j, stored, prev_st):
        # b2 resets the limit impulse when the limit state changed
        z = torch.where((j["st"] == prev_st) & (j["st"] != 0), stored[:, 2], 0.0)
        return stored[:, 0], stored[:, 1], z, stored[:, 3]

    def apply_joint(hv, lv, j, accj):
        px, py, z, m = accj
        (hvx, hvy, hw), (lvx, lvy, lw) = hv, lv
        hvx = hvx - IMH * px
        hvy = hvy - IMH * py
        hw = hw - IIH * (j["rax"] * py - j["ray"] * px + m + z)
        lvx = lvx + IML * px
        lvy = lvy + IML * py
        lw = lw + IIL * (j["rbx"] * py - j["rby"] * px + m + z)
        return (hvx, hvy, hw), (lvx, lvy, lw)

    ja1 = joint_acc(j1, acc.j1, acc.s1)
    ja2 = joint_acc(j2, acc.j2, acc.s2)
    hv, l1v = apply_joint(hv, tuple(x[:n] for x in lv), j1, ja1)
    hv, l2v = apply_joint(hv, tuple(x[n:] for x in lv), j2, ja2)
    lvx, lvy, lw = (torch.cat([a, b]) for a, b in zip(l1v, l2v))

    # stored impulses of the corners that are this frame's manifold points
    stored = torch.cat([acc.c1, acc.c2])
    p1 = stored.gather(1, c.idx1[:, None, None].expand(-1, 1, 2))[:, 0]
    p2 = stored.gather(1, c.idx2[:, None, None].expand(-1, 1, 2))[:, 0]
    n1a, n2a = p1[:, 0] * d["f1"], p2[:, 0] * d["f2"]
    t1a, t2a = p1[:, 1] * d["f1"], p2[:, 1] * d["f2"]
    p1x = n1a * c.nx1 + t1a * c.ny1
    p1y = n1a * c.ny1 + t1a * (-c.nx1)
    p2x = n2a * c.nx2 + t2a * c.ny2
    p2y = n2a * c.ny2 + t2a * (-c.nx2)
    lvx = lvx + IML * (p1x + p2x)
    lvy = lvy + IML * (p1y + p2y)
    lw = lw + IIL * (d["r1x"] * p1y - d["r1y"] * p1x + d["r2x"] * p2y - d["r2y"] * p2x)
    return hv, (lvx, lvy, lw), ja1, ja2, (n1a, n2a, t1a, t2a)


def _pack_contact(c: LegContacts, ca) -> torch.Tensor:
    """Per-corner ``(2N, 4, 2)`` [normal, tangent] impulses for the next
    frame's warm start: idx1 != idx2, so the two rows are disjoint."""
    n1a, n2a, t1a, t2a = ca
    p1 = torch.stack([n1a, t1a], -1) * c.active1.to(torch.float32)[:, None]
    p2 = torch.stack([n2a, t2a], -1) * c.active2.to(torch.float32)[:, None]
    corner = torch.arange(4, device=n1a.device)
    oh1 = (c.idx1[:, None] == corner).to(torch.float32)
    oh2 = (c.idx2[:, None] == corner).to(torch.float32)
    return oh1[:, :, None] * p1[:, None, :] + oh2[:, :, None] * p2[:, None, :]


# ------------------------------------------------------ position iterations
def _integrate(b: Body, dt: float) -> Body:
    """Positions from velocities, with b2's translation/rotation clamps."""
    t2 = (b.vx * b.vx + b.vy * b.vy) * dt * dt
    ratio = torch.where(t2 > MAX_TRANSLATION**2, _div(MAX_TRANSLATION, torch.sqrt(t2)), 1.0)
    vx, vy = b.vx * ratio, b.vy * ratio
    r = torch.abs(b.w * dt)
    w = b.w * torch.where(r > MAX_ROTATION, _div(MAX_ROTATION, r), 1.0)
    return Body(cx=b.cx + vx * dt, cy=b.cy + vy * dt, a=b.a + w * dt, vx=vx, vy=vy, w=w)


def _pos_contact(lp, c: LegContacts):
    """One manifold's position correction (sequential over its points).
    Returns the pass's minimum pre-correction separation, which b2 uses for
    the position loop's early exit."""
    lcx, lcy, la = lp
    min_sep = torch.zeros_like(lcx)
    for active, lx, ly, sx, sh, nx, ny in (
        (c.active1, c.lx1, c.ly1, c.sx1, c.sh1, c.nx1, c.ny1),
        (c.active2, c.lx2, c.ly2, c.sx2, c.sh2, c.nx2, c.ny2),
    ):
        wxp, wyp = rot(la, lx, ly)
        px, py = lcx + wxp, lcy + wyp
        sep = (px - sx) * nx + (py - sh) * ny - TOTAL_RADIUS
        min_sep = torch.minimum(min_sep, torch.where(active, sep, 0.0))
        C = torch.clamp(BAUMGARTE * (sep + LINEAR_SLOP), -MAX_LINEAR_CORRECTION, 0.0)
        rx, ry = px - lcx, py - lcy
        cn = rx * ny - ry * nx
        K = IML + IIL * cn * cn
        imp = torch.where(active, -C / K, 0.0)
        lcx = lcx + IML * imp * nx
        lcy = lcy + IML * imp * ny
        la = la + IIL * cn * imp
    return (lcx, lcy, la), min_sep


def _pos_joint(hp, lp, side: float):
    """One revolute joint position correction (limit then point).  Returns
    (hp, lp, position_error, angular_error): b2's early-exit tolerances are
    checked on the pre-correction errors."""
    hcx, hcy, ha = hp
    lcx, lcy, la = lp
    angle = la - ha - side * 0.05  # referenceAngle = i*0.05 (see _joint_data)
    lower, upper = (0.4, 0.9) if side < 0 else (-0.9, -0.4)
    at_lower = angle <= lower
    at_upper = angle >= upper
    C_low = torch.clamp((angle - lower) + ANGULAR_SLOP, -MAX_ANGULAR_CORRECTION, 0.0)
    C_up = torch.clamp((angle - upper) - ANGULAR_SLOP, 0.0, MAX_ANGULAR_CORRECTION)
    C = torch.where(at_lower, C_low, torch.where(at_upper, C_up, 0.0))
    ang_err = torch.where(at_lower, -(angle - lower), torch.where(at_upper, angle - upper, 0.0))
    limit_imp = -MOTOR_MASS * C
    ha = ha - IIH * limit_imp
    la = la + IIL * limit_imp
    # point constraint
    rax, ray = rot(ha, -HULL_CX, -HULL_CY)
    rbx, rby = rot(la, side * LEG_AWAY, LEG_DOWN)
    Cx = (lcx + rbx) - (hcx + rax)
    Cy = (lcy + rby) - (hcy + ray)
    k11 = IMH + IML + IIH * ray * ray + IIL * rby * rby
    k12 = -IIH * rax * ray - IIL * rbx * rby
    k22 = IMH + IML + IIH * rax * rax + IIL * rbx * rbx
    det = k11 * k22 - k12 * k12
    det = torch.where(det.abs() > 1e-12, det, 1.0)
    ix = -(k22 * Cx - k12 * Cy) / det
    iy = -(k11 * Cy - k12 * Cx) / det
    hcx = hcx - IMH * ix
    hcy = hcy - IMH * iy
    ha = ha - IIH * (rax * iy - ray * ix)
    lcx = lcx + IML * ix
    lcy = lcy + IML * iy
    la = la + IIL * (rbx * iy - rby * ix)
    pos_err = torch.sqrt(Cx * Cx + Cy * Cy)
    return (hcx, hcy, ha), (lcx, lcy, la), pos_err, ang_err


def _sleepy(b: Body) -> torch.Tensor:
    return (b.vx * b.vx + b.vy * b.vy < LIN_SLEEP_TOL**2) & (b.w * b.w < ANG_SLEEP_TOL**2)


def _cat_bodies(b1: Body, b2: Body) -> Body:
    return Body(*(torch.cat([getattr(b1, f.name), getattr(b2, f.name)])
                  for f in dataclasses.fields(Body)))


# ----------------------------------------------------------- the full step
def assembly_step(
    hull: Body,
    leg1: Body,
    leg2: Body,
    terrain: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
    torque: torch.Tensor,
    gravity: float,
    acc: AssemblyAcc = None,
    dt: float = 1.0 / FPS,
    vel_iters: int = VEL_ITERS,
    pos_iters: int = POS_ITERS,
    vel_tol: float = 0.0,
    return_iters: bool = False,
):
    """One ``world.Step`` of ``N`` 3-body islands: :func:`assembly_step_reference`
    on CPU tensors, the kernel S1 on tensors elsewhere (it launches on CUDA
    tensors or raises).  Arguments and result as
    :func:`assembly_step_reference`'s."""
    # imported here: the kernel's module imports this one
    from deep_q_learning_tpu_torch.ops import solver_kernels

    kw = dict(acc=acc, dt=dt, vel_iters=vel_iters, pos_iters=pos_iters, vel_tol=vel_tol,
              return_iters=return_iters)
    if hull.cx.device.type == "cpu":
        solver_kernels.plain_calls["assembly_step"] += 1
        return assembly_step_reference(hull, leg1, leg2, terrain, fx, fy, torque, gravity, **kw)
    return solver_kernels.assembly_step_kernel(hull, leg1, leg2, terrain, fx, fy, torque,
                                               gravity, **kw)


def assembly_step_reference(
    hull: Body,
    leg1: Body,
    leg2: Body,
    terrain: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
    torque: torch.Tensor,
    gravity: float,
    acc: AssemblyAcc = None,
    dt: float = 1.0 / FPS,
    vel_iters: int = VEL_ITERS,
    pos_iters: int = POS_ITERS,
    vel_tol: float = 0.0,
    return_iters: bool = False,
):
    """One ``world.Step`` of ``N`` 3-body islands in plain PyTorch, on
    either device: S1's plain version.

    ``fx, fy, torque`` ``(N,)`` are forces on the hull for this step (reset
    kick, wind/turbulence); engine impulses must already be applied to
    ``hull``'s velocities.  ``terrain`` is ``(N, CHUNKS)``; ``gravity`` the
    float32 value of the env's gravity; ``acc`` the warm-start accumulators
    (``zero_acc(N)`` for fresh assemblies, the default).

    Returns ``(hull', leg1', leg2', touch1, touch2, hull_hit, still, acc')``
    where ``still`` is this frame's island sleep predicate; with
    ``return_iters``, also the ``(N,)`` int32 count of velocity iterations
    each env ran.
    """
    n = hull.cx.shape[0]
    if acc is None:
        acc = zero_acc(n, hull.cx.device)
    # both legs as one batch of 2N lanes (leg 1 first) for everything that
    # touches only the leg: collision, contact solve, integration
    legs = _cat_bodies(leg1, leg2)
    # ---- collide (manifolds from start-of-step poses, like b2World::Step)
    c, touch = collide_leg(torch.cat([terrain, terrain]), legs)
    hull_hit = hull_touches(terrain, hull)

    # ---- integrate velocities (gravity + external forces on the hull)
    hv = (
        hull.vx + dt * fx * IMH,
        hull.vy + dt * (gravity + fy * IMH),
        hull.w + dt * torque * IIH,
    )
    lv = (legs.vx, legs.vy + _f32_product(dt, gravity), legs.w)

    j1 = _joint_data(hull.a, leg1.a, -1.0)
    j2 = _joint_data(hull.a, leg2.a, 1.0)
    d = _contact_data(legs, c)

    # ================= velocity iterations (b2Island order: joints, contacts)
    hv, lv, ja1, ja2, ca = _warm_start(hv, lv, j1, j2, c, d, acc, n)
    if vel_tol and vel_tol > 0.0:
        # convergence early exit, off in every preset (the JAX module and
        # config.py say why).  As under jax.vmap, each env stops once its
        # largest accumulator change in an iteration falls below vel_tol and
        # keeps its state from then on; the loop runs until every env has
        # stopped or vel_iters passes, reading the device once a pass.
        used = torch.zeros((n,), dtype=torch.int32, device=hull.cx.device)
        running = torch.ones((n,), dtype=torch.bool, device=hull.cx.device)
        for _ in range(vel_iters):
            new = _vel_iteration(hv, lv, j1, j2, c, d, ja1, ja2, ca, n, dt)
            # largest change of any accumulator this pass, per env
            joint_delta = torch.stack(
                [(a - b).abs() for a, b in zip((*new[2], *new[3]), (*ja1, *ja2))]
            ).amax(0)
            contact_delta = torch.stack(
                [(a - b).abs() for a, b in zip(new[4], ca)]
            ).amax(0).view(2, n).amax(0)
            delta = torch.maximum(joint_delta, contact_delta)
            hv = tuple(torch.where(running, a, b) for a, b in zip(new[0], hv))
            keep2 = running.repeat(2)
            lv = tuple(torch.where(keep2, a, b) for a, b in zip(new[1], lv))
            ja1 = tuple(torch.where(running, a, b) for a, b in zip(new[2], ja1))
            ja2 = tuple(torch.where(running, a, b) for a, b in zip(new[3], ja2))
            ca = tuple(torch.where(keep2, a, b) for a, b in zip(new[4], ca))
            used = used + running.to(torch.int32)
            running = running & (delta >= vel_tol)
            if not bool(running.any()):
                break
    else:
        for _ in range(vel_iters):
            hv, lv, ja1, ja2, ca = _vel_iteration(hv, lv, j1, j2, c, d, ja1, ja2, ca, n, dt)
        used = None

    # ---- store accumulators for the next frame's warm start
    packed = _pack_contact(c, ca)
    new_acc = AssemblyAcc(
        j1=torch.stack(ja1, -1), j2=torch.stack(ja2, -1), s1=j1["st"], s2=j2["st"],
        c1=packed[:n], c2=packed[n:],
    )

    # ---- integrate positions (with b2 translation/rotation clamps)
    hull = _integrate(Body(hull.cx, hull.cy, hull.a, *hv), dt)
    legs = _integrate(Body(legs.cx, legs.cy, legs.a, *lv), dt)

    # ================= position iterations (contacts then joints, b2Island)
    # b2Island breaks out of the position passes once a pass's minimum
    # contact separation >= -3*slop and every joint's errors are within the
    # slops; the result depends on where it stops.  Each env keeps its
    # positions from the pass where it met the test (jax.lax.while_loop
    # under vmap masks it the same way and stops once every env has); here
    # every pass runs with that mask, which changes nothing once all envs
    # are done: the same values bit for bit, with no host read per pass.
    hp = (hull.cx, hull.cy, hull.a)
    lp = (legs.cx, legs.cy, legs.a)
    done = torch.zeros((n,), dtype=torch.bool, device=hull.cx.device)
    for _ in range(pos_iters):
        nlp, min_sep = _pos_contact(lp, c)
        min_sep = torch.minimum(min_sep[:n], min_sep[n:])
        nhp, n1p, e1, a1 = _pos_joint(hp, tuple(x[:n] for x in nlp), -1.0)
        nhp, n2p, e2, a2 = _pos_joint(nhp, tuple(x[n:] for x in nlp), 1.0)
        ok = (
            (min_sep >= -3.0 * LINEAR_SLOP)
            & (torch.maximum(e1, e2) <= LINEAR_SLOP)
            & (torch.maximum(a1, a2) <= ANGULAR_SLOP)
        )
        hp = tuple(torch.where(done, o, x) for x, o in zip(nhp, hp))
        lp = tuple(
            torch.where(done, o.view(2, n), torch.stack([x1, x2])).view(-1)
            for x1, x2, o in zip(n1p, n2p, lp)
        )
        done = done | ok
    hull = dataclasses.replace(hull, cx=hp[0], cy=hp[1], a=hp[2])
    legs = dataclasses.replace(legs, cx=lp[0], cy=lp[1], a=lp[2])

    # ---- island sleep predicate (b2Island::Solve sleep bookkeeping)
    sleepy = _sleepy(legs)
    still = _sleepy(hull) & sleepy[:n] & sleepy[n:]
    leg1 = Body(*(getattr(legs, f.name)[:n] for f in dataclasses.fields(Body)))
    leg2 = Body(*(getattr(legs, f.name)[n:] for f in dataclasses.fields(Body)))
    out = (hull, leg1, leg2, touch[:n], touch[n:], hull_hit, still, new_acc)
    if return_iters:
        if used is None:
            used = torch.full((n,), vel_iters, dtype=torch.int32, device=hull.cx.device)
        return out + (used,)
    return out
