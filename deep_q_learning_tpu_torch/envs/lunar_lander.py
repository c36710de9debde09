"""LunarLander dynamics in batched PyTorch — ``deep_q_learning_tpu/envs/lunar_lander.py``.

The JAX module documents the fidelity contract (gym's geometry, terrain,
observation, shaping reward, engine impulses with dispersion, the reset
kick frame, Box2D's sleep rule) and carries the Box2D validation.  This
module ports both of its physics engines formula for formula, with a
leading ``N`` axis on every state field, and is held against the JAX env
on matched states (``tests/test_torch_envs_lunar.py``), not against Box2D
again:

  * ``jointed`` (``params.jointed``, the default): the hull and two legs on
    motorized revolute joints, stepped by the Box2D sequential-impulse
    solver of ``envs/lander_solver.py``;
  * ``rigid``: one rigid body with two leg-tip contacts and the calibrated
    joint-overload threshold ``J_CRASH``.

A step, and the reset's physics frame, on CUDA tensors is one hand-written
kernel a frame: J1 for the jointed engine (``ops/jointed_kernels.py``, S1's
solve inside it) and R1 for the rigid one (``ops/lander_kernels.py``), each
bitwise the plain version on the card; CPU tensors take the plain versions,
``step_env_reference`` and ``reset_env_reference``.

Randomness: the reset draws (terrain heights, kick force, wind indices)
and the per-frame dispersion draw come from the caller's generator, or
are injected through ``draws`` (:class:`ResetDraws`, or an ``(N, 2)``
uniform tensor on ``[-1, 1)`` for a step).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.envs import lander_solver
from deep_q_learning_tpu_torch.envs.base import EnvParams, Environment, uniform
from deep_q_learning_tpu_torch.envs.lander_solver import AssemblyAcc, Body, _f32_product

# ----------------------------- published spec constants --------------------
FPS = 50.0
SCALE = 30.0
VIEWPORT_W = 600.0
VIEWPORT_H = 400.0
W = VIEWPORT_W / SCALE
H = VIEWPORT_H / SCALE
CHUNKS = 11
HELIPAD_Y = H / 4.0

MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
MAIN_ENGINE_Y_LOCATION = 4.0
INITIAL_RANDOM = 1000.0

LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
LEG_H = 8.0 / SCALE
SIDE_ENGINE_HEIGHT = 14.0 / SCALE
SIDE_ENGINE_AWAY = 12.0 / SCALE

# ------------------- constants measured from the Box2D bodies --------------
# (values and provenance: deep_q_learning_tpu/envs/lunar_lander.py)
TOTAL_MASS = 4.9589
HULL_MASS = 4.8167  # b2 lander.mass
INERTIA = 0.953
COM_OFFSET = 0.0981
LEG_TIP_X = 0.8577
LEG_TIP_Y = -0.6127
CONTACT_SKIN = 0.019
HULL_BOTTOM = (-17.0 / SCALE, 17.0 / SCALE, -10.0 / SCALE)
MU = 0.14142
J_CRASH = 6.3
SLOP = 0.005
LIN_SLEEP_TOL = 0.01
ANG_SLEEP_TOL = 0.0349
SLEEP_FRAMES = 25
SOLVER_ITERS = 4


@dataclasses.dataclass
class LunarLanderState:
    """Batched lander state; every field has a leading ``N`` axis."""

    x: torch.Tensor  # (N,) f32 hull body-origin position
    y: torch.Tensor
    vx: torch.Tensor  # (N,) f32 COM linear velocity
    vy: torch.Tensor
    angle: torch.Tensor
    omega: torch.Tensor
    leg1: torch.Tensor  # (N,) bool leg contact
    leg2: torch.Tensor
    terrain: torch.Tensor  # (N, CHUNKS) f32 smoothed surface heights
    prev_shaping: torch.Tensor  # (N,) f32
    t: torch.Tensor  # (N,) int32
    sleep: torch.Tensor  # (N,) int32 consecutive below-tolerance frames
    wind_idx: torch.Tensor  # (N,) int32
    torque_idx: torch.Tensor  # (N,) int32
    # jointed engine only (None in rigid mode): the two leg bodies of the
    # 3-body assembly and the solver's warm-start accumulators
    leg1_body: Optional[Body] = None
    leg2_body: Optional[Body] = None
    solver_acc: Optional[AssemblyAcc] = None


@dataclasses.dataclass(frozen=True)
class LunarLanderParams(EnvParams):
    gravity: float = -10.0
    random_terrain: bool = True
    enable_wind: bool = False
    wind_power: float = 15.0
    turbulence_power: float = 1.5
    dispersion_scale: float = 1.0  # scales engine dispersion noise (1 = spec)
    max_steps_in_episode: int = 1000
    # physics engine: the jointed 3-body assembly (default) or the rigid body
    jointed: bool = True
    # the jointed solver's iteration counts: gym passes (180, 60); presets
    # may lower them, not below ~60 velocity iterations, where the joints
    # give way under touchdown load (tests/test_lander_solver.py)
    vel_iters: int = lander_solver.VEL_ITERS
    pos_iters: int = lander_solver.POS_ITERS
    # velocity-loop early exit on the accumulators' change; 0.0 (the
    # fixed-count loop) in every preset
    vel_tol: float = 0.0


@dataclasses.dataclass
class ResetDraws:
    """The random numbers one batched reset consumes."""

    terrain: torch.Tensor  # (N, CHUNKS + 1) f32 on [0, H/2)
    kick: torch.Tensor  # (N, 2) f32 on [-INITIAL_RANDOM, INITIAL_RANDOM)
    wind: torch.Tensor  # (N, 2) int32 on [-9999, 9999): wind, torque index


def sample_reset_draws(generator: torch.Generator, n: int) -> ResetDraws:
    return ResetDraws(
        terrain=uniform(generator, (n, CHUNKS + 1), 0.0, H / 2.0),
        kick=uniform(generator, (n, 2), -INITIAL_RANDOM, INITIAL_RANDOM),
        wind=torch.randint(
            -9999, 9999, (n, 2), generator=generator, device=generator.device,
            dtype=torch.int32,
        ),
    )


def sample_step_draws(generator: torch.Generator, n: int) -> torch.Tensor:
    """The ``(n, 2)`` engine dispersion one step consumes, uniform on
    ``[-1, 1)``."""
    return uniform(generator, (n, 2), -1.0, 1.0)


def _terrain_height(terrain: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear terrain height at world x (chunks span [0, W])."""
    chunk_w = W / (CHUNKS - 1)
    xi = torch.clamp(x / chunk_w, 0.0, CHUNKS - 1 - 1e-6)
    i0 = torch.floor(xi).to(torch.int64)
    frac = xi - i0.to(torch.float32)
    h0 = terrain.gather(1, i0[:, None])[:, 0]
    h1 = terrain.gather(1, torch.clamp(i0 + 1, max=CHUNKS - 1)[:, None])[:, 0]
    return h0 * (1.0 - frac) + h1 * frac


def smoothed_terrain(raw: torch.Tensor, params) -> torch.Tensor:
    """The ``(N, CHUNKS)`` surface heights from the reset's ``(N, CHUNKS +
    1)`` draws: the helipad substituted BEFORE the 3-tap smoothing, whose
    window wraps at the left edge like gym's height[i-1] at i=0."""
    device = raw.device
    if not params.random_terrain:
        raw = torch.full_like(raw, HELIPAD_Y)
    idx = torch.arange(CHUNKS + 1, device=device)
    raw = torch.where((idx - CHUNKS // 2).abs() <= 2, HELIPAD_Y, raw)
    prev = raw[:, torch.arange(-1, CHUNKS - 1, device=device) % (CHUNKS + 1)]
    nxt = raw[:, 1 : CHUNKS + 1]
    return 0.33 * (prev + raw[:, :CHUNKS] + nxt)


def _wind_pattern(idx: torch.Tensor) -> torch.Tensor:
    """gymnasium v3's deterministic wind: tanh(sin(2kx) + sin(pi kx)), k=0.01."""
    f = idx.to(torch.float32)
    return torch.tanh(torch.sin(0.02 * f) + torch.sin(math.pi * 0.01 * f))


def state_from_numpy(state, device="cpu") -> LunarLanderState:
    """Convert a ``deep_q_learning_tpu`` ``LunarLanderState`` whose leaves
    are numpy arrays (batched with a leading ``N`` axis, or one instance)
    into a batched :class:`LunarLanderState`, the jointed engine's leg
    bodies and solver accumulators included."""
    f32, i32 = torch.float32, torch.int32

    def col(value, dtype, *trailing):
        a = np.asarray(value).reshape(-1, *trailing)
        return torch.tensor(a, device=device).to(dtype)

    def body(b):
        return Body(**{f.name: col(getattr(b, f.name), f32) for f in dataclasses.fields(Body)})

    acc = state.solver_acc
    jointed = state.leg1_body is not None
    return LunarLanderState(
        **{name: col(getattr(state, name), f32)
           for name in ("x", "y", "vx", "vy", "angle", "omega", "prev_shaping")},
        **{name: col(getattr(state, name), i32) for name in ("t", "sleep", "wind_idx", "torque_idx")},
        leg1=col(state.leg1, torch.bool),
        leg2=col(state.leg2, torch.bool),
        terrain=col(state.terrain, f32, CHUNKS),
        leg1_body=body(state.leg1_body) if jointed else None,
        leg2_body=body(state.leg2_body) if jointed else None,
        solver_acc=AssemblyAcc(
            j1=col(acc.j1, f32, 4), j2=col(acc.j2, f32, 4),
            s1=col(acc.s1, i32), s2=col(acc.s2, i32),
            c1=col(acc.c1, f32, 4, 2), c2=col(acc.c2, f32, 4, 2),
        ) if jointed else None,
    )


class LunarLander(Environment):
    """Batched LunarLander, jointed or rigid engine (``params.jointed``)."""

    injects_draws = True

    def step_draws(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return sample_step_draws(generator, n)

    def reset_draws(self, generator: torch.Generator, n: int) -> ResetDraws:
        return sample_reset_draws(generator, n)

    def default_params(self) -> LunarLanderParams:
        return LunarLanderParams()

    @property
    def num_actions(self) -> int:
        return 4

    def obs_shape(self, params) -> Tuple[int, ...]:
        return (8,)

    # ------------------------------------------------------------------ reset
    def reset_env(
        self,
        generator: torch.Generator,
        n: int,
        params: LunarLanderParams,
        draws: Optional[ResetDraws] = None,
    ):
        """``n`` fresh episodes, ``(obs, state)``: the smoothed terrain, then
        gym's first physics frame with the kick.  On CUDA tensors that frame
        is a kernel (it launches or raises): J1 for the jointed engine
        (``ops/jointed_kernels.py``), R1 for the rigid one
        (``ops/lander_kernels.py``); on CPU tensors
        :meth:`reset_env_reference`, the plain version."""
        from deep_q_learning_tpu_torch.ops import jointed_kernels, lander_kernels

        if draws is None:
            draws = sample_reset_draws(generator, n)
        if draws.terrain.device.type != "cpu":
            terrain = smoothed_terrain(draws.terrain, params)
            kick, wind = draws.kick.contiguous(), draws.wind.contiguous()
            if params.jointed:
                return jointed_kernels.jointed_reset_kernel(
                    terrain, dataclasses.replace(draws, kick=kick, wind=wind), params)
            return lander_kernels.rigid_reset_kernel(terrain, kick, wind, params)
        if params.jointed:
            jointed_kernels.plain_calls["jointed_step"] += 1
        else:
            lander_kernels.plain_calls["rigid_step"] += 1
        return self.reset_env_reference(None, n, params, draws)

    def reset_env_reference(
        self,
        generator: torch.Generator,
        n: int,
        params: LunarLanderParams,
        draws: Optional[ResetDraws] = None,
        *,
        solve=None,
    ):
        """The plain version of :meth:`reset_env`, both engines; ``solve``
        as :meth:`step_env_reference`'s."""
        if draws is None:
            draws = sample_reset_draws(generator, n)
        terrain = smoothed_terrain(draws.terrain, params)
        device = terrain.device

        def full(v, dtype=torch.float32):
            return torch.full((n,), v, dtype=dtype, device=device)

        def make_leg(side):
            # gym: position (initial_x - i*LEG_AWAY, initial_y), angle i*0.05;
            # the joint then pulls the leg to the hull over the first frames
            return Body(
                cx=full(W / 2.0 - side * LEG_AWAY), cy=full(H), a=full(side * 0.05),
                vx=full(0.0), vy=full(0.0), w=full(0.0),
            )

        state = LunarLanderState(
            x=full(W / 2.0),
            y=full(H),
            vx=full(0.0),
            vy=full(0.0),
            angle=full(0.0),
            omega=full(0.0),
            leg1=full(False, torch.bool),
            leg2=full(False, torch.bool),
            terrain=terrain,
            prev_shaping=full(0.0),
            t=full(0, torch.int32),
            sleep=full(0, torch.int32),
            wind_idx=draws.wind[:, 0].contiguous(),
            torque_idx=draws.wind[:, 1].contiguous(),
            leg1_body=make_leg(-1.0) if params.jointed else None,
            leg2_body=make_leg(1.0) if params.jointed else None,
            solver_acc=lander_solver.zero_acc(n, device) if params.jointed else None,
        )
        # gym's reset ends with one nop physics frame that carries the
        # initial random force.  The action is a nop, so the frame's engine
        # dispersion has no effect and is passed as zeros.
        state, _, _ = self._physics(params, solve)(
            state, full(0, torch.int32), params,
            disp=torch.zeros((n, 2), device=device), kick_force=draws.kick,
        )
        state = dataclasses.replace(
            state, prev_shaping=self._shaping(state, params), t=full(0, torch.int32)
        )
        return self.get_obs(state, params), state

    # ------------------------------------------------------------------- obs
    def get_obs(self, state: LunarLanderState, params) -> torch.Tensor:
        return torch.stack(
            [
                (state.x - W / 2.0) / (W / 2.0),
                (state.y - (HELIPAD_Y + LEG_DOWN)) / (H / 2.0),
                state.vx * (W / 2.0) / FPS,
                state.vy * (H / 2.0) / FPS,
                state.angle,
                20.0 * state.omega / FPS,
                state.leg1.to(torch.float32),
                state.leg2.to(torch.float32),
            ],
            dim=-1,
        )

    def _shaping(self, state: LunarLanderState, params) -> torch.Tensor:
        """The published potential, computed on the normalized observation."""
        o = self.get_obs(state, params)
        return (
            -100.0 * torch.sqrt(o[:, 0] ** 2 + o[:, 1] ** 2)
            - 100.0 * torch.sqrt(o[:, 2] ** 2 + o[:, 3] ** 2)
            - 100.0 * torch.abs(o[:, 4])
            + 10.0 * o[:, 6]
            + 10.0 * o[:, 7]
        )

    # ---------------------------------------------------------------- physics
    def _physics_step(self, state, action, params, disp, kick_force=None):
        """One Box2D-ordered frame: impulses -> gravity -> contact velocity
        solve at the start-of-step pose -> integrate -> position correction.
        ``disp`` is the ``(N, 2)`` engine dispersion.  Returns
        ``(state', game_over, rest)``."""
        dt = 1.0 / FPS
        sin_a = torch.sin(state.angle)
        cos_a = torch.cos(state.angle)
        tip0, tip1 = sin_a, cos_a
        side0, side1 = -cos_a, sin_a
        d0, d1 = disp[:, 0], disp[:, 1]

        comx = state.x - COM_OFFSET * sin_a
        comy = state.y + COM_OFFSET * cos_a
        vx, vy, omega = state.vx, state.vy, state.omega

        wind_idx, torque_idx = state.wind_idx, state.torque_idx
        if params.enable_wind:
            airborne = ~(state.leg1 | state.leg2)
            wind = _wind_pattern(wind_idx) * params.wind_power
            torq = _wind_pattern(torque_idx) * params.turbulence_power
            vx = vx + torch.where(airborne, wind / TOTAL_MASS * dt, 0.0)
            omega = omega + torch.where(airborne, torq / INERTIA * dt, 0.0)
            wind_idx = wind_idx + airborne.to(torch.int32)
            torque_idx = torque_idx + airborne.to(torch.int32)

        # --- main engine (gym's exact impulse geometry) --------------------
        m_power = torch.where(action == 2, 1.0, 0.0)
        k_main = MAIN_ENGINE_Y_LOCATION / SCALE + 2.0 * d0
        ox_m = tip0 * k_main + side0 * d1
        oy_m = -tip1 * k_main - side1 * d1
        jmx = -ox_m * MAIN_ENGINE_POWER * m_power
        jmy = -oy_m * MAIN_ENGINE_POWER * m_power
        rmx = (state.x + ox_m) - comx
        rmy = (state.y + oy_m) - comy
        vx = vx + jmx / TOTAL_MASS
        vy = vy + jmy / TOTAL_MASS
        omega = omega + (rmx * jmy - rmy * jmx) / INERTIA

        # --- side engines ---------------------------------------------------
        s_power = torch.where((action == 1) | (action == 3), 1.0, 0.0)
        direction = torch.where(action == 3, 1.0, torch.where(action == 1, -1.0, 0.0))
        k_side = 3.0 * d1 + direction * SIDE_ENGINE_AWAY
        ox_s = tip0 * d0 + side0 * k_side
        oy_s = -tip1 * d0 - side1 * k_side
        jsx = -ox_s * SIDE_ENGINE_POWER * s_power
        jsy = -oy_s * SIDE_ENGINE_POWER * s_power
        # the published 17-vs-14 impulse-position quirk, reproduced verbatim
        rsx = (state.x + ox_s - tip0 * 17.0 / SCALE) - comx
        rsy = (state.y + oy_s + tip1 * SIDE_ENGINE_HEIGHT) - comy
        vx = vx + jsx / TOTAL_MASS
        vy = vy + jsy / TOTAL_MASS
        omega = omega + (rsx * jsy - rsy * jsx) / INERTIA

        # --- reset kick (one frame) + gravity -------------------------------
        if kick_force is not None:
            vx = vx + kick_force[:, 0] * dt / TOTAL_MASS
            vy = vy + kick_force[:, 1] * dt / TOTAL_MASS
        vy = vy + _f32_product(params.gravity, dt)

        # --- contacts at the start-of-step pose (Box2D collide phase) ------
        def leg_tip(sign):
            bx, by = sign * LEG_TIP_X, LEG_TIP_Y
            return (
                state.x + bx * cos_a - by * sin_a,
                state.y + bx * sin_a + by * cos_a,
            )

        p1x, p1y = leg_tip(-1.0)
        p2x, p2y = leg_tip(1.0)
        g1 = _terrain_height(state.terrain, p1x)
        g2 = _terrain_height(state.terrain, p2x)
        c1 = p1y <= g1 + CONTACT_SKIN + SLOP
        c2 = p2y <= g2 + CONTACT_SKIN + SLOP

        # --- fixed-iteration impulse solve: Box2D's 2-point block solver for
        # the normal pair, sequential friction clamped by the normal impulses
        r1x, r1y = p1x - comx, p1y - comy
        r2x, r2y = p2x - comx, p2y - comy
        a11 = 1.0 / TOTAL_MASS + r1x * r1x / INERTIA
        a22 = 1.0 / TOTAL_MASS + r2x * r2x / INERTIA
        a12 = 1.0 / TOTAL_MASS + r1x * r2x / INERTIA
        det = a11 * a22 - a12 * a12
        mt1 = 1.0 / (1.0 / TOTAL_MASS + r1y * r1y / INERTIA)
        mt2 = 1.0 / (1.0 / TOTAL_MASS + r2y * r2y / INERTIA)
        jn1 = jn2 = jt1 = jt2 = torch.zeros_like(vx)
        f1 = c1.to(torch.float32)
        f2 = c2.to(torch.float32)
        for _ in range(SOLVER_ITERS):
            un1 = vy + omega * r1x
            un2 = vy + omega * r2x
            b1 = un1 - (a11 * jn1 + a12 * jn2)
            b2 = un2 - (a12 * jn1 + a22 * jn2)
            # case 1: both contacts active (x = -A^-1 b)
            x1_b = (-a22 * b1 + a12 * b2) / det
            x2_b = (a12 * b1 - a11 * b2) / det
            ok_b = c1 & c2 & (x1_b >= 0.0) & (x2_b >= 0.0)
            # case 2: only contact 1 pushes
            x1_1 = torch.clamp(-b1 / a11, min=0.0) * f1
            ok_1 = c1 & (a12 * x1_1 + b2 >= 0.0) | ~c2
            # case 3: only contact 2 pushes
            x2_2 = torch.clamp(-b2 / a22, min=0.0) * f2
            x1 = torch.where(ok_b, x1_b, torch.where(ok_1, x1_1, 0.0)) * f1
            x2 = torch.where(ok_b, x2_b, torch.where(ok_1, 0.0, x2_2)) * f2
            dn1, dn2 = x1 - jn1, x2 - jn2
            vy = vy + (dn1 + dn2) / TOTAL_MASS
            omega = omega + (dn1 * r1x + dn2 * r2x) / INERTIA
            jn1, jn2 = x1, x2
            # contact 1: friction
            ut = vx - omega * r1y
            jt_new = torch.clamp(jt1 - ut * mt1, -MU * jn1, MU * jn1)
            djt = (jt_new - jt1) * f1
            vx = vx + djt / TOTAL_MASS
            omega = omega - djt * r1y / INERTIA
            jt1 = jt1 + djt
            # contact 2: friction
            ut = vx - omega * r2y
            jt_new = torch.clamp(jt2 - ut * mt2, -MU * jn2, MU * jn2)
            djt = (jt_new - jt2) * f2
            vx = vx + djt / TOTAL_MASS
            omega = omega - djt * r2y / INERTIA
            jt2 = jt2 + djt

        # joint overload: a per-frame normal impulse through either leg above
        # J_CRASH slams the hull down => game over
        hard = (jn1 > J_CRASH) | (jn2 > J_CRASH)

        # --- integrate (semi-implicit Euler, Box2D order) -------------------
        comx = comx + vx * dt
        comy = comy + vy * dt
        angle = state.angle + omega * dt
        sin_n, cos_n = torch.sin(angle), torch.cos(angle)
        x = comx + COM_OFFSET * sin_n
        y = comy - COM_OFFSET * cos_n

        # --- position correction: lift contacting tips back to the surface --
        def tip_at(sign, xx, yy):
            bx, by = sign * LEG_TIP_X, LEG_TIP_Y
            return (
                xx + bx * cos_n - by * sin_n,
                yy + bx * sin_n + by * cos_n,
            )

        q1x, q1y = tip_at(-1.0, x, y)
        q2x, q2y = tip_at(1.0, x, y)
        h1 = _terrain_height(state.terrain, q1x)
        h2 = _terrain_height(state.terrain, q2x)
        pen1 = torch.where(c1, (h1 + CONTACT_SKIN) - q1y, 0.0)
        pen2 = torch.where(c2, (h2 + CONTACT_SKIN) - q2y, 0.0)
        lift = torch.clamp(torch.maximum(pen1, pen2), min=0.0)
        y = y + lift

        # hull bottom corners touching ground => Box2D BeginContact game_over
        def corner(bx, by):
            return (
                x + bx * cos_n - by * sin_n,
                y + bx * sin_n + by * cos_n,
            )

        hx1, hy1 = corner(HULL_BOTTOM[0], HULL_BOTTOM[2])
        hx2, hy2 = corner(HULL_BOTTOM[1], HULL_BOTTOM[2])
        hull_hit = (hy1 <= _terrain_height(state.terrain, hx1) + 0.01) | (
            hy2 <= _terrain_height(state.terrain, hx2) + 0.01
        )
        game_over = hull_hit | hard

        # --- Box2D sleep => the +100 "rest" trigger -------------------------
        still = (
            c1
            & c2
            & (vx.abs() < LIN_SLEEP_TOL)
            & (vy.abs() < LIN_SLEEP_TOL)
            & (omega.abs() < ANG_SLEEP_TOL)
        )
        sleep = torch.where(still, state.sleep + 1, 0).to(torch.int32)
        rest = sleep >= SLEEP_FRAMES

        new_state = dataclasses.replace(
            state,
            x=x,
            y=y,
            vx=vx,
            vy=vy,
            angle=angle,
            omega=omega,
            leg1=c1,
            leg2=c2,
            sleep=sleep,
            wind_idx=wind_idx,
            torque_idx=torque_idx,
            t=state.t + 1,
        )
        return new_state, game_over, rest

    def _physics(self, params, solve=None):
        """The physics frame of ``params``' engine, the jointed one with
        ``solve`` as its solver step."""
        if params.jointed:
            return functools.partial(self._physics_step_jointed, solve=solve)
        return self._physics_step

    # ----------------------------------------------- jointed 3-body physics
    def _physics_step_jointed(self, state, action, params, disp, kick_force=None, solve=None):
        """One Box2D frame of the 3-body assembly: engine impulses on the
        hull (hull mass and inertia; gym applies them before
        ``world.Step``), then ``solve``, by default
        ``lander_solver.assembly_step``.  ``game_over`` is the hull
        touching the terrain, with no calibrated threshold.  Returns
        ``(state', game_over, rest)``."""
        dt = 1.0 / lander_solver.FPS
        sin_a = torch.sin(state.angle)
        cos_a = torch.cos(state.angle)
        tip0, tip1 = sin_a, cos_a
        side0, side1 = -cos_a, sin_a
        d0, d1 = disp[:, 0], disp[:, 1]

        comx, comy = lander_solver.hull_com(state.x, state.y, state.angle)
        vx, vy, omega = state.vx, state.vy, state.omega
        IMH, IIH = lander_solver.IMH, lander_solver.IIH

        # wind/turbulence are forces on the hull (ApplyForceToCenter/Torque)
        fx = torch.zeros_like(vx)
        fy = torch.zeros_like(vx)
        torque = torch.zeros_like(vx)
        wind_idx, torque_idx = state.wind_idx, state.torque_idx
        if params.enable_wind:
            airborne = ~(state.leg1 | state.leg2)
            fx = fx + torch.where(airborne, _wind_pattern(wind_idx) * params.wind_power, 0.0)
            torque = torque + torch.where(
                airborne, _wind_pattern(torque_idx) * params.turbulence_power, 0.0
            )
            wind_idx = wind_idx + airborne.to(torch.int32)
            torque_idx = torque_idx + airborne.to(torch.int32)
        if kick_force is not None:
            fx = fx + kick_force[:, 0]
            fy = fy + kick_force[:, 1]

        # --- main engine impulse (the rigid engine's published geometry) ---
        m_power = torch.where(action == 2, 1.0, 0.0)
        k_main = MAIN_ENGINE_Y_LOCATION / SCALE + 2.0 * d0
        ox_m = tip0 * k_main + side0 * d1
        oy_m = -tip1 * k_main - side1 * d1
        jmx = -ox_m * MAIN_ENGINE_POWER * m_power
        jmy = -oy_m * MAIN_ENGINE_POWER * m_power
        rmx = (state.x + ox_m) - comx
        rmy = (state.y + oy_m) - comy
        vx = vx + jmx * IMH
        vy = vy + jmy * IMH
        omega = omega + (rmx * jmy - rmy * jmx) * IIH

        # --- side engines ---------------------------------------------------
        s_power = torch.where((action == 1) | (action == 3), 1.0, 0.0)
        direction = torch.where(action == 3, 1.0, torch.where(action == 1, -1.0, 0.0))
        k_side = 3.0 * d1 + direction * SIDE_ENGINE_AWAY
        ox_s = tip0 * d0 + side0 * k_side
        oy_s = -tip1 * d0 - side1 * k_side
        jsx = -ox_s * SIDE_ENGINE_POWER * s_power
        jsy = -oy_s * SIDE_ENGINE_POWER * s_power
        rsx = (state.x + ox_s - tip0 * 17.0 / SCALE) - comx
        rsy = (state.y + oy_s + tip1 * SIDE_ENGINE_HEIGHT) - comy
        vx = vx + jsx * IMH
        vy = vy + jsy * IMH
        omega = omega + (rsx * jsy - rsy * jsx) * IIH

        hull = Body(cx=comx, cy=comy, a=state.angle, vx=vx, vy=vy, w=omega)
        solve = solve or lander_solver.assembly_step
        hull, leg1, leg2, touch1, touch2, hull_hit, still, acc = solve(
            hull, state.leg1_body, state.leg2_body, state.terrain, fx, fy, torque,
            params.gravity, acc=state.solver_acc, dt=dt,
            vel_iters=params.vel_iters, pos_iters=params.pos_iters, vel_tol=params.vel_tol,
        )
        x, y = lander_solver.hull_origin(hull.cx, hull.cy, hull.a)

        sleep = torch.where(still, state.sleep + 1, 0).to(torch.int32)
        rest = sleep >= lander_solver.SLEEP_FRAMES

        new_state = dataclasses.replace(
            state,
            x=x,
            y=y,
            vx=hull.vx,
            vy=hull.vy,
            angle=hull.a,
            omega=hull.w,
            leg1=touch1,
            leg2=touch2,
            leg1_body=leg1,
            leg2_body=leg2,
            solver_acc=acc,
            sleep=sleep,
            wind_idx=wind_idx,
            torque_idx=torque_idx,
            t=state.t + 1,
        )
        return new_state, hull_hit, rest

    # ------------------------------------------------------------------ step
    def step_env(
        self,
        generator: torch.Generator,
        state: LunarLanderState,
        action: torch.Tensor,
        params: LunarLanderParams,
        draws: Optional[torch.Tensor] = None,
    ):
        """One transition, ``(obs, state, reward, terminated, truncated)``.
        On CUDA tensors a kernel (it launches or raises): J1 for the jointed
        engine (``ops/jointed_kernels.py``), R1 for the rigid one
        (``ops/lander_kernels.py``); on CPU tensors
        :meth:`step_env_reference`, the plain version."""
        from deep_q_learning_tpu_torch.ops import jointed_kernels, lander_kernels

        if draws is None:
            draws = sample_step_draws(generator, action.shape[0])
        if state.x.device.type != "cpu":
            kernel = (jointed_kernels.jointed_step_kernel if params.jointed
                      else lander_kernels.rigid_step_kernel)
            return kernel(state, action.to(torch.int32), params, draws.contiguous())
        if params.jointed:
            jointed_kernels.plain_calls["jointed_step"] += 1
        else:
            lander_kernels.plain_calls["rigid_step"] += 1
        return self.step_env_reference(None, state, action, params, draws)

    def fuses_vector_step(self, params: LunarLanderParams, state: LunarLanderState,
                          fresh) -> bool:
        """The rigid engine on CUDA tensors runs the vector step with a
        reset pool as one kernel (R1's vector entry)."""
        return fresh is not None and not params.jointed and state.x.device.type == "cuda"

    def vector_step(self, generator, state, action, params, fresh, draws=None, reset_draws=None,
                    time_feature: bool = False):
        """``VectorEnv._step`` with the pool ``fresh`` in one launch of R1
        (``ops/lander_kernels.py::rigid_vector_kernel``): the step, the
        auto-reset's selects and, with ``time_feature``, ``TimeFractionObs``'
        feature.  CUDA tensors of the rigid engine only (it raises
        elsewhere); the plain version is ``VectorEnv._step``'s composition."""
        from deep_q_learning_tpu_torch.ops import lander_kernels

        if draws is None:
            draws = sample_step_draws(generator, action.shape[0])
        return lander_kernels.rigid_vector_kernel(state, action.to(torch.int32), params,
                                                  draws.contiguous(), fresh, time_feature)

    def step_env_reference(
        self,
        generator: torch.Generator,
        state: LunarLanderState,
        action: torch.Tensor,
        params: LunarLanderParams,
        draws: Optional[torch.Tensor] = None,
        *,
        solve=None,
    ):
        """The plain version of :meth:`step_env`, both engines.  The
        jointed engine's solve is ``solve``: by default
        ``lander_solver.assembly_step`` (S1 on the card), or
        ``lander_solver.assembly_step_reference`` for the plain solver on
        either device."""
        if draws is None:
            draws = sample_step_draws(generator, action.shape[0])
        # dispersion is drawn every frame (gym draws before the engine gate)
        disp = draws / SCALE * params.dispersion_scale
        phys = self._physics(params, solve)
        new_state, game_over, rest = phys(state, action, params, disp)

        m_power = torch.where(action == 2, 1.0, 0.0)
        s_power = torch.where((action == 1) | (action == 3), 1.0, 0.0)

        obs = self.get_obs(new_state, params)
        out_of_bounds = obs[:, 0].abs() >= 1.0

        shaping = self._shaping(new_state, params)
        reward = shaping - state.prev_shaping
        new_state = dataclasses.replace(new_state, prev_shaping=shaping)
        reward = reward - m_power * 0.30 - s_power * 0.03
        crash = game_over | out_of_bounds
        reward = torch.where(crash, -100.0, torch.where(rest, 100.0, reward))

        terminated = crash | rest
        truncated = (new_state.t >= params.max_steps_in_episode) & ~terminated
        return obs, new_state, reward, terminated, truncated
