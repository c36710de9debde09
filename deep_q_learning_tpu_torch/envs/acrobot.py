"""Acrobot-v1 in batched PyTorch — ``deep_q_learning_tpu/envs/acrobot.py``.

The published task (Sutton 1996): a two-link underactuated pendulum, RK4
integration of the book's equations with dt 0.2, torque in {-1, 0, +1} on
the second joint, reward -1 per step until the tip rises above
``-cos(θ1) - cos(θ1 + θ2) > 1`` (reward 0 on that step), a 500-step
limit, reset uniform on (-0.1, 0.1).  The formulas keep the JAX module's
order of operations and its Python-float constants, so both evaluate the
same float32 expressions (XLA may still fuse multiply-adds, PyTorch does
not).  The reset's four numbers per env come from one bulk draw, or from
``draws`` (an ``(N, 4)`` tensor already on (-0.1, 0.1)).  On CUDA tensors
the step, and the vector step with its auto-reset, run as one launch of the
kernel A1 (``ops/classic_kernels.py``); ``step_env_reference`` is the plain
version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import ClassicControl, EnvParams, uniform

# published physical constants (link masses/lengths = 1, com at 0.5, I = 1)
L1 = 1.0
M1 = M2 = 1.0
LC1 = LC2 = 0.5
I1 = I2 = 1.0
G = 9.8
DT = 0.2
MAX_VEL_1 = 4.0 * math.pi
MAX_VEL_2 = 9.0 * math.pi


@dataclasses.dataclass(frozen=True)
class AcrobotState:
    theta1: torch.Tensor  # (N,) f32, wrapped to [-pi, pi]
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor  # (N,) int32


@dataclasses.dataclass(frozen=True)
class AcrobotParams(EnvParams):
    max_steps_in_episode: int = 500


def _dynamics(s, torque):
    """d/dt of ``(θ1, θ2, ω1, ω2)``, a tuple of ``(N,)`` tensors: the book's
    equations of motion."""
    theta1, theta2, dtheta1, dtheta2 = s
    d1 = (
        M1 * LC1**2
        + M2 * (L1**2 + LC2**2 + 2 * L1 * LC2 * torch.cos(theta2))
        + I1
        + I2
    )
    d2 = M2 * (LC2**2 + L1 * LC2 * torch.cos(theta2)) + I2
    phi2 = M2 * LC2 * G * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        -M2 * L1 * LC2 * dtheta2**2 * torch.sin(theta2)
        - 2 * M2 * L1 * LC2 * dtheta2 * dtheta1 * torch.sin(theta2)
        + (M1 * LC1 + M2 * L1) * G * torch.cos(theta1 - math.pi / 2.0)
        + phi2
    )
    # "book" variant of the accelerations (the published env default)
    ddtheta2 = (
        torque + d2 / d1 * phi1 - M2 * L1 * LC2 * dtheta1**2 * torch.sin(theta2) - phi2
    ) / (M2 * LC2**2 + I2 - d2**2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return dtheta1, dtheta2, ddtheta1, ddtheta2


def _rk4_step(s, torque, dt: float):
    k1 = _dynamics(s, torque)
    k2 = _dynamics(tuple(x + dt / 2 * k for x, k in zip(s, k1)), torque)
    k3 = _dynamics(tuple(x + dt / 2 * k for x, k in zip(s, k2)), torque)
    k4 = _dynamics(tuple(x + dt * k for x, k in zip(s, k3)), torque)
    return tuple(
        x + dt / 6.0 * (a + 2 * b + 2 * c + d) for x, a, b, c, d in zip(s, k1, k2, k3, k4)
    )


def _wrap(x, low: float, high: float):
    # torch.remainder, like jnp.mod, takes the divisor's sign (fmod does not)
    return low + torch.remainder(x - low, high - low)


class Acrobot(ClassicControl):
    """Batched Acrobot-v1."""

    kernel = "acrobot"  # ops/classic_kernels.py

    def default_params(self) -> AcrobotParams:
        return AcrobotParams()

    @property
    def num_actions(self) -> int:
        return 3  # torque -1 / 0 / +1

    def obs_shape(self, params) -> Tuple[int, ...]:
        return (6,)

    def reset_draws(self, generator, n):
        return uniform(generator, (n, 4), -0.1, 0.1)

    def reset_env(self, generator, n, params, draws=None):
        init = self.reset_draws(generator, n) if draws is None else draws
        state = AcrobotState(
            theta1=init[:, 0],
            theta2=init[:, 1],
            dtheta1=init[:, 2],
            dtheta2=init[:, 3],
            t=torch.zeros((n,), dtype=torch.int32, device=init.device),
        )
        return self.get_obs(state, params), state

    def get_obs(self, state: AcrobotState, params) -> torch.Tensor:
        return torch.stack(
            [
                torch.cos(state.theta1),
                torch.sin(state.theta1),
                torch.cos(state.theta2),
                torch.sin(state.theta2),
                state.dtheta1,
                state.dtheta2,
            ],
            dim=-1,
        )

    def step_env_reference(self, generator, state: AcrobotState, action, params, draws=None):
        torque = (action - 1).to(torch.float32)
        s = (state.theta1, state.theta2, state.dtheta1, state.dtheta2)
        ns = _rk4_step(s, torque, DT)
        theta1 = _wrap(ns[0], -math.pi, math.pi)
        theta2 = _wrap(ns[1], -math.pi, math.pi)
        new_state = AcrobotState(
            theta1=theta1,
            theta2=theta2,
            dtheta1=torch.clamp(ns[2], -MAX_VEL_1, MAX_VEL_1),
            dtheta2=torch.clamp(ns[3], -MAX_VEL_2, MAX_VEL_2),
            t=state.t + 1,
        )
        terminated = (-torch.cos(theta1) - torch.cos(theta2 + theta1)) > 1.0
        truncated = (new_state.t >= params.max_steps_in_episode) & ~terminated
        reward = torch.where(terminated, 0.0, -1.0)
        return self.get_obs(new_state, params), new_state, reward, terminated, truncated
