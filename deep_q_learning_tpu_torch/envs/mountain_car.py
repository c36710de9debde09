"""MountainCar-v0 in batched PyTorch — ``deep_q_learning_tpu/envs/mountain_car.py``.

The published classic-control task (Moore 1990): force 0.001, gravity
0.0025, velocity clipped to ±0.07, position to [-1.2, 0.6] with an
inelastic left wall, goal at 0.5, reward -1 per step, a 200-step limit,
reset uniform on [-0.6, -0.4) at rest.  The reset's one number per env
comes from one bulk draw, or from ``draws`` (an ``(N,)`` tensor already on
[-0.6, -0.4)).  On CUDA tensors the step, and the vector step with its
auto-reset, run as one launch of the kernel M1 (``ops/classic_kernels.py``);
``step_env_reference`` is the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import ClassicControl, EnvParams, uniform


@dataclasses.dataclass(frozen=True)
class MountainCarState:
    position: torch.Tensor  # (N,) f32
    velocity: torch.Tensor
    t: torch.Tensor  # (N,) int32


@dataclasses.dataclass(frozen=True)
class MountainCarParams(EnvParams):
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    force: float = 0.001
    gravity: float = 0.0025
    max_steps_in_episode: int = 200


class MountainCar(ClassicControl):
    """Batched MountainCar-v0."""

    kernel = "mountain_car"  # ops/classic_kernels.py

    def default_params(self) -> MountainCarParams:
        return MountainCarParams()

    @property
    def num_actions(self) -> int:
        return 3  # push left / no push / push right

    def obs_shape(self, params) -> Tuple[int, ...]:
        return (2,)

    def reset_draws(self, generator, n):
        return uniform(generator, (n,), -0.6, -0.4)

    def reset_env(self, generator, n, params, draws=None):
        position = self.reset_draws(generator, n) if draws is None else draws
        state = MountainCarState(
            position=position,
            velocity=torch.zeros_like(position),
            t=torch.zeros((n,), dtype=torch.int32, device=position.device),
        )
        return self.get_obs(state, params), state

    def get_obs(self, state: MountainCarState, params) -> torch.Tensor:
        return torch.stack([state.position, state.velocity], dim=-1)

    def step_env_reference(self, generator, state: MountainCarState, action, params, draws=None):
        # (action - 1) * force in float32, as JAX promotes int32 by a weak float
        push = (action - 1).to(torch.float32) * params.force
        velocity = state.velocity + push + torch.cos(3.0 * state.position) * (-params.gravity)
        velocity = torch.clamp(velocity, -params.max_speed, params.max_speed)
        position = torch.clamp(state.position + velocity, params.min_position, params.max_position)
        # inelastic left wall (published spec)
        velocity = torch.where((position <= params.min_position) & (velocity < 0), 0.0, velocity)
        new_state = MountainCarState(position=position, velocity=velocity, t=state.t + 1)
        terminated = position >= params.goal_position
        truncated = (new_state.t >= params.max_steps_in_episode) & ~terminated
        reward = torch.full_like(position, -1.0)
        return self.get_obs(new_state, params), new_state, reward, terminated, truncated
