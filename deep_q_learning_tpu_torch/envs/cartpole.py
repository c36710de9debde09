"""CartPole-v1 in batched PyTorch — ``deep_q_learning_tpu/envs/cartpole.py``.

The published task (Barto, Sutton & Anderson 1983; the ``CartPole-v1``
config): Euler integration with tau 0.02, reward 1 per step, a 500-step
limit, termination at |x| > 2.4 or |theta| > 12 degrees, reset uniform in
(-0.05, 0.05).  Every state field has a leading ``N`` axis.  The reset's
four numbers per env come from the caller's generator in one bulk draw,
or are injected through ``draws`` (an ``(N, 4)`` tensor already on
(-0.05, 0.05)).  A step draws nothing.  On CUDA tensors the step, and the
vector step with its auto-reset, run as one launch of the kernel C1
(``ops/classic_kernels.py``); ``step_env_reference`` is the plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import ClassicControl, EnvParams, uniform


@dataclasses.dataclass(frozen=True)
class CartPoleState:
    x: torch.Tensor  # (N,) f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # (N,) int32 step counter


@dataclasses.dataclass(frozen=True)
class CartPoleParams(EnvParams):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half the pole's length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * math.pi / 360
    x_threshold: float = 2.4
    max_steps_in_episode: int = 500


class CartPole(ClassicControl):
    """Batched CartPole-v1; Euler integrator, float32."""

    kernel = "cartpole"  # ops/classic_kernels.py

    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    @property
    def num_actions(self) -> int:
        return 2

    def obs_shape(self, params) -> Tuple[int, ...]:
        return (4,)

    def reset_draws(self, generator, n):
        return uniform(generator, (n, 4), -0.05, 0.05)

    def reset_env(self, generator, n, params, draws=None):
        init = self.reset_draws(generator, n) if draws is None else draws
        state = CartPoleState(
            x=init[:, 0],
            x_dot=init[:, 1],
            theta=init[:, 2],
            theta_dot=init[:, 3],
            t=torch.zeros((n,), dtype=torch.int32, device=init.device),
        )
        return self.get_obs(state, params), state

    def get_obs(self, state: CartPoleState, params) -> torch.Tensor:
        return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], dim=-1)

    def step_env_reference(self, generator, state: CartPoleState, action,
                           params: CartPoleParams, draws=None):
        force = torch.where(action == 1, params.force_mag, -params.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)

        total_mass = params.masscart + params.masspole
        polemass_length = params.masspole * params.length

        temp = (force + polemass_length * state.theta_dot**2 * sintheta) / total_mass
        thetaacc = (params.gravity * sintheta - costheta * temp) / (
            params.length * (4.0 / 3.0 - params.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        # Euler ("kinematics_integrator == 'euler'" in the published spec)
        new_state = CartPoleState(
            x=state.x + params.tau * state.x_dot,
            x_dot=state.x_dot + params.tau * xacc,
            theta=state.theta + params.tau * state.theta_dot,
            theta_dot=state.theta_dot + params.tau * thetaacc,
            t=state.t + 1,
        )
        # Python-float thresholds compare in float32, as JAX's weak-typed ones
        terminated = (new_state.x.abs() > params.x_threshold) | (
            new_state.theta.abs() > params.theta_threshold
        )
        truncated = (new_state.t >= params.max_steps_in_episode) & ~terminated
        reward = torch.ones_like(state.x)
        return self.get_obs(new_state, params), new_state, reward, terminated, truncated
