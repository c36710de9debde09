"""Batched environment wrappers (``deep_q_learning_tpu/envs/wrappers.py``).

``TimeFractionObs`` appends ``t / max_steps`` to the observation, the
reference's ``fraction_finished`` feature.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import Environment


class WrappedEnv(Environment):
    """Base delegating wrapper."""

    def __init__(self, env: Environment):
        self.env = env

    def default_params(self):
        return self.env.default_params()

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    @property
    def batch_reset_cheap(self) -> bool:
        return self.env.batch_reset_cheap

    def obs_shape(self, params) -> Tuple[int, ...]:
        return self.env.obs_shape(params)

    def reset_env(self, generator, n, params, draws=None):
        return self.env.reset_env(generator, n, params, draws)

    def step_env(self, generator, state, action, params, draws=None):
        return self.env.step_env(generator, state, action, params, draws)

    def get_obs(self, state, params):
        return self.env.get_obs(state, params)


class TimeFractionObs(WrappedEnv):
    """Append ``t / max_steps`` to the observation.  The wrapped env's state
    must expose an integer ``t`` field."""

    def obs_shape(self, params) -> Tuple[int, ...]:
        (d,) = self.env.obs_shape(params)
        return (d + 1,)

    def _augment(self, obs, state, params):
        frac = state.t.to(torch.float32) / params.max_steps_in_episode
        return torch.cat([obs, frac[:, None]], dim=-1)

    def reset_env(self, generator, n, params, draws=None):
        obs, state = self.env.reset_env(generator, n, params, draws)
        return self._augment(obs, state, params), state

    def step_env(self, generator, state, action, params, draws=None):
        obs, new_state, reward, terminated, truncated = self.env.step_env(
            generator, state, action, params, draws
        )
        return (
            self._augment(obs, new_state, params),
            new_state,
            reward,
            terminated,
            truncated,
        )

    def get_obs(self, state, params):
        return self._augment(self.env.get_obs(state, params), state, params)
