"""Environment factory — config string to ``(env, params)``
(``deep_q_learning_tpu/envs/registry.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from deep_q_learning_tpu_torch.envs.acrobot import Acrobot
from deep_q_learning_tpu_torch.envs.base import Environment
from deep_q_learning_tpu_torch.envs.cartpole import CartPole
from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander
from deep_q_learning_tpu_torch.envs.mountain_car import MountainCar
from deep_q_learning_tpu_torch.envs.wrappers import TimeFractionObs

_ENVS = {
    "Acrobot-v1": Acrobot,
    "CartPole-v1": CartPole,
    "LunarLander-v2": LunarLander,
    "MountainCar-v0": MountainCar,
}


def make_env(
    env_id: str,
    time_fraction_obs: bool = False,
    max_steps_in_episode: Optional[int] = None,
    param_overrides: Optional[dict] = None,
) -> Tuple[Environment, object]:
    """Build an env (optionally wrapped with ``TimeFractionObs``) and its
    params.  ``param_overrides`` fields the params do not have are ignored,
    so config-level knobs can be passed whatever the env."""
    if env_id not in _ENVS:
        raise ValueError(f"unknown env_id {env_id!r}; have {sorted(_ENVS)}")
    env: Environment = _ENVS[env_id]()
    if time_fraction_obs:
        env = TimeFractionObs(env)
    params = env.default_params()
    if max_steps_in_episode is not None:
        params = dataclasses.replace(params, max_steps_in_episode=max_steps_in_episode)
    if param_overrides:
        known = {f.name for f in dataclasses.fields(params)}
        applicable = {k: v for k, v in param_overrides.items() if k in known}
        if applicable:
            params = dataclasses.replace(params, **applicable)
    return env, params


def available_envs():
    return sorted(_ENVS)
