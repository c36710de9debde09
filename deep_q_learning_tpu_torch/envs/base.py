"""Batched environment API — the PyTorch form of ``deep_q_learning_tpu/envs/base.py``.

The JAX package writes each environment for ONE instance and batches it
with ``jax.vmap``.  Here every environment function takes and returns
tensors with a leading ``N`` (env) axis, and randomness comes from the
caller's ``torch.Generator`` (whose device is the device the env runs on).

The semantics are the reference's: ``step`` returns separate
``terminated`` and ``truncated`` flags, and ``VectorEnv.step`` auto-resets
finished instances in the same call while the returned :class:`Transition`
keeps the pre-reset ``next_obs`` for bootstrapping.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Base class for static environment parameters."""

    max_steps_in_episode: int = 1000


def tree_where(mask: torch.Tensor, fresh: Any, stepped: Any) -> Any:
    """Per-env select ``mask ? fresh : stepped`` over a tensor or a
    dataclass of batched tensors."""
    if isinstance(stepped, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (stepped.dim() - 1))
        return torch.where(m, fresh, stepped)
    return dataclasses.replace(
        stepped,
        **{
            f.name: tree_where(mask, getattr(fresh, f.name), getattr(stepped, f.name))
            for f in dataclasses.fields(stepped)
        },
    )


class Environment:
    """Abstract batched environment.

    Subclasses implement ``reset_env`` / ``step_env`` / ``get_obs`` over
    batched states.  ``draws`` lets a caller (a parity test) inject the
    random numbers a call would otherwise take from ``generator``."""

    # Whether a reset is cheap enough to run every frame for auto-reset.
    # Envs whose reset runs physics (the lander) keep one reset pool per
    # superstep instead (algos/superstep.py).
    batch_reset_cheap: bool = False

    def default_params(self):
        raise NotImplementedError

    @property
    def num_actions(self) -> int:
        raise NotImplementedError

    def obs_shape(self, params) -> Tuple[int, ...]:
        raise NotImplementedError

    def reset_env(self, generator: torch.Generator, n: int, params, draws=None):
        """``n`` fresh episodes. Returns batched ``(obs, states)``."""
        raise NotImplementedError

    def reset_batch(self, generator: torch.Generator, n: int, params):
        return self.reset_env(generator, n, params)

    def get_obs(self, state, params) -> torch.Tensor:
        raise NotImplementedError

    def step_env(self, generator: torch.Generator, state, action, params, draws=None):
        """One transition of every instance.
        Returns ``(obs, state, reward, terminated, truncated)``."""
        raise NotImplementedError


@dataclasses.dataclass
class Transition:
    """One batched transition, the replay storage record.  ``next_obs`` is
    the true successor (pre-auto-reset)."""

    obs: torch.Tensor  # (N, *obs_shape)
    action: torch.Tensor  # (N,) int32
    reward: torch.Tensor  # (N,) float32
    next_obs: torch.Tensor  # (N, *obs_shape)
    terminated: torch.Tensor  # (N,) bool
    truncated: torch.Tensor  # (N,) bool


class VectorEnv:
    """``num_envs`` lockstep instances with auto-reset."""

    def __init__(self, env: Environment, num_envs: int):
        self.env = env
        self.num_envs = num_envs

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    def obs_shape(self, params) -> Tuple[int, ...]:
        return self.env.obs_shape(params)

    def reset(self, generator: torch.Generator, params):
        return self.env.reset_env(generator, self.num_envs, params)

    def fresh_pool(self, generator: torch.Generator, params):
        """Per-env reset pool for ``step(..., fresh=...)``, built once per
        superstep for envs whose reset runs physics."""
        return self.env.reset_env(generator, self.num_envs, params)

    def step(
        self,
        generator: torch.Generator,
        states: Any,
        actions: torch.Tensor,
        params,
        prev_obs: Optional[torch.Tensor] = None,
        fresh: Any = None,
    ) -> Tuple[torch.Tensor, Any, Transition]:
        """Step all instances; auto-reset finished ones.

        Returns ``(obs_after_autoreset, states_after_autoreset, transition)``.
        ``fresh`` is an optional ``fresh_pool`` result: env ``i`` resets
        into pool entry ``i``.  Without it, fresh states come from
        ``Environment.reset_batch`` on every call."""
        if prev_obs is None:
            prev_obs = self.env.get_obs(states, params)
        next_obs, next_states, reward, terminated, truncated = self.env.step_env(
            generator, states, actions, params
        )
        done = terminated | truncated
        if fresh is None:
            fresh = self.env.reset_batch(generator, self.num_envs, params)
        fresh_obs, fresh_states = fresh
        out_states = tree_where(done, fresh_states, next_states)
        out_obs = tree_where(done, fresh_obs, next_obs)
        transition = Transition(
            obs=prev_obs,
            action=actions,
            reward=reward,
            next_obs=next_obs,
            terminated=terminated,
            truncated=truncated,
        )
        return out_obs, out_states, transition
