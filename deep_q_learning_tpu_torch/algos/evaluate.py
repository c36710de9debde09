"""Greedy policy evaluation that returns TRUE episode returns
(``deep_q_learning_tpu/algos/evaluate.py``).

One greedy episode per env, all in lockstep; an env is masked after its
first episode ends, and ``truncated`` marks episodes the evaluator cut at
``max_steps``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from deep_q_learning_tpu_torch.envs.base import VectorEnv

# steps between checks of "all episodes done" (each check reads the device)
_DONE_CHECK_EVERY = 32


class EvalResult(NamedTuple):
    """Per-episode greedy-eval outcome, shapes ``(num_envs,)``."""

    returns: torch.Tensor  # f32 sum of rewards until episode end / cutoff
    lengths: torch.Tensor  # int32; == max_steps for evaluator-truncated envs
    truncated: torch.Tensor  # bool: True iff the evaluator cut the episode


def build_evaluator(venv: VectorEnv, env_params: Any, max_steps: int) -> Callable:
    """Returns ``evaluate(network, generator) -> EvalResult``."""

    @torch.no_grad()
    def evaluate(network: torch.nn.Module, generator: torch.Generator) -> EvalResult:
        obs, states = venv.reset(generator, env_params)
        # finished envs are masked, so what they reset into does not matter:
        # reuse the start states as the reset pool instead of resetting anew
        pool = (obs, states)
        n = venv.num_envs
        device = obs.device
        rets = torch.zeros((n,), device=device)
        lengths = torch.full((n,), max_steps, dtype=torch.int32, device=device)
        done = torch.zeros((n,), dtype=torch.bool, device=device)
        for steps in range(max_steps):
            actions = torch.argmax(network(obs), dim=-1).to(torch.int32)
            obs, states, tr = venv.step(generator, states, actions, env_params, fresh=pool)
            live = ~done
            rets = rets + torch.where(live, tr.reward, 0.0)
            now_done = tr.terminated | tr.truncated
            lengths = torch.where(live & now_done, steps + 1, lengths).to(torch.int32)
            done = done | now_done
            if (steps + 1) % _DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
        return EvalResult(returns=rets, lengths=lengths, truncated=~done)

    return evaluate
