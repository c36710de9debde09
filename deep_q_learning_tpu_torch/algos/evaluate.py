"""Greedy policy evaluation that returns TRUE episode returns
(``deep_q_learning_tpu/algos/evaluate.py``).

One greedy episode per env, all in lockstep; an env is masked after its
first episode ends, and ``truncated`` marks episodes the evaluator cut at
``max_steps``.  The start states are the reset pool.

The JAX package runs the evaluation as one ``lax.while_loop``.  Here,
where the env injects its draws (the lander and the classic envs), each
eval step is one in-place CUDA graph on the card (``envs/graphed.py::
GraphedStep``): the forward, the greedy actions, the env step from the
start-state pool and the masked accounting, on static buffers, the step's
draws taken from the generator before each replay in the eager order.  The
graph is bound to the policy's tensors and to the evaluator's buffers: a
new network (a new runner, a restore, a population's new members) starts
it over with an eager call.  On the CPU the same step runs directly on the
same buffers.  ``graphed=False``, or an env that does not inject its
draws, runs each step eagerly, the env step as ``VectorEnv``'s (its graph
where it has one), with the same results.  Every ``_DONE_CHECK_EVERY``
steps one device read asks whether every episode has ended.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from deep_q_learning_tpu_torch.envs.base import VectorEnv
from deep_q_learning_tpu_torch.envs.graphed import GraphedStep, copy_into, tensors_of, tree_map

# steps between checks of "all episodes done" (each check reads the device)
_DONE_CHECK_EVERY = 32


class EvalResult(NamedTuple):
    """Per-episode greedy-eval outcome, shapes ``(num_envs,)``."""

    returns: torch.Tensor  # f32 sum of rewards until episode end / cutoff
    lengths: torch.Tensor  # int32; == max_steps for evaluator-truncated envs
    truncated: torch.Tensor  # bool: True iff the evaluator cut the episode


def _greedy(network, obs: torch.Tensor, members: Optional[int]) -> torch.Tensor:
    """The first maximum of each env's Q-values, int32; with ``members``,
    a member-stacked network over member ``m``'s envs at rows ``m·E``."""
    if members is None:
        q_values = network(obs)
    else:
        q_values = network(obs.view(members, obs.shape[0] // members, -1)).flatten(0, 1)
    return torch.argmax(q_values, dim=-1).to(torch.int32)


class _EvalWork:
    """What the graphed eval step runs, and its static buffers: the start
    states (the reset pool), the running observations and states, the
    step's draws, and the accounting (returns, lengths, done, the steps
    taken).  It holds no graph, so its step makes no reference cycle."""

    def __init__(self, venv: VectorEnv, env_params: Any, members: Optional[int]):
        self.venv, self.env_params, self.members = venv, env_params, members
        self.network = None
        self.pool = self.state = self.draws = None
        self.rets = self.lengths = self.done = self.steps = None

    def start(self, network, pool, max_steps: int) -> None:
        """Copy the start states into the static buffers; zero the
        accounting."""
        self.network = network
        if self.pool is None:
            n, device = self.venv.num_envs, pool[0].device
            self.pool, self.state = pool, tree_map(torch.clone, pool)
            self.rets = torch.zeros((n,), device=device)
            self.lengths = torch.zeros((n,), dtype=torch.int32, device=device)
            self.done = torch.zeros((n,), dtype=torch.bool, device=device)
            self.steps = torch.zeros((), dtype=torch.int32, device=device)
        else:
            copy_into(self.pool, pool)
            copy_into(self.state, pool)
        self.rets.zero_()
        self.lengths.fill_(max_steps)
        self.done.zero_()
        self.steps.zero_()

    def statics(self):
        return tensors_of([self.pool, self.state, self.draws, self.rets, self.lengths, self.done,
                           self.steps])

    def step(self, *_bound) -> None:
        """One greedy step of every env, in place."""
        obs, states = self.state
        actions = _greedy(self.network, obs, self.members)
        obs, states, tr = self.venv._step(None, states, actions, self.env_params, obs, self.pool,
                                          self.draws)
        live = ~self.done
        self.rets.copy_(self.rets + torch.where(live, tr.reward, 0.0))
        now_done = tr.terminated | tr.truncated
        self.steps.add_(1)
        self.lengths.copy_(torch.where(live & now_done, self.steps, self.lengths))
        self.done.copy_(self.done | now_done)
        copy_into(self.state, (obs, states))


def build_evaluator(venv: VectorEnv, env_params: Any, max_steps: int,
                    members: Optional[int] = None, graphed: bool = True) -> Callable:
    """Returns ``evaluate(network, generator, max_steps=None) -> EvalResult``;
    a ``max_steps`` given to a call cuts its episodes sooner.  With
    ``members`` M, ``network`` is member-stacked and member ``m`` plays the
    ``venv.num_envs // M`` envs at rows ``m·E``.  Each eval step is a CUDA
    graph where ``graphed`` is set and ``venv`` graphs its step (module
    docstring)."""
    default_max_steps = max_steps
    work = _EvalWork(venv, env_params, members)
    graph = GraphedStep(work.step, f"the greedy eval step of {venv.num_envs} "
                        f"{venv.env.name}", in_place=True)

    @torch.no_grad()
    def evaluate_graphed(network, generator: torch.Generator, max_steps: int) -> EvalResult:
        if not isinstance(network, torch.nn.Module):
            raise TypeError("a graphed evaluation is bound to a module's tensors: pass the "
                            "network, or build the evaluator with graphed=False")
        # finished envs are masked, so what they reset into does not matter:
        # the start states are the reset pool
        work.start(network, venv.reset(generator, env_params), max_steps)
        env, n = venv.env, venv.num_envs
        for steps in range(max_steps):
            draws = env.step_draws(generator, n)
            if work.draws is None:
                work.draws = tree_map(torch.clone, draws)
            else:
                copy_into(work.draws, draws)
            graph(tensors_of(network) + work.statics())
            if (steps + 1) % _DONE_CHECK_EVERY == 0 and bool(work.done.all()):
                break
        return EvalResult(returns=work.rets.clone(), lengths=work.lengths.clone(),
                          truncated=~work.done)

    @torch.no_grad()
    def evaluate_eager(network, generator: torch.Generator, max_steps: int) -> EvalResult:
        obs, states = venv.reset(generator, env_params)
        pool = (obs, states)
        n = venv.num_envs
        device = obs.device
        rets = torch.zeros((n,), device=device)
        lengths = torch.full((n,), max_steps, dtype=torch.int32, device=device)
        done = torch.zeros((n,), dtype=torch.bool, device=device)
        for steps in range(max_steps):
            actions = _greedy(network, obs, members)
            obs, states, tr = venv.step(generator, states, actions, env_params, fresh=pool)
            live = ~done
            rets = rets + torch.where(live, tr.reward, 0.0)
            now_done = tr.terminated | tr.truncated
            lengths = torch.where(live & now_done, steps + 1, lengths).to(torch.int32)
            done = done | now_done
            if (steps + 1) % _DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
        return EvalResult(returns=rets, lengths=lengths, truncated=~done)

    run = evaluate_graphed if graphed and venv.graphed else evaluate_eager

    def evaluate(network, generator: torch.Generator,
                 max_steps: Optional[int] = None) -> EvalResult:
        return run(network, generator, default_max_steps if max_steps is None else max_steps)

    evaluate.graph = graph if run is evaluate_graphed else None
    return evaluate
