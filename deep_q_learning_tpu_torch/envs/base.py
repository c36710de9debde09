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
from typing import Any, Generic, Optional, Tuple, TypeVar

import torch

from deep_q_learning_tpu_torch.envs.graphed import GraphedStep, tree_map

TEnvState = TypeVar("TEnvState")
TEnvParams = TypeVar("TEnvParams")


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Base class for static environment parameters."""

    max_steps_in_episode: int = 1000


def tree_where(mask: torch.Tensor, fresh: Any, stepped: Any) -> Any:
    """Per-env select ``mask ? fresh : stepped`` over a tensor or a
    dataclass of batched tensors, nested dataclasses and ``None`` fields
    (absent on both sides) included."""
    if stepped is None:
        return None
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


def uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """Float32 uniform on ``[lo, hi)``, drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


class Environment(Generic[TEnvState, TEnvParams]):
    """Abstract batched environment.

    Subclasses implement ``reset_env`` / ``step_env`` / ``get_obs`` over
    batched states.  ``draws`` lets a caller (a parity test) inject the
    random numbers a call would otherwise take from ``generator``."""

    # Whether a reset is cheap enough to run every frame for auto-reset.
    # Envs whose reset runs physics (the lander) keep one reset pool per
    # superstep instead (algos/superstep.py).
    batch_reset_cheap: bool = False
    # Whether ``step_env`` and ``reset_env`` take every random number they
    # use through ``draws`` (drawn by ``step_draws`` / ``reset_draws``, in
    # the order the generator would give them), so that ``VectorEnv`` can
    # run them in a CUDA graph (``envs/graphed.py``).
    injects_draws: bool = False

    def default_params(self) -> TEnvParams:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

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

    def get_obs(self, state: TEnvState, params: TEnvParams) -> torch.Tensor:
        raise NotImplementedError

    def step_draws(self, generator: torch.Generator, n: int):
        """The ``draws`` that ``step_env`` would take from ``generator``."""
        raise NotImplementedError

    def reset_draws(self, generator: torch.Generator, n: int):
        """The ``draws`` that ``reset_env`` would take from ``generator``."""
        raise NotImplementedError

    def step_env(self, generator: torch.Generator, state, action, params, draws=None):
        """One transition of every instance.
        Returns ``(obs, state, reward, terminated, truncated)``."""
        raise NotImplementedError

    def fuses_vector_step(self, params, state, fresh) -> bool:
        """Whether :meth:`vector_step` runs ``VectorEnv``'s step as one call
        for these params, this state's device and the reset pool ``fresh``
        (or None, the resets from the reset's draws): a matter of
        configuration (engine, device, pool), never of a failure."""
        return False

    def vector_step(self, generator: torch.Generator, state, action, params, fresh, draws=None,
                    reset_draws=None, time_feature: bool = False):
        """The vector step with the auto-reset as one call, where
        :meth:`fuses_vector_step` holds: from the pool ``fresh``, or where it
        is None from ``reset_draws`` (``reset_draws``' draws); returns
        ``(out_obs, out_state, next_obs, reward, terminated, truncated)``,
        what ``VectorEnv._step`` composes from ``step_env``, the reset and
        the selects; each observation ends in ``t / max_steps`` with
        ``time_feature`` (``TimeFractionObs``)."""
        raise NotImplementedError

    # the JAX package's "jittable edges": thin calls onto the env functions
    def reset(self, generator: torch.Generator, n: int, params, draws=None):
        return self.reset_env(generator, n, params, draws)

    def step(self, generator: torch.Generator, state, action, params, draws=None):
        return self.step_env(generator, state, action, params, draws)


class ClassicControl(Environment):
    """A classic-control env (CartPole, Acrobot, MountainCar): its reset is
    one bulk draw of the caller's generator, cheap enough to run every frame
    and taken first where it is injected (``reset_draws``); a step draws
    nothing.  On CUDA tensors its step, and its vector step without a pool,
    run as one launch of its kernel (``ops/classic_kernels.py``, the env
    named by ``kernel``); on CPU tensors the plain version,
    :meth:`step_env_reference`, and ``VectorEnv._step``'s composition."""

    # the reset is one bulk draw: auto-reset runs it every frame
    batch_reset_cheap = True
    # the reset's draw can be taken first and injected, so VectorEnv runs
    # the step with auto-reset as a CUDA graph (envs/graphed.py)
    injects_draws = True
    kernel: str = ""  # the env's key in ops/classic_kernels.py::SPECS

    def step_draws(self, generator, n):
        return None  # a step draws nothing

    def step_env(self, generator, state, action, params, draws=None):
        """One transition, ``(obs, state, reward, terminated, truncated)``:
        the kernel's step entry on CUDA tensors (it launches or raises),
        :meth:`step_env_reference` on CPU tensors."""
        from deep_q_learning_tpu_torch.ops import classic_kernels

        if state.t.device.type != "cpu":
            return classic_kernels.classic_step_kernel(self.kernel, state,
                                                       action.to(torch.int32), params)
        classic_kernels.plain_calls[self.kernel] += 1
        return self.step_env_reference(generator, state, action, params, draws)

    def step_env_reference(self, generator, state, action, params, draws=None):
        """The plain version of :meth:`step_env`, on either device."""
        raise NotImplementedError

    def fuses_vector_step(self, params, state, fresh) -> bool:
        """Without a pool, on CUDA tensors: the kernel's vector entry."""
        return fresh is None and state.t.device.type == "cuda"

    def vector_step(self, generator, state, action, params, fresh, draws=None, reset_draws=None,
                    time_feature: bool = False):
        """``VectorEnv._step`` without a pool in one launch of the env's
        kernel (``ops/classic_kernels.py::classic_vector_kernel``): the step,
        ``done``, the reset from ``reset_draws`` (drawn here where None),
        the auto-reset's selects and, with ``time_feature``,
        ``TimeFractionObs``' feature.  CUDA tensors only (it raises
        elsewhere); the plain version is ``VectorEnv._step``'s composition."""
        from deep_q_learning_tpu_torch.ops import classic_kernels

        if reset_draws is None:
            reset_draws = self.reset_draws(generator, action.shape[0])
        return classic_kernels.classic_vector_kernel(
            self.kernel, state, action.to(torch.int32), params, reset_draws.contiguous(),
            time_feature)


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
    """``num_envs`` lockstep instances with auto-reset.

    For an env that injects its draws (the lander, rigid and jointed, and
    the classic envs), ``step`` and ``fresh_pool`` draw their random
    numbers from the generator, in the order the eager calls draw them, and
    run the rest through a
    :class:`~deep_q_learning_tpu_torch.envs.graphed.GraphedStep`: on a CUDA
    device one CUDA graph of the vector step, auto-reset included, and one
    of the reset pool, each captured at its first call.  A step that draws
    nothing (the classic envs': only their resets draw) has ``None`` for
    its step draws.  The outputs are then the graph's static outputs,
    overwritten by the next call: copy what must outlive it.
    ``graphed=False``, or an env that does not inject its draws, runs every
    call eagerly."""

    def __init__(self, env: Environment, num_envs: int, graphed: bool = True):
        self.env = env
        self.num_envs = num_envs
        self.graphed = graphed and env.injects_draws
        self._graphs = {}  # (kind, params, device) -> GraphedStep

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    def obs_shape(self, params) -> Tuple[int, ...]:
        return self.env.obs_shape(params)

    def _graph(self, kind: str, params, device: torch.device, fn) -> GraphedStep:
        key = (kind, params, device)
        if key not in self._graphs:
            self._graphs[key] = GraphedStep(fn, f"{self.env.name}'s {kind} of {self.num_envs}")
        return self._graphs[key]

    def _pool(self, generator: torch.Generator, params):
        draws = self.env.reset_draws(generator, self.num_envs)
        pool = self._graph("reset pool", params, generator.device,
                           lambda d: self.env.reset_env(None, self.num_envs, params, d))
        return pool(draws)

    def reset(self, generator: torch.Generator, params):
        """``num_envs`` fresh episodes, ``(obs, states)``, the caller's own
        (never a graph's outputs)."""
        if not self.graphed:
            return self.env.reset_env(generator, self.num_envs, params)
        return tree_map(torch.clone, self._pool(generator, params))

    def fresh_pool(self, generator: torch.Generator, params):
        """Per-env reset pool for ``step(..., fresh=...)``, built once per
        superstep for envs whose reset runs physics."""
        if not self.graphed:
            return self.env.reset_env(generator, self.num_envs, params)
        return self._pool(generator, params)

    def _step(self, generator, states, actions, params, prev_obs, fresh, step_draws=None,
              reset_draws=None):
        """The vector step with auto-reset.  Random numbers come from
        ``generator`` where their draws are None; ``fresh`` None resets
        through ``reset_batch``, or from ``reset_draws`` where given.  An
        env that fuses its vector step for these params, tensors and pool
        runs it as one call: the rigid lander on the card with a pool, a
        classic env on the card without one (one kernel each); otherwise
        the step, ``done``, the reset and the selects, the plain
        composition."""
        if self.env.fuses_vector_step(params, states, fresh):
            if fresh is None and reset_draws is None:
                # reset_batch's draw, in the eager order: a step that fuses
                # without a pool draws nothing
                reset_draws = self.env.reset_draws(generator, self.num_envs)
            out_obs, out_states, next_obs, reward, terminated, truncated = self.env.vector_step(
                generator, states, actions, params, fresh, step_draws, reset_draws)
        else:
            next_obs, next_states, reward, terminated, truncated = self.env.step_env(
                generator, states, actions, params, step_draws
            )
            done = terminated | truncated
            if fresh is None:
                fresh = (self.env.reset_batch(generator, self.num_envs, params)
                         if reset_draws is None
                         else self.env.reset_env(None, self.num_envs, params, reset_draws))
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
        if not self.graphed:
            return self._step(generator, states, actions, params, prev_obs, fresh)
        # the draws in the eager step's order: the step's (None where a step
        # draws nothing), then the resets'
        draws = [self.env.step_draws(generator, self.num_envs)]
        if fresh is None:
            draws.append(self.env.reset_draws(generator, self.num_envs))
        kind = "step" if fresh is not None else "step with resets"
        step = self._graph(kind, params, generator.device,
                           lambda s, a, o, f, *d: self._step(None, s, a, params, o, f, *d))
        return step(states, actions, prev_obs, fresh, *draws)
