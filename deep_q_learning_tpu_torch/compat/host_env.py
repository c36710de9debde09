"""Host-protocol adapters for the engine-fidelity experiment
(``deep_q_learning_tpu/compat/host_env.py``).

:class:`HostAgent` (``compat/host_loop.py``) runs any stateful reset/step
env; this module supplies the two sides of a comparison of physics engines
under one algorithm:

  * :class:`TorchHostEnv` — a batched port env (``envs/``) behind the
    classic stateful 5-tuple API, one instance whose state stays on the
    device, and
  * :class:`TimeFractionHostWrapper` — the reference's observation
    augmentation (append ``fraction_finished = t / max_steps``) for host
    envs, so Box2D runs see the 9-feature observation the reference
    trained on.

``make_host_env`` builds either engine from one spec.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.envs.graphed import GraphedStep
from deep_q_learning_tpu_torch.train import resolve_device


class TorchHostEnv:
    """Stateful host adapter over a batched port environment, one instance.

    reset() -> (obs, info); step(a) -> (obs, reward, terminated, truncated,
    info) — the gymnasium 5-tuple protocol that ``HostAgent`` speaks.  The
    env state (``state``, batch of 1) stays on ``device`` and the random
    draws come from a ``torch.Generator`` there; each step brings the
    observation, the reward and both flags to the host in one copy.  There
    is no auto-reset: the caller resets after a finished episode.

    For an env that injects its draws (the lander), the draws are taken
    from the generator first and the step and the reset run through
    :class:`~deep_q_learning_tpu_torch.envs.graphed.GraphedStep`: one CUDA
    graph each on the card, the step's graph packing what the host reads;
    ``graphed=False`` runs them eagerly.  ``state`` is then the step
    graph's output, overwritten by the next step."""

    def __init__(self, env, params=None, seed: int = 0, device="cuda", graphed: bool = True):
        self.env = env
        self.params = env.default_params() if params is None else params
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # one (1,) int32 view per action: a step copies no action to the device
        self._actions = torch.arange(env.num_actions, dtype=torch.int32, device=self.device)
        self.state = None
        self.graphed = graphed and env.injects_draws
        self._step = GraphedStep(self._packed_step, f"{env.name}'s host step")
        self._reset = GraphedStep(lambda d: env.reset_env(None, 1, self.params, d),
                                  f"{env.name}'s host reset")

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    def obs_dim(self) -> int:
        (d,) = self.env.obs_shape(self.params)
        return d

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._generator.manual_seed(seed)
        if self.graphed:
            obs, self.state = self._reset(self.env.reset_draws(self._generator, 1))
        else:
            obs, self.state = self.env.reset_env(self._generator, 1, self.params)
        # a copy: on the CPU, .cpu() of the stepper's static output is the buffer itself
        return obs[0].to("cpu", copy=True).numpy(), {}

    def _packed_step(self, state, action, draws, generator=None):
        """The step; obs, reward and both flags (exactly 0.0 or 1.0) packed
        in one float32 tensor for the host's one copy."""
        obs, state, reward, terminated, truncated = self.env.step_env(
            generator, state, action, self.params, draws
        )
        host = torch.cat([
            obs.reshape(-1), reward.reshape(1), terminated.to(torch.float32),
            truncated.to(torch.float32),
        ])
        return state, host

    def step(self, action, draws: Optional[torch.Tensor] = None):
        """One transition.  ``draws`` injects the random numbers the env's
        step would take from the generator (``Environment.step_env``)."""
        a = int(action)
        if not 0 <= a < self.env.num_actions:
            raise ValueError(f"action {a} outside [0, {self.env.num_actions})")
        action = self._actions[a : a + 1]
        if not self.graphed:
            self.state, packed = self._packed_step(self.state, action, draws, self._generator)
        else:
            if draws is None:
                draws = self.env.step_draws(self._generator, 1)
            self.state, packed = self._step(self.state, action, draws)
        host = packed.to("cpu", copy=True).numpy()
        d = host.shape[0] - 3
        return host[:d], float(host[d]), bool(host[d + 1]), bool(host[d + 2]), {}


class TimeFractionHostWrapper:
    """Append ``t / max_steps`` as an extra feature (ref ``env.py:19-21``).

    The reference increments its internal counter on every ``observation()``
    call, so the first post-reset obs carries fraction 0 and the obs after
    step k carries k/max_steps — matched here (and by the batched
    ``TimeFractionObs`` wrapper, which reads the env state's ``t``).
    """

    def __init__(self, env, max_steps: int):
        self.env = env
        self.max_steps = max_steps
        self._t = 0

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _augment(self, obs: np.ndarray) -> np.ndarray:
        frac = np.float32(self._t / self.max_steps)
        return np.concatenate([np.asarray(obs, np.float32).reshape(-1), [frac]])

    def reset(self, seed: Optional[int] = None):
        out = self.env.reset(seed=seed) if seed is not None else self.env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        self._t = 0
        return self._augment(obs), {}

    def step(self, action):
        out = self.env.step(action)
        self._t += 1
        if len(out) == 5:
            obs, r, term, trunc, info = out
        else:  # classic 4-tuple
            obs, r, done, info = out
            term, trunc = done, False
        return self._augment(obs), r, term, trunc, info


def make_host_env(
    engine: str,
    env_id: str = "LunarLander-v2",
    max_steps: int = 1500,
    time_fraction: bool = True,
    seed: int = 0,
    device="cuda",
) -> Tuple[object, int, int]:
    """Build a host env for ``engine`` in {"box2d", "torch"}.

    Returns (env, obs_dim, num_actions).  ``"torch"`` is the port's env
    with the registry's default params (the jointed lander for
    ``LunarLander-v2``) on ``device``, the counterpart of the JAX package's
    ``"jax"`` engine.  The Box2D side uses gymnasium's canonical
    implementation (LunarLander-v3 is the maintained registration of the
    reference's LunarLander-v2 task) UNWRAPPED, on the host: episode
    truncation is the agent's job, exactly as in the reference
    (``q_agent.py:179-180`` forces done at its own max_steps).
    """
    if engine == "torch":
        from deep_q_learning_tpu_torch.envs import make_env

        env, params = make_env(env_id, max_steps_in_episode=max_steps)
        base = TorchHostEnv(env, params, seed=seed, device=device)
        obs_dim, num_actions = base.obs_dim(), base.num_actions
    elif engine == "box2d":
        import gymnasium as gym

        gym_id = env_id
        if gym_id not in gym.registry:  # e.g. LunarLander-v2 -> -v3
            family = gym_id.split("-")[0]
            cands = sorted(k for k in gym.registry if k.split("-")[0] == family)
            if not cands:
                raise ValueError(f"no gymnasium registration for {env_id}")
            gym_id = cands[-1]
        base = gym.make(gym_id).unwrapped
        base.reset(seed=seed)
        obs_dim = int(np.prod(base.observation_space.shape))
        num_actions = int(base.action_space.n)
    elif engine == "jax":
        raise ValueError(
            "engine 'jax' is the JAX package's; the PyTorch port's own env engine is 'torch'"
        )
    else:
        raise ValueError(f"engine must be 'box2d' or 'torch', got {engine!r}")

    if time_fraction:
        base = TimeFractionHostWrapper(base, max_steps)
        obs_dim += 1
    return base, obs_dim, num_actions
