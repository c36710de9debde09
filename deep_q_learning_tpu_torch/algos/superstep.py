"""The actor-learner superstep (``deep_q_learning_tpu/algos/superstep.py``).

One call runs ``cfg.steps_per_superstep`` vector steps, each: ε-greedy
actor forward → vector env step with auto-reset → replay write → episode
accounting → (on training frames) prioritized n-step sample, learner
update, priority update → target sync.

PyTorch runs this eagerly, so the JAX package's XLA-specific structure goes:
the cadence and warmup gates are plain Python decisions on counters the
host knows without reading the device (``env_step``, the replay cursor and
fill), the sample runs only on frames that train, and nothing in the
per-frame loop reads a device value back.  Metrics are read once, at the
end of the superstep.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.algos.dqn import (
    HyperParams,
    TrainState,
    build_update_step,
    epsilon_by_schedule,
    epsilon_greedy,
    init_train_state,
    sync_target,
)
from deep_q_learning_tpu_torch.envs.base import Transition, VectorEnv


@dataclasses.dataclass
class RunnerState:
    """Everything the training loop owns.  Host counters are ints; the
    others live on the device."""

    train: TrainState
    hyper: HyperParams
    env_states: Any  # batched env state, leaves (N, ...)
    obs: torch.Tensor  # (N, D) current observations
    replay: Any  # ReplayState | PrioritizedReplayState
    generator: torch.Generator  # all draws after init (device generator)
    env_step: int  # vector steps taken (aggregate steps = env_step * N)
    episodes: torch.Tensor  # () int64 completed episodes
    last_sync_episodes: torch.Tensor  # () int64 episode count at the last hard sync
    ep_return: torch.Tensor  # (N,) f32 running return per env
    ep_length: torch.Tensor  # (N,) int32 running length per env
    return_window: torch.Tensor  # (W,) f32 ring of completed returns
    window_cursor: torch.Tensor  # () int64
    window_filled: torch.Tensor  # () int64


@dataclasses.dataclass
class SuperstepMetrics:
    """Read back once per superstep, as Python numbers."""

    env_steps: int  # VECTOR steps so far (aggregate = env_steps * num_envs)
    episodes: int
    episodes_delta: int  # completed during this superstep
    return_sum_delta: float  # sum of returns completed this superstep
    loss_sum: float
    loss_count: int  # learner updates this superstep
    window_mean: float  # mean of the last W completed returns (-inf if none)
    epsilon: float
    solved: bool  # window full and mean >= threshold


def _scatter_completed_returns(
    window: torch.Tensor,
    cursor: torch.Tensor,
    filled: torch.Tensor,
    done: torch.Tensor,
    returns: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write the returns of the envs that finished this step into the ring
    window: each finisher's slot is its rank among finishers (env order)
    past the cursor.  Only the last ``W`` finishers can survive the ring, and
    their slots are unique, so they are written directly; the others go to
    a spare slot past the end that is then dropped.  No host sync."""
    w = window.shape[0]
    done_i = done.to(torch.int64)
    rank = torch.cumsum(done_i, dim=0) - 1  # rank among finished, in env order
    num_done = done_i.sum()
    sel = done & (rank >= num_done - w)
    slot = torch.where(sel, (cursor + rank) % w, w)
    padded = torch.cat([window, window.new_zeros(1)])
    padded.scatter_(0, slot, returns)
    return padded[:w], (cursor + num_done) % w, torch.clamp(filled + num_done, max=w)


def _seeds(seed: int, n: int):
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


def build_superstep(
    venv: VectorEnv,
    env_params: Any,
    network: torch.nn.Module,
    optimizer,
    replay,
    cfg,
    device,
) -> Tuple[Callable, Callable]:
    """Build ``(init_runner, superstep)``.

    ``init_runner(seed) -> RunnerState`` initialises a copy of ``network``
    (flax init from a CPU generator, so the weights for a seed are the same
    on every device) and everything else on ``device``.
    ``superstep(runner) -> (runner, SuperstepMetrics)`` advances ``runner``
    in place."""
    device = torch.device(device)
    update = build_update_step(optimizer, cfg)
    num_envs = venv.num_envs
    threshold = math.inf if cfg.solve_threshold is None else cfg.solve_threshold

    def init_runner(seed: int) -> RunnerState:
        net_seed, run_seed = _seeds(seed, 2)
        online = copy.deepcopy(network).to("cpu")
        online.reset_parameters(torch.Generator().manual_seed(net_seed))
        train = init_train_state(online.to(device), optimizer)
        generator = torch.Generator(device=device).manual_seed(run_seed)
        obs, env_states = venv.reset(generator, env_params)
        example = Transition(
            obs=obs,
            action=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            reward=torch.zeros((num_envs,), device=device),
            next_obs=obs,
            terminated=torch.zeros((num_envs,), dtype=torch.bool, device=device),
            truncated=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        )
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return RunnerState(
            train=train,
            hyper=HyperParams.from_config(cfg),
            env_states=env_states,
            obs=obs,
            replay=replay.init(example),
            generator=generator,
            env_step=0,
            episodes=zero.clone(),
            last_sync_episodes=zero.clone(),
            ep_return=torch.zeros((num_envs,), device=device),
            ep_length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            return_window=torch.zeros((cfg.return_window,), device=device),
            window_cursor=zero.clone(),
            window_filled=zero.clone(),
        )

    def _maybe_train(r: RunnerState) -> Optional[torch.Tensor]:
        """``cfg.updates_per_step`` updates when the cadence and the warmup
        gate (in stored transitions) allow; returns their loss sum or None."""
        h = r.hyper
        if r.env_step % h.train_every or r.replay.filled * num_envs < h.training_start:
            return None
        loss_sum = None
        for _ in range(cfg.updates_per_step):
            batch, info, weights = replay.sample_with_info(
                r.replay, r.generator, cfg.batch_size, gamma=h.gamma, beta=h.per_beta
            )
            _, loss, td = update(r.train, batch, weights, h)
            replay.update_priorities(r.replay, info, td)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum

    def _maybe_sync(r: RunnerState) -> None:
        """Hard target sync on the configured cadence; with ``target_tau``
        set the update step does a Polyak update instead."""
        if cfg.target_tau is not None:
            return
        if cfg.target_sync_mode == "steps":
            if r.env_step % r.hyper.target_sync_every == 0:
                sync_target(r.train)
        elif cfg.target_sync_mode == "episodes":
            # the episode count lives on the device: decide there
            k = r.hyper.target_replace_episodes
            do_sync = (r.episodes // k) > (r.last_sync_episodes // k)
            sync_target(r.train, do_sync)
            r.last_sync_episodes = torch.where(do_sync, r.episodes, r.last_sync_episodes)
        else:
            raise ValueError(f"unknown target_sync_mode {cfg.target_sync_mode!r}")

    def superstep(r: RunnerState) -> Tuple[RunnerState, SuperstepMetrics]:
        # the lander's reset runs physics: one reset pool per superstep
        fresh = None if venv.env.batch_reset_cheap else venv.fresh_pool(r.generator, env_params)
        loss_sum = torch.zeros((), device=device)
        loss_count = 0
        ep_delta = torch.zeros((), dtype=torch.int64, device=device)
        ret_delta = torch.zeros((), device=device)

        for _ in range(cfg.steps_per_superstep):
            # --- actor: ε-greedy -------------------------------------------
            eps = epsilon_by_schedule(cfg, r.env_step * num_envs, r.episodes, r.hyper)
            with torch.no_grad():
                q_values = r.train.online(r.obs)
            actions = epsilon_greedy(r.generator, q_values, eps)

            # --- env step with auto-reset, replay write ----------------------
            r.obs, r.env_states, tr = venv.step(
                r.generator, r.env_states, actions, env_params, prev_obs=r.obs, fresh=fresh
            )
            replay.add(r.replay, tr)

            # --- episode accounting -----------------------------------------
            done = tr.terminated | tr.truncated
            ep_return = r.ep_return + tr.reward
            r.return_window, r.window_cursor, r.window_filled = _scatter_completed_returns(
                r.return_window, r.window_cursor, r.window_filled, done, ep_return
            )
            num_done = done.sum()
            r.episodes = r.episodes + num_done
            ret_delta = ret_delta + torch.where(done, ep_return, 0.0).sum()
            ep_delta = ep_delta + num_done
            r.ep_return = torch.where(done, 0.0, ep_return)
            r.ep_length = torch.where(done, 0, r.ep_length + 1).to(torch.int32)

            # --- learner ----------------------------------------------------
            r.env_step += 1
            step_loss = _maybe_train(r)
            if step_loss is not None:
                loss_sum = loss_sum + step_loss
                loss_count += cfg.updates_per_step
            _maybe_sync(r)

        window_mean = torch.where(
            r.window_filled > 0,
            r.return_window.sum() / torch.clamp(r.window_filled, min=1),
            -math.inf,
        )
        eps = epsilon_by_schedule(cfg, r.env_step * num_envs, r.episodes, r.hyper)
        # the one device->host read of the superstep
        episodes, ep_d, ret_d, loss_s, mean, filled, eps_v = torch.stack([
            r.episodes.to(torch.float64),
            ep_delta.to(torch.float64),
            ret_delta.to(torch.float64),
            loss_sum.to(torch.float64),
            window_mean.to(torch.float64),
            r.window_filled.to(torch.float64),
            torch.as_tensor(eps, dtype=torch.float64, device=device),
        ]).tolist()
        metrics = SuperstepMetrics(
            env_steps=r.env_step,
            episodes=int(episodes),
            episodes_delta=int(ep_d),
            return_sum_delta=ret_d,
            loss_sum=loss_s,
            loss_count=loss_count,
            window_mean=mean,
            epsilon=eps_v,
            solved=filled >= cfg.return_window and mean >= threshold,
        )
        return r, metrics

    return init_runner, superstep
