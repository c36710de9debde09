"""Env-sharded actor-learner over ranks (``deep_q_learning_tpu/parallel/distributed.py``).

The JAX package's config 5 (``multihost_ddqn``): the envs are split over
the ranks of a process group (``parallel/mesh.py``), the learner is
replicated.  Each rank steps its own envs and keeps its own replay, PER
priorities and max priority, counters, generator and return window; it
samples a local sub-batch, and the update averages the gradients over the
ranks with one all-reduce (``algos/dqn.py::UpdateStep``), so the
replicated learner stays bitwise the same on every rank.  The rank's body
is the single-device ``build_superstep`` with the group passed in, as the
JAX shard body is the single-chip superstep plus one collective; its
metrics come back combined over the ranks
(``algos/superstep.py::reduce_metrics``, the JAX ``_reduce_metrics``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from deep_q_learning_tpu_torch.algos import build_superstep, make_optimizer
from deep_q_learning_tpu_torch.algos.superstep import SuperstepMetrics
from deep_q_learning_tpu_torch.envs import VectorEnv, make_env
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.replay import make_replay


def local_config(cfg, num_shards: int):
    """The config of one of ``num_shards`` ranks: its share of the envs and
    of the batch.  Raises, with the JAX package's messages, where either
    does not divide."""
    if cfg.num_envs % num_shards != 0:
        raise ValueError(f"num_envs={cfg.num_envs} not divisible by mesh size {num_shards}")
    if cfg.batch_size % num_shards != 0:
        raise ValueError(f"batch_size={cfg.batch_size} not divisible by mesh size {num_shards}")
    return dataclasses.replace(
        cfg, num_envs=cfg.num_envs // num_shards, batch_size=cfg.batch_size // num_shards
    )


def learner_checksum(online: torch.nn.Module) -> torch.Tensor:
    """A float64 sum over the learner's weights, weighted by position, on
    their device: two learners that differ give different sums (almost
    surely)."""
    total = torch.zeros((), dtype=torch.float64, device=next(online.parameters()).device)
    for i, p in enumerate(online.parameters()):
        flat = p.detach().reshape(-1).to(torch.float64)
        weights = torch.arange(1, flat.numel() + 1, dtype=torch.float64, device=flat.device)
        total = total + (i + 1) * (flat * weights).sum()
    return total


def build_distributed_superstep(
    cfg, device, group=None, graphed_learner: bool = True
) -> Tuple[Callable, Callable, torch.nn.Module]:
    """Build ``(init_runner, superstep, network)`` for this rank of
    ``group`` (the default process group if None; ``distributed_init``
    makes it).

    ``init_runner(seed) -> RunnerState`` builds this rank's runner: the
    learner from the same seed on every rank (checked with one checksum
    all-reduce), the envs, replay and generator from ``(seed, rank)``.
    ``superstep(runner) -> (runner, SuperstepMetrics)`` runs the rank's
    body; the metrics are combined over the ranks, and their ``env_steps``
    are vector steps (times the global ``cfg.num_envs`` for env steps).
    It runs as CUDA graph launches where ``graphed_learner`` is set and the
    env injects its draws (``build_superstep``), else eagerly."""
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError("no process group: call parallel.distributed_init() first")
        group = dist.group.WORLD
    num_shards = dist.get_world_size(group)
    shard = dist.get_rank(group)
    local_cfg = local_config(cfg, num_shards)

    env, env_params = make_env(
        cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
        param_overrides=cfg.env_param_overrides(),
    )
    venv = VectorEnv(env, local_cfg.num_envs)
    (obs_dim,) = env.obs_shape(env_params)
    network = QNetwork(
        obs_dim, env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling,
        compute_dtype=cfg.compute_dtype,
    )
    replay = make_replay(cfg, num_envs=local_cfg.num_envs)
    init_local, superstep = build_superstep(
        venv, env_params, network, make_optimizer(cfg), replay, local_cfg, device, group=group,
        graphed_learner=graphed_learner,
    )

    def init_runner(seed: int):
        runner = init_local(seed, shard)
        # the learner must start bitwise replicated: max(c) == -max(-c) on every rank
        c = learner_checksum(runner.train.online)
        both = torch.stack([c, -c])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        high, neg_low = both.tolist()
        if high != -neg_low:
            raise RuntimeError(f"the ranks initialised different learners ({high} vs {-neg_low})")
        return runner

    return init_runner, superstep, network


def aggregate_metrics(m: SuperstepMetrics, cfg, num_shards: int = 1) -> dict:
    """Host scalars of combined metrics: ``env_steps`` in env steps of the
    global ``cfg``, the mean loss.  ``num_shards`` is kept for the JAX
    signature; the metrics are already combined over the ranks."""
    return {
        "env_steps": m.env_steps * cfg.num_envs,
        "episodes": m.episodes,
        "episodes_delta": m.episodes_delta,
        "return_sum_delta": m.return_sum_delta,
        "loss": m.loss_sum / max(m.loss_count, 1.0),
        "window_mean": m.window_mean,
        "epsilon": m.epsilon,
        "solved": m.solved,
    }
