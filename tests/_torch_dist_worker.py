"""One gloo rank of ``tests/test_torch_distributed.py``.

The test module spawns ``WORLD`` of these once (``parallel.spawn_ranks``:
``torch.multiprocessing``, spawn), joined over ``tcp://localhost:<port>``.
Each rank runs every scenario below on the CPU at tiny widths and returns
one report: counters and metrics per superstep, digests of its learner (online
and target weights, Adam moments and count) and of its whole runner, the same
from the eager rank (``graphed_learner=False``) beside the graphed one, and
the results of one all-reduced update from the inputs the test prepared.  It
imports no JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

WORLD = 2
SUPERSTEPS = 4


def cartpole_cfg(**overrides):
    """A tiny ``multihost_ddqn``-shaped CartPole run whose warm-up gate
    (80 global transitions = vector step 10 at 8 envs) falls inside the
    second superstep."""
    from deep_q_learning_tpu_torch.config import DQNConfig

    cfg = DQNConfig(
        env_id="CartPole-v1", num_envs=8, steps_per_superstep=8, batch_size=16,
        training_start=80, buffer_capacity=512, double=False, dueling=False, hidden=(16, 16),
        learning_rate=5e-4, eps_schedule="linear_step", eps_decay_steps=2000, train_every=1,
        target_sync_mode="steps", target_sync_every=16, return_window=8,
    )
    return dataclasses.replace(cfg, **overrides)


def update_cfg(use_pallas: bool):
    """``lunar_per``'s learner (double, dueling, huber, adam with a clip,
    Polyak) at hidden (16, 16) and a global batch of 32 (16 a rank)."""
    from deep_q_learning_tpu_torch.config import lunar_per

    return dataclasses.replace(lunar_per(), hidden=(16, 16), batch_size=32, use_pallas=use_pallas)


def learner_digest(train) -> str:
    import numpy as np

    h = hashlib.sha256()
    tensors = [*train.online.parameters(), *train.target.parameters(),
               *train.opt_state.mu, *train.opt_state.nu]
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    h.update(np.int64(train.opt_state.count).tobytes())
    return h.hexdigest()


def runner_digest(runner) -> str:
    """sha256 of every tensor of a runner (learner, replay, env states,
    counters, window) and of its host counters."""
    from deep_q_learning_tpu_torch.envs.graphed import tensors_of

    h = hashlib.sha256()
    for t in tensors_of(runner):
        h.update(t.detach().cpu().numpy().tobytes())
    h.update(repr((runner.env_step, runner.train.updates, runner.train.opt_state.count,
                   runner.replay.cursor, runner.replay.total_adds)).encode())
    return h.hexdigest()


def _metrics(m) -> dict:
    return dataclasses.asdict(m)


def _step(tr) -> tuple:
    """One superstep: its metrics, the learner's digest and the runner's."""
    m = _metrics(tr.step())
    return m, learner_digest(tr.runner.train), runner_digest(tr.runner)


def _counters(cfg, workdir: str) -> dict:
    """Supersteps of ``cfg``, graphed (``GraphedLearner``), and the same
    supersteps of the eager rank from the same seed; a checkpoint, one more
    superstep, and two restores that each take that superstep again, and
    the eager rank restored from the graphed one's checkpoint taking it
    too; then a restore under a world size of 1, which must be refused."""
    import torch.distributed as dist

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.train import DistributedTrainer

    tr = DistributedTrainer(cfg, device="cpu", workdir=workdir).init(seed=7)
    eager = DistributedTrainer(cfg, device="cpu", graphed_learner=False).init(seed=7)
    steps = [_step(tr) for _ in range(SUPERSTEPS)]
    metrics = [m for m, _, _ in steps]
    out = {
        "metrics": metrics,
        "local_episodes": int(tr.runner.episodes),
        "updates": tr.runner.train.updates,
        "digest": learner_digest(tr.runner.train),
        "last_sync_episodes": int(tr.runner.last_sync_episodes),
        "graphed": [type(t._superstep) is GraphedLearner for t in (tr, eager)],
        "graphed_steps": steps,
        "eager_steps": [_step(eager) for _ in range(SUPERSTEPS)],
    }
    step = metrics[-1]["env_steps"] * cfg.num_envs
    tr.save(step)
    out["resumed"] = [(_metrics(tr.step()), learner_digest(tr.runner.train))]
    for _ in range(2):
        t2 = DistributedTrainer(cfg, device="cpu", workdir=workdir).init(seed=99)
        t2.restore(step)
        restored = learner_digest(t2.runner.train)
        out["resumed"].append((_metrics(t2.step()), learner_digest(t2.runner.train), restored))
    e2 = DistributedTrainer(cfg, device="cpu", workdir=workdir, graphed_learner=False).restore(step)
    out["eager_resumed"] = (_metrics(e2.step()), learner_digest(e2.runner.train))
    solo = dist.new_group([0])  # every rank takes part in making it
    if dist.get_rank() == 0:
        try:
            DistributedTrainer(cfg, device="cpu", workdir=workdir, group=solo).restore(step)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    return out


def _update(use_pallas: bool, inputs: dict, shard: int) -> dict:
    """One all-reduced learner update from the test's weights, on this
    rank's half of the batch."""
    import torch
    import torch.distributed as dist

    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    cfg = update_cfg(use_pallas)
    opt = make_optimizer(cfg)
    ts = init_train_state(QNetwork.from_flax_params(inputs["params"]), opt)
    ts.target.load_state_dict(QNetwork.from_flax_params(inputs["target"]).state_dict())
    b = cfg.batch_size // WORLD
    rows = slice(shard * b, (shard + 1) * b)
    batch = LearnBatch(**{k: torch.tensor(v[rows]) for k, v in inputs["batch"].items()})
    ts, loss, td = build_update_step(opt, cfg, group=dist.group.WORLD)(
        ts, batch, torch.tensor(inputs["weights"][rows]))
    layers = lambda net: {n: (l.weight.detach().numpy().T.copy(), l.bias.detach().numpy().copy())  # noqa: E731
                          for n, l in net.flax_layers()}
    return {"loss": float(loss), "td": td.numpy(), "online": layers(ts.online),
            "target": layers(ts.target), "digest": learner_digest(ts)}


def _reduce(shard: int) -> dict:
    """``reduce_metrics`` on made-up values that differ by rank."""
    import torch
    import torch.distributed as dist

    from deep_q_learning_tpu_torch.algos.superstep import METRIC_REDUCTIONS, reduce_metrics

    local = [float(3 + shard), 2.0 * shard + 1, 10.0 + shard, 1.0 - shard, 0.5 * shard,
             4.0 + shard, -1.5 + 3 * shard, 0.1 * (shard + 1), float(shard == 0)]
    assert len(local) == len(METRIC_REDUCTIONS)
    return {"local": local,
            "reduced": reduce_metrics(torch.tensor(local, dtype=torch.float64), dist.group.WORLD)}


def run(shard: int, world: int, port: int, workdir: str, inputs: dict) -> dict:
    """A spawned rank (``parallel.spawn_ranks``): every scenario, one report."""
    import torch

    from deep_q_learning_tpu_torch.parallel import distributed_init

    torch.set_num_threads(1)
    distributed_init(f"localhost:{port}", world, shard, backend="gloo", device="cpu")
    return {
        "steps": _counters(cartpole_cfg(), os.path.join(workdir, "steps")),
        "episodes": _counters(cartpole_cfg(target_sync_mode="episodes", target_replace_episodes=4),
                              os.path.join(workdir, "episodes")),
        "exp_episode": _counters(cartpole_cfg(eps_schedule="exp_episode", eps_decay=0.9),
                                 os.path.join(workdir, "exp_episode")),
        "per": _counters(cartpole_cfg(replay="prioritized", use_pallas=True,
                                      use_pallas_sampler=True),
                         os.path.join(workdir, "per")),
        "update": {p: _update(p, inputs, shard) for p in (False, True)},
        "reduce": _reduce(shard),
    }
