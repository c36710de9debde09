"""Uniform replay through the port's ``Trainer``, on the CPU at tiny widths.

* Each preset that runs uniform replay (``cartpole_vector``,
  ``acrobot_vector``, ``mountain_car_vector``, ``lunar_dddqn_vector`` and
  ``lunar_ref_parity``) for a few supersteps: the counters are exact (env
  steps, replay writes, and learner updates on exactly the frames the
  cadence and the warm-up gate allow), the losses finite, the online net
  trained, and the target followed by hard sync or Polyak averaging.
  ``lunar_ref_parity`` runs one env with episode-counted hard sync and
  per-episode ε on the jointed engine at gym's (180, 60) iterations, so it
  takes a few frames only.
* ``Trainer.train`` decides the solve, the budget and the checkpoint at log
  points only, as the JAX ``Trainer`` does: both stop at the same env step,
  with the same history length and the same checkpoint steps (the counters
  are deterministic, so they are compared exactly).
* The port's twin of ``tests/test_nstep.py::test_nstep_training_learns_cartpole``:
  the same CartPole config must reach a best window above 50 within 80,000
  env steps.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deep_q_learning_tpu import config as jax_config
from deep_q_learning_tpu.train import Trainer as JaxTrainer
from deep_q_learning_tpu_torch import config
from deep_q_learning_tpu_torch.config import DQNConfig
from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels
from deep_q_learning_tpu_torch.train import Trainer

TINY = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 32, steps_per_superstep=8,
            training_start=32, hidden=(16, 16), return_window=4)
# preset: (config cuts, supersteps)
RUNS = {
    # hard sync every 8 vector steps, so the last superstep ends on a sync
    "cartpole_vector": (dict(TINY, target_sync_every=8), 3),
    "acrobot_vector": (dict(TINY, max_steps_in_episode=12), 3),
    "mountain_car_vector": (dict(TINY, max_steps_in_episode=12), 3),
    "lunar_dddqn_vector": (dict(TINY, max_steps_in_episode=12), 3),
    # one env, the jointed engine at (180, 60): 2 supersteps of 4 frames,
    # episodes cut to 3 frames so that the episode-counted sync and the
    # per-episode ε both move
    "lunar_ref_parity": (dict(steps_per_superstep=4, training_start=4, batch_size=8,
                              max_steps_in_episode=3, target_replace_episodes=1), 2),
}


def _trained_frames(cfg, vector_steps):
    """The vector steps on which the learner runs: the cadence and the
    warm-up gate (in stored transitions) of ``algos/superstep.py``."""
    capacity = cfg.buffer_capacity // cfg.num_envs
    return [s for s in range(1, vector_steps + 1)
            if s % cfg.train_every == 0 and min(s, capacity) * cfg.num_envs >= cfg.training_start]


@pytest.mark.parametrize("preset", list(RUNS))
def test_uniform_replay_presets_through_trainer(preset):
    cuts, supersteps = RUNS[preset]
    cfg = dataclasses.replace(config.PRESETS[preset](), **cuts)
    assert cfg.replay == "uniform" and not cfg.use_pallas and not cfg.use_pallas_sampler
    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    tr = Trainer(cfg, device="cpu").init(seed=5)
    online0 = [p.detach().clone() for p in tr.runner.train.online.parameters()]
    target0 = [p.detach().clone() for p in tr.runner.train.target.parameters()]
    ms = [tr.step() for _ in range(supersteps)]
    r = tr.runner

    vector_steps = supersteps * cfg.steps_per_superstep
    assert [m.env_steps for m in ms] == [cfg.steps_per_superstep * (i + 1) for i in range(supersteps)]
    capacity = cfg.buffer_capacity // cfg.num_envs
    assert r.replay.total_adds == vector_steps and r.replay.cursor == vector_steps % capacity
    frames = _trained_frames(cfg, vector_steps)
    per_superstep = [sum(1 for s in frames if i * cfg.steps_per_superstep < s
                         <= (i + 1) * cfg.steps_per_superstep) for i in range(supersteps)]
    assert frames and [m.loss_count for m in ms] == [k * cfg.updates_per_step for k in per_superstep]
    assert r.train.updates == len(frames) * cfg.updates_per_step == r.train.opt_state.count
    # no kernel and no kernel's plain version: these presets run the plain TD loss
    for counts in (td_kernels.launches, td_kernels.plain_calls,
                   sample_kernels.launches, sample_kernels.plain_calls):
        assert not any(counts.values()), counts
    assert all(math.isfinite(m.loss_sum) for m in ms)
    assert ms[-1].episodes == sum(m.episodes_delta for m in ms) == int(r.episodes) > 0
    assert int(r.window_filled) == min(ms[-1].episodes, cfg.return_window)

    online = [p.detach() for p in r.train.online.parameters()]
    target = [p.detach() for p in r.train.target.parameters()]
    assert any(not torch.equal(p, p0) for p, p0 in zip(online, online0))
    assert any(not torch.equal(t, t0) for t, t0 in zip(target, target0))
    if cfg.target_tau is None and cfg.target_sync_mode == "steps":
        assert all(torch.equal(t, p) for t, p in zip(target, online))  # synced at the last step
    elif cfg.target_tau is None:  # episode-counted sync
        assert int(r.last_sync_episodes) > 0
    else:  # Polyak: the target trails the online net
        assert any(not torch.equal(t, p) for t, p in zip(target, online))
    if cfg.eps_schedule == "exp_episode":
        per_env = ms[-1].episodes / cfg.num_envs
        assert ms[-1].epsilon == pytest.approx(max(cfg.eps_decay**per_env, cfg.eps_min), rel=1e-6)
    else:
        frac = min(vector_steps * cfg.num_envs / cfg.eps_decay_steps, 1.0)
        assert ms[-1].epsilon == pytest.approx(1.0 + frac * (cfg.eps_min - 1.0), rel=1e-6)

    ev = tr.evaluate(seed=0, max_steps=5)
    assert ev.returns.shape == (max(cfg.num_envs, 10),) and np.isfinite(ev.returns).all()


# the cadence case: (overrides, max_env_steps); 64 env steps a superstep
CADENCE = {
    # the budget falls between log points: superstep 4 passes it, the log
    # point at superstep 6 stops; the checkpoint at superstep 2 and 4 is not
    # taken (not a log point), the one at 6 is
    "budget": (dict(solve_threshold=None), 200),
    # every episode is cut at 10 steps, so the 4-episode window is full and
    # "solved" from superstep 2; the stop is at the log point of superstep 3,
    # followed by the save after a solve
    "solve": (dict(solve_threshold=-1e9, max_steps_in_episode=10), 10**9),
}


def _jax_run(overrides, max_env_steps, tmp_path):
    cfg = dataclasses.replace(jax_config.cartpole_vector(), **TINY, **overrides)
    tr = JaxTrainer(cfg, workdir=str(tmp_path / "jax")).init(seed=0)
    saves = []
    tr.save = lambda step: saves.append(step)
    res = tr.train(max_env_steps=max_env_steps, log_every=3, checkpoint_every=2, verbose=False)
    return res, saves


@pytest.mark.parametrize("case", list(CADENCE))
def test_train_cadence_matches_jax(case, tmp_path):
    overrides, max_env_steps = CADENCE[case]
    cfg = dataclasses.replace(config.cartpole_vector(), **TINY, **overrides)
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path / "port")).init(seed=0)
    saves = []
    tr.save = lambda step: saves.append(step)
    res = tr.train(max_env_steps=max_env_steps, log_every=3, checkpoint_every=2, verbose=False)
    want, want_saves = _jax_run(overrides, max_env_steps, tmp_path)
    assert (res.env_steps, res.solved) == (want.env_steps, want.solved)
    assert len(res.history) == len(want.history)
    assert [h["env_steps"] for h in res.history] == [h["env_steps"] for h in want.history]
    assert saves == want_saves
    expected = {"budget": (384, False, 2, [384]), "solve": (192, True, 1, [192])}[case]
    assert (res.env_steps, res.solved, len(res.history), saves) == expected


def test_nstep_training_learns_cartpole():
    """n-step 3 end to end: the port learns at least as the JAX sanity gate."""
    cfg = DQNConfig(
        env_id="CartPole-v1", num_envs=32, steps_per_superstep=64,
        batch_size=128, training_start=1000, buffer_capacity=50_000,
        n_step=3, double=False, dueling=False, hidden=(64, 64),
        learning_rate=5e-4, eps_schedule="linear_step", eps_decay_steps=30_000,
        eps_min=0.05, train_every=1, target_sync_mode="steps",
        target_sync_every=512, return_window=32,
    )
    tr = Trainer(cfg, device="cpu").init()
    res = tr.train(max_env_steps=80_000, log_every=5, verbose=False)
    best = max(r["window_mean"] for r in res.history)
    assert best > 50.0, f"n-step training shows no learning: best {best}"
