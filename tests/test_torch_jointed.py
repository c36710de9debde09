"""The jointed lander through the port's entry points, on the CPU at a
tiny size: ``lunar_jointed_per`` and ``lunar_jointed_scaled`` through
``Trainer`` (counters exact, losses finite), a bitwise checkpoint resume
of a jointed runner, ``train --preset lunar_jointed_per`` through the
CLI, and the heuristic controller against the JAX one (actions exact)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs.heuristic import heuristic_action as jax_heuristic
from deep_q_learning_tpu_torch.__main__ import main
from deep_q_learning_tpu_torch.config import PRESETS, lunar_jointed_per, lunar_jointed_scaled
from deep_q_learning_tpu_torch.envs.heuristic import heuristic_action, touchdown_states
from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander, LunarLanderParams
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

TINY = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 32, steps_per_superstep=8,
            training_start=32, hidden=(32, 32), return_window=4)


def _same(a, b, where="runner"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_tiny_lunar_jointed_per_supersteps_on_cpu():
    cfg = dataclasses.replace(lunar_jointed_per(), **TINY)
    assert (cfg.lander_engine, cfg.lander_vel_iters, cfg.lander_pos_iters) == ("jointed", 120, 40)
    assert cfg.use_pallas and cfg.train_every == 1
    td_kernels.reset_counts()
    tr = Trainer(cfg, device="cpu").init(seed=4)
    assert tr.env_params.jointed and (tr.env_params.vel_iters, tr.env_params.pos_iters) == (120, 40)
    online0 = tr.runner.train.online.trunk[0].weight.detach().clone()
    ms = [tr.step() for _ in range(3)]
    r = tr.runner
    assert [m.env_steps for m in ms] == [8, 16, 24] and r.replay.total_adds == 24
    # updates start once 32 transitions are stored: at vector step 4
    assert [m.loss_count for m in ms] == [5, 8, 8]
    assert r.train.updates == 21 == r.train.opt_state.count
    assert td_kernels.plain_calls == {"td_loss_fwd": 21, "td_loss_bwd": 21}
    assert all(np.isfinite(m.loss_sum) for m in ms)
    assert ms[-1].episodes == sum(m.episodes_delta for m in ms) == int(r.episodes)
    assert not torch.equal(online0, r.train.online.trunk[0].weight)
    assert r.env_states.solver_acc.c1.shape == (8, 4, 2)
    ev = tr.evaluate(seed=0, max_steps=5)
    assert ev.returns.shape == (10,) and np.isfinite(ev.returns).all()
    assert (ev.lengths <= 5).all()


def test_lunar_jointed_scaled_builds_and_steps(tmp_path):
    """Full width (1024 envs, batch 1024, PER (1024, 512)), cut in depth."""
    cfg = dataclasses.replace(lunar_jointed_scaled(1024), steps_per_superstep=4,
                              training_start=4096)
    assert (cfg.train_every, cfg.lander_vel_iters, cfg.lander_pos_iters) == (4, 120, 40)
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path)).init(seed=0)
    assert tr.runner.replay.priorities.shape == (1024, 512)
    m = tr.step()
    assert m.env_steps == 4 and m.loss_count == 1 and np.isfinite(m.loss_sum)
    tr.save(step=4 * 1024)
    resumed = Trainer(cfg, device="cpu", workdir=str(tmp_path)).restore()
    assert resumed.step() == tr.step()
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(tr.runner))


def test_jointed_resume_is_bitwise(tmp_path):
    cfg = dataclasses.replace(lunar_jointed_per(), **TINY)
    wd = str(tmp_path / "ckpt")
    tr = Trainer(cfg, device="cpu", workdir=wd).init(seed=3)
    for _ in range(2):
        tr.step()
    tr.save(step=16)
    saved = torch.load(f"{wd}/16.pt", weights_only=True)
    assert saved["env_states"]["solver_acc"]["c2"].shape == (8, 4, 2)
    assert set(saved["env_states"]["leg1_body"]) == {"cx", "cy", "a", "vx", "vy", "w"}

    t2 = Trainer(cfg, device="cpu", workdir=wd).init(seed=99).restore(step=16)
    _same(ckpt._to_tree(t2.runner), ckpt._to_tree(tr.runner))
    m2 = t2.step()
    m0 = tr.step()  # the run that was never interrupted
    assert m2 == m0
    _same(ckpt._to_tree(t2.runner), ckpt._to_tree(tr.runner))
    # a rigid trainer cannot restore it: config.json names the engine
    rigid = dataclasses.replace(cfg, lander_engine="rigid")
    with pytest.raises(ValueError, match="lander_engine"):
        Trainer(rigid, device="cpu", workdir=wd).restore()


def test_cli_trains_and_evaluates_lunar_jointed_per(tmp_path, capsys):
    assert main(["presets"]) == 0
    listing = {line.split()[0]: line for line in capsys.readouterr().out.splitlines()}
    for name in PRESETS:
        assert "[runnable]" in listing[name], listing[name]

    args = ["--preset", "lunar_jointed_per", "--device", "cpu", "--set", "num_envs=8",
            "--set", "steps_per_superstep=8", "--set", "hidden=16,16", "--set", "batch_size=16",
            "--set", "buffer_capacity=256", "--set", "training_start=32",
            "--set", "return_window=4", "--set", "max_steps_in_episode=20"]
    wd = str(tmp_path / "run")
    assert main(["train", *args, "--max-env-steps", "64", "--log-every", "1",
                 "--checkpoint-every", "1", "--workdir", wd, "--quiet"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["env_steps"] == 64 and first["updates"] == 5
    assert main(["train", *args, "--resume", "--max-env-steps", "128", "--log-every", "1",
                 "--workdir", wd, "--quiet"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["updates"] == 13
    assert main(["eval", *args, "--workdir", wd]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["step"] == 64 and report["episodes"] == 10 and report["length_mean"] <= 20


def test_heuristic_action_matches_jax():
    rng = np.random.default_rng(0)
    obs = rng.normal(0.0, 0.6, (4096, 8)).astype(np.float32)
    obs[:, 6:] = rng.random((4096, 2)) < 0.3
    want = np.asarray(jax.jit(jax.vmap(jax_heuristic))(jnp.asarray(obs)))
    got = heuristic_action(torch.from_numpy(obs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}


def test_touchdown_states_cover_flight_and_contact():
    env = LunarLander()
    p = LunarLanderParams(vel_iters=120, pos_iters=40)
    obs, st = touchdown_states(env, p, 32, torch.Generator().manual_seed(0), frames=20)
    assert obs.shape == (32, 8) and torch.isfinite(obs).all()
    assert (st.leg1 & st.leg2).any() and (~st.leg1 & ~st.leg2).any()
    assert (st.t == 20).all()
