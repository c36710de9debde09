"""The ``lunar_per`` slice of the port as a whole, on the CPU.

* One learner update (double-DQN TD + huber through the fused op, its
  backward, adam with global-norm clip, Polyak target update) against the
  JAX ``build_update_step`` with ``use_pallas=True`` (Pallas in interpret
  mode), from the same params, batch and weights: rtol 1e-4.
* The plain loss path against the JAX ``build_loss_fn``: rtol 1e-5.
* Episode-window accounting against the JAX scatter: exact.
* A few supersteps of a tiny ``lunar_per`` through ``Trainer``.
* Importing the port pulls in neither jax, flax, optax nor the JAX package.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.algos.dqn import HyperParams as JaxHyper
from deep_q_learning_tpu.algos.dqn import TrainState as JaxTrainState
from deep_q_learning_tpu.algos.dqn import build_update_step as jax_build_update_step
from deep_q_learning_tpu.algos.dqn import make_optimizer as jax_make_optimizer
from deep_q_learning_tpu.algos.losses import build_loss_fn as jax_build_loss_fn
from deep_q_learning_tpu.algos.superstep import (
    _scatter_completed_returns as jax_scatter_returns,
)
from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.replay.nstep import LearnBatch as JaxBatch
from deep_q_learning_tpu_torch.algos import (
    HyperParams,
    build_loss_fn,
    build_update_step,
    init_train_state,
    make_optimizer,
)
from deep_q_learning_tpu_torch.algos.superstep import _scatter_completed_returns
from deep_q_learning_tpu_torch.config import lunar_per
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.replay.nstep import LearnBatch
from deep_q_learning_tpu_torch.train import Trainer

REPO = Path(__file__).resolve().parents[1]
OBS_DIM, ACTIONS, B = 9, 4, 32


def _small_cfg():
    return dataclasses.replace(lunar_per(), hidden=(16, 16), batch_size=B)


def _batch_np(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.standard_normal((B, OBS_DIM)).astype(np.float32),
        action=rng.integers(0, ACTIONS, B).astype(np.int32),
        reward=(3.0 * rng.standard_normal(B)).astype(np.float32),
        next_obs=rng.standard_normal((B, OBS_DIM)).astype(np.float32),
        bootstrap=(0.97 * (rng.random(B) > 0.2)).astype(np.float32),
    ), (rng.random(B) + 0.1).astype(np.float32)


def _flax_params(cfg, seed):
    net = FlaxQNetwork(num_actions=ACTIONS, hidden=cfg.hidden, dueling=cfg.dueling)
    return net, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS_DIM)))


def _assert_params_close(module, flax_params, rtol, atol):
    p = flax_params["params"]
    for name, layer in module.flax_layers():
        np.testing.assert_allclose(
            layer.weight.detach().numpy().T, np.asarray(p[name]["kernel"]), rtol=rtol, atol=atol
        )
        np.testing.assert_allclose(
            layer.bias.detach().numpy(), np.asarray(p[name]["bias"]), rtol=rtol, atol=atol
        )


def test_learner_update_matches_jax_pallas_path():
    cfg = _small_cfg()
    assert cfg.use_pallas and cfg.double and cfg.target_tau == 0.005
    flax_net, params = _flax_params(cfg, 0)
    _, target = _flax_params(cfg, 1)
    batch, weights = _batch_np(0)

    opt_j = jax_make_optimizer(cfg)
    update_j = jax_build_update_step(flax_net.apply, opt_j, cfg)
    ts_j = JaxTrainState(params=params, target_params=target,
                         opt_state=opt_j.init(params), updates=jnp.int32(0))
    ts_j, loss_j, td_j = update_j(
        ts_j, JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        jnp.asarray(weights), JaxHyper.from_config(cfg),
    )

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    opt = make_optimizer(cfg)
    ts = init_train_state(QNetwork.from_flax_params(to_np(params)), opt)
    ts.target.load_state_dict(QNetwork.from_flax_params(to_np(target)).state_dict())
    td_kernels.reset_counts()
    ts, loss, td = build_update_step(opt, cfg)(
        ts, LearnBatch(**{k: torch.tensor(v) for k, v in batch.items()}),
        torch.tensor(weights), HyperParams.from_config(cfg),
    )
    assert td_kernels.plain_calls == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    assert ts.updates == 1 and not any(p.requires_grad for p in ts.target.parameters())
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_j), rtol=1e-4, atol=1e-5)
    _assert_params_close(ts.online, ts_j.params, rtol=1e-4, atol=1e-6)
    _assert_params_close(ts.target, ts_j.target_params, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "loss,double,quirk", [("huber", True, False), ("huber", False, False), ("mse", True, True)]
)
def test_plain_loss_matches_jax(loss, double, quirk):
    cfg = _small_cfg()
    flax_net, params = _flax_params(cfg, 2)
    _, target = _flax_params(cfg, 3)
    batch, weights = _batch_np(1)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    kw = dict(double=double, loss=loss, huber_delta=1.0, ref_terminal_quirk=quirk)
    loss_j, td_j = jax_build_loss_fn(flax_net.apply, **kw)(params, target, jb, jnp.asarray(weights))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    loss_t, td_t = build_loss_fn(**kw)(
        QNetwork.from_flax_params(to_np(params)), QNetwork.from_flax_params(to_np(target)),
        LearnBatch(**{k: torch.tensor(v) for k, v in batch.items()}), torch.tensor(weights),
    )
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(td_t.numpy(), np.asarray(td_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,w,p_done", [(64, 16, 0.1), (64, 8, 0.5), (16, 32, 0.3)])
def test_window_accounting_matches_jax(n, w, p_done):
    """Only the last W finishers, in env order, land in unique ring slots."""
    rng = np.random.default_rng(n + w)
    window = rng.standard_normal(w).astype(np.float32)
    for cursor, filled in [(0, 0), (w - 3, w)]:
        done = rng.random(n) < p_done
        returns = rng.standard_normal(n).astype(np.float32)
        want = jax_scatter_returns(
            jnp.asarray(window), jnp.int32(cursor), jnp.int32(filled),
            jnp.asarray(done), jnp.asarray(returns),
        )
        got = _scatter_completed_returns(
            torch.tensor(window), torch.tensor(cursor), torch.tensor(filled),
            torch.tensor(done), torch.tensor(returns),
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


def test_tiny_lunar_per_supersteps_on_cpu():
    cfg = dataclasses.replace(
        lunar_per(), num_envs=8, batch_size=16, buffer_capacity=8 * 64,
        steps_per_superstep=16, training_start=64, hidden=(16, 16), return_window=4,
    )
    td_kernels.reset_counts()
    tr = Trainer(cfg, device="cpu").init(seed=1)
    params0 = [p.detach().clone() for p in tr.runner.train.online.parameters()]
    target0 = [p.detach().clone() for p in tr.runner.train.target.parameters()]
    ms = [tr.step() for _ in range(4)]
    r = tr.runner
    assert [m.env_steps for m in ms] == [16, 32, 48, 64] and r.replay.total_adds == 64
    # updates start once 64 transitions are stored: at vector step 8
    assert [m.loss_count for m in ms] == [9, 16, 16, 16]
    assert r.train.updates == 57 == r.train.opt_state.count
    assert td_kernels.plain_calls == {"td_loss_fwd": 57, "td_loss_bwd": 57}
    assert td_kernels.launches == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    assert all(np.isfinite(m.loss_sum) for m in ms)
    assert ms[-1].episodes == sum(m.episodes_delta for m in ms) == int(r.episodes)
    assert int(r.window_filled) == min(ms[-1].episodes, cfg.return_window)
    assert not torch.equal(params0[0], r.train.online.trunk[0].weight)
    assert not torch.equal(target0[0], r.train.target.trunk[0].weight)
    assert ms[-1].epsilon == pytest.approx(1.0 + 64 * 8 / 300_000 * (0.01 - 1.0), rel=1e-6)

    tr.set_hyper(learning_rate=1e-3, train_every=2)
    assert tr.runner.hyper.learning_rate == 1e-3 and tr.runner.hyper.train_every == 2
    assert tr.step().loss_count == 8
    with pytest.raises(ValueError):
        tr.set_hyper(batch_size=3)

    ev = tr.evaluate(seed=0)
    assert ev.returns.shape == (10,) and np.isfinite(ev.returns).all()
    assert ev.truncated.dtype == np.bool_


@pytest.mark.parametrize("mode", ["steps", "episodes"])
def test_hard_target_sync_modes(mode):
    """Without Polyak, the target is a hard copy on the step or episode
    cadence; the episode decision is taken on the device."""
    cfg = dataclasses.replace(
        lunar_per(), num_envs=8, batch_size=16, buffer_capacity=8 * 64,
        steps_per_superstep=16, training_start=64, hidden=(16, 16),
        target_tau=None, target_sync_mode=mode, target_sync_every=16,
        target_replace_episodes=1,
    )
    tr = Trainer(cfg, device="cpu").init(seed=2)
    target0 = tr.runner.train.target.trunk[0].weight.detach().clone()
    tr.step()
    train = tr.runner.train
    if mode == "steps":  # vector step 16 synced after its update
        assert torch.equal(train.target.trunk[0].weight, train.online.trunk[0].weight)
    else:
        for _ in range(6):
            tr.step()
        assert int(tr.runner.episodes) > 0
        assert int(tr.runner.last_sync_episodes) > 0
        assert not torch.equal(train.target.trunk[0].weight, target0)


def test_absent_cuda_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(lunar_per(), device="cuda")


def test_import_leaves_jax_out():
    code = (
        "import sys, deep_q_learning_tpu_torch, deep_q_learning_tpu_torch.train, "
        "deep_q_learning_tpu_torch.__main__, deep_q_learning_tpu_torch.measure, "
        "deep_q_learning_tpu_torch.parallel, deep_q_learning_tpu_torch.utils.visualize, "
        "deep_q_learning_tpu_torch.compat.host_loop, deep_q_learning_tpu_torch.compat.host_env, "
        "deep_q_learning_tpu_torch.native, deep_q_learning_tpu_torch.envs.gym_compat, "
        "deep_q_learning_tpu_torch.examples.gym_parity_report, "
        "deep_q_learning_tpu_torch.examples.policy_transfer, "
        "deep_q_learning_tpu_torch.examples.engine_curve_compare, "
        "deep_q_learning_tpu_torch.examples.summarize_engine_curves; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'deep_q_learning_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
