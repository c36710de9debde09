"""``compute_dtype="bfloat16"`` through the port's learner, trainers,
checkpoints and CLI, on the CPU.

One learner update with a bf16 trunk, plain and fused, against the JAX
``build_update_step`` over flax's ``QNetwork(compute_dtype=bfloat16)``
from the same params, batch and weights (the fused path runs Pallas in
interpret mode on the JAX side): the loss rtol 1e-3 and td atol 1e-3 (the
forwards' bf16 features are bitwise flax's, and the float32 heads sum in
another order: measured ~1e-6 relative; the backward's bf16 products
round where XLA's do, so gradients agree to bf16 rounding), and each
parameter within a tenth of the learning rate, as the population test
holds Adam's first step, wherever the JAX gradient is above the bf16
resolution of its leaf (2^-6 of the leaf's largest).  Below it the two
frameworks' bf16 rounding of the trunk's backward products and bias sums
(measured: trunk gradients within 1 bf16 ulp of the leaf's largest, bias
gradients 1.2 %) may flip a gradient's sign, and Adam's first step,
lr·g/(|g|+1e-8), then moves the weight by ±lr in each: those (at most
1 % of the weights beyond lr/10; 1 of 1,541 here) are held within
2.1·lr.  Parameters,
gradients and Adam's moments stay float32.

Then ``Trainer``, ``PopulationTrainer`` (2 members) and
``DistributedTrainer`` (world size 1, gloo) each run supersteps on bf16;
a checkpoint round trip keeps the dtype; ``train --set
compute_dtype=bfloat16`` runs through the CLI."""

import dataclasses
import json

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
from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.replay.nstep import LearnBatch as JaxBatch
from deep_q_learning_tpu_torch.__main__ import main
from deep_q_learning_tpu_torch.algos import (
    HyperParams,
    build_update_step,
    init_train_state,
    make_optimizer,
)
from deep_q_learning_tpu_torch.config import lunar_per
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.parallel.mesh import distributed_init
from deep_q_learning_tpu_torch.parallel.population import PopulationTrainer
from deep_q_learning_tpu_torch.replay.nstep import LearnBatch
from deep_q_learning_tpu_torch.train import DistributedTrainer, Trainer

OBS_DIM, ACTIONS, B = 9, 4, 32
BF16 = dict(compute_dtype="bfloat16")
# lunar_per on the rigid lander, cut in width and depth for the CPU
TINY = dict(num_envs=8, steps_per_superstep=8, hidden=(16, 16), batch_size=16,
            buffer_capacity=512, training_start=32, return_window=8, **BF16)


def _batch_np(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.standard_normal((B, OBS_DIM)).astype(np.float32),
        action=rng.integers(0, ACTIONS, B).astype(np.int32),
        reward=(3.0 * rng.standard_normal(B)).astype(np.float32),
        next_obs=rng.standard_normal((B, OBS_DIM)).astype(np.float32),
        bootstrap=(0.97 * (rng.random(B) > 0.2)).astype(np.float32),
    ), (rng.random(B) + 0.1).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_update_matches_jax(use_pallas):
    cfg = dataclasses.replace(lunar_per(), hidden=(32, 32), batch_size=B, use_pallas=use_pallas,
                              **BF16)
    flax_net = FlaxQNetwork(num_actions=ACTIONS, hidden=cfg.hidden, dueling=cfg.dueling,
                            compute_dtype=jnp.bfloat16)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))
    target = flax_net.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS_DIM)))
    batch, weights = _batch_np(0)

    opt_j = jax_make_optimizer(cfg)
    ts_j = JaxTrainState(params=params, target_params=target,
                         opt_state=opt_j.init(params), updates=jnp.int32(0))
    ts_j, loss_j, td_j = jax_build_update_step(flax_net.apply, opt_j, cfg)(
        ts_j, JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        jnp.asarray(weights), JaxHyper.from_config(cfg),
    )

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    opt = make_optimizer(cfg)
    ts = init_train_state(QNetwork.from_flax_params(to_np(params), **BF16), opt)
    ts.target.load_state_dict(QNetwork.from_flax_params(to_np(target)).state_dict())
    assert ts.target.compute_dtype == torch.bfloat16
    td_kernels.reset_counts()
    ts, loss, td = build_update_step(opt, cfg)(
        ts, LearnBatch(**{k: torch.tensor(v) for k, v in batch.items()}),
        torch.tensor(weights), HyperParams.from_config(cfg),
    )
    calls = 1 if use_pallas else 0
    assert td_kernels.plain_calls == {"td_loss_fwd": calls, "td_loss_bwd": calls}
    assert loss.dtype == td.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-3)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_j), rtol=0, atol=1e-3)
    assert all(t.dtype == torch.float32 for t in ts.opt_state.mu + ts.opt_state.nu)
    # Adam's first step moves each weight by lr·g/(|g|+1e-8), about ±lr: a
    # gradient below the bf16 resolution of its leaf may take the other sign
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    grads = to_np(jax.grad(lambda q: jax_build_loss_fn(flax_net.apply, double=cfg.double)(
        q, target, jb, jnp.asarray(weights))[0])(params))["params"]
    p = to_np(ts_j.params)["params"]
    lr, far, total = cfg.learning_rate, 0, 0
    for name, layer in ts.online.flax_layers():
        for got, want, g in ((layer.weight.detach().numpy().T, p[name]["kernel"],
                              grads[name]["kernel"]),
                             (layer.bias.detach().numpy(), p[name]["bias"], grads[name]["bias"])):
            assert got.dtype == np.float32
            decided = np.abs(g) > 2.0**-6 * np.abs(g).max()
            np.testing.assert_allclose(got[decided], want[decided], rtol=0, atol=lr / 10)
            np.testing.assert_allclose(got, want, rtol=0, atol=2.1 * lr)
            far += int((np.abs(got - want) > lr / 10).sum())
            total += g.size
    assert far <= 0.01 * total


def _check_bf16_learner(online, obs):
    assert online.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in online.parameters())
    with torch.no_grad():
        assert online.features(obs).dtype == torch.bfloat16
        assert online(obs).dtype == torch.float32


def test_trainer_runs_bf16_and_checkpoints_keep_it(tmp_path):
    cfg = dataclasses.replace(lunar_per(), **TINY)
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path)).init(seed=1)
    before = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    metrics = [trainer.step() for _ in range(6)]
    assert sum(m.loss_count for m in metrics) > 0
    assert all(np.isfinite(m.loss_sum) for m in metrics)
    online = trainer.runner.train.online
    _check_bf16_learner(online, trainer.runner.obs)
    assert any(not torch.equal(a, b) for a, b in zip(before, online.parameters()))
    assert np.isfinite(trainer.evaluate(seed=0, max_steps=20).returns).all()

    trainer.save(step=48 * 8)
    assert json.load(open(tmp_path / "config.json"))["compute_dtype"] == "bfloat16"
    restored = Trainer(cfg, device="cpu", workdir=str(tmp_path)).restore()
    _check_bf16_learner(restored.runner.train.online, restored.runner.obs)
    for a, b in zip(restored.runner.train.online.parameters(), online.parameters()):
        assert torch.equal(a, b)
    assert dataclasses.asdict(restored.step()) == dataclasses.asdict(trainer.step())
    f32 = Trainer(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu",
                  workdir=str(tmp_path))
    with pytest.raises(ValueError, match="compute_dtype"):
        f32.restore()


def test_population_runs_bf16():
    cfg = dataclasses.replace(lunar_per(), **TINY)
    trainer = PopulationTrainer(cfg, num_members=2, eval_envs=4, device="cpu")
    runner = trainer.init(seed=0)
    for _ in range(5):
        runner, metrics = trainer.step(runner)
    assert (metrics.loss_count > 0).all() and np.isfinite(metrics.loss_sum).all()
    online = runner.train.online
    _check_bf16_learner(online, runner.obs.view(2, 8, -1))
    assert np.isfinite(trainer.evaluate(runner, seed=1, max_steps=20).returns).all()


def test_distributed_trainer_runs_bf16_at_world_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    distributed_init(device="cpu")
    try:
        cfg = dataclasses.replace(lunar_per(), **TINY)
        single = Trainer(cfg, device="cpu").init(seed=3)
        dist_tr = DistributedTrainer(cfg, device="cpu").init(seed=3)
        for _ in range(5):
            assert dataclasses.asdict(dist_tr.step()) == dataclasses.asdict(single.step())
        _check_bf16_learner(dist_tr.runner.train.online, dist_tr.runner.obs)
        for a, b in zip(dist_tr.runner.train.online.parameters(),
                        single.runner.train.online.parameters()):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_cli_trains_bf16(tmp_path, capsys):
    wd = tmp_path / "run"
    args = ["--preset", "lunar_per", "--device", "cpu",
            *[f"--set={k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
              for k, v in TINY.items()]]
    assert main(["train", *args, "--max-env-steps", "384", "--log-every", "6",
                 "--checkpoint-every", "6", "--workdir", str(wd), "--quiet"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["env_steps"] == 384 and summary["updates"] > 0
    assert json.load(open(wd / "config.json"))["compute_dtype"] == "bfloat16"
    assert main(["eval", *args, "--workdir", str(wd), "--quiet"]) == 0
    with pytest.raises(ValueError, match="compute_dtype"):
        main(["train", *args, "--set", "compute_dtype=float16", "--max-env-steps", "64"])
