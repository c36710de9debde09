"""Population training in the port (``deep_q_learning_tpu_torch/parallel/``)
against the JAX package's vmapped population, on the CPU at the JAX tests'
``TINY`` size (``tests/test_population.py``).

* One population learner update (3 members, the fused TD loss, PER weights,
  Adam with the global-norm clip, Polyak, per-member learning rates)
  against the JAX update step ``jax.vmap``ped over the same member-stacked
  flax params and batch (Pallas in interpret mode): loss, td and every
  member's new online and target params at rtol 1e-4, atol 1e-6 (as
  ``tests/test_torch_slice.py`` holds one learner).
* The member sampler of prioritized replay (with the slot kernel's plain
  version) against the JAX sampler vmapped over the members' states, with
  each member's draws injected: indices exact, weights rtol 1e-6.
* Counters: each member's learner updates, Adam counts and per-superstep
  update counts with per-member ``train_every`` and ``training_start``
  equal the JAX population's exactly (host gates against ``lax.cond``
  under ``vmap``).
* Episode windows with a member axis against the JAX scatter vmapped:
  exact.
* A member is bitwise independent of another member's learning rate.
* ``set_population_hyper`` rejects a static field and a wrong length;
  ``PopulationTrainer`` evaluates on the training env's engine, and ``run``
  starts every call from fresh members.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_q_learning_tpu import config as jax_config
from deep_q_learning_tpu.algos.dqn import HyperParams as JaxHyper
from deep_q_learning_tpu.algos.dqn import TrainState as JaxTrainState
from deep_q_learning_tpu.algos.dqn import build_update_step as jax_build_update_step
from deep_q_learning_tpu.algos.dqn import make_optimizer as jax_make_optimizer
from deep_q_learning_tpu.algos.superstep import (
    _scatter_completed_returns as jax_scatter_returns,
)
from deep_q_learning_tpu.envs.base import Transition as JaxTransition
from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.parallel import build_population as jax_build_population
from deep_q_learning_tpu.parallel import set_population_hyper as jax_set_population_hyper
from deep_q_learning_tpu.replay import PrioritizedReplay as JaxPER
from deep_q_learning_tpu.replay.nstep import LearnBatch as JaxBatch
from deep_q_learning_tpu_torch import config
from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
from deep_q_learning_tpu_torch.algos.dqn import MemberHyperParams
from deep_q_learning_tpu_torch.algos.superstep import _scatter_completed_returns
from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.models import MemberQNetwork, QNetwork
from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels
from deep_q_learning_tpu_torch.parallel import (
    PopulationTrainer,
    build_population,
    candidate_overrides,
    set_population_hyper,
    train_population,
)
from deep_q_learning_tpu_torch.replay import PrioritizedReplay
from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

TINY = dict(num_envs=8, steps_per_superstep=8, hidden=(16, 16), batch_size=16,
            buffer_capacity=512, training_start=32, return_window=8)
M, OBS_DIM, ACTIONS, B = 3, 9, 4, 32
LRS = [1e-4, 3e-4, 1e-3]


def _stack_flax_params(seed):
    net = FlaxQNetwork(num_actions=ACTIONS, hidden=(16, 16), dueling=True)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    return net, jax.vmap(lambda k: net.init(k, jnp.zeros((1, OBS_DIM))))(keys)


def _member_batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.standard_normal((M, B, OBS_DIM)).astype(np.float32),
        action=rng.integers(0, ACTIONS, (M, B)).astype(np.int32),
        reward=(3.0 * rng.standard_normal((M, B))).astype(np.float32),
        next_obs=rng.standard_normal((M, B, OBS_DIM)).astype(np.float32),
        bootstrap=(0.97 * (rng.random((M, B)) > 0.2)).astype(np.float32),
    ), (rng.random((M, B)) + 0.1).astype(np.float32)


def test_member_network_from_stacked_flax_params():
    """The weight carry: a member-stacked flax dict into the stacked form;
    each member's forward equals the vmapped flax apply."""
    net, params = _stack_flax_params(0)
    x = np.random.default_rng(0).standard_normal((M, 5, OBS_DIM)).astype(np.float32)
    want = jax.vmap(net.apply)(params, jnp.asarray(x))
    stacked = MemberQNetwork.from_flax_params(jax.tree.map(np.asarray, params))
    assert stacked.members == M and stacked.trunk[0].weight.shape == (M, 16, OBS_DIM)
    np.testing.assert_allclose(stacked(torch.tensor(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    # member m initialised as one network from the m-th generator
    gens = [torch.Generator().manual_seed(s) for s in (4, 5, 6)]
    fresh = MemberQNetwork(M, OBS_DIM, ACTIONS, (16, 16), generators=gens)
    one = QNetwork(OBS_DIM, ACTIONS, (16, 16), generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a[1], b) for a, b in zip(fresh.parameters(), one.parameters()))


def test_population_learner_update_matches_jax_vmapped():
    cfg = dataclasses.replace(config.lunar_per(), hidden=(16, 16), batch_size=B)
    assert cfg.use_pallas and cfg.replay == "prioritized" and cfg.max_grad_norm == 10.0
    flax_net, params = _stack_flax_params(0)
    _, target = _stack_flax_params(1)
    batch, weights = _member_batch(0)

    jcfg = dataclasses.replace(jax_config.lunar_per(), hidden=(16, 16), batch_size=B)
    opt_j = jax_make_optimizer(jcfg)
    update_j = jax_build_update_step(flax_net.apply, opt_j, jcfg)
    ts_j = JaxTrainState(params=params, target_params=target,
                         opt_state=jax.vmap(opt_j.init)(params), updates=jnp.zeros((M,), jnp.int32))
    hyper_j = jax.tree.map(lambda x: jnp.stack([x] * M), JaxHyper.from_config(jcfg))
    hyper_j = hyper_j.replace(learning_rate=jnp.asarray(LRS, jnp.float32))
    ts_j, loss_j, td_j = jax.vmap(update_j)(
        ts_j, JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        jnp.asarray(weights), hyper_j,
    )

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    opt = make_optimizer(cfg)
    ts = init_train_state(MemberQNetwork.from_flax_params(to_np(params)), opt)
    ts.target.load_state_dict(MemberQNetwork.from_flax_params(to_np(target)).state_dict())
    hyper = MemberHyperParams.from_config(cfg, M, "cpu")
    hyper.learning_rate = torch.tensor(LRS)
    td_kernels.reset_counts()
    ts, loss, td = build_update_step(opt, cfg)(
        ts, LearnBatch(**{k: torch.tensor(v) for k, v in batch.items()}),
        torch.tensor(weights), hyper, [True] * M,
    )
    assert td_kernels.plain_calls == {"td_loss_fwd": 1, "td_loss_bwd": 1}  # one call, all members
    assert ts.updates == [1] * M == ts.opt_state.count
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_j), rtol=1e-4, atol=1e-5)
    for module, want in ((ts.online, ts_j.params), (ts.target, ts_j.target_params)):
        p = want["params"]
        for name, layer in module.flax_layers():
            np.testing.assert_allclose(layer.weight.detach().numpy().transpose(0, 2, 1),
                                       np.asarray(p[name]["kernel"]), rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(p[name]["bias"]),
                                       rtol=1e-4, atol=1e-6)


N, C = 6, 40


def test_member_sampler_matches_jax_vmapped():
    """Prioritized replay of 3 members with the slot kernel's path: each
    member samples its own rows (level 1 over its row sums, IS weights by
    its own batch max, its own γ), as the JAX sampler vmapped over the
    members' states; the draws of each member's key are injected."""
    rng = np.random.default_rng(3)
    kw = dict(alpha=0.6, beta=0.4, eps=1e-6, max_decay=0.999, gamma=0.97, n_step=3,
              use_pallas=True)
    jr, tr = JaxPER(N, C, **kw), PrioritizedReplay(N, C, members=M, **kw)

    def transitions():
        x = dict(
            obs=rng.standard_normal((M, N, 3)).astype(np.float32),
            action=rng.integers(0, 4, (M, N)).astype(np.int32),
            reward=rng.standard_normal((M, N)).astype(np.float32),
            next_obs=rng.standard_normal((M, N, 3)).astype(np.float32),
            terminated=rng.random((M, N)) < 0.1,
            truncated=rng.random((M, N)) < 0.05,
        )
        return ([JaxTransition(**{k: jnp.asarray(v[m]) for k, v in x.items()}) for m in range(M)],
                Transition(**{k: torch.tensor(v.reshape((M * N,) + v.shape[2:]))
                              for k, v in x.items()}))

    tj, tt = transitions()
    js, ts = [jr.init(t) for t in tj], tr.init(tt)
    for _ in range(25):
        tj, tt = transitions()
        js, ts = [jr.add(s, t) for s, t in zip(js, tj)], tr.add(ts, tt)
    pri = (rng.integers(1, 257, (M, N, C)) / 64.0 * (rng.random((M, N, C)) > 0.3)).astype(np.float32)
    js = jax.tree.map(lambda *x: jnp.stack(x), *[s.replace(priorities=jnp.asarray(pri[m]))
                                                 for m, s in enumerate(js)])
    ts.priorities = torch.tensor(pri.reshape(M * N, C))
    gamma, beta = np.array([0.9, 0.97, 0.99], np.float32), np.array([0.3, 0.4, 0.5], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), M)
    b = 37
    batch_j, info_j, w_j = jax.vmap(lambda s, k, g, be: jr.sample_with_info(s, k, b, g, be))(
        js, keys, jnp.asarray(gamma), jnp.asarray(beta))
    u = [np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[i], (b,))) for k in keys])
         for i in (0, 1)]
    sample_kernels.reset_counts()
    batch_t, info_t, w_t = tr.sample_with_info(
        ts, None, b, gamma=torch.tensor(gamma), beta=torch.tensor(beta),
        uniforms=tuple(torch.tensor(x) for x in u),
    )
    assert sample_kernels.plain_calls == {"per_slot_sample": 1}  # one call, all members
    rows = np.asarray(info_j.env_idx) + np.arange(M)[:, None] * N
    np.testing.assert_array_equal(info_t.env_idx.numpy(), rows)
    np.testing.assert_array_equal(info_t.slot_idx.numpy(), np.asarray(info_j.slot_idx))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    for name in ("obs", "action", "next_obs"):
        np.testing.assert_array_equal(getattr(batch_t, name).numpy(),
                                      np.asarray(getattr(batch_j, name)))
    for name in ("reward", "bootstrap"):
        np.testing.assert_allclose(getattr(batch_t, name).numpy(),
                                   np.asarray(getattr(batch_j, name)), rtol=1e-6, atol=1e-7)

    # a closed gate leaves its member's priorities and max priority alone
    before, max_before = ts.priorities.clone(), ts.max_priority.clone()
    tr.update_priorities(ts, info_t, torch.full((M, b), 2.5), mask=[True, False, True])
    assert torch.equal(ts.priorities[N:2 * N], before[N:2 * N])
    assert not torch.equal(ts.priorities[:N], before[:N])
    assert ts.max_priority[1] == max_before[1] and ts.max_priority[0] == 2.5 + 1e-6


@pytest.mark.parametrize("n,w,p_done", [(16, 8, 0.3), (8, 32, 0.5)])
def test_member_window_accounting_matches_jax_vmapped(n, w, p_done):
    rng = np.random.default_rng(n + w)
    window = rng.standard_normal((M, w)).astype(np.float32)
    cursor = np.array([0, 3, w - 1], np.int32)
    filled = np.array([0, w, 5], np.int32)
    done = rng.random((M, n)) < p_done
    returns = rng.standard_normal((M, n)).astype(np.float32)
    want = jax.vmap(jax_scatter_returns)(*map(jnp.asarray, (window, cursor, filled, done, returns)))
    got = _scatter_completed_returns(*map(torch.tensor, (window, cursor.astype(np.int64),
                                                         filled.astype(np.int64), done, returns)))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_counters_match_jax_population():
    """Per-member gates: train_every [1, 2, 3] and training_start [32, 64,
    48] give each member exactly the JAX population's updates, per
    superstep and in total, and its own Adam count."""
    cadence = dict(train_every=[1, 2, 3], training_start=[32, 64, 48])
    jcfg = dataclasses.replace(jax_config.cartpole_vector(), **TINY)
    init_j, step_j, _ = jax_build_population(jcfg, num_members=M)
    runner_j = jax_set_population_hyper(init_j(jax.random.PRNGKey(0)), **cadence)
    step_j = jax.jit(step_j, donate_argnums=0)
    want = []
    for _ in range(4):
        runner_j, m = step_j(runner_j)
        want.append(np.asarray(m.loss_count).astype(int).tolist())
    adam = [s for s in jax.tree_util.tree_leaves(
        runner_j.train.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]

    cfg = dataclasses.replace(config.cartpole_vector(), **TINY)
    init, step, _ = build_population(cfg, M, device="cpu")
    runner = set_population_hyper(init(0), **cadence)
    got = []
    for _ in range(4):
        runner, m = step(runner)
        got.append(m.loss_count.tolist())
    assert got == want
    assert runner.train.updates == np.asarray(runner_j.train.updates).tolist()
    assert runner.train.opt_state.count == np.asarray(adam.count).tolist()
    assert m.env_steps == int(np.asarray(runner_j.env_step)[0]) == 32
    # hard sync every 250 steps of cartpole_vector: none in 32 steps, as in JAX
    assert all(not torch.equal(t, p) for t, p in zip(runner.train.target.parameters(),
                                                     runner.train.online.parameters()))


def _pallas_tiny():
    return dataclasses.replace(config.cartpole_vector(), **TINY, use_pallas=True,
                               replay="prioritized", double=True, use_pallas_sampler=True)


def test_member_is_independent_of_another_members_learning_rate():
    """Member 0's params after 4 supersteps are bitwise the same whether
    member 1 learns at 1e-4 or 1e-2 (the fused loss and the slot kernel's
    plain versions, PER)."""
    finals = []
    for lr1 in (1e-4, 1e-2):
        init, step, _ = build_population(_pallas_tiny(), 2, device="cpu")
        runner = set_population_hyper(init(0), learning_rate=[1e-3, lr1])
        counts = sum(step(runner)[1].loss_count for _ in range(4))
        assert counts.tolist() == [29, 29]  # vector steps 4..32
        finals.append([p.detach().clone() for p in runner.train.online.parameters()])
    assert all(torch.equal(a[0], b[0]) for a, b in zip(*finals))
    assert not all(torch.equal(a[1], b[1]) for a, b in zip(*finals))


def test_set_population_hyper_validation():
    init, _, _ = build_population(dataclasses.replace(config.cartpole_vector(), **TINY), 2,
                                  device="cpu")
    runner = init(0)
    with pytest.raises(ValueError):
        set_population_hyper(runner, batch_size=32)  # static, not runtime
    with pytest.raises(ValueError):
        set_population_hyper(runner, gamma=[0.9, 0.99, 0.999])  # wrong length
    set_population_hyper(runner, gamma=0.95, train_every=[1.0, 3.7], learning_rate=[1e-3, 2e-3])
    assert runner.hyper.gamma.tolist() == pytest.approx([0.95, 0.95])
    assert runner.hyper.train_every == (1, 3)  # int32 casts truncate
    assert runner.hyper.learning_rate.dtype == torch.float32


def test_eval_env_matches_training_engine():
    """The eval env is the training env's engine (the JAX package's
    test_eval_env_matches_training_engine)."""
    lunar = dataclasses.replace(config.cartpole_vector(), **TINY, env_id="LunarLander-v2",
                                time_fraction_obs=True, max_steps_in_episode=64,
                                lander_engine="rigid")
    trainer = PopulationTrainer(lunar, num_members=2, eval_envs=4, device="cpu")
    assert trainer._eval_env_params.jointed is False
    jointed = dataclasses.replace(lunar, lander_engine="jointed")
    trainer2 = PopulationTrainer(jointed, num_members=2, eval_envs=4, device="cpu")
    assert trainer2._eval_env_params.jointed is True
    assert trainer2._eval_env_params.vel_iters == jointed.lander_vel_iters


def test_train_population_end_to_end_and_fresh_runs():
    cands = [{"learning_rate": 1e-3, "gamma": 0.99}, {"learning_rate": 3e-4, "gamma": 0.97}]
    cfg = dataclasses.replace(_pallas_tiny(), max_steps_in_episode=20)
    res = train_population(cfg, num_members=2, max_env_steps=512,
                           hyper_overrides=candidate_overrides(cands), eval_envs=4, device="cpu")
    assert res["window_mean"].shape == res["eval_mean"].shape == res["eval_truncated"].shape == (2,)
    assert res["env_steps"] >= 512 and np.isfinite(res["eval_mean"]).all()
    trainer = PopulationTrainer(cfg, num_members=2, eval_envs=4, device="cpu")
    first = trainer.run(128, seed=3)
    again = trainer.run(128, seed=3)  # the same build, fresh members
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])
    with pytest.raises(ValueError):
        candidate_overrides([{"gamma": 0.9}, {"learning_rate": 1e-3}])
