"""The port's runs over ranks (``parallel/distributed.py``, ``mesh.py``,
``train.DistributedTrainer``) on the CPU, against the JAX mesh program.

Two gloo ranks are spawned once for the module (``tests/_torch_dist_worker.py``)
and run every multi-rank scenario at tiny widths; the JAX side runs here on
2 of conftest's 8 virtual CPU devices.

Tolerances: the learner is bitwise the same on both ranks (online and
target weights, Adam moments and count), in ``steps`` and ``episodes``
sync modes; a resumed superstep is bitwise the uninterrupted one; the
graphed rank (graph L1, the collective, graph L2) is bitwise the eager rank
on both ranks, superstep by superstep, whole runners included, and after a
resume; the world-1 ``DistributedTrainer`` is bitwise ``Trainer``, graphed
and eager; the mean of the ranks' sums is bitwise ``lax.pmean``'s at 2, 3
and 4 shards; the counters
(env steps, updates per superstep, the first update frame) are exact
against the JAX program, and so are the metric reductions (max, sum, mean,
min) and ``exp_episode`` ε per shard (float32 ulps: rtol 1e-6); the
all-reduced update against ``build_update_step(..., axis_name="env")``
under ``shard_map``: rtol 1e-4 (atol 1e-6 on weights, 1e-5 on td), the
single update's tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from deep_q_learning_tpu.algos.dqn import TrainState as JaxTrainState
from deep_q_learning_tpu.algos.dqn import build_update_step as jax_build_update_step
from deep_q_learning_tpu.algos.dqn import epsilon_by_schedule as jax_epsilon
from deep_q_learning_tpu.algos.dqn import make_optimizer as jax_make_optimizer
from deep_q_learning_tpu.config import DQNConfig as JaxDQNConfig
from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.parallel import aggregate_metrics as jax_aggregate
from deep_q_learning_tpu.parallel import build_distributed_superstep as jax_distributed
from deep_q_learning_tpu.parallel import make_env_mesh
from deep_q_learning_tpu.replay.nstep import LearnBatch as JaxBatch
from deep_q_learning_tpu_torch.algos.dqn import mean_of_sum
from deep_q_learning_tpu_torch.algos.superstep import METRIC_REDUCTIONS, GraphedLearner
from deep_q_learning_tpu_torch.parallel import dryrun_multichip, local_config, spawn_ranks
from deep_q_learning_tpu_torch.parallel.mesh import distributed_init, rank_device
from deep_q_learning_tpu_torch.train import DistributedTrainer, Trainer

WORLD = worker.WORLD
RANKS_TIMEOUT_S = 300


def _jax_cfg(cfg):
    return JaxDQNConfig(**dataclasses.asdict(cfg))


def _update_inputs():
    net = FlaxQNetwork(num_actions=4, hidden=(16, 16), dueling=True)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    rng = np.random.default_rng(0)
    b = worker.update_cfg(False).batch_size
    return {
        "params": to_np(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))),
        "target": to_np(net.init(jax.random.PRNGKey(1), jnp.zeros((1, 9)))),
        "batch": dict(
            obs=rng.standard_normal((b, 9)).astype(np.float32),
            action=rng.integers(0, 4, b).astype(np.int32),
            reward=(3.0 * rng.standard_normal(b)).astype(np.float32),
            next_obs=rng.standard_normal((b, 9)).astype(np.float32),
            bootstrap=(0.97 * (rng.random(b) > 0.2)).astype(np.float32),
        ),
        "weights": (rng.random(b) + 0.1).astype(np.float32),
    }


@pytest.fixture(scope="module")
def inputs():
    return _update_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Spawn the gloo ranks once; their reports, by rank."""
    workdir = str(tmp_path_factory.mktemp("ranks"))
    return spawn_ranks(worker.run, WORLD, workdir, inputs, timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def mesh2():
    assert jax.device_count() >= 2, "conftest must provide the virtual devices"
    return make_env_mesh(2)


@pytest.mark.parametrize("mode", ["steps", "episodes", "exp_episode"])
def test_two_ranks_keep_the_learner_bitwise_equal(ranks, mode):
    a, b = (r[mode] for r in ranks)
    assert a["updates"] > 0, "no update ran"
    assert a["digest"] == b["digest"]
    assert a["metrics"] == b["metrics"]  # combined metrics: the same on every rank
    if mode == "episodes":
        # both ranks synced on the summed count, and keep it
        assert a["last_sync_episodes"] == b["last_sync_episodes"] > 0
        assert a["last_sync_episodes"] <= a["metrics"][-1]["episodes"]
        assert a["local_episodes"] + b["local_episodes"] == a["metrics"][-1]["episodes"]


@pytest.mark.parametrize("mode", ["steps", "episodes", "exp_episode", "per"])
def test_graphed_rank_equals_eager_rank_bitwise(ranks, mode):
    """The graphed rank (``GraphedLearner`` under the group: graph L1, the
    eager all-reduce, graph L2) against the eager rank from the same seed:
    the metrics, the learner and the whole runner after every superstep, on
    both ranks; and the eager rank restored from the graphed one's
    checkpoint takes the next superstep as the graphed restores do.
    ``per``: the prioritized replay with both kernels' plain versions, the
    TD errors written into the local priorities inside graph L1."""
    for r in ranks:
        got = r[mode]
        assert got["graphed"] == [True, False]
        assert got["updates"] > 0, "no update ran"
        assert got["graphed_steps"] == got["eager_steps"]
        assert got["eager_resumed"] == got["resumed"][0]
    assert ranks[0][mode]["graphed_steps"][-1][1] == ranks[1][mode]["graphed_steps"][-1][1]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_mean_of_sum_is_pmean_bitwise(world):
    """``mean_of_sum`` (F6) against ``lax.pmean`` under ``shard_map`` over
    ``world`` of conftest's virtual CPU devices, on the same float32 sums
    (``lax.psum`` of the same shards): XLA multiplies the sum by the
    float32 reciprocal of the world size.  At 3 shards a true division
    differs from it in about a third of the elements."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(world)
    shards = (rng.standard_normal((world, 100_000)) * 10.0 ** rng.integers(-6, 3, 100_000)
              ).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:world]), ("env",))
    both = shard_map(lambda x: (jax.lax.psum(x, "env"), jax.lax.pmean(x, "env")), mesh=mesh,
                     in_specs=P("env"), out_specs=(P(), P()), check_vma=False)
    total, mean = (np.asarray(x).reshape(-1) for x in jax.jit(both)(shards))
    ours = mean_of_sum(torch.from_numpy(total.copy()), world).numpy()
    np.testing.assert_array_equal(ours, mean)
    divided = (torch.from_numpy(total.copy()) / world).numpy()
    if world == 3:
        assert (divided != mean).mean() > 0.2
    else:  # a power of two: the reciprocal is exact
        np.testing.assert_array_equal(divided, mean)


def test_counters_match_jax(ranks, mesh2):
    """Env steps and updates per superstep (and so the first update frame)
    equal the 2-shard JAX program's: the warm-up gate counts global
    transitions."""
    cfg = worker.cartpole_cfg()
    init_runner, superstep, _ = jax_distributed(_jax_cfg(cfg), mesh2)
    runner = init_runner(jax.random.PRNGKey(7))
    step = jax.jit(superstep, donate_argnums=0)
    theirs = []
    for _ in range(worker.SUPERSTEPS):
        runner, m = step(runner)
        theirs.append((jax_aggregate(m, cfg)["env_steps"], int(float(m.loss_count))))
    ours = [(m["env_steps"] * cfg.num_envs, m["loss_count"]) for m in ranks[0]["steps"]["metrics"]]
    assert ours == theirs

    def first_update_frame(counts):
        i = next(k for k, (_, c) in enumerate(counts) if c)
        return i * cfg.steps_per_superstep + cfg.steps_per_superstep - counts[i][1] // WORLD + 1

    # 80 global transitions at 8 envs: vector step 10 (at 4 local envs it would be 20)
    assert first_update_frame(ours) == first_update_frame(theirs) == 10
    assert ranks[0]["steps"]["updates"] == sum(c for _, c in ours) // WORLD


def test_metric_reductions_follow_jax(ranks):
    """``reduce_metrics``: max of the lockstep counters and ε, sums of the
    tallies, the mean of the windows, the min of ``solved``, the same on
    every rank."""
    locals_ = [r["reduce"]["local"] for r in ranks]
    want = []
    for i, name in enumerate(METRIC_REDUCTIONS):
        col = [v[i] for v in locals_]
        want.append({"env_steps": max, "epsilon": max, "solved": min,
                     "window_mean": lambda c: sum(c) / len(c)}.get(name, sum)(col))
    for r in ranks:
        assert r["reduce"]["reduced"] == want


def test_checkpoint_resume_is_bitwise_at_two_ranks(ranks):
    """Two restores of the saved step each take the next superstep bitwise
    as the run that went on without stopping; the same on both ranks."""
    for mode in ("steps", "episodes"):
        per_rank = [r[mode]["resumed"] for r in ranks]
        for resumed in per_rank:
            (m0, d0), (m1, d1, saved1), (m2, d2, saved2) = resumed
            assert saved1 == saved2 == ranks[0][mode]["digest"]
            assert d0 == d1 == d2 and m0 == m1 == m2
        assert per_rank[0][0] == per_rank[1][0]


def test_restore_under_another_world_size_is_refused(ranks):
    assert "written by 2 ranks" in ranks[0]["steps"]["refused"]


def test_exp_episode_epsilon_is_per_shard(ranks):
    """As the JAX shard body computes it: each rank's ε from its own episode
    count over its own ``num_envs``; the combined ε is their max."""
    cfg = worker.cartpole_cfg(eps_schedule="exp_episode", eps_decay=0.9)
    local = _jax_cfg(local_config(cfg, WORLD))
    episodes = [r["exp_episode"]["local_episodes"] for r in ranks]
    assert sum(episodes) == ranks[0]["exp_episode"]["metrics"][-1]["episodes"]
    per_shard = [float(jax_epsilon(local, jnp.float32(0), jnp.int32(e))) for e in episodes]
    np.testing.assert_allclose(ranks[0]["exp_episode"]["metrics"][-1]["epsilon"], max(per_shard),
                               rtol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused"])
def test_update_matches_jax_shard_map(ranks, inputs, mesh2, use_pallas):
    """One all-reduced update (gradients and loss averaged before the clip)
    against the JAX update under ``shard_map`` with ``axis_name="env"``, on
    the same weights and per-shard batches; with ``use_pallas`` the JAX
    side runs the Pallas kernels in interpret mode."""
    cfg = _jax_cfg(worker.update_cfg(use_pallas))
    net = FlaxQNetwork(num_actions=4, hidden=(16, 16), dueling=True)
    opt = jax_make_optimizer(cfg)
    update = jax_build_update_step(net.apply, opt, cfg, axis_name="env")
    params = jax.tree.map(jnp.asarray, inputs["params"])
    ts = JaxTrainState(params=params, target_params=jax.tree.map(jnp.asarray, inputs["target"]),
                       opt_state=opt.init(params), updates=jnp.int32(0))
    run = shard_map(update, mesh=mesh2, in_specs=(P(), P("env"), P("env")),
                    out_specs=(P(), P(), P("env")), check_vma=False)
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    ts, loss, td = jax.jit(run)(ts, batch, jnp.asarray(inputs["weights"]))
    b = cfg.batch_size // WORLD
    for r in ranks:
        ours = r["update"][use_pallas]
        np.testing.assert_allclose(ours["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(ours["td"], np.asarray(td)[r["rank"] * b:(r["rank"] + 1) * b],
                                   rtol=1e-4, atol=1e-5)
        for key, tree in (("online", ts.params), ("target", ts.target_params)):
            for name, (kernel, bias) in ours[key].items():
                np.testing.assert_allclose(kernel, np.asarray(tree["params"][name]["kernel"]),
                                           rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(bias, np.asarray(tree["params"][name]["bias"]),
                                           rtol=1e-4, atol=1e-6)
    assert ranks[0]["update"][use_pallas]["digest"] == ranks[1]["update"][use_pallas]["digest"]


@pytest.mark.parametrize("field,value", [("num_envs", 63), ("batch_size", 5)])
def test_validation_errors_match_jax(mesh2, field, value):
    cfg = dataclasses.replace(worker.cartpole_cfg(), **{field: value})
    with pytest.raises(ValueError) as theirs:
        jax_distributed(_jax_cfg(cfg), mesh2)
    with pytest.raises(ValueError) as ours:
        local_config(cfg, 2)
    assert str(ours.value) == str(theirs.value)


@pytest.fixture
def world_one():
    """A world-1 gloo group in this process, torn down after the test."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    distributed_init(device="cpu")
    distributed_init(device="cpu")  # idempotent
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_world_one_rank_equals_trainer_graphed_and_eager(world_one, graphed):
    """At world size 1 the rank's three update stages are the single
    learner's update, bitwise: the graphed rank against the graphed
    ``Trainer``, the eager rank against the eager one, whole runners.  The
    rank's greedy evaluator (its eval step graphed, or eager) equals the
    eager form on its envs."""
    from deep_q_learning_tpu_torch.algos.evaluate import build_evaluator

    cfg = worker.cartpole_cfg(replay="prioritized")
    single = Trainer(cfg, device="cpu", graphed_learner=graphed).init(seed=5)
    ranked = DistributedTrainer(cfg, device="cpu", graphed_learner=graphed).init(seed=5)
    assert isinstance(ranked._superstep, GraphedLearner) is graphed
    assert isinstance(single._superstep, GraphedLearner) is graphed
    for _ in range(3):
        assert dataclasses.asdict(ranked.step()) == dataclasses.asdict(single.step())
        assert worker.runner_digest(ranked.runner) == worker.runner_digest(single.runner)
    assert single.runner.train.updates > 0
    assert (ranked._evaluate.graph is not None) is graphed
    eager = build_evaluator(ranked.eval_venv, ranked.env_params, 30, graphed=False)
    got = ranked.evaluate(seed=2, max_steps=30)
    want = eager(ranked.runner.train.online, torch.Generator().manual_seed(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_world_one_distributed_trainer_equals_trainer(world_one, tmp_path):
    """At world size 1 the distributed run is the single learner's, bitwise:
    the same seeds, the all-reduce a division by 1, the metrics as read."""
    cfg = worker.cartpole_cfg()
    single = Trainer(cfg, device="cpu").init(seed=3)
    dist_tr = DistributedTrainer(cfg, device="cpu", workdir=str(tmp_path)).init(seed=3)
    assert rank_device("cpu") == torch.device("cpu")
    for _ in range(3):
        assert dataclasses.asdict(dist_tr.step()) == dataclasses.asdict(single.step())
    assert worker.learner_digest(dist_tr.runner.train) == worker.learner_digest(single.runner.train)
    assert torch.equal(dist_tr.runner.obs, single.runner.obs)
    result = dist_tr.train(max_env_steps=5 * 64, log_every=1, checkpoint_every=1, verbose=False)
    assert result.env_steps == 5 * 64
    assert sorted(p.name for p in tmp_path.iterdir()) == ["256", "320", "config.json"]


def test_dryrun_multichip_two_ranks():
    """The jointed lander with PER and both kernels' plain versions under
    the all-reduce, one superstep over 2 gloo ranks."""
    reports = dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["backend"] == "gloo" and r["updates"] == 4
        assert r["plain_calls"] == {"td_loss_fwd": 4, "td_loss_bwd": 4, "per_slot_sample": 4}
