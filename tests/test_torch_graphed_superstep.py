"""A whole superstep as one CUDA graph (``algos/superstep.py``:
``GraphedLearner`` and ``GraphedPopulation`` replaying
``_LearnerWork.superstep``), on the CPU.

On the CPU the superstep's graph is its function called directly, on the
buffers, tables and device counters the card's capture is bound to, its
random numbers drawn from the runner's generator in the function, so
these tests hold everything a replay depends on but the capture itself.
Each case runs the same seed four ways, superstep by superstep:

  * ``whole``: every superstep after the first as the superstep's graph
    (its pattern marked as seen before it, so that the warm-up boundary
    runs through the graph too);
  * ``natural``: the graphed learner as it chooses (a pattern's graph at
    its second sighting), which must run the steady supersteps whole;
  * ``frames``: ``max_graphs = 0``, every superstep frame by frame;
  * ``eager``: ``graphed=False``;

and holds every tensor and counter of the four runners (the checkpoint
tree: the generator's state, the device counters read back against their
host mirrors) and their metrics bitwise equal after every superstep.  The
cases: ``lunar_per`` with the PER slot sampler on, the warm-up ending in
the middle of the second superstep; ``cartpole_vector`` with a hard sync
every 5 frames over 8-frame supersteps (decided on the device frame
counter); ``lunar_ref_parity``'s sync on the episode count; a checkpoint
of the whole-graph learner restored mid-run; a 3-member ``lunar_per``
population with mixed ``train_every`` and warm-ups, then new cadences and
learning rates from ``set_population_hyper``.

Against the JAX package: the frames on which the port's superstep graph
runs an update and a hard sync equal those on which the JAX superstep's
``_maybe_train`` and ``_maybe_sync`` do, for the same config, seen through
one-frame JAX supersteps (an update adds to ``loss_count``; a sync changes
the target parameters, which an update has moved away from the online ones
since the last sync on every sync frame of this cadence).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deep_q_learning_tpu import config as jax_config
from deep_q_learning_tpu.train import Trainer as JaxTrainer
from deep_q_learning_tpu_torch import config
from deep_q_learning_tpu_torch.algos import superstep as superstep_mod
from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner, GraphedPopulation
from deep_q_learning_tpu_torch.parallel import build_population, set_population_hyper
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

SMALL = dict(hidden=(32, 32), batch_size=16, steps_per_superstep=8, return_window=4)
CASES = {
    # the warm-up ends at frame 12, in the middle of the second superstep
    "lunar_per_sampler": ("lunar_per", dict(
        num_envs=8, buffer_capacity=8 * 32, training_start=8 * 12, use_pallas_sampler=True)),
    # a hard sync every 5 frames: 5 does not divide the superstep's 8
    "cartpole_steps_sync": ("cartpole_vector", dict(
        num_envs=16, buffer_capacity=16 * 32, training_start=16 * 10, target_sync_every=5)),
    # syncs every 2 episodes, episodes cut at 12 frames so that they end;
    # updates every 4 frames from frame 16; the rigid engine, for time
    "ref_parity_episodes_sync": ("lunar_ref_parity", dict(
        num_envs=8, buffer_capacity=8 * 32, training_start=8 * 14, target_replace_episodes=2,
        max_steps_in_episode=12, lander_engine="rigid")),
}
SUPERSTEPS = 6
MODES = ("whole", "natural", "frames", "eager")


def _same(a, b, where="runner"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _same_metrics(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)


def _expect_whole(learner, runner):
    """Mark ``runner``'s next pattern as seen, so that the superstep runs
    as its graph (once the learner is bound to the runner)."""
    if learner.bound_to is not None:
        learner.seen[learner.key(runner)] = None


def _trainer(cfg, mode, tmp_path):
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path / mode), graphed=mode != "eager")
    if mode == "frames":
        tr._superstep.max_graphs = 0
    return tr


def _step(tr, mode):
    if mode == "whole":
        _expect_whole(tr._superstep, tr.runner)
    return tr.step()


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_superstep_equals_frames_and_eager_bitwise(case, tmp_path):
    preset, cut = CASES[case]
    cfg = dataclasses.replace(getattr(config, preset)(), **SMALL, **cut)
    trainers = {mode: _trainer(cfg, mode, tmp_path).init(seed=5) for mode in MODES}
    for _ in range(SUPERSTEPS):
        metrics = {mode: _step(tr, mode) for mode, tr in trainers.items()}
        for mode in MODES[1:]:
            assert metrics[mode] == metrics["whole"], (case, mode)
            _same(ckpt._to_tree(trainers[mode].runner), ckpt._to_tree(trainers["whole"].runner),
                  f"{mode} runner")
    runs = {mode: dict(tr._superstep.runs) for mode, tr in trainers.items() if mode != "eager"}
    assert runs["whole"] == {"frames": 1, "whole": SUPERSTEPS - 1}
    # warm-up, boundary, then the steady pattern: its graph from its second sighting
    assert runs["natural"] == {"frames": 3, "whole": SUPERSTEPS - 3}
    assert runs["frames"] == {"frames": SUPERSTEPS}
    assert len(trainers["natural"]._superstep.supersteps) == 1
    r = trainers["whole"].runner
    frames = SUPERSTEPS * cfg.steps_per_superstep
    assert r.env_step == int(r.device_env_step) == frames
    assert r.train.updates == int(r.train.opt_state.device_count) > 0
    if cfg.target_sync_mode == "episodes":
        assert int(r.last_sync_episodes) >= cfg.target_replace_episodes  # it synced


def test_whole_superstep_resumes_bitwise(tmp_path):
    preset, cut = CASES["lunar_per_sampler"]
    cfg = dataclasses.replace(getattr(config, preset)(), **SMALL, **cut)
    g = _trainer(cfg, "whole", tmp_path).init(seed=2)
    for _ in range(3):
        _step(g, "whole")
    g.save(step=g.runner.env_step * cfg.num_envs)
    resumed = Trainer(cfg, device="cpu", workdir=g.workdir).restore()
    assert isinstance(resumed._superstep, GraphedLearner)
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))
    for _ in range(3):
        assert _step(resumed, "whole") == _step(g, "whole")
        _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))
    assert resumed._superstep.runs == {"frames": 1, "whole": 2}  # its graphs start over


POP_MEMBERS = 3
POP_SMALL = dict(num_envs=8, hidden=(32, 32), buffer_capacity=8 * 32, batch_size=16,
                 steps_per_superstep=8, training_start=64, return_window=4)
POP_GATES = dict(train_every=[1, 2, 3], training_start=[64, 64, 160])
POP_LATER = dict(train_every=[2, 1, 3], learning_rate=[1e-4, 3e-4, 1e-3])


def test_whole_population_superstep_equals_frames_and_eager_bitwise():
    cfg = dataclasses.replace(config.lunar_per(), **POP_SMALL)
    pops = {}
    for mode in ("whole", "frames", "eager"):
        init, step, _ = build_population(cfg, POP_MEMBERS, device="cpu",
                                         graphed_learner=mode != "eager")
        if mode != "eager":
            # whole: room for every pattern (mixed cadences make 5 before
            # they repeat); frames: none
            step.max_graphs = 0 if mode == "frames" else 2 * SUPERSTEPS
        pops[mode] = set_population_hyper(init(4), **POP_GATES), step
    assert isinstance(pops["whole"][1], GraphedPopulation)
    for i in range(2 * SUPERSTEPS):
        if i == SUPERSTEPS:
            for runner, _ in pops.values():
                set_population_hyper(runner, **POP_LATER)
        metrics = {}
        for mode, (runner, step) in pops.items():
            if mode == "whole":
                _expect_whole(step, runner)
            metrics[mode] = step(runner)[1]
        for mode in ("frames", "eager"):
            _same_metrics(metrics[mode], metrics["whole"])
            _same(ckpt._to_tree(pops[mode][0]), ckpt._to_tree(pops["whole"][0]), mode)
    runner, step = pops["whole"]
    # new hyperparameter tensors: the graphs start over, once frame by frame
    assert step.runs == {"frames": 2, "whole": 2 * SUPERSTEPS - 2}
    counts = runner.train.opt_state.count
    assert runner.train.updates == counts == runner.train.opt_state.device_count.tolist()
    assert len(set(counts)) == POP_MEMBERS  # the gates differ


# the port's superstep graph against one-frame JAX supersteps: CartPole,
# updates every 3 frames from frame 12 (warm-up ends in the second
# 8-frame superstep), a hard sync every 5 frames
CADENCE = dict(num_envs=8, hidden=(16, 16), batch_size=8, buffer_capacity=8 * 32,
               training_start=8 * 10, train_every=3, target_sync_every=5, return_window=4)
CADENCE_FRAMES = 32


def _jax_cadence():
    cfg = dataclasses.replace(jax_config.cartpole_vector(), **CADENCE, steps_per_superstep=1)
    tr = JaxTrainer(cfg).init(seed=0)
    updates, syncs = [], []
    for frame in range(1, CADENCE_FRAMES + 1):
        before = jax.tree_util.tree_map(np.asarray, tr.runner.train.target_params)  # donated
        tr.runner, m = tr._superstep(tr.runner)
        if int(m.loss_count):
            updates.append(frame)
        changed = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a, b: bool((a != np.asarray(b)).any()), before, tr.runner.train.target_params))
        if any(changed):
            syncs.append(frame)
    return updates, syncs


def test_superstep_graph_updates_and_syncs_on_the_jax_frames(monkeypatch):
    cfg = dataclasses.replace(config.cartpole_vector(), **CADENCE, steps_per_superstep=8)
    tr = Trainer(cfg, device="cpu", graphed=True).init(seed=0)
    learner, updates, syncs = tr._superstep, [], []
    work, sync_target = learner.work, superstep_mod.sync_target
    learn = work.learn

    def recording_learn(*args):
        updates.append(int(work.runner.device_env_step))
        return learn(*args)

    def recording_sync(train, do_sync=True):
        if bool(do_sync):
            syncs.append(int(work.runner.device_env_step))
        return sync_target(train, do_sync)

    work.learn = recording_learn
    monkeypatch.setattr(superstep_mod, "sync_target", recording_sync)
    for _ in range(CADENCE_FRAMES // cfg.steps_per_superstep):
        _expect_whole(learner, tr.runner)
        tr.step()
    assert learner.runs == {"frames": 1, "whole": CADENCE_FRAMES // 8 - 1}
    jax_updates, jax_syncs = _jax_cadence()
    assert updates[0] == 12 and updates == jax_updates
    # the first frames' syncs change nothing in JAX: no update has moved
    # the online parameters yet
    assert [f for f in syncs if f > updates[0]] == [f for f in jax_syncs if f > updates[0]]
    assert syncs == list(range(5, CADENCE_FRAMES + 1, 5))
