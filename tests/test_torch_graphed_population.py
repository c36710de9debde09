"""The population superstep through CUDA-graph-ready code
(``algos/superstep.py::GraphedPopulation``), on the CPU.

On the CPU the graphed population calls its frame and update functions
directly, on the same static buffers, gate mask and device counters the
card's graphs are bound to, so these tests hold everything the card's
replays depend on but the capture itself:

  * ``lunar_per`` shrunk to 3 members of 8 envs, hidden (32, 32), 64 slots
    a row and batch 32, graphed against eager over 3 supersteps that wrap
    the ring, with mixed gates (``train_every`` 1, 2, 3 and member 2
    learning from a later ``training_start``): every tensor and counter of
    the runners bitwise equal (the checkpoint tree reads the device
    counters back against their host mirrors), and the metrics;
  * which populations are graphed: every one with ``graphed_learner``, on
    the lander and the classic envs, with either replay;
  * the members' PER sample from the device counters (the host mirrors
    left behind) against the JAX package's ``sample_with_info`` vmapped
    over the members' states, on injected uniforms, at fills below, at and
    past the capacity: indices exact, weights at rtol 1e-6, as
    ``tests/test_torch_population.py`` holds them;
  * member Adam with its counts on the device against optax per member
    over 30 steps with some gates closed (rtol 1e-6, as
    ``tests/test_torch_optim.py`` holds the optimizer);
  * a checkpoint of the graphed population restored and run on, bitwise;
  * ``set_population_hyper`` between supersteps: graphed and eager stay
    bitwise equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_q_learning_tpu.algos.dqn import make_optimizer as jax_make_optimizer
from deep_q_learning_tpu.envs.base import Transition as JaxTransition
from deep_q_learning_tpu.replay import PrioritizedReplay as JaxPER
from deep_q_learning_tpu_torch.algos import make_optimizer
from deep_q_learning_tpu_torch.algos.superstep import GraphedPopulation
from deep_q_learning_tpu_torch.config import DQNConfig, cartpole_vector, lunar_per
from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.parallel import build_population, set_population_hyper
from deep_q_learning_tpu_torch.replay import PrioritizedReplay
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

# lunar_per at 3 members of 8 envs, 64 slots a row: 3 supersteps of 32
# frames wrap the ring at frame 64; members 0 and 1 learn from frame 8 (64
# stored transitions), member 2 from frame 20
SMALL = dict(num_envs=8, hidden=(32, 32), buffer_capacity=8 * 64, batch_size=32,
             steps_per_superstep=32, training_start=64, return_window=4)
M, SUPERSTEPS = 3, 3
GATES = dict(train_every=[1, 2, 3], training_start=[64, 64, 160])


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


def _population(graphed, seed=3, **sets):
    cfg = dataclasses.replace(lunar_per(), **SMALL, **sets)
    init, step, _ = build_population(cfg, M, device="cpu", graphed_learner=graphed)
    return cfg, set_population_hyper(init(seed), **GATES), step


@pytest.fixture(scope="module")
def populations():
    runs = {}
    for graphed in (True, False):
        cfg, runner, step = _population(graphed)
        runs[graphed] = runner, step, [step(runner)[1] for _ in range(SUPERSTEPS)]
    return cfg, runs


def test_graphed_population_equals_eager_bitwise(populations):
    cfg, runs = populations
    (g, g_step, g_metrics), (e, e_step, e_metrics) = runs[True], runs[False]
    assert isinstance(g_step, GraphedPopulation) and not isinstance(e_step, GraphedPopulation)
    for a, b in zip(g_metrics, e_metrics):
        _same_metrics(a, b)
    frames = SUPERSTEPS * cfg.steps_per_superstep
    # each member's own gates: every k-th frame from its warm-up frame on
    want = [sum(1 for f in range(1, frames + 1) if f % k == 0 and f * cfg.num_envs >= s)
            for k, s in zip(GATES["train_every"], GATES["training_start"])]
    assert sum(m.loss_count for m in g_metrics).tolist() == want
    assert len(set(want)) == M  # the gates differ
    opt = g.train.opt_state
    assert g.train.updates == opt.count == opt.device_count.tolist() == want
    assert (g.replay.cursor, g.replay.total_adds) == (frames % 64, frames)
    assert (int(g.replay.device_cursor), int(g.replay.device_adds)) == (frames % 64, frames)
    # every tensor of the runner, the counters read back from the device
    _same(ckpt._to_tree(g), ckpt._to_tree(e))
    assert torch.equal(g.train.opt_state.device_count, e.train.opt_state.device_count)


def test_only_a_graphed_lander_with_per_gets_the_graphed_population():
    """Every env of the port injects its draws, so every population with
    ``graphed_learner`` set is graphed, with either replay, on the lander
    and on the classic envs; ``graphed_learner=False`` is eager."""
    for cfg, graphed, want in (
        (dataclasses.replace(lunar_per(), **SMALL), True, True),
        (dataclasses.replace(lunar_per(), **SMALL), False, False),
        (dataclasses.replace(lunar_per(), **SMALL, replay="uniform"), True, True),
        (dataclasses.replace(cartpole_vector(), **SMALL, replay="prioritized"), True, True),
        (dataclasses.replace(cartpole_vector(), **SMALL), True, True),
        (dataclasses.replace(cartpole_vector(), **SMALL), False, False),
    ):
        _, step, _ = build_population(cfg, 2, device="cpu", graphed_learner=graphed)
        assert isinstance(step, GraphedPopulation) == want, (cfg.env_id, cfg.replay, graphed)


N, C, D = 3, 8, 2


def _transitions(rng):
    x = dict(
        obs=rng.standard_normal((M, N, D)).astype(np.float32),
        action=rng.integers(0, 4, (M, N)).astype(np.int32),
        reward=rng.standard_normal((M, N)).astype(np.float32),
        next_obs=rng.standard_normal((M, N, D)).astype(np.float32),
        terminated=rng.random((M, N)) < 0.2,
        truncated=rng.random((M, N)) < 0.1,
    )
    return ([JaxTransition(**{k: jnp.asarray(v[m]) for k, v in x.items()}) for m in range(M)],
            Transition(**{k: torch.tensor(v.reshape((M * N,) + v.shape[2:]))
                          for k, v in x.items()}))


@pytest.mark.parametrize("adds", [C - 1, C, C + 1, 2 * C + 3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_member_sample_from_device_counters_matches_jax_vmapped(adds, use_pallas):
    """Written with the device half alone (``write``), so the host mirrors
    stay at 0: the sample reads the device cursor and fill."""
    rng = np.random.default_rng(adds)
    kw = dict(alpha=0.6, beta=0.4, eps=1e-6, max_decay=0.999, gamma=0.97, n_step=3)
    jr = JaxPER(N, C, **kw)
    tr = PrioritizedReplay(N, C, use_pallas=use_pallas, members=M, **kw)
    tj, tt = _transitions(rng)
    js, ts = [jr.init(t) for t in tj], tr.init(tt)
    for _ in range(adds):
        tj, tt = _transitions(rng)
        js = [jr.add(s, t) for s, t in zip(js, tj)]
        tr.write(ts, tt)
    assert (ts.cursor, ts.total_adds) == (0, 0)
    assert (int(ts.device_cursor), int(ts.device_adds)) == (adds % C, adds)
    pri = (rng.integers(1, 257, (M, N, C)) / 64.0 * (rng.random((M, N, C)) > 0.3)).astype(
        np.float32)
    js = jax.tree.map(lambda *x: jnp.stack(x), *[s.replace(priorities=jnp.asarray(pri[m]))
                                                 for m, s in enumerate(js)])
    ts.priorities.copy_(torch.tensor(pri.reshape(M * N, C)))
    gamma = np.array([0.9, 0.97, 0.99], np.float32)
    beta = np.array([0.3, 0.4, 0.5], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(adds), M)
    b = 37
    batch_j, info_j, w_j = jax.vmap(lambda s, k, g, be: jr.sample_with_info(s, k, b, g, be))(
        js, keys, jnp.asarray(gamma), jnp.asarray(beta))
    u = [np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[i], (b,))) for k in keys])
         for i in (0, 1)]
    batch_t, info_t, w_t = tr.sample_with_info(
        ts, None, b, gamma=torch.tensor(gamma), beta=torch.tensor(beta),
        uniforms=tuple(torch.tensor(x) for x in u))
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


def test_member_adam_with_device_counts_matches_optax_over_30_steps():
    """3 members, each its own optax chain (the clip and Adam) in JAX,
    applied only on the steps where its gate is open; the port's members
    from one call a step with the gate mask, on the device or as host
    bools, each member's Adam count on the device."""
    cfg = DQNConfig(optimizer="adam", learning_rate=3e-4, max_grad_norm=10.0)
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 3), "b": (3,), "c": (4, 2)}
    params = {k: rng.standard_normal((M,) + s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal((M,) + s) * 10.0).astype(np.float32)
              for k, s in shapes.items()} for _ in range(30)]
    gates = rng.random((30, M)) < 0.7
    gates[0] = True
    gates[5:9, 1] = False
    lrs = np.array([1e-4, 3e-4, 1e-3], np.float32)

    want = []
    for m in range(M):
        jopt = jax_make_optimizer(dataclasses.replace(cfg, learning_rate=float(lrs[m])))
        jp = {k: jnp.asarray(v[m]) for k, v in params.items()}
        jstate = jopt.init(jp)
        for g, gate in zip(grads, gates):
            if gate[m]:
                upd, jstate = jopt.update({k: jnp.asarray(v[m]) for k, v in g.items()}, jstate, jp)
                jp = optax.apply_updates(jp, upd)
        want.append(jp)

    opt = make_optimizer(cfg)
    keys = sorted(shapes)
    tp = [torch.tensor(params[k]) for k in keys]
    state = opt.init(tp, members=M)
    assert state.device_count.dtype == torch.int32 and state.device_count.shape == (M,)
    lr, clip = torch.tensor(lrs), torch.full((M,), 10.0)
    for i, (g, gate) in enumerate(zip(grads, gates)):
        grad = [torch.tensor(g[k]) for k in keys]
        if i % 2:  # a device mask, the host mirror advanced by its caller
            opt.apply(grad, state, tp, lr, clip, torch.tensor(gate), advance=False)
            state.count = [c + bool(k) for c, k in zip(state.count, gate)]
        else:
            opt.apply(grad, state, tp, lr, clip, gate.tolist())
    counts = gates.sum(axis=0).tolist()
    assert state.device_count.tolist() == state.count == counts
    for m in range(M):
        for k, t in zip(keys, tp):
            np.testing.assert_allclose(t[m].numpy(), np.asarray(want[m][k]), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="advance=False"):
        opt.apply(grad, state, tp, lr, clip, torch.tensor(gate))


def test_graphed_population_resumes_bitwise(tmp_path):
    cfg, runner, step = _population(True, seed=5)
    step(runner)
    ckpt.save_checkpoint(str(tmp_path), runner, runner.env_step)
    init, _, _ = build_population(cfg, M, device="cpu")
    restored = ckpt.restore_checkpoint(str(tmp_path), init(0))
    assert restored.hyper.train_every == tuple(GATES["train_every"])
    assert restored.train.opt_state.device_count.tolist() == runner.train.opt_state.count
    assert int(restored.replay.device_cursor) == restored.replay.cursor == runner.replay.cursor
    _same(ckpt._to_tree(restored), ckpt._to_tree(runner))
    for _ in range(2):
        _same_metrics(step(restored)[1], step(runner)[1])
    _same(ckpt._to_tree(restored), ckpt._to_tree(runner))
    # a member's device count off its host mirror is refused at save time
    restored.train.opt_state.device_count[1] += 1
    with pytest.raises(RuntimeError, match="device_count"):
        ckpt.save_checkpoint(str(tmp_path), restored, 1)


def test_set_population_hyper_between_supersteps_keeps_graphed_equal_eager():
    runs = {}
    for graphed in (True, False):
        _, runner, step = _population(graphed, seed=7)
        metrics = [step(runner)[1]]
        set_population_hyper(runner, learning_rate=[1e-3, 2e-4, 5e-4], gamma=[0.9, 0.99, 0.95],
                             per_beta=0.6, train_every=[2, 1, 1], training_start=[64, 160, 64])
        metrics += [step(runner)[1] for _ in range(2)]
        runs[graphed] = runner, metrics
    (g, g_metrics), (e, e_metrics) = runs[True], runs[False]
    for a, b in zip(g_metrics, e_metrics):
        _same_metrics(a, b)
    _same(ckpt._to_tree(g), ckpt._to_tree(e))
    assert g.hyper.learning_rate.tolist() == pytest.approx([1e-3, 2e-4, 5e-4])
