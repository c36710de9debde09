"""The single learner's frame and update through CUDA-graph-ready code
(``algos/superstep.py::GraphedLearner``), on the CPU.

On the CPU the graphed learner calls its frame and update functions
directly, on the same static buffers and device counters the card's
graphs are bound to, so these tests hold everything the card's replays
depend on but the capture itself:

  * a ``Trainer`` of ``lunar_per`` shrunk to 8 envs, hidden (32, 32), 64
    slots a row and batch 32, ``graphed=True`` against ``graphed=False``
    over 3 supersteps that wrap the ring: every tensor and counter of the
    runners bitwise equal (the checkpoint tree reads the device counters
    back against their host mirrors), and the metrics;
  * the replay's device cursor and fill against the host mirrors through
    the wrap, and a write at a device cursor equal to one at a host int;
  * the PER sample from the device counters against the JAX package's
    ``sample_with_info`` on injected uniforms at fills below, at and past
    the capacity (indices exact, weights at rtol 1e-6, as
    ``tests/test_torch_replay.py`` holds them, and the priorities written
    from the same TD errors at 4 ulps);
  * Adam with its count on the device against optax over 30 steps (rtol
    1e-6, as ``tests/test_torch_optim.py`` holds the optimizer), and its
    bias correction, read from a table of optax's float32 values, equal
    to the host's numpy one at every count to 60,000 and to optax's
    ``tree_bias_correction`` where the correctly rounded power is not;
  * ε in a float32 device scalar against the host float, on a grid of
    draws a few ulps either side of ε;
  * a checkpoint of the graphed learner restored and run on, bitwise.
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
from deep_q_learning_tpu_torch.algos.dqn import HyperParams, epsilon_greedy, make_optimizer
from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
from deep_q_learning_tpu_torch.config import DQNConfig, lunar_per
from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.replay import PrioritizedReplay
from deep_q_learning_tpu_torch.replay.uniform import alloc_storage, write_row
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

# lunar_per at 8 envs, 64 slots a row: 3 supersteps of 32 frames wrap the
# ring at frame 64; the learner starts at frame 8 (64 stored transitions)
SMALL = dict(num_envs=8, hidden=(32, 32), buffer_capacity=8 * 64, batch_size=32,
             steps_per_superstep=32, training_start=64, return_window=4)
SUPERSTEPS = 3
N, C, D = 3, 8, 2


def _same(a, b, where="runner"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    cfg = dataclasses.replace(lunar_per(), **SMALL)
    root = tmp_path_factory.mktemp("graphed_learner")
    runs = {}
    for graphed in (True, False):
        tr = Trainer(cfg, device="cpu", workdir=str(root / str(graphed)),
                     graphed=graphed).init(seed=3)
        runs[graphed] = tr, [tr.step() for _ in range(SUPERSTEPS)]
    return cfg, runs


def test_graphed_learner_equals_eager_bitwise(trainers):
    cfg, runs = trainers
    (g, g_metrics), (e, e_metrics) = runs[True], runs[False]
    assert isinstance(g._superstep, GraphedLearner)
    assert not isinstance(e._superstep, GraphedLearner)
    assert g_metrics == e_metrics
    frames = SUPERSTEPS * cfg.steps_per_superstep
    updates = frames - cfg.training_start // cfg.num_envs + 1
    assert sum(m.loss_count for m in g_metrics) == updates
    r = g.runner
    assert r.train.updates == r.train.opt_state.count == int(r.train.opt_state.device_count)
    assert r.train.updates == updates
    assert (r.replay.cursor, r.replay.total_adds) == (frames % 64, frames)
    assert (int(r.replay.device_cursor), int(r.replay.device_adds)) == (frames % 64, frames)
    # every tensor of the runner, the counters read back from the device
    _same(ckpt._to_tree(g.runner), ckpt._to_tree(e.runner))
    for a, b in ((r.replay.device_cursor, e.runner.replay.device_cursor),
                 (r.train.opt_state.device_count, e.runner.train.opt_state.device_count)):
        assert torch.equal(a, b)


def test_graphed_learner_resumes_bitwise(trainers):
    cfg, runs = trainers
    g, _ = runs[True]
    g.save(step=g.runner.env_step * cfg.num_envs)
    resumed = Trainer(cfg, device="cpu", workdir=g.workdir).restore()
    assert isinstance(resumed._superstep, GraphedLearner)
    r = resumed.runner
    assert int(r.replay.device_cursor) == r.replay.cursor == g.runner.replay.cursor
    assert int(r.train.opt_state.device_count) == r.train.opt_state.count
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))
    assert [resumed.step() for _ in range(2)] == [g.step() for _ in range(2)]
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))


def test_checkpoint_refuses_a_counter_off_its_mirror(trainers, tmp_path):
    _, runs = trainers
    g, _ = runs[False]
    r = g.runner
    r.replay.device_adds.add_(1)
    try:
        with pytest.raises(RuntimeError, match="device_adds"):
            ckpt.save_checkpoint(str(tmp_path), r, 1)
    finally:
        r.replay.device_adds.sub_(1)


def _transition(rng, n=N):
    x = dict(
        obs=rng.standard_normal((n, D)).astype(np.float32),
        action=rng.integers(0, 4, n).astype(np.int32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, D)).astype(np.float32),
        terminated=rng.random(n) < 0.2,
        truncated=rng.random(n) < 0.1,
    )
    return (
        JaxTransition(**{k: jnp.asarray(v) for k, v in x.items()}),
        Transition(**{k: torch.tensor(v) for k, v in x.items()}),
    )


def test_device_cursor_and_fill_follow_their_mirrors_through_the_wrap():
    rng = np.random.default_rng(0)
    replay = PrioritizedReplay(N, C, n_step=3)
    state = replay.init(_transition(rng)[1])
    seen = []
    for _ in range(2 * C + 3):
        replay.write(state, _transition(rng)[1])
        # the device half alone leaves the host mirrors where they were
        assert int(state.device_adds) == state.total_adds + 1
        replay.advance(state)
        cursor, adds = int(state.device_cursor), int(state.device_adds)
        assert (cursor, adds) == (state.cursor, state.total_adds)
        assert min(adds, C) == state.filled
        seen.append((cursor, state.filled))
    assert seen[C - 2] == (C - 1, C - 1) and seen[C - 1] == (0, C) and seen[C] == (1, C)
    assert seen[-1] == ((2 * C + 3) % C, C)


def test_write_at_a_device_cursor_equals_a_host_cursor():
    rng = np.random.default_rng(1)
    _, example = _transition(rng)
    host, device = alloc_storage(example, C), alloc_storage(example, C)
    for i in range(C + 3):
        _, tr = _transition(rng)
        write_row(host, i % C, tr)
        write_row(device, torch.tensor(i % C), tr)
    for name in ("obs", "next_obs", "aux"):
        assert torch.equal(getattr(host, name), getattr(device, name))


@pytest.mark.parametrize("adds", [C - 1, C, C + 1, 2 * C + 3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sample_from_device_counters_matches_jax(adds, use_pallas):
    rng = np.random.default_rng(adds)
    kw = dict(alpha=0.6, beta=0.4, eps=1e-6, max_decay=0.999, gamma=0.97, n_step=3)
    jr, tr = JaxPER(N, C, **kw), PrioritizedReplay(N, C, use_pallas=use_pallas, **kw)
    tj, tt = _transition(rng)
    js, ts = jr.init(tj), tr.init(tt)
    for _ in range(adds):
        tj, tt = _transition(rng)
        js, ts = jr.add(js, tj), tr.add(ts, tt)
    assert (int(ts.device_cursor), int(ts.device_adds)) == (int(js.cursor), int(js.total_adds))
    ints = rng.integers(0, 6, (N, C)).astype(np.float32)
    js = js.replace(priorities=jnp.asarray(ints))
    ts.priorities.copy_(torch.tensor(ints))
    b, key = 64, jax.random.PRNGKey(adds)
    batch_j, info_j, w_j = jr.sample_with_info(js, key, b)
    env_key, slot_key = jax.random.split(key)
    u = (jax.random.uniform(env_key, (b,)), jax.random.uniform(slot_key, (b,)))
    batch_t, info_t, w_t = tr.sample_with_info(
        ts, None, b, uniforms=tuple(torch.tensor(np.asarray(x)) for x in u))
    np.testing.assert_array_equal(info_t.env_idx.numpy(), np.asarray(info_j.env_idx))
    np.testing.assert_array_equal(info_t.slot_idx.numpy(), np.asarray(info_j.slot_idx))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    for name in ("obs", "action", "reward", "next_obs", "bootstrap"):
        np.testing.assert_allclose(
            getattr(batch_t, name).numpy(), np.asarray(getattr(batch_j, name)), rtol=1.2e-7)
    td = (rng.standard_normal(b) * 3).astype(np.float32)
    js = jr.update_priorities(js, info_j, jnp.asarray(td))
    kept = ts.max_priority
    tr.update_priorities(ts, info_t, torch.tensor(td))
    assert ts.max_priority is kept  # written in place, as a graph needs
    np.testing.assert_allclose(ts.priorities.numpy(), np.asarray(js.priorities), rtol=5e-7)
    np.testing.assert_allclose(float(ts.max_priority), float(js.max_priority), rtol=1e-7)


def test_adam_with_a_device_count_matches_optax_over_30_steps():
    cfg = DQNConfig(optimizer="adam", learning_rate=3e-4, max_grad_norm=10.0)
    rng = np.random.default_rng(5)
    shapes = {"a": (5, 3), "b": (3,), "c": (4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0).astype(np.float32) for k, s in shapes.items()}
             for _ in range(30)]
    jopt = jax_make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)

    opt = make_optimizer(cfg)
    keys = sorted(shapes)
    tp = [torch.tensor(params[k]) for k in keys]
    state = opt.init(tp)
    assert state.device_count.dtype == torch.int32
    h = HyperParams.from_config(cfg)
    for i, g in enumerate(grads):
        # a caller inside a graph advances the host mirror itself
        opt.apply([torch.tensor(g[k]) for k in keys], state, tp, h.learning_rate,
                  h.max_grad_norm, advance=i % 2 == 0)
    assert int(state.device_count) == 30 and state.count == 15
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("decay,differ", [(0.9, []), (0.999, [])])
def test_device_bias_correction_is_the_correctly_rounded_power(decay, differ):
    """The device count's bias correction, read from the table of optax's
    float32 values, against the host's numpy float32 one (optax's formula)
    at every count to 60,000: equal everywhere (``differ`` is empty), also
    at 0.999's counts 2958 and 3606, where the correctly rounded power of
    the float32 decay is an ulp off numpy's and optax's.  The table ends at
    the first count whose correction is 1.0f, and a count past it reads
    1.0f."""
    from deep_q_learning_tpu_torch.algos.dqn import (
        _bias_correction,
        _device_bias_correction,
        bias_correction_table,
    )

    counts = torch.arange(1, 60_001, dtype=torch.int32)
    device = _device_bias_correction(decay, counts).numpy()
    host = np.array([_bias_correction(decay, k) for k in range(1, 60_001)], dtype=np.float32)
    assert list(np.nonzero(device != host)[0] + 1) == differ
    table = bias_correction_table(decay, "cpu")
    last = {0.9: 165, 0.999: 17_321}[decay]  # the first count at 1.0f, checked with numpy
    assert table.numel() == last + 1 and table[-1] == 1 and table[-2] < 1
    assert bias_correction_table(decay, "cpu") is table  # made once
    # one member's count, several members' counts
    assert _device_bias_correction(decay, torch.tensor(2958, dtype=torch.int32)).shape == ()
    pair = _device_bias_correction(decay, torch.tensor([0, 1], dtype=torch.int32))
    assert pair[0] == pair[1] == host[0]


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_device_bias_correction_equals_optax(decay):
    """The corrected moment ``m / (1 - decay**count)`` from the device
    table against optax's ``tree_bias_correction`` on JAX's CPU, at the
    counts where the correctly rounded power departs from optax's (2958,
    3606) and on either side of the table's end for both decays."""
    from deep_q_learning_tpu_torch.algos.dqn import _device_bias_correction

    moments = np.array([1.0, 0.37, -2.5e-3, 7.0], dtype=np.float32)
    for count in (1, 2, 164, 165, 2958, 3606, 17_320, 17_321, 60_000):
        want = optax.tree_utils.tree_bias_correction(
            jnp.asarray(moments), decay, jnp.asarray(count, jnp.int32))
        bc = _device_bias_correction(decay, torch.tensor(count, dtype=torch.int32))
        got = torch.tensor(moments) / bc
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(count))


@pytest.mark.parametrize("eps", [0.1, 0.1 + 1e-12, 0.505, 1 / 3, 0.0200001, 0.999999999])
def test_epsilon_in_a_device_scalar_acts_as_the_host_float(eps):
    """``u < ε`` and ``u / ε`` take a host float as a float32, so the float32
    scalar the graph reads acts as the float the host computed: on draws a
    few ulps either side of float32(ε), where rounding ε otherwise would
    flip a draw between exploring and acting greedily."""
    e32 = np.float32(eps)
    below = [e32]
    above = [e32]
    for _ in range(4):
        below.append(np.nextafter(below[-1], np.float32(0)))
        above.append(np.nextafter(above[-1], np.float32(1)))
    grid = np.array(sorted(set(below + above)), dtype=np.float32)
    u = torch.tensor(np.repeat(grid, 4))
    q = torch.tensor(np.random.default_rng(0).standard_normal((u.numel(), 4)).astype(np.float32))
    static = torch.zeros(())
    static.fill_(eps)
    host = epsilon_greedy(None, q, eps, u=u)
    device = epsilon_greedy(None, q, static, u=u)
    assert torch.equal(host, device)
    explored = (u < static).numpy()
    assert explored.any() and not explored.all()
