"""The lander's env step through ``envs/graphed.py``'s stepper against the
eager path, on the CPU, bitwise.

On the CPU the stepper makes a direct call where the card replays a CUDA
graph, through the same static input and output buffers, so these tests
exercise the buffer handling that the card depends on: the draws taken
from the generator outside the step in the eager step's order, the inputs
copied in, the outputs overwritten by the next call.  Held against
``graphed=False`` (the eager path), with every tensor equal bit for bit:

  * ``VectorEnv.step`` over 40 frames of 8 rigid and 8 jointed landers from
    a flight near the ground, with ``max_steps_in_episode`` cut to 40 so
    that truncations and terminations both auto-reset; every output kept
    (copied) and compared, and an output held past the next frame without
    a copy seen overwritten;
  * ``fresh_pool`` and ``reset``;
  * a tiny ``lunar_jointed_per`` ``Trainer`` (``tests/test_torch_jointed.py``'s
    cut) over 3 supersteps: metrics, parameters, Adam state, the replay
    ring and priorities, env states and counters; its greedy evaluation;
    and a ``restore`` of its checkpoint that continues bitwise;
  * ``TorchHostEnv`` on the jointed lander, resets and injected draws
    included;
  * the stepper itself: static buffers, an argument that is already the
    static input, a mismatched argument refused.
"""

import dataclasses

import pytest
import torch

from deep_q_learning_tpu_torch.compat.host_env import TorchHostEnv
from deep_q_learning_tpu_torch.config import lunar_jointed_per
from deep_q_learning_tpu_torch.envs import CartPole, LunarLander, VectorEnv
from deep_q_learning_tpu_torch.envs.graphed import GraphedStep, tree_leaves, tree_map
from deep_q_learning_tpu_torch.envs.heuristic import touchdown_states
from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLanderParams
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

N, FRAMES, FLIGHT = 8, 40, 20
TINY = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 32, steps_per_superstep=8,
            training_start=32, hidden=(32, 32), return_window=4)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i}"


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
        assert a == b, where


def _lander(engine, max_steps=30):
    return LunarLander(), LunarLanderParams(
        jointed=engine == "jointed", vel_iters=120, pos_iters=40, max_steps_in_episode=max_steps)


@pytest.mark.parametrize("engine", ["rigid", "jointed"])
def test_vector_step_through_the_stepper_equals_eager(engine):
    # the flight ends at t = 20: episodes are cut 20 frames on, and again 40 after
    env, p = _lander(engine, max_steps=40)
    obs0, states0 = touchdown_states(env, p, N, torch.Generator().manual_seed(1), frames=FLIGHT)
    lanes = torch.arange(N, dtype=torch.int32)
    runs = {}
    for graphed in (True, False):
        venv = VectorEnv(env, N, graphed=graphed)
        assert venv.graphed == graphed
        g = torch.Generator().manual_seed(3)
        acts = torch.Generator().manual_seed(4)
        pool = venv.fresh_pool(g, p)
        kept, held = [_clone(pool)], []
        obs, states = obs0.clone(), _clone(states0)
        for _ in range(FRAMES):
            # lanes 4-7 at random; lanes 0-3 fire a side engine, which tips a
            # lander near the ground over (a crash)
            actions = torch.where(lanes >= 4, torch.randint(
                0, 4, (N,), generator=acts, dtype=torch.int32), 1 + 2 * (lanes % 2))
            out = venv.step(g, states, actions, p, prev_obs=obs, fresh=pool)
            held.append(out)  # as returned, no copy
            kept.append(_clone(out))
            obs, states, _ = out
        runs[graphed] = kept, held, venv
    (g_kept, g_held, g_venv), (e_kept, e_held, _) = runs[True], runs[False]
    _equal(g_kept, e_kept)
    # the eager outputs are the caller's own; the stepper's are its static
    # outputs, so one held past the next frame holds the last frame's values
    _equal(e_held, e_kept[1:])
    assert all(h[0] is g_held[-1][0] for h in g_held)
    _equal(g_held[0], g_kept[-1])
    assert not torch.equal(g_kept[1][0], g_kept[-1][0])
    transitions = [tr for _, _, tr in g_kept[1:]]
    assert any(bool(tr.terminated.any()) for tr in transitions)
    assert any(bool(tr.truncated.any()) for tr in transitions)
    assert sorted(kind for kind, *_ in g_venv._graphs) == ["reset pool", "step"]


@pytest.mark.parametrize("engine", ["rigid", "jointed"])
def test_fresh_pool_and_reset_through_the_stepper_equal_eager(engine):
    env, p = _lander(engine)
    runs = {}
    for graphed in (True, False):
        venv = VectorEnv(env, N, graphed=graphed)
        g = torch.Generator().manual_seed(9)
        start = venv.reset(g, p)
        start_copy = _clone(start)
        pools = [_clone(venv.fresh_pool(g, p)) for _ in range(2)]
        _equal(start, start_copy)  # reset's states are the caller's: no pool overwrote them
        runs[graphed] = start, pools
    _equal(runs[True], runs[False])
    assert not torch.equal(runs[True][1][0][0], runs[True][1][1][0])


def test_step_without_a_pool_resets_through_the_stepper():
    """No ``fresh`` pool: the reset draws follow the step's, as the eager
    ``reset_batch`` takes them."""
    env, p = _lander("rigid")
    runs = {}
    for graphed in (True, False):
        venv = VectorEnv(env, N, graphed=graphed)
        g = torch.Generator().manual_seed(5)
        obs, states = venv.reset(g, p)
        kept = []
        for t in range(35):
            actions = torch.full((N,), t % 4, dtype=torch.int32)
            obs, states, tr = venv.step(g, states, actions, p, prev_obs=obs)
            kept.append(_clone((obs, states, tr)))
        runs[graphed] = kept
    _equal(runs[True], runs[False])
    assert any(bool(tr.truncated.any()) for _, _, tr in runs[True])


def test_classic_envs_stay_eager():
    """The classic envs inject their resets' draw and so graph their vector
    step; they stay eager under ``graphed=False``, as does an env that does
    not inject its draws."""
    assert VectorEnv(CartPole(), 4).graphed
    assert not VectorEnv(CartPole(), 4, graphed=False).graphed

    class Drawing(CartPole):
        injects_draws = False

    assert not VectorEnv(Drawing(), 4).graphed


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The tiny jointed trainer through the stepper and eagerly, 3
    supersteps each from seed 4."""
    cfg = dataclasses.replace(lunar_jointed_per(), **TINY)
    root = tmp_path_factory.mktemp("graphed")
    runs = {}
    for graphed in (True, False):
        tr = Trainer(cfg, device="cpu", workdir=str(root / f"graphed_{graphed}"),
                     graphed=graphed).init(seed=4)
        runs[graphed] = tr, [tr.step() for _ in range(3)]
    return cfg, runs


def test_tiny_jointed_trainer_through_the_stepper_equals_eager(trainers):
    _, runs = trainers
    (g, g_metrics), (e, e_metrics) = runs[True], runs[False]
    assert g.venv.graphed and not e.venv.graphed
    assert g_metrics == e_metrics
    assert [m.loss_count for m in g_metrics] == [5, 8, 8]
    _same(ckpt._to_tree(g.runner), ckpt._to_tree(e.runner))


def test_tiny_jointed_evaluation_through_the_stepper_equals_eager(trainers):
    _, runs = trainers
    (g, _), (e, _) = runs[True], runs[False]
    got, want = g.evaluate(seed=2, max_steps=6), e.evaluate(seed=2, max_steps=6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and (a == b).all()
    assert got.returns.shape == (10,)


def test_tiny_jointed_trainer_resumes_bitwise_through_the_stepper(trainers):
    cfg, runs = trainers
    g, _ = runs[True]
    g.save(step=g.runner.env_step * cfg.num_envs)
    resumed = Trainer(cfg, device="cpu", workdir=g.workdir).restore()
    assert resumed.venv.graphed
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))
    assert [resumed.step() for _ in range(2)] == [g.step() for _ in range(2)]
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))


def test_trainers_graph_a_vel_tol_config_bitwise_eager(monkeypatch):
    """``lander_vel_tol > 0`` (the velocity passes' early exit) once made the
    solver read the device every pass, so the trainers built such a
    config's envs eagerly.  The exit now runs per env inside the solver's
    kernel on the card, with no host read, and every lander config graphs:
    ``Trainer``, ``DistributedTrainer`` and ``PopulationTrainer`` build
    their training and evaluation envs through the stepper with the
    tolerance 0 and 1e-3 alike, and a ``Trainer`` of the 1e-3 config
    through the stepper equals ``graphed=False`` bitwise over 2 supersteps
    and an evaluation."""
    import torch.distributed as dist

    from deep_q_learning_tpu_torch import train
    from deep_q_learning_tpu_torch.parallel import distributed, population
    from deep_q_learning_tpu_torch.parallel.mesh import distributed_init
    from deep_q_learning_tpu_torch.train import DistributedTrainer

    built = []

    class Recorded(VectorEnv):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self.graphed)

    for module in (distributed, population, train):
        monkeypatch.setattr(module, "VectorEnv", Recorded)
    cfg = dataclasses.replace(lunar_jointed_per(), **TINY)
    tol = dataclasses.replace(cfg, lander_vel_tol=1e-3)
    assert not dist.is_initialized()
    distributed_init(device="cpu")
    try:
        for c in (cfg, tol):
            built.clear()
            tr = Trainer(c, device="cpu").init(seed=0)
            DistributedTrainer(c, device="cpu")
            pop = population.PopulationTrainer(c, 2, eval_envs=2, device="cpu")
            assert built == [True] * 6
        assert pop.step(pop.init(seed=0))[1].env_steps == TINY["steps_per_superstep"]
    finally:
        dist.destroy_process_group()
    eager = Trainer(tol, device="cpu", graphed=False).init(seed=0)
    assert tr.venv.graphed and not eager.venv.graphed
    assert [tr.step() for _ in range(2)] == [eager.step() for _ in range(2)]
    _same(ckpt._to_tree(tr.runner), ckpt._to_tree(eager.runner))
    got, want = tr.evaluate(seed=0, max_steps=2), eager.evaluate(seed=0, max_steps=2)
    assert got.returns.shape == (10,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and (a == b).all()


def test_host_env_through_the_stepper_equals_eager():
    env, p = _lander("jointed")
    p = dataclasses.replace(p, max_steps_in_episode=6)
    runs = {}
    for graphed in (True, False):
        draws = torch.Generator().manual_seed(8)
        host = TorchHostEnv(env, p, seed=2, device="cpu", graphed=graphed)
        assert host.graphed == graphed
        seq = [host.reset()[0]]
        for t in range(14):
            injected = torch.rand((1, 2), generator=draws) * 2 - 1 if t % 5 == 4 else None
            obs, reward, term, trunc, _ = host.step(t % 4, injected)
            seq.append((obs, reward, term, trunc))
            if term or trunc:
                seq.append(host.reset()[0])
        runs[graphed] = seq
    assert len(runs[True]) == len(runs[False]) > 15  # two resets at least
    for a, b in zip(runs[True], runs[False]):
        if isinstance(a, tuple):
            assert (a[0] == b[0]).all() and a[1:] == b[1:]
        else:
            assert (a == b).all()


def test_graphed_step_owns_its_buffers():
    calls = []

    def fn(x, pair):
        calls.append(x.clone())
        return x * 2, (pair[0] + 1, None)

    step = GraphedStep(fn)
    a = torch.arange(3.0)
    first = step(a, (torch.ones(2), None))
    assert step.inputs[0] is not a and torch.equal(step.inputs[0], a)
    held = first[0]
    second = step(a + 1, (torch.zeros(2), None))
    assert second[0] is held and torch.equal(held, (a + 1) * 2)  # overwritten in place
    assert torch.equal(second[1][0], torch.ones(2)) and second[1][1] is None
    step(*step.inputs)  # the static inputs themselves: nothing to copy
    assert torch.equal(calls[-1], a + 1) and len(calls) == 3
    with pytest.raises(ValueError, match="held"):
        step(torch.arange(4.0), (torch.ones(2), None))
    with pytest.raises(ValueError, match="held"):
        step(a.long(), (torch.ones(2), None))
    with pytest.raises(ValueError, match="tensors given"):
        step(a, (torch.ones(2), torch.ones(2)))
