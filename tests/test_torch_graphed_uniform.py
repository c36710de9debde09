"""The uniform replay's learner and the classic envs' step through
CUDA-graph-ready code (``algos/superstep.py::GraphedLearner``,
``GraphedPopulation``; ``envs/base.py::VectorEnv``), on the CPU.

On the CPU the graphed learner calls its frame and update functions
directly, on the same static buffers and device counters the card's graphs
are bound to, so these tests hold everything the card's replays depend on
but the capture itself:

  * each classic env: a reset from ``reset_draws`` is bitwise the
    generator's reset, and ``VectorEnv`` graphed equals it eager, bitwise,
    over 20 frames with resets;
  * the uniform n-step sample against the JAX package's: with injected
    uniforms every slot lies inside JAX's valid window (partly filled, at
    and past the wrap, n-step 1, 3 and 5; one learner and 3 members), the
    indices follow ``min(⌊u·N⌋, N-1)`` and ``(cursor - fill + min(⌊u·R⌋,
    R-1)) mod C``, and the assembled batch equals JAX's ``assemble`` on the
    same indices (rtol as ``tests/test_torch_replay.py``, the members' as
    ``tests/test_torch_population.py``); over 2^20 draws
    the env and rank histograms of JAX's ``sample_with_info`` and of the
    port's each pass a chi-square test against uniform (p > 1e-4, fixed
    seeds); and every age rank's probability within 0.1 % of 1/R at the
    largest ring a preset has (100,000 slots, ``lunar_ref_parity``),
    counted exactly from the mapping on the CPU's float64 grid and the
    card's (within 1.6e-11 of 1/R on both; a float32 uniform misses by
    0.46 %);
  * ``GraphedLearner`` with the uniform replay against the eager
    superstep (``graphed=False``: the env step and the learner eager),
    bitwise in every runner tensor and counter, for cut-down
    ``cartpole_vector``, ``acrobot_vector``, ``mountain_car_vector`` and
    ``lunar_dddqn_vector``, two supersteps past ``training_start`` through
    the ring's wrap; a graphed learner restored from its checkpoint runs on
    bitwise, and a device counter off its host mirror is refused at save;
  * ``GraphedPopulation`` with the uniform replay: 3 members with mixed
    gates, bitwise the eager population.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deep_q_learning_tpu.envs.base import Transition as JaxTransition
from deep_q_learning_tpu.replay import UniformReplay as JaxUniform
from deep_q_learning_tpu.replay.nstep import assemble_learn_batch as jax_assemble
from deep_q_learning_tpu.replay.nstep import valid_slot_mask as jax_valid_mask
from deep_q_learning_tpu_torch import config
from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner, GraphedPopulation
from deep_q_learning_tpu_torch.envs import make_env
from deep_q_learning_tpu_torch.envs.base import Transition, VectorEnv
from deep_q_learning_tpu_torch.parallel import build_population, set_population_hyper
from deep_q_learning_tpu_torch.replay import UniformReplay
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

CLASSIC = ["CartPole-v1", "Acrobot-v1", "MountainCar-v0"]
# each preset cut to 8 envs and 16 slots a row: 3 supersteps of 8 frames
# wrap the ring at frame 16; the learner starts at frame 4 (32 stored);
# episodes cut to 12 frames so that the auto-reset runs
TINY = dict(num_envs=8, batch_size=16, buffer_capacity=8 * 16, steps_per_superstep=8,
            training_start=32, hidden=(16, 16), return_window=4)
PRESETS = {
    # a hard sync every 4 frames runs eagerly between the graphs
    "cartpole_vector": dict(TINY, target_sync_every=4, max_steps_in_episode=12),
    "acrobot_vector": dict(TINY, max_steps_in_episode=12),
    "mountain_car_vector": dict(TINY, max_steps_in_episode=12),  # n-step 5
    "lunar_dddqn_vector": dict(TINY, max_steps_in_episode=12),
}
SUPERSTEPS = 3


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


# ---------------------------------------------------------------- classic envs


@pytest.mark.parametrize("env_id", CLASSIC)
def test_reset_from_injected_draws_is_the_generators_reset(env_id):
    env, p = make_env(env_id)
    assert env.injects_draws and env.step_draws(torch.Generator(), 5) is None
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    obs, st = env.reset_env(g1, 37, p)
    obs_d, st_d = env.reset_env(None, 37, p, env.reset_draws(g2, 37))
    _same((obs, dataclasses.asdict(st)), (obs_d, dataclasses.asdict(st_d)), env_id)
    # both generators moved on by the same draw
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3, generator=g2))


@pytest.mark.parametrize("env_id", CLASSIC)
def test_vector_env_graphed_equals_eager_bitwise(env_id):
    env, p = make_env(env_id, max_steps_in_episode=6)
    n = 16
    runs = {}
    for graphed in (True, False):
        venv = VectorEnv(env, n, graphed=graphed)
        assert venv.graphed == graphed
        g = torch.Generator().manual_seed(9)
        obs, states = venv.reset(g, p)
        kept = []
        for t in range(20):
            actions = torch.randint(0, env.num_actions, (n,), generator=g, dtype=torch.int32)
            obs, states, tr = venv.step(g, states, actions, p, prev_obs=obs)
            # a graphed step's outputs are overwritten by the next: keep copies
            # (asdict copies each tensor)
            kept.append((obs.clone(), dataclasses.asdict(states), dataclasses.asdict(tr)))
        runs[graphed] = kept
    _same(runs[True], runs[False])
    assert any(bool(tr["truncated"].any()) for _, _, tr in runs[True])


# ---------------------------------------------------------- the uniform sample

N, C, D = 5, 8, 2


def _transition(rng, t, rows=N):
    """A transition whose obs encodes (add index, env row)."""
    x = dict(
        obs=np.stack([np.full(rows, t), np.arange(rows)], axis=1).astype(np.float32),
        action=rng.integers(0, 4, rows).astype(np.int32),
        reward=rng.standard_normal(rows).astype(np.float32),
        next_obs=rng.standard_normal((rows, D)).astype(np.float32),
        terminated=rng.random(rows) < 0.2,
        truncated=rng.random(rows) < 0.1,
    )
    return (JaxTransition(**{k: jnp.asarray(v) for k, v in x.items()}),
            Transition(**{k: torch.tensor(v) for k, v in x.items()}))


def _filled_pair(adds, n_step, members=None, rows=N, capacity=C, seed=0):
    rng = np.random.default_rng(seed)
    jr = JaxUniform(rows, capacity, gamma=0.97, n_step=n_step)
    tr = UniformReplay(rows // (members or 1), capacity, gamma=0.97, n_step=n_step,
                       members=members)
    tj, tt = _transition(rng, -1, rows)
    js, ts = jr.init(tj), tr.init(tt)
    for t in range(adds):
        tj, tt = _transition(rng, t, rows)
        js, ts = jr.add(js, tj), tr.add(ts, tt)
    assert (int(ts.device_cursor), int(ts.device_adds)) == (ts.cursor, ts.total_adds)
    assert (ts.cursor, ts.total_adds) == (int(js.cursor), int(js.total_adds))
    return jr, js, tr, ts


@pytest.mark.parametrize("n_step", [1, 3, 5])
@pytest.mark.parametrize("adds", ["partly", C, C + 1, 2 * C + 3])
@pytest.mark.parametrize("members", [None, 3])
def test_sample_with_injected_uniforms_stays_in_jaxs_valid_window(n_step, adds, members):
    adds = n_step + 1 if adds == "partly" else adds
    m = members or 1
    jr, js, tr, ts = _filled_pair(adds, n_step, members, rows=N * m)
    rng = np.random.default_rng(adds * 10 + n_step)
    b = 64
    shape = (b,) if members is None else (m, b)
    u_env = rng.random(shape).astype(np.float32)
    u_slot = rng.random(shape)
    u_env.flat[:2], u_slot.flat[:2] = [0.0, np.float32(1) - np.float32(2**-24)], [0.0, 1 - 2**-53]
    batch, info, w = tr.sample_with_info(
        ts, None, b, gamma=None if members is None else torch.full((m,), 0.97),
        uniforms=(torch.tensor(u_env), torch.tensor(u_slot)))
    assert info is None and torch.equal(w, torch.ones(shape))
    filled = min(adds, C)
    want_env = np.minimum(np.floor(u_env * np.float32(N)).astype(np.int64), N - 1)
    r = max(filled - (n_step - 1), 1)
    want_slot = (ts.cursor - filled + np.minimum(np.floor(u_slot * r).astype(np.int64), r - 1)) % C
    obs = batch.obs.numpy().reshape(-1, D)
    rows = (want_env + (np.arange(m)[:, None] * N if members else 0)).reshape(-1)
    np.testing.assert_array_equal(obs[:, 1], rows)
    # the add index that wrote each sampled slot
    np.testing.assert_array_equal(obs[:, 0].astype(np.int64) % C, want_slot.reshape(-1))
    valid = np.asarray(jax_valid_mask(C, jnp.int32(ts.cursor), jnp.int32(filled), n_step))
    assert valid[want_slot].all()
    bj = jax_assemble(js.storage, jnp.asarray(rows), jnp.asarray(want_slot.reshape(-1)), 0.97,
                      n_step, True)
    for name in ("obs", "action", "next_obs"):
        np.testing.assert_array_equal(getattr(batch, name).numpy().reshape(
            np.asarray(getattr(bj, name)).shape), np.asarray(getattr(bj, name)))
    # a member's discount is a float32 tensor, and its powers round apart
    # from those of the Python float: test_torch_population.py's tolerance
    tol = dict(rtol=1.2e-7, atol=0) if members is None else dict(rtol=1e-6, atol=1e-7)
    for name in ("reward", "bootstrap"):
        np.testing.assert_allclose(getattr(batch, name).numpy().reshape(-1),
                                   np.asarray(getattr(bj, name)), **tol)


def test_env_and_rank_histograms_pass_chi_square_on_both_sides():
    """2^20 draws from a ring of 7 envs and 37 slots, 45 adds (past the
    wrap), n-step 3: 35 ranks.  JAX's ``sample_with_info`` and the port's,
    each from a fixed seed, the indices read back from the sampled obs."""
    rows, capacity, adds, n_step, b = 7, 37, 45, 3, 1 << 20
    jr, js, tr, ts = _filled_pair(adds, n_step, rows=rows, capacity=capacity)
    oldest = adds - capacity  # the add index of age rank 0
    ranks = capacity - (n_step - 1)
    batch_j, _, _ = jr.sample_with_info(js, jax.random.PRNGKey(0), b)
    batch_t, _, _ = tr.sample_with_info(ts, torch.Generator().manual_seed(0), b)
    for side, obs in (("jax", np.asarray(batch_j.obs)), ("port", batch_t.obs.numpy())):
        env, rank = obs[:, 1].astype(np.int64), obs[:, 0].astype(np.int64) - oldest
        assert rank.min() >= 0 and rank.max() < ranks, side
        for name, values, k in (("env", env, rows), ("rank", rank, ranks)):
            p = stats.chisquare(np.bincount(values, minlength=k)).pvalue
            assert p > 1e-4, (side, name, p)


def _rank_shares(r: int, grid: str) -> np.ndarray:
    """``P(rank) · R - 1`` for each rank of ``min(⌊u·R⌋, R-1)``, counted
    exactly over every value ``u`` can take: the CPU generator's float64
    grid ``k·2^-53`` and float32 grid ``k·2^-24``, and the card's float64
    grid (curand's ``(2z + 1)·2^-54`` rounded to a double, z on [0, 2^53),
    its top value 1.0 read as 0 by PyTorch).  The map is monotone in k, so
    each rank's values are one run of k, found by bisection."""
    points = 2**24 if grid == "cpu32" else 2**53

    def rank_of(k):
        if grid == "cpu32":
            u = k.astype(np.float32) * np.float32(2.0**-24)
            scaled = u * np.float32(r)
        else:
            u = (k.astype(np.float64) * 2.0**-53 if grid == "cpu64"
                 else (2 * k + 1).astype(np.float64) * 2.0**-54)
            scaled = u * np.float64(r)
        return np.minimum(np.floor(scaled).astype(np.int64), r - 1)

    top = points - 1 if grid == "cuda64" else points  # cuda: the last k is read as 0
    target = np.arange(r + 1, dtype=np.int64)
    lo, hi = np.zeros(r + 1, np.int64), np.full(r + 1, top, np.int64)
    for _ in range(60):  # the first k whose rank is >= target, or top
        mid = (lo + hi) // 2
        up = rank_of(mid) >= target
        hi, lo = np.where(up, mid, hi), np.where(up, lo, mid + 1)
    lo[0], lo[r] = 0, top
    counts = np.diff(lo).astype(np.float64)
    if grid == "cuda64":
        counts[0] += 1
    assert counts.sum() == points
    return counts * r / points - 1


@pytest.mark.parametrize("n_step", [1, 3, 5])
def test_every_rank_within_a_thousandth_of_uniform_at_100k_slots(n_step):
    assert config.lunar_ref_parity().buffer_capacity // config.lunar_ref_parity().num_envs == (
        100_000)
    assert max(cfg.buffer_capacity // cfg.num_envs for cfg in (
        p() for p in config.PRESETS.values())) == 100_000
    r = 100_000 - (n_step - 1)
    for grid in ("cpu64", "cuda64"):
        assert np.abs(_rank_shares(r, grid)).max() < 1.6e-11, grid
    # the reason for float64: a float32 uniform gives some ranks 0.46 % too few
    assert np.abs(_rank_shares(r, "cpu32")).max() > 4e-3


def test_cpu_float64_uniforms_lie_on_the_counted_grid():
    u = torch.rand(1 << 16, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    k = u.numpy() * 2.0**53
    assert (k == np.floor(k)).all() and (k < 2**53).all()


# ------------------------------------------------------ the graphed learners


def _trainer(preset, graphed, seed=3, workdir=None):
    cfg = dataclasses.replace(config.PRESETS[preset](), **PRESETS[preset])
    return Trainer(cfg, device="cpu", graphed=graphed, workdir=workdir).init(seed=seed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for preset in PRESETS:
        pair = {}
        for graphed in (True, False):
            root = tmp_path_factory.mktemp(f"{preset}_{graphed}")
            tr = _trainer(preset, graphed, workdir=str(root))
            pair[graphed] = tr, [tr.step() for _ in range(SUPERSTEPS)]
        out[preset] = pair
    return out


@pytest.mark.parametrize("preset", list(PRESETS))
def test_graphed_uniform_learner_equals_eager_bitwise(runs, preset):
    (g, g_metrics), (e, e_metrics) = runs[preset][True], runs[preset][False]
    cfg = g.cfg
    assert cfg.replay == "uniform"
    assert isinstance(g._superstep, GraphedLearner) and g.venv.graphed
    assert not isinstance(e._superstep, GraphedLearner) and not e.venv.graphed
    assert g_metrics == e_metrics
    frames = SUPERSTEPS * cfg.steps_per_superstep
    first = cfg.training_start // cfg.num_envs  # the first frame that trains
    assert sum(m.loss_count for m in g_metrics) == (frames - first + 1) * cfg.updates_per_step
    assert g_metrics[-1].episodes > 0
    r = g.runner
    assert (r.replay.cursor, r.replay.total_adds) == (frames % 16, frames)
    assert (int(r.replay.device_cursor), int(r.replay.device_adds)) == (frames % 16, frames)
    assert r.train.updates == r.train.opt_state.count == int(r.train.opt_state.device_count)
    # every tensor of the runner, the counters read back from the device
    _same(ckpt._to_tree(g.runner), ckpt._to_tree(e.runner))


def test_graphed_uniform_learner_resumes_bitwise(runs):
    g, _ = runs["mountain_car_vector"][True]
    g.save(step=g.runner.env_step * g.cfg.num_envs)
    resumed = Trainer(g.cfg, device="cpu", workdir=g.workdir).restore()
    assert isinstance(resumed._superstep, GraphedLearner)
    r = resumed.runner
    assert int(r.replay.device_cursor) == r.replay.cursor == g.runner.replay.cursor
    assert int(r.replay.device_adds) == r.replay.total_adds == g.runner.replay.total_adds
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))
    assert [resumed.step() for _ in range(2)] == [g.step() for _ in range(2)]
    _same(ckpt._to_tree(resumed.runner), ckpt._to_tree(g.runner))


def test_checkpoint_refuses_a_uniform_counter_off_its_mirror(runs, tmp_path):
    e, _ = runs["cartpole_vector"][False]
    r = e.runner
    for name in ("device_adds", "device_cursor"):
        getattr(r.replay, name).add_(1)
        try:
            with pytest.raises(RuntimeError, match=name):
                ckpt.save_checkpoint(str(tmp_path), r, 1)
        finally:
            getattr(r.replay, name).sub_(1)


def test_graphed_uniform_population_with_mixed_gates_equals_eager_bitwise():
    cfg = dataclasses.replace(config.cartpole_vector(), **PRESETS["cartpole_vector"])
    members, out = 3, {}
    for graphed in (True, False):
        init, step, _ = build_population(cfg, members, device="cpu", graphed_learner=graphed)
        assert isinstance(step, GraphedPopulation) == graphed
        runner = set_population_hyper(init(5), train_every=[1, 2, 3],
                                      training_start=[32, 32, 80], target_sync_every=[4, 5, 6])
        out[graphed] = runner, [step(runner)[1] for _ in range(SUPERSTEPS)]
    (g, g_metrics), (e, e_metrics) = out[True], out[False]
    for a, b in zip(g_metrics, e_metrics):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
    counts = sum(m.loss_count for m in g_metrics).tolist()
    assert len(set(counts)) == members and min(counts) > 0  # the gates differ
    assert g.train.opt_state.device_count.tolist() == g.train.opt_state.count == counts
    assert int(g.replay.device_adds) == g.replay.total_adds == SUPERSTEPS * cfg.steps_per_superstep
    _same(ckpt._to_tree(g), ckpt._to_tree(e))
