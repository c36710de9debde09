"""The port's host-compatibility path (``compat/``, ``native/``) against the
JAX package's.

Tolerances:
  * the native ring buffer: bitwise (the same C++ source, the same
    ``std::mt19937_64`` stream from one seed, the same adds);
  * ``HostAgent`` with ε pinned at 1 (both agents draw their actions from
    the same ``random.Random`` stream, and start from the same flax
    parameters): actions, rewards, episode lengths, global steps, buffer
    contents and target-sync episodes exact; each update's loss rtol 1e-4
    (float32 networks and Adam in two libraries); the final parameters
    atol a tenth of the learning rate, as the population test holds Adam's
    steps (an update of lr·m/(sqrt(v)+1e-8) moves a weight whose gradient
    is ~1e-8 by up to lr on rounding alone);
  * the bookkeeping (ε, windows, stops, done flags) with the learner off:
    exact, since it is the same Python arithmetic on the same episodes;
  * host envs: gymnasium obs streams through either package's
    ``TimeFractionHostWrapper`` bitwise; one ``TorchHostEnv`` step from a
    state carried over from ``JaxHostEnv``: the rigid lander at obs atol
    1e-5 and reward atol 1e-4 (``tests/test_torch_envs_lunar.py`` gives
    the reasons) and its terminal steps' obs at 1e-4 (a crash's contact
    solve amplifies float32 rounding: 1.1e-5 in ω on one crash here, where
    JAX's float32 step is 0.03 from its float64 evaluation), CartPole at
    1e-6, flags exact."""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.compat import host_env as jax_host_env
from deep_q_learning_tpu.compat import host_loop as jax_host_loop
from deep_q_learning_tpu.config import DQNConfig as JaxConfig
from deep_q_learning_tpu.envs.cartpole import CartPole as JaxCartPole
from deep_q_learning_tpu.envs.lunar_lander import LunarLander as JaxLander
from deep_q_learning_tpu_torch import native
from deep_q_learning_tpu_torch.algos.dqn import init_train_state
from deep_q_learning_tpu_torch.compat import host_env, host_loop
from deep_q_learning_tpu_torch.compat.host_env import TorchHostEnv, make_host_env
from deep_q_learning_tpu_torch.compat.host_loop import HostAgent
from deep_q_learning_tpu_torch.config import DQNConfig
from deep_q_learning_tpu_torch.envs import CartPole, LunarLander
from deep_q_learning_tpu_torch.envs.cartpole import CartPoleState
from deep_q_learning_tpu_torch.envs.lunar_lander import state_from_numpy
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.ops import td_kernels

REPO = native.PACKAGE_DIR.parent


def _has_gxx():
    import shutil

    return shutil.which("g++") is not None


needs_gxx = pytest.mark.skipif(not _has_gxx(), reason="no C++ compiler")


@pytest.fixture(scope="module", autouse=True)
def jax_buffer_library(tmp_path_factory):
    """The JAX package's buffer compiled from its own source into a
    temporary directory, with its loader's flags, and loaded by its own
    loader: nothing here writes into ``deep_q_learning_tpu/native/``, whose
    loader would otherwise rebuild its committed library in place."""
    if not _has_gxx():
        yield
        return
    import subprocess

    from deep_q_learning_tpu import native as jax_native

    lib = tmp_path_factory.mktemp("jax_native") / "libreplay.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", jax_native._SRC, "-o",
                    str(lib)], check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_build_library", lambda: str(lib))
        mp.setattr(jax_native, "_lib", None)
        yield


# ---------------------------------------------------------------------------
# the native ring buffer
# ---------------------------------------------------------------------------

def _fill(buffers, rng, capacity, obs_dim):
    """The same single and batch adds into every buffer, past a wrap."""
    for t in range(capacity + 3):
        row = (rng.standard_normal(obs_dim).astype(np.float32), int(rng.integers(0, 4)),
               float(rng.standard_normal()), rng.standard_normal(obs_dim).astype(np.float32),
               bool(rng.random() < 0.2))
        for b in buffers:
            b.add(*row)
    n = capacity // 2 + 1
    batch = (rng.standard_normal((n, obs_dim)).astype(np.float32),
             rng.integers(0, 4, n).astype(np.int32), rng.standard_normal(n).astype(np.float32),
             rng.standard_normal((n, obs_dim)).astype(np.float32),
             (rng.random(n) < 0.2).astype(np.uint8))
    for b in buffers:
        b.add_batch(*batch)


@needs_gxx
@pytest.mark.parametrize("capacity,obs_dim,seed", [(8, 3, 0), (37, 9, 5), (1000, 5, 123)])
def test_buffer_samples_bitwise_the_jax_buffer(capacity, obs_dim, seed):
    from deep_q_learning_tpu.native import HostReplayBuffer as JaxBuffer

    port = native.HostReplayBuffer(capacity, obs_dim, seed=seed)
    ref = JaxBuffer(capacity, obs_dim, seed=seed)
    assert port.size == ref.size == 0 and port.capacity == capacity
    # before any add both draw from the zeroed storage
    for x, y in zip(port.sample(4), ref.sample(4)):
        np.testing.assert_array_equal(x, y)
    _fill([port, ref], np.random.default_rng(seed), capacity, obs_dim)
    assert port.size == ref.size == capacity
    for batch in (1, 64, 257, 64):
        got, want = port.sample(batch), ref.sample(batch)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@needs_gxx
def test_buffer_refuses_rows_of_the_wrong_width():
    b = native.HostReplayBuffer(4, 3)
    with pytest.raises(ValueError, match="obs"):
        b.add(np.zeros(2, np.float32), 0, 0.0, np.zeros(3, np.float32), False)
    with pytest.raises(ValueError, match="action"):
        b.add_batch(np.zeros((2, 3)), np.zeros(3), np.zeros(2), np.zeros((2, 3)), np.zeros(2))
    assert b.size == 0
    b.close()
    b.close()  # idempotent


@needs_gxx
def test_buffer_builds_under_build_only(tmp_path, monkeypatch):
    """The library lands under ``build/torch_native/`` (a fresh build under
    a stand-in directory here), never beside the JAX package's source and
    library."""
    assert native.BUILD_DIR == REPO / "build" / "torch_native"
    native.HostReplayBuffer(4, 2).add(np.zeros(2), 1, 1.0, np.zeros(2), True)
    assert native.load_library()._name.startswith(str(native.BUILD_DIR))

    jax_lib = REPO / "deep_q_learning_tpu" / "native" / "libreplay.so"
    before = {p.name: p.stat().st_mtime_ns for p in jax_lib.parent.iterdir()}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    built = native.build_library()
    assert built.parent == tmp_path / "torch_native" and built.suffix == ".so"
    assert native.build_library() == built  # cached by the hash
    after = {p.name: p.stat().st_mtime_ns for p in jax_lib.parent.iterdir()}
    assert after == before


def test_loader_names_gxx_when_absent(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.find_cxx()


# ---------------------------------------------------------------------------
# HostAgent against the JAX HostAgent
# ---------------------------------------------------------------------------

class TinyCorridorEnv:
    """5-state corridor, classic 4-tuple Gym protocol; reward 1 at the end
    (``tests/test_native_compat.py``).  ``log`` records every step."""

    def __init__(self):
        self.pos = 0
        self.log = []

    def reset(self):
        self.pos = 2
        return self._obs()

    def _obs(self):
        o = np.zeros(5, np.float32)
        o[self.pos] = 1.0
        return o

    def step(self, action):
        self.pos += 1 if action == 1 else -1
        self.pos = int(np.clip(self.pos, 0, 4))
        done = self.pos in (0, 4)
        reward = 1.0 if self.pos == 4 else (-1.0 if self.pos == 0 else -0.01)
        self.log.append((int(action), reward, done))
        return self._obs(), reward, done, {}


CORRIDOR = dict(
    num_envs=1, batch_size=32, buffer_capacity=4096, training_start=64,
    double=True, dueling=False, hidden=(32,), learning_rate=3e-3,
    optimizer="adam", gamma=0.9, eps_schedule="exp_episode",
    eps_start=1.0, eps_decay=0.95, eps_min=0.01, train_every=2,
    target_replace_episodes=10, max_steps_in_episode=20,
    return_window=20, solve_threshold=0.5, seed=0,
)


def _agents(monkeypatch, **overrides):
    """A JAX and a port ``HostAgent`` on their own corridors, the port's
    learner carried over from the JAX one's initial parameters; each
    records its updates' losses, its target syncs and its buffer adds."""
    kw = dict(CORRIDOR, **overrides)
    ref = jax_host_loop.HostAgent(TinyCorridorEnv(), 5, 2, JaxConfig(**kw))
    port = HostAgent(TinyCorridorEnv(), 5, 2, DQNConfig(**kw), device="cpu")
    params = jax.tree.map(np.asarray, ref.train_state.params)
    port.train_state = init_train_state(
        QNetwork.from_flax_params(params), port.optimizer)
    for module, agent in ((jax_host_loop, ref), (host_loop, port)):
        agent.losses, agent.syncs, agent.adds, agent.records = [], [], [], []

        def train_step(step=agent._train_step, agent=agent):
            agent.losses.append(step())
            return agent.losses[-1]

        def add(obs, action, reward, next_obs, done, add=agent.buffer.add, agent=agent):
            agent.adds.append((obs.tolist(), action, reward, next_obs.tolist(), done))
            add(obs, action, reward, next_obs, done)

        agent._train_step = train_step
        agent.buffer.add = add
    for module, agent in ((jax_host_loop, ref), (host_loop, port)):
        sync = module.sync_target

        def recording_sync(ts, sync=sync, agent=agent):
            agent.syncs.append(agent.episodes)
            return sync(ts)

        # each module's agent calls its own module's sync_target
        monkeypatch.setattr(module, "sync_target", recording_sync)
    return ref, port


def _train(agent, **kw):
    def on_episode(*record):
        agent.records.append(record)

    return agent.training(verbose=False, on_episode=on_episode, **kw)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_host_agent_matches_jax_with_epsilon_pinned(use_pallas, monkeypatch):
    ref, port = _agents(monkeypatch, eps_start=1.0, eps_min=1.0, solve_threshold=None,
                        target_replace_episodes=4, max_steps_in_episode=6,
                        training_start=48, use_pallas=use_pallas)
    td_kernels.reset_counts()
    assert _train(ref, max_episodes=40) == _train(port, max_episodes=40) == (False, 40)
    assert port.env.log == ref.env.log and port.records == ref.records
    assert port.adds == ref.adds and port.buffer.size == ref.buffer.size == len(port.adds)
    assert port.syncs == ref.syncs == list(range(4, 41, 4))
    assert port._global_steps == ref._global_steps == len(port.env.log)
    assert len(port.losses) == len(ref.losses) > 20
    np.testing.assert_allclose(port.losses, ref.losses, rtol=1e-4)
    # the fused path ran the kernels' plain versions, once an update
    expected = len(port.losses) if use_pallas else 0
    assert td_kernels.plain_calls == {"td_loss_fwd": expected, "td_loss_bwd": expected}
    ref_params = jax.tree.map(np.asarray, ref.train_state.params)["params"]
    for name, layer in port.train_state.online.flax_layers():
        np.testing.assert_allclose(layer.weight.detach().numpy(), ref_params[name]["kernel"].T,
                                   atol=CORRIDOR["learning_rate"] / 10, rtol=0)
        np.testing.assert_allclose(layer.bias.detach().numpy(), ref_params[name]["bias"],
                                   atol=CORRIDOR["learning_rate"] / 10, rtol=0)
    # the buffers hold the same transitions in the same slots
    for x, y in zip(port.buffer.sample(512), ref.buffer.sample(512)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("truncation_bootstrap", [True, False])
@pytest.mark.parametrize("stop", ["solve", "max_total_steps"])
def test_host_agent_bookkeeping_matches_jax(stop, truncation_bootstrap, monkeypatch):
    """ε decay with its floor, the return window, the solve stop, the
    env-step budget, forced truncation and the done flag it stores: the
    learner is off (``training_start`` above the budget), so the greedy
    actions come from the same initial parameters."""
    kw = dict(eps_start=1.0, eps_decay=0.8, eps_min=0.3, training_start=10**6,
              max_steps_in_episode=5, return_window=4,
              truncation_bootstrap=truncation_bootstrap)
    if stop == "solve":
        kw.update(solve_threshold=0.45)
        run = dict(max_episodes=200)
    else:
        kw.update(solve_threshold=None)
        run = dict(max_episodes=200, max_total_steps=57)
    ref, port = _agents(monkeypatch, **kw)
    result = _train(port, **run)
    assert result == _train(ref, **run) and result[1] < 200
    assert port.records == ref.records and port.adds == ref.adds
    eps = [r[-1] for r in port.records]
    assert eps[0] == pytest.approx(0.8) and min(eps) == 0.3  # decayed to the floor
    if stop == "max_total_steps":
        assert port._global_steps >= 57 > port._global_steps - port.records[-1][2]
    else:
        assert port.records[-1][4] >= 0.45
    # episodes end at a terminal state or at the forced truncation (5 steps)
    ends = [a[4] for a in port.adds]
    lengths = [r[2] for r in port.records]
    last = np.cumsum(lengths) - 1
    truncated = [not port.env.log[i][2] for i in last]  # the env did not end it
    assert any(truncated) and not all(truncated)
    assert all(lengths[k] == 5 for k, t in enumerate(truncated) if t)
    assert [ends[i] for i in last] == [not (t and truncation_bootstrap) for t in truncated]
    assert sum(ends) == sum(ends[i] for i in last)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_host_agent_graphed_update_equals_eager(use_pallas):
    """The agent's update through its in-place step (``graphed=True``: one
    CUDA graph replay on the card, a direct call on the CPU, on the static
    batch buffers) against the eager update, from one seed: every loss and
    action, the learner (weights, target, Adam moments and count) and the
    host counters bitwise over at least 50 updates."""
    cfg = DQNConfig(**dict(CORRIDOR, use_pallas=use_pallas, target_replace_episodes=3,
                           solve_threshold=None))
    agents = [HostAgent(TinyCorridorEnv(), 5, 2, cfg, device="cpu", graphed=g)
              for g in (True, False)]
    for agent in agents:
        agent.losses = []

        def train_step(step=agent._train_step, agent=agent):
            agent.losses.append(step())
            return agent.losses[-1]

        agent._train_step = train_step
        agent.training(max_episodes=40, verbose=False)
    graphed, eager = agents
    assert len(graphed.losses) >= 50 and graphed.losses == eager.losses
    assert graphed.env.log == eager.env.log
    ts_g, ts_e = graphed.train_state, eager.train_state
    assert ts_g.updates == ts_e.updates == ts_g.opt_state.count == int(ts_g.opt_state.device_count)
    for x, y in zip([*ts_g.online.parameters(), *ts_g.target.parameters(), *ts_g.opt_state.mu,
                     *ts_g.opt_state.nu],
                    [*ts_e.online.parameters(), *ts_e.target.parameters(), *ts_e.opt_state.mu,
                     *ts_e.opt_state.nu]):
        assert torch.equal(x, y)


def test_host_agent_solves_corridor():
    """The counterpart of ``tests/test_native_compat.py``'s solve, on the port."""
    agent = HostAgent(TinyCorridorEnv(), obs_dim=5, num_actions=2, cfg=DQNConfig(**CORRIDOR),
                      device="cpu")
    solved, episodes = agent.training(max_episodes=300, verbose=False)
    assert solved, f"corridor not solved in {episodes} episodes"
    assert min(agent.evaluate(5)) > 0.9  # greedy walks straight to the goal


def test_host_agent_refuses_n_step():
    with pytest.raises(ValueError, match="HostAgent implements 1-step TD only"):
        HostAgent(TinyCorridorEnv(), 5, 2, DQNConfig(**dict(CORRIDOR, n_step=3)), device="cpu")


def test_host_agent_greedy_takes_the_first_maximum():
    agent = HostAgent(TinyCorridorEnv(), 5, 2, DQNConfig(**CORRIDOR), device="cpu")
    with torch.no_grad():
        for p in agent.train_state.online.parameters():
            p.zero_()
    assert agent._greedy(np.ones(5, np.float32)) == 0


# ---------------------------------------------------------------------------
# host envs
# ---------------------------------------------------------------------------

def _gym_lander():
    gym = pytest.importorskip("gymnasium")
    pytest.importorskip("Box2D")
    return gym.make("LunarLander-v3").unwrapped


def test_time_fraction_wrapper_matches_jax_on_gymnasium():
    port = host_env.TimeFractionHostWrapper(_gym_lander(), 1500)
    ref = jax_host_env.TimeFractionHostWrapper(_gym_lander(), 1500)
    a, b = port.reset(seed=3), ref.reset(seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0][-1] == 0.0 and a[0].shape == (9,)
    rng = random.Random(3)
    for t in range(1, 61):
        action = rng.randrange(4)
        x, y = port.step(action), ref.step(action)
        np.testing.assert_array_equal(x[0], y[0])
        assert x[0][-1] == np.float32(t / 1500) and x[1:4] == y[1:4]
        if x[2] or x[3]:
            break


def test_make_host_env_box2d_matches_jax():
    _gym_lander()
    port, port_dim, port_actions = make_host_env("box2d", seed=7)
    ref, ref_dim, ref_actions = jax_host_env.make_host_env("box2d", seed=7)
    assert (port_dim, port_actions) == (ref_dim, ref_actions) == (9, 4)
    np.testing.assert_array_equal(port.reset()[0], ref.reset()[0])


def test_make_host_env_torch_builds_the_registry_env():
    env, obs_dim, num_actions = make_host_env("torch", "CartPole-v1", max_steps=200,
                                              device="cpu")
    assert (obs_dim, num_actions) == (5, 2)
    assert env.env.params.max_steps_in_episode == 200
    obs, info = env.reset()
    assert obs.shape == (5,) and obs.dtype == np.float32 and obs[-1] == 0.0 and info == {}
    lander, dim, actions = make_host_env("torch", time_fraction=False, device="cpu")
    assert (dim, actions) == (8, 4) and lander.params.jointed  # the registry's default
    assert lander.params.max_steps_in_episode == 1500


@pytest.mark.parametrize("engine,match", [("jax", "'torch'"), ("mujoco", "'box2d' or 'torch'")])
def test_make_host_env_refuses_other_engines(engine, match):
    with pytest.raises(ValueError, match=match):
        make_host_env(engine, device="cpu")


def test_torch_host_env_refuses_an_action_outside_the_space():
    env = TorchHostEnv(CartPole(), device="cpu")
    env.reset()
    with pytest.raises(ValueError, match="outside"):
        env.step(2)


def _jax_lander_draws(key):
    """The dispersion draw the JAX lander's step takes from its key."""
    return np.asarray(jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0))


@pytest.mark.parametrize("env_name", ["lander_rigid", "cartpole"])
def test_torch_host_env_step_matches_jax_host_env(env_name):
    """Along a JAX host rollout, each state is carried over to the port's
    host env and stepped once by both with the same action (and the same
    dispersion draw)."""
    if env_name == "lander_rigid":
        jax_env, port_env = JaxLander(), LunarLander()
        jax_params = jax_env.default_params().replace(jointed=False)
        port_params = dataclasses.replace(port_env.default_params(), jointed=False)
        to_port = state_from_numpy
        obs_atol, rew_atol, steps = 1e-5, 1e-4, 120
    else:
        jax_env, port_env = JaxCartPole(), CartPole()
        jax_params, port_params = jax_env.default_params(), port_env.default_params()

        def to_port(s):
            return CartPoleState(**{f.name: torch.tensor(np.asarray(getattr(s, f.name)).reshape(1))
                                    for f in dataclasses.fields(CartPoleState)})

        obs_atol, rew_atol, steps = 1e-6, 1e-6, 60
    ref = jax_host_env.JaxHostEnv(jax_env, jax_params, seed=4)
    port = TorchHostEnv(port_env, port_params, seed=4, device="cpu")
    ref.reset()
    port.reset()
    rng = random.Random(4)
    ends = 0
    for _ in range(steps):
        action = rng.randrange(port.num_actions)
        port.state = to_port(jax.tree.map(np.asarray, ref._state))
        draws = None
        if env_name == "lander_rigid":
            _, k = jax.random.split(ref._key)
            draws = torch.tensor(_jax_lander_draws(k))[None]
        got = port.step(action, draws=draws)
        want = ref.step(action)
        assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
        # a crash (the hull's contact solve) amplifies float32 rounding: in
        # this rollout the lander's crash step differs by 1.1e-5 in ω, where
        # JAX's own float32 step is 0.03 from its float64 evaluation
        atol = obs_atol if not (env_name == "lander_rigid" and want[2]) else 1e-4
        np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0)
        assert abs(got[1] - want[1]) <= rew_atol
        assert got[2:] == want[2:]
        if want[2] or want[3]:
            ends += 1
            ref.reset()
    assert ends > 0
