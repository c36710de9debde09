"""The port's ``utils/metrics.py`` and ``utils/visualize.py``: the
counterparts of ``tests/test_utils.py``, and the recorded trajectory held
to the JAX package's format.

The ``.npz`` of a lander rollout has the JAX ``record_trajectory``'s keys
and dtypes; replaying the recorded actions from a generator with the same
seed gives the recorded observations and rewards exactly (the greedy
action takes no draw).  Figures skip where matplotlib (or pillow, for a
``.gif``) is absent.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs import LunarLander as JaxLunarLander
from deep_q_learning_tpu.models import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.utils.visualize import lander_pose_extras as jax_pose_extras
from deep_q_learning_tpu.utils.visualize import lander_static as jax_static
from deep_q_learning_tpu.utils.visualize import record_trajectory as jax_record
from deep_q_learning_tpu_torch.envs import make_env
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.utils.metrics import (
    MetricLogger,
    plot_history,
    start_profiler_trace,
    stop_profiler_trace,
    stopwatch,
    trace,
)
from deep_q_learning_tpu_torch.utils.visualize import (
    dump_trajectory,
    lander_pose_extras,
    lander_static,
    plot_lander_flight,
    record_trajectory,
    render_lander_animation,
)


def test_metric_logger_jsonl(tmp_path):
    path = os.path.join(str(tmp_path), "log", "metrics.jsonl")
    ml = MetricLogger(path)
    ml.log({"step": 1, "x": 2.0})
    ml.log({"step": 2, "x": 3.0})
    ml.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines == [{"step": 1, "x": 2.0}, {"step": 2, "x": 3.0}] == ml.records


def test_plot_history(tmp_path):
    pytest.importorskip("matplotlib")
    hist = [{"env_steps": i * 100, "window_mean": float(i), "loss": 1.0 / (i + 1)}
            for i in range(10)]
    p = plot_history(hist, os.path.join(str(tmp_path), "c.png"))
    assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_stopwatch():
    out = []
    with stopwatch("phase", sink=out.append):
        pass
    assert len(out) == 1 and out[0].startswith("phase:")


def test_trace_spans_reach_the_profiler_trace(tmp_path):
    prof = start_profiler_trace(str(tmp_path))
    with trace("my_phase"):
        torch.ones(4).sum()
    stop_profiler_trace(prof)
    assert "my_phase" in {e.key for e in prof.key_averages()}
    (trace_file,) = tmp_path.iterdir()
    assert "my_phase" in trace_file.read_text()


def _lander(jointed: bool):
    return make_env("LunarLander-v2", param_overrides={"jointed": jointed, "vel_iters": 8,
                                                      "pos_iters": 4})


def _policy(seed=0):
    net = QNetwork(8, 4, hidden=(16,), dueling=False,
                   generator=torch.Generator().manual_seed(seed))
    return net


def _record(env, params, seed, max_steps):
    return record_trajectory(env, params, _policy(), torch.Generator().manual_seed(seed),
                             max_steps=max_steps, extras_fn=lander_pose_extras,
                             static_fn=lander_static)


def test_lander_trajectory_has_the_jax_keys_and_dtypes(tmp_path):
    env, params = _lander(jointed=False)
    ours = _record(env, params, seed=1, max_steps=60)
    jenv = JaxLunarLander()
    jp = jenv.default_params().replace(jointed=False)
    jnet = FlaxQNetwork(num_actions=4, hidden=(16,), dueling=False)
    jparams = jnet.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.float32))
    theirs = jax_record(jenv, jp, jnet, jparams, jax.random.PRNGKey(1), max_steps=60,
                        extras_fn=jax_pose_extras, static_fn=jax_static)
    loaded = dict(np.load(dump_trajectory(str(tmp_path / "ours.npz"), ours)))
    wanted = dict(np.load(dump_trajectory(str(tmp_path / "theirs.npz"), theirs)))
    assert set(loaded) == set(wanted)
    for k in wanted:
        assert loaded[k].dtype == wanted[k].dtype, k
        assert loaded[k].shape[1:] == wanted[k].shape[1:], k
    assert 1 <= ours["length"] <= 60 and ours["obs"].shape == (ours["length"], 8)
    np.testing.assert_allclose(ours["ret"], ours["reward"].sum(), rtol=1e-5)
    np.testing.assert_array_equal(loaded["obs"], ours["obs"])


@pytest.mark.parametrize("jointed", [False, True], ids=["rigid", "jointed"])
def test_replaying_the_actions_gives_the_recorded_rewards(jointed):
    env, params = _lander(jointed)
    traj = _record(env, params, seed=5, max_steps=40)
    assert ("extra_leg1_x" in traj) == jointed
    generator = torch.Generator().manual_seed(5)
    obs, state = env.reset_env(generator, 1, params)
    np.testing.assert_array_equal(obs.numpy()[0], traj["obs"][0])
    for t in range(traj["length"]):
        action = torch.tensor([traj["action"][t]], dtype=torch.int32)
        np.testing.assert_array_equal(obs.numpy()[0], traj["obs"][t])
        np.testing.assert_array_equal(state.x.numpy(), traj["extra_x"][t:t + 1])
        obs, state, reward, terminated, truncated = env.step_env(generator, state, action, params)
        assert float(reward[0]) == traj["reward"][t]
        assert bool(terminated[0] | truncated[0]) == traj["done"][t]
    assert traj["done"][-1] or traj["length"] == 40


def test_plot_and_render_lander_flight(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    env, params = _lander(jointed=True)
    traj = _record(env, params, seed=2, max_steps=12)
    png = plot_lander_flight(traj, str(tmp_path / "f.png"))
    gif = render_lander_animation(traj, str(tmp_path / "f.gif"))
    assert os.path.getsize(png) > 1000 and os.path.getsize(gif) > 1000
    with pytest.raises(ValueError, match="pose channels"):
        render_lander_animation({k: v for k, v in traj.items() if not k.startswith("extra")},
                                str(tmp_path / "g.gif"))
