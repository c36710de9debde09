"""The port's gymnasium harness (``deep_q_learning_tpu_torch/envs/
gym_compat.py``) and its examples, against the JAX module and scripts, on
the CPU.  Skips without gymnasium and Box2D, like tests/test_gym_parity.py.

* Injection: the port's injected state equals JAX's ``_inject_state_from_gym``
  field by field, exactly (float32 of the same Box2D numbers), over seeds
  0-2, wind on and off, both engines.
* One frame from that state, port against the JAX env, at
  tests/test_torch_lander_solver.py's tight tolerances (positions and angles
  atol 1e-5, velocities 1e-4, accumulators 1e-5 + rtol 1e-4; flags exact):
  the states are airborne, so no contact iteration carries the rounding.
  Observations atol 1e-5, rewards and shaping atol 1e-4
  (tests/test_torch_envs_lunar.py).
* Lanes: ``_stepwise_lanes`` over seeds [1, 6] equals two one-lane calls,
  dict for dict (the lanes are independent elementwise computations).
* Classic envs: ``steps_compared`` and ``termination_agrees`` equal JAX's;
  ``max_abs_err`` (each side against gym's float64 dynamics) within
  tests/test_torch_envs_classic.py's tolerances of JAX's: 1e-6 for CartPole
  and MountainCar, for Acrobot 4x JAX's own float32 error (plus 1e-7).
* Burn seed 1: every gate of ``test_lunar_flight_stepwise_divergence``, and
  terminal and first-contact steps equal the JAX call's.
* Traces: ``gym_traces.json`` equals a fresh recording; replayed through
  ``_RecordedLander`` it gives the live env's dicts.
* The jointed and rigid impact sweeps against Box2D's boundary.
* Examples: the summary JSON equal to the JAX script's, Box2D returns equal
  to the JAX policy-transfer script's within 1e-3, the curve JSONL's keys.
"""

import dataclasses
import json
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("gymnasium")
pytest.importorskip("Box2D")

import gymnasium  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deep_q_learning_tpu.envs import gym_compat as jgc  # noqa: E402
from deep_q_learning_tpu.envs.lunar_lander import LunarLander as JaxLander  # noqa: E402
from deep_q_learning_tpu_torch.envs import gym_compat as tgc  # noqa: E402
from deep_q_learning_tpu_torch.envs.lunar_lander import (  # noqa: E402
    LunarLander,
    state_from_numpy,
)

REPO = Path(__file__).resolve().parents[1]
CASES = [(seed, wind, jointed) for seed in (0, 1, 2) for wind in (False, True)
         for jointed in (True, False)]
POS_TOL, VEL_TOL, ACC_TOL = 1e-5, 1e-4, (1e-5, 1e-4)  # atol; (atol, rtol)
_JAX_STEP = jax.jit(JaxLander().step)


def _fields(state, prefix=""):
    """(name, tensor or None) over a state's fields, nested ones flattened."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None or isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        else:
            yield from _fields(v, prefix + f.name + ".")


def _cases(seed, wind, jointed):
    """A reset gym lander, and the JAX and port params of one case
    (dispersion zeroed on both, as the stepwise comparisons run)."""
    genv, gobs = tgc._gym_lander(gymnasium, seed, True, wind)
    jparams = JaxLander().default_params().replace(
        jointed=jointed, enable_wind=wind, dispersion_scale=0.0)
    params = dataclasses.replace(LunarLander().default_params(), jointed=jointed,
                                 enable_wind=wind, dispersion_scale=0.0)
    return genv, gobs, jparams, params


@pytest.mark.parametrize("seed,wind,jointed", CASES)
def test_injected_state_equals_jax(seed, wind, jointed):
    genv, gobs, jparams, params = _cases(seed, wind, jointed)
    want = state_from_numpy(jax.tree.map(np.asarray, jgc._inject_state_from_gym(
        genv, JaxLander(), jparams)))
    got = tgc._inject_state_from_gym([genv], LunarLander(), params, "cpu")
    for (name, g), (_, w) in zip(_fields(got), _fields(want)):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g, w)
        assert torch.equal(g, w), (name, g, w)
    obs = LunarLander().get_obs(got, params)[0].numpy()
    # gym's observation from its float64 state; the port's from the float32 state
    np.testing.assert_allclose(obs, gobs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,wind,jointed", CASES)
def test_one_frame_from_injected_state_matches_jax(seed, wind, jointed):
    genv, _, jparams, params = _cases(seed, wind, jointed)
    action = (seed + 2) % 4  # burn, side engine, nop
    jstate = jgc._inject_state_from_gym(genv, JaxLander(), jparams)
    jobs, jstate, jr, jterm, jtrunc = jax.tree.map(np.asarray, _JAX_STEP(
        jax.random.PRNGKey(seed), jstate, jnp.int32(action), jparams))
    want = state_from_numpy(jstate)
    env = LunarLander()
    state = tgc._inject_state_from_gym([genv], env, params, "cpu")
    obs, got, r, term, trunc = env.step_env(
        torch.Generator().manual_seed(seed), state, torch.tensor([action], dtype=torch.int32),
        params)
    np.testing.assert_allclose(obs[0].numpy(), jobs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(r[0]), float(jr), atol=1e-4, rtol=0)
    assert (bool(term[0]), bool(trunc[0])) == (bool(jterm), bool(jtrunc))
    for (name, g), (_, w) in zip(_fields(got), _fields(want)):
        if w is None:
            assert g is None, name
        elif w.dtype != torch.float32:
            assert torch.equal(g, w), (name, g, w)
        elif name.startswith("solver_acc."):
            torch.testing.assert_close(g, w, atol=ACC_TOL[0], rtol=ACC_TOL[1])
        elif name.split(".")[-1] in ("vx", "vy", "omega", "w"):
            torch.testing.assert_close(g, w, atol=VEL_TOL, rtol=0)
        elif name == "prev_shaping":
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
        else:
            torch.testing.assert_close(g, w, atol=POS_TOL, rtol=0)


def test_lanes_equal_one_lane_calls():
    lanes = [(1, "burn"), (6, "heuristic")]

    def run(chosen):
        out = []
        for seed, policy in chosen:
            genv, gobs = tgc._gym_lander(gymnasium, seed)
            out.append((genv, gobs, seed, policy))
        return tgc._stepwise_lanes(out, max_steps=20, closed_loop=True, device="cpu")

    together = run(lanes)
    alone = [run([lane])[0] for lane in lanes]
    assert together == alone
    assert [r["steps_compared"] for r in together] == [20, 20]


@pytest.mark.parametrize("seed", range(5))
def test_compare_cartpole_matches_jax(seed):
    got = tgc.compare_cartpole(num_steps=300, seed=seed, device="cpu")
    want = jgc.compare_cartpole(num_steps=300, seed=seed)
    assert got["steps_compared"] == want["steps_compared"], (got, want)
    assert abs(got["max_abs_err"] - want["max_abs_err"]) <= 1e-6, (got, want)


@pytest.mark.parametrize("env_id", ["Acrobot-v1", "MountainCar-v0"])
def test_compare_classic_matches_jax(env_id):
    got = tgc.compare_classic(env_id, device="cpu")
    want = jgc.compare_classic(env_id)
    for key in ("env_id", "seed", "steps_compared", "termination_agrees"):
        assert got[key] == want[key], (key, got, want)
    if env_id == "Acrobot-v1":
        # gym steps Acrobot in float64: JAX's divergence is its own float32 error
        assert got["max_abs_err"] <= 4.0 * want["max_abs_err"] + 1e-7, (got, want)
    else:
        assert abs(got["max_abs_err"] - want["max_abs_err"]) <= 1e-6, (got, want)


@pytest.fixture(scope="module")
def burn_seed1():
    return tgc.compare_lunar_stepwise(policy="burn", seed=1, device="cpu")


def test_lunar_flight_stepwise_divergence(burn_seed1):
    res = burn_seed1
    assert res["init_state_err"] < 1e-5, res  # state injection is exact
    assert res["flight_steps"] >= 40, res
    assert res["flight_max_err"] < 5e-4, res
    # the engine model itself: one full-thrust frame from a matched state
    assert res["obs_err_at"]["1"] < 2e-4, res
    assert res["term_step"]["gym"] == res["term_step"]["torch"], res
    assert res["term_reward"]["gym"] == res["term_reward"]["torch"], res
    want = jgc.compare_lunar_stepwise(policy="burn", seed=1)
    assert res["term_step"]["torch"] == want["term_step"]["jax"], (res, want)
    assert res["first_contact"]["torch"] == want["first_contact"]["jax"], (res, want)


def test_committed_traces_equal_a_fresh_recording():
    with open(tgc.TRACES_PATH) as fh:
        committed = json.load(fh)
    fresh = json.loads(json.dumps(tgc._record_all()))
    assert committed["gymnasium"] == gymnasium.__version__
    assert sorted(committed["traces"]) == sorted(fresh["traces"])
    for name, trace in fresh["traces"].items():
        assert committed["traces"][name] == trace, name
        # the stand-in reads back the pose the injection reads
        assert tgc._gym_pose(tgc._RecordedLander(trace)) == trace["pose"], name
        # and the recorded pose is the reset observation's: gym's shaping from
        # its float64 state against the formula on the float32 observation
        assert abs(tgc._shaping_of(trace["reset_obs"]) - trace["pose"]["prev_shaping"]) < 1e-4


def test_replayed_traces_give_the_live_dicts(burn_seed1):
    traces = tgc._load_traces()
    genv, gobs = tgc._gym_lander(gymnasium, 6)
    recorded = [tgc._RecordedLander(traces[name]) for name in ("burn_s6", "burn_s1")]
    live, replay6, replay1 = tgc._stepwise_lanes(
        [(genv, gobs, 6, "burn")] + [(r, r.reset_obs, r.trace["seed"], "burn") for r in recorded],
        device="cpu")
    assert replay6 == live
    assert replay1 == burn_seed1
    with pytest.raises(RuntimeError, match="the recording took 2"):
        tgc._RecordedLander(traces["burn_s6"]).step(0)


@pytest.mark.parametrize("jointed", [True, False])
def test_lunar_crash_boundary(jointed):
    """A touchdown at <= 1.5 m/s lands and at >= 2.5 m/s crashes on Box2D
    and on the port's lander (the JAX test's protocol and speeds)."""
    from deep_q_learning_tpu_torch.examples.gym_parity_report import (
        impact_sweep_box2d,
        impact_sweep_torch,
    )

    speeds = [1.0, 1.5, 2.5, 3.0]
    want = {"1.0": "LAND", "1.5": "LAND", "2.5": "CRASH", "3.0": "CRASH"}
    if jointed:
        assert impact_sweep_box2d(speeds) == want
    assert impact_sweep_torch(speeds, jointed=jointed, device="cpu") == want


def test_summarize_engine_curves_matches_jax(tmp_path, monkeypatch):
    from deep_q_learning_tpu_torch.examples import summarize_engine_curves as port
    from examples import summarize_engine_curves as ref

    art = tmp_path / "artifacts"
    shutil.copytree(REPO / "artifacts" / "curves", art / "curves")
    for name in ("lunar_ref_parity_population_r3.json", "policy_transfer.json"):
        shutil.copy(REPO / "artifacts" / name, art / name)
    monkeypatch.chdir(tmp_path)
    ref.main()
    port.main(["--curve-dir", str(art / "curves"), "--out-json", str(tmp_path / "port.json"),
               "--out-png", str(tmp_path / "port.png")])
    want = json.loads((art / "ref_parity_curves.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert (tmp_path / "port.png").stat().st_size > 0


def test_policy_transfer_box2d_returns_match_jax(tmp_path, monkeypatch):
    from deep_q_learning_tpu_torch.examples import policy_transfer as port
    from examples import policy_transfer as ref

    rng = np.random.default_rng(0)

    def dense(n_in, n_out):
        return {"kernel": (rng.normal(size=(n_in, n_out)) / np.sqrt(n_in)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(n_out,))).astype(np.float32)}

    # lunar_ref_parity's network: 9 inputs (time fraction), dueling (32, 64)
    member = {"params": {"trunk_0": dense(9, 32), "trunk_1": dense(32, 64),
                         "value": dense(64, 1), "advantage": dense(64, 4)}}
    (tmp_path / "member_0.pickle").write_bytes(pickle.dumps(member))
    args = ["--params-dir", str(tmp_path), "--episodes", "2",
            "--set", "max_steps_in_episode=8"]
    monkeypatch.setattr(sys, "argv", ["policy_transfer.py", *args,
                                      "--out", str(tmp_path / "jax.json")])
    ref.main()
    got = port.main([*args, "--out", str(tmp_path / "torch.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    (g,), (w,) = got["members"], want["members"]
    np.testing.assert_allclose(g["box2d_returns"], w["box2d_returns"], atol=1e-3, rtol=0)
    assert len(g["torch_returns"]) == 2 and np.isfinite(g["torch_returns"]).all()
    assert set(got) == {k.replace("jax", "torch") for k in want} | {"device"}


@pytest.mark.parametrize("engine,env_id", [("torch", "CartPole-v1"),
                                           ("box2d", "LunarLander-v2")])
def test_engine_curve_compare_writes_the_reference_lines(engine, env_id, tmp_path):
    from deep_q_learning_tpu_torch.examples import engine_curve_compare, summarize_engine_curves

    out = tmp_path / f"curve_{engine}_s0.jsonl"
    engine_curve_compare.main([
        "--engine", engine, "--env", env_id, "--episodes", "3", "--eval-episodes", "1",
        "--set", "training_start=64", "--set", "max_steps_in_episode=200",
        "--set", "use_pallas=true", "--out", str(out), "--device", "cpu",
    ])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    # the keys examples/engine_curve_compare.py writes
    assert set(lines[0]["meta"]) == {"engine", "env", "preset", "seed", "overrides", "obs_dim"}
    assert lines[0]["meta"]["engine"] == engine
    assert len(lines) == 3 + 2
    for row in lines[1:-1]:
        assert set(row) == {"episode", "return", "steps", "global_steps", "window", "eps", "wall"}
    assert set(lines[-1]["final"]) == {"solved", "episodes", "global_steps", "wall_s",
                                       "eval_returns", "eval_mean"}
    summary = summarize_engine_curves.main([
        "--curve-dir", str(tmp_path), "--out-json", str(tmp_path / "s.json"),
        "--out-png", str(tmp_path / "s.png")])
    assert summary["overlay"][engine]["seeds"] == 1
