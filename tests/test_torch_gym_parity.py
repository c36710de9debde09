"""The standing Box2D cross-validation gates of tests/test_gym_parity.py,
on the port's jointed lander (``deep_q_learning_tpu_torch/envs/
gym_compat.py``), at the same thresholds, on the CPU.  Skips without
gymnasium and Box2D.

The seeds of a gate run as lanes of one port env (a frame costs about the
same for one lane or ten): the ballistic envelope's nop seeds 0-9 in one
module-scoped batch that also serves the nop seed 2 contact-timing gate,
and the wind envelope's burn seeds 0-5 in one batch that also serves the
wind seed 2 gate.  Each batch also carries the recorded Box2D traces of its
cases (``envs/gym_traces.json``) as extra lanes: a replayed trace must give
its live lane's dict, which is what the card relies on, having no Box2D.
"""

import pytest

pytest.importorskip("gymnasium")
pytest.importorskip("Box2D")

import gymnasium  # noqa: E402

from deep_q_learning_tpu_torch.envs import gym_compat as gc  # noqa: E402


def _with_traces(policy, seeds, names, max_steps, **kw):
    """Live lanes for ``seeds`` and recorded lanes for the traces ``names``,
    in one call: ``(live dicts, replayed dicts)``."""
    lanes = []
    for seed in seeds:
        genv, gobs = gc._gym_lander(gymnasium, seed, enable_wind=kw.get("enable_wind", False))
        lanes.append((genv, gobs, seed, policy))
    traces = gc._load_traces()
    for name in names:
        rec = gc._RecordedLander(traces[name])
        lanes.append((rec, rec.reset_obs, rec.trace["seed"], rec.trace["policy"]))
    out = gc._stepwise_lanes(lanes, max_steps, device="cpu", **kw)
    return out[: len(seeds)], out[len(seeds):]


@pytest.fixture(scope="module")
def nop_batch():
    return _with_traces("nop", range(10), ["nop_s0", "nop_s2"], 1000)


@pytest.fixture(scope="module")
def wind_batch():
    return _with_traces("burn", range(6), ["burn_s2_wind"], 1000, enable_wind=True)


def test_lunar_ballistic_contact_timing(nop_batch):
    res = nop_batch[0][2]
    g, j = res["first_contact"]["gym"], res["first_contact"]["torch"]
    assert g is not None and j is not None
    assert abs(g - j) <= 2, res
    assert res["flight_max_err"] < 1e-4, res
    assert abs(res["term_step"]["gym"] - res["term_step"]["torch"]) <= 2, res
    assert (res["term_reward"]["gym"] > 0) == (res["term_reward"]["torch"] > 0), res


def test_lunar_ballistic_envelope_aggregate(nop_batch):
    sign_agree = step_close = flight_ok = 0
    for res in nop_batch[0]:
        g_r, j_r = res["term_reward"]["gym"], res["term_reward"]["torch"]
        g_t, j_t = res["term_step"]["gym"], res["term_step"]["torch"]
        if g_r is not None and j_r is not None and (g_r > 0) == (j_r > 0):
            sign_agree += 1
        if g_t is not None and j_t is not None and abs(g_t - j_t) <= 2:
            step_close += 1
        if res["flight_max_err"] < 1e-3:
            flight_ok += 1
    assert sign_agree >= 9, (sign_agree, step_close, flight_ok)
    assert step_close >= 7, (sign_agree, step_close, flight_ok)
    assert flight_ok >= 9, (sign_agree, step_close, flight_ok)


def test_lunar_nop_traces_replay_their_live_lanes(nop_batch):
    live, replayed = nop_batch
    assert replayed == [live[0], live[2]]


def test_lunar_heuristic_closed_loop_outcome():
    (res,), (replayed,) = _with_traces("heuristic", [3], ["heuristic_s3"], 1000,
                                       closed_loop=True)
    assert res["term_reward"]["gym"] == 100.0, res
    assert res["term_reward"]["torch"] == 100.0, res
    assert abs(res["term_step"]["gym"] - res["term_step"]["torch"]) <= 10, res
    assert res["flight_max_err"] < 1e-3, res
    # the replay checked at every frame that the port's heuristic, applied
    # to gym's observation, chose gym's recorded action
    assert replayed == res


def test_lunar_task_level_parity():
    res = gc.compare_lunar_task_level(episodes=6, seed=0, device="cpu")
    assert res["gym"]["mean_return"] > 100, res
    assert res["torch"]["mean_return"] > 100, res
    assert res["torch"]["land_rate"] >= res["gym"]["land_rate"] - 0.17, res
    assert abs(res["torch"]["mean_len"] - res["gym"]["mean_len"]) < 80, res


def test_lunar_wind_stepwise(wind_batch):
    res = wind_batch[0][2]
    assert res["enable_wind"] is True
    assert res["init_state_err"] < 1e-5, res
    assert res["flight_steps"] >= 40, res
    assert res["flight_max_err"] < 5e-4, res
    assert res["term_step"]["gym"] == res["term_step"]["torch"], res
    assert res["term_reward"]["gym"] == res["term_reward"]["torch"], res
    assert wind_batch[1] == [res]


def test_lunar_wind_envelope_aggregate(wind_batch):
    exact_term = sign_agree = flight_ok = 0
    for res in wind_batch[0]:
        g_t, j_t = res["term_step"]["gym"], res["term_step"]["torch"]
        g_r, j_r = res["term_reward"]["gym"], res["term_reward"]["torch"]
        if g_t is not None and j_t is not None and abs(g_t - j_t) <= 1:
            exact_term += 1
        if g_r is not None and j_r is not None and (g_r > 0) == (j_r > 0):
            sign_agree += 1
        if res["flight_max_err"] < 1e-3:
            flight_ok += 1
    assert exact_term >= 5, (exact_term, sign_agree, flight_ok)
    assert sign_agree == 6, (exact_term, sign_agree, flight_ok)
    assert flight_ok >= 4, (exact_term, sign_agree, flight_ok)
