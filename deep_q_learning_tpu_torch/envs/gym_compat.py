"""Cross-validation harness against gymnasium's reference environments
(``deep_q_learning_tpu/envs/gym_compat.py``).

The same functions, arguments and result dicts as the JAX module, on the
port's envs.  Where the JAX dicts name the JAX engine ``"jax"``, these
name the port's engine ``"torch"`` (as ``compat/host_env.make_host_env``
does).  Every public function takes ``device`` (default ``"cuda"``,
through ``train.resolve_device``):

* ``compare_cartpole`` / ``compare_classic`` — gym's classic envs and the
  port's at batch 1 from gym's state, with the same actions;
* ``compare_lunar_stepwise`` — gym's Box2D lander and the port's jointed
  lander from the same injected post-reset state, with the same actions
  (engine dispersion zeroed on both sides; gymnasium v3's deterministic
  wind phase-matched through the injected counters);
  ``compare_lunar_stepwise_seeds`` runs many seeds as the lanes of ONE
  port env: a frame costs about the same for one lane or ten, so a batch
  of seeds costs one run of its longest episode;
* ``compare_lunar_task_level`` — heuristic-controller return
  distributions on both engines (the port's episodes are lanes of one env;
  its reset draws are Philox, not JAX's threefry, so only the distribution
  is comparable).

The card has no gymnasium.  ``gym_traces.json`` (beside this file) holds
Box2D episodes recorded by ``_record_lunar_trace``; ``_RecordedLander``
replays one in place of the live env, for ``_stepwise_lanes``.  A caller
picks the live env or a trace; nothing falls back from one to the other.
Re-record with ``python -m deep_q_learning_tpu_torch.envs.gym_compat
--record`` (needs gymnasium and Box2D).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.envs import lander_solver
from deep_q_learning_tpu_torch.envs.base import uniform
from deep_q_learning_tpu_torch.envs.graphed import GraphedStep
from deep_q_learning_tpu_torch.envs.heuristic import heuristic_action
from deep_q_learning_tpu_torch.envs.lunar_lander import CHUNKS, LunarLander, LunarLanderState
from deep_q_learning_tpu_torch.envs.registry import make_env
from deep_q_learning_tpu_torch.train import resolve_device

TRACES_PATH = Path(__file__).with_name("gym_traces.json")
# the recorded cases: (policy, seed, enable_wind, closed_loop, max_steps)
TRACE_CASES = (
    ("burn", 1, False, False, 400),
    ("burn", 6, False, False, 400),
    ("nop", 0, False, False, 1000),
    ("nop", 2, False, False, 1000),
    ("heuristic", 3, False, True, 1000),
    ("burn", 2, True, False, 400),
)


def _import_gym():
    try:
        import gymnasium as gym

        return gym, 5
    except ImportError:
        pass
    try:
        import gym  # classic API

        return gym, 4
    except ImportError:
        return None, 0


def _make_lander(gym, **kwargs):
    for env_id in ("LunarLander-v3", "LunarLander-v2"):
        try:
            return gym.make(env_id, **kwargs).unwrapped
        except Exception:
            continue
    raise RuntimeError("no LunarLander registration available")


class _ZeroDispersionRNG:
    """np_random proxy nulling the lander's per-step dispersion draws.

    gymnasium's step draws ``uniform(-1.0, +1.0)`` (scalar) twice per frame
    for engine dispersion; terrain (vector draw) and the initial force
    (``uniform(-1000, 1000)``) have distinguishable signatures and pass
    through to the real generator.
    """

    def __init__(self, rng):
        self._rng = rng

    def uniform(self, low=0.0, high=1.0, size=None):
        if size is None and low == -1.0 and high == 1.0:
            return 0.0
        return self._rng.uniform(low, high, size)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def _shaping_of(obs) -> float:
    o = np.asarray(obs, np.float64)
    return float(
        -100 * np.sqrt(o[0] ** 2 + o[1] ** 2)
        - 100 * np.sqrt(o[2] ** 2 + o[3] ** 2)
        - 100 * abs(o[4])
        + 10 * o[6]
        + 10 * o[7]
    )


def _gym_lander(gym, seed, zero_dispersion=True, enable_wind=False, wind_power=15.0,
                turbulence_power=1.5):
    """A reset gym lander, with its dispersion draws nulled if asked:
    ``(genv, reset_obs)``."""
    wind_kw = (
        dict(enable_wind=True, wind_power=wind_power, turbulence_power=turbulence_power)
        if enable_wind
        else {}
    )
    genv = _make_lander(gym, **wind_kw)
    gobs, _ = genv.reset(seed=seed)
    if zero_dispersion:
        genv._np_random = _ZeroDispersionRNG(genv.np_random)
    return genv, np.asarray(gobs, np.float32)


def _gym_pose(genv) -> dict:
    """What the injection reads from a gym lander, as plain numbers: the
    hull and both legs (position, angle, velocities; legs with their
    contact flag), the terrain heights from ``sky_polys``, the shaping and
    the wind counters."""

    def body(b):
        return [b.position.x, b.position.y, b.angle, b.linearVelocity.x,
                b.linearVelocity.y, b.angularVelocity]

    # sky_polys[i][0] = (chunk_x[i], smooth_y[i]); the last one's [1] is the right end
    terrain = [genv.sky_polys[i][0][1] for i in range(CHUNKS - 1)]
    terrain.append(genv.sky_polys[-1][1][1])
    return {
        "hull": [float(v) for v in body(genv.lander)],
        "legs": [[float(v) for v in body(leg)] + [bool(leg.ground_contact)]
                 for leg in genv.legs],
        "terrain": [float(h) for h in terrain],
        "prev_shaping": float(genv.prev_shaping),
        # gymnasium v3 draws both pattern offsets at reset (lunar_lander.py
        # :323-325 in gymnasium 1.2.2): injected, the deterministic tanh(sin)
        # pattern is phase-matched for wind comparisons
        "wind_idx": int(getattr(genv, "wind_idx", 0)),
        "torque_idx": int(getattr(genv, "torque_idx", 0)),
    }


def _inject_state_from_gym(genvs, env, params, device="cuda") -> LunarLanderState:
    """A batched port ``LunarLanderState`` mirroring the gym landers' current
    poses, one lane per env in ``genvs``."""
    device = resolve_device(device)
    poses = [_gym_pose(g) for g in genvs]

    def f32(values):
        return torch.tensor(np.asarray(values, np.float32), device=device)

    def i32(values):
        return torch.tensor(np.asarray(values, np.int32), device=device)

    hull = np.asarray([p["hull"] for p in poses], np.float64)  # (L, 6): x y a vx vy w

    def leg_body(side):
        # gym creates legs for i in [-1, +1]: legs[0] is side -1, the
        # solver's leg1.  A leg's localCenter is (0, 0): its origin is its
        # COM, as Body expects
        v = np.asarray([p["legs"][side][:6] for p in poses], np.float64)
        return lander_solver.Body(cx=f32(v[:, 0]), cy=f32(v[:, 1]), a=f32(v[:, 2]),
                                  vx=f32(v[:, 3]), vy=f32(v[:, 4]), w=f32(v[:, 5]))

    n = len(poses)
    jointed = params.jointed
    return LunarLanderState(
        x=f32(hull[:, 0]),
        y=f32(hull[:, 1]),
        vx=f32(hull[:, 3]),
        vy=f32(hull[:, 4]),
        angle=f32(hull[:, 2]),
        omega=f32(hull[:, 5]),
        leg1=torch.tensor([p["legs"][0][6] for p in poses], device=device),
        leg2=torch.tensor([p["legs"][1][6] for p in poses], device=device),
        terrain=f32([p["terrain"] for p in poses]),
        prev_shaping=f32([p["prev_shaping"] for p in poses]),
        t=i32([0] * n),
        sleep=i32([0] * n),
        wind_idx=i32([p["wind_idx"] for p in poses]),
        torque_idx=i32([p["torque_idx"] for p in poses]),
        leg1_body=leg_body(0) if jointed else None,
        leg2_body=leg_body(1) if jointed else None,
        # Box2D's accumulators are not readable through pybox2d; starting
        # from zero costs one settling frame at the (airborne) injection
        # point, where only the tiny motor/limit impulses are in play
        solver_acc=lander_solver.zero_acc(n, device) if jointed else None,
    )


class _Frames:
    """A batched port env stepped frame by frame, its state held here.

    The frame runs through :class:`~deep_q_learning_tpu_torch.envs.graphed.
    GraphedStep`: on a CUDA device it is captured once in a CUDA graph and
    every frame replays it (an eager jointed frame is ~80k kernel launches,
    bound by the host's time per launch, where a replay issues them from the
    device), bit for bit the eager frame; on the CPU it is called directly.
    ``state`` is the frame's output, overwritten by the next frame."""

    def __init__(self, env, params, state):
        self.env, self.params, self.state = env, params, state
        self._stepper = GraphedStep(
            lambda st, a, d: env.step_env(None, st, a, params, d), f"{env.name}'s frame")

    @property
    def _graph(self):
        return self._stepper.graph

    def step(self, actions: torch.Tensor, draws: Optional[torch.Tensor] = None):
        """One frame with these actions (and a lander's ``(N, 2)``
        dispersion draws): ``(obs, reward, terminated, truncated)``."""
        obs, self.state, *rest = self._stepper(self.state, actions, draws)
        return (obs, *rest)


def _step_host(frames: _Frames, actions, draws=None):
    """One frame; obs, reward and both flags to the host in one copy.
    Returns the device obs and the host obs, reward, terminated, truncated."""
    obs, reward, term, trunc = frames.step(actions, draws)
    n, d = obs.shape
    host = torch.cat([obs.reshape(-1), reward, term.to(torch.float32),
                      trunc.to(torch.float32)]).cpu().numpy()
    return (obs, host[: n * d].reshape(n, d), host[n * d : n * d + n],
            host[n * d + n : n * d + 2 * n] > 0, host[n * d + 2 * n :] > 0)


def compare_cartpole(num_steps: int = 200, seed: int = 0, device="cuda") -> Optional[dict]:
    """Step gym's CartPole and the port's with the same actions from the
    same state; returns the max per-dimension divergence (None if gym is
    missing)."""
    gym, api = _import_gym()
    if gym is None:
        return None
    device = resolve_device(device)
    genv = gym.make("CartPole-v1").unwrapped
    out = genv.reset(seed=seed) if api == 5 else genv.reset()
    gobs = np.asarray(out[0] if isinstance(out, tuple) else out, np.float32)

    env, p = make_env("CartPole-v1")
    _, state = env.reset_env(torch.Generator(device=device).manual_seed(0), 1, p)
    g = torch.tensor(gobs[None], device=device)
    frames = _Frames(env, p, dataclasses.replace(
        state, x=g[:, 0].clone(), x_dot=g[:, 1].clone(), theta=g[:, 2].clone(),
        theta_dot=g[:, 3].clone()))
    rng = np.random.RandomState(seed)
    max_err = 0.0
    steps = 0
    for t in range(num_steps):
        a = int(rng.randint(2))
        gout = genv.step(a)
        gobs = np.asarray(gout[0], np.float32)
        gdone = bool(gout[2]) or (api == 5 and bool(gout[3]))
        action = torch.tensor([a], dtype=torch.int32, device=device)
        _, tobs, _, term, _ = _step_host(frames, action)
        max_err = max(max_err, float(np.max(np.abs(tobs[0] - gobs))))
        steps = t + 1
        if gdone or term[0]:
            break
    return {"steps_compared": steps, "max_abs_err": max_err}


def compare_classic(env_id: str, num_steps: int = 300, seed: int = 0,
                    device="cuda") -> Optional[dict]:
    """Acrobot/MountainCar stepwise cross-validation against gymnasium:
    matched initial state, same action sequence, max per-dimension
    observation divergence."""
    gym, api = _import_gym()
    if gym is None:
        return None
    device = resolve_device(device)
    genv = gym.make(env_id).unwrapped
    genv.reset(seed=seed)

    # gym is .unwrapped (no TimeLimit), so the port env's own step cap must
    # not fire mid-comparison either: this measures dynamics + termination,
    # not time-limit bookkeeping
    env, p = make_env(env_id, max_steps_in_episode=num_steps + 1)
    _, state = env.reset_env(torch.Generator(device=device).manual_seed(0), 1, p)
    s = torch.tensor(np.asarray(genv.state, np.float64), device=device).to(torch.float32)
    if env_id == "Acrobot-v1":
        # gym state: [theta1, theta2, dtheta1, dtheta2]
        fields = ("theta1", "theta2", "dtheta1", "dtheta2")
    elif env_id == "MountainCar-v0":
        fields = ("position", "velocity")
    else:
        raise ValueError(env_id)
    frames = _Frames(env, p, dataclasses.replace(
        state, **{name: s[i : i + 1].clone() for i, name in enumerate(fields)}))
    rng = np.random.RandomState(seed)
    max_err = 0.0
    steps = 0
    term_match = True
    for t in range(num_steps):
        a = int(rng.randint(env.num_actions))
        gout = genv.step(a)
        gobs = np.asarray(gout[0], np.float32)
        gterm = bool(gout[2])
        gtrunc = api == 5 and bool(gout[3])
        action = torch.tensor([a], dtype=torch.int32, device=device)
        _, tobs, _, term, trunc = _step_host(frames, action)
        max_err = max(max_err, float(np.max(np.abs(tobs[0] - gobs))))
        steps = t + 1
        # either side ending the episode stops the comparison; terminations
        # and truncations are matched separately
        if gterm or gtrunc or term[0] or trunc[0]:
            term_match = (gterm == bool(term[0])) and (gtrunc == bool(trunc[0]))
            break
    return {
        "env_id": env_id,
        "seed": seed,
        "steps_compared": steps,
        "max_abs_err": max_err,
        "termination_agrees": term_match,
    }


def _stepwise_lanes(
    lanes: Sequence[Tuple[object, np.ndarray, int, str]],
    max_steps: int = 400,
    zero_dispersion: bool = True,
    closed_loop: bool = False,
    enable_wind: bool = False,
    wind_power: float = 15.0,
    turbulence_power: float = 1.5,
    device="cuda",
) -> List[dict]:
    """The matched-state stepwise comparison, one lane per gym env.

    ``lanes`` holds ``(genv, reset_obs, seed, policy)`` per lane: a reset
    gym lander (dispersion nulled if ``zero_dispersion``) or a
    ``_RecordedLander``, its reset observation, the seed it was reset with
    (reported), and its policy ("nop", "burn" or "heuristic").  The gym
    envs step on the host one after another; the port steps one env of L
    lanes with one ``step_env`` a frame.  Dispersion and wind are port env
    parameters, so every lane shares them (and ``closed_loop``).  Each lane
    keeps the JAX module's bookkeeping for itself: a lane whose side has
    ended stops recording while the batch steps on.  Returns one
    ``compare_lunar_stepwise`` dict per lane."""
    device = resolve_device(device)
    genvs = [lane[0] for lane in lanes]
    gobs = np.stack([np.asarray(lane[1], np.float32) for lane in lanes])
    policies = [lane[3] for lane in lanes]
    if not set(policies) <= {"nop", "burn", "heuristic"}:
        raise ValueError(f"unknown policy in {policies}")
    n = len(lanes)

    env = LunarLander()
    params = dataclasses.replace(
        env.default_params(), dispersion_scale=0.0 if zero_dispersion else 1.0,
        enable_wind=enable_wind, wind_power=wind_power, turbulence_power=turbulence_power,
    )
    state = _inject_state_from_gym(genvs, env, params, device)
    jobs_dev = env.get_obs(state, params)
    jobs = jobs_dev.cpu().numpy()
    frames = _Frames(env, params, state)
    generator = torch.Generator(device=device).manual_seed(int(lanes[0][2]))
    fixed = np.asarray([{"nop": 0, "burn": 2}.get(p, 0) for p in policies], np.int32)
    heur = np.asarray([p == "heuristic" for p in policies])
    own = heur & closed_loop  # lanes whose port side acts on its own observation
    own_dev = torch.tensor(own, device=device)

    init_err = np.max(np.abs(jobs - gobs), axis=1)
    errs: List[List[float]] = [[] for _ in range(n)]  # continuous dims 0..5
    rerrs: List[List[float]] = [[] for _ in range(n)]
    flag_match: List[List[bool]] = [[] for _ in range(n)]
    g_first = [None] * n
    j_first = [None] * n
    g_term = [None] * n
    j_term = [None] * n
    g_rew = [None] * n
    j_rew = [None] * n
    gdone = np.zeros(n, bool)
    jdone = np.zeros(n, bool)
    gr = np.zeros(n)
    for t in range(max_steps):
        a = fixed.copy()
        if heur.any():
            # actions from the GYM observation; replayed open-loop into the
            # port env unless closed_loop gives it its own feedback
            a = np.where(heur, heuristic_action(torch.from_numpy(gobs)).numpy(), a)
        ja = torch.from_numpy(a).to(device)
        if own.any():
            ja = torch.where(own_dev, heuristic_action(jobs_dev), ja)
        for i in np.flatnonzero(~gdone):
            out = genvs[i].step(int(a[i]))
            gobs[i] = np.asarray(out[0], np.float32)
            gr[i] = float(out[1])
            if g_first[i] is None and (gobs[i, 6] > 0 or gobs[i, 7] > 0):
                g_first[i] = t + 1
            if out[2] or out[3]:
                gdone[i], g_term[i], g_rew[i] = True, t + 1, float(out[1])
        jobs_dev, step_obs, jr, jterm, jtrunc = _step_host(
            frames, ja, uniform(generator, (n, 2), -1.0, 1.0))
        live = ~jdone
        jobs[live] = step_obs[live]
        for i in np.flatnonzero(live):
            if j_first[i] is None and (jobs[i, 6] > 0 or jobs[i, 7] > 0):
                j_first[i] = t + 1
            if jterm[i] or jtrunc[i]:
                jdone[i], j_term[i], j_rew[i] = True, t + 1, float(jr[i])
        if (gdone & jdone).all():
            break
        # a lane records while both of its sides are live (the JAX loop keeps
        # stepping the live engine for its terminal info)
        for i in np.flatnonzero(~gdone & ~jdone):
            errs[i].append(float(np.max(np.abs(jobs[i, :6] - gobs[i, :6]))))
            flag_match[i].append(bool((jobs[i, 6] > 0) == (gobs[i, 6] > 0)
                                      and (jobs[i, 7] > 0) == (gobs[i, 7] > 0)))
            rerrs[i].append(abs(float(jr[i]) - float(gr[i])))

    results = []
    for i in range(n):
        e = errs[i]
        contact = min([c for c in (g_first[i], j_first[i]) if c is not None], default=None)
        flight = e[: (contact - 1) if contact is not None else len(e)]
        results.append({
            "policy": policies[i],
            "seed": int(lanes[i][2]),
            "zero_dispersion": zero_dispersion,
            "closed_loop": closed_loop,
            "enable_wind": enable_wind,
            "init_state_err": float(init_err[i]),
            "steps_compared": len(e),
            "flight_steps": len(flight),
            "flight_max_err": max(flight) if flight else None,
            "obs_err_at": {str(k): e[k - 1] for k in (1, 5, 10, 25, 50, 100, 200) if len(e) >= k},
            "max_obs_err": max(e) if e else None,
            "max_reward_err": max(rerrs[i]) if rerrs[i] else None,
            "leg_flag_agreement": float(np.mean(flag_match[i])) if flag_match[i] else None,
            "first_contact": {"gym": g_first[i], "torch": j_first[i]},
            "term_step": {"gym": g_term[i], "torch": j_term[i]},
            "term_reward": {"gym": g_rew[i], "torch": j_rew[i]},
        })
    return results


def compare_lunar_stepwise_seeds(
    policy: str = "nop",
    seeds: Sequence[int] = (0,),
    max_steps: int = 400,
    zero_dispersion: bool = True,
    closed_loop: bool = False,
    enable_wind: bool = False,
    wind_power: float = 15.0,
    turbulence_power: float = 1.5,
    device="cuda",
) -> Optional[List[dict]]:
    """``compare_lunar_stepwise`` for each of ``seeds``, the seeds stepped
    as lanes of one port env; one dict per seed (None if gym is missing)."""
    gym, _ = _import_gym()
    if gym is None:
        return None
    lanes = []
    for seed in seeds:
        genv, gobs = _gym_lander(gym, seed, zero_dispersion, enable_wind, wind_power,
                                 turbulence_power)
        lanes.append((genv, gobs, seed, policy))
    return _stepwise_lanes(lanes, max_steps, zero_dispersion, closed_loop, enable_wind,
                           wind_power, turbulence_power, device)


def compare_lunar_stepwise(
    policy: str = "nop",
    seed: int = 0,
    max_steps: int = 400,
    zero_dispersion: bool = True,
    closed_loop: bool = False,
    enable_wind: bool = False,
    wind_power: float = 15.0,
    turbulence_power: float = 1.5,
    device="cuda",
) -> Optional[dict]:
    """Matched-initial-state, same-action-sequence divergence measurement.

    ``policy``: "nop" (ballistic drop to touchdown), "heuristic" (the
    landing controller, actions computed from the GYM observation and
    replayed open-loop into the port env), or "burn" (main engine every
    frame: the in-flight engine model).  ``closed_loop=True`` gives each
    engine its own heuristic feedback; open-loop replay of a powered flight
    amplifies any per-step difference (the thrust-attitude loop is
    unstable), so it measures chaos, not engine error.  ``enable_wind``
    turns on gymnasium v3's wind and turbulence on both engines.

    Returns per-step divergence checkpoints, first-contact and termination
    steps and terminal rewards on both engines (``"gym"``, ``"torch"``)."""
    out = compare_lunar_stepwise_seeds(policy, [seed], max_steps, zero_dispersion, closed_loop,
                                       enable_wind, wind_power, turbulence_power, device)
    return None if out is None else out[0]


def compare_lunar_task_level(episodes: int = 10, seed: int = 0, device="cuda") -> Optional[dict]:
    """Heuristic-controller closed-loop returns on both engines.  The port's
    ``episodes`` run as lanes of one env reset from a generator seeded with
    ``seed``; each lane ends at its first terminal frame."""
    gym, _ = _import_gym()
    if gym is None:
        return None
    device = resolve_device(device)
    genv = _make_lander(gym)
    g_rets, g_lens = [], []
    for ep in range(episodes):
        out = genv.reset(seed=seed + ep)
        obs = np.asarray(out[0] if isinstance(out, tuple) else out, np.float32)
        total, steps = 0.0, 0
        for _ in range(1000):
            a = int(heuristic_action(torch.from_numpy(obs)[None])[0])
            gout = genv.step(a)
            obs = np.asarray(gout[0], np.float32)
            total += float(gout[1])
            steps += 1
            if bool(gout[2]) or bool(gout[3]):
                break
        g_rets.append(total)
        g_lens.append(steps)

    env = LunarLander()
    p = env.default_params()
    generator = torch.Generator(device=device).manual_seed(seed)
    obs, state = env.reset_env(generator, episodes, p)
    frames = _Frames(env, p, state)
    t_rets = np.zeros(episodes)
    t_lens = np.zeros(episodes, np.int64)
    done = np.zeros(episodes, bool)
    for _ in range(1000):
        obs, _, r, term, trunc = _step_host(frames, heuristic_action(obs),
                                            uniform(generator, (episodes, 2), -1.0, 1.0))
        t_rets += np.where(done, 0.0, r.astype(np.float64))
        t_lens += ~done
        done |= term | trunc
        if done.all():
            break

    def summary(rets, lens):
        return {
            "mean_return": float(np.mean(rets)),
            "std_return": float(np.std(rets)),
            "land_rate": float(np.mean([r > 200 for r in rets])),
            "mean_len": float(np.mean(lens)),
            "returns": [round(float(r), 1) for r in rets],
        }

    return {"episodes": episodes, "gym": summary(g_rets, g_lens),
            "torch": summary(t_rets, t_lens)}


# ------------------------------------------------------------ recorded traces
def _trace_name(policy: str, seed: int, enable_wind: bool) -> str:
    return f"{policy}_s{seed}" + ("_wind" if enable_wind else "")


def _f32_list(values) -> List[float]:
    """float32 values as the shortest decimals that read back to them."""
    return [float(str(v)) for v in np.asarray(values, np.float32)]


def _record_lunar_trace(policy: str, seed: int, enable_wind: bool, closed_loop: bool,
                        max_steps: int) -> dict:
    """One Box2D episode for replay where gymnasium is absent: gym's
    post-reset pose (``_gym_pose``) and reset observation, then per frame
    gym's action, observation, reward and both flags, until gym's episode
    ends or ``max_steps``.  Dispersion is nulled, as in every stepwise
    comparison; a heuristic lander's actions come from gym's observations
    (``closed_loop`` is kept for the replay's port side)."""
    gym, _ = _import_gym()
    if gym is None:
        raise RuntimeError("recording a trace needs gymnasium and Box2D")
    genv, gobs = _gym_lander(gym, seed, True, enable_wind)
    trace = {
        "policy": policy, "seed": seed, "enable_wind": enable_wind,
        "closed_loop": closed_loop, "max_steps": max_steps,
        "pose": _gym_pose(genv), "reset_obs": _f32_list(gobs),
        "actions": [], "obs": [], "rewards": [], "terminated": [], "truncated": [],
    }
    for _ in range(max_steps):
        if policy == "heuristic":
            a = int(heuristic_action(torch.from_numpy(gobs)[None])[0])
        else:
            a = {"nop": 0, "burn": 2}[policy]
        obs, reward, term, trunc, _ = genv.step(a)
        gobs = np.asarray(obs, np.float32)
        trace["actions"].append(a)
        trace["obs"].append(_f32_list(gobs))
        trace["rewards"].append(float(reward))
        trace["terminated"].append(bool(term))
        trace["truncated"].append(bool(trunc))
        if term or trunc:
            break
    return trace


def _load_traces() -> dict:
    with open(TRACES_PATH) as fh:
        return json.load(fh)["traces"]


def _body_ns(x, y, angle, vx, vy, w, contact=False):
    return SimpleNamespace(position=SimpleNamespace(x=x, y=y), angle=angle,
                           linearVelocity=SimpleNamespace(x=vx, y=vy), angularVelocity=w,
                           ground_contact=contact)


class _RecordedLander:
    """A recorded gym lander (``_record_lunar_trace``) in place of the live
    env: the attributes ``_gym_pose`` reads, and ``step(a)``, which replays
    the next recorded frame and raises if ``a`` is not the recorded action
    (or the trace has ended)."""

    def __init__(self, trace: dict):
        pose = trace["pose"]
        self.trace = trace
        self.lander = _body_ns(*pose["hull"])
        self.legs = [_body_ns(*leg) for leg in pose["legs"]]
        h = pose["terrain"]
        self.sky_polys = [[(None, h[i]), (None, h[i + 1])] for i in range(len(h) - 1)]
        self.prev_shaping = pose["prev_shaping"]
        self.wind_idx = pose["wind_idx"]
        self.torque_idx = pose["torque_idx"]
        self.reset_obs = np.asarray(trace["reset_obs"], np.float32)
        self._t = 0

    def step(self, action):
        t, tr = self._t, self.trace
        if t >= len(tr["actions"]):
            raise RuntimeError(f"trace {_trace_name(tr['policy'], tr['seed'], tr['enable_wind'])} "
                               f"has {t} frames; a step past its end was asked for")
        if int(action) != tr["actions"][t]:
            raise RuntimeError(f"frame {t}: action {int(action)}, the recording took "
                               f"{tr['actions'][t]}")
        self._t += 1
        return (np.asarray(tr["obs"][t], np.float32), tr["rewards"][t], tr["terminated"][t],
                tr["truncated"][t], {})


def _replay(names: Sequence[str], max_steps: int, device="cuda") -> List[dict]:
    """``_stepwise_lanes`` over recorded traces (one lane each) in place of
    live gym envs.  The traces must share wind and closed-loop settings."""
    traces = _load_traces()
    cases = [traces[name] for name in names]
    shared = {(c["enable_wind"], c["closed_loop"]) for c in cases}
    if len(shared) != 1:
        raise ValueError(f"traces {names} differ in wind or closed loop: {shared}")
    ((enable_wind, closed_loop),) = shared
    lanes = []
    for c in cases:
        genv = _RecordedLander(c)
        lanes.append((genv, genv.reset_obs, c["seed"], c["policy"]))
    return _stepwise_lanes(lanes, max_steps, True, closed_loop, enable_wind, device=device)


def _record_all() -> dict:
    import gymnasium

    return {
        "gymnasium": gymnasium.__version__,
        "traces": {_trace_name(p, s, w): _record_lunar_trace(p, s, w, c, m)
                   for p, s, w, c, m in TRACE_CASES},
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="gymnasium cross-checks of the port's envs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", action="store_true",
                    help=f"re-record {TRACES_PATH.name} (needs gymnasium and Box2D)")
    args = ap.parse_args()
    if args.record:
        with open(TRACES_PATH, "w") as fh:
            json.dump(_record_all(), fh, separators=(",", ":"))
            fh.write("\n")
        print("wrote", TRACES_PATH)
    else:
        print("cartpole:", compare_cartpole(device=args.device))
        for pol in ("nop", "burn", "heuristic"):
            print(f"lunar stepwise [{pol}]:", compare_lunar_stepwise(policy=pol,
                                                                     device=args.device))
        print("lunar task-level:", compare_lunar_task_level(device=args.device))
