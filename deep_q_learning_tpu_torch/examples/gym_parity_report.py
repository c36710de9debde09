"""The port's measured fidelity report against gymnasium's Box2D lander
(``examples/gym_parity_report.py``).

Per-step state divergence for CartPole and LunarLander, heuristic-
controller return distributions on both engines and impact-speed crash
boundaries, with the port's lander (``"torch"``) where the JAX report has
``"jax"``.  The lander's seeds run as lanes of one env
(``envs/gym_compat.compare_lunar_stepwise_seeds``).  Needs gymnasium and
Box2D, so it runs where they are installed (the CPU here):

    python -m deep_q_learning_tpu_torch.examples.gym_parity_report \
        --device cpu --out artifacts/gym_parity_torch.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional


def impact_sweep_box2d(speeds, seed=0):
    """Vertical drop onto the pad at controlled impact speed on Box2D."""
    import gymnasium as gym

    out = {}
    for v0 in speeds:
        env = gym.make("LunarLander-v3").unwrapped
        env.reset(seed=seed)
        L = env.lander
        for _ in range(80):  # settle legs at joint limits while held aloft
            env.step(0)
            for b in [L] + list(env.legs):
                b.linearVelocity = (0, 0)
                b.angularVelocity = 0
        lowest = min(
            leg.GetWorldPoint(v).y
            for leg in env.legs
            for v in leg.fixtures[0].shape.vertices
        )
        y0 = env.helipad_y * 0.99 + (L.position.y - lowest) + 0.03
        dx, dy = 10.0 - L.position.x, y0 - L.position.y
        for b in [L] + list(env.legs):
            b.position = (b.position.x + dx, b.position.y + dy)
            b.linearVelocity = (0, -v0)
            b.angularVelocity = 0
        r = None
        for _ in range(400):
            obs, r, term, trunc, _ = env.step(0)
            if term:
                break
        out[str(v0)] = "CRASH" if env.game_over else ("LAND" if r == 100 else "TIMEOUT")
    return out


def impact_sweep_torch(speeds, jointed=True, device="cuda"):
    """The Box2D sweep's protocol on the port's lander, one lane per speed:
    settle the legs aloft (80 frames, velocities zeroed), move the whole
    assembly to 0.03 m above the pad, release at the speed; each lane's
    outcome is its first terminal reward.  Every lane resets from the same
    draws (one draw repeated), as the JAX sweep resets every speed from one
    key."""
    import numpy as np
    import torch

    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs import lander_solver as ls
    from deep_q_learning_tpu_torch.envs.lunar_lander import (
        CONTACT_SKIN, HELIPAD_Y, LEG_TIP_Y, W, ResetDraws, sample_reset_draws,
    )
    from deep_q_learning_tpu_torch.train import resolve_device

    device = resolve_device(device)
    env = LunarLander()
    p = dataclasses.replace(env.default_params(), random_terrain=False, jointed=jointed)
    n = len(speeds)
    generator = torch.Generator(device=device).manual_seed(0)
    one = sample_reset_draws(generator, 1)
    draws = ResetDraws(**{f.name: getattr(one, f.name).expand(n, -1).contiguous()
                          for f in dataclasses.fields(ResetDraws)})
    _, st = env.reset_env(generator, n, p, draws=draws)
    nop = torch.zeros((n,), dtype=torch.int32, device=device)
    zero = torch.zeros((n,), device=device)
    down = -torch.tensor(speeds, dtype=torch.float32, device=device)
    ground = 0.99 * HELIPAD_Y

    def f32(values):
        return torch.tensor(np.asarray(values, np.float32), device=device)

    if jointed:
        still = dict(vx=zero, vy=zero, w=zero)
        for _ in range(80):
            _, st, *_ = env.step_env(generator, st, nop, p)
            st = dataclasses.replace(
                st, vx=zero, vy=zero, omega=zero,
                leg1_body=dataclasses.replace(st.leg1_body, **still),
                leg2_body=dataclasses.replace(st.leg2_body, **still),
            )
        corners = []
        for leg in (st.leg1_body, st.leg2_body):
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    _, wy = ls.rot(leg.a, sx * ls.LEG_HW, sy * ls.LEG_HH)
                    corners.append(leg.cy + wy)
        lowest = torch.stack(corners).amin(0).cpu().numpy().astype(np.float64)
        x, y = (v.cpu().numpy().astype(np.float64) for v in (st.x, st.y))
        # the offsets in float64, as the JAX sweep's Python floats
        y0 = ground + (y - lowest) + 0.03
        dx, dy = f32(W / 2 - x), f32(y0 - y)

        def move(b):
            return dataclasses.replace(b, cx=b.cx + dx, cy=b.cy + dy, vx=zero, vy=down, w=zero)

        st = dataclasses.replace(
            st, x=st.x + dx, y=st.y + dy, vx=zero, vy=down, omega=zero,
            leg1_body=move(st.leg1_body), leg2_body=move(st.leg2_body),
            sleep=torch.zeros_like(st.sleep),
        )
    else:
        st = dataclasses.replace(
            st, x=f32([W / 2] * n), y=f32([ground + CONTACT_SKIN - LEG_TIP_Y + 0.03] * n),
            vx=zero, vy=down, angle=zero, omega=zero,
            leg1=torch.zeros_like(st.leg1), leg2=torch.zeros_like(st.leg2),
            sleep=torch.zeros_like(st.sleep),
        )
    outcome = np.zeros(n)
    done = np.zeros(n, bool)
    for _ in range(400):
        _, st, r, term, _ = env.step_env(generator, st, nop, p)
        host = torch.stack([r, term.to(torch.float32)]).cpu().numpy()
        outcome = np.where(done, outcome, host[0])
        done |= host[1] > 0
        if done.all():
            break
    return {str(v0): "CRASH" if rr == -100.0 else ("LAND" if rr == 100.0 else "TIMEOUT")
            for v0, rr in zip(speeds, outcome)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="artifacts/gym_parity_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from deep_q_learning_tpu_torch.envs import gym_compat as gc
    from deep_q_learning_tpu_torch.envs import lander_solver as ls
    from deep_q_learning_tpu_torch.envs import lunar_lander as ll

    device = args.device
    report = {"engine": f"jointed (deep_q_learning_tpu_torch/envs/lander_solver.py) on {device}"}
    report["cartpole_stepwise"] = [
        gc.compare_cartpole(num_steps=300, seed=s, device=device) for s in range(5)
    ]
    # nop/burn are open-loop (deterministic action sequences); the heuristic
    # is CLOSED-loop per engine: open-loop replay of a powered descent
    # measures chaos amplification, not engine error (gym_compat docstring)
    for pol in ("nop", "burn"):
        report[f"lunar_stepwise_{pol}"] = gc.compare_lunar_stepwise_seeds(
            pol, range(10), device=device)
    report["lunar_stepwise_heuristic"] = gc.compare_lunar_stepwise_seeds(
        "heuristic", range(10), max_steps=1000, closed_loop=True, device=device)
    report["lunar_stepwise_wind"] = [
        res
        for pol in ("nop", "burn")
        for res in gc.compare_lunar_stepwise_seeds(pol, range(6), max_steps=1000,
                                                   enable_wind=True, device=device)
    ]
    report["lunar_task_level"] = gc.compare_lunar_task_level(episodes=20, seed=0, device=device)
    speeds = [0.5, 1.0, 1.5, 1.8, 2.0, 2.2, 2.5, 3.0, 4.0]
    report["impact_sweep"] = {
        "box2d": impact_sweep_box2d(speeds),
        "torch": impact_sweep_torch(speeds, jointed=True, device=device),
        "torch_rigid": impact_sweep_torch(speeds, jointed=False, device=device),
    }
    report["constants"] = {
        "note": "measured by instantiating gymnasium's Box2D bodies",
        "hull_mass": ls.HULL_M,
        "hull_inertia": ls.HULL_I,
        "hull_center": [ls.HULL_CX, ls.HULL_CY],
        "leg_mass": ls.LEG_M,
        "leg_inertia": ls.LEG_I,
        "total_mass": ll.TOTAL_MASS,
        "assembly_inertia_rigid": ll.INERTIA,
        "contact_skin": ll.CONTACT_SKIN,
        "mu": ll.MU,
        "j_crash_rigid": ll.J_CRASH,
        "sleep": [ll.LIN_SLEEP_TOL, ll.ANG_SLEEP_TOL, ll.SLEEP_FRAMES],
    }
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report["lunar_task_level"], indent=1))
    print("impact:", json.dumps(report["impact_sweep"]))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
