"""Heuristic LunarLander controller (``deep_q_learning_tpu/envs/heuristic.py``),
batched, and a short flight of landers near the ground that it drives.

The controller is the classic open-source demo: target an angle
proportional to the horizontal offset and speed, a hover height
proportional to |x|, and fire the engine whose correction is most needed.
"""

from __future__ import annotations

import dataclasses

import torch

from deep_q_learning_tpu_torch.envs.lunar_lander import _terrain_height


def heuristic_action(obs: torch.Tensor) -> torch.Tensor:
    """``(N, >= 8)`` LunarLander observations -> ``(N,)`` int32 actions."""
    x, y, vx, vy, angle, omega, l1, l2 = obs[:, :8].unbind(1)

    angle_targ = torch.clamp(x * 0.5 + vx * 1.0, -0.4, 0.4)
    hover_targ = 0.55 * torch.abs(x)

    angle_todo = (angle_targ - angle) * 0.5 - omega * 1.0
    hover_todo = (hover_targ - y) * 0.5 - vy * 0.5

    grounded = (l1 > 0.5) | (l2 > 0.5)
    angle_todo = torch.where(grounded, 0.0, angle_todo)
    hover_todo = torch.where(grounded, -vy * 0.5, hover_todo)

    main = (hover_todo > torch.abs(angle_todo)) & (hover_todo > 0.05)
    action = torch.where(
        main, 2, torch.where(angle_todo < -0.05, 3, torch.where(angle_todo > 0.05, 1, 0))
    )
    return action.to(torch.int32)


def touchdown_states(env, params, n: int, generator: torch.Generator, frames: int = 30):
    """``n`` lander states after a short flight that starts just above the
    ground, for checks and measurements of the physics.

    Each fresh lander is moved down rigidly (hull, legs and solver state
    together) to 0.5-3 m over the terrain under it, given a speed of up to
    1 m/s sideways and 3 m/s down, then flies ``frames`` frames: the
    even-numbered landers with :func:`heuristic_action`, the others at
    random.  Landers that finish keep stepping, so the batch holds flights,
    touchdowns, landers on their legs and crashes.  Returns
    ``(obs, state)``."""
    device = generator.device

    def uniform(lo, hi):
        return torch.rand((n,), generator=generator, device=device) * (hi - lo) + lo

    obs, st = env.reset_env(generator, n, params)
    dy = _terrain_height(st.terrain, st.x) + uniform(0.5, 3.0) - st.y
    vx, vy = uniform(-1.0, 1.0), uniform(-3.0, 0.0)
    zero = torch.zeros_like(vx)

    def move(b):
        return dataclasses.replace(b, cy=b.cy + dy, vx=vx, vy=vy, w=zero)

    st = dataclasses.replace(
        st, y=st.y + dy, vx=vx, vy=vy, omega=zero,
        leg1_body=None if st.leg1_body is None else move(st.leg1_body),
        leg2_body=None if st.leg2_body is None else move(st.leg2_body),
    )
    obs = env.get_obs(st, params)
    heuristic = torch.arange(n, device=device) % 2 == 0
    for _ in range(frames):
        random = torch.randint(0, 4, (n,), generator=generator, device=device, dtype=torch.int32)
        actions = torch.where(heuristic, heuristic_action(obs), random)
        obs, st, *_ = env.step_env(generator, st, actions, params)
    return obs, st
