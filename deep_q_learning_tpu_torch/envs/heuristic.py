"""Heuristic LunarLander controller (``deep_q_learning_tpu/envs/heuristic.py``),
batched, and the flights of landers that it drives for checks and
measurements of the physics.

The controller is the classic open-source demo: target an angle
proportional to the horizontal offset and speed, a hover height
proportional to |x|, and fire the engine whose correction is most needed.
"""

from __future__ import annotations

import dataclasses

import torch

from deep_q_learning_tpu_torch.envs import lunar_lander as ll
from deep_q_learning_tpu_torch.envs.base import tree_where
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


def _cat_states(trees):
    """States (dataclasses of ``(N, ...)`` tensors) joined along the env axis."""
    first = trees[0]
    if first is None or isinstance(first, torch.Tensor):
        return None if first is None else torch.cat(trees)
    return dataclasses.replace(first, **{
        f.name: _cat_states([getattr(t, f.name) for t in trees])
        for f in dataclasses.fields(first)})


def solver_inputs(env, params, n: int, generator: torch.Generator, envs: int = 128,
                  frames: int = 60):
    """``lander_solver.assembly_step`` inputs of ``n`` lanes, for checks and
    measurements of the solver: pre-step states of ``envs`` jointed landers
    along a :func:`touchdown_states` flight of ``frames`` frames (flight,
    touchdowns, landers on one leg and on both, block contacts, joint
    limits, crashes; a lander is taken until it finishes), ``n`` of them
    drawn at random, the hull at its COM and wind-like forces on half the
    lanes.  Returns ``(hull, leg1, leg2, terrain, fx, fy, torque, gravity,
    acc)``: ``assembly_step``'s positional arguments, then ``acc``."""
    from deep_q_learning_tpu_torch.envs import lander_solver as ls
    from deep_q_learning_tpu_torch.envs.graphed import tree_map

    device = generator.device
    obs, st = touchdown_states(env, params, envs, generator, frames=0)
    heuristic = torch.arange(envs, device=device) % 2 == 0
    alive = torch.ones(envs, dtype=torch.bool, device=device)
    kept = []
    for _ in range(frames):
        kept.append(tree_map(lambda x: x[alive], st))
        random = torch.randint(0, 4, (envs,), generator=generator, device=device,
                               dtype=torch.int32)
        actions = torch.where(heuristic, heuristic_action(obs), random)
        obs, st, _, terminated, truncated = env.step_env(generator, st, actions, params)
        alive &= ~(terminated | truncated)
    st = _cat_states(kept)
    total = st.x.shape[0]
    lanes = torch.randperm(total, generator=generator, device=device)[:n]
    if total < n:
        lanes = torch.randint(0, total, (n,), generator=generator, device=device)
    st = tree_map(lambda x: x[lanes].contiguous(), st)
    hx, hy = ls.hull_com(st.x, st.y, st.angle)
    hull = ls.Body(hx, hy, st.angle, st.vx, st.vy, st.omega)

    def uniform(lo, hi):
        return torch.rand((n,), generator=generator, device=device) * (hi - lo) + lo

    wind = torch.rand((n,), generator=generator, device=device) < 0.5
    fx = torch.where(wind, uniform(-15.0, 15.0), 0.0)
    torque = torch.where(wind, uniform(-1.5, 1.5), 0.0)
    return (hull, st.leg1_body, st.leg2_body, st.terrain.contiguous(), fx,
            torch.zeros_like(fx), torque, params.gravity, st.solver_acc)


def lander_step_inputs(env, params, n: int, generator: torch.Generator, envs: int = 1024,
                       frames: int = 300):
    """``LunarLander.step_env`` inputs of ``n`` lanes, for checks and
    measurements of the lander's step (R1 in rigid mode, J1 in jointed
    mode): the pre-step states,
    actions and dispersion draws of ``envs`` landers over ``frames``
    frames, half of them started from fresh resets and half just above the
    ground (:func:`touchdown_states`), the even-numbered flown by
    :func:`heuristic_action` and the others at random; a lander that
    finishes restarts from a fresh reset.  So the states hold flight,
    touchdowns on one leg and on both, landers coming to rest, crashes,
    landers leaving the screen and, where ``params.max_steps_in_episode`` is
    below ``frames``, truncations (:func:`rigid_cover` and
    :func:`jointed_cover` count them).  Of
    the ``n`` lanes taken, the steps that end an episode come first, as
    many as there are, then others at random, all in a random order;
    returns ``(state, action, draws)``."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_map

    device = generator.device
    _, top = env.reset_env(generator, envs, params)
    _, low = touchdown_states(env, params, envs, generator, frames=0)
    st = tree_where(torch.arange(envs, device=device) < envs // 2, top, low)
    obs = env.get_obs(st, params)
    heuristic = torch.arange(envs, device=device) % 2 == 0
    kept = []
    for _ in range(frames):
        random = torch.randint(0, 4, (envs,), generator=generator, device=device,
                               dtype=torch.int32)
        actions = torch.where(heuristic, heuristic_action(obs), random)
        draws = env.step_draws(generator, envs)
        obs, nxt, _, terminated, truncated = env.step_env(None, st, actions, params, draws)
        done = terminated | truncated
        kept.append((st, actions, draws, done))
        fresh_obs, fresh = env.reset_env(generator, envs, params)
        st, obs = tree_where(done, fresh, nxt), tree_where(done, fresh_obs, obs)
    st, actions, draws, ends = (_cat_states([k[i] for k in kept]) for i in range(4))
    order = torch.randperm(frames * envs, generator=generator, device=device)
    first = torch.argsort((~ends[order]).to(torch.int8), stable=True)
    lanes = order[first[:n]]
    lanes = lanes[torch.randperm(lanes.shape[0], generator=generator, device=device)]
    return tree_map(lambda x: x[lanes].contiguous(), (st, actions, draws))


def rigid_cover(env, params, state, action, draws) -> dict:
    """What a rigid step from these inputs meets, from the plain version:
    the lanes in flight, on one leg and on both after the step, the hull's
    corners hitting the ground, a leg's normal impulse over ``J_CRASH``
    without a hull hit, the lander leaving the screen, coming to rest and
    reaching the episode's limit; with the wind on, the airborne lanes it
    pushes.  ``{name: (N,) bool}``."""
    obs, new, reward, _, truncated = env.step_env_reference(None, state, action, params, draws)
    _, game_over, _ = env._physics_step(state, action, params,
                                        draws / ll.SCALE * params.dispersion_scale)
    cos_n, sin_n = torch.cos(new.angle), torch.sin(new.angle)
    hull_hit = torch.zeros_like(new.leg1)
    for bx in ll.HULL_BOTTOM[:2]:
        by = ll.HULL_BOTTOM[2]
        hx = new.x + bx * cos_n - by * sin_n
        hy = new.y + bx * sin_n + by * cos_n
        hull_hit = hull_hit | (hy <= _terrain_height(new.terrain, hx) + 0.01)
    cover = {"flight": ~new.leg1 & ~new.leg2, "one leg": new.leg1 ^ new.leg2,
             "two legs": new.leg1 & new.leg2, "hull hit": hull_hit,
             "overload": game_over & ~hull_hit, "off screen": obs[:, 0].abs() >= 1.0,
             "rest": reward == 100.0, "truncated": truncated}
    if params.enable_wind:
        cover["wind"] = ~(state.leg1 | state.leg2)
    return cover


def jointed_cover(env, params, state, action, draws) -> dict:
    """What a jointed step from these inputs meets, from the plain version:
    the lanes in flight, on one leg and on both after the step, a joint at
    its limit, the hull hitting the ground, the lander leaving the screen,
    asleep, coming to rest and reaching the episode's limit; with the wind
    on, the airborne lanes it pushes.  ``{name: (N,) bool}``."""
    obs, new, reward, _, truncated = env.step_env_reference(None, state, action, params, draws)
    off = obs[:, 0].abs() >= 1.0
    acc = new.solver_acc
    cover = {"flight": ~new.leg1 & ~new.leg2, "one leg": new.leg1 ^ new.leg2,
             "two legs": new.leg1 & new.leg2, "joint limit": (acc.s1 != 0) | (acc.s2 != 0),
             "hull hit": (reward == -100.0) & ~off, "off screen": off, "asleep": new.sleep > 0,
             "rest": reward == 100.0, "truncated": truncated}
    if params.enable_wind:
        cover["wind"] = ~(state.leg1 | state.leg2)
    return cover
