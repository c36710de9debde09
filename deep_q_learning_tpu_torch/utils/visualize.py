"""Greedy rollouts, recorded and drawn (``deep_q_learning_tpu/utils/visualize.py``).

``record_trajectory`` runs one greedy episode on the network's device, from
a reset drawn from an explicit generator, and returns numpy arrays under
the JAX package's keys.  ``dump_trajectory`` writes them as an ``.npz``;
``plot_lander_flight`` draws a LunarLander flight path, and
``render_lander_animation`` an animated replay (``.gif`` or ``.mp4``).
matplotlib (and pillow for a ``.gif``) are imported when a figure is
drawn: where one is absent the function raises an ``ImportError`` that
names it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deep_q_learning_tpu_torch.utils.metrics import import_matplotlib

# steps between checks of "the episode ended" (each check reads the device)
_DONE_CHECK_EVERY = 32


@torch.no_grad()
def record_trajectory(
    env,
    env_params,
    network: torch.nn.Module,
    generator: torch.Generator,
    max_steps: Optional[int] = None,
    extras_fn: Optional[Callable] = None,
    static_fn: Optional[Callable] = None,
) -> Dict[str, Any]:
    """One greedy episode of ``env`` (one instance on ``generator``'s
    device): the reset, then every step, draws from ``generator``, and the
    greedy action needs no draw, so the same seed replays the episode.

    Returns obs (T, D) float32 (the observation each action was taken
    from), action (T,) int32, reward (T,) float32, done (T,) bool, and
    ``length`` and ``ret``, cut at the first termination or at
    ``max_steps`` (the env's episode limit if None).  ``extras_fn(state)``
    adds per-step channels ``extra_<k>`` from the state before each step,
    ``static_fn(state0)`` per-episode constants ``static_<k>``."""
    max_steps = max_steps or env_params.max_steps_in_episode
    obs, state = env.reset_env(generator, 1, env_params)
    static = static_fn(state) if static_fn is not None else {}
    steps = []
    ended = torch.zeros((1,), dtype=torch.bool, device=obs.device)
    for t in range(max_steps):
        action = torch.argmax(network(obs), dim=-1).to(torch.int32)
        extras = extras_fn(state) if extras_fn is not None else {}
        next_obs, state, reward, terminated, truncated = env.step_env(
            generator, state, action, env_params
        )
        done = terminated | truncated
        steps.append((obs, action, reward, done, extras))
        ended = ended | done
        obs = next_obs
        if (t + 1) % _DONE_CHECK_EVERY == 0 and bool(ended.all()):
            break
    stack = lambda i: torch.cat([s[i] for s in steps]).cpu().numpy()  # noqa: E731
    done = stack(3)
    length = int(np.argmax(done)) + 1 if done.any() else len(steps)
    reward = stack(2)[:length]
    out = {
        "obs": stack(0)[:length],
        "action": stack(1)[:length],
        "reward": reward,
        "done": done[:length],
        "length": length,
        "ret": float(reward.sum()),
    }
    for k in steps[0][4]:
        out[f"extra_{k}"] = torch.cat([s[4][k] for s in steps[:length]]).cpu().numpy()
    for k, v in static.items():
        out[f"static_{k}"] = v[0].cpu().numpy()
    return out


def lander_pose_extras(state) -> Dict[str, torch.Tensor]:
    """``extras_fn`` for LunarLander: the world-frame hull pose, and on the
    jointed engine each leg's (what the renderer draws)."""
    base = {"x": state.x, "y": state.y, "angle": state.angle}
    if state.leg1_body is not None:
        for i, leg in ((1, state.leg1_body), (2, state.leg2_body)):
            base[f"leg{i}_x"] = leg.cx
            base[f"leg{i}_y"] = leg.cy
            base[f"leg{i}_a"] = leg.a
    return base


def lander_static(state) -> Dict[str, torch.Tensor]:
    """``static_fn`` for LunarLander: the episode's terrain profile."""
    return {"terrain": state.terrain}


def dump_trajectory(path: str, traj: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **traj)
    return path


def plot_lander_flight(traj: Dict[str, Any], path: str) -> str:
    """Flight-path figure of a LunarLander trajectory: the x/y path colored
    by time, altitude, vertical speed and angle traces, the actions."""
    plt = import_matplotlib()
    obs = traj["obs"]
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(15, 4))
    t = np.arange(len(obs))
    sc = ax1.scatter(obs[:, 0], obs[:, 1], c=t, s=4, cmap="viridis")
    ax1.axhline(0.0, color="gray", lw=1)
    ax1.set_title(f"flight path (return {traj['ret']:.1f})")
    ax1.set_xlabel("x (helipad-relative)")
    ax1.set_ylabel("y")
    fig.colorbar(sc, ax=ax1, label="step")
    ax2.plot(t, obs[:, 1], label="altitude")
    ax2.plot(t, obs[:, 3], label="v_y")
    ax2.plot(t, obs[:, 4], label="angle")
    ax2.legend()
    ax2.grid(alpha=0.3)
    ax2.set_title("state traces")
    ax3.step(t, traj["action"], where="post", lw=0.8)
    ax3.set_yticks([0, 1, 2, 3], ["nop", "left", "main", "right"])
    ax3.set_title("actions")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_lander_animation(traj: Dict[str, Any], path: str, fps: int = 25, stride: int = 2) -> str:
    """Animated replay of a LunarLander trajectory recorded with
    ``extras_fn=lander_pose_extras, static_fn=lander_static``: a ``.mp4``
    where ffmpeg is available, else a ``.gif`` (pillow).  ``stride``
    subsamples the 50 fps frames (2 at 25 fps plays in real time).
    Returns the path written."""
    from deep_q_learning_tpu_torch.envs.lander_solver import HULL_VERTS, LEG_HH, LEG_HW
    from deep_q_learning_tpu_torch.envs.lunar_lander import CHUNKS, H, W

    if "extra_x" not in traj:
        raise ValueError(
            "trajectory lacks pose channels; record with "
            "extras_fn=lander_pose_extras, static_fn=lander_static"
        )
    plt = import_matplotlib()
    import matplotlib.animation as manim
    from matplotlib.patches import Polygon as MplPolygon

    if path.endswith(".mp4") and not manim.writers.is_available("ffmpeg"):
        path = path[:-4] + ".gif"
    if not path.endswith(".mp4"):
        try:
            import PIL  # noqa: F401  (matplotlib's gif writer)
        except ImportError as e:
            raise ImportError(f"pillow is needed to write {path} and is not installed ({e})") from e

    terrain = np.asarray(traj["static_terrain"])
    xs = np.linspace(0.0, W, CHUNKS)
    frames = list(range(0, len(traj["extra_x"]), max(1, stride)))

    fig, ax = plt.subplots(figsize=(6, 4), dpi=90)
    ax.set_xlim(0, W)
    ax.set_ylim(0, H)
    ax.set_aspect("equal")
    ax.fill_between(xs, 0.0, terrain, color="#555555")
    pad_x = W / 2
    ax.plot(
        [pad_x - W / (CHUNKS - 1), pad_x + W / (CHUNKS - 1)],
        [terrain[CHUNKS // 2]] * 2,
        color="#ffcc00",
        lw=2,
    )
    hull_patch = MplPolygon(np.zeros((len(HULL_VERTS), 2)), closed=True, color="#7a7aff")
    ax.add_patch(hull_patch)
    leg_patches = [MplPolygon(np.zeros((4, 2)), closed=True, color="#aa3333") for _ in range(2)]
    for lp in leg_patches:
        ax.add_patch(lp)
    (flame,) = ax.plot([], [], color="orange", lw=3)
    title = ax.set_title("")

    def rot2(a, pts):
        c, s = np.cos(a), np.sin(a)
        return pts @ np.array([[c, s], [-s, c]])

    leg_box = np.array([[-LEG_HW, -LEG_HH], [LEG_HW, -LEG_HH], [LEG_HW, LEG_HH], [-LEG_HW, LEG_HH]])
    hull_pts = np.asarray(HULL_VERTS)
    ret_so_far = np.cumsum(np.asarray(traj["reward"]))

    def draw(i):
        x, y, a = traj["extra_x"][i], traj["extra_y"][i], traj["extra_angle"][i]
        hull_patch.set_xy(rot2(a, hull_pts) + [x, y])
        if "extra_leg1_x" in traj:
            for j, lp in enumerate(leg_patches, start=1):
                lx, ly, la = (traj[f"extra_leg{j}_{k}"][i] for k in ("x", "y", "a"))
                lp.set_xy(rot2(la, leg_box) + [lx, ly])
        act = int(traj["action"][i])
        if act == 2:  # main engine: the plume under the hull
            tip = rot2(a, np.array([[0.0, -0.6], [0.0, -1.3]])) + [x, y]
            flame.set_data(tip[:, 0], tip[:, 1])
        else:
            flame.set_data([], [])
        title.set_text(
            f"step {i}  action {['nop', 'left', 'main', 'right'][act]}  "
            f"return {ret_so_far[i]:.1f}"
        )
        return [hull_patch, *leg_patches, flame, title]

    anim = manim.FuncAnimation(fig, draw, frames=frames, blit=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    anim.save(path, writer="ffmpeg" if path.endswith(".mp4") else "pillow", fps=fps)
    plt.close(fig)
    return path
