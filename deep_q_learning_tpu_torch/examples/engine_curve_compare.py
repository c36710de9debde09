"""Engine-fidelity experiment: DQN learning curves, Box2D vs the port's
lander (``examples/engine_curve_compare.py``).

The same algorithm (``compat/host_loop.HostAgent``: the reference's host
loop with the port's update step on ``--device``) with the same
hyperparameters on

  * gymnasium's Box2D LunarLander (``--engine box2d``, the reference's own
    task, stepped on the host), and
  * the port's env (``--engine torch``, ``compat/host_env.TorchHostEnv``:
    one env on the device),

so the only varying factor is the physics engine.  Per-episode curves go
to JSONL: a ``meta`` line, one row per episode and a ``final`` line, which
``summarize_engine_curves`` aggregates.

    python -m deep_q_learning_tpu_torch.examples.engine_curve_compare \
        --engine box2d --seed 0 --episodes 2000 \
        --out artifacts/curves/curve_box2d_s0.jsonl
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=["box2d", "torch"], required=True)
    ap.add_argument("--env", default="LunarLander-v2")
    ap.add_argument("--preset", default="lunar_ref_parity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--episodes", type=int, default=2000)
    ap.add_argument("--max-total-steps", type=int, default=1_500_000)
    ap.add_argument("--out", required=True)
    ap.add_argument("--eval-episodes", type=int, default=20)
    ap.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="override any DQNConfig field (same syntax as the CLI)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    from deep_q_learning_tpu_torch.__main__ import build_config
    from deep_q_learning_tpu_torch.compat.host_env import make_host_env
    from deep_q_learning_tpu_torch.compat.host_loop import HostAgent

    cfg = build_config(args.preset, args.set)
    cfg = dataclasses.replace(cfg, seed=args.seed)

    env, obs_dim, num_actions = make_host_env(
        args.engine,
        env_id=args.env,
        max_steps=cfg.max_steps_in_episode or 1000,
        time_fraction=cfg.time_fraction_obs,
        seed=args.seed,
        device=args.device,
    )
    agent = HostAgent(env, obs_dim, num_actions, cfg, device=args.device)

    t0 = time.monotonic()
    with open(args.out, "w", buffering=1) as fh:
        meta = {
            "engine": args.engine,
            "env": args.env,
            "preset": args.preset,
            "seed": args.seed,
            "overrides": args.set,
            "obs_dim": obs_dim,
        }
        fh.write(json.dumps({"meta": meta}) + "\n")

        def on_episode(ep, ret, steps, gsteps, window, eps):
            fh.write(
                json.dumps(
                    {
                        "episode": ep,
                        "return": round(ret, 3),
                        "steps": steps,
                        "global_steps": gsteps,
                        "window": round(window, 3),
                        "eps": round(eps, 4),
                        "wall": round(time.monotonic() - t0, 1),
                    }
                )
                + "\n"
            )

        solved, episodes = agent.training(
            max_episodes=args.episodes,
            verbose=True,
            on_episode=on_episode,
            max_total_steps=args.max_total_steps,
        )
        eval_returns = agent.evaluate(episodes=args.eval_episodes)
        final = {
            "final": {
                "solved": solved,
                "episodes": episodes,
                "global_steps": agent._global_steps,
                "wall_s": round(time.monotonic() - t0, 1),
                "eval_returns": [round(r, 2) for r in eval_returns],
                "eval_mean": round(sum(eval_returns) / len(eval_returns), 2),
            }
        }
        fh.write(json.dumps(final) + "\n")
    print("FINAL", json.dumps(final))
    return final


if __name__ == "__main__":
    main()
