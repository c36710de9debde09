"""Train a LunarLander preset, write the learner in the reference's pickle
format and record greedy rollouts (``examples/train_lunar_lander.py``, the
reference's training script: train to the solve, pickle the parameters,
render 10 greedy episodes).

    python -m deep_q_learning_tpu_torch.examples.train_lunar_lander \
        [--steps 60000000] [--preset lunar_per] [--workdir runs/lunar] \
        [--seed 0] [--rollouts 10] [--device cuda]

``Trainer(cfg, device).init().train(--steps, log_every=20)``, then into
``--workdir``: ``curves.png`` (the window and loss curves), the learner as
``ref_format/params.pickle`` and ``ref_format/opt_state.pickle`` (the
pair the JAX package's ``load_params_pickle`` reads), a checkpoint at a
solve, and for each rollout ``i`` (its reset and steps drawn from seed
1000 + i) ``rollout_<i>.npz`` and a flight figure ``rollout_<i>.png``.  A
figure that cannot be drawn (no matplotlib) is reported on its own line
and the rest is still written.  ``--aot-cache`` is refused, as the CLI
refuses it.  The port adds ``--log-every`` (supersteps between log points,
where the solve and the budget are decided; 20 as the JAX script), ``--set
FIELD=VALUE`` (config overrides, as the CLI's) and ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

PRESETS = ("lunar_per", "lunar_dddqn_vector", "lunar_ref_parity")


def draw(fn, *args) -> Optional[str]:
    """``fn(*args)``, the path it wrote; a missing matplotlib is reported
    and gives None."""
    try:
        return fn(*args)
    except ImportError as e:
        print(f"did not write {args[-1]}: {e}")
        return None


def main(argv: Optional[List[str]] = None):
    """Train, write the pair and the rollouts; returns the ``Trainer``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60_000_000)
    ap.add_argument("--preset", default="lunar_per", choices=PRESETS)
    ap.add_argument("--workdir", default="runs/lunar")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rollouts", type=int, default=10)  # the reference renders 10
    ap.add_argument("--log-every", type=int, default=20, metavar="SUPERSTEPS")
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--aot-cache", default=None, help="not ported, by design")
    args = ap.parse_args(argv)

    from deep_q_learning_tpu_torch.__main__ import _not_ported, build_config

    if args.aot_cache:
        raise _not_ported("--aot-cache (a TPU-tunnel workaround)", "'not ported, by design'")

    import numpy as np
    import torch

    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import visualize as vis
    from deep_q_learning_tpu_torch.utils.metrics import plot_history

    cfg = dataclasses.replace(build_config(args.preset, args.set), seed=args.seed)
    trainer = Trainer(cfg, device=args.device, workdir=args.workdir).init()
    result = trainer.train(max_env_steps=args.steps, log_every=args.log_every)
    print(
        f"solved={result.solved} env_steps={result.env_steps} "
        f"episodes={result.episodes} window={result.final_window_mean:.1f} "
        f"wall={result.wall_time_s:.1f}s"
    )
    draw(plot_history, result.history, f"{args.workdir}/curves.png")
    trainer.save_pickle_compat(f"{args.workdir}/ref_format")

    # greedy rollouts (the reference renders 10 episodes)
    rets = []
    for i in range(args.rollouts):
        traj = vis.record_trajectory(
            trainer.env, trainer.env_params, trainer.runner.train.online,
            torch.Generator(device=trainer.device).manual_seed(1000 + i),
            extras_fn=vis.lander_pose_extras, static_fn=vis.lander_static,
        )
        rets.append(traj["ret"])
        vis.dump_trajectory(f"{args.workdir}/rollout_{i}.npz", traj)
        draw(vis.plot_lander_flight, traj, f"{args.workdir}/rollout_{i}.png")
    if rets:
        print(f"greedy rollout returns: mean={np.mean(rets):.1f} {['%.0f' % r for r in rets]}")
    return trainer


if __name__ == "__main__":
    main()
