"""Evaluate a checkpoint with the greedy policy and draw flight figures
(``examples/evaluate_checkpoint.py``, the reference's post-training phase:
load the pickled parameters, render greedy episodes).

    python -m deep_q_learning_tpu_torch.examples.evaluate_checkpoint \
        --ckpt runs/lunar/ref_format [--env LunarLander-v2] [--episodes 10] \
        [--out runs/eval] [--seed 0] [--device cuda]

``--ckpt`` is either the reference's pickle pair (a directory holding
``params.pickle`` and ``opt_state.pickle``, as ``train_lunar_lander`` or
the JAX package writes it, e.g. ``artifacts/lunar_ref_format``) or a port
run directory (``Trainer.save``'s checkpoints beside ``config.json``, read
through ``Trainer.restore``).  ``--episodes`` greedy episodes run at once
through ``build_evaluator``; one line gives their mean, min, max and mean
length.  For ``LunarLander-v2``, 3 more greedy episodes (seeds 500 + i)
are drawn as flight figures into ``--out``; without matplotlib one line
says so.

The network is the pair's (or ``lunar_per``'s, for a run directory), and
the env is ``lunar_per``'s: the rigid lander the preset trains on.  ``--set
FIELD=VALUE`` overrides ``lunar_per``'s fields for both, as the CLI's
``--set``; the JAX script's env is ``make_env``'s default lander, the
jointed engine at gym's iterations (``--set lander_engine=jointed --set
lander_vel_iters=180 --set lander_pos_iters=60`` here).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def load_network(ckpt: str, cfg, device):
    """The greedy network of ``ckpt``: a pickle pair's parameters, or the
    online network of a run directory's latest checkpoint."""
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt_io

    if os.path.exists(os.path.join(ckpt, "params.pickle")):
        params, _ = ckpt_io.load_params_pickle(ckpt)
        return QNetwork.from_flax_params(params, device=device)
    return Trainer(cfg, device=device, workdir=ckpt).restore().runner.train.online


def main(argv: Optional[List[str]] = None) -> dict:
    """Evaluate and draw; returns the returns and lengths, the mean and the
    figures written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--env", default="LunarLander-v2")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--out", default="runs/eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from deep_q_learning_tpu_torch.__main__ import build_config
    from deep_q_learning_tpu_torch.algos import build_evaluator
    from deep_q_learning_tpu_torch.envs import VectorEnv, make_env
    from deep_q_learning_tpu_torch.train import resolve_device, set_matmul_precision
    from deep_q_learning_tpu_torch.utils.metrics import import_matplotlib
    from deep_q_learning_tpu_torch.utils.visualize import plot_lander_flight, record_trajectory

    device = resolve_device(args.device)
    cfg = build_config("lunar_per", args.set)
    set_matmul_precision(cfg)
    env, env_params = make_env(args.env, cfg.time_fraction_obs, cfg.max_steps_in_episode,
                               param_overrides=cfg.env_param_overrides())
    network = load_network(args.ckpt, cfg, device)

    evaluate = build_evaluator(VectorEnv(env, args.episodes), env_params,
                               env_params.max_steps_in_episode)
    ev = evaluate(network, torch.Generator(device=device).manual_seed(args.seed))
    rets, lengths = ev.returns.cpu().numpy(), ev.lengths.cpu().numpy()
    print(
        f"eval over {args.episodes} greedy episodes: mean={rets.mean():.1f} "
        f"min={rets.min():.1f} max={rets.max():.1f} "
        f"(lengths {lengths.mean():.0f} avg)"
    )
    figures = []
    if args.env == "LunarLander-v2":
        try:
            import_matplotlib()
        except ImportError as e:
            print(f"no flight-path figures: {e}")
        else:
            os.makedirs(args.out, exist_ok=True)
            for i in range(min(3, args.episodes)):
                traj = record_trajectory(
                    env, env_params, network,
                    torch.Generator(device=device).manual_seed(500 + i),
                )
                figures.append(plot_lander_flight(traj, f"{args.out}/eval_rollout_{i}.png"))
            print(f"flight-path figures -> {args.out}/")
    return {"returns": rets.tolist(), "lengths": lengths.tolist(),
            "mean": float(np.mean(rets)), "figures": figures}


if __name__ == "__main__":
    main()
