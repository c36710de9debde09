"""Cross-engine policy transfer (``examples/policy_transfer.py``): greedy
rollouts of the same network on the port's lander and on gymnasium's Box2D
lander.

If a policy trained on the port's env scores the same when replayed on
Box2D, the envs present the same task; a gap shows where the port's env is
easier or harder.  The networks are the ``member_*.pickle`` files that
``examples/seed_robustness_population.py --save-params`` writes (numpy
flax parameter trees, written by this repo's own example), loaded through
``QNetwork.from_flax_params``:

  * the port's env: ``algos/evaluate.build_evaluator`` over
    ``VectorEnv(env, episodes)`` on ``--device``;
  * Box2D: ``make_host_env("box2d")``, one env on the host, the network's
    greedy action read back from the device each step.

    python -m deep_q_learning_tpu_torch.examples.policy_transfer \
        --params-dir runs/ref_parity_params --preset lunar_ref_parity \
        --episodes 20 --out artifacts/policy_transfer_torch.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params-dir", required=True)
    ap.add_argument("--preset", default="lunar_ref_parity")
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/policy_transfer_torch.json")
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from deep_q_learning_tpu_torch.__main__ import build_config
    from deep_q_learning_tpu_torch.algos.evaluate import build_evaluator
    from deep_q_learning_tpu_torch.compat.host_env import make_host_env
    from deep_q_learning_tpu_torch.envs import VectorEnv, make_env
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.train import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(args.preset, args.set)
    env, env_params = make_env(
        cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
        param_overrides=cfg.env_param_overrides(),
    )
    evaluator = build_evaluator(VectorEnv(env, args.episodes), env_params,
                                env_params.max_steps_in_episode)
    max_steps = cfg.max_steps_in_episode or 1000
    genv, _, _ = make_host_env(
        "box2d",
        env_id=cfg.env_id,
        max_steps=max_steps,
        time_fraction=cfg.time_fraction_obs,
        seed=args.seed,
        device=device,
    )

    results = []
    for path in sorted(glob.glob(os.path.join(args.params_dir, "member_*.pickle"))):
        with open(path, "rb") as f:
            net = QNetwork.from_flax_params(pickle.load(f), device=device)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        torch_rets = evaluator(net, generator).returns.cpu().numpy()

        box_rets = []
        for ep in range(args.episodes):
            obs, _ = genv.reset(seed=args.seed * 10_000 + ep)
            ret = 0.0
            # the host env is unwrapped: truncation is the caller's job,
            # exactly as in the reference (q_agent.py:179-180)
            for _ in range(max_steps):
                with torch.no_grad():
                    x = torch.from_numpy(np.asarray(obs, np.float32)).to(device)
                    a = int(torch.argmax(net(x[None]), dim=-1)[0])
                obs, r, term, trunc, _ = genv.step(a)
                ret += float(r)
                if term or trunc:
                    break
            box_rets.append(ret)
        results.append(
            {
                "member": os.path.basename(path),
                "torch_eval_mean": round(float(torch_rets.mean()), 2),
                "torch_land_rate": round(float((torch_rets > 200).mean()), 2),
                "box2d_eval_mean": round(float(np.mean(box_rets)), 2),
                "box2d_land_rate": round(float(np.mean([r > 200 for r in box_rets])), 2),
                "torch_returns": [round(float(r), 1) for r in torch_rets],
                "box2d_returns": [round(r, 1) for r in box_rets],
            }
        )
        print(json.dumps({k: results[-1][k] for k in
                          ("member", "torch_eval_mean", "box2d_eval_mean",
                           "torch_land_rate", "box2d_land_rate")}), flush=True)

    summary = {
        "preset": args.preset,
        "episodes_per_engine": args.episodes,
        "device": str(device),
        "members": results,
        "mean_gap_torch_minus_box2d": round(
            float(
                np.mean([m["torch_eval_mean"] for m in results])
                - np.mean([m["box2d_eval_mean"] for m in results])
            ),
            2,
        ),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", args.out)
    return summary


if __name__ == "__main__":
    main()
