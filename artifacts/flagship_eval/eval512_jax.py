"""The JAX package's ``lunar_jointed_per``, trained on the CPU until it
solves, then each solving policy evaluated greedily over 512 episodes with
the statistics of ``eval512.py`` (the port's flagship on the card).

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 artifacts/flagship_eval/eval512_jax.py OUT.json 0 1 2

One seed at a time, in this process, through the JAX package's public API:
``deep_q_learning_tpu.train.Trainer`` on the preset with ``use_pallas=False``
(the plain TD loss; a Pallas kernel on the CPU runs in interpret mode), the
solve decided at its log points (every 10 supersteps, as ``solves.py`` and
the earlier ``lunar_jointed_solve_cpu*.json`` runs decide it).  The policy
at the solve is evaluated by the package's ``build_evaluator`` widened to
512 jointed landers in lockstep, one greedy episode each, from the reset
pool of ``PRNGKey(0)``.  For each seed: the solve's env step, window and
training seconds; the mean, standard deviation, median and minimum of the
returns, the share of returns below 0 and below 200, the mean episode
length and the count of episodes that ran to the 1,000-frame limit."""
import dataclasses
import json
import os
import platform
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from deep_q_learning_tpu.algos.evaluate import build_evaluator  # noqa: E402
from deep_q_learning_tpu.config import lunar_jointed_per  # noqa: E402
from deep_q_learning_tpu.envs.base import VectorEnv  # noqa: E402
from deep_q_learning_tpu.train import Trainer  # noqa: E402

EPISODES = 512
MAX_ENV_STEPS = 10_000_000
jax.config.update("jax_platforms", "cpu")
out, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
cfg = dataclasses.replace(lunar_jointed_per(), use_pallas=False)
records = {"host": f"{platform.processor() or platform.machine()}, {os.cpu_count()} CPUs, "
                   f"jax {jax.__version__} on {jax.devices()[0].platform}",
           "overrides": ["use_pallas=False"], "episodes": EPISODES, "seeds": {}}
for seed in seeds:
    tr = Trainer(cfg).init(seed=seed)
    t0 = time.time()
    result = tr.train(max_env_steps=MAX_ENV_STEPS, log_every=10, verbose=False)
    train_s = time.time() - t0
    evaluate = jax.jit(build_evaluator(VectorEnv(tr.env, EPISODES), tr.env_params, tr.network,
                                       tr.env_params.max_steps_in_episode))
    t0 = time.time()
    ev = evaluate(tr.runner.train.params, jax.random.PRNGKey(0))
    ret, length = np.asarray(ev.returns), np.asarray(ev.lengths)
    rec = {
        "solved": bool(result.solved), "checkpoint_env_steps": int(result.env_steps),
        "window": float(result.final_window_mean), "train_s": round(train_s, 1),
        "eval_s": round(time.time() - t0, 1),
        "mean": float(ret.mean()), "std": float(ret.std()), "median": float(np.median(ret)),
        "min": float(ret.min()), "below_0": float((ret < 0).mean()),
        "below_200": float((ret < 200).mean()), "mean_length": float(length.mean()),
        "at_frame_limit": int((length >= tr.env_params.max_steps_in_episode).sum()),
    }
    records["seeds"][str(seed)] = rec
    print(seed, json.dumps(rec), flush=True)
    with open(out, "w") as f:  # after each seed, so a cut run keeps the seeds it finished
        json.dump(records, f, indent=1)
