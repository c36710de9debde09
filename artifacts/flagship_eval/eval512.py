"""Greedy evaluation of each solving checkpoint of ``lunar_jointed_per``'s
seed runs over 512 episodes, on one CUDA GPU: one greedy episode in each of
512 jointed landers, in lockstep, from the seed-0 reset pool (the
evaluator of ``Trainer.evaluate``, widened to 512 envs).

    env PYTHONPATH=. python3 artifacts/flagship_eval/eval512.py OUT.json SEED=WORKDIR ...

Each WORKDIR is a ``solves.py`` run's ``P_seedS.workdir``, whose newest
checkpoint (``--keep-newest``) is the one written at the solve.  For each
seed: the checkpoint's env step, the mean, standard deviation, median and
minimum of the returns, the share of returns below 0 and below 200, the
mean episode length and the count of episodes that ran to the 1,000-frame
limit (hovering landers)."""
import json
import subprocess
import sys

import numpy as np
import torch

from deep_q_learning_tpu_torch.algos.evaluate import build_evaluator
from deep_q_learning_tpu_torch.config import lunar_jointed_per
from deep_q_learning_tpu_torch.envs.base import VectorEnv
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils.checkpoint import latest_step

EPISODES = 512
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip()
out, runs = sys.argv[1], dict(a.split("=", 1) for a in sys.argv[2:])
cfg = lunar_jointed_per()
records = {"card": card, "episodes": EPISODES, "seeds": {}}
for seed, workdir in runs.items():
    tr = Trainer(cfg, device="cuda", workdir=workdir).restore()
    evaluate = build_evaluator(VectorEnv(tr.env, EPISODES), tr.env_params,
                               tr.env_params.max_steps_in_episode)
    ev = evaluate(tr.runner.train.online, torch.Generator(device="cuda").manual_seed(0))
    ret, length, _ = (x.cpu().numpy() for x in ev)
    rec = {
        "checkpoint_env_steps": latest_step(workdir),
        "mean": float(ret.mean()), "std": float(ret.std()), "median": float(np.median(ret)),
        "min": float(ret.min()), "below_0": float((ret < 0).mean()),
        "below_200": float((ret < 200).mean()), "mean_length": float(length.mean()),
        "at_frame_limit": int((length >= tr.env_params.max_steps_in_episode).sum()),
    }
    records["seeds"][seed] = rec
    print(seed, json.dumps(rec), card, flush=True)
json.dump(records, open(out, "w"), indent=1)
