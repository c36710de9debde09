"""Steady supersteps of another checkout of the port (the parent commit) and
of this tree on one card, each in a process of its own, in turns:
``measure.profile_superstep`` of ``lunar_per`` and ``lunar_per_scaled``
(1024 landers), and of the jointed ``lunar_jointed_per`` and
``lunar_jointed_scaled`` (1024 landers), and of the classic
``cartpole_vector``, ``acrobot_vector`` and ``mountain_car_vector``, and
``measure.profile_population`` of ``lunar_per`` with 8 members and the PER
slot kernel.  Each prints its traced superstep (host
launches a vector step, the kernels on the device, the busy share), two
unprofiled supersteps (env-steps/s), each graph's replay alone on the
device with its kernels, and the superstep graph's nodes.

    git archive <parent> deep_q_learning_tpu_torch | tar -x -C build/parent
    python3 artifacts/rigid_kernel/turns.py --parent build/parent \\
        [--order parent,tree,tree,parent] [--what lunar_per,lunar_per_scaled,population]
        [--what lunar_jointed_per,lunar_jointed_scaled]
        [--what cartpole_vector,acrobot_vector,mountain_car_vector]

Needs one CUDA GPU; imports nothing of JAX.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROFILES = {
    "lunar_per": "m.profile_superstep(build_config('lunar_per', []), card)",
    "lunar_per_scaled": "m.profile_superstep(build_config('lunar_per_scaled', []), card)",
    "population": "m.profile_population(build_config('lunar_per', "
                  "['use_pallas_sampler=true']), 8, card)",
    "lunar_jointed_per": "m.profile_superstep(build_config('lunar_jointed_per', []), card)",
    "lunar_jointed_scaled": "m.profile_superstep(build_config('lunar_jointed_scaled', []), card)",
    **{preset: f"m.profile_superstep(build_config('{preset}', []), card)"
       for preset in ("cartpole_vector", "acrobot_vector", "mountain_car_vector")},
}
PRELUDE = ("import torch; from deep_q_learning_tpu_torch import measure as m; "
           "from deep_q_learning_tpu_torch.__main__ import build_config; "
           "torch.backends.cuda.matmul.allow_tf32 = False; card = m.card_line(); ")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--order", default="parent,tree,tree,parent")
    ap.add_argument("--what", default="lunar_per,lunar_per_scaled,population")
    args = ap.parse_args()
    for what in args.what.split(","):
        for which in args.order.split(","):
            checkout = args.parent.resolve() if which == "parent" else ROOT
            print(f"== {what}, {which}", flush=True)
            subprocess.run([sys.executable, "-c", PRELUDE + PROFILES[what]], cwd=checkout,
                           env=dict(os.environ, PYTHONPATH=str(checkout)), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
