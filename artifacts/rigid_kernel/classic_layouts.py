"""A1, C1 and M1's vector entries at other block sizes, on one card.

    python3 artifacts/rigid_kernel/classic_layouts.py

The threads a block are the launcher's argument
(``ops/classic_kernels.py::THREADS``), so one build serves every layout.
On a flight's states (``measure.classic_step_inputs``) at the presets' N
(128 for Acrobot and MountainCar, 4096 for CartPole) and at 1024 and 8192,
prints the device µs a call (``measure.device_us``) of each env's vector
step (``VectorEnv._step`` without a pool, one launch) at 32, 64, 128 and
256 threads a block, in that order and again in reverse, with the lanes
whose result differs in any bit from the default layout's.  Needs one
CUDA GPU; imports nothing of JAX.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from deep_q_learning_tpu_torch import measure  # noqa: E402
from deep_q_learning_tpu_torch.envs import VectorEnv, make_env  # noqa: E402
from deep_q_learning_tpu_torch.ops import classic_kernels as ck  # noqa: E402

LAYOUTS = (32, 64, 128, 256)
NS = {"acrobot": (128, 1024, 8192), "cartpole": (1024, 4096, 8192),
      "mountain_car": (128, 1024, 8192)}


def main() -> int:
    card = measure.card_line()
    print(card)
    g = torch.Generator(device="cuda").manual_seed(7)
    for key, spec in ck.SPECS.items():
        env, _ = make_env(spec.env_id)
        params = measure.classic_params(env)
        default = ck.THREADS[key]
        for n in NS[key]:
            state, action, _ = measure.classic_step_inputs(env, params, n, g)
            draws = env.reset_draws(g, n)
            prev = torch.zeros((n, spec.obs), device="cuda")
            venv = VectorEnv(env, n, graphed=False)

            def call():
                out_obs, out_state, tr = venv._step(None, state, action, params, prev, None,
                                                    None, draws)
                return out_obs, out_state, tr.next_obs, tr.reward, tr.terminated, tr.truncated

            ck.THREADS[key] = default
            first = call()
            times, differ = {}, {}
            for threads in LAYOUTS + LAYOUTS[::-1]:
                ck.THREADS[key] = threads
                differ[threads] = measure.lanes_differ(first, call())
                times.setdefault(threads, []).append(measure.device_us(call))
            ck.THREADS[key] = default
            text = "; ".join(f"{t} threads {a:.2f}, {b:.2f} us ({differ[t]} lanes differ)"
                             for t, (a, b) in times.items())
            print(f"{key} vector step N={n}: {text} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
