"""The operations of one rigid `lunar_per` vector step outside the lander's
own step (R1 on the card): the auto-reset's selects of `VectorEnv._step`
and `TimeFractionObs`' time feature, which stay plain PyTorch ops, counted
by name with a dispatch mode on the CPU (the same ops the card runs; a view
launches no kernel).

    python3 artifacts/rigid_kernel/step_ops.py

Counts operations, not device time: runs on the CPU, no GPU needed.
"""

import collections
import dataclasses
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs, VectorEnv  # noqa: E402
from deep_q_learning_tpu_torch.envs import lunar_lander as ll  # noqa: E402

VIEWS = ("view", "unsqueeze", "slice", "select", "expand", "alias")


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    env = TimeFractionObs(LunarLander())
    params = dataclasses.replace(env.default_params(), jointed=False)
    venv = VectorEnv(env, 128, graphed=False)
    g = torch.Generator().manual_seed(0)
    obs, states = venv.reset(g, params)
    pool = venv.fresh_pool(g, params)
    actions = torch.zeros(128, dtype=torch.int32)
    draws = env.step_draws(g, 128)
    inner, outer = Count(), Count()
    step = ll.LunarLander.step_env_reference

    def counted(self, *args, **kw):
        with inner:
            return step(self, *args, **kw)

    ll.LunarLander.step_env_reference = counted
    try:
        with outer:
            venv._step(None, states, actions, params, obs, pool, draws)
    finally:
        ll.LunarLander.step_env_reference = step
    around = outer.ops - inner.ops
    kernels = {k: v for k, v in around.items() if k not in VIEWS}
    print(f"a vector step of 128 rigid landers: {sum(outer.ops.values())} operations, "
          f"{sum(inner.ops.values())} of them the lander's step (one R1 launch on the card); "
          f"around it {sum(around.values())}: {dict(around)}; "
          f"{sum(kernels.values())} that launch a kernel: {kernels}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
