"""deep_q_learning_tpu_torch — the PyTorch/CUDA port of ``deep_q_learning_tpu``.

The JAX package beside it is the reference: module paths and names mirror
it, and the tests hold each ported function against its JAX counterpart on
the same inputs.  This package imports torch and numpy, never jax, flax,
optax or any module of the JAX package.

What is ported so far is single-device training of every preset: the
classic-control envs (CartPole, Acrobot, MountainCar, with uniform replay
and a per-frame auto-reset draw) and LunarLander on both engines, the
jointed 3-body lander stepped by the Box2D sequential-impulse solver
(``lunar_jointed_per``, ``lunar_jointed_scaled``;
``envs/lander_solver.py``) and the rigid one (``lunar_per``,
``lunar_per_scaled``), the heuristic controller, the dueling Q-network,
uniform and prioritized n-step replay with the hand-written CUDA
slot-sampling kernel (``ops/sample_kernels.py``, ``csrc/per_sample.cu``),
the double-DQN learner with the hand-written CUDA TD+huber kernel
(``ops/td_kernels.py``, ``csrc/td_loss.cu``), the superstep, the
evaluator, the ``Trainer`` with full-runner checkpoints, the command
line (``python -m deep_q_learning_tpu_torch``), population training and the
GP-UCB search, runs over ranks, the bf16 trunk (``compute_dtype``), and
the host-compatibility path (``compat/``: the reference agent's host loop
over any Gym-protocol env, on the native ring buffer of ``native/``).
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

import os as _os

if _os.environ.get("DQL_PRNG", "threefry") == "rbg":
    raise RuntimeError(
        "DQL_PRNG=rbg selects the TPU's hardware PRNG in the JAX package; the "
        "PyTorch port draws from torch.Generator and has no such switch. "
        "Unset DQL_PRNG to import deep_q_learning_tpu_torch."
    )

from deep_q_learning_tpu_torch.config import DQNConfig, PRESETS  # noqa: E402
