"""J1 of other checkouts of the port against this tree's, in turns on one card.

    python3 artifacts/rigid_kernel/j1_variants.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding ``deep_q_learning_tpu_torch/csrc`` and
``deep_q_learning_tpu_torch/ops/{jointed,solver}_kernels.py``: the parent
commit unpacked with ``git archive``, or a copy of this tree with one
choice changed (a launch shape: ``sed`` on ``lander_solver.cuh``'s
``kGroup`` or ``kEnvsPerBlock``).  On the four sets of states of
``j1_profile.py`` (a 60-frame flight's and ``chip_smoke.py`` phase 3's
contact-heavy ones, N = 128 and 1024), prints the device µs a call of J1
(``measure.device_us``) of this tree, each checkout in order and this tree
again, and the lanes of each checkout's result that differ from this
tree's in any bit.  Needs one CUDA GPU; imports nothing of JAX.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> int:
    import j1_profile

    from deep_q_learning_tpu_torch import measure
    from deep_q_learning_tpu_torch.measure import device_us, jointed_params, lanes_differ
    from deep_q_learning_tpu_torch.ops import jointed_kernels

    card = measure.card_line()
    names = sys.argv[1:]
    modules = {name: measure.load_baseline(Path(name).resolve(), "jointed_kernels")
               for name in names}
    params = jointed_params()
    for kind in ("flight", "contact-heavy"):
        for n in (128, 1024):
            state, action, draws = j1_profile.states(kind, n)

            def call(module):
                return module.jointed_step_kernel(state, action, params, draws)

            times = [(which, device_us(lambda: call(modules.get(which, jointed_kernels))))
                     for which in ["tree", *names, "tree"]]
            differ = {name: lanes_differ(call(modules[name]), call(jointed_kernels))
                      for name in names}
            print(f"{kind} N={n}: " + ", ".join(f"{w} {t:.2f}" for w, t in times)
                  + f" us; lanes differing from the tree {differ} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
