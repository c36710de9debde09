"""R1 at other block sizes, and the parent's R1, against this tree's, on one card.

    python3 artifacts/rigid_kernel/r1_variants.py [--parent CHECKOUT]

Builds each block size of ``VARIANTS`` from a copy of this tree's
``deep_q_learning_tpu_torch/csrc`` and ``ops/lander_kernels.py`` under
``build/r1_variants/<name>`` with ``csrc/lander_rigid.cu``'s ``kThreads``
changed, and loads it beside this tree (``measure.load_baseline``).  On a flight's states (``envs/heuristic.py::
lander_step_inputs``, the wind off) at N = 1, 128, 1024 and 8192, prints
the device µs a call (``measure.device_us``) of R1's step of this tree,
each layout and the parent (``--parent``: another checkout, e.g. the parent
commit unpacked with ``git archive``) in order and this tree again, then
of the vector step (the step, the auto-reset from a pool and the time
feature) of this tree and each layout, with the lanes of each result that
differ from this tree's in any bit.  Needs one CUDA GPU; imports nothing
of JAX.
"""

import argparse
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# name -> the threads a block of lander_rigid.cu
VARIANTS = {"threads64": 64, "threads128": 128, "threads256": 256}
NS = (1, 128, 1024, 8192)


def variant(name: str, threads: int) -> Path:
    """A checkout of this tree's R1 with ``threads`` a block."""
    out = ROOT / "build" / "r1_variants" / name / "deep_q_learning_tpu_torch"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "deep_q_learning_tpu_torch" / "csrc", out / "csrc")
    (out / "ops").mkdir(parents=True)
    shutil.copy(ROOT / "deep_q_learning_tpu_torch" / "ops" / "lander_kernels.py", out / "ops")
    source = out / "csrc" / "lander_rigid.cu"
    line = "constexpr int kThreads = 32;"
    text = source.read_text()
    assert line in text, line
    source.write_text(text.replace(line, f"constexpr int kThreads = {threads};"))
    return out.parent


def main() -> int:
    import torch

    from deep_q_learning_tpu_torch import measure
    from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws
    from deep_q_learning_tpu_torch.measure import device_us, lanes_differ, rigid_params
    from deep_q_learning_tpu_torch.ops import lander_kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    card = measure.card_line()
    modules = {name: measure.load_baseline(variant(name, threads), "lander_kernels")
               for name, threads in VARIANTS.items()}
    if args.parent is not None:
        modules["parent"] = measure.load_baseline(args.parent.resolve(), "lander_kernels")
    with ThreadPoolExecutor(max_workers=len(modules) + 1) as builds:  # one nvcc each, together
        list(builds.map(lambda m: m._lib(), [lander_kernels, *modules.values()]))
    env, params = LunarLander(), rigid_params()
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = lander_step_inputs(env, params, max(NS), g)
    pool = TimeFractionObs(env).reset_env(None, max(NS), params, sample_reset_draws(g, max(NS)))
    for n in NS:
        state, action, draws, fresh = measure_inputs(inputs, pool, n)

        def step(module):
            return module.rigid_step_kernel(state, action, params, draws)

        def vector(module):
            return module.rigid_vector_kernel(state, action, params, draws, fresh, True)

        for label, call, names in (("step", step, list(modules)),
                                   ("vector step", vector, list(VARIANTS))):
            times = [(which, device_us(lambda: call(modules.get(which, lander_kernels))))
                     for which in ["tree", *names, "tree"]]
            differ = {name: lanes_differ(call(modules[name]), call(lander_kernels))
                      for name in names}
            print(f"R1 {label} N={n}: " + ", ".join(f"{w} {t:.2f}" for w, t in times)
                  + f" us; lanes differing from the tree {differ} [{card}]", flush=True)
    return 0


def measure_inputs(inputs, pool, n):
    """The first ``n`` lanes of the step's inputs and of the pool."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_map

    state, action, draws = tree_map(lambda t: t[:n].contiguous(), inputs)
    fresh = tree_map(lambda t: t[:n].contiguous(), pool)
    return state, action, draws, fresh


if __name__ == "__main__":
    sys.exit(main())
