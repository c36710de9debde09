"""R1's cycles by phase on the card, from a throwaway instrumented build.

    python3 artifacts/rigid_kernel/r1_profile.py [--checkout DIR]

Copies a checkout's ``deep_q_learning_tpu_torch/csrc`` and
``ops/lander_kernels.py`` (this tree's by default) under ``build/r1_probe``
and adds ``clock64()`` probes to the copy of ``lander_rigid.cuh``: each env
writes the clock at the vector step's entry, after its loads are issued,
after the start-of-frame sin and cos, after the contacts' terrain lookups,
after the divisors' reciprocals, after the four solve passes, after the
integration's sin and cos, after the lifts and the hull's corners, after
the frame's outcome and at its end (a probe reads the clock when its
instruction issues: it waits for nothing but what the compiler puts
before it).  The copy is built with the kernel's flags, run as the vector
step of ``lunar_per`` (a flight's states, the time feature, a reset pool)
at N = 128 and 1024, and read back.  Prints, a shape a line, each phase's
cycles (median and largest over the envs), the kernel's span on the card
(the earliest entry to the latest end, from ``%globaltimer`` in ns) and the
device µs a call of the uninstrumented and the instrumented kernel
(``measure.device_us``: a CUDA graph of 100 calls).

Needs one CUDA GPU; imports nothing of JAX.  The instrumented build is not
the program: it lives under ``build/`` and is made anew at each run.
"""

import argparse
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

MAX_ENVS = 8192
SLOTS = 12
# (anchor in lander_rigid.cuh, probe inserted after it); a probe of slot s
# closes the phase PHASES[s - 1]
ANCHORS = [
    ("  const int width = kObs + (v.time_feature ? 1 : 0);\n", 0),
    ("  for (int q = 0; q < kObs + 1; ++q) {\n"
     "    p_obs[q] = q < width ? pool.obs[(int64_t)i * width + q] : 0.0f;\n  }\n", 1),
    ("  const float sin_a = t0.s, cos_a = t0.c;\n", 2),
    ("  const bool c2 = p2y <= (g2 + k.contact_skin) + k.slop;\n", 3),
    ("  float jn1 = 0.0f, jn2 = 0.0f, jt1 = 0.0f, jt2 = 0.0f;\n", 4),
    ("  const bool hard = (jn1 > k.j_crash) | (jn2 > k.j_crash);\n", 5),
    ("  const float sin_n = t1.s, cos_n = t1.c;\n", 6),
    ("  const bool game_over = hull_hit | hard;\n", 7),
    ("  const bool done = r.terminated | r.truncated;\n", 8),
    ("  out.torque_idx[i] = done ? p_torque : (k.enable_wind ? e.torque_idx : torque_idx);\n", 9),
]
PHASES = ["loads issued", "start sin/cos", "contacts", "divisors", "4 solve passes",
          "integrate, sin/cos", "lifts, hull corners", "outcome", "stores"]
PRELUDE = r"""
#ifdef __CUDACC__
__device__ long long r1_probe[%d * %d];
#endif
#ifdef __CUDA_ARCH__
#define R1_PROBE(slot) \
  r1_probe[(int64_t)(blockIdx.x * blockDim.x + threadIdx.x) * %d + (slot)] = clock64()
#define R1_TIMER(slot) do { long long t_; \
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
  r1_probe[(int64_t)(blockIdx.x * blockDim.x + threadIdx.x) * %d + (slot)] = t_; } while (0)
#else
#define R1_PROBE(slot) do { } while (0)
#define R1_TIMER(slot) do { } while (0)
#endif
""" % (MAX_ENVS, SLOTS, SLOTS, SLOTS)
READER = r"""
extern "C" int r1_probe_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, r1_probe, sizeof(long long) * n * %d);
}
""" % SLOTS


def instrument(checkout: Path, out: Path) -> Path:
    """The instrumented copy of ``checkout``'s R1 under ``out``."""
    src = checkout / "deep_q_learning_tpu_torch"
    dst = out / "deep_q_learning_tpu_torch"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src / "csrc", dst / "csrc")
    (dst / "ops").mkdir(parents=True)
    shutil.copy(src / "ops" / "lander_kernels.py", dst / "ops")
    cuh = dst / "csrc" / "lander_rigid.cuh"
    text = cuh.read_text()
    text = text.replace("namespace rigid {\n", PRELUDE + "\nnamespace rigid {\n", 1)
    for anchor, slot in ANCHORS:
        if anchor not in text:
            raise SystemExit(f"anchor not found: {anchor!r}")
        text = text.replace(anchor, anchor + f"  R1_PROBE({slot});\n")
    # the frame's span: the global timer at the entry and after the stores
    text = text.replace("  R1_PROBE(0);\n", "  R1_PROBE(0);\n  R1_TIMER(10);\n", 1)
    text = text.replace("  R1_PROBE(9);\n", "  R1_PROBE(9);\n  R1_TIMER(11);\n", 1)
    cuh.write_text(text)
    cu = dst / "csrc" / "lander_rigid.cu"
    cu.write_text(cu.read_text() + READER)
    return out


def main() -> int:
    import ctypes

    import torch

    from deep_q_learning_tpu_torch import measure
    from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs
    from deep_q_learning_tpu_torch.envs.graphed import tree_map
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws
    from deep_q_learning_tpu_torch.measure import device_us, lanes_differ, rigid_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", type=Path, default=ROOT)
    args = ap.parse_args()
    card = measure.card_line()
    plain = measure.load_baseline(args.checkout.resolve(), "lander_kernels")
    probed = measure.load_baseline(instrument(args.checkout.resolve(), ROOT / "build" / "r1_probe"),
                                   "lander_kernels")
    lib = probed._lib()
    lib.r1_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    env, params = LunarLander(), rigid_params()
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = lander_step_inputs(env, params, 1024, g)
    pool = TimeFractionObs(env).reset_env(None, 1024, params, sample_reset_draws(g, 1024))
    for n in (128, 1024):
        state, action, draws = tree_map(lambda t: t[:n].contiguous(), inputs)
        fresh = tree_map(lambda t: t[:n].contiguous(), pool)

        def call(module):
            return module.rigid_vector_kernel(state, action, params, draws, fresh, True)

        differ = lanes_differ(call(probed), call(plain))
        for _ in range(3):  # the last of a few calls, its data in L2 as in a graph of calls
            call(probed)
        torch.cuda.synchronize()
        raw = np.zeros(n * SLOTS, np.int64)
        assert lib.r1_probe_read(raw.ctypes.data, n) == 0
        raw = raw.reshape(n, SLOTS)
        cycles = np.diff(raw[:, :10], axis=1)
        text = ", ".join(f"{name} {int(np.median(c))}/{int(c.max())}"
                         for name, c in zip(PHASES, cycles.T))
        span_ns = int(raw[:, 11].max() - raw[:, 10].min())
        us = [device_us(lambda: call(m)) for m in (plain, probed, plain)]
        print(f"R1 vector step N={n}, cycles by phase (median/largest over the envs): {text}; "
              f"entry to end {int(np.median(raw[:, 9] - raw[:, 0]))}/"
              f"{int((raw[:, 9] - raw[:, 0]).max())}; the kernel's span {span_ns} ns; device "
              f"{us[0]:.2f}, {us[2]:.2f} us a call, instrumented {us[1]:.2f}; instrumented "
              f"lanes differing {differ} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
