"""J1's cycles by phase on the card, from a throwaway instrumented build.

    python3 artifacts/rigid_kernel/j1_profile.py [--checkout DIR] [--out DIR]

Copies a checkout's ``deep_q_learning_tpu_torch/csrc`` and
``ops/jointed_kernels.py`` with ``ops/solver_kernels.py`` (this tree's by default) under ``build/j1_probe``
and adds ``clock64()`` probes to the copy: rank 0 of each live group writes
the clock at the frame's start, at ``solve_env``'s entry, before each of its
``// ---- `` sections (collide, the velocity integration, the warm start,
the velocity passes, the accumulators' store, the position integration,
the position passes), at its end and at the frame's end; and, where the
source has the layout of the passes with a
spread division and ``vel_pass``, the cycles summed over the passes
of joint 1, joint 2 and the contacts (velocity) and of the contacts, joint
1, joint 2 and the slop test with its vote (position).  The copy is built
with the same flags as the kernel (``ops/build.py``), run on four sets of
states (a 60-frame flight's, as ``measure.jointed_device_times`` makes them,
and ``chip_smoke.py`` phase 3's contact-heavy ones, at N = 128 and 1024),
and read back.  Prints, a set a line: the slowest env's cycles by phase,
each phase's largest over the envs, the cycles of a pass, the histogram of
the position passes the envs ran (``jointed_kernels.position_passes``), and
the device µs of the uninstrumented and the instrumented kernel.  Then, from
``cuobjdump -sass`` of the checkout's uninstrumented J1 and S1, each loop
(a backward branch) with its instructions, divisions' reciprocals
(``MUFU.RCP``), square roots (``MUFU.RSQ``), sines (``MUFU.SIN``), calls
(slow paths), local memory, shuffles and votes; and ptxas's registers and
spills.  The SASS goes to ``<out>/j1_<checkout name>.sass``.

Needs one CUDA GPU; imports nothing of JAX.  The instrumented build is not
the program: it lives under ``build/`` and is made anew at each run.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# the intervals between the 11 clocks of an env
PHASES = ["frame start", "start trig", "collide", "frame terms", "warm start", "velocity passes",
          "accumulator store", "position integration", "position passes", "frame end"]
INNER = ["vel joint 1", "vel joint 2", "vel contacts", "pos contacts", "pos joint 1",
         "pos joint 2", "pos test and vote"]
N_SLOTS = 24
MAX_ENVS = 1024

PRELUDE = r"""
#ifdef __CUDACC__
__device__ long long lander_probe[%d * %d];
#endif
#ifdef __CUDA_ARCH__
#define PROBE_AT(slot, value) \
  do { if (live && lanes.rank(0) == 0) lander_probe[(int64_t)i * %d + (slot)] = (value); } while (0)
#define PROBE(slot) PROBE_AT(slot, clock64())
#define PROBE_NOW() clock64()
#else
#define PROBE_AT(slot, value) do { } while (0)
#define PROBE(slot) do { } while (0)
#define PROBE_NOW() 0LL
#endif
""" % (MAX_ENVS, N_SLOTS, N_SLOTS)

# that layout of lander_solver.cuh's passes, with clocks between the parts
VEL_OLD = "    for (int it = 0; it < vel_iters; ++it) vel_pass(lanes, hv, lv, jd, ja, cd, ca, k);\n"
VEL_NEW = r"""    long long p_j1 = 0, p_j2 = 0, p_c = 0;
    for (int it = 0; it < vel_iters; ++it) {
      long long t0 = PROBE_NOW();
      solve_joint(lanes, hv, lv[0], jd[0], ja[0], k);
      long long t1 = PROBE_NOW();
      solve_joint(lanes, hv, lv[1], jd[1], ja[1], k);
      long long t2 = PROBE_NOW();
      Vel mine[Lanes::kLocal];
#pragma unroll
      for (int l = 0; l < Lanes::kLocal; ++l) {
        mine[l] = leg_of(lanes, l) == 0 ? lv[0] : lv[1];
        solve_contacts(mine[l], cd[l], ca[l], k);
      }
      lv[0] = lanes.read(mine, 0);
      lv[1] = lanes.read(mine, 1);
      long long t3 = PROBE_NOW();
      p_j1 += t1 - t0; p_j2 += t2 - t1; p_c += t3 - t2;
    }
    PROBE_AT(11, p_j1); PROBE_AT(12, p_j2); PROBE_AT(13, p_c);
"""
POS_ANCHORS = [
    ("  for (int it = 0; it < pos_iters && lanes.any(!done); ++it) {\n",
     "  long long q_c = 0, q_j1 = 0, q_j2 = 0, q_t = 0, t_last = -1;\n"
     "  for (int it = 0; it < pos_iters && lanes.any(!done); ++it) {\n"
     "    long long t0 = PROBE_NOW();\n"
     "    if (t_last >= 0) q_t += t0 - t_last;\n"),
    ("    float sep = fminf(lanes.read(ms, 0), lanes.read(ms, 1));\n",
     "    float sep = fminf(lanes.read(ms, 0), lanes.read(ms, 1));\n"
     "    long long t1 = PROBE_NOW();\n"),
    ("    float e2 = pos_joint(lanes, hp1, lp1[1], 1, ht, lt[1], k, a2);\n",
     "    long long t2 = PROBE_NOW();\n"
     "    float e2 = pos_joint(lanes, hp1, lp1[1], 1, ht, lt[1], k, a2);\n"
     "    long long t3 = PROBE_NOW();\n"),
    ("    done = done | ok;\n  }\n",
     "    done = done | ok;\n"
     "    q_c += t1 - t0; q_j1 += t2 - t1; q_j2 += t3 - t2; t_last = t3;\n  }\n"
     "  if (t_last >= 0) q_t += PROBE_NOW() - t_last;\n"
     "  PROBE_AT(14, q_c); PROBE_AT(15, q_j1); PROBE_AT(16, q_j2); PROBE_AT(17, q_t);\n"),
]


def instrument(checkout: Path, out: Path) -> bool:
    """The instrumented copy of ``checkout``'s J1 under ``out``; returns
    whether the passes' inner probes went in too."""
    src = checkout / "deep_q_learning_tpu_torch"
    dst = out / "deep_q_learning_tpu_torch"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src / "csrc", dst / "csrc")
    (dst / "ops").mkdir(parents=True)
    for name in ("jointed_kernels.py", "solver_kernels.py"):
        shutil.copy(src / "ops" / name, dst / "ops" / name)

    solver = (dst / "csrc" / "lander_solver.cuh").read_text()
    solver = solver.replace('#include "lander_frame.cuh"\n',
                            '#include "lander_frame.cuh"\n' + PRELUDE, 1)
    head, body = solver.split("LS_FN void solve_env(", 1)
    body, tail = body.split("\n}\n", 1)
    slot = iter(range(2, 10))
    body = re.sub(r"\n  // ---- ", lambda m: f"\n  PROBE({next(slot)});\n  // ---- ", body)
    assert next(slot) == 9, "solve_env's sections changed"
    body = body.replace("{\n", "{\n  PROBE(1);\n", 1) + "\n  PROBE(9);"
    inner = VEL_OLD in body and all(a in body for a, _ in POS_ANCHORS)
    if inner:
        body = body.replace(VEL_OLD, VEL_NEW)
        for anchor, new in POS_ANCHORS:
            body = body.replace(anchor, new)
    solver = head + "LS_FN void solve_env(" + body + "\n}\n" + tail
    (dst / "csrc" / "lander_solver.cuh").write_text(solver)

    jointed = (dst / "csrc" / "lander_jointed.cuh").read_text()
    head, body = jointed.split("LJ_FN void jointed_step_env(", 1)
    body = body.replace("{\n", "{\n  PROBE(0);\n", 1)
    body = body.replace("  frame::finish(fio, fk, i, s, e, rank0);\n",
                        "  frame::finish(fio, fk, i, s, e, rank0);\n  PROBE(10);\n", 1)
    (dst / "csrc" / "lander_jointed.cuh").write_text(head + "LJ_FN void jointed_step_env(" + body)

    cu = dst / "csrc" / "lander_jointed.cu"
    cu.write_text(cu.read_text() + (
        '\nextern "C" int probe_read(void* dst, int bytes) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(dst, lander_probe, bytes));\n}\n"))
    return inner


def states(kind: str, n: int):
    """``step_env``'s inputs: a 60-frame flight's (``measure``) or phase 3's
    contact-heavy states (``chip_smoke.py``), wind off."""
    import torch

    import chip_smoke as cs
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.graphed import tree_map
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.measure import jointed_params

    env = LunarLander()
    if kind == "flight":
        g = torch.Generator(device="cuda").manual_seed(n)
        return lander_step_inputs(env, jointed_params(), n, g, envs=n, frames=60)
    g = torch.Generator(device="cuda").manual_seed(40)
    inputs = lander_step_inputs(env, jointed_params(False, cs.J1_MAX_STEPS), max(cs.J1_NS), g,
                                envs=cs.J1_ENVS, frames=cs.J1_FRAMES)
    return tree_map(lambda t: t[:n].contiguous(), inputs)


def sass_loops(sass: str, kernel: str) -> list:
    """Each loop of ``kernel``'s SASS (a backward branch) with its counts."""
    start = sass.find(f"Function : {kernel}")
    if start < 0:
        start = next(m.start() for m in re.finditer(r"Function : (\S+)", sass) if kernel in m.group(1))
    text = sass[start:]
    end = text.find("Function :", 10)
    text = text if end < 0 else text[:end]
    lines = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            lines.append((int(m.group(1), 16), m.group(2).strip()))
    loops = []
    for addr, ins in lines:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [i for a, i in lines if lo <= a <= addr]
            count = lambda pat: sum(bool(re.search(pat, i)) for i in body)  # noqa: E731
            loops.append({"from": hex(lo), "to": hex(addr), "instructions": len(body),
                          "MUFU.RCP": count(r"MUFU\.RCP"), "MUFU.RSQ": count(r"MUFU\.RSQ"),
                          "MUFU.SIN/COS": count(r"MUFU\.(SIN|COS)"), "FCHK": count(r"FCHK"),
                          "CALL": count(r"\bCALL"), "local": count(r"\b(LDL|STL)\b"),
                          "SHFL": count(r"\bSHFL"), "VOTE": count(r"\bVOTE"),
                          "BRA": count(r"\bBRA\b"), "BSSY": count(r"\bBSSY\b")})
    total = {"instructions": len(lines), "local": sum(bool(re.search(r"\b(LDL|STL)\b", i))
                                                      for _, i in lines),
             "CALL": sum("CALL" in i for _, i in lines)}
    return [total] + loops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out")
    ap.add_argument("--sizes", default="128,1024")
    args = ap.parse_args()

    import ctypes

    import torch

    from deep_q_learning_tpu_torch import measure
    from deep_q_learning_tpu_torch.measure import device_us, jointed_params, load_baseline
    from deep_q_learning_tpu_torch.ops import build, jointed_kernels

    card = measure.card_line()
    checkout = args.checkout.resolve()
    probe_dir = ROOT / "build" / "j1_probe"
    inner = instrument(checkout, probe_dir)
    tree = load_baseline(checkout, "jointed_kernels")
    probed = load_baseline(probe_dir, "jointed_kernels")
    lib = probed._lib()
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    tree._lib()
    print(f"checkout {checkout}; inner probes {'in' if inner else 'not in (layout changed)'} "
          f"[{card}]")
    for src, report in build.ptxas_reports.items():
        print(f"  ptxas {src}: {build.ptxas_summary(report)}")

    params = jointed_params()
    result = {"card": card, "checkout": str(checkout), "sets": {}}
    for kind in ("flight", "contact-heavy"):
        for n in (int(s) for s in args.sizes.split(",")):
            state, action, draws = states(kind, n)
            ran = jointed_kernels.position_passes(params, state, action, draws).cpu().numpy()
            us = device_us(lambda: tree.jointed_step_kernel(state, action, params, draws))
            us_probed = device_us(lambda: probed.jointed_step_kernel(state, action, params, draws))
            probed.jointed_step_kernel(state, action, params, draws)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_ENVS, N_SLOTS), np.int64)
            assert lib.probe_read(buf.ctypes.data, buf.nbytes) == 0
            t = buf[:n]
            phases = np.diff(t[:, :len(PHASES) + 1], axis=1)
            total = t[:, len(PHASES)] - t[:, 0]
            slow = int(np.argmax(total))
            warp = slice(slow // 8 * 8, slow // 8 * 8 + 8)
            warp_pos = int(ran[warp].max())
            row = {
                "us": us, "us_probed": us_probed,
                "slowest_env": slow, "slowest_cycles": int(total[slow]),
                "slowest_pos_used": int(ran[slow]), "slowest_warp_pos_used": warp_pos,
                "slowest_by_phase": dict(zip(PHASES, map(int, phases[slow]))),
                "largest_by_phase": dict(zip(PHASES, map(int, phases.max(0)))),
                "vel_cycles_a_pass": float(phases[slow, PHASES.index("velocity passes")]) / 120,
                "pos_cycles_a_pass": float(phases[slow, PHASES.index("position passes")])
                / max(warp_pos, 1),
                "pos_used_histogram": {int(v): int(c) for v, c in
                                       zip(*np.unique(ran, return_counts=True))},
                "used": "120 on every env (vel_tol 0)",
            }
            if inner:
                sums = dict(zip(INNER, map(int, t[slow, 11:18])))
                row["slowest_inner"] = sums
                row["slowest_inner_a_pass"] = {
                    k: v / (120 if k.startswith("vel") else max(warp_pos, 1))
                    for k, v in sums.items()}
            result["sets"][f"{kind} N={n}"] = row
            print(f"{kind} N={n}: {json.dumps(row)} [{card}]", flush=True)

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    for source, kernel in (("lander_jointed.cu", "jointed_step_kernel"),
                           ("lander_solver.cu", "assembly_step_kernel")):
        so = build.load_library(source, checkout / "deep_q_learning_tpu_torch" / "csrc")._name
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                              text=True, check=True).stdout
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"{Path(source).stem}_{checkout.name}.sass").write_text(sass)
        loops = sass_loops(sass, kernel)
        result[f"sass {kernel}"] = loops
        print(f"SASS {kernel}: {json.dumps(loops)}")
    (args.out / f"j1_profile_{checkout.name}.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
