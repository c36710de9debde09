"""A preset's solve from one seed (0 unless given) on another checkout of
the port (the parent commit) and on this tree, in turns on one card: a
kernel that is bitwise the plain version it replaces (R1 the rigid step,
J1 the jointed frame, A1, C1 and M1 the classic envs' vector steps)
leaves the two runs' log points and greedy evaluation equal bit for bit,
and only their walls differ.

    git archive <parent> | tar -x -C build/parent
    python3 artifacts/rigid_kernel/solve_pair.py --parent build/parent \\
        --out build/solve_pair [--preset lunar_per] [--seed 0] [--order parent,tree] \\
        [--artifact artifacts/lunar_per_solve_torch_r1_s0.json]

Each run is ``python -m deep_q_learning_tpu_torch.solves --preset
PRESET --seeds SEED --out OUT/<i>_<which>`` from that checkout (its kernels
built from its own ``csrc/``), then ``--artifact`` of it.  Compared: every
field of every log point but its timing (``steps_per_s``, ``wall_s``), the
solve's env steps, episodes and updates, and the greedy evaluation.
Writes OUT/pair.json (or ``--artifact``; the runs' workdirs under OUT hold
their checkpoints): each run's wall and env-steps/s
in the order run, whether every run equals the first, and the first
tree run's record (curve, solve, evaluation), with the card's name and
power limit.  Needs one CUDA GPU; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TIMING = ("steps_per_s", "wall_s")
SOLVE = ("solved", "solve_env_steps", "final_window_mean", "episodes", "updates", "greedy_eval")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(checkout: Path, out: Path, preset: str, seed: int) -> dict:
    """One solve of ``preset`` from ``seed`` and ``checkout``, and its record."""
    env = dict(os.environ, PYTHONPATH=str(checkout))
    base = [sys.executable, "-m", "deep_q_learning_tpu_torch.solves", "--preset", preset,
            "--seeds", str(seed), "--out", str(out.resolve())]
    subprocess.run(base, cwd=checkout, env=env, check=True)
    record = out / "record.json"
    subprocess.run(base + ["--artifact", str(record.resolve())], cwd=checkout, env=env, check=True)
    return json.loads(record.read_text())


def comparable(rec: dict) -> dict:
    return {"curve": [{k: v for k, v in line.items() if k not in TIMING} for line in rec["curve"]],
            **{k: rec[k] for k in SOLVE}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--preset", default="lunar_per")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", default="parent,tree")
    ap.add_argument("--artifact", type=Path, default=None)
    args = ap.parse_args()
    card = card_line()
    runs = []
    for i, which in enumerate(args.order.split(",")):
        checkout = args.parent.resolve() if which == "parent" else ROOT
        rec = run(checkout, args.out / f"{i}_{which}", args.preset, args.seed)
        runs.append((which, rec))
        print(json.dumps({"run": i, "which": which, "wall_time_s": rec["wall_time_s"],
                          "solve_env_steps": rec["solve_env_steps"], "card": card}), flush=True)
    first = comparable(runs[0][1])
    differ = [i for i, (_, rec) in enumerate(runs) if comparable(rec) != first]
    tree = next(rec for which, rec in runs if which == "tree")
    out = {
        "source": "python3 artifacts/rigid_kernel/solve_pair.py --parent build/parent --out "
                  f"{args.out} --preset {args.preset} --seed {args.seed} --order {args.order} "
                  f"(each run: python -m deep_q_learning_tpu_torch.solves --preset {args.preset} "
                  f"--seeds {args.seed}, then "
                  "--artifact)",
        "card": card,
        "parent": "the parent commit, unpacked with git archive into build/parent",
        "runs": [{"which": which, "wall_time_s": rec["wall_time_s"],
                  "env_steps_per_s": rec["calls"][-1]["env_steps_per_s"],
                  "solve_env_steps": rec["solve_env_steps"], "greedy_eval": rec["greedy_eval"]}
                 for which, rec in runs],
        "bitwise_equal": not differ,
        "runs_that_differ_from_the_first": differ,
        "log_points": len(first["curve"]),
        "tree_record": tree,
    }
    path = args.artifact or args.out / "pair.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in ("card", "runs", "bitwise_equal", "log_points")}))
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
