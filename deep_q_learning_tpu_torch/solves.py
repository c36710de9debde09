"""Solve runs on one CUDA GPU: presets trained through the command line
until the return window reaches the preset's solve threshold or the
env-step budget is spent, at the CLI's default ``--log-every 10``.

    python -m deep_q_learning_tpu_torch.solves [--group classic|lunar] [--out DIR]
    python -m deep_q_learning_tpu_torch.solves --preset P --seeds 4,5,6 [--device cpu]

``classic``: ``cartpole_vector`` at seeds 0, 1, 2, 3 in turn (42M env steps
each) until two have solved; ``acrobot_vector`` at seed 0 (4M), and seed 1
only if seed 0 missed; ``mountain_car_vector`` the same (13M).  ``lunar``:
``lunar_per_scaled`` (1024 envs) at seed 0 (63M).  Each run is

    python -m deep_q_learning_tpu_torch train --preset P --seed S
        --max-env-steps B --eval-every 10 --history-out DIR/P_seedS.jsonl
        --workdir W

(a greedy evaluation of 128 episodes at every log point, and a checkpoint
at the solve), then ``eval --workdir W`` of that checkpoint.  Each run's
output goes to ``DIR/P_seedS.log``, and one summary line per run to
``DIR/summary.jsonl`` and to standard output, with the card's name and
power limit.  Without CUDA the first ``train`` fails and so does this.
``--preset P --seeds S,...`` runs those seeds of one preset of a group, all
of them, at the preset's budget: a solve rate over more seeds.  ``--device
cpu`` runs on the host instead (the summary's card is then ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# (preset, budget in env steps, seeds in order, solves wanted)
GROUPS = {
    "classic": [
        ("cartpole_vector", 42_000_000, (0, 1, 2, 3), 2),
        ("acrobot_vector", 4_000_000, (0, 1), 1),
        ("mountain_car_vector", 13_000_000, (0, 1), 1),
    ],
    "lunar": [("lunar_per_scaled", 63_000_000, (0,), 1)],
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cli(args, log, device: str) -> dict:
    """Run ``python -m deep_q_learning_tpu_torch *args``, append its output to
    ``log`` and return the JSON of its last line."""
    proc = subprocess.run(
        [sys.executable, "-m", "deep_q_learning_tpu_torch", *args, "--device", device],
        capture_output=True, text=True,
    )
    log.write(f"$ {' '.join(args)}\n{proc.stdout}{proc.stderr}")
    log.flush()
    if proc.returncode != 0:
        raise RuntimeError(f"{args[0]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def solve(preset: str, seed: int, budget: int, out: Path, card: str, device: str) -> dict:
    hist = out / f"{preset}_seed{seed}.jsonl"
    with open(out / f"{preset}_seed{seed}.log", "w") as log, \
            tempfile.TemporaryDirectory() as workdir:
        run = ["--preset", preset, "--seed", str(seed)]
        result = cli(["train", *run, "--max-env-steps", str(budget), "--eval-every", "10",
                      "--history-out", str(hist), "--workdir", workdir], log, device)
        ev = cli(["eval", *run, "--workdir", workdir], log, device) if result["solved"] else None
    history = [json.loads(line) for line in open(hist)]
    return {
        "preset": preset,
        "seed": seed,
        "budget": budget,
        **result,
        "env_steps_per_s": result["env_steps"] / result["wall_time_s"],
        "best_window": max(h["window_mean"] for h in history),
        "last_eval_mean": history[-1].get("eval_mean"),
        "greedy_eval": ev,
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deep_q_learning_tpu_torch.solves")
    ap.add_argument("--group", choices=sorted(GROUPS), default="classic")
    ap.add_argument("--out", type=Path, default=Path("runs/solves"))
    ap.add_argument("--preset", choices=sorted(p for g in GROUPS.values() for p, *_ in g),
                    help="with --seeds: run these seeds of this preset, every one")
    ap.add_argument("--seeds", type=lambda s: tuple(int(x) for x in s.split(",")))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runs = GROUPS[args.group]
    if args.preset:
        if not args.seeds:
            ap.error("--preset needs --seeds")
        budget = {p: b for g in GROUPS.values() for p, b, *_ in g}[args.preset]
        runs = [(args.preset, budget, args.seeds, len(args.seeds))]
    args.out.mkdir(parents=True, exist_ok=True)
    card = card_line() if args.device.startswith("cuda") else args.device
    print(card, flush=True)
    with open(args.out / "summary.jsonl", "a") as summary:
        for preset, budget, seeds, wanted in runs:
            solved = 0
            for seed in seeds:
                rec = solve(preset, seed, budget, args.out, card, args.device)
                summary.write(json.dumps(rec) + "\n")
                summary.flush()
                print(json.dumps(rec), flush=True)
                solved += rec["solved"]
                if solved >= wanted:
                    break
    return 0


if __name__ == "__main__":
    sys.exit(main())
