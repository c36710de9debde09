"""Solve runs on one CUDA GPU: presets trained through the command line
until the return window reaches the preset's solve threshold or the
env-step budget is spent, at the CLI's default ``--log-every 10``.

    python -m deep_q_learning_tpu_torch.solves [--group classic|lunar] [--out DIR]
    python -m deep_q_learning_tpu_torch.solves --preset P --seeds 4,5,6 [--device cpu]
    python -m deep_q_learning_tpu_torch.solves --population 10 [--seeds 0] [--out DIR]

``classic``: ``cartpole_vector`` at seeds 0, 1, 2, 3 in turn (42M env steps
each) until two have solved; ``acrobot_vector`` at seed 0 (4M), and seed 1
only if seed 0 missed; ``mountain_car_vector`` the same (13M).  ``lunar``:
``lunar_per_scaled`` (1024 envs) at seed 0 (63M), then ``lunar_per`` (128
envs, the single learner of the main path) at seed 0 (30M).  Each run is

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

``--population M``: ``lunar_per`` (or ``--preset``, one of ``POPULATION``)
as one population of M members with the preset's hyperparameters and
member seeds derived from the first of ``--seeds`` (default 0), through
``PopulationTrainer``, until every member's window has reached the solve
threshold or the budget per member is spent.  Each member's env steps at
its first solved superstep, then a greedy evaluation of every member (20
episodes each) go to ``DIR/<preset>_population<M>.json``, with the members'
windows every 10 supersteps and the aggregate env-steps/s.
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
    "lunar": [
        ("lunar_per_scaled", 63_000_000, (0,), 1),
        # the single learner of the main path; the JAX package's one single
        # run solved at 29.5M (artifacts/lunar_solve_curve.json)
        ("lunar_per", 30_000_000, (0,), 1),
    ],
}
# --population: preset -> budget per member (the JAX package's 10-member
# lunar_per population reached window 200 at 4.21M-7.09M env steps a member)
POPULATION = {"lunar_per": 8_000_000}
POPULATION_EVAL_ENVS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cli(args, log, device: str) -> dict:
    """Run ``python -m deep_q_learning_tpu_torch *args``, append its output to
    ``log`` line by line as it comes (a run cut short keeps its curve) and
    return the JSON of its last line."""
    log.write(f"$ {' '.join(args)}\n")
    log.flush()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deep_q_learning_tpu_torch", *args, "--device", device],
        stdout=subprocess.PIPE, stderr=log, text=True,
    )
    lines = []
    for line in proc.stdout:
        lines.append(line)
        log.write(line)
        log.flush()
    if proc.wait() != 0:
        raise RuntimeError(f"{args[0]} exited {proc.returncode}; its output is in {log.name}")
    return json.loads(lines[-1])


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


def population(preset: str, members: int, seed: int, out: Path, card: str, device: str) -> dict:
    """One population of ``members`` of ``preset`` to the solve threshold or
    the budget; per-member steps to solve and greedy evaluation."""
    import time

    import numpy as np

    from deep_q_learning_tpu_torch.config import PRESETS
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer

    cfg, budget = PRESETS[preset](), POPULATION[preset]
    trainer = PopulationTrainer(cfg, members, eval_envs=POPULATION_EVAL_ENVS, device=device)
    runner = trainer.init(seed)
    per_superstep = cfg.steps_per_superstep * cfg.num_envs
    solved_at = [None] * members
    curve = []
    t0 = time.time()
    path = out / f"{preset}_population{members}.json"
    for i in range(1, -(-budget // per_superstep) + 1):
        runner, m = trainer.step(runner)
        for k in np.flatnonzero(m.solved):
            if solved_at[k] is None:
                solved_at[k] = i * per_superstep
        if i % 10 == 0:
            curve.append({"env_steps": i * per_superstep, "wall_s": time.time() - t0,
                          "window_mean": m.window_mean.tolist()})
            print(json.dumps(curve[-1]), flush=True)
            with open(path, "w") as f:  # the run so far, should it be cut
                json.dump({"preset": preset, "members": members, "curve": curve}, f)
        if all(s is not None for s in solved_at):
            break
    wall = time.time() - t0
    ev = trainer.evaluate(runner, seed=seed + 1)
    rec = {
        "preset": preset,
        "members": members,
        "seed": seed,
        "budget_per_member": budget,
        "env_steps_per_member": i * per_superstep,
        "aggregate_env_steps": i * per_superstep * members,
        "wall_s": wall,
        "aggregate_env_steps_per_s": i * per_superstep * members / wall,
        "threshold": cfg.solve_threshold,
        "solved": sum(s is not None for s in solved_at),
        "steps_to_solve": solved_at,
        "final_window_mean": m.window_mean.tolist(),
        "eval_mean": ev.returns.mean(axis=1).tolist(),
        "eval_returns": ev.returns.tolist(),
        "eval_truncated": ev.truncated.sum(axis=1).tolist(),
        "card": card,
        "curve": curve,
    }
    with open(path, "w") as f:
        json.dump(rec, f)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deep_q_learning_tpu_torch.solves")
    ap.add_argument("--group", choices=sorted(GROUPS), default="classic")
    ap.add_argument("--out", type=Path, default=Path("runs/solves"))
    ap.add_argument("--preset", choices=sorted({p for g in GROUPS.values() for p, *_ in g}
                                               | set(POPULATION)),
                    help="with --seeds: run these seeds of this preset, every one")
    ap.add_argument("--seeds", type=lambda s: tuple(int(x) for x in s.split(",")))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--population", type=int, metavar="M",
                    help="train M members of --preset (default lunar_per) as one population")
    args = ap.parse_args(argv)
    if args.population:
        preset = args.preset or "lunar_per"
        if preset not in POPULATION:
            ap.error(f"--population runs {sorted(POPULATION)}")
        args.out.mkdir(parents=True, exist_ok=True)
        card = card_line() if args.device.startswith("cuda") else args.device
        print(card, flush=True)
        rec = population(preset, args.population, (args.seeds or (0,))[0], args.out, card,
                         args.device)
        print(json.dumps({k: v for k, v in rec.items() if k not in ("curve", "eval_returns")}))
        return 0
    runs = GROUPS[args.group]
    if args.preset:
        if not args.seeds:
            ap.error("--preset needs --seeds")
        budgets = {p: b for g in GROUPS.values() for p, b, *_ in g}
        if args.preset not in budgets:
            ap.error(f"--preset {args.preset} runs with --population")
        budget = budgets[args.preset]
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
