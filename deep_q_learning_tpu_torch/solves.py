"""Solve runs on one CUDA GPU: presets trained through the command line
until the return window reaches the preset's solve threshold or the
env-step budget is spent, at the CLI's default ``--log-every 10``.

    python -m deep_q_learning_tpu_torch.solves [--group classic|lunar|jointed] [--out DIR]
    python -m deep_q_learning_tpu_torch.solves --preset P --seeds 4,5,6 [--device cpu]
        [--max-seconds S]
    python -m deep_q_learning_tpu_torch.solves --population 10 [--seeds 0] [--out DIR]

``classic``: ``cartpole_vector`` at seeds 0, 1, 2, 3 in turn (42M env steps
each) until two have solved; ``acrobot_vector`` at seed 0 (4M), and seed 1
only if seed 0 missed; ``mountain_car_vector`` the same (13M).  ``lunar``:
``lunar_per_scaled`` (1024 envs) at seed 0 (63M), then ``lunar_per`` (128
envs, the single learner of the main path) at seed 0 (30M).  ``jointed``:
``lunar_jointed_per`` (the jointed lander) at seed 0 (6M).  Each run is

    python -m deep_q_learning_tpu_torch train --preset P --seed S
        --max-env-steps B --eval-every E --history-out DIR/P_seedS.call.jsonl
        --workdir DIR/P_seedS.workdir --checkpoint-every 10 --keep-newest
        [--resume] [--max-seconds T]

(a greedy evaluation of 128 episodes every ``E`` supersteps, 10, or
``EVAL_EVERY`` for a preset whose evaluation is long; a checkpoint at every
log point and at the solve, only the newest kept), then ``eval --workdir
W`` of the solving checkpoint.  The workdir persists: a run cut by
``--max-seconds`` (at a log point, after a checkpoint) continues from its
workdir with ``train --resume`` when the same command runs again on the
same ``--out``, and its history is appended to ``DIR/P_seedS.jsonl``, each
line tagged with its call, continuous in env steps.  A finished run
(solved or out of budget) leaves ``DIR/P_seedS.done.json`` and is not run
again.  Each run's output goes to ``DIR/P_seedS.log``, and one summary
line per call to ``DIR/summary.jsonl`` and to standard output, with the
card's name and power limit.  Without CUDA the first ``train`` fails and
so does this.  ``--preset P --seeds S,...`` runs those seeds of one preset
of a group, all of them, at the preset's budget: a solve rate over more
seeds.  ``--device cpu`` runs on the host instead (the summary's card is
then ``cpu``).  ``--artifact JSON --preset P --seeds S`` writes one run's
record from ``--out`` (every call's wall time and card, the curve, the
solve and its greedy evaluation, and the JAX package's records of the
preset beside them) and runs nothing; ``--seeds S,...`` writes those runs'
records and their count of solves.

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
from pathlib import Path

from deep_q_learning_tpu_torch.utils.checkpoint import latest_step

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
    # the JAX package's flagship solved 3 of 3 seeds at 2.79M-3.60M env steps
    # (artifacts/lunar_jointed_solve.json, artifacts/lunar_jointed_solve_tpu.json)
    "jointed": [
        ("lunar_jointed_per", 6_000_000, (0,), 1),
    ],
}
# supersteps between greedy evaluations, where not 10: a jointed evaluation
# of 128 episodes is up to 1,000 jointed frames
EVAL_EVERY = {"lunar_jointed_per": 50}
# the JAX package's records of the same solve, put beside a run's by --artifact
JAX_ARTIFACTS = {"lunar_jointed_per": ("artifacts/lunar_jointed_solve.json",
                                       "artifacts/lunar_jointed_solve_tpu.json")}
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


def solve(preset: str, seed: int, budget: int, out: Path, card: str, device: str,
          max_seconds=None) -> dict:
    """One call of one run: from the start, or on from its workdir."""
    name = f"{preset}_seed{seed}"
    done = out / f"{name}.done.json"
    if done.exists():
        return json.loads(done.read_text())
    hist, call_hist = out / f"{name}.jsonl", out / f"{name}.call.jsonl"
    workdir = out / f"{name}.workdir"
    resume = latest_step(str(workdir)) is not None
    past = [json.loads(line) for line in open(hist)] if resume and hist.exists() else []
    call = 1 + max((h["call"] for h in past), default=0)
    with open(out / f"{name}.log", "a") as log:
        run = ["--preset", preset, "--seed", str(seed)]
        args = ["train", *run, "--max-env-steps", str(budget),
                "--eval-every", str(EVAL_EVERY.get(preset, 10)), "--history-out", str(call_hist),
                "--workdir", str(workdir), "--checkpoint-every", "10", "--keep-newest"]
        if resume:
            args.append("--resume")
        if max_seconds:
            args += ["--max-seconds", str(max_seconds)]
        result = cli(args, log, device)
        ev = (cli(["eval", *run, "--workdir", str(workdir)], log, device)
              if result["solved"] else None)
    history = past + [dict(json.loads(line), call=call) for line in open(call_hist)]
    with open(hist, "w") as f:
        f.writelines(json.dumps(h) + "\n" for h in history)
    # without max_seconds a run ends only solved or out of budget
    finished = not max_seconds or result["solved"] or result["env_steps"] >= budget
    rec = {
        "preset": preset,
        "seed": seed,
        "budget": budget,
        "call": call,
        "finished": finished,
        **result,
        "env_steps_per_s": (result["env_steps"] - (past[-1]["env_steps"] if past else 0))
        / result["wall_time_s"],
        "best_window": max(h["window_mean"] for h in history),
        "last_eval_mean": next((h["eval_mean"] for h in reversed(history) if "eval_mean" in h),
                               None),
        "greedy_eval": ev,
        "card": card,
    }
    if finished:
        done.write_text(json.dumps(rec))
    return rec


def artifact(preset: str, seed: int, out: Path) -> dict:
    """One run's record from its files under ``out``, every call of it: the
    curve (continuous in env steps), the steps at the solve, the greedy
    evaluation of the solving checkpoint, wall time and card per call, and
    the JAX package's records of the same preset beside it."""
    name = f"{preset}_seed{seed}"
    calls = [rec for rec in map(json.loads, open(out / "summary.jsonl"))
             if (rec["preset"], rec["seed"]) == (preset, seed)]
    calls = list({rec["call"]: rec for rec in calls}.values())  # a finished run's repeats
    last = calls[-1]
    root = Path(__file__).resolve().parents[1]
    return {
        "source": f"python -m deep_q_learning_tpu_torch.solves --preset {preset} --seeds {seed} "
                  f"--out {out} [--max-seconds S], run once a call until finished (the CLI's "
                  f"train at --log-every 10, --eval-every {EVAL_EVERY.get(preset, 10)}, resumed "
                  f"from the run's workdir), then eval of the solving checkpoint",
        "card": last["card"],
        "preset": preset,
        "seed": seed,
        "budget": last["budget"],
        "finished": last["finished"],
        "solved": last["solved"],
        "solve_env_steps": last["env_steps"] if last["solved"] else None,
        "final_window_mean": last["final_window_mean"],
        "episodes": last["episodes"],
        "updates": last["updates"],
        "calls": [{k: rec[k] for k in ("call", "env_steps", "wall_time_s", "env_steps_per_s",
                                       "card")} for rec in calls],
        "wall_time_s": sum(rec["wall_time_s"] for rec in calls),
        "greedy_eval": last["greedy_eval"],
        "curve": [json.loads(line) for line in open(out / f"{name}.jsonl")],
        "jax_references": {path: json.loads((root / path).read_text())
                           for path in JAX_ARTIFACTS.get(preset, ())},
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
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="cut each call of a run at the first log point past this wall time; "
                         "the same command continues it")
    ap.add_argument("--artifact", type=Path, metavar="JSON",
                    help="with --preset and --seeds: write the runs' records from --out to "
                         "JSON (each one's calls, curve, solve and greedy evaluation; with "
                         "several seeds, their count of solves too), run nothing")
    args = ap.parse_args(argv)
    if args.artifact:
        if not args.preset or not args.seeds:
            ap.error("--artifact needs --preset and --seeds")
        recs = [artifact(args.preset, seed, args.out) for seed in args.seeds]
        rec = recs[0] if len(recs) == 1 else {
            "preset": args.preset, "seeds": list(args.seeds),
            "solved": sum(r["solved"] for r in recs), "runs": recs}
        args.artifact.write_text(json.dumps(rec, indent=1) + "\n")
        for r in recs:
            print(json.dumps({k: v for k, v in r.items() if k not in ("curve", "jax_references")}))
        return 0
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
                rec = solve(preset, seed, budget, args.out, card, args.device, args.max_seconds)
                summary.write(json.dumps(rec) + "\n")
                summary.flush()
                print(json.dumps(rec), flush=True)
                if not rec["finished"]:
                    return 0  # cut by --max-seconds: the same command continues it
                solved += rec["solved"]
                if solved >= wanted:
                    break
    return 0


if __name__ == "__main__":
    sys.exit(main())
