"""The port's CLI (``python -m deep_q_learning_tpu_torch``): config
overrides, the presets listing, the option it refuses, a tiny
train -> resume -> eval round trip on ``--device cpu`` (as
``tests/test_cli.py`` drives the JAX package's CLI), ``train
--distributed`` at world size 1, ``eval --rollout-dir``, and ``hpo``,
whose first round of parameters comes from the seed alone and so equals
the JAX CLI's."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deep_q_learning_tpu.__main__ import build_config as jax_build_config
from deep_q_learning_tpu_torch.__main__ import build_config, main

REPO = Path(__file__).resolve().parents[1]

OVERRIDES = [
    "num_envs=8", "hidden=16,16", "target_tau=0.01", "max_grad_norm=none",
    "double=true", "use_pallas_sampler=on", "solve_threshold=123.5",
]


def test_build_config_overrides_match_jax():
    cfg = build_config("lunar_per_scaled", OVERRIDES)
    assert cfg.num_envs == 8 and cfg.hidden == (16, 16)
    assert cfg.target_tau == pytest.approx(0.01) and cfg.max_grad_norm is None
    assert cfg.use_pallas_sampler is True and cfg.solve_threshold == pytest.approx(123.5)
    assert cfg.per_max_decay == 0.999 and cfg.train_every == 4  # the preset's own
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_build_config("lunar_per_scaled", OVERRIDES)
    )


@pytest.mark.parametrize("preset,override", [
    ("lunar_per", "nonsense=1"),
    ("lunar_per", "double=maybe"),
    ("lunar_per", "num_envs"),
    ("no_such_preset", "num_envs=8"),
])
def test_build_config_rejects(preset, override):
    with pytest.raises(SystemExit):
        build_config(preset, [override])


def test_presets_listing(capsys):
    assert main(["presets", "--fields"]) == 0
    out = capsys.readouterr().out
    assert "lunar_per_scaled" in out and "use_pallas_sampler" in out


@pytest.mark.parametrize("argv,item", [
    (["train", "--preset", "lunar_per", "--aot-cache", "x"], "by design"),
])
def test_options_not_ported_are_refused(argv, item):
    with pytest.raises(SystemExit, match=item):
        main(argv)


TINY = [
    "--preset", "lunar_per_scaled", "--device", "cpu",
    "--set", "num_envs=8", "--set", "steps_per_superstep=8", "--set", "hidden=16,16",
    "--set", "batch_size=16", "--set", "buffer_capacity=256", "--set", "training_start=32",
    "--set", "return_window=4", "--set", "use_pallas_sampler=true",
]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_resume_eval_roundtrip(tmp_path, capsys):
    wd = str(tmp_path / "run")
    assert main(["train", *TINY, "--max-env-steps", "128", "--log-every", "1",
                 "--checkpoint-every", "1", "--workdir", wd, "--quiet",
                 "--history-out", str(tmp_path / "hist.jsonl")]) == 0
    first = _last_json(capsys)
    assert first["env_steps"] == 128 and first["updates"] == 4
    hist = [json.loads(line) for line in open(tmp_path / "hist.jsonl")]
    assert [h["env_steps"] for h in hist] == [64, 128]
    assert sorted(p.name for p in Path(wd).iterdir()) == ["128.pt", "64.pt", "config.json"]

    assert main(["train", *TINY, "--resume", "--max-env-steps", "192", "--log-every", "1",
                 "--checkpoint-every", "1", "--workdir", wd, "--quiet"]) == 0
    resumed = _last_json(capsys)
    assert resumed["env_steps"] == 192 and resumed["updates"] == 6
    assert resumed["episodes"] >= first["episodes"]

    assert main(["eval", *TINY, "--workdir", wd, "--quiet"]) == 0
    report = _last_json(capsys)
    assert report["step"] == 192 and report["episodes"] == 10 and report["length_mean"] > 0

    with pytest.raises(SystemExit, match="requires --workdir"):
        main(["train", *TINY, "--resume"])
    with pytest.raises(ValueError, match="config mismatch"):
        main(["eval", *TINY, "--set", "hidden=8,8", "--workdir", wd])


@pytest.mark.parametrize("quiet", [True, False])
def test_cli_train_distributed_world_one(quiet, tmp_path, capsys):
    """``train --distributed`` from a plain launch: one gloo rank, step
    directories, a resume that goes on from the saved counters, and no
    process group left behind."""
    import torch.distributed as dist

    wd = str(tmp_path / "run")
    q = ["--quiet"] if quiet else []
    assert main(["train", *TINY, "--distributed", "--max-env-steps", "128", "--log-every", "1",
                 "--checkpoint-every", "1", "--workdir", wd, *q]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    first = json.loads(out[-1])
    assert len(out) == (1 if quiet else 3)  # a progress line a log point
    assert first["env_steps"] == 128 and first["updates"] == 4 and first["world_size"] == 1
    assert sorted(p.name for p in Path(wd).iterdir()) == ["128", "64", "config.json"]
    assert sorted(p.name for p in (Path(wd) / "128").iterdir()) == ["learner.pt", "shard_0.pt"]
    assert json.load(open(Path(wd) / "config.json"))["world_size"] == 1
    assert not dist.is_initialized()
    assert main(["train", *TINY, "--distributed", "--resume", "--max-env-steps", "192",
                 "--log-every", "1", "--workdir", wd, "--quiet"]) == 0
    resumed = _last_json(capsys)
    assert resumed["env_steps"] == 192 and resumed["updates"] == 6


CARTPOLE = [
    "--preset", "cartpole_vector", "--device", "cpu", "--set", "num_envs=8",
    "--set", "steps_per_superstep=8", "--set", "hidden=16,16", "--set", "batch_size=16",
    "--set", "buffer_capacity=256", "--set", "training_start=32", "--set", "return_window=4",
]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny lander and a tiny CartPole checkpoint, by preset arguments."""
    out = {}
    for name, args in (("lander", TINY), ("cartpole", CARTPOLE)):
        wd = str(tmp_path_factory.mktemp(name) / "run")
        assert main(["train", *args, "--max-env-steps", "64", "--log-every", "1",
                     "--checkpoint-every", "1", "--workdir", wd, "--quiet"]) == 0
        out[name] = (args, wd)
    return out


@pytest.mark.parametrize("env,extra,figures", [
    ("lander", ["--rollouts", "2"], ["png"]),
    ("lander", ["--rollouts", "1", "--render", "gif"], ["png", "gif"]),
    ("cartpole", ["--rollouts", "2"], []),
], ids=["rollouts", "render-gif", "cartpole"])
def test_cli_eval_rollout_dir(env, extra, figures, checkpoints, tmp_path, capsys):
    """``eval --rollout-dir``: ``rollout_<i>.npz`` with the JAX keys and,
    for the lander, the flight-path PNG and, with ``--render gif``, the
    animated replay; each return printed and in the summary."""
    if figures:
        pytest.importorskip("matplotlib")
    if "gif" in figures:
        pytest.importorskip("PIL")
    args, wd = checkpoints[env]
    out_dir = tmp_path / "rollouts"
    capsys.readouterr()
    assert main(["eval", *args, "--workdir", wd, "--rollout-dir", str(out_dir), *extra,
                 "--quiet"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    n = int(extra[1])
    assert len(report["rollouts"]) == n
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        f"rollout_{i}.{ext}" for i in range(n) for ext in ["npz", *figures])
    keys = {"obs", "action", "reward", "done", "length", "ret"}
    if env == "lander":
        keys |= {"extra_x", "extra_y", "extra_angle", "static_terrain"}
    for i, roll in enumerate(report["rollouts"]):
        assert lines[i].startswith(f"rollout {i}: return={roll['return']:.1f} ")
        traj = np.load(out_dir / f"rollout_{i}.npz")
        assert set(traj) == keys
        assert int(traj["length"]) == roll["length"] == traj["obs"].shape[0]


def test_module_runs_as_a_program():
    proc = subprocess.run(
        [sys.executable, "-m", "deep_q_learning_tpu_torch", "presets"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "lunar_per_scaled" in proc.stdout


@pytest.mark.parametrize("argv,trains", [
    # the classic group: CartPole seeds until two solve (seed 1 misses here),
    # then Acrobot and MountainCar at seed 0, which solve
    (["--group", "classic"], [("cartpole_vector", 0, 42_000_000), ("cartpole_vector", 1, 42_000_000),
                              ("cartpole_vector", 2, 42_000_000), ("acrobot_vector", 0, 4_000_000),
                              ("mountain_car_vector", 0, 13_000_000)]),
    # --preset/--seeds: every seed, at the preset's budget
    (["--preset", "cartpole_vector", "--seeds", "0,2,3"],
     [("cartpole_vector", s, 42_000_000) for s in (0, 2, 3)]),
    # the lunar group: the scaled preset, then the single lunar_per learner
    (["--group", "lunar"], [("lunar_per_scaled", 0, 63_000_000), ("lunar_per", 0, 30_000_000)]),
    (["--preset", "lunar_per", "--seeds", "0"], [("lunar_per", 0, 30_000_000)]),
    # the jointed flagship, its greedy evaluation every 50 supersteps
    (["--group", "jointed"], [("lunar_jointed_per", 0, 6_000_000)]),
])
def test_solves_drive_the_cli(argv, trains, tmp_path, monkeypatch):
    """``solves.py`` runs ``train`` at the CLI's default ``--log-every`` with
    a greedy evaluation every 10 supersteps (50 for the jointed preset), and
    ``eval`` of each solve."""
    from deep_q_learning_tpu_torch import solves

    calls = []

    def fake_cli(args, log, device):
        calls.append(args)
        assert device == "cpu" and "--log-every" not in args
        if args[0] == "eval":
            return {"step": 10, "return_mean": 500.0}
        seed = int(args[args.index("--seed") + 1])
        with open(args[args.index("--history-out") + 1], "w") as f:
            f.write(json.dumps({"window_mean": 480.0, "eval_mean": 490.0}) + "\n")
        return {"solved": seed != 1, "env_steps": 10, "wall_time_s": 2.0,
                "final_window_mean": 480.0, "episodes": 3, "updates": 4}

    monkeypatch.setattr(solves, "cli", fake_cli)
    assert solves.main([*argv, "--device", "cpu", "--out", str(tmp_path)]) == 0
    got = [(a[a.index("--preset") + 1], int(a[a.index("--seed") + 1]),
            int(a[a.index("--max-env-steps") + 1])) for a in calls if a[0] == "train"]
    assert got == trains
    assert all(a[a.index("--eval-every") + 1] == str(solves.EVAL_EVERY.get(preset, 10))
               for a, (preset, *_) in zip([a for a in calls if a[0] == "train"], trains))
    summary = [json.loads(line) for line in open(tmp_path / "summary.jsonl")]
    assert [(r["preset"], r["seed"]) for r in summary] == [t[:2] for t in trains]
    assert all(r["card"] == "cpu" and r["env_steps_per_s"] == 5.0 for r in summary)
    assert [r["greedy_eval"] is not None for r in summary] == [r["solved"] for r in summary]
    if "--seeds" in argv and "," in argv[-1]:  # several seeds' records and their solves
        out = tmp_path / "runs.json"
        assert solves.main([*argv, "--out", str(tmp_path), "--artifact", str(out)]) == 0
        rec = json.loads(out.read_text())
        assert [r["seed"] for r in rec["runs"]] == rec["seeds"] == [0, 2, 3]
        assert rec["solved"] == 3 and all(r["solve_env_steps"] == 10 for r in rec["runs"])


def test_solves_resume_a_run_cut_by_its_time_limit(tmp_path, monkeypatch):
    """A call cut by ``--max-seconds`` leaves its workdir; the same command
    then runs ``train --resume`` in it, appends the history (each line
    tagged with its call, env steps continuous), and once the run has
    finished it is not run again."""
    from deep_q_learning_tpu_torch import solves

    calls = []
    progress = iter([(640, False), (1280, True)])

    def fake_cli(args, log, device):
        calls.append(args)
        if args[0] == "eval":
            return {"step": 1280, "return_mean": 210.0}
        workdir = args[args.index("--workdir") + 1]
        steps, solved = next(progress)
        os.makedirs(workdir, exist_ok=True)
        open(os.path.join(workdir, f"{steps}.pt"), "w").close()
        with open(args[args.index("--history-out") + 1], "w") as f:
            for k in (1, 2):
                f.write(json.dumps({"env_steps": steps - 640 + 320 * k,
                                    "window_mean": 100.0 * k}) + "\n")
        return {"solved": solved, "env_steps": steps, "wall_time_s": 64.0, "episodes": 9,
                "updates": steps // 8, "final_window_mean": 200.0 if solved else 100.0}

    monkeypatch.setattr(solves, "cli", fake_cli)
    argv = ["--preset", "lunar_jointed_per", "--seeds", "0", "--device", "cpu",
            "--out", str(tmp_path), "--max-seconds", "60"]
    for _ in range(3):
        assert solves.main(argv) == 0
    trains = [a for a in calls if a[0] == "train"]
    assert len(trains) == 2 and "--resume" not in trains[0] and "--resume" in trains[1]
    assert all(a[a.index("--max-seconds") + 1] == "60.0" and "--keep-newest" in a
               for a in trains)
    workdirs = {a[a.index("--workdir") + 1] for a in trains}
    assert len(workdirs) == 1
    assert [a[0] for a in calls] == ["train", "train", "eval"]
    history = [json.loads(line) for line in open(tmp_path / "lunar_jointed_per_seed0.jsonl")]
    assert [(h["call"], h["env_steps"]) for h in history] == [(1, 320), (1, 640), (2, 960),
                                                             (2, 1280)]
    summary = [json.loads(line) for line in open(tmp_path / "summary.jsonl")]
    assert [(r["call"], r["finished"], r["solved"]) for r in summary] == [
        (1, False, False), (2, True, True), (2, True, True)]
    assert summary[1]["env_steps_per_s"] == 10.0 and summary[1]["greedy_eval"]["step"] == 1280
    # the run's record, from its files alone
    assert solves.main(["--preset", "lunar_jointed_per", "--seeds", "0", "--out", str(tmp_path),
                        "--artifact", str(tmp_path / "run.json")]) == 0
    rec = json.loads((tmp_path / "run.json").read_text())
    assert (rec["solved"], rec["solve_env_steps"], rec["wall_time_s"]) == (True, 1280, 128.0)
    assert [c["call"] for c in rec["calls"]] == [1, 2] and rec["curve"] == history
    assert rec["greedy_eval"]["return_mean"] == 210.0
    assert set(rec["jax_references"]) == set(solves.JAX_ARTIFACTS["lunar_jointed_per"])
    assert [a[0] for a in calls] == ["train", "train", "eval"]  # it ran nothing


HPO_SETS = ["--set", "num_envs=8", "--set", "steps_per_superstep=8", "--set", "hidden=16,16",
            "--set", "batch_size=16", "--set", "buffer_capacity=512", "--set", "training_start=32",
            "--set", "return_window=8", "--set", "max_steps_in_episode=20"]


@pytest.mark.parametrize("population", [1, 2])
def test_cli_hpo_writes_the_history_and_the_jax_first_round(population, tmp_path, capsys,
                                                            monkeypatch):
    """``hpo`` on the CPU: one history line a trial and the final JSON line.
    The first round's parameters come from the seed's ``rng.rand`` alone, so
    they equal the JAX CLI's (whose objective is stubbed here: only the
    parameters are compared)."""
    from deep_q_learning_tpu.__main__ import main as jax_main
    from deep_q_learning_tpu.hpo import bayesopt as jax_bo

    argv = ["hpo", "--preset", "lunar_per", "--space", "lunar", "--trials", "4",
            "--population", str(population), "--steps-per-trial", "128", "--seed", "3",
            "--quiet", *HPO_SETS]
    assert main([*argv, "--device", "cpu", "--history-out", str(tmp_path / "port.jsonl")]) == 0
    result = _last_json(capsys)
    ours = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    assert len(ours) == 4 and all(np.isfinite(t["objective"]) for t in ours)
    assert result["best_objective"] == max(t["objective"] for t in ours)

    def stub(*args, **kwargs):
        return lambda c: [0.0] * len(c) if isinstance(c, list) else 0.0

    monkeypatch.setattr(jax_bo, "make_population_objective", stub)
    monkeypatch.setattr(jax_bo, "make_dqn_objective", stub)
    assert jax_main([*argv, "--history-out", str(tmp_path / "jax.jsonl")]) == 0
    theirs = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    first = population if population > 1 else 4  # optimize: its random init trials
    assert [t["params"] for t in ours[:first]] == [t["params"] for t in theirs[:first]]
