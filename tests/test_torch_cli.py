"""The port's CLI (``python -m deep_q_learning_tpu_torch``): config
overrides, the presets listing, the options it refuses, and a tiny
train -> resume -> eval round trip on ``--device cpu`` (as
``tests/test_cli.py`` drives the JAX package's CLI)."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

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
    (["hpo", "--preset", "lunar_per", "--trials", "2"], "item H"),
    (["train", "--preset", "lunar_per", "--distributed"], "item I"),
    (["train", "--preset", "lunar_per", "--aot-cache", "x"], "by design"),
    (["eval", "--preset", "lunar_per", "--workdir", "x", "--rollout-dir", "y"], "item G"),
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

    assert main(["train", *TINY, "--resume", "--max-env-steps", "192",
                 "--checkpoint-every", "1", "--workdir", wd, "--quiet"]) == 0
    resumed = _last_json(capsys)
    assert resumed["env_steps"] == 192 and resumed["updates"] == 6
    assert resumed["episodes"] >= first["episodes"]

    assert main(["eval", *TINY, "--workdir", wd]) == 0
    report = _last_json(capsys)
    assert report["step"] == 192 and report["episodes"] == 10 and report["length_mean"] > 0

    with pytest.raises(SystemExit, match="requires --workdir"):
        main(["train", *TINY, "--resume"])
    with pytest.raises(ValueError, match="config mismatch"):
        main(["eval", *TINY, "--set", "hidden=8,8", "--workdir", wd])


def test_module_runs_as_a_program():
    proc = subprocess.run(
        [sys.executable, "-m", "deep_q_learning_tpu_torch", "presets"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "lunar_per_scaled" in proc.stdout
