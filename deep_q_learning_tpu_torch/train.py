"""Trainer — the host-side loop (``deep_q_learning_tpu/train.py``).

It builds the env, network, replay and superstep for one config on one
explicit device, runs supersteps until the window is solved or the
env-step budget is spent, checkpoints the full runner into ``workdir``
(with the resolved config beside it, as ``config.json``) and evaluates the
greedy policy.  The JAX package's AOT cache is not ported, by design
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deep_q_learning_tpu_torch.algos import build_superstep, make_optimizer
from deep_q_learning_tpu_torch.algos.evaluate import EvalResult, build_evaluator
from deep_q_learning_tpu_torch.config import config_shape_mismatches, config_to_dict
from deep_q_learning_tpu_torch.envs import VectorEnv, make_env
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.replay import make_replay
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt


def _write_config_json(workdir: str, cfg) -> None:
    """Keep the resolved config beside the checkpoints, so that eval and
    resume can check that they rebuild the same shapes."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)


def _check_config_json(workdir: str, cfg) -> None:
    path = os.path.join(workdir, "config.json")
    if not os.path.exists(path):
        return
    with open(path) as f:
        saved = json.load(f)
    bad = config_shape_mismatches(saved, cfg)
    if bad:
        detail = ", ".join(f"{k}: checkpoint={v[0]!r} vs current={v[1]!r}" for k, v in bad.items())
        raise ValueError(
            f"config mismatch vs {path}: the checkpoint was written with "
            f"different shape-affecting fields ({detail}); repeat the same "
            f"--preset/--set overrides used at train time"
        )


@dataclasses.dataclass
class TrainResult:
    solved: bool
    env_steps: int
    episodes: int
    wall_time_s: float
    final_window_mean: float
    history: List[Dict[str, float]]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device that is absent raises (the
    port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device} requested but only {torch.cuda.device_count()} GPU(s) exist"
            )
    return device


class Trainer:
    """Build-once, step-many trainer for one config on one device.

    Everything runs in float32: TF32 is switched off for matmuls and cuDNN
    (process-wide), since the reference values are full float32."""

    def __init__(self, cfg, device="cuda", workdir: Optional[str] = None):
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "the PyTorch port runs in float32 only (compute_dtype='bfloat16' "
                "is not ported; see ROADMAP.md)"
            )
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env, self.env_params = make_env(
            cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
            param_overrides=cfg.env_param_overrides(),
        )
        self.venv = VectorEnv(self.env, cfg.num_envs)
        (obs_dim,) = self.env.obs_shape(self.env_params)
        self.network = QNetwork(
            obs_dim, self.env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling
        )
        self.optimizer = make_optimizer(cfg)
        self.replay = make_replay(cfg)
        self._init_runner, self._superstep = build_superstep(
            self.venv, self.env_params, self.network, self.optimizer, self.replay,
            cfg, self.device,
        )
        # >= 10 parallel greedy episodes (the reference evaluates 10)
        eval_venv = VectorEnv(self.env, min(max(cfg.num_envs, 10), 128))
        self._evaluate = build_evaluator(
            eval_venv, self.env_params, self.env_params.max_steps_in_episode
        )
        self.runner = None
        self.history: List[Dict[str, float]] = []

    def init(self, seed: Optional[int] = None):
        self.runner = self._init_runner(self.cfg.seed if seed is None else seed)
        self.history = []
        return self

    def set_hyper(self, **overrides):
        """Change runtime hyperparameters (``algos/dqn.py::HyperParams``):
        gamma, the ε schedule values, learning_rate, max_grad_norm,
        target_tau, per_beta and the cadence ints.  Static config fields
        (shapes, network, replay kind, schedule and sync modes) cannot be
        changed this way."""
        if self.runner is None:
            raise RuntimeError("call init() first")
        hyper = self.runner.hyper
        valid = {f.name for f in dataclasses.fields(hyper)}
        unknown = set(overrides) - valid
        if unknown:
            raise ValueError(f"not runtime hyperparams: {sorted(unknown)} (have {sorted(valid)})")
        self.runner.hyper = dataclasses.replace(
            hyper, **{k: type(getattr(hyper, k))(v) for k, v in overrides.items()}
        )
        return self

    def step(self):
        """One superstep; returns its :class:`SuperstepMetrics`."""
        if self.runner is None:
            self.init()
        self.runner, metrics = self._superstep(self.runner)
        return metrics

    def train(
        self,
        max_env_steps: int = 10_000_000,
        log_every: int = 10,
        checkpoint_every: Optional[int] = None,
        eval_every: Optional[int] = None,
        verbose: bool = True,
    ) -> TrainResult:
        """Run supersteps until solved or the env-step budget is spent.
        With a ``workdir``, a checkpoint is saved every ``checkpoint_every``
        supersteps and when the window is solved.  ``eval_every`` (in
        supersteps) interleaves greedy evaluation."""
        if self.runner is None:
            self.init()
        cfg = self.cfg
        t0 = time.time()
        i = 0
        last_steps, last_time = self.runner.env_step * cfg.num_envs, t0
        while True:
            m = self.step()
            i += 1
            env_steps = m.env_steps * cfg.num_envs
            if i % log_every == 0:
                now = time.time()
                sps = (env_steps - last_steps) / max(now - last_time, 1e-9)
                last_steps, last_time = env_steps, now
                rec = {
                    "superstep": i,
                    "env_steps": env_steps,
                    "episodes": m.episodes,
                    "window_mean": m.window_mean,
                    "epsilon": m.epsilon,
                    "loss": m.loss_sum / max(m.loss_count, 1),
                    "updates": m.loss_count,
                    "steps_per_s": sps,
                    "wall_s": now - t0,
                }
                if eval_every and i % eval_every == 0:
                    ev = self.evaluate(seed=i)
                    rec["eval_mean"] = float(np.mean(ev.returns))
                    rec["eval_truncated"] = int(np.sum(ev.truncated))
                self.history.append(rec)
                if verbose:
                    print(
                        f"[{rec['wall_s']:7.1f}s] steps {env_steps/1e6:8.2f}M "
                        f"episodes {rec['episodes']:7d} window {m.window_mean:8.2f} "
                        f"eps {m.epsilon:.3f} loss {rec['loss']:.4f} "
                        f"({sps/1e6:.3f}M steps/s)",
                        flush=True,
                    )
            if self.workdir and (m.solved or (checkpoint_every and i % checkpoint_every == 0)):
                self.save(step=env_steps)
            if m.solved or env_steps >= max_env_steps:
                break
        return TrainResult(
            solved=m.solved,
            env_steps=env_steps,
            episodes=m.episodes,
            wall_time_s=time.time() - t0,
            final_window_mean=m.window_mean,
            history=self.history,
        )

    def evaluate(self, seed: int = 0) -> EvalResult:
        """Greedy eval: true per-episode returns, as numpy arrays."""
        if self.runner is None:
            raise RuntimeError("call init() first")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        ev = self._evaluate(self.runner.train.online, generator)
        return EvalResult(*(x.cpu().numpy() for x in ev))

    # --------------------------------------------------------- persistence
    def save(self, step: int) -> str:
        """Checkpoint the full runner as ``workdir/<step>.pt``."""
        if not self.workdir:
            raise ValueError("Trainer(workdir=...) is required for checkpointing")
        if self.runner is None:
            raise RuntimeError("call init() first")
        _write_config_json(self.workdir, self.cfg)
        return ckpt.save_checkpoint(self.workdir, self.runner, step)

    def restore(self, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (the latest if None) from
        ``workdir``, after checking ``config.json`` against this config."""
        if not self.workdir:
            raise ValueError("Trainer(workdir=...) is required for checkpointing")
        _check_config_json(self.workdir, self.cfg)
        template = self.runner if self.runner is not None else self._init_runner(self.cfg.seed)
        self.runner = ckpt.restore_checkpoint(self.workdir, template, step)
        return self
