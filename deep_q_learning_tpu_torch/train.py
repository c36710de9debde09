"""Trainer — the host-side loop (``deep_q_learning_tpu/train.py``).

It builds the env, network, replay and superstep for one config on one
explicit device, runs supersteps until the window is solved or the
env-step budget is spent, checkpoints the full runner into ``workdir``
(with the resolved config beside it, as ``config.json``) and evaluates the
greedy policy.  :class:`DistributedTrainer` runs the same loop on one rank
of a process group: envs split over the ranks, the learner replicated and
its gradients all-reduced (``parallel/distributed.py``).  The JAX
package's AOT cache is not ported, by design (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deep_q_learning_tpu_torch.algos import build_superstep, make_optimizer
from deep_q_learning_tpu_torch.algos.evaluate import EvalResult, build_evaluator
from deep_q_learning_tpu_torch.config import config_shape_mismatches, config_to_dict
from deep_q_learning_tpu_torch.envs import VectorEnv, make_env
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.models.networks import compute_dtype_of
from deep_q_learning_tpu_torch.replay import make_replay
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt


def _write_config_json(workdir: str, cfg, **extra) -> None:
    """Keep the resolved config (and ``extra`` keys) beside the
    checkpoints, so that eval and resume can check that they rebuild the
    same shapes."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "config.json")
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dict(config_to_dict(cfg), **extra), f, indent=1)
    os.replace(tmp, path)


def _check_config_json(workdir: str, cfg) -> dict:
    """The saved config (empty without one); raises where its
    shape-affecting fields differ from ``cfg``'s."""
    path = os.path.join(workdir, "config.json")
    if not os.path.exists(path):
        return {}
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
    return saved


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


def set_matmul_precision(cfg) -> None:
    """Check ``cfg.compute_dtype`` and make every matmul accumulate in full
    float32, as the reference values are computed (process-wide): TF32 off
    for matmuls and cuDNN, and bf16 products without reduced-precision
    reductions."""
    compute_dtype_of(cfg.compute_dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Trainer:
    """Build-once, step-many trainer for one config on one device.  The
    network's trunk runs in ``cfg.compute_dtype`` (float32 or bfloat16);
    parameters, optimizer state, Q-values and everything else stay
    float32.  The lander's vector step and reset pool, in training and in
    evaluation, run as CUDA graphs on the card (``envs/base.py::
    VectorEnv``), the classic envs' too, and so does each training frame,
    the actor and the learner update included, with either replay
    (``algos/superstep.py::GraphedLearner``), and each greedy eval step
    (``algos/evaluate.py``); ``graphed=False`` runs them eagerly, with the
    same results, and ``graphed_learner=False`` runs the frame and the eval
    step eagerly around the graphed vector step."""

    def __init__(self, cfg, device="cuda", workdir: Optional[str] = None, graphed: bool = True,
                 graphed_learner: bool = True):
        set_matmul_precision(cfg)
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        self.env, self.env_params = make_env(
            cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
            param_overrides=cfg.env_param_overrides(),
        )
        self.venv = VectorEnv(self.env, cfg.num_envs, graphed=graphed)
        (obs_dim,) = self.env.obs_shape(self.env_params)
        self.network = QNetwork(
            obs_dim, self.env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling,
            compute_dtype=cfg.compute_dtype,
        )
        self.optimizer = make_optimizer(cfg)
        self.replay = make_replay(cfg)
        self._init_runner, self._superstep = build_superstep(
            self.venv, self.env_params, self.network, self.optimizer, self.replay,
            cfg, self.device, graphed_learner=graphed_learner,
        )
        # >= 10 parallel greedy episodes (the reference evaluates 10)
        self.eval_venv = VectorEnv(self.env, min(max(cfg.num_envs, 10), 128), graphed=graphed)
        self._evaluate = build_evaluator(
            self.eval_venv, self.env_params, self.env_params.max_steps_in_episode,
            graphed=graphed_learner,
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
        max_seconds: Optional[float] = None,
        keep_newest: bool = False,
    ) -> TrainResult:
        """Run supersteps until solved or the env-step budget is spent.

        As in the JAX package, the solve, the budget and the checkpoint are
        decided only at log points (every ``log_every`` supersteps), so a
        run stops at the same env step in both.  With a ``workdir``, a
        checkpoint is saved at every log point that is also a multiple of
        ``checkpoint_every``, and once more after a solve; ``keep_newest``
        deletes the older ones at each.  ``eval_every`` (in supersteps)
        interleaves greedy evaluation at log points.  ``max_seconds`` also
        stops the run at the first log point past that wall time, with a
        checkpoint there (a run longer than one process continues with
        ``restore``).  Supersteps are counted from the runner's, so a
        restored run keeps its log, evaluation and checkpoint cadence."""
        if self.runner is None:
            self.init()
        cfg = self.cfg
        t0 = time.time()
        solved = False
        i = self.runner.env_step // cfg.steps_per_superstep
        last_steps, last_time = self.runner.env_step * cfg.num_envs, t0
        while True:
            m = self.step()
            i += 1
            if i % log_every:
                continue
            env_steps = m.env_steps * cfg.num_envs
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
            solved = m.solved
            out_of_time = max_seconds is not None and now - t0 >= max_seconds
            saved = bool(self.workdir and checkpoint_every and i % checkpoint_every == 0)
            if saved:
                self._save(env_steps, keep_newest)
            if solved or env_steps >= max_env_steps or out_of_time:
                break
        env_steps = m.env_steps * cfg.num_envs
        if self.workdir and (solved or (out_of_time and not saved)):
            self._save(env_steps, keep_newest)
        return TrainResult(
            solved=solved,
            env_steps=env_steps,
            episodes=m.episodes,
            wall_time_s=time.time() - t0,
            final_window_mean=m.window_mean,
            history=self.history,
        )

    def evaluate(self, seed: int = 0, max_steps: Optional[int] = None) -> EvalResult:
        """Greedy eval: true per-episode returns, as numpy arrays.  Episodes
        are cut at the env's ``max_steps_in_episode``, or at ``max_steps``."""
        if self.runner is None:
            raise RuntimeError("call init() first")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        ev = self._evaluate(self.runner.train.online, generator, max_steps)
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

    def _save(self, step: int, keep_newest: bool) -> None:
        self.save(step)
        if keep_newest:
            ckpt.prune_checkpoints(self.workdir)

    def restore(self, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (the latest if None) from
        ``workdir``, after checking ``config.json`` against this config."""
        if not self.workdir:
            raise ValueError("Trainer(workdir=...) is required for checkpointing")
        _check_config_json(self.workdir, self.cfg)
        template = self.runner if self.runner is not None else self._init_runner(self.cfg.seed)
        self.runner = ckpt.restore_checkpoint(self.workdir, template, step)
        return self

    def save_pickle_compat(self, directory: str) -> None:
        """The learner in the reference's on-disk format: ``params.pickle``
        and ``opt_state.pickle`` (``utils/checkpoint.py``)."""
        if self.runner is None:
            raise RuntimeError("call init() first")
        ckpt.save_params_pickle(
            directory, *ckpt.to_reference_format(self.runner.train, self.optimizer)
        )


class DistributedTrainer(Trainer):
    """:class:`Trainer` on one rank of a process group (the default group
    if ``group`` is None; ``parallel.distributed_init`` makes it): this
    rank's share of the envs and of the batch, its own replay and
    generator, and the learner replicated on every rank, its gradients
    all-reduced.  ``device="cuda"`` puts the rank on
    ``parallel.rank_device``'s card.

    Every rank runs the same ``train`` loop on metrics combined over the
    ranks, so all decide the same log points, checkpoints and stop; only
    rank 0 prints.  ``evaluate`` evaluates the replicated learner and gives
    the same result on every rank.  Checkpoints are step directories
    (``utils/checkpoint.py``); ``config.json`` records the world size, and
    a restore under another world size raises.

    Each frame runs as CUDA graph launches, as :class:`Trainer`'s, the
    update split in two graphs at the gradient all-reduce, which runs
    eagerly between them (``algos/superstep.py::GraphedLearner``), and
    each greedy eval step is a graph; ``graphed_learner=False`` runs them
    eagerly, with the same results."""

    def __init__(self, cfg, device="cuda", workdir: Optional[str] = None, group=None,
                 graphed_learner: bool = True):
        from deep_q_learning_tpu_torch.parallel.distributed import build_distributed_superstep
        from deep_q_learning_tpu_torch.parallel.mesh import rank_device

        set_matmul_precision(cfg)
        self.cfg = cfg
        self.workdir = workdir
        self.group = group
        self.device = rank_device(resolve_device(device))
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._init_runner, self._superstep, self.network = build_distributed_superstep(
            cfg, self.device, group, graphed_learner
        )
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.optimizer = make_optimizer(cfg)
        self.env, self.env_params = make_env(
            cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
            param_overrides=cfg.env_param_overrides(),
        )
        self.eval_venv = VectorEnv(self.env, 128)
        self._evaluate = build_evaluator(
            self.eval_venv, self.env_params,
            self.env_params.max_steps_in_episode, graphed=graphed_learner,
        )
        self.runner = None
        self.history: List[Dict[str, float]] = []

    def train(
        self,
        max_env_steps: int = 10_000_000,
        log_every: int = 10,
        checkpoint_every: Optional[int] = None,
        verbose: bool = True,
    ) -> TrainResult:
        """:meth:`Trainer.train`'s loop and cadence on combined metrics."""
        return super().train(
            max_env_steps, log_every, checkpoint_every, verbose=verbose and self.rank == 0
        )

    def _barrier(self) -> None:
        """Wait for every rank (a collective the host waits on, whatever
        the backend)."""
        token = torch.zeros((1,), device=self.device)
        dist.all_reduce(token, group=self.group)
        token.item()

    def save(self, step: int) -> str:
        """Checkpoint into ``workdir/<step>/``: the learner once, a shard a
        rank.  Every rank calls it and returns once all have written."""
        if not self.workdir:
            raise ValueError("DistributedTrainer(workdir=...) is required for checkpointing")
        if self.runner is None:
            raise RuntimeError("call init() first")
        if self.rank == 0:
            _write_config_json(self.workdir, self.cfg, world_size=self.world_size)
        out = ckpt.save_sharded_checkpoint(self.workdir, self.runner, step, self.rank)
        self._barrier()
        return out

    def restore(self, step: Optional[int] = None):
        """Load this rank's runner from ``workdir/<step>/`` (the latest if
        None), after checking ``config.json``: the same shapes, and the same
        world size."""
        if not self.workdir:
            raise ValueError("DistributedTrainer(workdir=...) is required for checkpointing")
        saved = _check_config_json(self.workdir, self.cfg)
        if saved.get("world_size", self.world_size) != self.world_size:
            raise ValueError(
                f"the checkpoint in {self.workdir} was written by {saved['world_size']} ranks "
                f"and this run has {self.world_size}: restore it with {saved['world_size']} ranks"
            )
        template = self.runner if self.runner is not None else self._init_runner(self.cfg.seed)
        self.runner = ckpt.restore_sharded_checkpoint(self.workdir, template, self.rank, step)
        return self
