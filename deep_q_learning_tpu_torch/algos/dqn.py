"""DQN learner (``deep_q_learning_tpu/algos/dqn.py``): runtime
hyperparameters, train state, an optimizer with optax semantics, the update
step and the ε schedules.

Optimizer semantics follow optax, not ``torch.optim`` (ROADMAP.md, "Optimizer
and init defaults"):
  * ``clip_by_global_norm(m)`` leaves the gradients alone when the global
    norm is below ``m`` and scales them by ``m / norm`` otherwise;
  * adam bias-corrects both moments and adds ``eps`` outside the sqrt;
  * adamw's weight decay defaults to 1e-4 and is added to the adam update
    before the learning-rate scale; rmsprop adds ``eps`` inside the sqrt
    with decay 0.9.
The learning rate and the clip norm are read from :class:`HyperParams` at
every update, as ``optax.inject_hyperparams`` allows in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deep_q_learning_tpu_torch.algos.losses import build_loss_fn
from deep_q_learning_tpu_torch.replay.nstep import LearnBatch


@dataclasses.dataclass
class HyperParams:
    """Runtime hyperparameters, as Python numbers: changing one between
    supersteps changes no program structure."""

    gamma: float
    eps_start: float
    eps_min: float
    eps_decay: float
    eps_decay_steps: float
    learning_rate: float
    max_grad_norm: float  # unused when cfg.max_grad_norm is None
    target_tau: float  # unused when cfg.target_tau is None (hard sync)
    per_beta: float
    train_every: int
    training_start: int
    target_sync_every: int
    target_replace_episodes: int

    @classmethod
    def from_config(cls, cfg) -> "HyperParams":
        return cls(
            gamma=float(cfg.gamma),
            eps_start=float(cfg.eps_start),
            eps_min=float(cfg.eps_min),
            eps_decay=float(cfg.eps_decay),
            eps_decay_steps=float(cfg.eps_decay_steps),
            learning_rate=float(cfg.learning_rate),
            max_grad_norm=math.inf if cfg.max_grad_norm is None else float(cfg.max_grad_norm),
            target_tau=0.0 if cfg.target_tau is None else float(cfg.target_tau),
            per_beta=float(cfg.per_beta),
            train_every=int(cfg.train_every),
            training_start=int(cfg.training_start),
            target_sync_every=int(cfg.target_sync_every),
            target_replace_episodes=int(cfg.target_replace_episodes),
        )


# ---------------------------------------------------------------------------
# Optimizer (optax semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptState:
    count: int  # updates applied (optax's int32 count)
    mu: List[torch.Tensor]  # first moments (adam/adamw)
    nu: List[torch.Tensor]  # second moments (adam/adamw/rmsprop)


# optax's defaults for the constructors the JAX package calls with the
# learning rate alone (algos/dqn.py::_OPTIMIZERS there)
ADAM_B1, ADAM_B2, EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
RMSPROP_DECAY = 0.9


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), <ctor>(lr))`` as an
    in-place update of a list of parameter tensors."""

    def __init__(self, name: str, clip: bool):
        if name not in ("adam", "adamw", "rmsprop", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.clip = clip

    def init(self, params: List[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        return OptState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def apply(
        self,
        grads: List[torch.Tensor],
        state: OptState,
        params: List[torch.Tensor],
        learning_rate: float,
        max_grad_norm: float = math.inf,
    ) -> None:
        """Update ``params`` and ``state`` in place from ``grads``."""
        grads = list(grads)
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(norm < max_grad_norm, g, g / norm * max_grad_norm) for g in grads]
        state.count += 1
        if self.name in ("adam", "adamw"):
            b1, b2 = ADAM_B1, ADAM_B2
            for m, g in zip(state.mu, grads):
                m.copy_((1 - b1) * g + b1 * m)
            for v, g in zip(state.nu, grads):
                v.copy_((1 - b2) * (g * g) + b2 * v)
            # bias corrections in float32, as optax computes decay**count
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(state.count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(state.count))
            updates = [
                (m / bc1) / (torch.sqrt(v / bc2) + EPS)
                for m, v in zip(state.mu, state.nu)
            ]
            if self.name == "adamw":
                updates = [u + ADAMW_WEIGHT_DECAY * p for u, p in zip(updates, params)]
        elif self.name == "rmsprop":
            d = RMSPROP_DECAY
            for v, g in zip(state.nu, grads):
                v.copy_((1 - d) * (g * g) + d * v)
            updates = [torch.rsqrt(v + EPS) * g for v, g in zip(state.nu, grads)]
        else:  # sgd
            updates = grads
        for p, u in zip(params, updates):
            p.add_(-learning_rate * u)


def make_optimizer(cfg) -> Optimizer:
    """Optimizer from config; the clip is in the chain iff
    ``cfg.max_grad_norm`` is set, as in the JAX package."""
    return Optimizer(cfg.optimizer, clip=cfg.max_grad_norm is not None)


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """Online and target networks, optimizer state, update counter."""

    online: torch.nn.Module
    target: torch.nn.Module
    opt_state: OptState
    updates: int


def init_train_state(network: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    """Train state around an initialised ``network``; the target is a copy
    that takes no gradients."""
    target = copy.deepcopy(network)
    target.requires_grad_(False)
    return TrainState(
        online=network,
        target=target,
        opt_state=optimizer.init(list(network.parameters())),
        updates=0,
    )


# ---------------------------------------------------------------------------
# ε-greedy policy + schedules
# ---------------------------------------------------------------------------

def epsilon_by_schedule(cfg, env_steps: float, episodes, hyper: Optional[HyperParams] = None):
    """Exploration rate from progress counters.  ``linear_step`` uses the
    host-side step count and returns a float; ``exp_episode`` uses the
    device-side episode count (a tensor), rescaled by ``num_envs`` to keep
    the reference's per-env decay rate, and returns a tensor."""
    h = hyper if hyper is not None else HyperParams.from_config(cfg)
    if cfg.eps_schedule == "exp_episode":
        per_env_episodes = episodes.to(torch.float32) / cfg.num_envs
        eps = h.eps_start * h.eps_decay**per_env_episodes
        return torch.clamp(eps, min=h.eps_min)
    elif cfg.eps_schedule == "linear_step":
        frac = min(max(env_steps / h.eps_decay_steps, 0.0), 1.0)
        return h.eps_start + frac * (h.eps_min - h.eps_start)
    raise ValueError(f"unknown eps_schedule {cfg.eps_schedule!r}")


def epsilon_greedy(
    generator: Optional[torch.Generator],
    q_values: torch.Tensor,
    epsilon,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched ε-greedy with ONE uniform per env: ``u < ε`` explores, and
    then ``u / ε`` is again uniform, so ``floor(u / ε · A)`` is a uniform
    random action.  ``u`` may be injected; else it is drawn."""
    n, num_actions = q_values.shape
    greedy = torch.argmax(q_values, dim=-1)
    if u is None:
        u = torch.rand((n,), generator=generator, device=q_values.device)
    explore = u < epsilon
    if isinstance(epsilon, torch.Tensor):
        safe_eps = torch.clamp(epsilon, min=1e-9)
    else:
        safe_eps = max(epsilon, 1e-9)
    random_actions = torch.clamp(
        (u / safe_eps * num_actions).to(torch.int32), max=num_actions - 1
    )
    return torch.where(explore, random_actions, greedy.to(torch.int32))


# ---------------------------------------------------------------------------
# Gradient update
# ---------------------------------------------------------------------------

def build_update_step(optimizer: Optimizer, cfg) -> Callable:
    """Returns ``update(ts, batch, weights, hyper) -> (ts, loss, td)``, which
    applies one gradient step to ``ts`` in place.  ``cfg.use_pallas`` routes
    the TD and loss math through the CUDA kernel (``ops/td_kernels.py``)."""
    if cfg.ref_terminal_quirk and cfg.n_step != 1:
        raise ValueError("ref_terminal_quirk reproduces 1-step semantics; set n_step=1")
    if cfg.use_pallas:
        if cfg.loss != "huber":
            raise ValueError("use_pallas=True supports loss='huber' only")
        if cfg.ref_terminal_quirk:
            raise ValueError(
                "use_pallas=True implements the FIXED terminal semantics; "
                "disable ref_terminal_quirk"
            )
        from deep_q_learning_tpu_torch.ops.td_kernels import build_fused_loss_fn

        loss_fn = build_fused_loss_fn(double=cfg.double, huber_delta=cfg.huber_delta)
    else:
        loss_fn = build_loss_fn(
            double=cfg.double,
            loss=cfg.loss,
            huber_delta=cfg.huber_delta,
            ref_terminal_quirk=cfg.ref_terminal_quirk,
        )

    def update(
        ts: TrainState,
        batch: LearnBatch,
        weights: torch.Tensor,
        hyper: Optional[HyperParams] = None,
    ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        h = hyper if hyper is not None else HyperParams.from_config(cfg)
        params = list(ts.online.parameters())
        loss, td = loss_fn(ts.online, ts.target, batch, weights)
        grads = torch.autograd.grad(loss, params)
        optimizer.apply(grads, ts.opt_state, params, h.learning_rate, h.max_grad_norm)
        if cfg.target_tau is not None:
            # Polyak soft target update every gradient step
            tau = h.target_tau
            with torch.no_grad():
                for t, p in zip(ts.target.parameters(), params):
                    t.copy_((1.0 - tau) * t + tau * p)
        ts.updates += 1
        return ts, loss.detach(), td

    return update


@torch.no_grad()
def sync_target(ts: TrainState, do_sync=True) -> TrainState:
    """Hard target copy.  ``do_sync`` may be a device bool tensor, so the
    copy can be conditional without reading it back to the host."""
    for t, p in zip(ts.target.parameters(), ts.online.parameters()):
        if isinstance(do_sync, torch.Tensor):
            t.copy_(torch.where(do_sync, p, t))
        elif do_sync:
            t.copy_(p)
    return ts
