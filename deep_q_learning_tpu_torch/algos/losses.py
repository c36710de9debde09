"""TD losses over a :class:`~deep_q_learning_tpu_torch.replay.nstep.LearnBatch`
(``deep_q_learning_tpu/algos/losses.py``) — the plain PyTorch learner path.

    td   = stop_grad(G + bootstrap · boot(s')) − Q(s, a)
    loss = mean(w · huber_δ(td))

``ref_terminal_quirk`` reproduces the reference's terminal target
``q[a] + r`` where ``bootstrap == 0`` (see the JAX module).

The JAX builders take ``apply_fn(params, x)``; in the port the networks
are modules, so a loss function takes the online and target networks
themselves: ``loss_fn(online, target, batch, weights) -> (loss, td)``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deep_q_learning_tpu_torch.replay.nstep import LearnBatch


def huber(err: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber loss on residuals (optax.huber_loss semantics)."""
    abs_err = err.abs()
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad**2 + delta * (abs_err - quad)


def td_targets(
    q_next_online: torch.Tensor,  # (B, A) Q(s', .) under the online net
    q_next_target: torch.Tensor,  # (B, A) Q(s', .) under the target net
    reward: torch.Tensor,  # (B,) n-step return G
    bootstrap: torch.Tensor,  # (B,) gamma^K · nonterminal
    double: bool = True,
) -> torch.Tensor:
    """Scalar targets ``G + bootstrap · boot``: double DQN bootstraps from
    ``Q_target(s', argmax_a Q_online(s', a))``, else ``max_a Q_target``."""
    if double:
        best = torch.argmax(q_next_online, dim=-1)
        boot = torch.take_along_dim(q_next_target, best[:, None], dim=-1)[:, 0]
    else:
        boot = q_next_target.max(dim=-1).values
    return reward + bootstrap * boot


def build_loss_fn(
    double: bool = True,
    loss: str = "huber",
    huber_delta: float = 1.0,
    ref_terminal_quirk: bool = False,
) -> Callable:
    """Returns ``loss_fn(online, target, batch, weights) -> (loss, td)``.

    ``weights`` are per-sample importance weights (ones for uniform
    replay); ``td`` (detached) feeds PER priority updates."""
    if loss not in ("huber", "mse"):
        raise ValueError(f"unknown loss {loss!r}")

    def loss_fn(
        online: Callable, target: Callable, batch: LearnBatch, weights: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        # one online forward over [s; s']
        b = batch.obs.shape[0]
        q_both = online(torch.cat([batch.obs, batch.next_obs], dim=0))
        q_s, q_next_online = q_both[:b], q_both[b:].detach()
        with torch.no_grad():
            q_next_target = target(batch.next_obs)

        targets = td_targets(
            q_next_online, q_next_target, batch.reward, batch.bootstrap, double
        )
        q_taken = torch.take_along_dim(q_s, batch.action.long()[:, None], dim=-1)[:, 0]
        if ref_terminal_quirk:
            targets = torch.where(batch.bootstrap > 0, targets, q_taken + batch.reward)

        td_err = targets.detach() - q_taken
        if loss == "huber":
            per_sample = huber(td_err, huber_delta)
        else:
            per_sample = 0.5 * td_err**2
        return torch.mean(weights * per_sample), td_err.detach()

    return loss_fn
