"""n-step return assembly at sample time (``deep_q_learning_tpu/replay/nstep.py``).

Each env's transitions sit in consecutive ring slots, so sampling an
``(env, slot)`` pair and gathering the next ``n`` slots yields the forward
window in time order:

    G         = sum_{k<K} gamma^k r_{t+k}     K = steps until first stop (<= n)
    bootstrap = gamma^K * nonterminal_at_stop
    batch     = (s_t, a_t, G, s_{t+K}, bootstrap)
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LearnBatch:
    """What the learner consumes: the n-step return and the bootstrap factor
    (gamma^K * nonterminal), so the TD target is ``G + bootstrap * boot``."""

    obs: torch.Tensor  # (B, D)
    action: torch.Tensor  # (B,) int32
    reward: torch.Tensor  # (B,) n-step discounted return G
    next_obs: torch.Tensor  # (B, D) state s_{t+K} to bootstrap from
    bootstrap: torch.Tensor  # (B,) gamma^K * (0 if the stop was a termination)


def valid_slot_mask(
    capacity: int, cursor: int, filled: int, n_step: int, device=None
) -> torch.Tensor:
    """(C,) bool: slots whose n-step window lies inside the stored,
    time-ordered region (age rank <= filled - n)."""
    start = (cursor - filled) % capacity  # oldest stored slot
    ranks = (torch.arange(capacity, device=device) - start) % capacity
    return ranks < max(filled - (n_step - 1), 0)


def assemble_learn_batch(
    storage,  # RingStorage (replay/uniform.py)
    env_idx: torch.Tensor,  # (B,) int64
    slot_idx: torch.Tensor,  # (B,) int64
    gamma: float,
    n_step: int,
    truncation_bootstrap: bool,
) -> LearnBatch:
    """Gather the n-slot forward windows (one ``(B, n, 4)`` gather of the
    packed aux lane) and fold them into a :class:`LearnBatch`."""
    from deep_q_learning_tpu_torch.replay.uniform import (
        AUX_ACTION,
        AUX_REWARD,
        AUX_TERM,
        AUX_TRUNC,
    )

    capacity = storage.aux.shape[0]
    b = env_idx.shape[0]
    device = env_idx.device

    offsets = torch.arange(n_step, device=device)
    win = (slot_idx[:, None] + offsets[None, :]) % capacity  # (B, n)
    aux_win = storage.aux[win, env_idx[:, None]]  # (B, n, 4)
    rewards = aux_win[..., AUX_REWARD]
    term = aux_win[..., AUX_TERM]
    trunc = aux_win[..., AUX_TRUNC]
    stop = torch.clamp(term + trunc, 0.0, 1.0)

    # alive_k = 1 iff no stop among transitions 0..k-1 (the stopping
    # transition itself is still included)
    alive = torch.cumprod(
        torch.cat([torch.ones((b, 1), device=device), 1.0 - stop[:, :-1]], dim=1), dim=1
    )

    discounts = gamma ** offsets.to(torch.float32)
    g = torch.sum(alive * discounts[None, :] * rewards, dim=1)

    k = torch.sum(alive, dim=1)  # number of included steps
    last_off = (k - 1.0).to(torch.int64)
    last_slot = (slot_idx + last_off) % capacity

    stopped_term = torch.sum(alive * term, dim=1)
    stopped_trunc = torch.sum(alive * trunc, dim=1)
    if truncation_bootstrap:
        nonterm = 1.0 - stopped_term
    else:  # ref-compat: truncation also cuts the bootstrap
        nonterm = 1.0 - torch.clamp(stopped_term + stopped_trunc, 0.0, 1.0)

    bootstrap = (gamma**k) * nonterm

    return LearnBatch(
        obs=storage.obs[slot_idx, env_idx],
        action=aux_win[:, 0, AUX_ACTION].to(torch.int32),
        reward=g,
        next_obs=storage.next_obs[last_slot, env_idx],
        bootstrap=bootstrap,
    )
