"""Proportional prioritized replay on the device
(``deep_q_learning_tpu/replay/prioritized.py``).

Sample ∝ priority^α, importance weights ``(1/(n·P))^β`` normalised by the
batch max, new transitions at the running max priority, priorities set to
``(|td| + ε)^α`` after each update.  Priorities are a dense ``(N, C)``
array beside the slot-major ring; sampling is two-level: env rows ∝ row
sums, then slots within each chosen row, both by counting cumulative sums
below a uniform draw.  With ``use_pallas`` (the config's
``use_pallas_sampler``) level 2 runs in the CUDA kernel of
``ops/sample_kernels.py``, whose draw is ``u · sum(row)`` as in the JAX
package's Pallas kernel; level 1, the draws and the weights stay here.

The JAX package's one-hot priority update is a TPU workaround; here
duplicate ``(env, slot)`` pairs resolve max-wins through set-to-0 and a
``scatter_reduce`` with ``amax`` (the JAX package's large-N branch).  The
max priority stays a device scalar, so no step reads it back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.ops.sample_kernels import slot_select
from deep_q_learning_tpu_torch.replay.nstep import assemble_learn_batch, valid_slot_mask
from deep_q_learning_tpu_torch.replay.uniform import (
    RingStorage,
    alloc_storage,
    write_row,
)


@dataclasses.dataclass
class PrioritizedReplayState:
    storage: RingStorage  # slot-major packed leaves — see replay/uniform.py
    priorities: torch.Tensor  # (N, C) f32, already exponentiated by alpha
    max_priority: torch.Tensor  # () f32 (pre-alpha magnitude)
    cursor: int
    total_adds: int

    @property
    def capacity_per_env(self) -> int:
        return self.storage.aux.shape[0]

    @property
    def num_envs(self) -> int:
        return self.storage.aux.shape[1]

    @property
    def filled(self) -> int:
        return min(self.total_adds, self.capacity_per_env)


class SampleInfo(NamedTuple):
    env_idx: torch.Tensor  # (B,) int64
    slot_idx: torch.Tensor  # (B,) int64


class PrioritizedReplay:
    """Proportional-PER ring buffer (same write path as uniform)."""

    kind = "prioritized"

    def __init__(
        self,
        num_envs: int,
        capacity_per_env: int,
        alpha: float = 0.6,
        beta: float = 0.4,
        eps: float = 1e-6,
        max_decay: float = 0.999,
        use_pallas: bool = False,
        gamma: float = 0.99,
        n_step: int = 1,
        truncation_bootstrap: bool = True,
    ):
        self.use_pallas = use_pallas
        self.num_envs = num_envs
        self.capacity_per_env = capacity_per_env
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.max_decay = max_decay
        self.gamma = gamma
        self.n_step = n_step
        self.truncation_bootstrap = truncation_bootstrap

    def init(self, example: Transition) -> PrioritizedReplayState:
        if example.obs.shape[0] != self.num_envs:
            raise ValueError(f"example must hold num_envs={self.num_envs} rows")
        device = example.obs.device
        return PrioritizedReplayState(
            storage=alloc_storage(example, self.capacity_per_env),
            priorities=torch.zeros((self.num_envs, self.capacity_per_env), device=device),
            max_priority=torch.ones((), device=device),
            cursor=0,
            total_adds=0,
        )

    def add(
        self, state: PrioritizedReplayState, transition: Transition
    ) -> PrioritizedReplayState:
        """Write one vector step in place; new transitions enter at the max
        priority."""
        write_row(state.storage, state.cursor, transition)
        state.priorities[:, state.cursor].copy_(
            (state.max_priority**self.alpha).expand(self.num_envs)
        )
        state.cursor = (state.cursor + 1) % self.capacity_per_env
        state.total_adds += 1
        return state

    def sample_with_info(
        self,
        state: PrioritizedReplayState,
        generator: torch.Generator,
        batch_size: int,
        gamma: Optional[float] = None,
        beta: Optional[float] = None,
        uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """Two-level proportional sampling; returns ``(batch, info, weights)``.

        ``uniforms``: optional ``(u_env, u_slot)``, each ``(B,)`` on
        ``[0, 1)``, used instead of drawing from ``generator``."""
        p_all = state.priorities
        device = p_all.device
        # zero the newest n-1 slots so n-step windows never cross the cursor
        mask = valid_slot_mask(
            self.capacity_per_env, state.cursor, state.filled, self.n_step, device
        )
        p = p_all * mask[None, :].to(torch.float32)
        if uniforms is None:
            uniforms = (
                torch.rand((batch_size,), generator=generator, device=device),
                torch.rand((batch_size,), generator=generator, device=device),
            )
        u_env, u_slot = uniforms

        # level 1: env rows ∝ row sums (rank by counting cdf entries below u)
        row_cdf = torch.cumsum(p.sum(dim=1), dim=0)  # (N,)
        total = row_cdf[-1]
        env_idx = (row_cdf[None, :] < (u_env * total)[:, None]).sum(dim=1)
        env_idx = env_idx.clamp(max=self.num_envs - 1)

        # level 2: slot within each chosen row ∝ row priorities
        if self.use_pallas:
            slot_idx = slot_select(p, env_idx, u_slot)
        else:
            row_cdfs = torch.cumsum(p[env_idx], dim=1)  # (B, C)
            row_tot = row_cdfs[:, -1]
            slot_idx = (row_cdfs < (u_slot * row_tot)[:, None]).sum(dim=1)
            slot_idx = slot_idx.clamp(max=self.capacity_per_env - 1)
        p_sel = p[env_idx, slot_idx] / total.clamp(min=1e-12)

        batch = assemble_learn_batch(
            state.storage, env_idx, slot_idx,
            self.gamma if gamma is None else gamma,
            self.n_step, self.truncation_bootstrap,
        )

        # importance weights: w = (1/(n·P))^β, normalised by the batch max
        n_valid = float(state.filled * self.num_envs)
        w = (1.0 / (n_valid * p_sel).clamp(min=1e-12)) ** (self.beta if beta is None else beta)
        w = w / w.max().clamp(min=1e-12)
        return batch, SampleInfo(env_idx, slot_idx), w

    def update_priorities(
        self,
        state: PrioritizedReplayState,
        info: SampleInfo,
        td_errors: torch.Tensor,
    ) -> PrioritizedReplayState:
        """Set the sampled priorities to ``(|td| + ε)^α`` in place; duplicate
        pairs in one batch (the same transition) resolve max-wins."""
        mag = td_errors.abs() + self.eps
        new_p = mag**self.alpha
        flat = state.priorities.view(-1)
        idx = info.env_idx * self.capacity_per_env + info.slot_idx
        flat.index_fill_(0, idx, 0.0)
        flat.scatter_reduce_(0, idx, new_p, reduce="amax")
        # decaying high-water mark (max_decay=1.0: the classic monotone max)
        state.max_priority = torch.maximum(state.max_priority * self.max_decay, mag.max())
        return state
