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

The write cursor and the count of adds live on the device too
(``device_cursor``, ``device_adds``), as the JAX package's replay state
carries them, so that a write, a sample and a priority update launch
kernels only and run inside the learner's CUDA graphs
(``algos/superstep.py``); every tensor of the state is updated in place.
The host ints ``cursor`` and ``total_adds`` mirror them, advanced by
:meth:`PrioritizedReplay.advance`, for the host's gates and the
checkpoint.  :meth:`PrioritizedReplay.write` is the device half of
:meth:`~PrioritizedReplay.add`, and the sample reads the device counters
(a single learner's and a population's).

With ``members`` M (a population), the priorities of M members are one
(M·N, C) array beside the shared storage, member ``m``'s rows at ``m·N``,
and ``max_priority`` is (M,).  Each member samples B from its own rows:
level 1 over its N row sums, level 2 for all members in one call of the
slot kernel (``slot_select_members``), importance weights normalised by
its own batch max; a priority update changes only the members whose train
gate is open (a device mask, so that it too runs inside a CUDA graph).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.envs.graphed import device_mirror
from deep_q_learning_tpu_torch.ops.sample_kernels import slot_select, slot_select_members
from deep_q_learning_tpu_torch.replay.nstep import (
    assemble_learn_batch,
    split_members,
    valid_slot_mask,
)
from deep_q_learning_tpu_torch.replay.uniform import (
    RingStorage,
    alloc_storage,
    can_sample,
    member_rows,
    write_row,
)


@dataclasses.dataclass
class PrioritizedReplayState:
    storage: RingStorage  # slot-major packed leaves — see replay/uniform.py
    priorities: torch.Tensor  # (N, C) f32, already exponentiated by alpha; (M·N, C) for members
    max_priority: torch.Tensor  # () f32 (pre-alpha magnitude); (M,) for members
    cursor: int = device_mirror("device_cursor")
    total_adds: int = device_mirror("device_adds")
    device_cursor: Optional[torch.Tensor] = None  # () int64, the cursor on the device
    device_adds: Optional[torch.Tensor] = None  # () int64, total_adds on the device

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
    env_idx: torch.Tensor  # (B,) int64; for members (M, B) storage rows
    slot_idx: torch.Tensor  # (B,) int64; for members (M, B)


class PrioritizedReplay:
    """Proportional-PER ring buffer (same write path as uniform); with
    ``members`` M, the buffers of M population members."""

    kind = "prioritized"
    # the dtypes of the sample's two uniforms (u_env, u_slot)
    uniform_dtypes = (torch.float32, torch.float32)

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
        members: Optional[int] = None,
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
        self.members = members
        self.rows = num_envs * (members or 1)

    def init(self, example: Transition) -> PrioritizedReplayState:
        if example.obs.shape[0] != self.rows:
            raise ValueError(f"example must hold {self.rows} env rows")
        device = example.obs.device
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return PrioritizedReplayState(
            storage=alloc_storage(example, self.capacity_per_env),
            priorities=torch.zeros((self.rows, self.capacity_per_env), device=device),
            max_priority=torch.ones(() if self.members is None else (self.members,), device=device),
            cursor=0,
            total_adds=0,
            device_cursor=zero,
            device_adds=zero.clone(),
        )

    def add(
        self, state: PrioritizedReplayState, transition: Transition
    ) -> PrioritizedReplayState:
        """Write one vector step in place; new transitions enter at the max
        priority."""
        self.write(state, transition)
        self.advance(state)
        return state

    def write(self, state: PrioritizedReplayState, transition: Transition) -> None:
        """The device half of :meth:`add`: the row and its priorities at the
        device cursor, and the device counters advanced; the host mirrors
        are left to :meth:`advance`."""
        cursor = state.device_cursor
        write_row(state.storage, cursor, transition)
        new_p = state.max_priority**self.alpha
        column = (new_p.expand(self.num_envs) if self.members is None
                  else new_p.repeat_interleave(self.num_envs))  # each member's own
        state.priorities.index_copy_(1, cursor.view(1), column.unsqueeze(1))
        cursor.copy_((cursor + 1) % self.capacity_per_env)
        state.device_adds.add_(1)

    def advance(self, state: PrioritizedReplayState, k: int = 1) -> None:
        """The host mirrors of ``k`` :meth:`write` calls."""
        state.cursor = (state.cursor + k) % self.capacity_per_env
        state.total_adds += k

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
        ``[0, 1)``, used instead of drawing from ``generator``.  With
        members: ``gamma`` and ``beta`` are (M,) float32 tensors (each
        member's, required), ``uniforms`` (M, B) each, and the batch, the
        info and the weights are (M, B, ...)."""
        if self.members is not None:
            return self._sample_members(state, generator, batch_size, gamma, beta, uniforms)
        p_all = state.priorities
        device = p_all.device
        # zero the newest n-1 slots so n-step windows never cross the cursor
        filled = torch.clamp(state.device_adds, max=self.capacity_per_env)
        mask = valid_slot_mask(
            self.capacity_per_env, state.device_cursor, filled, self.n_step, device
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
        n_valid = (filled * self.num_envs).to(torch.float32)
        w = (1.0 / (n_valid * p_sel).clamp(min=1e-12)) ** (self.beta if beta is None else beta)
        w = w / w.max().clamp(min=1e-12)
        return batch, SampleInfo(env_idx, slot_idx), w

    def _sample_members(self, state, generator, batch_size, gamma, beta, uniforms):
        """Each member's two-level sample from its own N rows, as a member's
        own replay under ``jax.vmap``; level 2 for all members in one call."""
        members, n, b = self.members, self.num_envs, batch_size
        device = state.priorities.device
        filled = torch.clamp(state.device_adds, max=self.capacity_per_env)
        mask = valid_slot_mask(
            self.capacity_per_env, state.device_cursor, filled, self.n_step, device
        )
        p = state.priorities * mask[None, :].to(torch.float32)  # (M·N, C)
        if uniforms is None:
            uniforms = (
                torch.rand((members, b), generator=generator, device=device),
                torch.rand((members, b), generator=generator, device=device),
            )
        u_env, u_slot = uniforms

        # level 1, per member: env rows ∝ row sums
        row_cdf = torch.cumsum(p.sum(dim=1).view(members, n), dim=1)  # (M, N)
        total = row_cdf[:, -1:]  # (M, 1)
        env_idx = (row_cdf[:, None, :] < (u_env * total)[:, :, None]).sum(dim=2)
        env_idx = env_idx.clamp(max=n - 1)
        rows = member_rows(env_idx, n)  # (M, B) storage rows

        # level 2: slot within each chosen row ∝ row priorities
        if self.use_pallas:
            slot_idx = slot_select_members(p, env_idx, u_slot)
        else:
            row_cdfs = torch.cumsum(p[rows], dim=2)  # (M, B, C)
            slot_idx = (row_cdfs < (u_slot * row_cdfs[..., -1])[..., None]).sum(dim=2)
            slot_idx = slot_idx.clamp(max=self.capacity_per_env - 1)
        p_sel = p[rows, slot_idx] / total.clamp(min=1e-12)

        batch = assemble_learn_batch(
            state.storage, rows.reshape(-1), slot_idx.reshape(-1),
            gamma.repeat_interleave(b), self.n_step, self.truncation_bootstrap,
        )
        # importance weights per member, normalised by its own batch max
        n_valid = (filled * n).to(torch.float32)
        w = (1.0 / (n_valid * p_sel).clamp(min=1e-12)) ** beta[:, None]
        w = w / w.max(dim=1, keepdim=True).values.clamp(min=1e-12)
        return split_members(batch, members), SampleInfo(rows, slot_idx), w

    def can_sample(self, state: PrioritizedReplayState, min_transitions: int) -> torch.Tensor:
        """True (a 0-d bool tensor) once ``min_transitions`` transitions are
        stored over this learner's envs (the ``training_start`` gate)."""
        return can_sample(state, self.num_envs, min_transitions)

    def update_priorities(
        self,
        state: PrioritizedReplayState,
        info: SampleInfo,
        td_errors: torch.Tensor,
        mask=None,
    ) -> PrioritizedReplayState:
        """Set the sampled priorities to ``(|td| + ε)^α`` in place; duplicate
        pairs in one batch (the same transition) resolve max-wins.  With
        members (``td_errors`` (M, B)), only the members whose ``mask`` (an
        (M,) bool tensor on the device, or M host bools) is True (all if
        None) change their priorities and max priority."""
        mag = td_errors.abs() + self.eps
        new_p = mag**self.alpha
        flat = state.priorities.view(-1)
        idx = info.env_idx * self.capacity_per_env + info.slot_idx
        keep = None
        if mask is not None:
            # a closed gate writes each sampled priority back as it was;
            # where(True, new, old) is new bit for bit
            keep = mask if isinstance(mask, torch.Tensor) else torch.tensor(
                [bool(k) for k in mask], device=flat.device)
            new_p = torch.where(keep[:, None], new_p, flat[idx])
        flat.index_fill_(0, idx.reshape(-1), 0.0)
        flat.scatter_reduce_(0, idx.reshape(-1), new_p.reshape(-1), reduce="amax")
        # decaying high-water mark (max_decay=1.0: the classic monotone max),
        # written in place like every tensor of the state
        if self.members is None:
            state.max_priority.copy_(torch.maximum(state.max_priority * self.max_decay, mag.max()))
            return state
        new_max = torch.maximum(state.max_priority * self.max_decay, mag.max(dim=1).values)
        state.max_priority.copy_(
            new_max if keep is None else torch.where(keep, new_max, state.max_priority))
        return state
