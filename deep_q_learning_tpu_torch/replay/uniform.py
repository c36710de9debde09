"""Device-resident uniform replay (``deep_q_learning_tpu/replay/uniform.py``).

Storage is slot-major, ``(capacity_per_env, num_envs, ...)``: all envs
write their transition at the same slot each vector step, so a write is
one contiguous row.  The four scalar fields (reward, action, terminated,
truncated) are packed into one float32 ``aux`` lane, so an n-step window
is a single gather (``replay/nstep.py``).

The port updates the buffers in place.  The cursor and fill counters are
Python ints: the host knows them without reading the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.replay.nstep import assemble_learn_batch

# packed-aux lane indices (RingStorage.aux trailing axis)
AUX_REWARD, AUX_ACTION, AUX_TERM, AUX_TRUNC = 0, 1, 2, 3


@dataclasses.dataclass
class RingStorage:
    """Slot-major transition storage with the packed scalar lane.  Packing
    is exact: actions are small ints and the flags are 0/1."""

    obs: torch.Tensor  # (C, N, *obs_shape)
    next_obs: torch.Tensor  # (C, N, *obs_shape)
    aux: torch.Tensor  # (C, N, 4) f32: [reward, action, terminated, truncated]


def alloc_storage(example: Transition, capacity_per_env: int) -> RingStorage:
    """Zeroed storage shaped after one batched transition."""

    def alloc(leaf: torch.Tensor) -> torch.Tensor:
        return torch.zeros(
            (capacity_per_env,) + tuple(leaf.shape), dtype=leaf.dtype, device=leaf.device
        )

    n = example.obs.shape[0]
    return RingStorage(
        obs=alloc(example.obs),
        next_obs=alloc(example.next_obs),
        aux=torch.zeros((capacity_per_env, n, 4), device=example.obs.device),
    )


def pack_aux(transition: Transition) -> torch.Tensor:
    """(N, 4) f32 packed scalar lane for one vector step."""
    return torch.stack(
        [
            transition.reward.to(torch.float32),
            transition.action.to(torch.float32),
            transition.terminated.to(torch.float32),
            transition.truncated.to(torch.float32),
        ],
        dim=-1,
    )


def write_row(storage: RingStorage, cursor: int, transition: Transition) -> None:
    """Write one vector step at slot ``cursor``, in place."""
    storage.obs[cursor].copy_(transition.obs)
    storage.next_obs[cursor].copy_(transition.next_obs)
    storage.aux[cursor].copy_(pack_aux(transition))


@dataclasses.dataclass
class ReplayState:
    """Ring-buffer state.  ``cursor`` is the next write slot (shared by all
    envs); ``total_adds`` counts vector steps written."""

    storage: RingStorage
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


class UniformReplay:
    """Uniform-sampling per-env ring buffer."""

    kind = "uniform"

    def __init__(
        self,
        num_envs: int,
        capacity_per_env: int,
        gamma: float = 0.99,
        n_step: int = 1,
        truncation_bootstrap: bool = True,
    ):
        if capacity_per_env < 1:
            raise ValueError("capacity_per_env must be >= 1")
        if not 1 <= n_step <= capacity_per_env:
            raise ValueError(f"n_step={n_step} out of range for capacity {capacity_per_env}")
        self.num_envs = num_envs
        self.capacity_per_env = capacity_per_env
        self.gamma = gamma
        self.n_step = n_step
        self.truncation_bootstrap = truncation_bootstrap

    def init(self, example: Transition) -> ReplayState:
        if example.obs.shape[0] != self.num_envs:
            raise ValueError(
                f"example leaves must be batched (num_envs={self.num_envs}), "
                f"got obs shape {tuple(example.obs.shape)}"
            )
        return ReplayState(
            storage=alloc_storage(example, self.capacity_per_env), cursor=0, total_adds=0
        )

    def add(self, state: ReplayState, transition: Transition) -> ReplayState:
        """Write one vector step at the cursor slot (in place); overwrite the
        oldest on wraparound."""
        write_row(state.storage, state.cursor, transition)
        state.cursor = (state.cursor + 1) % self.capacity_per_env
        state.total_adds += 1
        return state

    def sample_with_info(
        self,
        state: ReplayState,
        generator: torch.Generator,
        batch_size: int,
        gamma: Optional[float] = None,
        beta: Optional[float] = None,
    ):
        """``(LearnBatch, None, ones)``.  Slots are drawn in age order so the
        n-step window never crosses the write cursor; ``beta`` is ignored
        (uniform sampling has unit weights)."""
        device = state.storage.aux.device
        env_idx = torch.randint(
            0, self.num_envs, (batch_size,), generator=generator, device=device
        )
        max_rank = max(state.filled - (self.n_step - 1), 1)
        rank = torch.randint(0, max_rank, (batch_size,), generator=generator, device=device)
        start = (state.cursor - state.filled) % self.capacity_per_env
        slot_idx = (start + rank) % self.capacity_per_env
        batch = assemble_learn_batch(
            state.storage, env_idx, slot_idx,
            self.gamma if gamma is None else gamma,
            self.n_step, self.truncation_bootstrap,
        )
        return batch, None, torch.ones((batch_size,), device=device)

    def update_priorities(self, state: ReplayState, info, td_errors) -> ReplayState:
        return state  # uniform replay has no priorities
