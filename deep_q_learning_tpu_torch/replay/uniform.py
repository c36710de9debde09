"""Device-resident uniform replay (``deep_q_learning_tpu/replay/uniform.py``).

Storage is slot-major, ``(capacity_per_env, num_envs, ...)``: all envs
write their transition at the same slot each vector step, so a write is
one contiguous row.  The four scalar fields (reward, action, terminated,
truncated) are packed into one float32 ``aux`` lane, so an n-step window
is a single gather (``replay/nstep.py``).

The port updates the buffers in place.  The write cursor and the count of
adds live on the device (``device_cursor``, ``device_adds``), as the JAX
package's replay state carries them, so that a write and a sample launch
kernels only and run inside the learner's CUDA graphs
(``algos/superstep.py``); the host ints ``cursor`` and ``total_adds``
mirror them (``envs/graphed.py::device_mirror``), advanced by
:meth:`UniformReplay.advance`, for the host's gates and the checkpoint.
:func:`write_row` takes a host int or a device cursor.

The n-step sample scales two uniforms on the device by the device fill
(:meth:`UniformReplay.sample_with_info`), where the JAX package draws
``randint`` below a traced bound: a bound that changes every frame cannot
be baked into a capture.  The slot's uniform is float64, so that every age
rank keeps its share of 1/R to far better than 0.1 % at the largest ring
(100,000 slots); a float32 ``u·R`` does not past about 2^14 ranks.

A population of M members (``members=M``) keeps one storage of M·N env
rows, member ``m``'s at ``m·N``: the members add in lockstep, so they share
the cursor and the fill, and each samples B transitions from its own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.envs.graphed import device_mirror
from deep_q_learning_tpu_torch.replay.nstep import assemble_learn_batch, split_members

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


def unpack_aux(aux: torch.Tensor) -> tuple:
    """(reward f32, action i32, terminated bool, truncated bool) from a
    gathered ``(..., 4)`` aux block."""
    return (
        aux[..., AUX_REWARD],
        aux[..., AUX_ACTION].to(torch.int32),
        aux[..., AUX_TERM] > 0.5,
        aux[..., AUX_TRUNC] > 0.5,
    )


def can_sample(state, num_envs: int, min_transitions: int) -> torch.Tensor:
    """A 0-d bool tensor: at least ``min_transitions`` transitions are
    stored over the ``num_envs`` rows (the warm-up gate)."""
    return torch.tensor(state.filled * num_envs >= min_transitions,
                        device=state.storage.aux.device)


def member_rows(env_idx: torch.Tensor, num_envs: int) -> torch.Tensor:
    """Storage rows of (M, B) env indices within each member's N rows."""
    offset = torch.arange(env_idx.shape[0], device=env_idx.device)[:, None] * num_envs
    return env_idx + offset


def write_row(storage: RingStorage, cursor, transition: Transition) -> None:
    """Write one vector step at slot ``cursor``, in place: a host int, or a
    () int64 tensor on the storage's device, read there."""
    if isinstance(cursor, torch.Tensor):
        at = cursor.view(1)
        storage.obs.index_copy_(0, at, transition.obs.unsqueeze(0))
        storage.next_obs.index_copy_(0, at, transition.next_obs.unsqueeze(0))
        storage.aux.index_copy_(0, at, pack_aux(transition).unsqueeze(0))
        return
    storage.obs[cursor].copy_(transition.obs)
    storage.next_obs[cursor].copy_(transition.next_obs)
    storage.aux[cursor].copy_(pack_aux(transition))


def scaled_index(u: torch.Tensor, bound) -> torch.Tensor:
    """``min(floor(u · bound), bound - 1)`` as int64, on ``u``'s device:
    an index uniform on ``[0, bound)`` from a uniform ``u`` on ``[0, 1)``.
    ``bound`` is a host int or an int64 tensor that broadcasts against
    ``u``; the product is taken in ``u``'s dtype."""
    index = (u * bound).to(torch.int64)  # truncation is the floor: u·bound >= 0
    if isinstance(bound, torch.Tensor):
        return torch.minimum(index, bound - 1)
    return index.clamp(max=bound - 1)


@dataclasses.dataclass
class ReplayState:
    """Ring-buffer state.  ``cursor`` is the next write slot (shared by all
    envs); ``total_adds`` counts vector steps written.  Both are host
    mirrors of the device counters."""

    storage: RingStorage
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


class UniformReplay:
    """Uniform-sampling per-env ring buffer; with ``members`` M, the buffers
    of M population members of ``num_envs`` envs each."""

    kind = "uniform"
    # the dtypes of the sample's two uniforms (u_env, u_slot)
    uniform_dtypes = (torch.float32, torch.float64)

    def __init__(
        self,
        num_envs: int,
        capacity_per_env: int,
        gamma: float = 0.99,
        n_step: int = 1,
        truncation_bootstrap: bool = True,
        members: Optional[int] = None,
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
        self.members = members
        self.rows = num_envs * (members or 1)

    def init(self, example: Transition) -> ReplayState:
        if example.obs.shape[0] != self.rows:
            raise ValueError(
                f"example leaves must be batched ({self.rows} env rows), "
                f"got obs shape {tuple(example.obs.shape)}"
            )
        zero = torch.zeros((), dtype=torch.int64, device=example.obs.device)
        return ReplayState(
            storage=alloc_storage(example, self.capacity_per_env), cursor=0, total_adds=0,
            device_cursor=zero, device_adds=zero.clone(),
        )

    def add(self, state: ReplayState, transition: Transition) -> ReplayState:
        """Write one vector step at the cursor slot (in place); overwrite the
        oldest on wraparound."""
        self.write(state, transition)
        self.advance(state)
        return state

    def write(self, state: ReplayState, transition: Transition) -> None:
        """The device half of :meth:`add`: the row at the device cursor and
        the device counters advanced; the host mirrors are left to
        :meth:`advance`."""
        cursor = state.device_cursor
        write_row(state.storage, cursor, transition)
        cursor.copy_((cursor + 1) % self.capacity_per_env)
        state.device_adds.add_(1)

    def advance(self, state: ReplayState, k: int = 1) -> None:
        """The host mirrors of ``k`` :meth:`write` calls."""
        state.cursor = (state.cursor + k) % self.capacity_per_env
        state.total_adds += k

    def sample(
        self,
        state: ReplayState,
        generator: torch.Generator,
        batch_size: int,
        indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Transition:
        """Raw 1-step transitions, uniform with replacement over the filled
        (env, slot) cells: ``env_idx`` in ``[0, num_envs)`` and ``slot_idx``
        in ``[0, max(filled, 1))``, drawn directly as the JAX package does
        (slot numbers, not ages).  ``indices``: optional ``(env_idx,
        slot_idx)`` used instead of drawing from ``generator``."""
        if self.members is not None:
            raise ValueError("sample draws from one learner's buffer; a population "
                             "samples through sample_with_info")
        device = state.storage.aux.device
        if indices is None:
            indices = (
                torch.randint(0, self.num_envs, (batch_size,), generator=generator,
                              device=device),
                torch.randint(0, max(state.filled, 1), (batch_size,), generator=generator,
                              device=device),
            )
        env_idx, slot_idx = indices
        s = state.storage
        reward, action, terminated, truncated = unpack_aux(s.aux[slot_idx, env_idx])
        return Transition(
            obs=s.obs[slot_idx, env_idx],
            action=action,
            reward=reward,
            next_obs=s.next_obs[slot_idx, env_idx],
            terminated=terminated,
            truncated=truncated,
        )

    def can_sample(self, state: ReplayState, min_transitions: int) -> torch.Tensor:
        """True (a 0-d bool tensor) once ``min_transitions`` transitions are
        stored over this learner's envs (the ``training_start`` gate)."""
        return can_sample(state, self.num_envs, min_transitions)

    def sample_with_info(
        self,
        state: ReplayState,
        generator: torch.Generator,
        batch_size: int,
        gamma: Optional[float] = None,
        beta: Optional[float] = None,
        uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """``(LearnBatch, None, ones)``.  Slots are drawn in age order so the
        n-step window never crosses the write cursor; ``beta`` is ignored
        (uniform sampling has unit weights).

        ``uniforms``: optional ``(u_env, u_slot)`` on ``[0, 1)``, float32
        and float64 (:attr:`uniform_dtypes`), used instead of drawing them
        from ``generator`` in that order.  From the device counters, with
        ``R = max(fill - (n_step - 1), 1)``: ``env = min(⌊u_env·N⌋, N-1)``,
        ``rank = min(⌊u_slot·R⌋, R-1)`` and ``slot = (cursor - fill + rank)
        mod C``.  With members: B draws from each member's rows (``uniforms``
        (M, B) each), ``gamma`` (M,) float32 (each member's, required), and
        every leaf (M, B, ...)."""
        device = state.storage.aux.device
        shape = (batch_size,) if self.members is None else (self.members, batch_size)
        if uniforms is None:
            uniforms = tuple(torch.rand(shape, generator=generator, dtype=dtype, device=device)
                             for dtype in self.uniform_dtypes)
        u_env, u_slot = uniforms
        filled = torch.clamp(state.device_adds, max=self.capacity_per_env)
        env_idx = scaled_index(u_env, self.num_envs)
        rank = scaled_index(u_slot, torch.clamp(filled - (self.n_step - 1), min=1))
        slot_idx = (state.device_cursor - filled + rank) % self.capacity_per_env
        if self.members is None:
            batch = assemble_learn_batch(
                state.storage, env_idx, slot_idx,
                self.gamma if gamma is None else gamma,
                self.n_step, self.truncation_bootstrap,
            )
            return batch, None, torch.ones((batch_size,), device=device)
        batch = assemble_learn_batch(
            state.storage, member_rows(env_idx, self.num_envs).reshape(-1), slot_idx.reshape(-1),
            gamma.repeat_interleave(batch_size), self.n_step, self.truncation_bootstrap,
        )
        return split_members(batch, self.members), None, torch.ones(shape, device=device)

    def update_priorities(self, state: ReplayState, info, td_errors, mask=None) -> ReplayState:
        return state  # uniform replay has no priorities
