"""PER level-2 slot selection: the CUDA kernel (``csrc/per_sample.cu``) and
its plain PyTorch version.

Replaces ``deep_q_learning_tpu/ops/sample_kernels.py``: the Pallas kernel
``_slot_kernel`` (``pl.pallas_call`` at ``sample_kernels.py:128``, reached
through ``prioritized_sample_pallas``).  For each draw ``b``:

    row   = priorities[env_idx[b]]                        (C,)
    draw  = u_slot[b] · Σ row
    slot  = #{c : inclusive_prefix(row)[c] < draw}, clamped to C − 1

An all-zero row (or an ``env_idx`` outside ``[0, N)``, which selects no row,
as the Pallas kernel's one-hot gather) gives slot 0.  Level 1 (the env
rows), the draws, the valid-slot mask and the ``p_sel`` gather stay outside,
in ``replay/prioritized.py``, as they do in the JAX package.

Indices are int64 in and out, as the port's ``SampleInfo`` holds them, so no
conversion runs around the call.  :func:`per_slot_sample_work` gives the
bytes and operations a call needs on its inputs (``ops.bound_us`` turns
them into the least time the card could take).  The kernel gives each draw
a warp (C <= 512) or a block (larger C) that reads its row once into
registers; :func:`slot_plan` says which, for given priorities.  See the
source for the design.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches, and
``plain_calls`` counts calls that took the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from deep_q_learning_tpu_torch.ops.build import load_library
from deep_q_learning_tpu_torch.ops.td_kernels import _check, _device_kind, _launch

launches = {"per_slot_sample": 0}
plain_calls = {"per_slot_sample": 0}


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def per_slot_sample_work(priorities: torch.Tensor, env_idx: torch.Tensor) -> Tuple[int, int]:
    """``(bytes, operations)`` a call needs on these inputs: each distinct row
    that ``env_idx`` selects (at most N; an index outside ``[0, N)`` selects
    none) read once, and per draw its index and ``u`` read and its slot
    written (20 bytes); about ``4·C`` operations a draw (the row's sum, the
    prefix sums, the compares and the count)."""
    n, c = priorities.shape
    valid = env_idx[(env_idx >= 0) & (env_idx < n)]
    rows = int(torch.unique(valid).numel())
    b = env_idx.shape[0]
    return 4 * rows * c + 20 * b, b * (4 * c + 1)


def slot_select_reference(
    priorities: torch.Tensor, env_idx: torch.Tensor, u_slot: torch.Tensor
) -> torch.Tensor:
    """The kernel in plain PyTorch: ``slot_idx`` (B,) int64.  The draw is
    ``u · sum(row)``, as in the Pallas kernel (not ``u · cumsum(row)[-1]``)."""
    n, c = priorities.shape
    valid = (env_idx >= 0) & (env_idx < n)
    rows = torch.where(valid[:, None], priorities[env_idx.clamp(0, n - 1)], 0.0)
    draw = u_slot * rows.sum(dim=1)
    count = (torch.cumsum(rows, dim=1) < draw[:, None]).sum(dim=1)
    return count.clamp(max=c - 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("per_sample.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.per_slot_sample.argtypes = [ptr] * 4 + [i32, i32, i32, ptr]
    lib.per_slot_sample.restype = i32
    lib.per_slot_sample_plan.argtypes = [i32, ptr, ctypes.POINTER(i32)]
    lib.per_slot_sample_plan.restype = i32
    return lib


def slot_plan(priorities: torch.Tensor) -> dict:
    """How the kernel runs on these priorities (N, C) on the card:
    ``threads`` per draw (32: a warp, eight draws a block; more: a block),
    ``values`` each thread holds, ``vec`` (float4 loads; False where C % 4
    != 0 or the rows are not 16-byte aligned) and the ``chunks`` of the row
    a block walks (1: one pass)."""
    plan = (ctypes.c_int * 4)()
    _launch(_lib().per_slot_sample_plan, priorities.shape[1], priorities.data_ptr(), plan)
    return dict(threads=plan[0], values=plan[1], vec=bool(plan[2]), chunks=plan[3])


def slot_select(
    priorities: torch.Tensor, env_idx: torch.Tensor, u_slot: torch.Tensor
) -> torch.Tensor:
    """``slot_idx`` (B,) int64 from ``priorities`` f32 (N, C), ``env_idx``
    int64 (B,) and ``u_slot`` f32 (B,)."""
    device = priorities.device
    n, c = priorities.shape
    (b,) = env_idx.shape
    for name, t, dtype, shape in (
        ("priorities", priorities, torch.float32, (n, c)),
        ("env_idx", env_idx, torch.int64, (b,)),
        ("u_slot", u_slot, torch.float32, (b,)),
    ):
        _check(name, t, dtype, shape, device)
    if _device_kind(device) == "cpu":
        plain_calls["per_slot_sample"] += 1
        return slot_select_reference(priorities, env_idx, u_slot)
    lib = _lib()
    slot_idx = torch.empty((b,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch(
            lib.per_slot_sample,
            priorities.data_ptr(), env_idx.data_ptr(), u_slot.data_ptr(),
            slot_idx.data_ptr(), n, c, b, stream,
        )
    launches["per_slot_sample"] += 1
    return slot_idx
