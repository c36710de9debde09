"""Fused TD target + huber loss: the CUDA kernels (``csrc/td_loss.cu``), their
plain PyTorch versions, and the autograd function around them.

Replaces ``deep_q_learning_tpu/ops/td_kernels.py``: the Pallas forward
kernel ``_fwd_kernel`` (``pl.pallas_call`` at ``td_kernels.py:148``) and
backward kernel ``_bwd_kernel`` (``td_kernels.py:187``) of its custom VJP.

    a*   = argmax_a Q_online(s', a)   (double DQN; first max)
    boot = Q_target(s', a*)           (or max_a Q_target(s', a))
    td   = G + bootstrap · boot − Q(s, a)
    loss = Σ w · huber_δ(td) / B
    dQ(s, a) = −w · clip(td, −δ, δ) · g / B at the taken action, else 0

On the card the kernels are bound by launch latency, not bytes:
:func:`td_loss_fwd_work` and :func:`td_loss_bwd_work` give the bytes and
operations a call needs, and ``ops.bound_us`` the least time they allow
(a few ns against about a microsecond per launch).  See the source for the
design.

:class:`FusedTDLoss` takes the learner's whole ``q_both = Q([s; s'])``
(2B, A) and its backward kernel writes the gradient of all of it, zero on
the stopped ``s'`` half, so autograd runs nothing between the kernel and
the network's backward.

A population of M learners (``parallel/population.py``) gives every
operand a leading member axis, as ``jax.vmap`` over the Pallas kernels
lifts it into their grid: ``q_both`` (M, 2B, A), the vectors (M, B),
``loss`` and the cotangent (M,).  Both kernels take it as their grid's
second dimension, so the M learners' TD losses are one launch each way;
one learner is the case without the axis (M = 1 in the kernel).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches, and
``plain_calls`` counts calls that took the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deep_q_learning_tpu_torch.ops.build import load_library

launches = {"td_loss_fwd": 0, "td_loss_bwd": 0}
plain_calls = {"td_loss_fwd": 0, "td_loss_bwd": 0}


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def td_loss_fwd_work(b: int, a: int, members: int = 1) -> Tuple[int, int]:
    """``(bytes, operations)`` the forward needs at (B, A) for each of
    ``members`` learners: three Q matrices and four (B,) vectors read once,
    ``td`` and the loss written once; about ``2A + 12`` float operations a
    row (argmax and select, target, huber, weight, sum)."""
    return (members * (4 * (3 * b * a + 4 * b) + 4 * (b + 1)),
            members * (b * (2 * a + 12) + 1))


def td_loss_bwd_work(
    b: int, a: int, out_rows: Optional[int] = None, members: int = 1
) -> Tuple[int, int]:
    """``(bytes, operations)`` the backward needs for each of ``members``
    learners: ``td``, ``weights``, ``action`` and ``g`` read once,
    ``out_rows`` rows of dQ written once; about ``5 + A`` operations a row
    (clip, two products, the select)."""
    rows = b if out_rows is None else out_rows
    return members * (4 * (3 * b + 1) + 4 * rows * a), members * (b * (5 + a) + 1)


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------

def td_loss_reference(
    q_s, q_next_online, q_next_target, action, reward, bootstrap, weights,
    delta: float = 1.0, double: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's forward in plain PyTorch: ``(loss (), td (B,))``, or
    with a leading member axis ``(loss (M,), td (M, B))``."""
    b, a = q_s.shape[-2:]
    col = torch.arange(a, device=q_s.device)
    if double:
        best = torch.argmax(q_next_online, dim=-1)
        boot = torch.where(col == best[..., None], q_next_target, 0.0).sum(dim=-1)
    else:
        boot = q_next_target.max(dim=-1).values
    y = reward + bootstrap * boot
    q_taken = torch.where(col == action[..., None], q_s, 0.0).sum(dim=-1)
    td = y - q_taken
    abs_td = td.abs()
    quad = torch.clamp(abs_td, max=delta)
    per = 0.5 * quad * quad + delta * (abs_td - quad)
    return torch.sum(weights * per, dim=-1) / b, td


def td_loss_backward_reference(
    td, action, weights, g, num_actions: int, delta: float = 1.0,
    out_rows: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's backward in plain PyTorch: ``dQ`` of shape
    (``out_rows``, A), ``out_rows`` >= B (default B); rows past B are zero.
    With a leading member axis (``td`` (M, B), ``g`` (M,)): (M, ``out_rows``, A)."""
    b = td.shape[-1]
    col = torch.arange(num_actions, device=td.device)
    coeff = -torch.clamp(td, -delta, delta) * weights * (g[..., None] / b)
    dq = torch.where(col == action[..., None], coeff[..., None], 0.0)
    if out_rows is None or out_rows == b:
        return dq
    return torch.cat([dq, dq.new_zeros(dq.shape[:-2] + (out_rows - b, num_actions))], dim=-2)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("td_loss.cu")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_longlong
    lib.td_loss_fwd.argtypes = [ptr] * 10 + [i32, ptr, i32, i32, i32, i64, f32, i32, i32, ptr]
    lib.td_loss_fwd.restype = i32
    lib.td_loss_bwd.argtypes = [ptr] * 5 + [i32, i32, i32, i32, f32, i32, ptr]
    lib.td_loss_bwd.restype = i32
    lib.td_loss_fwd_rows_per_block.argtypes = []
    lib.td_loss_fwd_rows_per_block.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device, any_member_stride=False) -> None:
    """Device, dtype, shape and contiguity; with ``any_member_stride`` a
    3-D tensor's leading (member) axis may have any stride, as long as
    each member's rows are contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    inner = t[0] if any_member_stride and t.dim() == 3 and t.shape[0] > 0 else t
    if not inner.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_kind(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda tensors, not {device}")
    return device.type


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error {err}")


def float4_rows(num_actions: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernels take rows of ``tensors`` as one float4 each: four
    actions and every row 16-byte aligned (every member's too).  Else they
    take the scalar path."""
    return num_actions == 4 and all(
        t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:-2]) for t in tensors
    )


# the forward's cross-block scratch, one (partials f32, ticket i32) per device
_fwd_scratch: dict = {}


def fwd_scratch(device: torch.device, blocks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's per-block partial sums and its ticket counter on
    ``device``: made with ``torch.zeros`` at first use, the partials grown
    when a launch needs more blocks (all members' together).  The last block
    of every launch sets the counter back to 0, so launches that share them
    run in order on one stream."""
    partials, ticket = _fwd_scratch.get(device, (None, None))
    if ticket is None:
        ticket = torch.zeros((), dtype=torch.int32, device=device)
    if partials is None or partials.numel() < blocks:
        partials = torch.zeros((max(blocks, 64),), dtype=torch.float32, device=device)
    _fwd_scratch[device] = (partials, ticket)
    return partials, ticket


def td_loss_fwd(
    q_s, q_next_online, q_next_target, action, reward, bootstrap, weights,
    delta: float = 1.0, double: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(loss (), td (B,))``.  ``q_*`` f32 (B, A); ``action`` i32
    (B,); ``reward``, ``bootstrap``, ``weights`` f32 (B,).  With a leading
    member axis (``q_*`` (M, B, A), the vectors (M, B)): ``(loss (M,), td
    (M, B))``; ``q_s`` and ``q_next_online`` may then be the two halves of
    one (M, 2B, A) ``q_both``, read in place (each member's rows contiguous,
    one member stride for the two)."""
    device = q_s.device
    *lead, b, a = q_s.shape
    lead = tuple(lead)
    if len(lead) > 1:
        raise ValueError(f"q_s has shape {tuple(q_s.shape)}: at most one member axis")
    for name, t, dtype, shape in (
        ("q_s", q_s, torch.float32, lead + (b, a)),
        ("q_next_online", q_next_online, torch.float32, lead + (b, a)),
        ("q_next_target", q_next_target, torch.float32, lead + (b, a)),
        ("action", action, torch.int32, lead + (b,)),
        ("reward", reward, torch.float32, lead + (b,)),
        ("bootstrap", bootstrap, torch.float32, lead + (b,)),
        ("weights", weights, torch.float32, lead + (b,)),
    ):
        _check(name, t, dtype, shape, device, any_member_stride=name in ("q_s", "q_next_online"))
    members = lead[0] if lead else 1
    q_stride = q_s.stride(0) if lead else b * a
    if lead and q_next_online.stride(0) != q_stride:
        raise ValueError("q_s and q_next_online must share one member stride")
    if _device_kind(device) == "cpu":
        plain_calls["td_loss_fwd"] += 1
        return td_loss_reference(
            q_s, q_next_online, q_next_target, action, reward, bootstrap, weights,
            delta, double,
        )
    lib = _lib()
    partials, ticket = fwd_scratch(
        device, members * -(-b // lib.td_loss_fwd_rows_per_block()))
    loss = torch.empty(lead, dtype=torch.float32, device=device)
    td = torch.empty(lead + (b,), dtype=torch.float32, device=device)
    vec4 = float4_rows(a, q_s, q_next_online, q_next_target)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch(
            lib.td_loss_fwd,
            q_s.data_ptr(), q_next_online.data_ptr(), q_next_target.data_ptr(),
            action.data_ptr(), reward.data_ptr(), bootstrap.data_ptr(),
            weights.data_ptr(), loss.data_ptr(), td.data_ptr(), partials.data_ptr(),
            partials.numel(), ticket.data_ptr(), b, a, members, q_stride, float(delta),
            int(double), int(vec4), stream,
        )
    launches["td_loss_fwd"] += 1
    return loss, td


def td_loss_bwd(
    td, action, weights, g, num_actions: int, delta: float = 1.0,
    out_rows: Optional[int] = None,
) -> torch.Tensor:
    """Backward: ``dQ`` (``out_rows``, A) from ``td``, ``action``,
    ``weights`` and the loss cotangent ``g`` (a 0-dim f32 tensor, read on
    the device).  ``out_rows`` >= B (default B); rows past B are zero.
    With a leading member axis (``td`` (M, B), ``g`` (M,)): (M, ``out_rows``, A)."""
    device = td.device
    *lead, b = td.shape
    lead = tuple(lead)
    if len(lead) > 1:
        raise ValueError(f"td has shape {tuple(td.shape)}: at most one member axis")
    rows = b if out_rows is None else out_rows
    if rows < b:
        raise ValueError(f"out_rows {rows} is below the batch {b}")
    for name, t, dtype, shape in (
        ("td", td, torch.float32, lead + (b,)),
        ("action", action, torch.int32, lead + (b,)),
        ("weights", weights, torch.float32, lead + (b,)),
        ("g", g, torch.float32, lead),
    ):
        _check(name, t, dtype, shape, device)
    if _device_kind(device) == "cpu":
        plain_calls["td_loss_bwd"] += 1
        return td_loss_backward_reference(
            td, action, weights, g, num_actions, delta, out_rows=rows
        )
    lib = _lib()
    dq = torch.empty(lead + (rows, num_actions), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch(
            lib.td_loss_bwd,
            td.data_ptr(), action.data_ptr(), weights.data_ptr(), g.data_ptr(),
            dq.data_ptr(), b, num_actions, rows, lead[0] if lead else 1, float(delta),
            int(float4_rows(num_actions, dq)), stream,
        )
    launches["td_loss_bwd"] += 1
    return dq


class FusedTDLoss(torch.autograd.Function):
    """``(loss, td)`` from the online net's ``q_both`` (2B, A) = Q([s; s'])
    and the rest of the batch: rows ``[:b]`` are Q(s, ·) and rows ``[b:]``
    Q_online(s', ·), both handed to the forward kernel as views.
    Differentiable in ``q_both``: the backward kernel writes its whole
    gradient, zero on rows ``[b:]`` (stopped, as in the JAX package), so no
    slice backward runs.  ``td`` is marked non-differentiable.  A leading
    member axis (``q_both`` (M, 2B, A)) gives ``loss`` (M,)."""

    @staticmethod
    def forward(ctx, q_both, b: int, q_next_target, action, reward, bootstrap,
                weights, delta: float, double: bool):
        loss, td = td_loss_fwd(
            q_both[..., :b, :], q_both[..., b:, :], q_next_target, action, reward,
            bootstrap, weights, delta, double,
        )
        ctx.save_for_backward(td, action, weights)
        ctx.delta = delta
        ctx.q_shape = tuple(q_both.shape)
        ctx.mark_non_differentiable(td)
        return loss, td

    @staticmethod
    def backward(ctx, g_loss, g_td):
        td, action, weights = ctx.saved_tensors
        *_, rows, num_actions = ctx.q_shape
        # the cotangent of a summed member loss arrives expanded (stride 0)
        dq = td_loss_bwd(td, action, weights, g_loss.contiguous(), num_actions, ctx.delta,
                         out_rows=rows)
        return dq, None, None, None, None, None, None, None, None


def fused_td_loss(
    q_s, q_next_online, q_next_target, action, reward, bootstrap, weights,
    delta: float = 1.0, double: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, td)`` through :class:`FusedTDLoss` (the CUDA kernels on the
    card, their plain versions on the CPU), with the JAX package's
    signature: ``q_*`` f32 (B, A), ``action`` i32 (B,), the rest f32 (B,).
    Differentiable in ``q_s`` only; the targets are stopped."""
    q_both = torch.cat([q_s, q_next_online.detach()], dim=-2)
    return FusedTDLoss.apply(
        q_both, q_s.shape[-2], q_next_target.detach(), action, reward, bootstrap, weights,
        delta, double,
    )


def build_fused_loss_fn(double: bool = True, huber_delta: float = 1.0):
    """Drop-in for ``algos.losses.build_loss_fn`` (huber only) that routes the
    TD and loss math through :class:`FusedTDLoss`.  The network forwards stay
    ordinary matmuls: one online forward over ``[s; s']``, whose output goes
    to the fused loss whole, and one target forward.  A member-stacked
    network and batch (a leading member axis) give one loss a member."""

    def loss_fn(online, target, batch, weights):
        b = batch.obs.shape[-2]
        q_both = online(torch.cat([batch.obs, batch.next_obs], dim=-2))
        with torch.no_grad():
            q_next_target = target(batch.next_obs)
        return FusedTDLoss.apply(
            q_both, b, q_next_target, batch.action, batch.reward,
            batch.bootstrap, weights, huber_delta, double,
        )

    return loss_fn
