"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: without a GPU every test here skips.  This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit; ``--noconftest`` skips tests/conftest.py, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: loss and td rtol 1e-5, atol 1e-6 (the kernel reduces the loss
in another order); dQ rtol 1e-5, atol 1e-7; the forward's loss is bitwise
the same from call to call.  PER slot sampling: exact on
dyadic priorities (every sum exact in any order); on random priorities a
slot may differ only where every prefix between the two slots lies within
8 float32 ulps of the row total of the plain version's draw, and in under
1 % of at least 1024 draws; the slots are bitwise the same from call to
call."""

import dataclasses

import numpy as np
import pytest
import torch

from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels
from deep_q_learning_tpu_torch.ops.sample_kernels import slot_select, slot_select_reference
from deep_q_learning_tpu_torch.ops.td_kernels import (
    td_loss_backward_reference,
    td_loss_bwd,
    td_loss_fwd,
    td_loss_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are compiled by nvcc for sm_90a")
    return torch.device("cuda")


def _inputs(b, a, seed, device):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)  # noqa: E731
    return [
        f(b, a), f(b, a), f(b, a),
        torch.tensor(rng.integers(0, a, b).astype(np.int32), device=device),
        f(b),
        torch.tensor((0.97 * (rng.random(b) > 0.3)).astype(np.float32), device=device),
        f(b).abs() + 0.1,
    ]


TD_SHAPES = [(256, 4), (1024, 4), (4096, 4), (300, 4), (37, 2)]


def _check_td(args, a, double):
    """The kernels against the plain versions on ``args``; the backward
    writes (2B, A) rows, as the learner's q_both."""
    b = args[0].shape[0]
    loss, td = td_loss_fwd(*args, 1.0, double)
    ref_loss, ref_td = td_loss_reference(*args, 1.0, double)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(td, ref_td, rtol=1e-5, atol=1e-6)
    g = torch.tensor(0.7, device=args[0].device)
    dq = td_loss_bwd(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    want = td_loss_backward_reference(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    torch.testing.assert_close(dq, want, rtol=1e-5, atol=1e-7)
    assert not dq[b:].any()
    torch.cuda.synchronize()
    return td


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("shape", TD_SHAPES)
def test_td_kernel_matches_plain(cuda, shape, double):
    b, a = shape
    args = _inputs(b, a, seed=b + a, device=cuda)
    td_kernels.reset_counts()
    _check_td(args, a, double)
    assert td_kernels.launches == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    partials, ticket = td_kernels.fwd_scratch(cuda)
    assert int(ticket) == 0, "the last block resets the ticket counter"


@pytest.mark.parametrize("b", [256, 4096])
def test_td_kernel_clip_case(cuda, b):
    """|td| past delta everywhere: the gradient saturates at w·delta/B."""
    args = _inputs(b, 4, seed=7, device=cuda)
    args[4] = args[4] + 100.0
    td = _check_td(args, 4, True)
    assert float(td.abs().min()) > 1.0


@pytest.mark.parametrize("b", [256, 4096])
def test_td_kernel_scalar_path_on_misaligned_rows(cuda, b):
    """Rows that are not 16-byte aligned take the scalar path."""
    args = _inputs(b, 4, seed=11, device=cuda)
    for i in range(3):
        flat = torch.empty(b * 4 + 1, device=cuda)
        view = flat[1:].view(b, 4)
        view.copy_(args[i])
        args[i] = view
    assert args[0].is_contiguous() and not td_kernels.float4_rows(4, *args[:3])
    _check_td(args, 4, True)


def test_td_kernel_loss_is_bitwise_stable(cuda):
    """100 forward calls at B = 4096 (16 blocks and the last-block sum) give
    the same loss and td bit for bit; after a CUDA-graph replay of 10 calls
    the ticket counter is back at 0 and the result is the same again."""
    args = _inputs(4096, 4, seed=3, device=cuda)
    loss0, td0 = td_loss_fwd(*args, 1.0, True)
    for _ in range(100):
        loss, td = td_loss_fwd(*args, 1.0, True)
        assert torch.equal(loss, loss0) and torch.equal(td, td0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        td_loss_fwd(*args, 1.0, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [td_loss_fwd(*args, 1.0, True) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    _, ticket = td_kernels.fwd_scratch(cuda)
    assert int(ticket) == 0
    for loss, td in outs:
        assert torch.equal(loss, loss0) and torch.equal(td, td0)


def test_learner_update_on_gpu_matches_cpu(cuda):
    """One learner update through the kernel on the GPU against the plain
    path on the CPU, from the same params and batch: rtol 1e-4."""
    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(lunar_per(), batch_size=256)
    rng = np.random.default_rng(0)
    batch = dict(
        obs=rng.standard_normal((256, 9)), action=rng.integers(0, 4, 256),
        reward=rng.standard_normal(256), next_obs=rng.standard_normal((256, 9)),
        bootstrap=0.97 * (rng.random(256) > 0.2),
    )
    weights = rng.random(256) + 0.1
    results = []
    for device in ("cpu", cuda):
        net = QNetwork(9, 4, hidden=cfg.hidden, generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(cfg)
        ts = init_train_state(net.to(device), opt)
        lb = LearnBatch(**{
            k: torch.tensor(v, dtype=torch.int32 if k == "action" else torch.float32, device=device)
            for k, v in batch.items()
        })
        td_kernels.reset_counts()
        ts, loss, td = build_update_step(opt, cfg)(
            ts, lb, torch.tensor(weights, dtype=torch.float32, device=device)
        )
        results.append((ts, loss.cpu(), td.cpu()))
    assert td_kernels.launches == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    (ts_c, loss_c, td_c), (ts_g, loss_g, td_g) = results
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(td_g, td_c, rtol=1e-4, atol=1e-5)
    for pc, pg in zip(ts_c.online.parameters(), ts_g.online.parameters()):
        torch.testing.assert_close(pg.detach().cpu(), pc.detach(), rtol=1e-4, atol=1e-6)


def _slot_inputs(n, c, b, seed, dyadic, device):
    rng = np.random.default_rng(seed)
    if dyadic:
        p = rng.integers(1, 257, (n, c)) / 64.0
        p[rng.random((n, c)) < 0.3] = 0.0
        p[0] = 0.0  # an all-zero row
    else:
        p = rng.random((n, c)) ** 3
    env = rng.integers(0, n, b)
    env[:2] = (-1, n)  # rows outside [0, N) select nothing
    env[3] = n - 1  # a row with mass (row 0 of the dyadic priorities has none)
    u = rng.random(b)
    u[2:5] = (0.0, 1.5, 1.0)  # no mass; past the total; the total itself
    return (
        torch.tensor(p, dtype=torch.float32, device=device),
        torch.tensor(env, dtype=torch.int64, device=device),
        torch.tensor(u, dtype=torch.float32, device=device),
    )


def _misaligned(t):
    """A contiguous copy of ``t`` whose rows are not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


# (N, C, B): lunar_per_scaled(1024), lunar_per, lunar_per_scaled(4096) with the
# sampler on; C = 200 and 300 (a warp, 8 and 12 values a lane); C = 37 on
# misaligned rows (the scalar path); C = 20000 (the block's chunk loop), with
# the plan the kernel must take: threads per draw, values, float4 loads, chunks
SLOT_CASES = {
    (1024, 512, 1024): (32, 16, True, 1),
    (128, 4096, 256): (256, 16, True, 1),
    (4096, 128, 4096): (32, 4, True, 1),
    (5, 200, 37): (32, 8, True, 1),
    (6, 300, 40): (32, 12, True, 1),
    (5, 37, 64): (32, 4, False, 1),
    (3, 20000, 64): (1024, 16, True, 2),
}


# random priorities: the share of mismatches is taken over at least this many
# draws, in calls of B; at B = 64 a single draw would be 1.6 %
SHARE_DRAWS = 1024


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,c,b", list(SLOT_CASES))
def test_slot_kernel_matches_plain(cuda, n, c, b, dyadic):
    calls = 1 if dyadic else -(-SHARE_DRAWS // b)
    mismatches = 0
    for k in range(calls):
        p, env, u = _slot_inputs(n, c, b, seed=n + c + b + k, dyadic=dyadic, device=cuda)
        if c % 4:
            p = _misaligned(p)
        assert tuple(sample_kernels.slot_plan(p).values()) == SLOT_CASES[(n, c, b)]
        sample_kernels.reset_counts()
        got = slot_select(p, env, u)
        want = slot_select_reference(p, env, u)
        torch.cuda.synchronize()
        assert sample_kernels.launches == {"per_slot_sample": 1}
        assert sample_kernels.plain_calls == {"per_slot_sample": 0}
        assert got.dtype == torch.int64 and got.shape == (b,)
        assert int(got[0]) == int(got[1]) == int(got[2]) == 0
        assert int(got[3]) == c - 1
        if dyadic:
            assert torch.equal(got, want)
            continue
        rows = torch.where(
            ((env >= 0) & (env < n))[:, None], p[env.clamp(0, n - 1)], 0.0
        ).double().cpu().numpy()
        total = rows.sum(axis=1).astype(np.float32)
        draw = u.double().cpu().numpy() * total
        cdf = np.cumsum(rows, axis=1)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        for i in np.flatnonzero(got != want):
            lo, hi = sorted((got[i], want[i]))
            assert np.abs(cdf[i, lo:hi] - draw[i]).max() <= 8 * np.spacing(total[i]), i
        mismatches += int((got != want).sum())
    assert mismatches < 0.01 * calls * b


@pytest.mark.parametrize("c", [200, 37, 300, 4096, 20000])
def test_slot_kernel_edge_semantics(cuda, c):
    """tests/test_torch_sample_kernel.py's edge cases on every path of the
    kernel, against the plain version: leading zero slots with u = 0, an
    all-zero row, u = 1.0 (the total) and 1.5 (past it), rows -1 and N."""
    p = np.random.default_rng(c).integers(1, 257, (4, c)) / 64.0
    p[0, :17] = 0.0
    p[2] = 0.0
    p = torch.tensor(p, dtype=torch.float32, device=cuda)
    env = torch.tensor([0, 0, 2, 2, 1, 3, 1, -1, 4, 3, 0], device=cuda)
    u = torch.tensor([0.0, 0.5, 0.0, 0.7, 1.5, 1.0, 0.999999, 0.3, 0.3, 1e-7, 0.25],
                     device=cuda)
    got = slot_select(p, env, u).tolist()
    assert got == slot_select_reference(p, env, u).tolist()
    assert got[0] == 0 and got[2] == got[3] == 0
    assert got[4] == got[5] == c - 1
    assert got[7] == got[8] == 0


@pytest.mark.parametrize("n,c,b", [(1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096)])
def test_slot_kernel_is_bitwise_stable(cuda, n, c, b):
    """100 calls give the same slots bit for bit, and so do 10 calls
    replayed from a CUDA graph."""
    p, env, u = _slot_inputs(n, c, b, seed=1, dyadic=False, device=cuda)
    slots0 = slot_select(p, env, u)
    for _ in range(100):
        assert torch.equal(slot_select(p, env, u), slots0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        slot_select(p, env, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [slot_select(p, env, u) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, slots0) for o in outs)


def test_jointed_frame_on_gpu_matches_cpu(cuda):
    """One jointed lander frame (the lunar_jointed_* solver iterations
    (120, 40)) on the GPU against the same frame on the CPU, from 64 landers
    after a short flight near the ground.  The CPU and the GPU round float32
    differently in the last ulp and the solver carries that far on hard
    impacts (tests/test_torch_lander_solver.py), so: positions atol 1e-5,
    velocities 1e-4, accumulators 1e-5 + rtol 1e-4 on 90 % of the landers,
    and every lander within 1.2e-4, 3e-2 and 2e-2; flags exact."""
    from deep_q_learning_tpu_torch.envs.heuristic import touchdown_states
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander, LunarLanderParams

    def to(obj, device):
        if obj is None or isinstance(obj, torch.Tensor):
            return None if obj is None else obj.to(device)
        return dataclasses.replace(obj, **{
            f.name: to(getattr(obj, f.name), device) for f in dataclasses.fields(obj)})

    env, p = LunarLander(), LunarLanderParams(vel_iters=120, pos_iters=40)
    n = 64
    g = torch.Generator().manual_seed(3)
    _, st = touchdown_states(env, p, n, g, frames=30)
    assert (st.leg1 & st.leg2).any() and (~st.leg1 & ~st.leg2).any()
    actions = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32)
    draws = torch.rand((n, 2), generator=g) * 2 - 1
    _, c, _, c_term, _ = env.step_env(None, st, actions, p, draws)
    _, gpu, _, g_term, _ = env.step_env(None, to(st, cuda), actions.to(cuda), p, draws.to(cuda))
    gpu = to(gpu, "cpu")
    pairs = [(getattr(c, f), getattr(gpu, f), f in ("x", "y", "angle"))
             for f in ("x", "y", "angle", "vx", "vy", "omega")]
    for leg in ("leg1_body", "leg2_body"):
        pairs += [(getattr(getattr(c, leg), f), getattr(getattr(gpu, leg), f), f in ("cx", "cy", "a"))
                  for f in ("cx", "cy", "a", "vx", "vy", "w")]
    past_tight = torch.zeros(n, dtype=torch.bool)
    for want, got, is_pos in pairs:
        gap = (got - want).abs()
        assert float(gap.max()) <= (1.2e-4 if is_pos else 3e-2)
        past_tight |= gap > (1e-5 if is_pos else 1e-4)
    for f in ("j1", "j2", "c1", "c2"):
        want, got = getattr(c.solver_acc, f), getattr(gpu.solver_acc, f)
        gap = (got - want).abs().reshape(n, -1)
        assert float(gap.max()) <= 2e-2
        past_tight |= (gap > 1e-5 + 1e-4 * want.abs().reshape(n, -1)).any(1)
    assert float(past_tight.float().mean()) <= 0.1, int(past_tight.sum())
    for f in ("leg1", "leg2"):
        assert torch.equal(getattr(c, f), getattr(gpu, f))
    assert torch.equal(c_term, g_term.cpu())
