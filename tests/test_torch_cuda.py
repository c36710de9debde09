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
call.  With a population's member axis: each member's loss, td and dQ
bitwise its own unbatched call, and one slot launch over every member's
rows bitwise M per-member calls; a population learner update on the GPU
vs the CPU at rtol 1e-4.  ``ops.fused_td_loss`` on the GPU vs the CPU at
the kernels' tolerances, one launch each way.  At world size 1 on NCCL, ``DistributedTrainer``
is bitwise ``Trainer``; ``dryrun_multichip(1)`` runs the three kernels
under the all-reduce.  The host-compat agent's update on the GPU vs the
CPU at rtol 1e-4; a bf16-trunk update on the GPU vs the CPU: the loss
rtol 1e-3, every parameter within 2.1 lr and at most 1 % beyond lr / 10.
The gymnasium harness's CUDA-graph replay of a jointed frame: bitwise the
eager frame.  A rank's superstep as CUDA graphs (graph L1, the all-reduce,
graph L2): bitwise the eager rank and, at world size 1, the graphed
``Trainer``.  The greedy evaluators with each eval step one CUDA graph and
the host agent's update one graph replay: bitwise their eager forms.  ``VectorEnv``'s CUDA graphs of the lander's vector step and
reset pool: bitwise the eager step over 64 jointed frames with auto-resets
and over two ``lunar_per`` supersteps (the whole runner); a graphed step
runs the kernels the eager step runs, the jointed lander's kernel J1 once
among them and the solver's S1 not on its own; a ``lander_vel_tol > 0``
trainer graphs, bitwise its eager twin.  The single learner's frame and update as CUDA graphs
(``GraphedLearner``): the first training frames apply one update each
(the Adam count 1, 2, 3, 4 and the runner bitwise the eager learner's
after each), K1 and K2 counted in the profiler's trace once per update.
The population's as CUDA graphs (``GraphedPopulation``): bitwise the
eager population after every frame with mixed gates, across a change of
hyperparameters that makes the graphs start over.
F5: ``epsilon_greedy`` with a float ε equals it with a device tensor over
2^20 draws, and a graphed ``lunar_per`` learner is bitwise its eager twin
over 512 exploring frames.  The uniform replay's learner and the classic
envs' step as CUDA graphs: bitwise ``graphed=False`` for the four
uniform-replay presets; the card's float64 uniforms lie on the grid the
rank-bias count assumes.
S1 against the plain solver: bit for bit (every bit of every field,
accumulator and flag) at N = 128, 1024 and 37, N = 2 at (180, 60) and the
ragged N = 3, 33 and 129, with and without the early exit; over 100 calls
and a graph replay; its wrapper refuses a wrong dtype, a non-contiguous
input and mixed devices.  R1, the rigid lander's step, against its plain
versions through ``step_env`` and ``reset_env``: bit for bit at N = 1, 37,
128, 129, 1024 and 8192 with the wind off and on, over a graph replay; its
wrapper's refusals; its vector step (the step, the auto-reset from a pool
and the time feature in one launch) against the plain composition at the
same N, the wind and the time feature off and on.  J1, the jointed
lander's frame around S1, against its plain versions (S1 inside them)
through ``step_env`` and ``reset_env``: bit
for bit at N = 37, 128 and 1024 with the wind off and on, and on the reset
frame; over 100 calls and a graph replay; its wrapper's refusals.  A1, C1
and M1, the classic envs' kernels, against their plain versions through
``step_env`` and through ``VectorEnv._step`` without a pool (the time
feature off and on): bit for bit at N = 1, 128, 4096 and 8192 on states of
a flight; over 100 calls and a graph replay; their wrapper's refusals."""

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


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("shape", [(256, 4), (37, 2)])
def test_fused_td_loss_on_the_card_matches_the_cpu(cuda, shape, double):
    """``ops.fused_td_loss`` (the JAX package's signature) launches K1/K2
    once each on CUDA tensors and gives the CPU's loss, td and dQ."""
    b, a = shape
    args = _inputs(b, a, seed=b + 2 * a, device=cuda)
    got, want = [], []
    for device, out in ((cuda, got), (torch.device("cpu"), want)):
        q_s, *rest = [x.detach().to(device) for x in args]
        q_s.requires_grad_(True)
        td_kernels.reset_counts()
        loss, td = td_kernels.fused_td_loss(q_s, *rest, delta=1.0, double=double)
        loss.backward()
        kind = "launches" if device.type == "cuda" else "plain_calls"
        assert getattr(td_kernels, kind) == {"td_loss_fwd": 1, "td_loss_bwd": 1}
        out.extend(x.detach().cpu() for x in (loss, td, q_s.grad))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-7)


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


def _member_inputs(m, b, a, seed, device):
    """Member-axis inputs as a population's learner gives them: ``q_s`` and
    ``q_next_online`` the halves of one (M, 2B, A) ``q_both``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)  # noqa: E731
    q_both = f(m, 2 * b, a)
    return [
        q_both[:, :b], q_both[:, b:], f(m, b, a),
        torch.tensor(rng.integers(0, a, (m, b)).astype(np.int32), device=device),
        f(m, b),
        torch.tensor((0.97 * (rng.random((m, b)) > 0.3)).astype(np.float32), device=device),
        f(m, b).abs() + 0.1,
    ]


@pytest.mark.parametrize("m,b,a", [(8, 256, 4), (10, 256, 4), (8, 1024, 4), (3, 37, 4), (2, 300, 2)])
def test_td_kernel_member_axis_matches_plain(cuda, m, b, a):
    """One launch each way for M members: against the plain versions, and
    each member bitwise equal to its own unbatched call."""
    args = _member_inputs(m, b, a, seed=m * b + a, device=cuda)
    td_kernels.reset_counts()
    loss, td = td_loss_fwd(*args, 1.0, True)
    g = torch.rand((m,), device=cuda) + 0.5
    dq = td_loss_bwd(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    assert td_kernels.launches == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    ref_loss, ref_td = td_loss_reference(*args, 1.0, True)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(td, ref_td, rtol=1e-5, atol=1e-6)
    want = td_loss_backward_reference(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    torch.testing.assert_close(dq, want, rtol=1e-5, atol=1e-7)
    assert dq.shape == (m, 2 * b, a) and not dq[:, b:].any()
    for k in range(m):
        one_loss, one_td = td_loss_fwd(*[x[k].contiguous() for x in args], 1.0, True)
        one_dq = td_loss_bwd(one_td, args[3][k], args[6][k], g[k].contiguous(), a, 1.0,
                             out_rows=2 * b)
        assert torch.equal(one_loss, loss[k]) and torch.equal(one_td, td[k])
        assert torch.equal(one_dq, dq[k])
    _, ticket = td_kernels.fwd_scratch(cuda)
    assert int(ticket) == 0


def test_td_kernel_member_loss_is_bitwise_stable(cuda):
    """M = 8 members of 4 blocks each (one ticket over the grid): 100 calls
    and a CUDA-graph replay give the same loss and td bit for bit, and the
    ticket counter is back at 0."""
    args = _member_inputs(8, 1024, 4, seed=4, device=cuda)
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
    assert all(torch.equal(lo, loss0) and torch.equal(t, td0) for lo, t in outs)


@pytest.mark.parametrize("dyadic", [True, False])
def test_slot_kernel_over_members_equals_separate_calls(cuda, dyadic):
    """lunar_per's PER at 8 members, (M·N, C, M·B) = (1024, 4096, 2048): one
    launch over every member's rows gives bitwise the slots of 8 calls on
    each member's own (N, C) rows."""
    m, n, c, b = 8, 128, 4096, 256
    p, _, _ = _slot_inputs(m * n, c, 8, seed=21, dyadic=dyadic, device=cuda)
    rng = np.random.default_rng(22)
    env = torch.tensor(rng.integers(0, n, (m, b)), device=cuda)
    u = torch.tensor(rng.random((m, b)).astype(np.float32), device=cuda)
    sample_kernels.reset_counts()
    got = sample_kernels.slot_select_members(p, env, u)
    assert sample_kernels.launches == {"per_slot_sample": 1}
    each = torch.stack([slot_select(p[k * n:(k + 1) * n].contiguous(), env[k], u[k].contiguous())
                        for k in range(m)])
    assert torch.equal(got, each)
    if dyadic:
        flat = (env + torch.arange(m, device=cuda)[:, None] * n).reshape(-1)
        assert torch.equal(got.reshape(-1), slot_select_reference(p, flat, u.reshape(-1)))


def test_population_update_on_gpu_matches_cpu(cuda):
    """One population learner update (3 members, lunar_per's learner at batch
    256, per-member learning rates, member 1's gate closed) on the GPU
    against the CPU: rtol 1e-4; member 1 unchanged on both.  Each member's
    parameters atol a tenth of its learning rate: Adam's first step moves
    an element by lr · g / (|g| + 1e-8), so where |g| is within a few 1e-8
    of 0 the step depends on the gradient's last bits, and the GPU sums the
    batch in another order than the CPU."""
    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.algos.dqn import MemberHyperParams
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.models import MemberQNetwork
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, m, b = lunar_per(), 3, 256
    rng = np.random.default_rng(1)
    batch = dict(
        obs=rng.standard_normal((m, b, 9)), action=rng.integers(0, 4, (m, b)),
        reward=rng.standard_normal((m, b)), next_obs=rng.standard_normal((m, b, 9)),
        bootstrap=0.97 * (rng.random((m, b)) > 0.2),
    )
    weights = rng.random((m, b)) + 0.1
    lrs = [1e-4, 3e-4, 1e-3]
    results = []
    for device in ("cpu", cuda):
        net = MemberQNetwork(m, 9, 4, hidden=cfg.hidden,
                             generators=[torch.Generator().manual_seed(k) for k in range(m)])
        init = [p.detach().clone() for p in net.parameters()]
        opt = make_optimizer(cfg)
        ts = init_train_state(net.to(device), opt)
        hyper = MemberHyperParams.from_config(cfg, m, device)
        hyper.learning_rate = torch.tensor(lrs, device=device)
        lb = LearnBatch(**{
            k: torch.tensor(v, dtype=torch.int32 if k == "action" else torch.float32, device=device)
            for k, v in batch.items()
        })
        td_kernels.reset_counts()
        ts, loss, td = build_update_step(opt, cfg)(
            ts, lb, torch.tensor(weights, dtype=torch.float32, device=device), hyper,
            [True, False, True])
        results.append((ts, loss.cpu(), td.cpu()))
    assert td_kernels.launches == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    (ts_c, loss_c, td_c), (ts_g, loss_g, td_g) = results
    assert ts_g.opt_state.count == ts_c.opt_state.count == [1, 0, 1]
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(td_g, td_c, rtol=1e-4, atol=1e-5)
    for pc, pg, p0 in zip(ts_c.online.parameters(), ts_g.online.parameters(), init):
        for k, lr in enumerate(lrs):
            torch.testing.assert_close(pg[k].detach().cpu(), pc[k].detach(), rtol=1e-4, atol=lr / 10)
        assert torch.equal(pg[1].detach().cpu(), p0[1])


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


def test_graphed_lander_frames_equal_eager_frames(cuda):
    """``envs/gym_compat._Frames`` replays one CUDA graph of the jointed
    frame (gym's (180, 60) iterations) on the card: bit for bit the eager
    frames, over 5 frames of 64 landers near the ground (flights, contacts,
    crashes) with random actions and dispersion draws."""
    from deep_q_learning_tpu_torch.envs.gym_compat import _Frames
    from deep_q_learning_tpu_torch.envs.heuristic import touchdown_states
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander

    env = LunarLander()
    p = env.default_params()
    n = 64
    g = torch.Generator(device=cuda).manual_seed(5)
    _, eager = touchdown_states(env, p, n, g, frames=20)
    frames = _Frames(env, p, _copied(eager))
    for _ in range(5):
        actions = torch.randint(0, 4, (n,), generator=g, device=cuda, dtype=torch.int32)
        draws = torch.rand((n, 2), generator=g, device=cuda) * 2 - 1
        obs, eager, *rest = env.step_env(None, eager, actions, p, draws)
        got = frames.step(actions, draws)
        for a, b in zip(got, (obs, *rest)):
            assert torch.equal(a, b)
        for (name, a), (_, b) in zip(_leaves(frames.state), _leaves(eager)):
            assert torch.equal(a, b), name
    assert frames._graph is not None


def _leaves(state, prefix=""):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif v is not None:
            yield from _leaves(v, prefix + f.name + ".")


def _copied(state):
    return dataclasses.replace(state, **{
        f.name: (v.clone() if isinstance(v, torch.Tensor) else _copied(v))
        for f in dataclasses.fields(state) if (v := getattr(state, f.name)) is not None})


# one vector step card vs CPU: the CPU tests' atol 1e-6 for CartPole and
# MountainCar; Acrobot's RK4 of sin/cos 1e-5 (angles through cos and sin)
CLASSIC_TOL = {"CartPole-v1": 1e-6, "MountainCar-v0": 1e-6, "Acrobot-v1": 1e-5}


@pytest.mark.parametrize("env_id", list(CLASSIC_TOL))
def test_classic_env_step_on_gpu_matches_cpu(cuda, env_id):
    """One vector step of 4096 envs after 40 random steps from fresh
    resets, on the GPU and on the CPU from the same states and actions;
    flags equal except at most one lane at a threshold."""
    from deep_q_learning_tpu_torch.envs import make_env

    env, p = make_env(env_id)
    n = 4096
    g = torch.Generator().manual_seed(9)
    _, st = env.reset_env(g, n, p)
    for _ in range(40):
        actions = torch.randint(0, env.num_actions, (n,), generator=g, dtype=torch.int32)
        _, st, *_ = env.step_env(None, st, actions, p)
    actions = torch.randint(0, env.num_actions, (n,), generator=g, dtype=torch.int32)
    cpu = env.step_env(None, st, actions, p)
    on_gpu = dataclasses.replace(st, **{f.name: getattr(st, f.name).to(cuda)
                                        for f in dataclasses.fields(st)})
    gpu = env.step_env(None, on_gpu, actions.to(cuda), p)
    tol = CLASSIC_TOL[env_id]
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], atol=tol, rtol=0)
    for f in dataclasses.fields(cpu[1]):
        want, got = getattr(cpu[1], f.name), getattr(gpu[1], f.name).cpu()
        if f.name.startswith("theta"):
            want, got = torch.stack([want.cos(), want.sin()]), torch.stack([got.cos(), got.sin()])
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    same = (gpu[3].cpu() == cpu[3]) & (gpu[4].cpu() == cpu[4])
    assert int((~same).sum()) <= 1
    assert torch.equal(gpu[2].cpu()[same], cpu[2][same])


def test_world_one_nccl_distributed_trainer_equals_trainer(cuda):
    """A world-1 NCCL group: ``DistributedTrainer`` on lunar_per's learner
    (the TD kernels under the all-reduce), graphed (graph L1, the
    all-reduce, graph L2), takes the same supersteps as the graphed
    ``Trainer``, bitwise (metrics and the whole runner); each kernel's
    wrapper counts graph L1's eager call and capture, and the profiler's
    trace counts each kernel once per update on the device."""
    import torch.distributed as dist

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels
    from deep_q_learning_tpu_torch.parallel import distributed_init
    from deep_q_learning_tpu_torch.train import DistributedTrainer, Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(lunar_per(), steps_per_superstep=4, training_start=0,
                              use_pallas_sampler=True)
    distributed_init(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        single = Trainer(cfg, device="cuda").init(seed=0)
        ranked = DistributedTrainer(cfg, device="cuda").init(seed=0)
        assert isinstance(ranked._superstep, GraphedLearner)
        m_single = single.step()
        td_kernels.reset_counts()
        sample_kernels.reset_counts()
        assert ranked.step() == m_single
        assert td_kernels.launches == {"td_loss_fwd": 2, "td_loss_bwd": 2}
        assert sample_kernels.launches == {"per_slot_sample": 2}
        _same_tree(ckpt._to_tree(single.runner), ckpt._to_tree(ranked.runner))
        trace = traced_kernels(ranked.step)
        assert learner_kernels(trace) == {"td_loss_fwd": 4, "td_loss_bwd": 4,
                                          "per_slot_sample": 4}
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_one_rank_on_the_card(cuda):
    """One NCCL rank of the flagship's structure, graphed: 4 updates, each
    kernel's wrapper counting graph L1's eager call and capture."""
    from deep_q_learning_tpu_torch.parallel import dryrun_multichip

    (report,) = dryrun_multichip(1, device="cuda")
    assert report["backend"] == "nccl" and report["updates"] == 4 and report["graphed"]
    assert report["launches"] == {"td_loss_fwd": 2, "td_loss_bwd": 2, "per_slot_sample": 2}
    assert not any(report["plain_calls"].values())


def test_graphed_rank_equals_eager_rank_on_the_card(cuda):
    """A world-1 NCCL rank on lunar_per at 64 envs with the PER sampler,
    graphed and eager (``graphed_learner=False``) from one seed: metrics
    and the whole runner bitwise after each of 3 supersteps."""
    import torch.distributed as dist

    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.parallel import distributed_init
    from deep_q_learning_tpu_torch.train import DistributedTrainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(lunar_per(), num_envs=64, steps_per_superstep=16,
                              training_start=512, use_pallas_sampler=True)
    distributed_init(device="cuda")
    try:
        graphed = DistributedTrainer(cfg, device="cuda").init(seed=0)
        eager = DistributedTrainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
        for i in range(3):
            assert graphed.step() == eager.step(), i
            _same_tree(ckpt._to_tree(graphed.runner), ckpt._to_tree(eager.runner),
                       f"superstep {i}")
        assert graphed.runner.train.updates == 41
    finally:
        dist.destroy_process_group()


class _Corridor:
    """5-state corridor, classic 4-tuple protocol (``tests/test_torch_compat.py``)."""

    def reset(self):
        self.pos = 2
        return self._obs()

    def _obs(self):
        o = np.zeros(5, np.float32)
        o[self.pos] = 1.0
        return o

    def step(self, action):
        self.pos = int(np.clip(self.pos + (1 if action == 1 else -1), 0, 4))
        done = self.pos in (0, 4)
        return self._obs(), 1.0 if self.pos == 4 else (-1.0 if self.pos == 0 else -0.01), done, {}


def _update_on_both(cfg, ts, batch, weights):
    """One update of ``cfg`` from copies of ``ts`` on the CPU and the GPU."""
    import copy

    from deep_q_learning_tpu_torch.algos import build_update_step, make_optimizer
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    out = []
    for device in ("cpu", "cuda"):
        c = copy.deepcopy(ts)
        c.online.to(device)
        c.target.to(device)
        c.opt_state.mu = [t.to(device) for t in c.opt_state.mu]
        c.opt_state.nu = [t.to(device) for t in c.opt_state.nu]
        c.opt_state.device_count = c.opt_state.device_count.to(device)
        lb = LearnBatch(**{k: v.to(device) for k, v in batch.items()})
        c, loss, _ = build_update_step(make_optimizer(cfg), cfg)(c, lb, weights.to(device))
        out.append((loss.cpu(), [p.detach().cpu() for p in c.online.parameters()]))
    return out


def test_host_agent_update_on_gpu_matches_cpu(cuda):
    """The compat agent on the card with ``use_pallas``: K1/K2 launched once
    per update and no plain call; then one update from its state on the GPU
    vs the CPU at rtol 1e-4."""
    from deep_q_learning_tpu_torch.compat.host_loop import HostAgent
    from deep_q_learning_tpu_torch.config import DQNConfig

    cfg = DQNConfig(num_envs=1, batch_size=32, buffer_capacity=4096, training_start=64,
                    dueling=False, hidden=(32,), learning_rate=3e-3, optimizer="adam",
                    gamma=0.9, eps_decay=0.95, eps_min=0.01, train_every=2,
                    target_replace_episodes=10, max_steps_in_episode=20, use_pallas=True)
    agent = HostAgent(_Corridor(), 5, 2, cfg, device="cuda")
    td_kernels.reset_counts()
    agent.training(max_episodes=40, verbose=False)
    updates = agent.train_state.updates
    assert updates > 2 and np.isfinite(agent._last_loss)
    # the update's graph: its eager call and its capture
    assert td_kernels.launches == {"td_loss_fwd": 2, "td_loss_bwd": 2}
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    obs, action, reward, next_obs, done = agent.buffer.sample(cfg.batch_size)
    batch = dict(obs=torch.from_numpy(obs), action=torch.from_numpy(action),
                 reward=torch.from_numpy(reward), next_obs=torch.from_numpy(next_obs),
                 bootstrap=torch.from_numpy(cfg.gamma * (1.0 - done.astype(np.float32))))
    (lc, pc), (lg, pg) = _update_on_both(cfg, agent.train_state, batch,
                                         torch.ones((cfg.batch_size,)))
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    for a, c in zip(pg, pc):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)


def test_host_agent_graphed_update_equals_eager_on_the_card(cuda):
    """The compat agent's update as one CUDA graph replay against the eager
    update, from one seed, with ``use_pallas``: every loss and the learner
    (weights, target, Adam moments and count) bitwise over at least 50
    updates."""
    from deep_q_learning_tpu_torch.compat.host_loop import HostAgent
    from deep_q_learning_tpu_torch.config import DQNConfig

    cfg = DQNConfig(num_envs=1, batch_size=32, buffer_capacity=4096, training_start=64,
                    dueling=False, hidden=(32,), learning_rate=3e-3, optimizer="adam",
                    gamma=0.9, eps_decay=0.95, eps_min=0.01, train_every=2,
                    target_replace_episodes=3, max_steps_in_episode=20, use_pallas=True,
                    solve_threshold=None)
    agents = []
    for graphed in (True, False):
        agent = HostAgent(_Corridor(), 5, 2, cfg, device="cuda", graphed=graphed)
        agent.losses = []
        step = agent._train_step

        def train_step(step=step, agent=agent):
            agent.losses.append(step())
            return agent.losses[-1]

        agent._train_step = train_step
        agent.training(max_episodes=80, verbose=False)
        agents.append(agent)
    g, e = agents
    assert len(g.losses) >= 50 and g.losses == e.losses
    assert g._learn.graph is not None and e._learn.graph is None
    ts_g, ts_e = g.train_state, e.train_state
    assert ts_g.updates == ts_e.updates == int(ts_g.opt_state.device_count)
    for a, b in zip([*ts_g.online.parameters(), *ts_g.target.parameters(), *ts_g.opt_state.mu,
                     *ts_g.opt_state.nu],
                    [*ts_e.online.parameters(), *ts_e.target.parameters(), *ts_e.opt_state.mu,
                     *ts_e.opt_state.nu]):
        assert torch.equal(a, b)


def _eval_pair(evaluate, venv, env_params, network, max_steps=None, members=None):
    """``evaluate`` (graphed) and its eager form on the same envs, from one
    seed, twice each: every result bitwise equal; the graphed step captured."""
    from deep_q_learning_tpu_torch.algos.evaluate import build_evaluator

    eager = build_evaluator(venv, env_params, env_params.max_steps_in_episode, members=members,
                            graphed=False)
    out = []
    for fn in (evaluate, eager, evaluate, eager):
        ev = fn(network, torch.Generator(device="cuda").manual_seed(1), max_steps)
        out.append([x.cpu() for x in ev])
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert evaluate.graph.graph is not None
    return out[0]


@pytest.mark.parametrize("preset", ["lunar_per", "lunar_jointed_per", "cartpole_vector"])
def test_graphed_evaluator_equals_eager_on_the_card(cuda, preset):
    """Each greedy eval step as one CUDA graph (the jointed lander's with S1
    inside it) against the eager evaluator, 128 episodes (64 frames of the
    jointed lander), bitwise; then a new runner's network, bitwise too."""
    from deep_q_learning_tpu_torch.config import PRESETS
    from deep_q_learning_tpu_torch.train import Trainer

    tr = Trainer(PRESETS[preset](), device="cuda").init(seed=0)
    max_steps = 64 if preset == "lunar_jointed_per" else None
    for seed in (0, 1):
        if seed:
            tr.init(seed=seed)
        ret, length, truncated = _eval_pair(tr._evaluate, tr.eval_venv, tr.env_params,
                                            tr.runner.train.online, max_steps)
        assert ret.shape == (128,) and torch.isfinite(ret).all()
        assert (length <= tr.env_params.max_steps_in_episode).all()


def test_graphed_population_evaluator_equals_eager_on_the_card(cuda):
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer

    cfg = dataclasses.replace(lunar_per(), num_envs=16, hidden=(64, 64))
    trainer = PopulationTrainer(cfg, 3, eval_envs=8, device="cuda")
    runner = trainer.init(seed=0)
    ret, _, _ = _eval_pair(trainer._evaluate, trainer.eval_venv, trainer._eval_env_params,
                           runner.train.online, members=3)
    assert ret.shape == (24,) and torch.isfinite(ret).all()


def test_bf16_update_on_gpu_matches_cpu(cuda):
    """A bf16-trunk learner update (lunar_per's, through the TD kernels) on
    the GPU vs the CPU from a trained state: the loss rtol 1e-3, every
    parameter within 2.1 lr and at most 1 % beyond lr / 10 (the trunk's bf16
    products round in other places: a gradient below bf16 resolution may
    flip its sign, and Adam then moves the weight by about ±lr)."""
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.train import Trainer

    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels

    cfg = dataclasses.replace(lunar_per(), steps_per_superstep=4, training_start=0,
                              compute_dtype="bfloat16")
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    td_kernels.reset_counts()
    trainer.step()  # the learner's graphs: an eager call, then the capture
    trainer.step()  # the same cadence again: the superstep's graph captured
    # counted on the device: a replay does not pass the wrappers' counters
    assert learner_kernels(traced_kernels(trainer.step)) == {
        "td_loss_fwd": 4, "td_loss_bwd": 4, "per_slot_sample": 0}
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    online = trainer.runner.train.online
    assert online.features(trainer.runner.obs).dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    b = cfg.batch_size
    batch = dict(obs=torch.randn((b, 9), generator=g),
                 action=torch.randint(0, 4, (b,), generator=g, dtype=torch.int32),
                 reward=torch.randn((b,), generator=g), next_obs=torch.randn((b, 9), generator=g),
                 bootstrap=0.97 * (torch.rand((b,), generator=g) > 0.2).float())
    (lc, pc), (lg, pg) = _update_on_both(cfg, trainer.runner.train, batch,
                                         torch.rand((b,), generator=g) + 0.1)
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=1e-6)
    lr = cfg.learning_rate
    for a, c in zip(pg, pc):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, c, rtol=0, atol=2.1 * lr)
    far = sum(int(((a - c).abs() > lr / 10).sum()) for a, c in zip(pg, pc))
    assert far <= 0.01 * sum(a.numel() for a in pg)


def test_graphed_jointed_vector_step_equals_eager(cuda):
    """``VectorEnv``'s CUDA graphs of the jointed vector step and reset pool
    (``lunar_jointed_per``'s (120, 40) iterations, 128 landers) against the
    eager step, over 64 frames from a flight near the ground with episodes
    cut at 40 steps: terminations and truncations auto-reset; the pool and
    every frame's obs, states and transition bitwise.  Then the kernels one
    graphed step runs on the card (its replay and its draws) equal the
    kernels the eager step launches, by name and count, every launch matched
    to its kernel in the profiler's trace; J1 once among them, S1 not on
    its own (its body runs inside J1), and a few dozen in all (the plain
    solver alone is ~56k)."""
    from deep_q_learning_tpu_torch.envs import VectorEnv
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves, tree_map
    from deep_q_learning_tpu_torch.envs.heuristic import touchdown_states
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander, LunarLanderParams
    from deep_q_learning_tpu_torch.measure import traced_kernels

    env = LunarLander()
    p = LunarLanderParams(vel_iters=120, pos_iters=40, max_steps_in_episode=40)
    n = 128
    obs0, st0 = touchdown_states(env, p, n, torch.Generator(device=cuda).manual_seed(1), frames=20)
    lanes = torch.arange(n, dtype=torch.int32, device=cuda)
    runs = {}
    for graphed in (True, False):
        venv = VectorEnv(env, n, graphed=graphed)
        g = torch.Generator(device=cuda).manual_seed(3)
        acts = torch.Generator(device=cuda).manual_seed(4)
        pool = venv.fresh_pool(g, p)
        kept = [tree_map(torch.clone, pool)]
        obs, states = obs0.clone(), tree_map(torch.clone, st0)
        for _ in range(64):
            # half the lanes at random, half firing a side engine (crashes)
            actions = torch.where(lanes % 8 >= 4, torch.randint(
                0, 4, (n,), generator=acts, device=cuda, dtype=torch.int32), 1 + 2 * (lanes % 2))
            obs, states, tr = venv.step(g, states, actions, p, prev_obs=obs, fresh=pool)
            kept.append(tree_map(torch.clone, (obs, states, tr)))
        trace = traced_kernels(lambda: venv.step(g, states, actions, p, prev_obs=obs, fresh=pool))
        runs[graphed] = kept, trace
    (g_kept, gt), (e_kept, et) = runs[True], runs[False]
    for i, (a, b) in enumerate(zip(tree_leaves(g_kept), tree_leaves(e_kept))):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i}"
    transitions = [tr for _, _, tr in g_kept[1:]]
    assert any(bool(tr.terminated.any()) for tr in transitions)
    assert any(bool(tr.truncated.any()) for tr in transitions)
    g_kernels = sum((gt.graphed + gt.launched).values())
    assert gt.lost == et.lost == 0 and not et.graphed, (gt, et)
    assert gt.graphed + gt.launched == et.launched, (gt, et)
    assert g_kernels == et.launches and gt.launches < 10, (g_kernels, et.launches, gt.launches)
    j1, s1 = "jointed_step_kernel", "assembly_step_kernel"
    assert gt.count(j1) == et.count(j1) == 1 and g_kernels < 2_000, (gt, et)
    assert gt.count(s1) == et.count(s1) == 0, (gt, et)


def test_graphed_lunar_per_superstep_equals_eager(cuda):
    """Two ``lunar_per`` supersteps of 32 vector steps at full width, learning
    from 2048 stored transitions, with the frame and the learner update as
    CUDA graphs (the rigid lander's step among them) against
    ``graphed=False``: metrics and the whole runner (parameters, Adam,
    replay ring and priorities, env states) bitwise; K1 and K2 once per
    update, in the profiler's trace of the second superstep on the graphed
    path and by the wrappers' counters on the eager one."""
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(lunar_per(), steps_per_superstep=32, training_start=2048)
    runs = {}
    for graphed in (True, False):
        trainer = Trainer(cfg, device="cuda", graphed=graphed).init(seed=0)
        assert trainer.venv.graphed == graphed
        td_kernels.reset_counts()
        metrics = [trainer.step()]
        if graphed:
            counted = learner_kernels(traced_kernels(lambda: metrics.append(trainer.step())))
        else:
            metrics.append(trainer.step())
            counted = dict(td_kernels.launches, per_slot_sample=0)
        updates = metrics[-1].loss_count if graphed else sum(m.loss_count for m in metrics)
        assert counted == {"td_loss_fwd": updates, "td_loss_bwd": updates,
                           "per_slot_sample": 0} and updates, counted
        assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
        runs[graphed] = metrics, ckpt._to_tree(trainer.runner)
    assert runs[True][0] == runs[False][0]

    def same(a, b, where="runner"):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), where
        elif isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, where

    same(runs[True][1], runs[False][1])


def test_first_graphed_training_frames_apply_one_update_each(cuda):
    """The learner's graph runs its first call eagerly and captures on the
    second, so no frame applies its update twice: one ``lunar_per`` frame a
    superstep at full width, learning from the third, through the graphed
    learner frame by frame (``max_graphs = 0``: a repeated one-frame
    pattern would otherwise run as its superstep's graph) and the eager one
    from the same seed.  After each training
    frame the Adam count is the number of updates (1 after the first, an
    eager call; 2 after the capture and its replay; then replays) and the
    runners are bitwise equal."""
    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(lunar_per(), steps_per_superstep=1, training_start=3 * 128)
    graphed = Trainer(cfg, device="cuda").init(seed=0)
    graphed._superstep.max_graphs = 0  # frame by frame: no one-frame superstep graph
    eager = Trainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
    assert isinstance(graphed._superstep, GraphedLearner)
    assert not isinstance(eager._superstep, GraphedLearner) and eager.venv.graphed

    def same(a, b, where="runner"):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), where
        elif isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, where

    captured = []
    for frame in range(1, 7):
        assert graphed.step() == eager.step()
        updates = max(frame - 2, 0)
        count = graphed.runner.train.opt_state
        assert int(count.device_count) == count.count == updates, (frame, count.count)
        same(ckpt._to_tree(graphed.runner), ckpt._to_tree(eager.runner))
        captured.append(graphed._superstep.learn.graph is not None)
    # the update: eager at frame 3, captured and replayed at 4, replayed after
    assert captured == [False, False, False, True, True, True], captured
    assert graphed._superstep.frame.graph is not None


def test_graphed_population_equals_eager_with_mixed_gates(cuda):
    """The population's frame and update as CUDA graphs
    (``GraphedPopulation``): 3 members of ``lunar_per`` at 16 envs with the
    PER slot kernel, gates mixed (``train_every`` 1, 2, 3, member 2 from a
    later warm-up), one frame a superstep against the eager population from
    the same seed, frame by frame (``max_graphs = 0``); after each frame the
    runners are bitwise equal and every member's Adam count on the device
    is its host mirror.  Graph L makes
    its eager call at the first training frame and is captured at the
    next; new hyperparameters (``set_population_hyper``) make both graphs
    start over, and the runners stay equal."""
    from deep_q_learning_tpu_torch.algos.superstep import GraphedPopulation
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.parallel import build_population, set_population_hyper
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(lunar_per(), num_envs=16, hidden=(32, 32), batch_size=32,
                              buffer_capacity=16 * 64, steps_per_superstep=1, training_start=32,
                              return_window=4, use_pallas_sampler=True)
    gates = dict(train_every=[1, 2, 3], training_start=[32, 32, 96])
    runs = {}
    for graphed in (True, False):
        init, step, _ = build_population(cfg, 3, device="cuda", graphed_learner=graphed)
        assert isinstance(step, GraphedPopulation) == graphed
        if graphed:
            step.max_graphs = 0  # frame by frame
        runs[graphed] = step, set_population_hyper(init(0), **gates)
    (g_step, g), (e_step, e) = runs[True], runs[False]

    def same(a, b, where="runner"):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), where
        elif isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, where

    captured = []
    for frame in range(1, 13):
        if frame == 9:
            for r in (g, e):
                set_population_hyper(r, learning_rate=[1e-3, 2e-4, 5e-4], per_beta=0.6)
        gm, em = g_step(g)[1], e_step(e)[1]
        assert gm.loss_count.tolist() == em.loss_count.tolist(), frame
        same(ckpt._to_tree(g), ckpt._to_tree(e), f"frame {frame}")
        opt = g.train.opt_state
        assert opt.device_count.tolist() == opt.count, frame
        captured.append(g_step.learn.graph is not None)
    # member 0 at frames 2..12, member 1 at the even ones, member 2 at 6, 9 and 12
    assert g.train.updates == [11, 6, 3], g.train.updates
    # graph L: eager at frame 2, captured at 3; new tensors at 9: eager, captured at 10
    assert captured == [False, False, True, True, True, True, True, True,
                        False, True, True, True], captured


def test_vel_tol_trainer_graphs_bitwise_eager(cuda):
    """``lander_vel_tol > 0`` once made the solver read the device every
    velocity pass, which a capture refuses.  S1 ends each env's passes on
    the card, so a ``Trainer`` of such a config graphs its env step, and its
    supersteps equal an eager trainer's bitwise (the whole runner)."""
    from deep_q_learning_tpu_torch.config import lunar_jointed_per
    from deep_q_learning_tpu_torch.ops import solver_kernels
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(lunar_jointed_per(), num_envs=8, batch_size=16,
                              buffer_capacity=256, steps_per_superstep=8, training_start=32,
                              hidden=(32, 32), return_window=4, lander_vel_tol=1e-3)
    runs = {}
    solver_kernels.reset_counts()
    for graphed in (True, False):
        tr = Trainer(cfg, device="cuda", graphed=graphed).init(seed=0)
        assert tr.venv.graphed == graphed
        runs[graphed] = [tr.step() for _ in range(2)], ckpt._to_tree(tr.runner)
    assert solver_kernels.plain_calls == {"assembly_step": 0}
    assert runs[True][0] == runs[False][0]

    def same(a, b, where="runner"):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), where
        elif isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, where

    same(runs[True][1], runs[False][1])


def _same_tree(a, b, where="runner"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_a_capture_survives_unreachable_graphs(cuda):
    """A garbage collection during a capture that frees an unreachable CUDA
    graph resets it, a CUDA call the capture refuses, and the capture
    fails (seen in this file's bf16 test after earlier tests' trainers).
    ``GraphedStep`` collects before it captures and holds the collector off
    while capturing: with unreachable graphs in reference cycles and a
    collection due at nearly every allocation, its capture succeeds and
    its replays apply the call."""
    import gc

    from deep_q_learning_tpu_torch.envs.graphed import GraphedStep

    def garbage_graph():
        x = torch.zeros(1024, device="cuda")
        step = GraphedStep(lambda *_: x.add_(1), "garbage", in_place=True)
        for _ in range(2):  # the eager call, then the capture and its replay
            step(x)
        cycle = [step]
        cycle.append(cycle)  # unreachable once this returns: only a collection frees it

    y = torch.zeros(1024, device="cuda")

    def affine(*_):
        for _ in range(8):  # Python objects made during the capture
            y.mul_(2).add_(1)

    survivor = GraphedStep(affine, "survivor", in_place=True)
    threshold = gc.get_threshold()
    try:
        for _ in range(3):
            garbage_graph()
        gc.set_threshold(1)
        for _ in range(3):  # the eager call, the capture and a replay
            survivor(y)
    finally:
        gc.set_threshold(*threshold)
    assert survivor.graph is not None
    assert float(y[0]) == 2.0 ** 24 - 1  # 24 doublings and increments of 0


def _superstep_draws(g):
    """Every draw a superstep's graph takes, in its shapes and dtypes: the
    actor's uniforms, the rigid lander's reset pool and step draws at 128
    envs, CartPole's reset draws at 4096, a single learner's and an
    8-member population's sampler uniforms (float32 and float64)."""
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.envs import make_env
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    lander, _ = make_env("LunarLander-v2", True, 1000,
                         param_overrides=lunar_per().env_param_overrides())
    cartpole, _ = make_env("CartPole-v1", False, 500)
    out = [torch.rand((128,), generator=g, device="cuda")]
    out += tree_leaves(lander.reset_draws(g, 128)) + tree_leaves(lander.step_draws(g, 128))
    out += tree_leaves(cartpole.reset_draws(g, 4096))
    for shape in ((256,), (8, 256)):
        out += [torch.rand(shape, generator=g, device="cuda", dtype=dtype)
                for dtype in (torch.float32, torch.float64)]
    return out


def test_captured_draws_equal_eager_draws(cuda):
    """A superstep's graph draws from the runner's generator, registered
    with the graph (``GraphedStep(..., generator=g)``): every draw of
    :func:`_superstep_draws`, captured in one in-place graph and replayed
    5 times (the first at the capture), equals the same draws taken eagerly
    from a twin generator of the same seed, bitwise, and the generators'
    states are equal after every replay; a generator restored from the
    state after the third replay (a checkpoint's) draws what the fourth
    replay draws.  Uncaptured draws from ``g`` between replays continue
    from the replays' offset."""
    from deep_q_learning_tpu_torch.envs.graphed import GraphedStep

    g = torch.Generator(device="cuda").manual_seed(7)
    twin = torch.Generator(device="cuda").manual_seed(7)
    static = [torch.empty_like(x) for x in _superstep_draws(torch.Generator(device="cuda"))]

    def fn(*_bound):
        for buf, x in zip(static, _superstep_draws(g)):
            buf.copy_(x)

    step = GraphedStep(fn, "the draws", in_place=True, generator=g, warm_up=False)
    replays = []
    for i in range(5):
        step(static)
        replays.append([x.clone() for x in static])
        for got, want in zip(static, _superstep_draws(twin)):
            assert got.dtype == want.dtype and torch.equal(got, want), i
        assert torch.equal(g.get_state(), twin.get_state()), i
        if i == 2:
            saved = g.get_state()
        if i == 3:  # an eager draw between replays, from both
            assert torch.equal(torch.rand(33, generator=g, device="cuda"),
                               torch.rand(33, generator=twin, device="cuda"))
    assert step.graph is not None and step.nodes >= len(static)
    restored = torch.Generator(device="cuda")
    restored.set_state(saved)
    for got, want in zip(_superstep_draws(restored), replays[3]):
        assert torch.equal(got, want)


WHOLE_CASES = {  # preset: config cuts (full width, cut in depth)
    "lunar_per": dict(steps_per_superstep=16, training_start=20 * 128, use_pallas_sampler=True),
    "cartpole_vector": dict(steps_per_superstep=16, training_start=20 * 4096,
                            target_sync_every=5),
    "lunar_ref_parity": dict(num_envs=8, steps_per_superstep=16, training_start=8 * 22,
                             target_replace_episodes=2, max_steps_in_episode=24,
                             lander_engine="rigid"),
}


@pytest.mark.parametrize("preset", sorted(WHOLE_CASES))
def test_whole_superstep_graph_equals_frames_and_eager(cuda, preset, tmp_path):
    """A steady superstep as one CUDA graph (its draws, train cadence and
    target sync inside): the graphed learner as it chooses (a pattern's
    graph at its second sighting), frame by frame (``max_graphs = 0``) and
    with the eager learner, from one seed, over 6 supersteps whose warm-up
    ends in the second: runners (the generator's state, every counter
    against its mirror) and metrics bitwise equal after each, the last
    three supersteps one replay each; then the whole-graph learner's
    checkpoint restored, and 3 supersteps each, bitwise."""
    from deep_q_learning_tpu_torch import config
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(getattr(config, preset)(), **WHOLE_CASES[preset])
    whole = Trainer(cfg, device="cuda", workdir=str(tmp_path)).init(seed=0)
    frames = Trainer(cfg, device="cuda").init(seed=0)
    frames._superstep.max_graphs = 0
    eager = Trainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
    for i in range(6):
        m = whole.step()
        assert frames.step() == m == eager.step(), i
        for other in (frames, eager):
            _same_tree(ckpt._to_tree(other.runner), ckpt._to_tree(whole.runner), f"superstep {i}")
    assert whole._superstep.runs == {"frames": 3, "whole": 3}
    (graph, _), = whole._superstep.supersteps.values()
    assert graph.nodes > 0 and graph.instantiate_s is not None
    whole.save(step=whole.runner.env_step * cfg.num_envs)
    resumed = Trainer(cfg, device="cuda", workdir=str(tmp_path)).restore()
    for i in range(3):
        assert resumed.step() == whole.step(), i
        _same_tree(ckpt._to_tree(resumed.runner), ckpt._to_tree(whole.runner), f"resumed {i}")
    assert resumed._superstep.runs == {"frames": 1, "whole": 2}  # its graph anew


@pytest.mark.parametrize("eps", [0.9, 0.459, 0.01, 1 / 3])
def test_epsilon_greedy_with_a_float_equals_a_device_tensor(cuda, eps):
    """F5: CUDA divides by a Python float as a multiply by its float32
    reciprocal, by a tensor as a true division.  ``epsilon_greedy`` puts a
    float ε in a float32 tensor on the card first, so a float ε and the
    device scalar the graphed frame reads give the same actions over 2^20
    draws, at the four ε of ``artifacts/flagship_parting/division.py``."""
    from deep_q_learning_tpu_torch.algos.dqn import epsilon_greedy

    g = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 20
    u = torch.rand((n,), generator=g, device="cuda")
    q = torch.randn((n, 4), generator=g, device="cuda")
    static = torch.zeros((), device="cuda")
    static.fill_(eps)
    host, device = epsilon_greedy(None, q, eps, u=u), epsilon_greedy(None, q, static, u=u)
    assert torch.equal(host, device)
    explored = int((u < static).sum())
    assert 0 < explored < n
    # the explored draws cover every action
    assert set(host[u < static].unique().tolist()) == {0, 1, 2, 3}


def test_graphed_lunar_per_learner_equals_eager_over_512_exploring_frames(cuda):
    """F5: a ``lunar_per`` single learner at full width, graphed and with
    the eager learner (``graphed_learner=False``), from one seed: 4
    supersteps of 128 frames, ε falling from 1.0 to 0.78 under
    ``linear_step``, learning from frame 157; the metrics and the whole
    runner bitwise equal after each superstep."""
    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = lunar_per()
    assert cfg.eps_schedule == "linear_step"
    graphed = Trainer(cfg, device="cuda").init(seed=0)
    eager = Trainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
    assert isinstance(graphed._superstep, GraphedLearner)
    assert not isinstance(eager._superstep, GraphedLearner)
    for i in range(4):
        gm, em = graphed.step(), eager.step()
        assert gm == em, i
        _same_tree(ckpt._to_tree(graphed.runner), ckpt._to_tree(eager.runner), f"superstep {i}")
    assert gm.env_steps == 512 and 0.7 < gm.epsilon < 0.8 and graphed.runner.train.updates > 0


@pytest.mark.parametrize("preset", ["cartpole_vector", "acrobot_vector", "mountain_car_vector",
                                    "lunar_dddqn_vector"])
def test_graphed_uniform_learner_equals_eager_on_the_card(cuda, preset):
    """The uniform replay's learner and the classic envs' step as CUDA
    graphs (``GraphedLearner``) against ``graphed=False`` at 64 envs and a
    ring of 32 slots a row, 3 supersteps of 16 frames through the wrap, the
    learner from frame 4: metrics and the whole runner bitwise."""
    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import PRESETS
    from deep_q_learning_tpu_torch.train import Trainer
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(PRESETS[preset](), num_envs=64, buffer_capacity=64 * 32,
                              batch_size=64, steps_per_superstep=16, training_start=256,
                              max_steps_in_episode=20)
    runs = {}
    for graphed in (True, False):
        tr = Trainer(cfg, device="cuda", graphed=graphed).init(seed=0)
        assert isinstance(tr._superstep, GraphedLearner) == graphed
        runs[graphed] = [tr.step() for _ in range(3)], ckpt._to_tree(tr.runner)
    assert runs[True][0] == runs[False][0]
    assert sum(m.loss_count for m in runs[True][0]) == 45 * cfg.updates_per_step
    _same_tree(runs[True][1], runs[False][1])


def test_cuda_float64_uniforms_lie_on_the_counted_grid(cuda):
    """The card's float64 ``torch.rand`` takes curand's ``(2z + 1)·2^-54``
    rounded to a double (z on [0, 2^53)): below 0.5 each value times 2^54
    is an odd integer, above it an integer.  ``tests/
    test_torch_graphed_uniform.py`` counts the uniform replay's rank bias
    on this grid."""
    u = torch.rand((1 << 20,), generator=torch.Generator(device="cuda").manual_seed(3),
                   dtype=torch.float64, device="cuda").cpu().numpy()
    k = u * 2.0**54
    assert (k == np.floor(k)).all()
    low = k[u < 0.5]
    assert low.size > 0 and (low % 2 == 1).all()


# ----------------------------------------------------------------------- S1
def _solver_case(n, vel, pos, seed):
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.heuristic import solver_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLanderParams

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = LunarLanderParams(vel_iters=vel, pos_iters=pos)
    return solver_inputs(LunarLander(), p, n, g, envs=64, frames=60)


def _solver_leaves(out):
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    return tree_leaves(list(out))


def _same_bits(a, b) -> bool:
    """Equal dtype and every bit equal (``torch.equal`` takes -0.0 for 0.0)."""
    if a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


# (N, velocity passes, position passes): the presets' shape at 128 and 1024
# envs, gym's at 2, and ragged counts (a group of lanes, a warp, a block of
# the kernel part-full)
SOLVER_CASES = [pytest.param(128, 120, 40, id="128"), pytest.param(37, 120, 40, id="37"),
                pytest.param(1024, 120, 40, id="1024"), pytest.param(2, 180, 60, id="2-180-60"),
                pytest.param(3, 120, 40, id="3"), pytest.param(33, 120, 40, id="33"),
                pytest.param(129, 120, 40, id="129")]


@pytest.mark.parametrize("n,vel,pos", SOLVER_CASES)
def test_solver_kernel_matches_plain(cuda, n, vel, pos):
    """S1 against ``assembly_step_reference`` on the card, from a flight of
    64 landers near the ground, with and without the early exit: PyTorch's
    elementwise kernels and S1 round every operation the same way, so every
    output is bit for bit equal (``tests/test_torch_lander_solver.py``'s
    tolerances would allow more), the count of passes included."""
    from deep_q_learning_tpu_torch.envs import lander_solver as ls
    from deep_q_learning_tpu_torch.ops import solver_kernels

    *args, acc = _solver_case(n, vel, pos, seed=n)
    for tol in (0.0, 1e-3):
        kw = dict(acc=acc, vel_iters=vel, pos_iters=pos, vel_tol=tol, return_iters=True)
        solver_kernels.reset_counts()
        got = ls.assembly_step(*args, **kw)
        assert solver_kernels.launches == {"assembly_step": 1}
        want = ls.assembly_step_reference(*args, **kw)
        for i, (a, b) in enumerate(zip(_solver_leaves(got), _solver_leaves(want))):
            assert _same_bits(a, b), (tol, i)


def test_solver_kernel_is_bitwise_stable_over_100_calls(cuda):
    from deep_q_learning_tpu_torch.ops.solver_kernels import assembly_step_kernel

    *args, acc = _solver_case(1024, 120, 40, seed=7)
    first = assembly_step_kernel(*args, acc=acc, vel_iters=120, pos_iters=40)
    for _ in range(99):
        again = assembly_step_kernel(*args, acc=acc, vel_iters=120, pos_iters=40)
        for a, b in zip(_solver_leaves(first), _solver_leaves(again)):
            assert _same_bits(a, b)


def test_solver_kernel_is_bitwise_stable_over_a_graph_replay(cuda):
    from deep_q_learning_tpu_torch.ops.solver_kernels import assembly_step_kernel

    *args, acc = _solver_case(128, 120, 40, seed=5)
    call = lambda: assembly_step_kernel(*args, acc=acc, vel_iters=120, pos_iters=40)  # noqa: E731
    first = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(_solver_leaves(first), _solver_leaves(captured)):
            assert _same_bits(a, b)


def test_solver_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from deep_q_learning_tpu_torch.ops.solver_kernels import assembly_step_kernel

    *args, acc = _solver_case(16, 120, 40, seed=6)
    hull, leg1, leg2, terrain, fx, fy, torque, gravity = args
    with pytest.raises(TypeError, match="dtype"):
        assembly_step_kernel(hull, leg1, leg2, terrain, fx.double(), fy, torque, gravity, acc)
    wide = torch.zeros((terrain.shape[1], terrain.shape[0]), device=cuda).t()
    wide.copy_(terrain)
    with pytest.raises(ValueError, match="contiguous"):
        assembly_step_kernel(hull, leg1, leg2, wide, fx, fy, torque, gravity, acc)
    with pytest.raises(ValueError, match="is on cpu"):
        assembly_step_kernel(hull, leg1, leg2, terrain, fx, fy.cpu(), torque, gravity, acc)


# R1, the rigid lander's step: N of the host env, lunar_per, the population
# and lunar_per_scaled(1024), multihost_ddqn, and ragged counts (a block of
# the kernel part-full)
RIGID_CASES = [1, 37, 128, 129, 1024, 8192]


def _rigid_case(n, wind, seed):
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.measure import rigid_params

    env, params = LunarLander(), rigid_params(wind, max_steps=100)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return env, params, lander_step_inputs(env, params, n, g, envs=256, frames=150), g


@pytest.mark.parametrize("wind", [False, True], ids=["calm", "wind"])
@pytest.mark.parametrize("n", RIGID_CASES)
def test_rigid_kernel_matches_plain(cuda, n, wind):
    """R1 through ``step_env`` and ``reset_env`` against
    ``step_env_reference`` and ``reset_env_reference`` on the card, from a
    flight of landers (resets, touchdowns, crashes, rests, truncations):
    every bit of every output, one launch a call and no plain call."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
    from deep_q_learning_tpu_torch.ops import lander_kernels

    env, params, (state, action, draws), g = _rigid_case(n, wind, seed=n)
    rd = env.reset_draws(g, n)
    lander_kernels.reset_counts()
    got = env.step_env(None, state, action, params, draws)
    got_reset = env.reset_env(None, n, params, rd)
    assert lander_kernels.launches == {"rigid_step": 2}
    assert lander_kernels.plain_calls == {"rigid_step": 0}
    want = env.step_env_reference(None, state, action, params, draws)
    want_reset = env.reset_env_reference(None, n, params, rd)
    for i, (a, b) in enumerate(zip(tree_leaves([got, got_reset]),
                                   tree_leaves([want, want_reset]))):
        assert _same_bits(a, b), i


def test_rigid_kernel_is_bitwise_stable_over_a_graph_replay(cuda):
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    env, params, (state, action, draws), _ = _rigid_case(1024, True, seed=3)
    call = lambda: env.step_env(None, state, action, params, draws)  # noqa: E731
    first = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(tree_leaves(list(first)), tree_leaves(list(captured))):
            assert _same_bits(a, b)


@pytest.mark.parametrize("feature", [False, True], ids=["obs", "time_feature"])
@pytest.mark.parametrize("wind", [False, True], ids=["calm", "wind"])
@pytest.mark.parametrize("n", RIGID_CASES)
def test_rigid_vector_step_matches_its_plain_composition(cuda, n, wind, feature):
    """R1's vector step (``VectorEnv._step`` with a reset pool, the time
    feature off and on: one launch) against its plain composition on the
    card (``step_env_reference``, ``done``, ``tree_where`` and
    ``_augment``): every bit of every output."""
    from deep_q_learning_tpu_torch.envs import TimeFractionObs, VectorEnv
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
    from deep_q_learning_tpu_torch.measure import composed_rigid_lander
    from deep_q_learning_tpu_torch.ops import lander_kernels

    env, params, (state, action, draws), g = _rigid_case(n, wind, seed=n + 1)
    port_env = TimeFractionObs(env) if feature else env
    pool = port_env.reset_env(None, n, params, env.reset_draws(g, n))
    prev = torch.zeros_like(pool[0])
    lander_kernels.reset_counts()
    got = VectorEnv(port_env, n, graphed=False)._step(None, state, action, params, prev, pool,
                                                      draws)
    assert lander_kernels.launches == {"rigid_step": 1}
    assert lander_kernels.plain_calls == {"rigid_step": 0}
    want = VectorEnv(composed_rigid_lander(time_feature=feature), n, graphed=False)._step(
        None, state, action, params, prev, pool, draws)
    for i, (a, b) in enumerate(zip(tree_leaves(list(got)), tree_leaves(list(want)))):
        assert _same_bits(a, b), i


def test_rigid_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    import dataclasses

    from deep_q_learning_tpu_torch.ops.lander_kernels import rigid_step_kernel

    env, params, (state, action, draws), _ = _rigid_case(16, False, seed=6)
    with pytest.raises(TypeError, match="dtype"):
        rigid_step_kernel(state, action.long(), params, draws)
    with pytest.raises(ValueError, match="contiguous"):
        rigid_step_kernel(state, action, params, torch.zeros((2, 16), device=cuda).t())
    with pytest.raises(ValueError, match="is on cpu"):
        rigid_step_kernel(dataclasses.replace(state, vx=state.vx.cpu()), action, params, draws)


# J1, the jointed lander's frame around S1: N of lunar_jointed_per (128),
# lunar_jointed_scaled(1024) and a ragged count (37: a warp and a block of
# the kernel part-full)
JOINTED_CASES = [37, 128, 1024]


def _jointed_case(n, wind, seed):
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.measure import jointed_params

    env, params = LunarLander(), jointed_params(wind, max_steps=100)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return env, params, lander_step_inputs(env, params, n, g, envs=256, frames=150), g


@pytest.mark.parametrize("wind", [False, True], ids=["calm", "wind"])
@pytest.mark.parametrize("n", JOINTED_CASES)
def test_jointed_kernel_matches_plain(cuda, n, wind):
    """J1 through ``step_env`` and ``reset_env`` against
    ``step_env_reference`` and ``reset_env_reference`` on the card, with the
    plain solver (``assembly_step_reference``, no S1 launch) inside them and
    again with S1 inside, from a flight of jointed landers (resets,
    touchdowns, joint limits, crashes, rests, truncations): every bit of
    every output, one launch a call, no plain call and no launch of S1."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
    from deep_q_learning_tpu_torch.envs.lander_solver import assembly_step_reference
    from deep_q_learning_tpu_torch.ops import jointed_kernels, solver_kernels

    env, params, (state, action, draws), g = _jointed_case(n, wind, seed=n)
    rd = env.reset_draws(g, n)
    jointed_kernels.reset_counts()
    solver_kernels.reset_counts()
    got = env.step_env(None, state, action, params, draws)
    got_reset = env.reset_env(None, n, params, rd)
    assert jointed_kernels.launches == {"jointed_step": 2}
    assert jointed_kernels.plain_calls == {"jointed_step": 0}
    assert solver_kernels.launches == {"assembly_step": 0}
    for solve, s1 in ((assembly_step_reference, 0), (None, 2)):
        want = env.step_env_reference(None, state, action, params, draws, solve=solve)
        want_reset = env.reset_env_reference(None, n, params, rd, solve=solve)
        assert solver_kernels.launches == {"assembly_step": s1}
        for i, (a, b) in enumerate(zip(tree_leaves([got, got_reset]),
                                       tree_leaves([want, want_reset]))):
            assert _same_bits(a, b), (s1, i)


@pytest.mark.parametrize("kind", ["step", "reset"])
def test_jointed_kernel_is_bitwise_stable_over_100_calls_and_a_graph_replay(cuda, kind):
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    env, params, (state, action, draws), g = _jointed_case(1024, True, seed=3)
    rd = env.reset_draws(g, 1024)
    if kind == "step":
        call = lambda: env.step_env(None, state, action, params, draws)  # noqa: E731
    else:
        call = lambda: env.reset_env(None, 1024, params, rd)  # noqa: E731
    first = call()
    for _ in range(99):
        for a, b in zip(tree_leaves(list(first)), tree_leaves(list(call()))):
            assert _same_bits(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(tree_leaves(list(first)), tree_leaves(list(captured))):
            assert _same_bits(a, b)


def test_solver_fast_math_is_the_cards_own_on_every_float(cuda):
    """The branch-free sin/cos and reciprocal of S1's and J1's passes
    (``lander_fast_math.cuh::sincos_poly``, ``divisor_of``) against the card's
    ``sincosf`` and ``1.0f / b``: every float of their ranges, both signs,
    bitwise equal."""
    from deep_q_learning_tpu_torch.ops import solver_kernels

    assert solver_kernels.fast_math_mismatches() == {"sincos": 0, "reciprocal": 0}


def test_jointed_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from deep_q_learning_tpu_torch.ops.jointed_kernels import (
        jointed_reset_kernel,
        jointed_step_kernel,
    )

    env, params, (state, action, draws), g = _jointed_case(16, False, seed=6)
    with pytest.raises(TypeError, match="dtype"):
        jointed_step_kernel(state, action.long(), params, draws)
    with pytest.raises(ValueError, match="contiguous"):
        jointed_step_kernel(state, action, params, torch.zeros((2, 16), device=cuda).t())
    leg = dataclasses.replace(state.leg2_body, w=state.leg2_body.w.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        jointed_step_kernel(dataclasses.replace(state, leg2_body=leg), action, params, draws)
    rd = env.reset_draws(g, 16)
    with pytest.raises(ValueError, match="is on cpu"):
        jointed_reset_kernel(state.terrain, dataclasses.replace(rd, kick=rd.kick.cpu()), params)
    with pytest.raises(ValueError, match="rigid"):
        jointed_step_kernel(state, action, dataclasses.replace(params, jointed=False), draws)


# A1, C1 and M1, the classic envs' kernels: N of the host env (1),
# acrobot_vector and mountain_car_vector (128), cartpole_vector (4096), 8192
CLASSIC_CASES = [1, 128, 4096, 8192]
CLASSIC_KEYS = ["acrobot", "cartpole", "mountain_car"]


def _classic_case(key, n, seed):
    from deep_q_learning_tpu_torch.envs import make_env
    from deep_q_learning_tpu_torch.measure import classic_params, classic_step_inputs
    from deep_q_learning_tpu_torch.ops import classic_kernels

    env, _ = make_env(classic_kernels.SPECS[key].env_id)
    params = classic_params(env)
    g = torch.Generator(device="cuda").manual_seed(seed)
    state, action, _ = classic_step_inputs(env, params, n, g, envs=256, frames=150)
    return env, params, state, action, g


def _classic_vector(env, params, state, action, draws, feature, composed=False):
    from deep_q_learning_tpu_torch.envs import TimeFractionObs, VectorEnv
    from deep_q_learning_tpu_torch.measure import composed_classic

    n = action.shape[0]
    port_env = (composed_classic(env, feature) if composed
                else TimeFractionObs(env) if feature else env)
    prev = torch.zeros((n, env.obs_shape(params)[0] + feature), device="cuda")
    out_obs, out_state, tr = VectorEnv(port_env, n, graphed=False)._step(
        None, state, action, params, prev, None, None, draws)
    return out_obs, out_state, tr.next_obs, tr.reward, tr.terminated, tr.truncated


@pytest.mark.parametrize("feature", [False, True], ids=["obs", "time_feature"])
@pytest.mark.parametrize("n", CLASSIC_CASES)
@pytest.mark.parametrize("key", CLASSIC_KEYS)
def test_classic_kernel_matches_plain(cuda, key, n, feature):
    """A classic env's kernel through ``step_env`` and through
    ``VectorEnv._step`` without a pool (the resets from their draws) against
    ``step_env_reference`` and the plain composition on the card, from a
    flight (terminations, truncations, steps that go on): every bit of
    every output, one launch a call and no plain call."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves
    from deep_q_learning_tpu_torch.ops import classic_kernels

    env, params, state, action, g = _classic_case(key, n, seed=n)
    draws = env.reset_draws(g, n)
    classic_kernels.reset_counts()
    got = env.step_env(None, state, action, params)
    got_vector = _classic_vector(env, params, state, action, draws, feature)
    assert classic_kernels.launches == {k: 2 * (k == key) for k in CLASSIC_KEYS}
    assert not any(classic_kernels.plain_calls.values())
    want = env.step_env_reference(None, state, action, params)
    want_vector = _classic_vector(env, params, state, action, draws, feature, composed=True)
    assert classic_kernels.launches == {k: 2 * (k == key) for k in CLASSIC_KEYS}
    for i, (a, b) in enumerate(zip(tree_leaves([got, got_vector]),
                                   tree_leaves([want, want_vector]))):
        assert _same_bits(a, b), i


@pytest.mark.parametrize("key", CLASSIC_KEYS)
def test_classic_kernel_is_bitwise_stable_over_100_calls_and_a_graph_replay(cuda, key):
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    env, params, state, action, g = _classic_case(key, 4096, seed=3)
    draws = env.reset_draws(g, 4096)
    call = lambda: _classic_vector(env, params, state, action, draws, True)  # noqa: E731
    first = call()
    for _ in range(99):
        for a, b in zip(tree_leaves(list(first)), tree_leaves(list(call()))):
            assert _same_bits(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(tree_leaves(list(first)), tree_leaves(list(captured))):
            assert _same_bits(a, b)


def test_classic_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from deep_q_learning_tpu_torch.ops.classic_kernels import (
        classic_step_kernel,
        classic_vector_kernel,
    )

    env, params, state, action, g = _classic_case("acrobot", 16, seed=6)
    draws = env.reset_draws(g, 16)
    with pytest.raises(TypeError, match="dtype"):
        classic_step_kernel("acrobot", state, action.long(), params)
    with pytest.raises(ValueError, match="contiguous"):
        classic_vector_kernel("acrobot", state, action, params,
                              torch.zeros((4, 16), device=cuda).t())
    with pytest.raises(ValueError, match="is on cpu"):
        classic_vector_kernel("acrobot", state, action, params, draws.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        classic_step_kernel("acrobot", dataclasses.replace(state, theta2=state.theta2.cpu()),
                            action, params)
