"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: without a GPU every test here skips.  This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit; ``--noconftest`` skips tests/conftest.py, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: loss and td rtol 1e-5, atol 1e-6 (the kernel reduces the loss
in another order); dQ rtol 1e-5, atol 1e-7.  PER slot sampling: exact on
dyadic priorities (every sum exact in any order); on random priorities a
slot may differ only where every prefix between the two slots lies within
8 float32 ulps of the row total of the plain version's draw."""

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


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("shape", [(256, 4), (1024, 4), (37, 2)])
def test_td_kernel_matches_plain(cuda, shape, double):
    b, a = shape
    args = _inputs(b, a, seed=b + a, device=cuda)
    loss, td = td_loss_fwd(*args, 1.0, double)
    ref_loss, ref_td = td_loss_reference(*args, 1.0, double)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(td, ref_td, rtol=1e-5, atol=1e-6)
    g = torch.tensor(0.7, device=cuda)
    dq = td_loss_bwd(td, args[3], args[6], g, a, 1.0)
    torch.testing.assert_close(
        dq, td_loss_backward_reference(td, args[3], args[6], g, a, 1.0), rtol=1e-5, atol=1e-7
    )
    torch.cuda.synchronize()


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
    u = rng.random(b)
    u[2:5] = (0.0, 1.5, 1.0)  # no mass; past the total; the total itself
    return (
        torch.tensor(p, dtype=torch.float32, device=device),
        torch.tensor(env, dtype=torch.int64, device=device),
        torch.tensor(u, dtype=torch.float32, device=device),
    )


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,c,b", [(1024, 512, 1024), (128, 4096, 256), (5, 200, 37)])
def test_slot_kernel_matches_plain(cuda, n, c, b, dyadic):
    p, env, u = _slot_inputs(n, c, b, seed=n + c + b, dyadic=dyadic, device=cuda)
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
        return
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
    assert (got != want).mean() < 0.01
