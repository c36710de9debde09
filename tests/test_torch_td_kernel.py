"""The port's fused TD+huber op (``deep_q_learning_tpu_torch/ops/td_kernels.py``)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

Tolerances: loss and td rtol 1e-5 (float32, different summation order for
the loss); dQ vs ``jax.grad`` rtol 1e-4, as tests/test_td_kernel.py holds
the Pallas kernel to the jnp path.  The CUDA kernel itself runs only on
the GPU: tests/test_torch_cuda.py holds it to this plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.ops.td_kernels import fused_td_loss
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.ops.td_kernels import (
    FusedTDLoss,
    td_loss_fwd,
    td_loss_reference,
)

SHAPES = [(64, 4), (37, 2)]


def _inputs(b, a, seed, reward_shift=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        q_s=f(b, a),
        q_next_online=f(b, a),
        q_next_target=f(b, a),
        action=rng.integers(0, a, b).astype(np.int32),
        reward=(f(b) + reward_shift).astype(np.float32),
        bootstrap=(0.97 * (rng.random(b) > 0.3)).astype(np.float32),
        weights=(np.abs(f(b)) + 0.1).astype(np.float32),
    )


ORDER = ("q_s", "q_next_online", "q_next_target", "action", "reward", "bootstrap", "weights")


def _jax(x, double, delta=1.0):
    args = [jnp.asarray(x[k]) for k in ORDER]
    loss, td = fused_td_loss(*args, delta, double, True)
    dq = jax.grad(lambda q: fused_td_loss(q, *args[1:], delta, double, True)[0])(args[0])
    return float(loss), np.asarray(td), np.asarray(dq)


def _torch(x):
    return [torch.from_numpy(x[k].copy()) for k in ORDER]


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, double):
    x = _inputs(*shape, seed=shape[0] + int(double))
    loss_j, td_j, dq_j = _jax(x, double)
    q_s, *rest = _torch(x)
    q_s.requires_grad_(True)
    loss, td = FusedTDLoss.apply(q_s, *rest, 1.0, double)
    (dq,) = torch.autograd.grad(loss, q_s)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), td_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dq.numpy(), dq_j, rtol=1e-4, atol=1e-7)


def test_huber_clip_bounds_the_gradient():
    """With |td| > δ everywhere the gradient saturates at w·δ/B."""
    b, a = 64, 4
    x = _inputs(b, a, seed=7, reward_shift=100.0)
    loss_j, td_j, dq_j = _jax(x, True)
    q_s, *rest = _torch(x)
    q_s.requires_grad_(True)
    loss, td = FusedTDLoss.apply(q_s, *rest, 1.0, True)
    (dq,) = torch.autograd.grad(loss, q_s)
    assert float(td.abs().min()) > 1.0
    assert float(dq.abs().max()) <= float(x["weights"].max()) / b + 1e-6
    np.testing.assert_allclose(dq.numpy(), dq_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    td_kernels.reset_counts()
    x = _inputs(16, 4, seed=3)
    q_s, *rest = _torch(x)
    q_s.requires_grad_(True)
    loss, td = FusedTDLoss.apply(q_s, *rest, 1.0, True)
    loss.backward()
    assert td_kernels.launches == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    assert td_kernels.plain_calls == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    assert not td.requires_grad
    ref_loss, ref_td = td_loss_reference(*[t.detach() for t in _torch(x)], 1.0, True)
    assert torch.equal(loss.detach(), ref_loss) and torch.equal(td, ref_td)


def test_wrapper_rejects_bad_inputs():
    q_s, q_no, q_nt, action, reward, bootstrap, weights = _torch(_inputs(8, 4, seed=1))
    with pytest.raises(TypeError):
        td_loss_fwd(q_s, q_no, q_nt, action.long(), reward, bootstrap, weights)
    with pytest.raises(ValueError):
        td_loss_fwd(q_s, q_no, q_nt[:4], action, reward, bootstrap, weights)
    with pytest.raises(ValueError):
        td_loss_fwd(q_s.t().contiguous().t(), q_no, q_nt, action, reward, bootstrap, weights)
