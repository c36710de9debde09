"""The port's fused TD+huber op (``deep_q_learning_tpu_torch/ops/td_kernels.py``)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

``FusedTDLoss`` takes the learner's whole ``q_both = Q([s; s'])`` (2B, A)
and its gradient covers all of it, zero on the stopped ``s'`` half; the
loss function around it is held to ``build_pallas_loss_fn`` through the
network's parameters.  Batches of 300 and 512 rows cover the shapes that
take several blocks of the CUDA forward kernel.

Tolerances: loss and td rtol 1e-5 (float32, different summation order for
the loss); dQ and parameter gradients vs ``jax.grad`` rtol 1e-4, as
tests/test_td_kernel.py holds the Pallas kernel to the jnp path.  The CUDA
kernel itself runs only on the GPU: tests/test_torch_cuda.py holds it to
this plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.ops.td_kernels import build_pallas_loss_fn, fused_td_loss
from deep_q_learning_tpu.replay.nstep import LearnBatch as JaxBatch
from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
from deep_q_learning_tpu_torch.config import lunar_per
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.ops.td_kernels import (
    FusedTDLoss,
    build_fused_loss_fn,
    td_loss_backward_reference,
    td_loss_fwd,
    td_loss_reference,
)
from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

SHAPES = [(64, 4), (37, 2), (300, 4), (512, 4)]


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


def _fused(x, double, delta=1.0):
    """``FusedTDLoss`` on ``q_both = [q_s; q_next_online]``: ``(loss, td,
    dq_both)``, the gradient taken in ``q_both``."""
    q_s, q_no, *rest = _torch(x)
    q_both = torch.cat([q_s, q_no]).requires_grad_(True)
    loss, td = FusedTDLoss.apply(q_both, q_s.shape[0], *rest, delta, double)
    (dq,) = torch.autograd.grad(loss, q_both)
    return loss, td, dq


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, double):
    b, _ = shape
    x = _inputs(*shape, seed=shape[0] + int(double))
    loss_j, td_j, dq_j = _jax(x, double)
    loss, td, dq = _fused(x, double)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), td_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dq[:b].numpy(), dq_j, rtol=1e-4, atol=1e-7)
    assert not dq[b:].any(), "the s' half is stopped"


def test_huber_clip_bounds_the_gradient():
    """With |td| > δ everywhere the gradient saturates at w·δ/B."""
    b, a = 64, 4
    x = _inputs(b, a, seed=7, reward_shift=100.0)
    loss_j, td_j, dq_j = _jax(x, True)
    loss, td, dq = _fused(x, True)
    assert float(td.abs().min()) > 1.0
    assert float(dq.abs().max()) <= float(x["weights"].max()) / b + 1e-6
    np.testing.assert_allclose(dq[:b].numpy(), dq_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    td_kernels.reset_counts()
    x = _inputs(16, 4, seed=3)
    loss, td, _ = _fused(x, True)
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


@pytest.mark.parametrize("b", [64, 300])
def test_fused_loss_fn_matches_pallas_loss_fn(b):
    """The loss function on ``q_both`` against ``build_pallas_loss_fn`` in
    interpret mode, through a dueling network: loss, td and every
    parameter's gradient."""
    rng = np.random.default_rng(b)
    obs_dim, a, hidden = 9, 4, (16, 16)
    batch = dict(
        obs=rng.standard_normal((b, obs_dim)).astype(np.float32),
        action=rng.integers(0, a, b).astype(np.int32),
        reward=(3.0 * rng.standard_normal(b)).astype(np.float32),
        next_obs=rng.standard_normal((b, obs_dim)).astype(np.float32),
        bootstrap=(0.97 * (rng.random(b) > 0.2)).astype(np.float32),
    )
    weights = (rng.random(b) + 0.1).astype(np.float32)
    flax_net = FlaxQNetwork(num_actions=a, hidden=hidden, dueling=True)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    target = flax_net.init(jax.random.PRNGKey(1), jnp.zeros((1, obs_dim)))
    jax_loss_fn = build_pallas_loss_fn(flax_net.apply, True, 1.0, interpret=True)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    (loss_j, td_j), grads_j = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        params, target, jb, jnp.asarray(weights))

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    online = QNetwork.from_flax_params(to_np(params))
    target_t = QNetwork.from_flax_params(to_np(target))
    loss, td = build_fused_loss_fn(True, 1.0)(
        online, target_t, LearnBatch(**{k: torch.tensor(v) for k, v in batch.items()}),
        torch.tensor(weights))
    grads = torch.autograd.grad(loss, list(online.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_j), rtol=1e-5, atol=1e-6)
    grad_of = {id(p): gr for p, gr in zip(online.parameters(), grads)}
    g = grads_j["params"]
    for name, layer in online.flax_layers():
        np.testing.assert_allclose(
            grad_of[id(layer.weight)].numpy().T, np.asarray(g[name]["kernel"]), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(
            grad_of[id(layer.bias)].numpy(), np.asarray(g[name]["bias"]), rtol=1e-4, atol=1e-7)


def test_backward_reference_out_rows_are_zero_past_the_batch():
    x = _inputs(37, 4, seed=5)
    _, td = td_loss_reference(*_torch(x), 1.0, True)
    action, weights = torch.from_numpy(x["action"]), torch.from_numpy(x["weights"])
    g = torch.tensor(0.7)
    dq = td_loss_backward_reference(td, action, weights, g, 4, 1.0)
    dq_both = td_loss_backward_reference(td, action, weights, g, 4, 1.0, out_rows=74)
    assert dq.shape == (37, 4) and dq_both.shape == (74, 4)
    assert torch.equal(dq_both[:37], dq) and not dq_both[37:].any()
    assert int((dq != 0).sum()) == 37  # one taken action a row
    with pytest.raises(ValueError):
        td_kernels.td_loss_bwd(td, action, weights, g, 4, 1.0, out_rows=36)


def test_cpu_learner_update_runs_no_slice_backward():
    """One learner update with the fused loss: autograd hands the kernel's
    (2B, A) gradient straight to the network, with no slice backward."""
    b = 32
    cfg = dataclasses.replace(lunar_per(), batch_size=b, hidden=(16, 16))
    assert cfg.use_pallas
    opt = make_optimizer(cfg)
    ts = init_train_state(QNetwork(9, 4, hidden=cfg.hidden, generator=torch.Generator().manual_seed(0)), opt)
    g = torch.Generator().manual_seed(0)
    batch = LearnBatch(
        obs=torch.randn((b, 9), generator=g),
        action=torch.randint(0, 4, (b,), generator=g, dtype=torch.int32),
        reward=torch.randn((b,), generator=g), next_obs=torch.randn((b, 9), generator=g),
        bootstrap=torch.full((b,), 0.97),
    )
    weights = torch.rand((b,), generator=g) + 0.1
    update = build_update_step(opt, cfg)
    update(ts, batch, weights)
    td_kernels.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        update(ts, batch, weights)
    ops = {e.key: e.count for e in prof.key_averages()}
    assert td_kernels.plain_calls == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    assert ops.get("aten::addmm", 0) > 0, "the profiler saw the update"
    assert "aten::slice_backward" not in ops, ops
