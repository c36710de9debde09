"""The port's ``QNetwork`` against the flax module, and flax's init.

Tolerance: rtol 1e-5 (float32 matmuls summed in different orders).

``compute_dtype="bfloat16"`` against flax's ``QNetwork(compute_dtype=
bfloat16)`` from the same params: the trunk's bf16 features bitwise equal
(both round each product to bf16 once, from a float32 sum, then add the
bias in bf16), and Q (float32) within 1e-5 of max |Q| (measured 5e-7: the
float32 heads sum in another order).  For scale: adding the bias before
the product's rounding, as ``F.linear`` does, moves Q by 1.7e-3 of max |Q|,
and the f32 network is 2e-3..6e-3 of it away from the bf16 one.  The f32
path is held bitwise to its ``nn.Linear``/``baddbmm`` composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu_torch.models.networks import MemberQNetwork, QNetwork


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dueling", [True, False])
def test_forward_matches_flax(dueling):
    obs_dim, num_actions, hidden = 9, 4, (32, 16)
    flax_net = FlaxQNetwork(num_actions=num_actions, hidden=hidden, dueling=dueling)
    params = flax_net.init(jax.random.PRNGKey(4), jnp.zeros((1, obs_dim)))
    # non-zero biases, so a bias mix-up would show
    params = jax.tree.map(lambda p: p + 0.05 * jnp.arange(p.size).reshape(p.shape) / p.size, params)
    x = np.random.default_rng(0).standard_normal((64, obs_dim)).astype(np.float32)
    q_ref = np.asarray(flax_net.apply(params, jnp.asarray(x)))

    net = QNetwork.from_flax_params(_to_numpy(params))
    assert (net.obs_dim, net.num_actions, net.hidden, net.dueling) == (
        obs_dim, num_actions, hidden, dueling,
    )
    with torch.no_grad():
        q = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-6)


def test_init_is_flax_lecun_normal():
    """Kernels: normal truncated at 2 std, scaled to variance 1/fan_in;
    biases zero.  Same seed, same weights."""
    fan_in, width = 256, 512
    net = QNetwork(fan_in, 4, hidden=(width,), dueling=True,
                   generator=torch.Generator().manual_seed(0))
    w = net.trunk[0].weight.detach().numpy()
    assert w.shape == (width, fan_in)
    np.testing.assert_allclose(w.std(), np.sqrt(1.0 / fan_in), rtol=0.02)
    assert np.abs(w).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-7
    assert abs(float(np.mean(w))) < 1e-3
    for _, layer in net.flax_layers():
        assert torch.count_nonzero(layer.bias) == 0

    # the flax module's kernel has the same spread
    flax_w = np.asarray(
        FlaxQNetwork(num_actions=4, hidden=(width,)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, fan_in))
        )["params"]["trunk_0"]["kernel"]
    )
    np.testing.assert_allclose(w.std(), flax_w.std(), rtol=0.02)

    again = QNetwork(fan_in, 4, hidden=(width,), generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.trunk[0].weight, net.trunk[0].weight)


def _bumped_params(net, seed, x_dim):
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, x_dim)))
    return jax.tree.map(lambda p: p + 0.05 * jnp.arange(p.size).reshape(p.shape) / p.size, params)


@pytest.mark.parametrize("dueling,hidden", [(True, (32, 16)), (False, (32, 16)),
                                            (True, (256, 256))])
def test_bf16_forward_matches_flax(dueling, hidden):
    obs_dim, num_actions = 9, 4
    flax_net = FlaxQNetwork(num_actions=num_actions, hidden=hidden, dueling=dueling,
                            compute_dtype=jnp.bfloat16)
    params = _bumped_params(flax_net, 4, obs_dim)
    x = np.random.default_rng(1).standard_normal((512, obs_dim)).astype(np.float32)
    q_ref, f_ref = flax_net.apply(params, jnp.asarray(x), return_features=True)

    net = QNetwork.from_flax_params(_to_numpy(params), compute_dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        features = net.features(torch.from_numpy(x))
        q = net(torch.from_numpy(x))
    assert features.dtype == torch.bfloat16 and q.dtype == torch.float32
    np.testing.assert_array_equal(features.float().numpy(), np.asarray(f_ref))
    scale = float(np.abs(np.asarray(q_ref)).max())
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=0, atol=1e-5 * scale)


def test_bf16_member_network_matches_flax_vmapped():
    members, obs_dim, num_actions, hidden = 3, 9, 4, (32, 16)
    flax_net = FlaxQNetwork(num_actions=num_actions, hidden=hidden, compute_dtype=jnp.bfloat16)
    stacked = jax.tree.map(lambda *p: jnp.stack(p),
                           *[_bumped_params(flax_net, s, obs_dim) for s in range(members)])
    x = np.random.default_rng(2).standard_normal((members, 64, obs_dim)).astype(np.float32)
    q_ref = np.asarray(jax.vmap(flax_net.apply)(stacked, jnp.asarray(x)))

    net = MemberQNetwork.from_flax_params(_to_numpy(stacked), compute_dtype="bfloat16")
    with torch.no_grad():
        features = net.features(torch.from_numpy(x))
        q = net(torch.from_numpy(x))
    assert features.dtype == torch.bfloat16 and q.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=0, atol=1e-5 * np.abs(q_ref).max())


def test_f32_path_is_the_plain_composition():
    """float32 Q is bitwise ``relu(nn.Linear)`` layers and the dueling head
    (``baddbmm`` for members), as before ``compute_dtype`` existed."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 9)).astype(np.float32))
    net = QNetwork(9, 4, hidden=(32, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h = x
        for layer in net.trunk:
            h = torch.relu(torch.nn.functional.linear(h, layer.weight, layer.bias))
        adv = net.advantage(h)
        assert torch.equal(net(x), net.value(h) + adv - adv.mean(dim=-1, keepdim=True))
    members = MemberQNetwork(2, 9, 4, hidden=(32,), dueling=False,
                             generators=[torch.Generator().manual_seed(s) for s in (0, 1)])
    xm = torch.stack([x, x + 1.0])
    with torch.no_grad():
        layer = members.trunk[0]
        h = torch.relu(torch.baddbmm(layer.bias[:, None, :], xm, layer.weight.transpose(1, 2)))
        q = torch.baddbmm(members.q.bias[:, None, :], h, members.q.weight.transpose(1, 2))
        assert torch.equal(members(xm), q)


@pytest.mark.parametrize("name", ["float16", "bf16", "float64"])
def test_unknown_compute_dtype_is_refused(name):
    with pytest.raises(ValueError, match="compute_dtype"):
        QNetwork(9, 4, hidden=(8,), compute_dtype=name)
    with pytest.raises(ValueError, match="compute_dtype"):
        MemberQNetwork(2, 9, 4, hidden=(8,), compute_dtype=name)
