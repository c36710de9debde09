"""The port's ``QNetwork`` against the flax module, and flax's init.

Tolerance: rtol 1e-5 (float32 matmuls summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu_torch.models.networks import QNetwork


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
