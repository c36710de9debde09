"""The reference's pickle pair in the port (``utils/checkpoint.py``):
``params.pickle`` and ``opt_state.pickle``, read and written both ways
between the port and the JAX package.

Tolerances: Q-values from the same weights rtol 1e-5 (atol 1e-5); every
weight and optimizer-state leaf exactly equal.  The reference's own
jax-0.3 pickles are not on this host, so the Haiku conversion is held on a
synthetic 4-layer Haiku-named dict.
"""

import pickle
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_q_learning_tpu.models import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.utils.checkpoint import haiku_to_flax_params
from deep_q_learning_tpu.utils.checkpoint import load_params_pickle as jax_load_params_pickle
from deep_q_learning_tpu_torch.config import DQNConfig, lunar_per
from deep_q_learning_tpu_torch.models import QNetwork
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

REF_FORMAT = Path(__file__).resolve().parents[1] / "artifacts" / "lunar_ref_format"


def _obs(d=9, n=7, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)


def _q_port(net, obs):
    with torch.no_grad():
        return net(torch.tensor(obs)).numpy()


def _port_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order: tuples and namedtuples in order,
    dicts by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _port_leaves(t)]
    return [tree]


def test_reference_format_artifact_reads_as_in_jax():
    params, opt_state = ckpt.load_params_pickle(str(REF_FORMAT))
    jax_params, jax_opt = jax_load_params_pickle(str(REF_FORMAT))
    obs = _obs()
    net = FlaxQNetwork(num_actions=4, hidden=(256, 256), dueling=True)
    q_jax = np.asarray(net.apply(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(obs)))
    np.testing.assert_allclose(_q_port(QNetwork.from_flax_params(params), obs), q_jax,
                               rtol=1e-5, atol=1e-5)
    ours, theirs = _port_leaves(opt_state), jax.tree.leaves(jax_opt)
    assert len(ours) == len(theirs) == 17  # count, then mu and nu of 8 tensors each
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert type(opt_state[1][0]).__name__ == "ScaleByAdamState"
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) == jax.tree.structure(jax_params)


def _trained(cfg, device="cpu"):
    trainer = Trainer(cfg, device=device).init(seed=0)
    trainer.step()
    assert trainer.runner.train.updates > 0
    return trainer


@pytest.mark.parametrize("optimizer,clip", [("adam", 10.0), ("adamw", None), ("rmsprop", 1.0),
                                            ("sgd", None)])
def test_save_pickle_compat_reads_back_through_jax(optimizer, clip, tmp_path):
    """``Trainer.save_pickle_compat`` writes optax's class names: the JAX
    loader gives the state of ``optax.chain(clip_by_global_norm, <opt>)``
    (its tree structure) with the port's moments and count, and weights
    whose Q-values are the port's."""
    cfg = DQNConfig(env_id="CartPole-v1", num_envs=8, steps_per_superstep=8, batch_size=16,
                    training_start=32, buffer_capacity=256, hidden=(16, 16), dueling=True,
                    optimizer=optimizer, max_grad_norm=clip, return_window=4)
    trainer = _trained(cfg)
    trainer.save_pickle_compat(str(tmp_path))
    params, opt_state = jax_load_params_pickle(str(tmp_path))
    net = FlaxQNetwork(num_actions=2, hidden=(16, 16), dueling=True)
    obs = _obs(d=4)
    np.testing.assert_allclose(
        np.asarray(net.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(obs))),
        _q_port(trainer.runner.train.online, obs), rtol=1e-5, atol=1e-5)
    ctor = {"adam": optax.adam, "adamw": optax.adamw, "rmsprop": optax.rmsprop,
            "sgd": optax.sgd}[optimizer](1e-3)
    chain = optax.chain(optax.clip_by_global_norm(clip), ctor) if clip else ctor
    assert jax.tree.structure(opt_state) == jax.tree.structure(chain.init(params))
    state = trainer.runner.train.opt_state
    moments = {"adam": [state.mu, state.nu], "adamw": [state.mu, state.nu],
               "rmsprop": [state.nu], "sgd": []}[optimizer]
    leaves = jax.tree.leaves(opt_state)
    if optimizer.startswith("adam"):
        assert int(leaves.pop(0)) == state.count == trainer.runner.train.updates
    assert len(leaves) == 8 * len(moments)
    # the port's moments, as flax dicts of the same layers
    expected = []
    for tensors in moments:
        tree = ckpt._flax_tree(trainer.runner.train.online, tensors)
        expected += jax.tree.leaves(tree)
    for a, b in zip(leaves, expected):
        np.testing.assert_array_equal(a, b)
    # and the port reads its own pair back, leaf for leaf
    p2, o2 = ckpt.load_params_pickle(str(tmp_path))
    for a, b in zip(_port_leaves(o2), jax.tree.leaves(opt_state)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(p2) == jax.tree.structure(params)


def test_haiku_to_torch_matches_jax_conversion():
    """A synthetic reference ``Model`` (``model/~/linear``..``linear_3``,
    the value head before the advantage head): ``haiku_to_torch`` gives the
    Q-values of ``haiku_to_flax_params`` + the flax ``QNetwork``."""
    rng = np.random.default_rng(3)
    w = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    hk = {"model/~/linear": {"w": w(9, 32), "b": w(32)},
          "model/~/linear_1": {"w": w(32, 64), "b": w(64)},
          "model/~/linear_2": {"w": w(64, 1), "b": w(1)},
          "model/~/linear_3": {"w": w(64, 4), "b": w(4)}}
    obs = _obs()
    net = FlaxQNetwork(num_actions=4, hidden=(32, 64), dueling=True)
    q_jax = np.asarray(net.apply(haiku_to_flax_params(hk, hidden_layers=2), jnp.asarray(obs)))
    np.testing.assert_allclose(_q_port(ckpt.haiku_to_torch(hk, hidden_layers=2), obs), q_jax,
                               rtol=1e-5, atol=1e-5)


def _reconstruct_device_array(fun, args, arr_state, aval_state):  # stands in for jax 0.3's
    raise AssertionError("never called: pickled under jax 0.3's name")


class _FlatMap(dict):  # stands in for haiku's
    def __reduce__(self):
        return _FlatMap, (dict(self),)


class _DeviceArray:  # pickles as jax 0.3's DeviceArray did
    def __init__(self, value):
        self.value = value

    def __reduce__(self):
        fun, args, arr_state = self.value.__reduce__()
        return _reconstruct_device_array, (fun, args, arr_state, {"weak_type": False})


class _LegacyNames(pickle._Pickler):
    NAMES = {_reconstruct_device_array: ("jax._src.device_array", "reconstruct_device_array"),
             _FlatMap: ("haiku._src.data_structures", "FlatMap")}

    def save_global(self, obj, name=None):
        if obj in self.NAMES:
            for part in self.NAMES[obj]:
                self.save(part)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)

    dispatch = {**pickle._Pickler.dispatch, types.FunctionType: save_global}


def test_legacy_device_arrays_and_refusals(tmp_path):
    """A jax-0.3 ``DeviceArray`` inside a haiku ``FlatMap`` reads as numpy in
    a dict, as the JAX loader reads it; a class outside the reference's
    stacks is refused."""
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    with open(tmp_path / "params.pickle", "wb") as f:
        _LegacyNames(f, protocol=4).dump(_FlatMap({"model/~/linear": _FlatMap(w=_DeviceArray(value))}))
    (tmp_path / "opt_state.pickle").write_bytes(pickle.dumps(((), {}), protocol=4))
    params, opt_state = ckpt.load_params_pickle(str(tmp_path))
    jax_params, _ = jax_load_params_pickle(str(tmp_path))
    assert type(params) is dict and type(params["model/~/linear"]) is dict
    np.testing.assert_array_equal(params["model/~/linear"]["w"], value)
    np.testing.assert_array_equal(jax_params["model/~/linear"]["w"], value)
    assert opt_state == ((), {})
    (tmp_path / "opt_state.pickle").write_bytes(pickle.dumps(lunar_per(), protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="refusing to load .*DQNConfig"):
        ckpt.load_params_pickle(str(tmp_path))
