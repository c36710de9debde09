"""The reference-format scripts of the port on the CPU:
``examples/train_lunar_lander.py`` and ``examples/evaluate_checkpoint.py``.

* ``train_lunar_lander`` at a tiny cut writes the curves, the pickle pair
  and the rollouts; the pair loads through the JAX package's
  ``load_params_pickle`` and gives the JAX ``QNetwork``'s Q-values within
  float32 rounding (below) of the trained network's, with the optimizer's
  count equal to the updates.
* ``evaluate_checkpoint`` reads the pair the JAX package wrote
  (``artifacts/lunar_ref_format``) with JAX's Q-values (within float32
  rounding), the pair the port wrote (its greedy returns equal to the
  trained network's own evaluation, bitwise), and a port run directory.

Q-values are held to the float32 error of the products, not to a flat
tolerance: XLA's CPU dot and PyTorch's CPU matmul sum a 256-wide product in
orders that depend on the host (its vector width and the libraries' kernels),
and the dueling head subtracts Q-values of ~500, so a flat rtol/atol of 1e-5
sits at the size of that rounding and fails on some hosts (on an AMD EPYC
with AVX512, 2 of 1,024 values by 8.9e-5 at |Q| ~ 500-580).  A float64
forward of the same weights gives each Q-value's exact value; JAX's float32
result is that far from it (its conditioning, the largest gap over the
values, as the solver's tests measure theirs), and the port's must lie
within 4x that gap plus 4 float32 ulps of |Q| on every value.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.models.networks import QNetwork as FlaxQNetwork
from deep_q_learning_tpu.utils.checkpoint import load_params_pickle as jax_load_params_pickle
from deep_q_learning_tpu_torch.examples import evaluate_checkpoint, train_lunar_lander

REPO = Path(__file__).resolve().parents[1]
REF_FORMAT = REPO / "artifacts" / "lunar_ref_format"
CUT = ["num_envs=8", "steps_per_superstep=16", "hidden=16,16", "batch_size=16",
       "buffer_capacity=512", "training_start=64", "max_steps_in_episode=60",
       "return_window=4"]
SETS = [a for kv in CUT for a in ("--set", kv)]
# the port's Q-values lie within CONDITIONING x JAX's float32 gap from a
# float64 forward, plus ULPS float32 ulps of |Q| (the module docstring)
CONDITIONING, ULPS = 4.0, 4


def _obs(n, dim=9, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _jax_q(directory, obs, hidden):
    params, _ = jax_load_params_pickle(str(directory))
    net = FlaxQNetwork(num_actions=4, hidden=hidden, dueling=True)
    return np.asarray(net.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(obs)))


def _q64(directory, obs, hidden):
    """The dueling network's Q-values from the pair's weights, in float64."""
    params, _ = jax_load_params_pickle(str(directory))
    p = jax.tree.map(lambda x: np.asarray(x, np.float64), params["params"])

    def dense(x, name):
        return x @ p[name]["kernel"] + p[name]["bias"]

    x = obs.astype(np.float64)
    for i in range(len(hidden)):
        x = np.maximum(dense(x, f"trunk_{i}"), 0.0)
    adv = dense(x, "advantage")
    return dense(x, "value") + adv - adv.mean(-1, keepdims=True)


def _assert_q_close(got, jax_q, q64):
    """``got`` within CONDITIONING x JAX's float32 gap to the float64
    Q-values, plus ULPS float32 ulps of |Q|, on every value."""
    conditioning = float(np.abs(jax_q - q64).max())
    ulp = np.spacing(np.abs(q64).astype(np.float32)).astype(np.float64)
    gap = np.abs(got.astype(np.float64) - q64)
    bound = CONDITIONING * conditioning + ULPS * ulp
    far = gap > bound
    assert not far.any(), (int(far.sum()), float(gap.max()), conditioning,
                           np.argwhere(far)[:5].tolist())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("lunar")
    trainer = train_lunar_lander.main([
        "--device", "cpu", "--steps", "384", "--log-every", "1", "--rollouts", "1",
        "--workdir", str(workdir), "--seed", "3", *SETS])
    return trainer, workdir


def test_train_writes_the_pair_the_jax_package_reads(trained):
    trainer, workdir = trained
    assert trainer.history[-1]["env_steps"] == 384  # 3 supersteps of 128
    updates = trainer.runner.train.updates
    assert updates == 3 * 16 - 7  # from vector step 8: 64 stored over 8 envs
    for name in ("curves.png", "rollout_0.npz", "rollout_0.png", "ref_format/params.pickle",
                 "ref_format/opt_state.pickle"):
        assert (workdir / name).is_file(), name
    rollout = np.load(workdir / "rollout_0.npz")
    assert rollout["obs"].shape == (int(rollout["length"]), 9)

    obs = _obs(256, seed=1)
    with torch.no_grad():
        want = trainer.runner.train.online(torch.from_numpy(obs)).numpy()
    ref = workdir / "ref_format"
    _assert_q_close(want, _jax_q(ref, obs, (16, 16)), _q64(ref, obs, (16, 16)))
    _, opt_state = jax_load_params_pickle(str(workdir / "ref_format"))
    counts = {int(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if jax.tree_util.keystr(path).endswith(".count")}
    assert counts == {updates}


def test_evaluate_reads_the_jax_written_pair_with_jax_q_values(capsys, tmp_path):
    from deep_q_learning_tpu_torch.config import lunar_per

    net = evaluate_checkpoint.load_network(str(REF_FORMAT), lunar_per(), torch.device("cpu"))
    obs = _obs(256, seed=2)
    with torch.no_grad():
        got = net(torch.from_numpy(obs)).numpy()
    _assert_q_close(got, _jax_q(REF_FORMAT, obs, (256, 256)), _q64(REF_FORMAT, obs, (256, 256)))

    out = evaluate_checkpoint.main(["--ckpt", str(REF_FORMAT), "--device", "cpu",
                                    "--episodes", "3", "--out", str(tmp_path)])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("eval over 3 greedy episodes: mean=") and "lengths" in line
    assert len(out["returns"]) == 3 and np.isfinite(out["returns"]).all()
    assert [os.path.basename(f) for f in out["figures"]] == [
        f"eval_rollout_{i}.png" for i in range(3)]


def test_evaluate_reads_the_port_pair_and_run_directory(trained, tmp_path):
    from deep_q_learning_tpu_torch.algos import build_evaluator
    from deep_q_learning_tpu_torch.envs import VectorEnv

    trainer, workdir = trained
    args = ["--device", "cpu", "--episodes", "4", "--out", str(tmp_path), *SETS]
    got = evaluate_checkpoint.main(["--ckpt", str(workdir / "ref_format"), *args])
    ev = build_evaluator(VectorEnv(trainer.env, 4), trainer.env_params,
                         trainer.env_params.max_steps_in_episode)(
        trainer.runner.train.online, torch.Generator().manual_seed(0))
    assert got["returns"] == ev.returns.tolist() and got["lengths"] == ev.lengths.tolist()

    # a run directory: the trainer's checkpoint, read through Trainer.restore
    trainer.save(step=384)
    assert json.loads((workdir / "config.json").read_text())["hidden"] == [16, 16]
    assert evaluate_checkpoint.main(["--ckpt", str(workdir), *args]) == got


def test_train_refuses_the_aot_cache(tmp_path):
    with pytest.raises(SystemExit, match="not ported"):
        train_lunar_lander.main(["--device", "cpu", "--aot-cache", str(tmp_path)])
