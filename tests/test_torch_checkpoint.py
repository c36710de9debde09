"""Full-runner checkpoints of the port (``utils/checkpoint.py``,
``Trainer.save``/``restore``), on the CPU at a tiny size.

A run resumed from a checkpoint must continue bitwise: two fresh trainers
restored from the same file, and the run that was never interrupted, give
identical weights, optimizer state, replay, generator and counters (as
``tests/test_trainer.py::test_checkpoint_resume_bitwise`` holds the JAX
package)."""

import dataclasses
import json
import os

import pytest
import torch

from deep_q_learning_tpu_torch.config import lunar_per_scaled
from deep_q_learning_tpu_torch.train import Trainer
from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

CFG = dataclasses.replace(
    lunar_per_scaled(), num_envs=8, batch_size=16, buffer_capacity=8 * 32,
    steps_per_superstep=8, training_start=32, hidden=(16, 16), return_window=4,
    use_pallas_sampler=True,
)


def _state(trainer):
    """Everything a superstep may change, as comparable CPU values."""
    return ckpt._to_tree(trainer.runner)


def _assert_same(a, b, where="runner"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_resume_is_bitwise(tmp_path):
    wd = str(tmp_path / "ckpt")
    tr = Trainer(CFG, device="cpu", workdir=wd).init(seed=3)
    for _ in range(2):
        tr.step()
    assert tr.runner.train.updates > 0
    path = tr.save(step=2)
    assert os.path.basename(path) == "2.pt" and ckpt.latest_step(wd) == 2
    assert json.load(open(os.path.join(wd, "config.json")))["num_envs"] == 8

    def continue_from_ckpt():
        t2 = Trainer(CFG, device="cpu", workdir=wd).init(seed=99)  # restore overwrites it
        t2.restore(step=2)
        assert t2.runner.env_step == 16 and t2.runner.replay.total_adds == 16
        metrics = [t2.step() for _ in range(2)]
        return metrics, _state(t2)

    m1, s1 = continue_from_ckpt()
    m2, s2 = continue_from_ckpt()
    m0 = [tr.step() for _ in range(2)]  # the run that was never interrupted
    assert m1 == m2 == m0
    _assert_same(s1, s2)
    _assert_same(s1, _state(tr))
    assert m1[-1].env_steps == 32 and m1[-1].loss_count > 0


def test_restore_without_runner_and_latest(tmp_path):
    wd = str(tmp_path / "ckpt")
    assert ckpt.latest_step(wd) is None
    tr = Trainer(CFG, device="cpu", workdir=wd).init(seed=0)
    tr.step()
    tr.save(step=64)
    tr.step()
    tr.save(step=128)
    open(os.path.join(wd, "7.pt.tmp-1"), "w").close()  # a write cut short
    open(os.path.join(wd, "notes.pt"), "w").close()
    assert ckpt.latest_step(wd) == 128
    fresh = Trainer(CFG, device="cpu", workdir=wd).restore()  # no init(): latest
    assert fresh.runner.env_step == 16
    earlier = Trainer(CFG, device="cpu", workdir=wd).restore(step=64)
    assert earlier.runner.env_step == 8
    with pytest.raises(FileNotFoundError):
        Trainer(CFG, device="cpu", workdir=str(tmp_path / "empty")).restore()


def test_config_mismatch_is_rejected(tmp_path):
    wd = str(tmp_path / "ckpt")
    tr = Trainer(CFG, device="cpu", workdir=wd).init()
    tr.save(step=0)
    other = dataclasses.replace(CFG, hidden=(32, 16))
    with pytest.raises(ValueError, match="config mismatch.*hidden"):
        Trainer(other, device="cpu", workdir=wd).restore()
    # runtime hyperparameters may differ
    Trainer(dataclasses.replace(CFG, learning_rate=1e-3), device="cpu", workdir=wd).restore()
    # without config.json the tree walk still refuses a shape it cannot hold
    os.remove(os.path.join(wd, "config.json"))
    with pytest.raises(ValueError, match="return_window"):
        Trainer(dataclasses.replace(CFG, return_window=6), device="cpu", workdir=wd).restore()


def test_save_needs_a_workdir():
    tr = Trainer(CFG, device="cpu").init()
    with pytest.raises(ValueError, match="workdir"):
        tr.save(step=0)


def test_time_limited_train_keeps_the_newest_checkpoint_and_resumes(tmp_path):
    """``train(max_seconds=0)`` stops at the first log point with a
    checkpoint; with ``keep_newest`` only the newest file stays; a restored
    trainer goes on bitwise as the run that was not cut."""
    wd = str(tmp_path / "run")
    tr = Trainer(CFG, device="cpu", workdir=wd).init(seed=2)
    first = tr.train(max_env_steps=10**6, log_every=2, checkpoint_every=1, verbose=False,
                     max_seconds=0.0, keep_newest=True)
    assert not first.solved and first.env_steps == 2 * 8 * 8
    tr.train(max_env_steps=10**6, log_every=2, checkpoint_every=1, verbose=False,
             max_seconds=0.0, keep_newest=True)
    assert sorted(os.listdir(wd)) == ["256.pt", "config.json"]
    resumed = Trainer(CFG, device="cpu", workdir=wd).restore()
    _assert_same(_state(resumed), _state(tr))
    assert resumed.step() == tr.step()


def test_checkpoints_accumulate_without_keep_newest(tmp_path):
    wd = str(tmp_path / "run")
    tr = Trainer(CFG, device="cpu", workdir=wd).init(seed=2)
    tr.train(max_env_steps=3 * 8 * 8, log_every=1, checkpoint_every=1, verbose=False)
    assert sorted(os.listdir(wd)) == ["128.pt", "192.pt", "64.pt", "config.json"]


def test_resumed_train_continues_the_superstep_count(tmp_path):
    """A run restored from its checkpoint counts supersteps on from the
    runner's: the log points, the evaluations (and their seeds) and the
    history's ``superstep`` go on where the cut call left them."""
    wd = str(tmp_path / "run")
    kw = dict(max_env_steps=10**6, log_every=2, checkpoint_every=2, eval_every=4,
              verbose=False, max_seconds=0.0)
    first = Trainer(CFG, device="cpu", workdir=wd).init(seed=2).train(**kw)
    assert [(h["superstep"], "eval_mean" in h) for h in first.history] == [(2, False)]
    resumed = Trainer(CFG, device="cpu", workdir=wd).restore()
    second = resumed.train(**kw)
    assert [(h["superstep"], h["env_steps"], "eval_mean" in h) for h in second.history] == [
        (4, 4 * 8 * 8, True)]
    whole = Trainer(CFG, device="cpu").init(seed=2)
    for _ in range(4):
        whole.step()
    want = whole.evaluate(seed=4)
    assert second.history[0]["eval_mean"] == pytest.approx(float(want.returns.mean()), abs=0)
