"""A tiny ``lunar_per_scaled`` with the PER slot-sampling kernel switched on
(``use_pallas_sampler=True``) through the port's ``Trainer`` on the CPU:
the update cadence ``train_every=4``, one sampler call and one TD call per
update, finite losses, and the decaying max priority
(``per_max_decay=0.999``) on every update."""

import dataclasses

import numpy as np
import torch

from deep_q_learning_tpu_torch.config import lunar_per_scaled
from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels
from deep_q_learning_tpu_torch.train import Trainer


def test_tiny_lunar_per_scaled_with_sampler_kernel():
    cfg = dataclasses.replace(
        lunar_per_scaled(), num_envs=8, batch_size=16, buffer_capacity=8 * 64,
        steps_per_superstep=16, training_start=64, hidden=(16, 16), return_window=4,
        use_pallas_sampler=True,
    )
    assert (cfg.train_every, cfg.per_max_decay, cfg.use_pallas) == (4, 0.999, True)
    assert cfg.target_tau == 0.02
    tr = Trainer(cfg, device="cpu").init(seed=5)
    assert tr.replay.use_pallas

    decays = []
    update_priorities = tr.replay.update_priorities

    def spy(state, info, td):
        before = state.max_priority.clone()
        out = update_priorities(state, info, td)
        decays.append((float(before), float((td.abs() + cfg.per_eps).max()), float(out.max_priority)))
        return out

    tr.replay.update_priorities = spy
    sample_kernels.reset_counts()
    td_kernels.reset_counts()
    ms = [tr.step() for _ in range(3)]

    # updates start at vector step 8 (64 stored transitions), then every 4th
    assert [m.loss_count for m in ms] == [3, 4, 4]
    updates = tr.runner.train.updates
    assert updates == 11 == len(decays)
    assert sample_kernels.plain_calls == {"per_slot_sample": updates}
    assert td_kernels.plain_calls == {"td_loss_fwd": updates, "td_loss_bwd": updates}
    assert sample_kernels.launches == {"per_slot_sample": 0}
    assert all(np.isfinite(m.loss_sum) for m in ms)
    for before, mag, after in decays:
        want = max(np.float32(before) * np.float32(0.999), np.float32(mag))
        assert after == want
    assert decays[0][0] == 1.0
    # every written slot keeps a positive priority
    assert torch.all(tr.runner.replay.priorities[:, : tr.runner.replay.filled] > 0)
