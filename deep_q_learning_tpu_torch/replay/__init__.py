from deep_q_learning_tpu_torch.replay.uniform import ReplayState, UniformReplay
from deep_q_learning_tpu_torch.replay.nstep import (
    LearnBatch,
    assemble_learn_batch,
    valid_slot_mask,
)
from deep_q_learning_tpu_torch.replay.prioritized import (
    PrioritizedReplay,
    PrioritizedReplayState,
    SampleInfo,
)


def make_replay(cfg, num_envs=None, members=None):
    """Replay buffer from config (uniform | prioritized); with ``members``,
    the buffers of that many population members, each of the config's
    size."""
    n = num_envs if num_envs is not None else cfg.num_envs
    cap = max(1, cfg.buffer_capacity // n)
    common = dict(
        gamma=cfg.gamma, n_step=cfg.n_step,
        truncation_bootstrap=cfg.truncation_bootstrap, members=members,
    )
    if cfg.replay == "uniform":
        return UniformReplay(n, cap, **common)
    elif cfg.replay == "prioritized":
        return PrioritizedReplay(
            n, cap, alpha=cfg.per_alpha, beta=cfg.per_beta, eps=cfg.per_eps,
            max_decay=cfg.per_max_decay,
            use_pallas=cfg.use_pallas_sampler, **common,
        )
    raise ValueError(f"unknown replay {cfg.replay!r}")
