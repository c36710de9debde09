from deep_q_learning_tpu_torch.algos.dqn import (
    HyperParams,
    Optimizer,
    TrainState,
    build_update_step,
    epsilon_by_schedule,
    epsilon_greedy,
    init_train_state,
    make_optimizer,
    sync_target,
)
from deep_q_learning_tpu_torch.algos.losses import build_loss_fn, huber, td_targets
from deep_q_learning_tpu_torch.algos.superstep import (
    RunnerState,
    SuperstepMetrics,
    build_superstep,
)
