from deep_q_learning_tpu_torch.hpo.bayesopt import (
    LUNAR_SPACE,
    REFERENCE_SPACE,
    SPACES,
    HPOResult,
    Param,
    Trial,
    make_dqn_objective,
    make_population_objective,
    optimize,
    optimize_batched,
)
