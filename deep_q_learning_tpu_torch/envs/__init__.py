from deep_q_learning_tpu_torch.envs.base import (
    Environment,
    EnvParams,
    Transition,
    VectorEnv,
)
from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander
from deep_q_learning_tpu_torch.envs.registry import make_env
from deep_q_learning_tpu_torch.envs.wrappers import TimeFractionObs
