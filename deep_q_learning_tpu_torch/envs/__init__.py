from deep_q_learning_tpu_torch.envs.base import (
    Environment,
    EnvParams,
    Transition,
    VectorEnv,
)
from deep_q_learning_tpu_torch.envs.acrobot import Acrobot, AcrobotParams
from deep_q_learning_tpu_torch.envs.cartpole import CartPole, CartPoleParams
from deep_q_learning_tpu_torch.envs.mountain_car import MountainCar, MountainCarParams
from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander, LunarLanderParams
from deep_q_learning_tpu_torch.envs.wrappers import TimeFractionObs, WrappedEnv
from deep_q_learning_tpu_torch.envs.heuristic import heuristic_action
from deep_q_learning_tpu_torch.envs.registry import available_envs, make_env
