from deep_q_learning_tpu_torch.utils import checkpoint
from deep_q_learning_tpu_torch.utils.metrics import (
    MetricLogger,
    plot_history,
    stopwatch,
    trace,
)
from deep_q_learning_tpu_torch.utils.visualize import (
    dump_trajectory,
    plot_lander_flight,
    record_trajectory,
)
