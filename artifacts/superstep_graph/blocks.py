"""A whole superstep's CUDA graph against graphs of k of its frames
replayed F/k times, in one process that never starts torch.profiler.

    PYTHONPATH=. python3 artifacts/superstep_graph/blocks.py  # one H100

For the classic presets (no reset pool, so a block is the superstep
function on a slice of the pattern): ``mountain_car_vector``
(``training_start`` 16,384), ``cartpole_vector`` and ``acrobot_vector``
through ``Trainer``, 5 supersteps (the steady superstep's graph
captured), then blocks of k = 8, 16 and 32 frames of the same steady
pattern captured; 3 rounds of: the whole graph once, each block graph
F/k times (device ms between CUDA events), a superstep through the
trainer (one replay) and one frame by frame.  The replays alone advance
the runner past its host mirrors; the trainer's supersteps after them
are timed only.
"""

import dataclasses
import os
import sys
import time


def main() -> int:
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deep_q_learning_tpu_torch import config
    from deep_q_learning_tpu_torch.envs.graphed import graph_nodes
    from deep_q_learning_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()

    def timed(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for preset, cut in (("mountain_car_vector", {"training_start": 16384}),
                        ("cartpole_vector", {}), ("acrobot_vector", {})):
        trainer = Trainer(dataclasses.replace(getattr(config, preset)(), **cut),
                          device="cuda").init(seed=0)
        for _ in range(5):
            trainer.step()
        learner, work = trainer._superstep, trainer._superstep.work
        key = learner.key(trainer.runner)
        whole, _ = learner.supersteps[key]
        pattern = key[1]
        work.runner = trainer.runner
        blocks = {}
        for k in (8, 16, 32):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.register_generator_state(trainer.runner.generator)
            work.pattern = pattern[:k]
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                work.superstep()
            nodes = graph_nodes(graph.raw_cuda_graph())
            graph.instantiate()
            blocks[k] = graph, nodes
        frames = len(pattern)
        for rnd in range(3):
            print(f"{preset} round {rnd}: the whole graph ({whole.nodes} nodes) "
                  f"{timed(whole.graph.replay):.2f} ms on the device [{card}]", flush=True)
            for k, (graph, nodes) in blocks.items():
                ms = timed(lambda: [graph.replay() for _ in range(frames // k)])
                print(f"{preset} round {rnd}: {frames // k} x {k}-frame blocks ({nodes} nodes) "
                      f"{ms:.2f} ms on the device [{card}]", flush=True)
            print(f"{preset} round {rnd}: a superstep through the trainer "
                  f"{timed(trainer.step):.2f} ms [{card}]", flush=True)
            learner.max_graphs, kept = 0, learner.max_graphs
            print(f"{preset} round {rnd}: a superstep frame by frame "
                  f"{timed(trainer.step):.2f} ms [{card}]", flush=True)
            learner.max_graphs = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
