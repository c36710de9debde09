"""A steady superstep as one CUDA graph against the same learner frame by
frame, in turns in one process that never starts torch.profiler.

    PYTHONPATH=. python3 artifacts/superstep_graph/turns.py  # one H100

For the 8-member ``lunar_per`` population at ``chip_smoke.POP_CUTS`` and
for ``lunar_per``: 4 supersteps of each form (past the warm-up, the
steady pattern frame by frame and the graph's capture), then 4 turns of
one superstep each, host clock ending in a sync; then, 3 times, the
superstep's graph replayed alone (device ms between CUDA events and the
host ms of its launch) beside the frame graph and graph L replayed alone.
Prints one line a measurement, each with the card's name and power limit.
"""

import dataclasses
import os
import sys
import time


def sync_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def alone(torch, graph, n=3):
    """Device ms a replay over ``n`` back-to-back replays, host ms a launch."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    host = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        graph.replay()
        host += time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, 1e3 * host / n


def learners(label):
    """``{form: (step, superstep)}`` of the two forms from one seed."""
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.parallel import build_population
    from deep_q_learning_tpu_torch.train import Trainer

    import chip_smoke as cs

    out = {}
    for form in ("whole", "frames"):
        if label == "population":
            init, step, _ = build_population(
                dataclasses.replace(lunar_per(), **cs.POP_CUTS), cs.POP_MEMBERS, device="cuda")
            runner = init(0)
            out[form] = (lambda step=step, runner=runner: step(runner)), step
        else:
            trainer = Trainer(lunar_per(), device="cuda").init(seed=0)
            out[form] = trainer.step, trainer._superstep
        out[form][1].max_graphs = 4 if form == "whole" else 0
    return out


def main() -> int:
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    for label in ("population", "lunar_per"):
        forms = learners(label)
        frames = cs.POP_CUTS["steps_per_superstep"] if label == "population" else 128
        for _ in range(4):
            for step, _s in forms.values():
                step()
        for _ in range(4):
            for form, (step, _s) in forms.items():
                print(f"{label} {form} superstep {sync_ms(torch, step):.1f} ms [{card}]", flush=True)
        whole, per_frame = forms["whole"][1], forms["frames"][1]
        (graph, _), = whole.supersteps.values()
        for _ in range(3):
            device, host = alone(torch, graph.graph)
            fd, fh = alone(torch, per_frame.frame.graph, 10)
            ld, lh = alone(torch, per_frame.learn.graph, 10)
            print(f"{label} the superstep's graph alone: {device:.2f} ms on the device a replay, "
                  f"its launch {host:.2f} ms of host; the frame graph {fd:.3f} ms (launch "
                  f"{fh:.3f}), graph L {ld:.3f} ms (launch {lh:.3f}), x{frames} = "
                  f"{frames * (fd + ld):.2f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
