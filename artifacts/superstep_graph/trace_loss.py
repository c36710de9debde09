"""Does the profiler keep every record of a superstep that is one CUDA
graph replay?  Phase 13 (b) of ``chip_smoke.py`` in a process of its own.

    PYTHONPATH=. python3 artifacts/superstep_graph/trace_loss.py  # one H100

``examples.train_lunar_lander --preset lunar_per`` trains 4 supersteps
while ``examples.evaluate_checkpoint`` runs in a process of its own on the
card, as in the smoke; then its trainer's next supersteps (each one replay
of the superstep's graph) are traced one profiling session each
(``measure.traced_kernels``): 6 while the evaluator's process may still
run, 4 alone, 4 beside a process that multiplies matrices on the card, 2
alone again (the session idle ``measure.PAD_S`` before and after the
counted span), then 2 with no idle time around it.  Prints, a trace, the launches with no kernel
in the trace, the graph launches' kernels and K1/K2 on the device, and
the card's name and power limit.
"""

import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUSY = ("import time, torch\nx = torch.randn(2048, 2048, device='cuda')\nt = time.time()\n"
        "while time.time() - t < 25:\n    y = x @ x\n    torch.cuda.synchronize()\n")


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    from deep_q_learning_tpu_torch import native
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.examples import train_lunar_lander
    from deep_q_learning_tpu_torch.measure import PAD_S, learner_kernels, traced_kernels
    from deep_q_learning_tpu_torch.ops import sample_kernels, solver_kernels, td_kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{sys.version.split()[0]} torch {torch.__version__} CUDA {torch.version.cuda} [{card}]")
    with ThreadPoolExecutor(max_workers=4) as pool:
        for fut in [pool.submit(td_kernels._lib), pool.submit(sample_kernels._lib),
                    pool.submit(solver_kernels._lib), pool.submit(native.load_library)]:
            fut.result()
    torch.backends.cuda.matmul.allow_tf32 = False
    (REPO / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(dir=REPO / "build")
    cfg = lunar_per()
    steps = 4 * cfg.steps_per_superstep * cfg.num_envs
    evaluator = subprocess.Popen(
        [sys.executable, "-m", "deep_q_learning_tpu_torch.examples.evaluate_checkpoint",
         "--ckpt", str(REPO / "artifacts" / "lunar_ref_format"), "--episodes", "10",
         "--device", "cuda", "--out", str(Path(workdir) / "eval")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        trainer = train_lunar_lander.main([
            "--preset", "lunar_per", "--device", "cuda", "--rollouts", "1", "--steps", str(steps),
            "--log-every", "1", "--workdir", workdir])

        def trace(tag, other, pad_s=PAD_S):
            running = other is not None and other.poll() is None
            more = []
            t = traced_kernels(lambda: more.append(trainer.step()), pad_s=pad_s)
            print(f"{tag}: other process running at the start {running}; {t.lost} of "
                  f"{t.launches} kernel launches and {t.per_graph_launch.count(0)} of "
                  f"{len(t.per_graph_launch)} graph launches with no kernel; kernels a graph "
                  f"launch {t.per_graph_launch}; K1/K2 on the device {learner_kernels(t)} for "
                  f"{more[-1].loss_count} updates; supersteps as one replay / frame by frame "
                  f"{trainer._superstep.runs['whole']} / {trainer._superstep.runs['frames']}; "
                  f"lost launches at {[round(x / 1e3, 2) for x in t.lost_at_us]} ms of a "
                  f"{t.wall_us / 1e3:.1f} ms span [{card}]", flush=True)

        for i in range(6):
            trace(f"beside the evaluator {i}", evaluator)
        evaluator.communicate(timeout=300)
        for i in range(4):
            trace(f"alone {i}", None)
        busy = subprocess.Popen([sys.executable, "-c", BUSY], stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, env=dict(os.environ))
        try:
            time.sleep(6)  # past its start-up
            for i in range(4):
                trace(f"beside a busy process {i}", busy)
        finally:
            busy.kill()
            busy.wait()
        for i in range(2):
            trace(f"alone again {i}", None)
        for i in range(2):
            trace(f"no idle time around the span {i}", None, pad_s=0.0)
    finally:
        if evaluator.poll() is None:
            evaluator.kill()
            evaluator.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
