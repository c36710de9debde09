"""Device-side measurements behind PERF.md, on one CUDA GPU.

    python -m deep_q_learning_tpu_torch.measure [--preset lunar_per_scaled]
        [--set key=value ...] [--env-only]

1. Device time of each kernel and of its plain version at the main paths'
   shapes: 100 calls captured in one CUDA graph, replayed 50 times between
   CUDA events, so the host's enqueue cost drops out.
2. One steady superstep of the preset under ``torch.profiler``: host ms by
   phase (spans wrapped around the env step, replay and optimizer calls),
   kernel launches, and the device's busy share of the wall time; then the
   wall time and env-steps/s of the next two supersteps, unprofiled.

With ``--env-only``, neither: the preset's env alone, at its env count,
steps random actions from fresh resets; the wall time of each frame, then
one frame under ``torch.profiler`` (kernel launches, device busy share).

Every line names the card and its power limit.  Without CUDA it exits
non-zero: a CPU run measures nothing this script reports.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

GRAPH_CALLS, GRAPH_REPLAYS = 100, 50


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_us(fn) -> float:
    """Device µs per call of ``fn``, from a CUDA graph of GRAPH_CALLS calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (GRAPH_CALLS * GRAPH_REPLAYS)


def kernel_device_times(card: str) -> None:
    from deep_q_learning_tpu_torch.ops import sample_kernels as sk
    from deep_q_learning_tpu_torch.ops import td_kernels as tk

    g = torch.Generator(device="cuda").manual_seed(0)
    for n, c, b in [(1024, 512, 1024), (128, 4096, 256)]:
        p = torch.rand((n, c), generator=g, device="cuda") ** 3
        env = torch.randint(0, n, (b,), generator=g, device="cuda")
        u = torch.rand((b,), generator=g, device="cuda")
        k = device_us(lambda: sk.slot_select(p, env, u))
        r = device_us(lambda: sk.slot_select_reference(p, env, u))
        print(f"per_slot_sample (N, C, B)=({n}, {c}, {b}): device {k:.2f} us kernel, "
              f"{r:.2f} us plain [{card}]")
    for b in (256, 1024):
        q = [torch.randn((b, 4), generator=g, device="cuda") for _ in range(3)]
        act = torch.randint(0, 4, (b,), generator=g, device="cuda", dtype=torch.int32)
        rew, boot, w = (torch.rand((b,), generator=g, device="cuda") for _ in range(3))
        args = (*q, act, rew, boot, w, 1.0, True)
        loss, td = tk.td_loss_fwd(*args)
        one = torch.ones((), device="cuda")
        times = {
            "td_loss_fwd": (device_us(lambda: tk.td_loss_fwd(*args)),
                            device_us(lambda: tk.td_loss_reference(*args))),
            "td_loss_bwd": (device_us(lambda: tk.td_loss_bwd(td, act, w, one, 4, 1.0)),
                            device_us(lambda: tk.td_loss_backward_reference(td, act, w, one, 4, 1.0))),
        }
        for name, (k, r) in times.items():
            print(f"{name} B={b} A=4: device {k:.2f} us kernel, {r:.2f} us plain [{card}]")


PHASES = {
    "venv": ("fresh_pool", "step"),
    "replay": ("add", "sample_with_info", "update_priorities"),
    "optimizer": ("apply",),
}


def _span(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def profile_superstep(cfg, card: str) -> None:
    from deep_q_learning_tpu_torch.train import Trainer

    trainer = Trainer(cfg, device="cuda").init(seed=0)
    for owner, methods in PHASES.items():  # the superstep calls these by attribute
        obj = getattr(trainer, owner)
        for m in methods:
            setattr(obj, m, _span(getattr(obj, m), f"phase/{owner}.{m}"))
    for _ in range(2):  # past the warm-up frames: every superstep now trains
        trainer.step()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = trainer.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: the phase spans also appear on the device's timeline
    device_us_total = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("phase/")
    )
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    frames = cfg.steps_per_superstep
    print(f"profiled superstep: wall {wall * 1e3:.1f} ms, {m.loss_count} updates, "
          f"device busy {device_us_total / 1e3:.1f} ms ({100 * device_us_total / 1e6 / wall:.1f} %), "
          f"{launches} kernel launches ({launches / frames:.0f} per vector step) [{card}]")
    spans = sorted((e for e in events if e.key.startswith("phase/")
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: -e.cpu_time_total)
    for e in spans:
        print(f"  {e.key[6:]:28s} {e.cpu_time_total / 1e3:9.1f} ms host "
              f"({100 * e.cpu_time_total / 1e6 / wall:.1f} %), {e.count} calls")

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"unprofiled superstep: {wall * 1e3:.1f} ms, "
              f"{frames * cfg.num_envs / wall:.1f} env-steps/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")


ENV_FRAMES = 4


def env_frames(cfg, card: str) -> None:
    from deep_q_learning_tpu_torch.envs import make_env

    env, params = make_env(cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
                           param_overrides=cfg.env_param_overrides())
    n = cfg.num_envs
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = env.reset_env(g, n, params)
    torch.cuda.synchronize()
    print(f"reset of {n} envs (one physics frame): {(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")

    def frame():
        nonlocal st
        actions = torch.randint(0, env.num_actions, (n,), generator=g, device="cuda",
                                dtype=torch.int32)
        _, st, *_ = env.step_env(g, st, actions, params)

    walls = []
    for _ in range(ENV_FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"env-only vector steps of {n} envs: {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms "
          f"= {n / min(walls):.1f} env-steps/s at the fastest [{card}]")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
               for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    print(f"profiled vector step: wall {wall * 1e3:.1f} ms, {launches} kernel launches "
          f"({wall * 1e6 / max(launches, 1):.2f} us of wall each), device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e6 / wall:.1f} %) [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deep_q_learning_tpu_torch.measure")
    ap.add_argument("--preset", default="lunar_per_scaled")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--env-only", action="store_true",
                    help="time the preset's env alone instead of kernels and a superstep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    from deep_q_learning_tpu_torch.__main__ import build_config

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    cfg = build_config(args.preset, args.set)
    if args.env_only:
        env_frames(cfg, card)
        return 0
    kernel_device_times(card)
    profile_superstep(cfg, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
