"""Device-side measurements behind PERF.md, on one CUDA GPU.

    python -m deep_q_learning_tpu_torch.measure [--preset lunar_per_scaled]
        [--set key=value ...] [--env-only | --kernels-only] [--baseline CHECKOUT]

1. Device time of each kernel and of its plain version at the main paths'
   shapes: 100 calls captured in one CUDA graph, replayed 50 times between
   CUDA events, so the host's enqueue cost drops out.  Beside each: its
   bound (``ops.bound_us`` of the bytes and operations the call needs) and
   the share of it the kernel reaches, and the kernel's launches per steady
   superstep on each preset that runs it.  With ``--baseline CHECKOUT``
   (another checkout of the port, e.g. an earlier commit unpacked with
   ``git archive``), its TD kernels and its PER slot kernel are timed too,
   each built from that checkout's own source, in turns with this tree's.
   Then the kernel launches of one learner update (``torch.profiler``).
2. One steady superstep of the preset under ``torch.profiler``: host ms by
   phase (spans wrapped around the env step, replay and optimizer calls),
   kernel launches, and the device's busy share of the wall time; then the
   wall time and env-steps/s of the next two supersteps, unprofiled.

With ``--kernels-only``, only 1.  With ``--env-only``, neither: the preset's env alone, at its env count,
steps random actions from fresh resets; the wall time of each frame, then
one frame under ``torch.profiler`` (kernel launches, device busy share).

Every line names the card and its power limit.  Without CUDA it exits
non-zero: a CPU run measures nothing this script reports.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

GRAPH_CALLS, GRAPH_REPLAYS = 100, 50
# the TD kernels' batch on lunar_per / lunar_jointed_per, lunar_per_scaled(1024)
# and lunar_per_scaled(4096)
TD_BATCHES = (256, 1024, 4096)
# the PER slot kernel's (N, C, B) on lunar_per_scaled(1024), lunar_per and
# lunar_per_scaled(4096) (C = 2^19 / 4096) with use_pallas_sampler=true
SLOT_SHAPES = ((1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096))


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


def launches_per_superstep() -> dict:
    """Launches of each kernel in one steady superstep (every vector step
    past the warm-up), on each preset that runs it: one per learner update."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import PRESETS, lunar_per_scaled

    runs = {name: make() for name, make in PRESETS.items()}
    runs["lunar_per_scaled+use_pallas_sampler"] = dataclasses.replace(
        lunar_per_scaled(), use_pallas_sampler=True)
    out = {"td_loss_fwd": {}, "td_loss_bwd": {}, "per_slot_sample": {}}
    for name, cfg in runs.items():
        updates = -(-cfg.steps_per_superstep // cfg.train_every) * cfg.updates_per_step
        if cfg.use_pallas:
            out["td_loss_fwd"][name] = out["td_loss_bwd"][name] = updates
        if cfg.use_pallas_sampler:
            out["per_slot_sample"][name] = updates
    return out


def bound_text(work, us: float) -> str:
    """``bound X us (bytes), Y % of it`` for a kernel time ``us``."""
    from deep_q_learning_tpu_torch.ops import bound_by, bound_us

    bound = bound_us(work)
    return f"bound {bound:.4f} us ({bound_by(work)}: {work[0]} B, {work[1]} ops), {100 * bound / us:.2f} % of it"


def td_inputs(b: int, g: torch.Generator):
    """The TD kernels' inputs as the learner gives them: ``q_s`` and
    ``q_next_online`` are the two halves of one (2B, 4) ``q_both``."""
    q_both = torch.randn((2 * b, 4), generator=g, device="cuda")
    q_nt = torch.randn((b, 4), generator=g, device="cuda")
    act = torch.randint(0, 4, (b,), generator=g, device="cuda", dtype=torch.int32)
    rew, boot, w = (torch.rand((b,), generator=g, device="cuda") for _ in range(3))
    return (q_both[:b], q_both[b:], q_nt, act, rew, boot, w)


@functools.cache
def load_baseline(checkout: Path, name: str):
    """``ops/<name>.py`` (``td_kernels`` or ``sample_kernels``) of another
    checkout of the port (an earlier commit unpacked with ``git archive``),
    with its kernels built from that checkout's ``csrc/``, to time beside
    this one in one process."""
    from deep_q_learning_tpu_torch.ops import build

    path = checkout / "deep_q_learning_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.load_library = functools.partial(
        build.load_library, csrc_dir=checkout / "deep_q_learning_tpu_torch" / "csrc")
    return module


def kernel_device_times(card: str, baseline: Optional[Path] = None) -> None:
    from deep_q_learning_tpu_torch.ops import sample_kernels as sk
    from deep_q_learning_tpu_torch.ops import td_kernels as tk

    per_superstep = launches_per_superstep()
    print(f"kernel launches per steady superstep, by preset: {per_superstep}")
    g = torch.Generator(device="cuda").manual_seed(0)
    base_sk = load_baseline(baseline, "sample_kernels") if baseline is not None else None
    for n, c, b in SLOT_SHAPES:
        p = torch.rand((n, c), generator=g, device="cuda") ** 3
        env = torch.randint(0, n, (b,), generator=g, device="cuda")
        u = torch.rand((b,), generator=g, device="cuda")
        k = device_us(lambda: sk.slot_select(p, env, u))
        r = device_us(lambda: sk.slot_select_reference(p, env, u))
        print(f"per_slot_sample (N, C, B)=({n}, {c}, {b}): device {k:.2f} us kernel, "
              f"{r:.2f} us plain; {bound_text(sk.per_slot_sample_work(p, env), k)}; "
              f"plan {sk.slot_plan(p)} [{card}]")
        if base_sk is None:
            continue
        differ = int((base_sk.slot_select(p, env, u) != sk.slot_select(p, env, u)).sum())
        b0, t0, t1, b1 = [
            device_us(lambda: (base_sk if which == "baseline" else sk).slot_select(p, env, u))
            for which in ("baseline", "tree", "tree", "baseline")
        ]
        print(f"  ({n}, {c}, {b}) per_slot_sample: baseline {b0:.2f}, {b1:.2f} us; this tree "
              f"{t0:.2f}, {t1:.2f} us (device, in turns); {differ} of {b} slots differ from "
              f"the baseline's [{card}]")
    base = load_baseline(baseline, "td_kernels") if baseline is not None else None
    for b in TD_BATCHES:
        args = (*td_inputs(b, g), 1.0, True)
        loss, td = tk.td_loss_fwd(*args)
        act, w = args[3], args[6]
        one = torch.ones((), device="cuda")
        fwd = device_us(lambda: tk.td_loss_fwd(*args))
        bwd = device_us(lambda: tk.td_loss_bwd(td, act, w, one, 4, 1.0, out_rows=2 * b))
        print(f"td_loss_fwd B={b} A=4: device {fwd:.2f} us kernel, "
              f"{device_us(lambda: tk.td_loss_reference(*args)):.2f} us plain; "
              f"{bound_text(tk.td_loss_fwd_work(b, 4), fwd)} [{card}]")
        plain_bwd = device_us(
            lambda: tk.td_loss_backward_reference(td, act, w, one, 4, 1.0, out_rows=2 * b))
        print(f"td_loss_bwd B={b} A=4 -> ({2 * b}, 4): device {bwd:.2f} us kernel, "
              f"{plain_bwd:.2f} us plain; {bound_text(tk.td_loss_bwd_work(b, 4, 2 * b), bwd)} [{card}]")
        if base is None:
            continue
        # in turns: baseline, this tree, this tree, baseline.  The baseline's
        # backward writes (B, 4) and autograd pads it to (2B, 4) with a slice
        # backward (a zero fill and a copy): timed with and without it
        base_bwd = lambda: base.td_loss_bwd(td, act, w, one, 4, 1.0)  # noqa: E731
        turns = {"fwd": [], "bwd": [], "bwd+slice_backward": []}
        for which in ("baseline", "tree", "tree", "baseline"):
            if which == "baseline":
                turns["fwd"].append(device_us(lambda: base.td_loss_fwd(*args)))
                turns["bwd"].append(device_us(base_bwd))
                turns["bwd+slice_backward"].append(device_us(
                    lambda: torch.ops.aten.slice_backward(base_bwd(), [2 * b, 4], 0, 0, b, 1)))
            else:
                turns["fwd"].append(device_us(lambda: tk.td_loss_fwd(*args)))
                bwd_us = device_us(lambda: tk.td_loss_bwd(td, act, w, one, 4, 1.0, out_rows=2 * b))
                turns["bwd"].append(bwd_us)
                turns["bwd+slice_backward"].append(bwd_us)
        for name, (b0, t0, t1, b1) in turns.items():
            print(f"  B={b} {name}: baseline {b0:.2f}, {b1:.2f} us; this tree {t0:.2f}, "
                  f"{t1:.2f} us (device, in turns) [{card}]")


def learner_update_profile(td_module=None, b: int = 256):
    """``(launches, {kernel name: count}, {aten op: count})`` of one
    ``lunar_per`` learner update (forward, fused TD loss, backward, adam,
    Polyak) at batch ``b`` on the card, after three warm-up updates,
    counted by ``torch.profiler``.  ``td_module`` (another checkout's
    ``ops/td_kernels.py``, from :func:`load_baseline`) supplies
    the fused loss in place of this tree's."""
    import dataclasses
    from unittest import mock

    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.ops import td_kernels
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    cfg = dataclasses.replace(lunar_per(), batch_size=b)
    opt = make_optimizer(cfg)
    net = QNetwork(9, 4, hidden=cfg.hidden, generator=torch.Generator().manual_seed(0))
    ts = init_train_state(net.cuda(), opt)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = LearnBatch(
        obs=torch.randn((b, 9), generator=g, device="cuda"),
        action=torch.randint(0, 4, (b,), generator=g, device="cuda", dtype=torch.int32),
        reward=torch.randn((b,), generator=g, device="cuda"),
        next_obs=torch.randn((b, 9), generator=g, device="cuda"),
        bootstrap=torch.full((b,), 0.97, device="cuda"),
    )
    weights = torch.rand((b,), generator=g, device="cuda") + 0.1
    module = td_module if td_module is not None else td_kernels
    with mock.patch.object(td_kernels, "build_fused_loss_fn", module.build_fused_loss_fn):
        update = build_update_step(opt, cfg)
    for _ in range(3):
        update(ts, batch, weights)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        update(ts, batch, weights)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    kernels = {e.key: e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA}
    ops = {e.key: e.count for e in events if e.key in LEARNER_OPS}
    return launches, kernels, ops


# the autograd ops around the fused loss that launch kernels of their own
LEARNER_OPS = ("aten::slice_backward", "aten::zeros", "aten::zero_", "aten::fill_",
               "aten::copy_", "aten::cat")


def learner_launches(card: str, baseline: Optional[Path] = None) -> None:
    launches, kernels, ops = learner_update_profile()
    print(f"learner update B=256: {launches} kernel launches; {ops} [{card}]")
    if baseline is None:
        return
    base_launches, base_kernels, base_ops = learner_update_profile(
        load_baseline(baseline, "td_kernels"))
    print(f"  with the baseline's fused loss: {base_launches} kernel launches; {base_ops} [{card}]")
    for name in sorted(set(kernels) | set(base_kernels)):
        if kernels.get(name, 0) != base_kernels.get(name, 0):
            print(f"  kernel {name[:100]}: baseline {base_kernels.get(name, 0)}, "
                  f"this tree {kernels.get(name, 0)}")


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
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels and count a learner update's launches, "
                         "without the superstep")
    ap.add_argument("--baseline", type=Path, metavar="CHECKOUT",
                    help="also time the TD and PER slot kernels of another checkout of "
                         "the port, in turns with this tree's")
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
    kernel_device_times(card, args.baseline)
    learner_launches(card, args.baseline)
    if not args.kernels_only:
        profile_superstep(cfg, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
