"""Device-side measurements behind PERF.md, on one CUDA GPU.

    python -m deep_q_learning_tpu_torch.measure [--preset lunar_per_scaled]
        [--set key=value ...] [--env-only | --kernels-only] [--eager]
        [--eager-learner] [--members M] [--baseline CHECKOUT] [--pairs]

1. Device time of each kernel and of its plain version at the main paths'
   shapes, and with a population's member axis (``lunar_per``'s at 8
   members): 100 calls captured in one CUDA graph, replayed 50 times between
   CUDA events, so the host's enqueue cost drops out.  Beside each: its
   bound (``ops.bound_us`` of the bytes and operations the call needs) and
   the share of it the kernel reaches, and the kernel's launches per steady
   superstep on each preset that runs it.  S1, the jointed solver's step,
   at ``SOLVER_SHAPES`` on states of a flight of landers, its plain version
   as a CUDA graph of one call (~56k kernels).  R1, the rigid lander's
   step, at ``RIGID_SHAPES`` (and its reset frame) on states of a flight of
   landers, its plain version as a CUDA graph of 10 calls; R1's vector
   step (the step, the auto-reset from a pool and the time feature, one
   launch) at the same N against its plain composition, and alone as a
   CUDA graph of one call (replay µs and kernels).  J1, the
   jointed lander's frame, at ``JOINTED_SHAPES`` (the wind off and on, and
   the reset frame), with the slowest env's passes and the µs a pass.  With
   ``--baseline CHECKOUT``
   (another checkout of the port, e.g. an earlier commit unpacked with
   ``git archive``), its TD kernels, its PER slot kernel, its S1, its R1
   (step and reset frame; its vector step is its R1 step inside the
   composition) and its J1 are timed too, each built from that checkout's
   own source, in turns with this tree's (baseline, tree, tree, baseline),
   the lander kernels with the count of lanes whose result differs from
   the baseline's in any bit.
   Then the kernel launches of one learner update (``torch.profiler``).
2. One steady superstep of the preset under ``torch.profiler``: host ms by
   phase (spans wrapped around the env step, the reset pool or the cheap
   per-frame reset, the replay and optimizer calls, and the learner's
   frame and update graphs), the host's launches (kernels, CUDA graphs,
   copies and fills) per vector step, the kernels of the learner in the
   trace (K1, K2 and K3 once per update), and the device's busy share of
   the wall time; then the wall time and env-steps/s of the next two
   supersteps, unprofiled.  A steady superstep is one CUDA graph (every env
   of the port injects its draws, with either replay): the warm-up runs
   supersteps until the next one's cadence has its graph (at most
   ``WARM_SUPERSTEPS``), and its span ``phase/graph.superstep`` holds the
   replay; the line ``superstep graph`` gives its nodes, its capture and
   instantiation seconds, its replay alone on the device and the share of
   the supersteps that ran as one replay.  A superstep whose cadence is
   new runs frame by frame as CUDA graphs: the frame (actor, env step,
   replay write) and, when it trains, the learner update
   (``algos/superstep.py::GraphedLearner``), beside the lander's reset
   pool's graph; ``--eager-learner``
   runs the frame eagerly around the env step's graph, and ``--eager``
   runs everything eagerly (``graphed=False``).  Each graph is then
   replayed alone: its device time between CUDA events, its kernels and
   the host time of its launch, beside the wall time of a frame of those
   supersteps.  The learner's graphs write the runner in place, so their
   replays come last and leave the trainer advanced past its counters.
   With ``--members M`` the same for a population of M learners of the
   preset (``PopulationTrainer``; ``algos/superstep.py::GraphedPopulation``,
   the eager population with ``--eager-learner``): a steady superstep
   traced (the host's launches a vector step, K1-K3 on the device, the
   busy share), two unprofiled
   (aggregate env-steps/s) and each graph's replay.

With ``--kernels-only``, only 1.  With ``--pairs``, only 2, four times
in one process: the graphed learner and the eager one
(``--eager-learner``) in turns, graphed, eager, eager, graphed, so that
the two compare on one card in one call.  With
``--env-only``, neither: the preset's env alone, at its env count, steps
random actions from fresh resets; the wall time of each frame, then one
frame under ``torch.profiler`` (kernel launches, device busy share).

Every line names the card and its power limit.  Without CUDA it exits
non-zero: a CPU run measures nothing this script reports.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch

GRAPH_CALLS, GRAPH_REPLAYS = 100, 50
# the TD kernels' batch on a rank of lunar_per over 2 ranks, lunar_per /
# lunar_jointed_per, lunar_per_scaled(1024) and lunar_per_scaled(4096)
TD_BATCHES = (128, 256, 1024, 4096)
# the PER slot kernel's (N, C, B) on lunar_per_scaled(1024), lunar_per,
# lunar_per_scaled(4096) (C = 2^19 / 4096) and a rank of lunar_per over 2
# ranks (each rank's replay holds 2^19 over its 64 envs), with
# use_pallas_sampler=true
SLOT_SHAPES = ((1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096), (64, 8192, 128))
# a lunar_per population of 8 members: the TD kernels at (M, B, A) and the
# PER slot kernel over every member's rows, (M, N, C, B)
MEMBER_TD = (8, 256, 4)
MEMBER_SLOT = (8, 128, 4096, 256)
# S1, the jointed solver's step: (N, velocity passes, position passes) of
# lunar_jointed_per, lunar_jointed_scaled(1024) and the gymnasium harness's
# two-lane trace replay; its plain version, ~56k kernels a call, is timed as
# a CUDA graph of one call replayed PLAIN_SOLVER_REPLAYS times
SOLVER_SHAPES = ((128, 120, 40), (1024, 120, 40), (2, 180, 60))
PLAIN_SOLVER_REPLAYS = 3
# R1, the rigid lander's step: N of the host env (1), lunar_per's single
# learner (128), lunar_per_scaled(1024) and lunar_per's 8-member population
# (1024), multihost_ddqn (8192), with the wind off as in every preset; the
# reset frame at 128.  Its plain version, ~700 kernels a step, is timed as
# a CUDA graph of PLAIN_RIGID_CALLS calls
RIGID_SHAPES = (1, 128, 1024, 8192)
RIGID_RESET_N = 128
PLAIN_RIGID_CALLS = 10
# J1, the jointed lander's frame around S1: N of lunar_jointed_per (128) and
# lunar_jointed_scaled(1024) at the presets' (120, 40) passes, the wind off
# (every preset) and on; the reset frame at both.  Its plain version (S1
# and ~200 elementwise kernels a step) is timed as a CUDA graph of one call
# replayed PLAIN_JOINTED_REPLAYS times
JOINTED_SHAPES = (128, 1024)
PLAIN_JOINTED_REPLAYS = 20
# A1, C1 and M1, the classic envs' vector steps without a pool, as their
# presets run them: N of the host env (1), acrobot_vector and
# mountain_car_vector (128), cartpole_vector (4096) and 8192.  The plain
# composition (~265, ~50 and ~33 kernels a vector step) is timed as a CUDA
# graph of PLAIN_CLASSIC_CALLS calls; the states come from a flight of
# CLASSIC_ENVS envs over CLASSIC_FRAMES frames with episodes cut at
# CLASSIC_MAX_STEPS, so that some steps truncate
CLASSIC_SHAPES = (1, 128, 4096, 8192)
PLAIN_CLASSIC_CALLS = 10
CLASSIC_ENVS, CLASSIC_FRAMES, CLASSIC_MAX_STEPS = 1024, 300, 200


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_us(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device µs per call of ``fn``, from a CUDA graph of ``calls`` calls
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (calls * replays)


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


# ops modules a module of ops imports whose C structures it builds on
BASELINE_DEPS = {"jointed_kernels": ("solver_kernels",)}


@functools.cache
def load_baseline(checkout: Path, name: str):
    """``ops/<name>.py`` (``td_kernels``, ``sample_kernels``,
    ``solver_kernels``, ``lander_kernels`` or ``jointed_kernels``) of
    another checkout of the port (an earlier commit unpacked with ``git
    archive``), with its kernels built from that checkout's ``csrc/``, to
    time beside this one in one process.  The ops modules it builds its C structures on
    (``BASELINE_DEPS``) are that checkout's too while it loads."""
    from deep_q_learning_tpu_torch import ops
    from deep_q_learning_tpu_torch.ops import build

    deps = {dep: load_baseline(checkout, dep) for dep in BASELINE_DEPS.get(name, ())}
    path = checkout / "deep_q_learning_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    module = importlib.util.module_from_spec(spec)
    saved = {dep: importlib.import_module(f"{ops.__name__}.{dep}") for dep in deps}
    try:
        for dep, dep_module in deps.items():
            sys.modules[f"{ops.__name__}.{dep}"] = dep_module
            setattr(ops, dep, dep_module)
        spec.loader.exec_module(module)
    finally:
        for dep, dep_module in saved.items():
            sys.modules[f"{ops.__name__}.{dep}"] = dep_module
            setattr(ops, dep, dep_module)
    module.load_library = functools.partial(
        build.load_library, csrc_dir=checkout / "deep_q_learning_tpu_torch" / "csrc")
    return module


def solver_device_times(card: str, inputs: Optional[dict] = None,
                        baseline: Optional[Path] = None) -> dict:
    """S1 and its plain version at SOLVER_SHAPES: device µs a call of the
    kernel (a CUDA graph of GRAPH_CALLS calls) and of the plain version (a
    CUDA graph of one call, replayed PLAIN_SOLVER_REPLAYS times), and the
    work of the call on this data (``solver_kernels.needed_work``: the
    position passes each env ran, without what the plain version's selects
    drop), whose bound is printed beside the plain version's count's.
    ``inputs`` maps each shape to ``assembly_step``'s positional arguments
    then ``acc``; by default the states of a flight of 128 jointed landers
    near the ground (``envs/heuristic.py::solver_inputs``).  With
    ``baseline`` (a checkout, :func:`load_baseline`), that checkout's S1 is
    timed in turns with this tree's too.  Prints a line a shape and returns
    ``{shape: (kernel us, plain us, work)}``."""
    from deep_q_learning_tpu_torch.envs import LunarLander, lander_solver
    from deep_q_learning_tpu_torch.envs.heuristic import solver_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLanderParams
    from deep_q_learning_tpu_torch.ops import solver_kernels

    base = load_baseline(baseline, "solver_kernels") if baseline is not None else None
    g = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for n, vel, pos in SOLVER_SHAPES:
        if inputs is None:
            params = LunarLanderParams(vel_iters=vel, pos_iters=pos)
            *args, acc = solver_inputs(LunarLander(), params, n, g)
        else:
            *args, acc = inputs[n, vel, pos]
        kw = dict(acc=acc, vel_iters=vel, pos_iters=pos)
        ran = solver_kernels.position_passes(*args, **kw)
        k = device_us(lambda: solver_kernels.assembly_step_kernel(*args, **kw))
        r = device_us(lambda: lander_solver.assembly_step_reference(*args, **kw), calls=1,
                      replays=PLAIN_SOLVER_REPLAYS)
        work = solver_kernels.needed_work(*args, acc, ran, vel_iters=vel, pos_iters=pos)
        plain_work = solver_kernels.assembly_step_work(n, vel, ran)
        times[n, vel, pos] = (k, r, work)
        print(f"assembly_step (S1) N={n} ({vel}, {pos}): device {k:.2f} us kernel, {r:.2f} us "
              f"plain as a CUDA graph of one call ({r / k:.0f}x); position passes run "
              f"{int(ran.sum())} (mean {float(ran.float().mean()):.2f}); {bound_text(work, k)}; "
              f"counting the plain version's operations, {bound_text(plain_work, k)} [{card}]")
        if base is None:
            continue
        differ = lanes_differ(base.assembly_step_kernel(*args, **kw),
                                     solver_kernels.assembly_step_kernel(*args, **kw))
        b0, t0, t1, b1 = [
            device_us(lambda: (base if which == "baseline" else solver_kernels)
                      .assembly_step_kernel(*args, **kw))
            for which in ("baseline", "tree", "tree", "baseline")
        ]
        print(f"  N={n} ({vel}, {pos}) assembly_step (S1): baseline {b0:.2f}, {b1:.2f} us; this "
              f"tree {t0:.2f}, {t1:.2f} us (device, in turns; x{(b0 + b1) / (t0 + t1):.2f}); "
              f"{differ} of {n} lanes differ from the baseline's in some bit [{card}]")
    return times


def rigid_params(enable_wind: bool = False, max_steps: Optional[int] = None):
    """The rigid lander's params of the lander presets (wind off), or with
    the wind on, and another episode limit."""
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLanderParams

    params = LunarLanderParams(jointed=False, enable_wind=enable_wind)
    if max_steps is not None:
        params = dataclasses.replace(params, max_steps_in_episode=max_steps)
    return params


def rigid_device_times(card: str, inputs: Optional[dict] = None,
                       baseline: Optional[Path] = None) -> dict:
    """R1 and its plain version at RIGID_SHAPES, and the reset frame at
    RIGID_RESET_N: device µs a call of the kernel (a CUDA graph of
    GRAPH_CALLS calls) and of the plain version (a graph of
    PLAIN_RIGID_CALLS calls), beside the bound of the call's work
    (``lander_kernels.rigid_step_work``).  ``inputs`` maps each N to
    ``step_env``'s ``(state, action, draws)`` with the wind off; by
    default the states of a flight of landers
    (``envs/heuristic.py::lander_step_inputs``).  The reset's plain version is
    the whole ``reset_env_reference``, its terrain smoothing (a few
    kernels) included.  With ``baseline`` (a checkout,
    :func:`load_baseline`), that checkout's R1 is timed too, in turns with
    this tree's (baseline, tree, tree, baseline), with the count of lanes
    whose result differs from the baseline's in any bit.  Prints a line a
    shape and returns ``{(n, kind): (kernel us, plain us, work)}``, kind
    ``"step"`` or ``"reset"``."""
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws, smoothed_terrain
    from deep_q_learning_tpu_torch.ops import lander_kernels

    base = load_baseline(baseline, "lander_kernels") if baseline is not None else None
    env, params = LunarLander(), rigid_params()
    g = torch.Generator(device="cuda").manual_seed(0)
    times, calls = {}, {}
    for n in RIGID_SHAPES:
        state, action, draws = (inputs[n] if inputs is not None
                                else lander_step_inputs(env, params, n, g))
        calls[n, "step"] = functools.partial(_rigid_step, params, state, action, draws)
        k = device_us(lambda: lander_kernels.rigid_step_kernel(state, action, params, draws))
        r = device_us(lambda: env.step_env_reference(None, state, action, params, draws),
                      calls=PLAIN_RIGID_CALLS)
        times[n, "step"] = (k, r, lander_kernels.rigid_step_work(n))
    n = RIGID_RESET_N
    rd = sample_reset_draws(g, n)
    terrain = smoothed_terrain(rd.terrain, params)
    calls[n, "reset"] = functools.partial(_rigid_reset, params, terrain, rd)
    k = device_us(lambda: lander_kernels.rigid_reset_kernel(terrain, rd.kick, rd.wind, params))
    r = device_us(lambda: env.reset_env_reference(None, n, params, rd), calls=PLAIN_RIGID_CALLS)
    times[n, "reset"] = (k, r, lander_kernels.rigid_step_work(n, reset=True))
    for (n, kind), (k, r, work) in times.items():
        print(f"lander_rigid_step (R1) {kind} N={n}: device {k:.2f} us kernel, {r:.2f} us plain "
              f"as a CUDA graph of {PLAIN_RIGID_CALLS} calls ({r / k:.0f}x); "
              f"{bound_text(work, k)} [{card}]")
        if base is not None:
            in_turns(f"N={n} {kind} lander_rigid_step (R1)", calls[n, kind], base,
                     lander_kernels, n, card)
    return times


def _rigid_step(params, state, action, draws, module):
    return module.rigid_step_kernel(state, action, params, draws)


def _rigid_reset(params, terrain, draws, module):
    return module.rigid_reset_kernel(terrain, draws.kick, draws.wind, params)


def in_turns(label: str, call, base, module, n: int, card: str) -> None:
    """``call(module)`` against ``call(base)`` (another checkout's ops
    module): the lanes whose results differ in any bit, and device µs a
    call in turns (baseline, tree, tree, baseline)."""
    differ = lanes_differ(call(base), call(module))
    b0, t0, t1, b1 = [device_us(lambda: call(base if which == "baseline" else module))
                      for which in ("baseline", "tree", "tree", "baseline")]
    print(f"  {label}: baseline {b0:.2f}, {b1:.2f} us; this tree {t0:.2f}, {t1:.2f} us "
          f"(device, in turns; x{(b0 + b1) / (t0 + t1):.2f}); {differ} of {n} lanes differ "
          f"from the baseline's in some bit [{card}]")


@functools.cache
def _composed_lander_type():
    from deep_q_learning_tpu_torch.envs import LunarLander

    class ComposedRigidLander(LunarLander):
        """The rigid lander whose vector step composes: ``VectorEnv._step``'s
        step, ``done`` and selects around ``step`` (by default the plain
        ``step_env_reference`` on either device)."""

        def __init__(self, step=None):
            self.step_fn = step

        def step_env(self, generator, state, action, params, draws=None):
            if self.step_fn is None:
                return self.step_env_reference(generator, state, action, params, draws)
            return self.step_fn(state, action.to(torch.int32), params, draws.contiguous())

        def fuses_vector_step(self, params, state, fresh) -> bool:
            return False

    return ComposedRigidLander


def composed_rigid_lander(step: Optional[Callable] = None, time_feature: bool = True):
    """A rigid lander (in ``TimeFractionObs`` with ``time_feature``, as the
    lander presets run it) whose ``VectorEnv._step`` is the plain
    composition, the step, ``done`` and the auto-reset's selects: around
    the plain ``step_env_reference`` (R1's vector entry's plain version, on
    either device), or around ``step`` (``(state, action, params, draws)
    -> step_env``'s result; another checkout's ``rigid_step_kernel``: that
    checkout's vector step)."""
    from deep_q_learning_tpu_torch.envs import TimeFractionObs

    env = _composed_lander_type()(step)
    return TimeFractionObs(env) if time_feature else env


def graph_replay(fn, replays: int = 4 * GRAPH_REPLAYS) -> tuple:
    """``(device µs, kernels)`` of one replay of a CUDA graph of one call of
    ``fn``: replays back to back between CUDA events, and the kernels of
    the last of :data:`TRACED_REPLAYS` traced replays (which must agree
    with the one before it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    trace = traced_kernels(lambda: [graph.replay() for _ in range(TRACED_REPLAYS)])
    *_, before, last = trace.per_graph_launch
    if before != last:
        raise RuntimeError(f"the profiler recorded {trace.per_graph_launch} kernels in "
                           f"{TRACED_REPLAYS} replays of one graph: its last two must agree")
    return start.elapsed_time(end) * 1e3 / replays, last


def rigid_vector_times(card: str, inputs: Optional[dict] = None,
                       baseline: Optional[Path] = None) -> dict:
    """R1's vector step (``VectorEnv._step`` of the lander presets' rigid
    lander in ``TimeFractionObs`` with a reset pool: one launch) at
    RIGID_SHAPES: device µs a call of the kernel (a CUDA graph of
    GRAPH_CALLS calls) and of its plain composition (a graph of
    PLAIN_RIGID_CALLS calls), beside the bound of its work; then the
    vector step alone as a CUDA graph of one call (its replay's device µs
    and kernels), and with ``baseline`` that checkout's vector step (its R1
    step and the composition's selects around it) in turns (baseline, tree,
    tree, baseline), with the lanes whose results differ in any bit.
    ``inputs`` as :func:`rigid_device_times`'.  Prints a line a shape and
    returns ``{n: (kernel us, plain us, work)}``."""
    from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs, VectorEnv
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws
    from deep_q_learning_tpu_torch.ops import lander_kernels

    base = load_baseline(baseline, "lander_kernels") if baseline is not None else None
    env, params = TimeFractionObs(LunarLander()), rigid_params()
    g = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    for n in RIGID_SHAPES:
        state, action, draws = (inputs[n] if inputs is not None
                                else lander_step_inputs(env.env, params, n, g))
        pool = env.reset_env(None, n, params, sample_reset_draws(g, n))
        prev = torch.zeros_like(pool[0])
        steps = {"tree": VectorEnv(env, n, graphed=False),
                 "plain": VectorEnv(composed_rigid_lander(), n, graphed=False)}
        if base is not None:
            steps["baseline"] = VectorEnv(composed_rigid_lander(base.rigid_step_kernel), n,
                                          graphed=False)

        def call(which):
            out_obs, out_state, tr = steps[which]._step(None, state, action, params, prev, pool,
                                                        draws)
            return (out_obs, out_state, tr.next_obs, tr.reward, tr.terminated, tr.truncated)

        k = device_us(lambda: call("tree"))
        r = device_us(lambda: call("plain"), calls=PLAIN_RIGID_CALLS)
        work = lander_kernels.rigid_step_work(n, vector=True, time_feature=True)
        times[n] = (k, r, work)
        print(f"lander_rigid_step (R1) vector step N={n} (the time feature, a reset pool): device "
              f"{k:.2f} us kernel, {r:.2f} us plain as a CUDA graph of {PLAIN_RIGID_CALLS} calls "
              f"({r / k:.0f}x); {bound_text(work, k)} [{card}]")
        order = ("baseline", "tree", "tree", "baseline") if base is not None else ("tree",)
        graphs = [(which, *graph_replay(lambda: call(which))) for which in order]
        text = "; ".join(f"{which} {us:.2f} us, {kernels} kernels" for which, us, kernels in graphs)
        differ = (f"; {lanes_differ(call('baseline'), call('tree'))} of {n} lanes differ from the "
                  f"baseline's in some bit" if base is not None else "")
        print(f"  N={n} the vector step as a CUDA graph of one call, a replay on the device: "
              f"{text}{differ} [{card}]")
    return times


def classic_pump(kernel: str, state) -> torch.Tensor:
    """The energy-pumping policies of tests/test_torch_envs_classic.py:
    CartPole balanced (push toward the pole's lean), Acrobot's torque along
    the second joint's rate, MountainCar's push along the velocity."""
    if kernel == "cartpole":
        return (state.theta + 0.5 * state.theta_dot > 0).to(torch.int32)
    if kernel == "acrobot":
        return torch.where(state.dtheta2 > 0, 2, 0).to(torch.int32)
    return torch.where(state.velocity >= 0, 2, 0).to(torch.int32)


@functools.cache
def _composed_classic_type(cls):
    class Composed(cls):
        """The env whose vector step composes: ``step_env_reference``,
        ``done``, ``reset_env`` and the selects, on either device."""

        def step_env(self, generator, state, action, params, draws=None):
            return self.step_env_reference(generator, state, action, params, draws)

        def fuses_vector_step(self, params, state, fresh) -> bool:
            return False

    Composed.__name__ = f"Composed{cls.__name__}"
    return Composed


def composed_classic(env, time_feature: bool = False):
    """A classic env of ``env``'s class (in ``TimeFractionObs`` with
    ``time_feature``) whose ``VectorEnv._step`` is the plain composition
    around ``step_env_reference``: the plain version of its kernel's
    vector entry, on either device."""
    from deep_q_learning_tpu_torch.envs import TimeFractionObs

    env = _composed_classic_type(type(env))()
    return TimeFractionObs(env) if time_feature else env


def classic_step_inputs(env, params, n: int, g: torch.Generator, envs: int = CLASSIC_ENVS,
                        frames: int = CLASSIC_FRAMES):
    """``(state, action, ends)`` of ``n`` lanes: pre-step states of a flight
    of ``envs`` envs over ``frames`` frames on ``g``'s device (half on
    :func:`classic_pump`, half on random actions, auto-reset by the plain
    composition), up to half of them lanes whose step ends the episode and
    the rest lanes that go on, in random order; ``ends`` the flight's
    terminated and truncated flags of each lane."""
    from deep_q_learning_tpu_torch.envs import VectorEnv
    from deep_q_learning_tpu_torch.envs.graphed import tree_map

    device = g.device
    plain = VectorEnv(composed_classic(env), envs, graphed=False)
    obs, st = env.reset_env(g, envs, params)
    half = torch.arange(envs, device=device) % 2 == 0
    states, actions, ends = [], [], []
    for _ in range(frames):
        rand = torch.randint(0, env.num_actions, (envs,), generator=g, device=device)
        action = torch.where(half, classic_pump(env.kernel, st), rand).to(torch.int32)
        states.append(tree_map(lambda t: t.contiguous(), st))
        actions.append(action)
        obs, st, tr = plain._step(g, st, action, params, obs, None)
        ends.append(torch.stack([tr.terminated, tr.truncated], 1))
    state = type(st)(**{f.name: torch.cat([getattr(x, f.name) for x in states])
                        for f in dataclasses.fields(st)})
    action, ends = torch.cat(actions), torch.cat(ends)
    ending = ends.any(1)
    pick = lambda idx: idx[torch.randperm(len(idx), generator=g, device=device)]  # noqa: E731
    ended, going = pick(ending.nonzero()[:, 0]), pick((~ending).nonzero()[:, 0])
    k = min(len(ended), n // 2)
    idx = torch.cat([ended[:k], going[:n - k]])
    idx = idx[torch.randperm(n, generator=g, device=device)]
    return tree_map(lambda t: t[idx].contiguous(), state), action[idx], ends[idx]


def classic_params(env, max_steps: Optional[int] = CLASSIC_MAX_STEPS):
    """The env's params with episodes cut at ``max_steps`` (the flights and
    checks of the classic kernels)."""
    params = env.default_params()
    return params if max_steps is None else dataclasses.replace(
        params, max_steps_in_episode=max_steps)


def classic_device_times(card: str, inputs: Optional[dict] = None) -> dict:
    """A1, C1 and M1's vector entries (``VectorEnv._step`` without a pool,
    one launch) at CLASSIC_SHAPES against the plain composition
    (:func:`composed_classic`; the parent commit's vector step): device µs
    a call of the kernel (a CUDA graph of GRAPH_CALLS calls) and of the
    plain version (a graph of PLAIN_CLASSIC_CALLS calls), beside the bound
    of the call's work (``classic_kernels.classic_step_work``); then the
    vector step alone as a CUDA graph of one call (the frame graph's env
    part), replayed in turns (plain, kernel, kernel, plain), with its
    kernels.  ``inputs`` maps ``(env, n)`` to ``(state, action)``; by
    default the states of a flight (:func:`classic_step_inputs`).  Prints a
    line a shape and returns ``{(env, n): (kernel us, plain us, work)}``,
    env the kernel's key (``classic_kernels.SPECS``)."""
    from deep_q_learning_tpu_torch.envs import VectorEnv, make_env
    from deep_q_learning_tpu_torch.ops import classic_kernels as ck

    g = torch.Generator(device="cuda").manual_seed(2)
    times = {}
    for key, spec in ck.SPECS.items():
        env, _ = make_env(spec.env_id)
        params = classic_params(env)
        for n in CLASSIC_SHAPES:
            state, action = (inputs[key, n] if inputs is not None
                             else classic_step_inputs(env, params, n, g)[:2])
            draws = env.reset_draws(g, n)
            prev = torch.zeros((n, spec.obs), device="cuda")
            steps = {"kernel": VectorEnv(env, n, graphed=False),
                     "plain": VectorEnv(composed_classic(env), n, graphed=False)}

            def call(which):
                out_obs, out_state, tr = steps[which]._step(None, state, action, params, prev,
                                                            None, None, draws)
                return out_obs, out_state, tr.next_obs, tr.reward, tr.terminated, tr.truncated

            k = device_us(lambda: call("kernel"))
            r = device_us(lambda: call("plain"), calls=PLAIN_CLASSIC_CALLS)
            work = ck.classic_step_work(key, n, vector=True)
            times[key, n] = (k, r, work)
            print(f"{key}_step vector step N={n} (the resets from their draws, no pool): device "
                  f"{k:.2f} us kernel, {r:.2f} us plain as a CUDA graph of {PLAIN_CLASSIC_CALLS} "
                  f"calls ({r / k:.0f}x); {bound_text(work, k)} [{card}]")
            graphs = [(which, *graph_replay(lambda: call(which)))
                      for which in ("plain", "kernel", "kernel", "plain")]
            text = "; ".join(f"{which} {us:.2f} us, {kernels} kernels"
                             for which, us, kernels in graphs)
            print(f"  N={n} the vector step as a CUDA graph of one call, a replay on the device, "
                  f"in turns: {text} [{card}]")
    return times


def jointed_params(enable_wind: bool = False, max_steps: Optional[int] = None):
    """The jointed lander's params of the jointed presets ((120, 40) passes,
    the wind off), or with the wind on, and another episode limit."""
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLanderParams

    params = LunarLanderParams(vel_iters=120, pos_iters=40, enable_wind=enable_wind)
    if max_steps is not None:
        params = dataclasses.replace(params, max_steps_in_episode=max_steps)
    return params


def jointed_device_times(card: str, inputs: Optional[dict] = None,
                         baseline: Optional[Path] = None) -> dict:
    """J1 and its plain version at JOINTED_SHAPES, the wind off and on, and
    the reset frame: device µs a call of the kernel (a CUDA graph of
    GRAPH_CALLS calls) and of the plain version (a graph of one call
    replayed PLAIN_JOINTED_REPLAYS times), beside the bound of the call's
    work (``jointed_kernels.jointed_step_work`` at the position passes each
    env ran, ``jointed_kernels.position_passes``), the slowest env's
    velocity and position passes (every env runs ``vel_iters`` velocity
    passes: ``vel_tol`` is 0) and the kernel's µs a pass of that env.
    ``inputs`` maps each (N, wind) to ``step_env``'s ``(state, action,
    draws)``; by default the states of a flight of landers
    (``envs/heuristic.py::lander_step_inputs`` with the jointed engine).
    The reset's plain version is the whole ``reset_env_reference``, its
    terrain smoothing included.  With ``baseline`` (a checkout,
    :func:`load_baseline`), that checkout's J1 is timed too, in turns with
    this tree's (baseline, tree, tree, baseline), with the count of lanes
    whose result differs from the baseline's in any bit.  Prints a line a
    shape and returns ``{(n, kind): (kernel us, plain us, work)}``, kind
    ``"step"``, ``"wind"`` or ``"reset"``."""
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws, smoothed_terrain
    from deep_q_learning_tpu_torch.ops import jointed_kernels

    base = load_baseline(baseline, "jointed_kernels") if baseline is not None else None
    env = LunarLander()
    g = torch.Generator(device="cuda").manual_seed(0)
    times, calls, passes = {}, {}, {}
    for n in JOINTED_SHAPES:
        for wind in (False, True):
            params = jointed_params(wind)
            state, action, draws = (inputs[n, wind] if inputs is not None
                                    else lander_step_inputs(env, params, n, g, envs=n, frames=60))
            ran = jointed_kernels.position_passes(params, state, action, draws)
            key = n, "wind" if wind else "step"
            calls[key] = functools.partial(_jointed_step, params, state, action, draws)
            k = device_us(lambda: jointed_kernels.jointed_step_kernel(state, action, params, draws))
            r = device_us(lambda: env.step_env_reference(None, state, action, params, draws),
                          calls=1, replays=PLAIN_JOINTED_REPLAYS)
            work = jointed_kernels.jointed_step_work(n, params.vel_iters, ran, wind)
            times[key], passes[key] = (k, r, work), (params.vel_iters, int(ran.max()))
        params = jointed_params()
        rd = sample_reset_draws(g, n)
        terrain = smoothed_terrain(rd.terrain, params)
        calls[n, "reset"] = functools.partial(_jointed_reset, params, terrain, rd)
        k = device_us(lambda: jointed_kernels.jointed_reset_kernel(terrain, rd, params))
        r = device_us(lambda: env.reset_env_reference(None, n, params, rd), calls=1,
                      replays=PLAIN_JOINTED_REPLAYS)
        ran = jointed_kernels.position_passes(params, terrain=terrain, reset_draws=rd)
        times[n, "reset"] = (k, r, jointed_kernels.jointed_step_work(
            n, params.vel_iters, ran, reset=True))
        passes[n, "reset"] = (params.vel_iters, int(ran.max()))
    assert jointed_params().vel_tol == 0.0, "every env runs vel_iters velocity passes"
    for (n, kind), (k, r, work) in times.items():
        vel, pos = passes[n, kind]
        print(f"lander_jointed_step (J1) {kind} N={n} (120, 40): device {k:.2f} us kernel, "
              f"{r:.2f} us plain (S1 inside) as a CUDA graph of one call ({r / k:.1f}x); "
              f"{bound_text(work, k)}; the slowest env's passes ({vel}, {pos}), "
              f"{k / (vel + pos):.3f} us a pass [{card}]")
        if base is not None:
            in_turns(f"N={n} {kind} lander_jointed_step (J1)", calls[n, kind], base,
                     jointed_kernels, n, card)
    return times


def _jointed_step(params, state, action, draws, module):
    return module.jointed_step_kernel(state, action, params, draws)


def _jointed_reset(params, terrain, draws, module):
    return module.jointed_reset_kernel(terrain, draws, params)


def lanes_differ(a, b) -> int:
    """Lanes of two results of a lander kernel (S1's ``assembly_step``, R1's
    or J1's step, reset frame or vector step) that differ in any bit of
    any output."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    x, y = tree_leaves(list(a)), tree_leaves(list(b))
    n = x[0].shape[0]
    differ = torch.zeros(n, dtype=torch.bool, device=x[0].device)
    for p, q in zip(x, y):
        if p.is_floating_point():
            p, q = p.view(torch.int32), q.view(torch.int32)
        differ |= (p != q).reshape(n, -1).any(1)
    return int(differ.sum())


def kernel_device_times(card: str, baseline: Optional[Path] = None) -> None:
    from deep_q_learning_tpu_torch.ops import sample_kernels as sk
    from deep_q_learning_tpu_torch.ops import td_kernels as tk

    per_superstep = launches_per_superstep()
    print(f"kernel launches per steady superstep, by preset: {per_superstep}")
    solver_device_times(card, baseline=baseline)
    rigid_device_times(card, baseline=baseline)
    rigid_vector_times(card, baseline=baseline)
    jointed_device_times(card, baseline=baseline)
    classic_device_times(card)
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
    m, n, c, b = MEMBER_SLOT
    p = torch.rand((m * n, c), generator=g, device="cuda") ** 3
    env = torch.randint(0, n, (m, b), generator=g, device="cuda")
    u = torch.rand((m, b), generator=g, device="cuda")
    flat_env = (env + torch.arange(m, device="cuda")[:, None] * n).reshape(-1)
    k = device_us(lambda: sk.slot_select_members(p, env, u))
    r = device_us(lambda: sk.slot_select_reference(p, flat_env, u.reshape(-1)))
    print(f"per_slot_sample over {m} members (M·N, C, M·B)=({m * n}, {c}, {m * b}): device "
          f"{k:.2f} us kernel, {r:.2f} us plain; {bound_text(sk.per_slot_sample_work(p, flat_env), k)} "
          f"[{card}]")
    m, b, a = MEMBER_TD
    q_both = torch.randn((m, 2 * b, a), generator=g, device="cuda")
    args = (q_both[:, :b], q_both[:, b:], torch.randn((m, b, a), generator=g, device="cuda"),
            torch.randint(0, a, (m, b), generator=g, device="cuda", dtype=torch.int32),
            *(torch.rand((m, b), generator=g, device="cuda") for _ in range(3)), 1.0, True)
    _, td = tk.td_loss_fwd(*args)
    ones = torch.ones((m,), device="cuda")
    fwd = device_us(lambda: tk.td_loss_fwd(*args))
    bwd = device_us(lambda: tk.td_loss_bwd(td, args[3], args[6], ones, a, 1.0, out_rows=2 * b))
    print(f"td_loss_fwd (M, B, A)=({m}, {b}, {a}): device {fwd:.2f} us kernel, "
          f"{device_us(lambda: tk.td_loss_reference(*args)):.2f} us plain; "
          f"{bound_text(tk.td_loss_fwd_work(b, a, members=m), fwd)} [{card}]")
    plain_bwd = device_us(lambda: tk.td_loss_backward_reference(
        td, args[3], args[6], ones, a, 1.0, out_rows=2 * b))
    print(f"td_loss_bwd (M, B, A)=({m}, {b}, {a}) -> ({m}, {2 * b}, {a}): device {bwd:.2f} us "
          f"kernel, {plain_bwd:.2f} us plain; "
          f"{bound_text(tk.td_loss_bwd_work(b, a, 2 * b, members=m), bwd)} [{card}]")

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


# the reset runs as one pool per superstep (fresh_pool: the lander) or, for
# cheap resets (classic control), inside every venv.step: its draw taken
# before the step's graph (env.reset_draws), or eagerly (env.reset_batch),
# a span nested in venv.step's
PHASES = {
    "venv": ("fresh_pool", "step"),
    "env": ("reset_batch", "reset_draws"),
    "replay": ("add", "sample_with_info", "update_priorities"),
    "optimizer": ("apply",),
}


def _span(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    wrapped.__wrapped__ = fn
    return wrapped


# the learner's kernels by their names in the profiler's trace
LEARNER_KERNELS = {"td_loss_fwd": ("td_loss_fwd_kernel",), "td_loss_bwd": ("td_loss_bwd_kernel",),
                   "per_slot_sample": ("slot_warp_kernel", "slot_block_kernel")}
# the envs' kernels by their names in the profiler's trace: R1 (the rigid
# lander's step), J1 (the jointed lander's), S1 (the jointed solver's
# alone, which J1 runs inside it), and A1, C1 and M1 (the classic envs')
ENV_KERNELS = {"lander_rigid_step": ("rigid_step_kernel",),
               "lander_jointed_step": ("jointed_step_kernel",),
               "assembly_step": ("assembly_step_kernel",),
               "acrobot_step": ("acrobot_kernel",), "cartpole_step": ("cartpole_kernel",),
               "mountain_car_step": ("mountain_car_kernel",)}
# the host's calls that put work on the card one by one
HOST_LAUNCHES = {"kernels": ("cudaLaunchKernel", "cuLaunchKernel"), "graphs": ("cudaGraphLaunch",),
                 "copies and fills": ("cudaMemcpyAsync", "cudaMemsetAsync")}


def host_launches(events) -> dict:
    """The host's launches in ``key_averages()`` ``events``, by kind
    (:data:`HOST_LAUNCHES`)."""
    return {kind: sum(e.count for e in events if e.key.startswith(names))
            for kind, names in HOST_LAUNCHES.items()}


def learner_kernels(trace: "KernelTrace") -> dict:
    """K1, K2 and K3 in a :class:`KernelTrace`, launched or in a graph."""
    return {name: sum(trace.count(k) for k in kernels) for name, kernels in LEARNER_KERNELS.items()}


def learner_graphs(superstep) -> dict:
    """The learner's CUDA graphs of a superstep that is a ``GraphedLearner``
    or a ``GraphedPopulation`` (none otherwise), by what they run; a rank's
    update is two graphs, its local gradients and its step on the mean."""
    graphs = (("frame", "frame"), ("learner update", "learn"),
              ("learner step on the mean", "learn_mean"))
    return {k: g for k, g in ((k, getattr(superstep, name, None)) for k, name in graphs)
            if g is not None and g.graph is not None}


# the learner's graph launches, by the spans around them: the frame's and the
# update's, frame by frame, and the superstep's graph with its host mirrors
GRAPH_SPANS = {"frame": "phase/graph.frame", "learn": "phase/graph.learn",
               "replay_superstep": "phase/graph.superstep"}
# supersteps run before the profiled one, at most: until the next superstep's
# cadence has its graph (warm-up, its end, the steady cadence frame by frame,
# its capture)
WARM_SUPERSTEPS = 8


def warm_up(step: Callable[[], object], superstep, runner: Callable[[], object]) -> int:
    """Supersteps of ``step()`` until the next one replays its superstep's
    graph (a ``GraphedLearner``'s ``superstep`` bound to ``runner()``), at
    least 2, at most WARM_SUPERSTEPS; without one, 2.  Returns how many."""
    for n in range(1, WARM_SUPERSTEPS + 1):
        step()
        if n >= 2 and (superstep_graph(superstep, runner()) is not None
                       or not hasattr(superstep, "supersteps")):
            return n
    return WARM_SUPERSTEPS


def superstep_graph(superstep, r):
    """The graph that ``superstep``'s next superstep of ``r`` replays, or None."""
    if not hasattr(superstep, "supersteps"):
        return None
    graph = superstep.supersteps.get(superstep.key(r))
    return None if graph is None else graph[0]


def superstep_line(superstep, graph, card: str, replays: int = 2) -> None:
    """The superstep graph's nodes, capture and instantiation seconds, its
    device time alone (CUDA events over ``replays`` replays, each applying a
    superstep past the runner's counters: last), and the share of
    supersteps that ran as one replay."""
    runs = superstep.runs
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.graph.replay()
    end.record()
    end.synchronize()
    print(f"superstep graph: {graph.nodes} nodes, captured in {graph.capture_s:.3f} s, "
          f"instantiated in {graph.instantiate_s:.3f} s, replay alone "
          f"{start.elapsed_time(end) / replays:.3f} ms on the device (CUDA events over "
          f"{replays}); supersteps run as one replay {runs['whole']} of "
          f"{runs['whole'] + runs['frames']} [{card}]")


def profile_superstep(cfg, card: str, graphed: bool = True, graphed_learner: bool = True) -> None:
    from deep_q_learning_tpu_torch.train import Trainer

    trainer = Trainer(cfg, device="cuda", graphed=graphed,
                      graphed_learner=graphed_learner).init(seed=0)
    learner = type(trainer._superstep).__name__ == "GraphedLearner"
    mode = ("graphed learner" if learner else "eager learner, graphed env step"
            if trainer.venv.graphed else "eager")
    for owner, methods in PHASES.items():  # the superstep calls these by attribute
        obj = getattr(trainer, owner)
        for m in methods:
            setattr(obj, m, _span(getattr(obj, m), f"phase/{owner}.{m}"))
    warm = warm_up(trainer.step, trainer._superstep, lambda: trainer.runner)
    graph = superstep_graph(trainer._superstep, trainer.runner)
    for name, span in GRAPH_SPANS.items() if learner else ():
        setattr(trainer._superstep, name, _span(getattr(trainer._superstep, name), span))
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
    launches = host_launches(events)
    kernels = {name: sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                         and any(k in e.key for k in names))
               for name, names in {**LEARNER_KERNELS, **ENV_KERNELS}.items()}
    frames = cfg.steps_per_superstep
    if graph is not None:
        mode += ", one replay of its graph"
    print(f"profiled superstep ({mode}, after {warm} supersteps): wall {wall * 1e3:.1f} ms, "
          f"{m.loss_count} updates, "
          f"device busy {device_us_total / 1e3:.1f} ms ({100 * device_us_total / 1e6 / wall:.1f} %), "
          f"host launches {launches}: {sum(launches.values()) / frames:.1f} per vector step; "
          f"the learner's and the env's kernels on the device {kernels} [{card}]")
    if learner:
        for name in GRAPH_SPANS:
            setattr(trainer._superstep, name, getattr(trainer._superstep, name).__wrapped__)
    spans = sorted((e for e in events if e.key.startswith("phase/")
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: -e.cpu_time_total)
    for e in spans:
        print(f"  {e.key[6:]:28s} {e.cpu_time_total / 1e3:9.1f} ms host "
              f"({100 * e.cpu_time_total / 1e6 / wall:.1f} %), {e.count} calls")

    graphs = {kind: g for (kind, *_), g in trainer.venv._graphs.items()}
    graphs.update(learner_graphs(trainer._superstep))  # last: their replays write the runner
    unprofiled(trainer.step, frames, cfg.num_envs, mode, graphs, card)
    if graph is not None:
        superstep_line(trainer._superstep, graph, card)


def unprofiled(step: Callable[[], object], frames: int, envs: int, mode: str, graphs: dict,
               card: str) -> None:
    """Two supersteps of ``step()`` (``frames`` vector steps of ``envs``
    envs each, all members') timed on the host clock, then each of
    ``graphs`` replayed alone (:func:`replay_ms`), in order."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"unprofiled superstep ({mode}): {walls[-1] * 1e3:.1f} ms, "
              f"{frames * envs / walls[-1]:.1f} env-steps/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")
    frame_ms = 1e3 * min(walls) / frames
    for kind, g in graphs.items():
        host_ms, device_ms, nodes = replay_ms(g)
        print(f"graph of the {kind}: replay {device_ms:.3f} ms on the device (CUDA events over "
              f"{REPLAYS} back-to-back replays), {nodes} kernels, its launch {host_ms:.3f} ms of "
              f"host, captured in {g.capture_s:.3f} s after a {g.warmup_s:.3f} s eager call; a "
              f"frame of the faster unprofiled superstep {frame_ms:.3f} ms of wall, so one "
              f"replay is {100 * device_ms / frame_ms:.1f} % of it [{card}]")


def profile_population(cfg, members: int, card: str, graphed_learner: bool = True) -> None:
    """The population superstep of ``members`` learners of ``cfg``, as
    :func:`profile_superstep` measures a single learner's: one steady
    superstep traced (:func:`traced_kernels`: the host's launches a vector
    step, K1-K3 on the device, the busy share), then two unprofiled
    (aggregate env-steps/s, peak memory) and each graph's replay."""
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer

    trainer = PopulationTrainer(cfg, members, eval_envs=1, device="cuda",
                                graphed_learner=graphed_learner)
    graphed = type(trainer._step).__name__ == "GraphedPopulation"
    mode = (f"{members} members, " + ("graphed population" if graphed
                                      else "eager population, graphed env step"))
    runner = trainer.init(seed=0)
    warm = warm_up(lambda: trainer.step(runner), trainer._step, lambda: runner)
    graph = superstep_graph(trainer._step, runner)
    if graph is not None:
        mode += ", one replay of its graph"
    metrics = []
    trace = traced_kernels(lambda: metrics.append(trainer.step(runner)[1]))
    frames = cfg.steps_per_superstep
    print(f"profiled superstep ({mode}, after {warm} supersteps): wall "
          f"{trace.wall_us / 1e3:.1f} ms, updates "
          f"{metrics[-1].loss_count.tolist()}, device busy {trace.device_us / 1e3:.1f} ms "
          f"({100 * trace.device_us / trace.wall_us:.1f} %), host launches "
          f"{trace.host_launches / frames:.1f} per vector step ({trace.launches} kernels, "
          f"{len(trace.per_graph_launch)} graphs, {trace.copies} copies and fills); the "
          f"learner's kernels on the device {learner_kernels(trace)} [{card}]")
    graphs = {}
    if graphed:
        venv = trainer._step.work.venv
        graphs = {kind: g for (kind, *_), g in venv._graphs.items()}
        graphs.update(learner_graphs(trainer._step))
    unprofiled(lambda: trainer.step(runner), frames, cfg.num_envs * members, mode, graphs, card)
    if graph is not None:
        superstep_line(trainer._step, graph, card)


REPLAYS = 5


# Kernel launches of a profiling session's own before the span it counts:
# on the H100 the profiler has recorded no kernel for the first launches of
# a session (3-6 in most of chip_smoke.py's; the kernels ran: their outputs
# were checked bitwise), so they fall outside the span
WARM_LAUNCHES = 32
# Idle seconds of a profiling session before and after the span it counts:
# the profiler has dropped the records of launches made within a few ms of
# a session's start (after its warm-up launches) or of its end, most often
# late in a long process; the session holds its ends away from the span's
# launches
PAD_S = 0.05
SPAN = "traced_kernels"
# replays in the span that counts a graph's kernels: the last two must agree
TRACED_REPLAYS = 4


@dataclasses.dataclass
class KernelTrace:
    """The kernels a call ran on the card, by name, from the profiler's
    trace: those the host launched one by one (``launched``, ``launches``
    calls) and those of the CUDA graphs it launched (``graphed``; and
    ``per_graph_launch``, their count for each graph launch in order).
    ``copies`` counts the host's copy and fill calls, ``device_us`` the
    device time of the kernels, copies and fills matched to the span's
    calls, ``wall_us`` the span's wall time on the host, ``lost_at_us``
    when each launch with no kernel in the trace (a kernel launch or a
    graph launch) was made, in µs after the span began, ``lost_in`` that
    launch's API call and the innermost host op around it, and
    ``orphans`` the kernels of the session whose correlation id matches
    no host call in the trace, by name."""

    launches: int
    launched: collections.Counter
    graphed: collections.Counter
    per_graph_launch: list
    copies: int = 0
    device_us: float = 0.0
    wall_us: float = 0.0
    lost_at_us: list = dataclasses.field(default_factory=list)
    lost_in: list = dataclasses.field(default_factory=list)
    orphans: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def host_launches(self) -> int:
        """Everything the host put on the card one call at a time: kernels,
        CUDA graphs, copies and fills."""
        return self.launches + len(self.per_graph_launch) + self.copies

    @property
    def lost(self) -> int:
        """Host launches with no kernel in the trace."""
        return self.launches - sum(self.launched.values())

    def count(self, name: str) -> int:
        """The kernels whose name holds ``name``, launched or in a graph."""
        return sum(c for k, c in (self.launched + self.graphed).items() if name in k)


def traced_kernels(fn: Callable[[], object], pad_s: float = PAD_S) -> KernelTrace:
    """What ``fn()`` ran on the card, under ``torch.profiler``: every
    kernel launch call and CUDA graph launch the host made inside a span
    around ``fn()`` (and a sync), and the kernels matched to them by the
    trace's correlation ids; the kernels of a graph's replay carry the
    graph launch's.  Copies and fills are not kernels; host API calls
    (``cuLaunchKernel`` of cuBLAS among them) are never counted as
    kernels, whatever the profiler's summary makes of them.  The session
    stays idle ``pad_s`` seconds after its warm-up launches and again after
    the span."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(WARM_LAUNCHES):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        with torch.profiler.record_function(SPAN):
            fn()
            torch.cuda.synchronize()
        time.sleep(pad_s)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e["name"] == SPAN and e.get("cat") != "gpu_user_annotation")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    calls = [e for e in events if e.get("cat", "").startswith("cuda_") and t0 <= e["ts"] <= t1]
    # cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel, ...; cudaGraphLaunch
    launch_ids = {e["args"]["correlation"] for e in calls if "LaunchKernel" in e["name"]}
    graph_ids = [e["args"]["correlation"] for e in sorted(calls, key=lambda e: e["ts"])
                 if "GraphLaunch" in e["name"]]
    copy_ids = {e["args"]["correlation"] for e in calls
                if e["name"].startswith(("cudaMemcpy", "cudaMemset"))}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_id = collections.Counter(e["args"]["correlation"] for e in kernels)
    ours = launch_ids | set(graph_ids) | copy_ids
    launched = launch_ids | set(graph_ids)
    lost = sorted((e for e in calls
                   if e["args"]["correlation"] in launched and not by_id[e["args"]["correlation"]]),
                  key=lambda e: e["ts"])
    ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]

    def op_around(call) -> str:
        around = [op for op in ops if op["tid"] == call["tid"]
                  and op["ts"] <= call["ts"] <= op["ts"] + op["dur"]]
        return min(around, key=lambda op: op["dur"])["name"] if around else "no op"

    host_ids = {e["args"]["correlation"] for e in events
                if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    return KernelTrace(
        launches=sum("LaunchKernel" in e["name"] for e in calls),
        launched=collections.Counter(
            e["name"] for e in kernels if e["args"]["correlation"] in launch_ids),
        graphed=collections.Counter(
            e["name"] for e in kernels if e["args"]["correlation"] in set(graph_ids)),
        per_graph_launch=[by_id[i] for i in graph_ids],
        copies=len(copy_ids),
        device_us=sum(e["dur"] for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                      and e.get("args", {}).get("correlation") in ours),
        wall_us=span["dur"],
        lost_at_us=[e["ts"] - t0 for e in lost],
        lost_in=[f"{e['name']} in {op_around(e)}" for e in lost],
        orphans=collections.Counter(e["name"] for e in kernels
                                    if e["args"]["correlation"] not in host_ids))


def replay_ms(graphed) -> tuple:
    """``(host ms, device ms, kernels)`` of one replay of a captured
    ``envs/graphed.py::GraphedStep`` on its static inputs: the host time of
    the ``replay()`` call (its launch) and the device time between two CUDA
    events around ``REPLAYS`` replays back to back, each averaged, and the
    kernels one replay ran on the card (:func:`traced_kernels` of
    ``TRACED_REPLAYS`` replays: late in a long process the profiler has
    also lost records of a profiling session's first replay, so the last
    two replays must agree, and give the count).  A functional step's
    inputs are not changed, so its outputs are recomputed as they were; an
    in-place step's replays each apply its work again (a frame, an update)
    to the tensors it is bound to, past their host counters."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graphed.graph.replay()  # past a first launch's upload
    torch.cuda.synchronize()
    host = 0.0
    start.record()
    for _ in range(REPLAYS):
        t0 = time.perf_counter()
        graphed.graph.replay()
        host += time.perf_counter() - t0
    end.record()
    end.synchronize()
    trace = traced_kernels(lambda: [graphed.graph.replay() for _ in range(TRACED_REPLAYS)])
    *_, before, last = trace.per_graph_launch
    if before != last:
        raise RuntimeError(f"the profiler recorded {trace.per_graph_launch} kernels in "
                           f"{TRACED_REPLAYS} replays of one graph: its last two must agree")
    return 1e3 * host / REPLAYS, start.elapsed_time(end) / REPLAYS, last


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
    graphed_vector_step(env, params, n, g, st, card)


def graphed_vector_step(env, params, n: int, g: torch.Generator, st, card: str):
    """The env's vector step with its auto-reset as ``VectorEnv`` runs it
    in a CUDA graph (the learner's frame graph holds the same kernels), from
    a reset pool where the env's reset is not cheap (the lander) and from
    the reset's draws, taken before the graph, where it is (the classic
    envs): its replay alone (:func:`replay_ms`: device ms, kernels, the
    host's launch) and the env kernels among its kernels.  Returns
    ``(device ms, kernels, {env kernel: count})``, or None for an env that
    does not graph."""
    from deep_q_learning_tpu_torch.envs import VectorEnv

    venv = VectorEnv(env, n)
    if not venv.graphed:
        return None
    pool = None if env.batch_reset_cheap else venv.fresh_pool(g, params)
    obs = env.get_obs(st, params)
    actions = torch.randint(0, env.num_actions, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
    for _ in range(2):  # the capture, then a replay
        obs, st, _ = venv.step(g, st, actions, params, prev_obs=obs, fresh=pool)
    kind = "step" if pool is not None else "step with resets"
    step = next(graph for (k, *_), graph in venv._graphs.items() if k == kind)
    host_ms, device_ms, nodes = replay_ms(step)
    trace = traced_kernels(step.graph.replay)
    kernels = {name: sum(trace.count(k) for k in names) for name, names in ENV_KERNELS.items()}
    reset = "from the pool" if pool is not None else "from the reset's draws"
    print(f"the vector step's graph (auto-reset {reset} included): replay {device_ms:.3f} "
          f"ms on the device, {nodes} kernels, the env's among them {kernels}, its launch "
          f"{host_ms:.3f} ms of host [{card}]")
    return device_ms, nodes, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deep_q_learning_tpu_torch.measure")
    ap.add_argument("--preset", default="lunar_per_scaled")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--env-only", action="store_true",
                    help="time the preset's env alone instead of kernels and a superstep")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels and count a learner update's launches, "
                         "without the superstep")
    ap.add_argument("--eager", action="store_true",
                    help="run the superstep eagerly, its env step too (graphed=False)")
    ap.add_argument("--eager-learner", action="store_true",
                    help="run the frame eagerly around the env step's graph "
                         "(graphed_learner=False)")
    ap.add_argument("--pairs", action="store_true",
                    help="only the superstep, with the graphed learner and the eager one in "
                         "turns (graphed, eager, eager, graphed) in this process")
    ap.add_argument("--members", type=int, metavar="M",
                    help="measure the superstep of a population of M learners of the preset "
                         "instead of one learner's")
    ap.add_argument("--baseline", type=Path, metavar="CHECKOUT",
                    help="also time the TD and PER slot kernels of another checkout of "
                         "the port, in turns with this tree's")
    args = ap.parse_args(argv)
    if args.members and args.eager:
        ap.error("--members runs the env step graphed: use --eager-learner")
    if args.pairs and (args.members or args.eager or args.eager_learner or args.env_only
                       or args.kernels_only or args.baseline):
        ap.error("--pairs measures one learner's superstep, graphed and eager, alone")
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
    if args.pairs:
        for graphed_learner in (True, False, False, True):
            profile_superstep(cfg, card, graphed_learner=graphed_learner)
        return 0
    kernel_device_times(card, args.baseline)
    learner_launches(card, args.baseline)
    if args.members:
        profile_population(cfg, args.members, card, graphed_learner=not args.eager_learner)
    elif not args.kernels_only:
        profile_superstep(cfg, card, graphed=not args.eager,
                          graphed_learner=not args.eager_learner)
    return 0


if __name__ == "__main__":
    sys.exit(main())
