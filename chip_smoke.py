#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from deep_q_learning_tpu_torch/csrc with nvcc,
     one nvcc per source, all started together; print each kernel's
     registers and shared memory from ptxas, and fail on a spill;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it (the TD kernels at B = 256, 1024, 4096,
     300 and 37, both targets, the clip case, rows that are not 16-byte
     aligned; the backward writing q_both's (2B, A) gradient), check that
     the TD forward's loss is bitwise stable over 100 calls at B = 4096 and
     its ticket counter is 0 after a CUDA-graph replay; the PER slot kernel
     at (N, C, B) = (1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096),
     (5, 37, 64) on rows that are not 16-byte aligned and (3, 20000, 64)
     (the chunk loop), on dyadic and random priorities, the edge cases (u =
     0, 1.0 and 1.5, an all-zero row, rows outside [0, N)) on every path,
     and its slots bitwise stable over 100 calls and a CUDA-graph replay;
     time kernel and plain version with CUDA events, and print each
     kernel's bound, its share of it, and its launches per superstep on
     each preset;
  4. run the ``lunar_per`` slice at full width through ``Trainer``: 4
     supersteps (512 vector steps of 128 envs), then check that the TD
     kernels ran once per learner update, the loss is finite, the online
     net trained, the target followed by Polyak averaging, and a greedy
     evaluation returns finite returns; then one learner update on the
     card is held against the same update on the CPU;
  5. run ``lunar_per_scaled(1024)`` with ``use_pallas_sampler=True`` at
     full width through ``Trainer``: 2 supersteps (256 vector steps of
     1024 envs), and check that the PER slot kernel and the TD kernels ran
     once per learner update and no plain version ran;
  6. drive the same configuration through the command line: ``train`` one
     superstep with a checkpoint, ``train --resume`` one more, ``eval``;
  7. run ``lunar_jointed_per`` (the jointed 3-body lander, solver
     iterations (120, 40)) at full width through ``Trainer``: 2 supersteps
     of 16 vector steps of 128 envs, learning from 2048 stored
     transitions; check the TD kernels ran once per learner update with no
     plain call, the counters, a finite loss, the online net trained and
     the target followed; print env-steps/s and the kernel launches of one
     jointed vector step; a greedy evaluation cut at 4 frames; then one
     jointed frame of 64 landers from a short flight near the ground
     (touchdowns, contacts, crashes) on the card against the same frame on
     the CPU;
  8. print the kernels' record as one JSON line (with each kernel's bound,
     ``bound_ms``), then the result line.

It imports nothing of JAX or of the JAX package, and exits non-zero
without printing a result where CUDA is absent.
"""

import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # loss and td: the kernel sums in another order
DQ_TOL = dict(rtol=1e-5, atol=1e-7)
TD_SOURCE = "deep_q_learning_tpu_torch/csrc/td_loss.cu"
PER_SOURCE = "deep_q_learning_tpu_torch/csrc/per_sample.cu"
TD_SHAPES = [(256, 4), (1024, 4), (4096, 4), (300, 4), (37, 2)]
# B of lunar_per and lunar_jointed_per, lunar_per_scaled(1024), lunar_per_scaled(4096)
TD_TIMED = (256, 1024, 4096)
TD_STABLE_B, TD_STABLE_CALLS = 4096, 100
SUPERSTEPS = 4
SCALED_SUPERSTEPS = 2
# (N, C, B): lunar_per_scaled(1024), lunar_per, lunar_per_scaled(4096) (C = 2^19 / 4096),
# then C % 4 != 0 on misaligned rows (the scalar path) and C past 1024 * 16 (the chunk loop)
SLOT_SHAPES = [(1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096), (5, 37, 64), (3, 20000, 64)]
SLOT_TIMED = SLOT_SHAPES[:3]
SLOT_MISALIGNED = (5, 37, 64)
# the kernel's plan at each shape: threads per draw, values a thread, float4 loads, chunks
SLOT_PLANS = {
    (1024, 512, 1024): (32, 16, True, 1),
    (128, 4096, 256): (256, 16, True, 1),
    (4096, 128, 4096): (32, 4, True, 1),
    (5, 37, 64): (32, 4, False, 1),
    (3, 20000, 64): (1024, 16, True, 2),
}
SLOT_EDGE_C = (200, 37, 300, 4096, 20000)  # the edge cases on every path: V = 8, 4 scalar, 12, block, chunks
SLOT_STABLE_CALLS = 100
SLOT_ULPS = 8  # random priorities: a slot may differ only within 8 ulps of a prefix
SLOT_SHARE_DRAWS = 1024  # ... and in under 1 % of at least this many draws, in calls of B
REPO = Path(__file__).resolve().parent
SCALED_SETS = ["use_pallas_sampler=true"]  # the CLI's overrides of lunar_per_scaled
# lunar_jointed_per cut in depth only: the width and the solver iterations
# are the preset's (never below ~60 velocity iterations: the joints give way)
JOINTED_CUTS = dict(steps_per_superstep=16, training_start=2048)
JOINTED_SUPERSTEPS = 2
JOINTED_EVAL_FRAMES = 4  # Trainer.evaluate's default runs max_steps_in_episode = 1000 frames
FRAME_ENVS, FRAME_FLIGHT = 64, 30
# one jointed frame, card vs CPU.  XLA, the CPU and the card round float32
# differently in the last ulp, and the solver's iterations carry that far on
# hard impacts; the CPU tests measure how far against a float64 evaluation
# (tests/test_torch_lander_solver.py).  So: the CPU tests' tight tolerances on
# at least 90 % of the lanes, and every lane within 4x the largest float32
# error measured there.
FRAME_TOL = {  # kind: (tight atol, tight rtol, every-lane atol)
    "position": (1e-5, 0.0, 1.2e-4),
    "velocity": (1e-4, 0.0, 3e-2),
    "accumulator": (1e-5, 1e-4, 2e-2),
    "obs": (1e-5, 0.0, 2e-3),
    "reward": (1e-4, 0.0, 5e-2),
}
FRAME_TIGHT_SHARE = 0.9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def td_inputs(torch, b, a, seed, reward_shift=0.0):
    """The TD kernels' inputs as the learner gives them: ``q_s`` and
    ``q_next_online`` are the two halves of one (2B, A) ``q_both``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    q_both = randn(2 * b, a)
    return [
        q_both[:b], q_both[b:], randn(b, a),
        torch.randint(0, a, (b,), generator=g, device="cuda", dtype=torch.int32),
        randn(b) + reward_shift,
        0.97 * (torch.rand(b, generator=g, device="cuda") > 0.3).float(),
        torch.rand(b, generator=g, device="cuda") + 0.1,
    ]


TIMED_CALLS = 2000


def time_ms(torch, fn, iters=TIMED_CALLS, warmup=50) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose rows are not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def check_td_case(torch, td_kernels, args, a, double, err):
    """K1 and K2 against their plain versions on ``args``; K2 writes the
    (2B, A) gradient of q_both, zero past row B."""
    b = args[0].shape[0]
    loss, td = td_kernels.td_loss_fwd(*args, 1.0, double)
    ref_loss, ref_td = td_kernels.td_loss_reference(*args, 1.0, double)
    torch.testing.assert_close(loss, ref_loss, **LOSS_TOL)
    torch.testing.assert_close(td, ref_td, **LOSS_TOL)
    g = torch.rand((), device=args[0].device) + 0.5
    dq = td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    ref_dq = td_kernels.td_loss_backward_reference(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    torch.testing.assert_close(dq, ref_dq, **DQ_TOL)
    assert dq.shape == (2 * b, a) and not dq[b:].any()
    err["td_loss_fwd"] = max(
        err["td_loss_fwd"], float((loss - ref_loss).abs()), float((td - ref_td).abs().max())
    )
    err["td_loss_bwd"] = max(err["td_loss_bwd"], float((dq - ref_dq).abs().max()))
    return td


def check_td_determinism(torch, td_kernels):
    """K1 at B = 4096 (16 blocks and the last block's sum): 100 calls give a
    bitwise identical loss and td, and after a CUDA-graph replay the ticket
    counter is back at 0 and the result is the same again."""
    args = td_inputs(torch, TD_STABLE_B, 4, seed=5)
    loss0, td0 = td_kernels.td_loss_fwd(*args, 1.0, True)
    for _ in range(TD_STABLE_CALLS):
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        assert torch.equal(loss, loss0) and torch.equal(td, td0), "K1 is not bitwise stable"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        td_kernels.td_loss_fwd(*args, 1.0, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [td_kernels.td_loss_fwd(*args, 1.0, True) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    _, ticket = td_kernels.fwd_scratch(args[0].device)
    assert int(ticket) == 0, int(ticket)
    assert all(torch.equal(lo, loss0) and torch.equal(t, td0) for lo, t in outs)
    print(f"  K1 B={TD_STABLE_B}: {TD_STABLE_CALLS} calls and a graph replay bitwise equal, "
          f"ticket counter 0")


def check_td_kernels(torch, td_kernels, per_superstep, card):
    """Phase 3: kernel vs plain on the card; returns per-kernel records."""
    from deep_q_learning_tpu_torch.measure import bound_text

    err = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
    cases = [((b, a), double, 0.0) for (b, a) in TD_SHAPES for double in (True, False)]
    cases += [((256, 4), True, 100.0), ((4096, 4), True, 100.0)]
    for i, ((b, a), double, shift) in enumerate(cases):
        args = td_inputs(torch, b, a, seed=i, reward_shift=shift)
        assert td_kernels.float4_rows(a, *args[:3]) == (a == 4)
        td = check_td_case(torch, td_kernels, args, a, double, err)
        if shift:
            assert float(td.abs().min()) > 1.0, "the clip case must be past delta"
        print(f"  kernel vs plain B={b} A={a} double={double} shift={shift}: ok")
    for b in (256, 4096):
        args = td_inputs(torch, b, 4, seed=b)
        args[:3] = [misaligned(torch, t) for t in args[:3]]
        assert not td_kernels.float4_rows(4, *args[:3])
        check_td_case(torch, td_kernels, args, 4, True, err)
        print(f"  kernel vs plain B={b} A=4, rows not 16-byte aligned (scalar path): ok")
    check_td_determinism(torch, td_kernels)
    torch.cuda.synchronize()

    times = {}
    for b in TD_TIMED:
        args = td_inputs(torch, b, 4, seed=99)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        g = torch.ones((), device="cuda")
        rows = 2 * b
        times[b] = {
            "td_loss_fwd": (
                time_ms(torch, lambda: td_kernels.td_loss_fwd(*args, 1.0, True)),
                time_ms(torch, lambda: td_kernels.td_loss_reference(*args, 1.0, True)),
                td_kernels.td_loss_fwd_work(b, 4),
            ),
            "td_loss_bwd": (
                time_ms(torch, lambda: td_kernels.td_loss_bwd(
                    td, args[3], args[6], g, 4, 1.0, out_rows=rows)),
                time_ms(torch, lambda: td_kernels.td_loss_backward_reference(
                    td, args[3], args[6], g, 4, 1.0, out_rows=rows)),
                td_kernels.td_loss_bwd_work(b, 4, rows),
            ),
        }
        for name, (k_ms, p_ms, work) in times[b].items():
            print(f"  {name} B={b} A=4: kernel {k_ms * 1e3:.2f} us/call, "
                  f"plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls); "
                  f"{bound_text(work, k_ms * 1e3)}; launches per superstep "
                  f"{per_superstep[name]} [{card}]")
    return err, times


def slot_inputs(torch, n, c, b, seed, dyadic):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dyadic:  # multiples of 1/64 with small totals: every sum is exact
        p = torch.randint(1, 257, (n, c), generator=g, device="cuda").float() / 64
        p = p * (torch.rand((n, c), generator=g, device="cuda") > 0.3)
        p[0] = 0.0  # an all-zero row
    else:
        p = torch.rand((n, c), generator=g, device="cuda") ** 3
    env = torch.randint(0, n, (b,), generator=g, device="cuda")
    u = torch.rand((b,), generator=g, device="cuda")
    return p.contiguous(), env, u


def slot_mismatches(torch, p, env, u, got, want, dyadic):
    """How many draws' slots differ; fails unless dyadic priorities match
    exactly and random ones differ only where every prefix between the two
    slots lies within 8 ulps of the row total of the draw."""
    n, c = p.shape
    b = env.shape[0]
    bad = (got != want).nonzero().flatten().tolist()
    if dyadic:
        assert not bad, f"K3 dyadic ({n}, {c}, {b}): {len(bad)} slots differ"
        return len(bad)
    rows = p[env].double()
    total = rows.sum(dim=1).float()
    draw = u.double() * total.double()
    cdf = torch.cumsum(rows, dim=1)
    ulp = (torch.nextafter(total, torch.full_like(total, math.inf)) - total).double()
    for i in bad:
        lo, hi = sorted((int(got[i]), int(want[i])))
        gap = float((cdf[i, lo:hi] - draw[i]).abs().max())
        assert gap <= SLOT_ULPS * float(ulp[i]), (n, c, b, i, gap)
    return len(bad)


def check_slot_edges(torch, sample_kernels, c):
    """The CPU tests' edge cases against the Pallas kernel, on the card
    against the plain version at C = ``c``: leading zero slots with u = 0,
    an all-zero row, u = 1.0 and 1.5, rows -1 and N."""
    g = torch.Generator().manual_seed(c)
    p = torch.randint(1, 257, (4, c), generator=g).float() / 64
    p[0, :17] = 0.0  # leading zero slots
    p[2] = 0.0  # an all-zero row
    p = p.cuda()
    env = torch.tensor([0, 0, 2, 2, 1, 3, 1, -1, 4, 3, 0], device="cuda")
    u = torch.tensor([0.0, 0.5, 0.0, 0.7, 1.5, 1.0, 0.999999, 0.3, 0.3, 1e-7, 0.25],
                     device="cuda")
    got = sample_kernels.slot_select(p, env, u).tolist()
    assert got == sample_kernels.slot_select_reference(p, env, u).tolist(), (c, got)
    assert got[0] == 0 and got[2] == got[3] == 0, got  # u = 0; the all-zero row
    assert got[4] == c - 1 and got[5] == c - 1, got  # past the total, at it: clamped
    assert got[7] == got[8] == 0, got  # no row


def check_slot_determinism(torch, sample_kernels, n, c, b):
    """100 calls give bitwise the same slots, and so do 10 calls replayed
    from a CUDA graph."""
    p, env, u = slot_inputs(torch, n, c, b, seed=3, dyadic=False)
    slots0 = sample_kernels.slot_select(p, env, u)
    for _ in range(SLOT_STABLE_CALLS):
        assert torch.equal(sample_kernels.slot_select(p, env, u), slots0), "K3 is not bitwise stable"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sample_kernels.slot_select(p, env, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [sample_kernels.slot_select(p, env, u) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, slots0) for o in outs), "K3 differs after a graph replay"


def check_slot_kernel(torch, sample_kernels, per_superstep, card):
    """Phase 3, K3: slot indices of the kernel against the plain version.
    Dyadic priorities must match exactly (their count of mismatches is the
    record's ``max_abs_err``); random ones may differ only where every
    prefix between the two slots lies within 8 ulps of the row total of
    the draw, and in under 1 % of at least 1024 draws (at B = 64 one draw
    would be 1.6 %).  Then the edge cases on every path, the slots' bitwise
    stability, and the times."""
    from deep_q_learning_tpu_torch.measure import bound_text

    dyadic_mismatches = 0
    for n, c, b in SLOT_SHAPES:
        for dyadic in (True, False):
            # random: the share of mismatches over at least SLOT_SHARE_DRAWS draws
            calls = 1 if dyadic else -(-SLOT_SHARE_DRAWS // b)
            differ = 0
            for k in range(calls):
                p, env, u = slot_inputs(torch, n, c, b, seed=n + c + k, dyadic=dyadic)
                if (n, c, b) == SLOT_MISALIGNED:
                    p = misaligned(torch, p)
                plan = sample_kernels.slot_plan(p)
                assert tuple(plan.values()) == SLOT_PLANS[(n, c, b)], ((n, c, b), plan)
                got = sample_kernels.slot_select(p, env, u)
                want = sample_kernels.slot_select_reference(p, env, u)
                torch.cuda.synchronize()
                differ += slot_mismatches(torch, p, env, u, got, want, dyadic)
            assert differ < 0.01 * calls * b, ((n, c, b), differ, calls * b)
            dyadic_mismatches += differ if dyadic else 0
            print(f"  K3 kernel vs plain (N, C, B)=({n}, {c}, {b}) "
                  f"{'dyadic' if dyadic else 'random'}, plan {plan}: {differ} of {calls * b} "
                  f"slots differ")
    for c in SLOT_EDGE_C:
        check_slot_edges(torch, sample_kernels, c)
    print(f"  K3 edge cases (u = 0, 1.0, 1.5, an all-zero row, rows -1 and N) at C = "
          f"{SLOT_EDGE_C}: equal to the plain version")
    for n, c, b in SLOT_TIMED:
        check_slot_determinism(torch, sample_kernels, n, c, b)
    print(f"  K3 at {SLOT_TIMED}: {SLOT_STABLE_CALLS} calls and a graph replay bitwise equal")
    times = {}
    for n, c, b in SLOT_TIMED:
        p, env, u = slot_inputs(torch, n, c, b, seed=7, dyadic=False)
        times[(n, c, b)] = (
            time_ms(torch, lambda: sample_kernels.slot_select(p, env, u)),
            time_ms(torch, lambda: sample_kernels.slot_select_reference(p, env, u)),
            sample_kernels.per_slot_sample_work(p, env),
        )
        k_ms, p_ms, work = times[(n, c, b)]
        print(f"  per_slot_sample (N, C, B)=({n}, {c}, {b}): kernel {k_ms * 1e3:.2f} us/call, "
              f"plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls); "
              f"{bound_text(work, k_ms * 1e3)}; launches per superstep "
              f"{per_superstep['per_slot_sample']} [{card}]")
    return dyadic_mismatches, times


def run_slice(torch, td_kernels, sample_kernels, card):
    """Phase 4: lunar_per at full width through the Trainer."""
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = lunar_per()
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    online0 = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    target0 = [p.detach().clone() for p in trainer.runner.train.target.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.step() for _ in range(SUPERSTEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(td_kernels.launches)
    assert sample_kernels.launches == {"per_slot_sample": 0}  # off in lunar_per

    updates = sum(m.loss_count for m in metrics)
    loss_sum = sum(m.loss_sum for m in metrics)
    env_steps = metrics[-1].env_steps * cfg.num_envs
    assert env_steps == SUPERSTEPS * cfg.steps_per_superstep * cfg.num_envs
    assert updates > 0, "no learner update ran"
    assert updates == trainer.runner.train.updates
    assert launches == {"td_loss_fwd": updates, "td_loss_bwd": updates}, (launches, updates)
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    assert math.isfinite(loss_sum), loss_sum
    online = [p.detach() for p in trainer.runner.train.online.parameters()]
    target = [p.detach() for p in trainer.runner.train.target.parameters()]
    moved_online = sum(float((p - p0).norm()) for p, p0 in zip(online, online0))
    moved_target = sum(float((t - t0_).norm()) for t, t0_ in zip(target, target0))
    gap = sum(float((t - p).norm()) for t, p in zip(target, online))
    assert moved_online > 0 and 0 < moved_target < moved_online and gap > 0, (
        moved_online, moved_target, gap)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    ev = trainer.evaluate(seed=0)
    assert ev.returns.shape == (128,) and all(math.isfinite(x) for x in ev.returns)
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  updates {updates}, episodes {metrics[-1].episodes}, window {metrics[-1].window_mean:.3f}, "
          f"eval mean {float(ev.returns.mean()):.3f} over {len(ev.returns)} episodes")
    print(f"  lunar_per x{cfg.num_envs} envs: {env_steps} env steps in {seconds:.3f} s = "
          f"{env_steps / seconds:.1f} env-steps/s, peak memory {peak_mib:.1f} MiB "
          f"[{card}]")


def run_scaled(torch, td_kernels, sample_kernels, card):
    """Phase 5: lunar_per_scaled(1024) with the PER slot kernel, at full
    width through the Trainer."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_per_scaled
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_per_scaled(1024), use_pallas_sampler=True)
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    per = trainer.runner.replay.priorities
    assert per.shape == (1024, 512) and cfg.batch_size == 1024, (per.shape, cfg.batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.step() for _ in range(SCALED_SUPERSTEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(td_kernels.launches, **sample_kernels.launches)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls)

    updates = sum(m.loss_count for m in metrics)
    loss_sum = sum(m.loss_sum for m in metrics)
    env_steps = metrics[-1].env_steps * cfg.num_envs
    assert env_steps == SCALED_SUPERSTEPS * cfg.steps_per_superstep * cfg.num_envs
    assert updates > 0 and updates == trainer.runner.train.updates
    assert launches == {"td_loss_fwd": updates, "td_loss_bwd": updates,
                        "per_slot_sample": updates}, (launches, updates)
    assert not any(plain.values()), plain
    assert math.isfinite(loss_sum), loss_sum
    assert float(trainer.runner.replay.max_priority) > 0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  updates {updates}, launches {launches}, episodes {metrics[-1].episodes}")
    print(f"  lunar_per_scaled x{cfg.num_envs} envs, use_pallas_sampler: {env_steps} env steps "
          f"in {seconds:.3f} s = {env_steps / seconds:.1f} env-steps/s, "
          f"peak memory {peak_mib:.1f} MiB [{card}]")
    return launches


def run_cli(card):
    """Phase 6: train one superstep with a checkpoint, resume for one more,
    then evaluate the last checkpoint, each as ``python -m
    deep_q_learning_tpu_torch``."""
    per_superstep = 128 * 1024
    (REPO / "build").mkdir(exist_ok=True)

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "deep_q_learning_tpu_torch", *args],
            cwd=REPO, capture_output=True, text=True, timeout=400,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI {args[0]} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  {args[0]}{' --resume' if '--resume' in args else ''}: {out} "
              f"({time.perf_counter() - t0:.1f} s with start-up)")
        return out

    with tempfile.TemporaryDirectory(dir=REPO / "build") as workdir:
        common = ["--preset", "lunar_per_scaled", "--workdir", workdir]
        for item in SCALED_SETS:
            common += ["--set", item]
        first = cli("train", *common, "--max-env-steps", str(per_superstep),
                    "--checkpoint-every", "1", "--log-every", "1", "--quiet")
        assert first["env_steps"] == per_superstep and first["updates"] > 0, first
        resumed = cli("train", *common, "--resume", "--max-env-steps", str(2 * per_superstep),
                      "--checkpoint-every", "1", "--log-every", "1", "--quiet")
        assert resumed["env_steps"] == 2 * per_superstep, resumed
        assert resumed["updates"] > first["updates"] and resumed["episodes"] >= first["episodes"]
        report = cli("eval", *common)
        assert report["step"] == 2 * per_superstep and report["episodes"] == 128, report
        assert math.isfinite(report["return_mean"]) and report["length_mean"] > 0, report
    print(f"  CLI train -> resume -> eval on the card: ok [{card}]")


def frame_launches(torch, trainer) -> int:
    """Kernel launches of one vector step of the trainer's env on the card,
    counted by torch.profiler."""
    r = trainer.runner
    actions = torch.zeros((trainer.cfg.num_envs,), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.env.step_env(r.generator, r.env_states, actions, trainer.env_params)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))


def run_jointed(torch, td_kernels, sample_kernels, card):
    """Phase 7: lunar_jointed_per at full width through the Trainer."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_jointed_per
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_jointed_per(), **JOINTED_CUTS)
    assert (cfg.num_envs, cfg.hidden, cfg.batch_size, cfg.n_step, cfg.dueling) == (
        128, (256, 256), 256, 3, True), cfg
    assert (cfg.lander_engine, cfg.lander_vel_iters, cfg.lander_pos_iters) == ("jointed", 120, 40)
    assert cfg.use_pallas and not cfg.use_pallas_sampler
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    assert trainer.runner.replay.priorities.shape == (128, 4096)
    assert trainer.runner.env_states.solver_acc.c1.shape == (128, 4, 2)
    online0 = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    target0 = [p.detach().clone() for p in trainer.runner.train.target.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.step() for _ in range(JOINTED_SUPERSTEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(td_kernels.launches)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls)
    assert sample_kernels.launches == {"per_slot_sample": 0}  # off in lunar_jointed_per

    updates = sum(m.loss_count for m in metrics)
    loss_sum = sum(m.loss_sum for m in metrics)
    vector_steps = JOINTED_SUPERSTEPS * cfg.steps_per_superstep
    assert [m.env_steps for m in metrics] == [
        cfg.steps_per_superstep * (i + 1) for i in range(JOINTED_SUPERSTEPS)]
    assert trainer.runner.replay.total_adds == vector_steps
    # learning starts once 2048 transitions are stored: at vector step 16
    first = cfg.training_start // cfg.num_envs
    assert updates == vector_steps - first + 1 == trainer.runner.train.updates, updates
    assert trainer.runner.train.opt_state.count == updates
    assert metrics[-1].episodes == sum(m.episodes_delta for m in metrics)
    assert launches == {"td_loss_fwd": updates, "td_loss_bwd": updates}, (launches, updates)
    assert not any(plain.values()), plain
    assert math.isfinite(loss_sum), loss_sum
    online = [p.detach() for p in trainer.runner.train.online.parameters()]
    target = [p.detach() for p in trainer.runner.train.target.parameters()]
    moved_online = sum(float((p - p0).norm()) for p, p0 in zip(online, online0))
    moved_target = sum(float((t - t0_).norm()) for t, t0_ in zip(target, target0))
    gap = sum(float((t - p).norm()) for t, p in zip(target, online))
    assert moved_online > 0 and 0 < moved_target < moved_online and gap > 0, (
        moved_online, moved_target, gap)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    # each superstep also runs one frame for its pool of fresh episodes
    frames = vector_steps + JOINTED_SUPERSTEPS
    per_frame = frame_launches(torch, trainer)

    ev = trainer.evaluate(seed=0, max_steps=JOINTED_EVAL_FRAMES)
    assert ev.returns.shape == (128,) and all(math.isfinite(x) for x in ev.returns)
    assert (ev.lengths <= JOINTED_EVAL_FRAMES).all()
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  updates {updates}, launches {launches}, episodes {metrics[-1].episodes}, "
          f"greedy eval over {JOINTED_EVAL_FRAMES} frames: mean {float(ev.returns.mean()):.3f}")
    print(f"  lunar_jointed_per x{cfg.num_envs} envs: {vector_steps * cfg.num_envs} env steps "
          f"({frames} jointed frames with the reset pools) in {seconds:.3f} s = "
          f"{vector_steps * cfg.num_envs / seconds:.1f} env-steps/s, "
          f"{seconds / frames * 1e3:.1f} ms per jointed frame, peak memory {peak_mib:.1f} MiB "
          f"[{card}]")
    print(f"  kernel launches of one jointed vector step: {per_frame} "
          f"(torch.profiler) [{card}]")
    return launches


def to_device(torch, obj, device):
    """A state dataclass (nested dataclasses, tensors, None) on ``device``."""
    import dataclasses

    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return dataclasses.replace(obj, **{
        f.name: to_device(torch, getattr(obj, f.name), device) for f in dataclasses.fields(obj)
    })


def check_jointed_frame(torch, card):
    """Phase 7: one jointed frame on the card against the same frame on the
    CPU, from the same states, actions and dispersion draws."""
    from deep_q_learning_tpu_torch.config import lunar_jointed_per
    from deep_q_learning_tpu_torch.envs import make_env
    from deep_q_learning_tpu_torch.envs.heuristic import heuristic_action, touchdown_states

    cfg = lunar_jointed_per()
    env, params = make_env(cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
                           param_overrides=cfg.env_param_overrides())
    assert params.jointed and (params.vel_iters, params.pos_iters) == (120, 40)
    g = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    obs, st = touchdown_states(env, params, FRAME_ENVS, g, FRAME_FLIGHT)
    flight_s = time.perf_counter() - t0
    on_ground = st.leg1 | st.leg2
    assert on_ground.any() and (st.leg1 & st.leg2).any() and (~on_ground).any(), "coverage"
    random = torch.randint(0, 4, (FRAME_ENVS,), generator=g, dtype=torch.int32)
    actions = torch.where(torch.arange(FRAME_ENVS) % 2 == 0, heuristic_action(obs), random)
    draws = torch.rand((FRAME_ENVS, 2), generator=g) * 2.0 - 1.0
    cpu = env.step_env(None, st, actions, params, draws)
    gpu = env.step_env(None, to_device(torch, st, "cuda"), actions.cuda(), params, draws.cuda())
    torch.cuda.synchronize()
    gpu = [to_device(torch, x, "cpu") for x in gpu]

    c_st, g_st = cpu[1], gpu[1]
    fields = [("obs", cpu[0], gpu[0]), ("reward", cpu[2], gpu[2])]
    for name, kind in (("x", "position"), ("y", "position"), ("angle", "position"),
                       ("vx", "velocity"), ("vy", "velocity"), ("omega", "velocity")):
        fields.append((kind, getattr(c_st, name), getattr(g_st, name)))
    for leg in ("leg1_body", "leg2_body"):
        for name in ("cx", "cy", "a", "vx", "vy", "w"):
            kind = "position" if name in ("cx", "cy", "a") else "velocity"
            fields.append((kind, getattr(getattr(c_st, leg), name), getattr(getattr(g_st, leg), name)))
    for name in ("j1", "j2", "c1", "c2"):
        fields.append(("accumulator", getattr(c_st.solver_acc, name), getattr(g_st.solver_acc, name)))
    past_tight = torch.zeros(FRAME_ENVS, dtype=torch.bool)
    err = {}
    for kind, want, got in fields:
        tight, rtol, loose = FRAME_TOL[kind]
        gap = (got.double() - want.double()).abs().reshape(FRAME_ENVS, -1)
        err[kind] = max(err.get(kind, 0.0), float(gap.max()))
        assert float(gap.max()) <= loose, (kind, float(gap.max()), loose)
        past_tight |= (gap > tight + rtol * want.double().abs().reshape(FRAME_ENVS, -1)).any(1)
    assert float(past_tight.float().mean()) <= 1 - FRAME_TIGHT_SHARE, int(past_tight.sum())
    for name in ("leg1", "leg2", "wind_idx", "t"):
        assert torch.equal(getattr(c_st, name), getattr(g_st, name)), name
    for name in ("s1", "s2"):
        assert torch.equal(getattr(c_st.solver_acc, name), getattr(g_st.solver_acc, name)), name
    assert torch.equal(cpu[3], gpu[3]) and torch.equal(cpu[4], gpu[4]), "terminated, truncated"
    # the sleep counter follows the end-of-step speeds: a lane at a threshold may flip
    assert int((c_st.sleep != g_st.sleep).sum()) <= 1
    print(f"  one jointed frame of {FRAME_ENVS} landers ({int(on_ground.sum())} on the ground, "
          f"{int(cpu[3].sum())} finishing) after a {FRAME_FLIGHT}-frame flight on the CPU "
          f"({flight_s:.1f} s): card vs CPU largest gaps {err}, "
          f"{int(past_tight.sum())} lanes past the tight tolerances [{card}]")


def check_learner_vs_cpu(torch, td_kernels):
    """One learner update through the kernel on the card against the plain
    path on the CPU, from the same weights and batch (rtol 1e-4)."""
    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    cfg = lunar_per()
    g = torch.Generator().manual_seed(7)
    b = cfg.batch_size
    batch = dict(
        obs=torch.randn((b, 9), generator=g), action=torch.randint(0, 4, (b,), generator=g, dtype=torch.int32),
        reward=torch.randn((b,), generator=g), next_obs=torch.randn((b, 9), generator=g),
        bootstrap=0.97 * (torch.rand((b,), generator=g) > 0.2).float(),
    )
    weights = torch.rand((b,), generator=g) + 0.1
    out = []
    for device in ("cpu", "cuda"):
        net = QNetwork(9, 4, hidden=cfg.hidden, generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(cfg)
        ts = init_train_state(net.to(device), opt)
        lb = LearnBatch(**{k: v.to(device) for k, v in batch.items()})
        ts, loss, td = build_update_step(opt, cfg)(ts, lb, weights.to(device))
        out.append((loss.cpu(), td.cpu(), [p.detach().cpu() for p in ts.online.parameters()]))
    (lc, tdc, pc), (lg, tdg, pg) = out
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(tdg, tdc, rtol=1e-4, atol=1e-5)
    for a, c in zip(pg, pc):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)
    print("  learner update on the card vs the CPU plain path: ok")


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deep_q_learning_tpu_torch.ops import build, sample_kernels, td_kernels

    print("phase 2: build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, together
        for fut in [pool.submit(td_kernels._lib), pool.submit(sample_kernels._lib)]:
            fut.result()
    for source in ("td_loss.cu", "per_sample.cu"):
        print(f"  {source}: nvcc {build.build_seconds.get(source, 0.0):.2f} s (0 = reused a build)")
        for kernel, use in build.ptxas_summary(build.ptxas_reports.get(source, "")).items():
            print(f"    {kernel}: {use['registers']} registers, {use['smem']} B shared, "
                  f"spills {use['spill_stores']} B stored, {use['spill_loads']} B loaded (ptxas)")
            assert use["spill_stores"] == use["spill_loads"] == 0, (kernel, use)
    print(f"  built and loaded in {time.perf_counter() - t0:.2f} s")

    print("phase 3: kernels vs plain on the card")
    from deep_q_learning_tpu_torch.measure import launches_per_superstep

    per_superstep = launches_per_superstep()
    err, times = check_td_kernels(torch, td_kernels, per_superstep, card)
    err["per_slot_sample"], slot_times = check_slot_kernel(
        torch, sample_kernels, per_superstep, card)

    print("phase 4: lunar_per slice")
    run_slice(torch, td_kernels, sample_kernels, card)
    check_learner_vs_cpu(torch, td_kernels)
    torch.cuda.synchronize()

    print("phase 5: lunar_per_scaled(1024) with use_pallas_sampler")
    launches = run_scaled(torch, td_kernels, sample_kernels, card)

    print("phase 6: the command line on the card")
    run_cli(card)

    print("phase 7: lunar_jointed_per, the jointed lander")
    t0 = time.perf_counter()
    jointed_launches = run_jointed(torch, td_kernels, sample_kernels, card)
    check_jointed_frame(torch, card)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    # ms and bound at B=256 for the TD kernels (lunar_per, lunar_jointed_per)
    # and at (1024, 512, 1024) for the slot kernel (lunar_per_scaled);
    # launches of the TD kernels from phase 7, of the slot kernel from phase 5.
    # No single PyTorch call computes any of the three: library_ms is null
    from deep_q_learning_tpu_torch.ops import bound_by, bound_us

    timed = dict(times[256], per_slot_sample=slot_times[SLOT_SHAPES[0]])
    launches = dict(launches, **jointed_launches)
    kernels = {
        "td_loss_fwd": (TD_SOURCE, "deep_q_learning_tpu/ops/td_kernels.py:48"),
        "td_loss_bwd": (TD_SOURCE, "deep_q_learning_tpu/ops/td_kernels.py:97"),
        "per_slot_sample": (PER_SOURCE, "deep_q_learning_tpu/ops/sample_kernels.py:52"),
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": timed[name][0],
            "plain_ms": timed[name][1],
            "bound_ms": bound_us(timed[name][2]) / 1e3,
            "bound_by": bound_by(timed[name][2]),
            "library_ms": None,
        }
        for name, (source, replaces) in kernels.items()
    ]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - started:.1f} s [{card}]")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
