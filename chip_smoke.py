#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from deep_q_learning_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and time both with CUDA events;
  4. run the ``lunar_per`` slice at full width through ``Trainer``: 4
     supersteps (512 vector steps of 128 envs), then check that the TD
     kernels ran once per learner update, the loss is finite, the online
     net trained, the target followed by Polyak averaging, and a greedy
     evaluation returns finite returns; then one learner update on the
     card is held against the same update on the CPU;
  5. print the kernels' record as one JSON line, then the result line.

It imports nothing of JAX or of the JAX package, and exits non-zero
without printing a result where CUDA is absent.
"""

import json
import math
import subprocess
import sys
import time

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # loss and td: the kernel sums in another order
DQ_TOL = dict(rtol=1e-5, atol=1e-7)
TD_SOURCE = "deep_q_learning_tpu_torch/csrc/td_loss.cu"
SUPERSTEPS = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def td_inputs(torch, b, a, seed, reward_shift=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    return [
        randn(b, a), randn(b, a), randn(b, a),
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


def check_td_kernels(torch, td_kernels):
    """Phase 3: kernel vs plain on the card; returns per-kernel records."""
    err = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
    cases = [((b, a), double, 0.0) for (b, a) in [(256, 4), (1024, 4), (37, 2)]
             for double in (True, False)] + [((256, 4), True, 100.0)]
    for i, ((b, a), double, shift) in enumerate(cases):
        args = td_inputs(torch, b, a, seed=i, reward_shift=shift)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, double)
        ref_loss, ref_td = td_kernels.td_loss_reference(*args, 1.0, double)
        torch.testing.assert_close(loss, ref_loss, **LOSS_TOL)
        torch.testing.assert_close(td, ref_td, **LOSS_TOL)
        if shift:
            assert float(td.abs().min()) > 1.0, "the clip case must be past delta"
        g = torch.rand((), device="cuda") + 0.5
        dq = td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0)
        ref_dq = td_kernels.td_loss_backward_reference(td, args[3], args[6], g, a, 1.0)
        torch.testing.assert_close(dq, ref_dq, **DQ_TOL)
        err["td_loss_fwd"] = max(
            err["td_loss_fwd"], float((loss - ref_loss).abs()), float((td - ref_td).abs().max())
        )
        err["td_loss_bwd"] = max(err["td_loss_bwd"], float((dq - ref_dq).abs().max()))
        print(f"  kernel vs plain B={b} A={a} double={double} shift={shift}: ok")
    torch.cuda.synchronize()

    times = {}
    for b in (256, 1024):
        args = td_inputs(torch, b, 4, seed=99)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        g = torch.ones((), device="cuda")
        times[b] = {
            "td_loss_fwd": (
                time_ms(torch, lambda: td_kernels.td_loss_fwd(*args, 1.0, True)),
                time_ms(torch, lambda: td_kernels.td_loss_reference(*args, 1.0, True)),
            ),
            "td_loss_bwd": (
                time_ms(torch, lambda: td_kernels.td_loss_bwd(td, args[3], args[6], g, 4, 1.0)),
                time_ms(torch, lambda: td_kernels.td_loss_backward_reference(
                    td, args[3], args[6], g, 4, 1.0)),
            ),
        }
        for name, (k_ms, p_ms) in times[b].items():
            print(f"  {name} B={b} A=4: kernel {k_ms * 1e3:.2f} us/call, "
                  f"plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls)")
    return err, times


def run_slice(torch, td_kernels, card):
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
    t0 = time.perf_counter()
    metrics = [trainer.step() for _ in range(SUPERSTEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(td_kernels.launches)

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
    return launches


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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deep_q_learning_tpu_torch.ops import build, td_kernels

    print("phase 2: build")
    t0 = time.perf_counter()
    td_kernels._lib()
    print(f"  td_loss.cu: nvcc {build.build_seconds.get('td_loss.cu', 0.0):.2f} s "
          f"(0 = reused a build), load {time.perf_counter() - t0:.2f} s")

    print("phase 3: kernels vs plain on the card")
    err, times = check_td_kernels(torch, td_kernels)

    print("phase 4: lunar_per slice")
    launches = run_slice(torch, td_kernels, card)
    check_learner_vs_cpu(torch, td_kernels)
    torch.cuda.synchronize()

    replaces = {
        "td_loss_fwd": "deep_q_learning_tpu/ops/td_kernels.py:48",
        "td_loss_bwd": "deep_q_learning_tpu/ops/td_kernels.py:97",
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": TD_SOURCE,
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": times[256][name][0],
            "plain_ms": times[256][name][1],
        }
        for name in ("td_loss_fwd", "td_loss_bwd")
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
