"""Populations and runs over ranks; ``dryrun_multichip``, the counterpart
of the JAX package's ``__graft_entry__.dryrun_multichip``."""

from __future__ import annotations

import hashlib
import queue as queue_mod
import socket
import time
import traceback
from typing import List

from deep_q_learning_tpu_torch.parallel.mesh import (
    ENV_AXIS,
    distributed_init,
    rank,
    rank_device,
    world_size,
)
from deep_q_learning_tpu_torch.parallel.distributed import (
    aggregate_metrics,
    build_distributed_superstep,
    local_config,
)
from deep_q_learning_tpu_torch.parallel.population import (
    PopulationTrainer,
    build_population,
    candidate_overrides,
    set_population_hyper,
    train_population,
)

def dryrun_config(n: int):
    """``lunar_jointed_per``'s structure at tiny shapes over ``n`` ranks
    (``__graft_entry__.py``'s cuts): the jointed lander, prioritized
    n-step replay, the TD kernels and the PER slot kernel, the learner
    from the first frame."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_jointed_per

    return dataclasses.replace(
        lunar_jointed_per(),
        num_envs=4 * n,
        steps_per_superstep=4,
        batch_size=4 * n,
        training_start=1,
        buffer_capacity=64 * n,
        hidden=(32, 32),
        train_every=1,
        use_pallas_sampler=True,
        return_window=8,
    )


def _run_rank(target, shard: int, n: int, port: int, args, results) -> None:
    """A spawned rank of :func:`spawn_ranks`: ``target``'s report, or the
    traceback of its failure, goes on ``results``; the process group is
    torn down either way."""
    import torch.distributed as dist

    try:
        report = target(shard, n, port, *args)
        results.put(dict(report, rank=shard))
    except BaseException:
        results.put({"rank": shard, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target, n: int, *args, timeout_s: float = 600.0) -> List[dict]:
    """Run ``target(shard, n, port, *args) -> dict`` in ``n`` spawned
    processes (``torch.multiprocessing``), one a rank; ``port`` is a free
    port on localhost for their process group.  ``target`` must be
    importable (a module-level function).  Returns the reports by rank;
    raises with the traceback if a rank fails, and kills the others."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_run_rank, args=(target, k, n, port, args, results))
             for k in range(n)]
    for p in procs:
        p.start()
    reports = []
    failed = lambda: any("error" in r for r in reports)  # noqa: E731
    deadline = time.monotonic() + timeout_s
    try:  # drain before joining; after a failure the other ranks are killed
        while len(reports) < n and not failed():
            try:
                reports.append(results.get(timeout=1.0))
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"spawn_ranks: no report from every rank in {timeout_s} s")
                if any(p.exitcode not in (None, 0) for p in procs) and results.empty():
                    reports.append({"rank": -1, "error": "a rank exited without a report, "
                                    f"exit codes {[p.exitcode for p in procs]}"})
    finally:
        for p in procs:
            p.join(timeout=0 if failed() else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if failed():
        raise RuntimeError("a rank failed:\n" + "\n".join(r["error"] for r in reports if "error" in r))
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"spawn_ranks: exit codes {[p.exitcode for p in procs]}")
    return sorted(reports, key=lambda r: r["rank"])


def _dryrun_rank(shard: int, n: int, port: int, device: str, backend: str) -> dict:
    """One rank of :func:`dryrun_multichip`: one superstep, and its report."""
    import torch
    import torch.distributed as dist

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels

    distributed_init(f"localhost:{port}", n, shard, backend=backend, device=device)
    cfg = dryrun_config(n)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_runner, superstep, _ = build_distributed_superstep(cfg, dev)
    runner = init_runner(0)
    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    runner, metrics = superstep(runner)
    digest = hashlib.sha256()
    for p in runner.train.online.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return {
        "device": str(dev),
        "backend": dist.get_backend(),
        "metrics": aggregate_metrics(metrics, cfg, n),
        "updates": runner.train.updates,
        "graphed": isinstance(superstep, GraphedLearner),
        "launches": dict(td_kernels.launches, **sample_kernels.launches),
        "plain_calls": dict(td_kernels.plain_calls, **sample_kernels.plain_calls),
        "learner_sha256": digest.hexdigest(),
    }


def dryrun_multichip(n_devices: int, device: str = "cuda") -> List[dict]:
    """One distributed training superstep of :func:`dryrun_config` over
    ``n_devices`` ranks, each a spawned process on ``device`` (NCCL where
    every rank has a card of its own, else gloo: two ranks share one card
    over gloo, CPU ranks are gloo).  Checks that the combined env steps are
    every rank's, the loss is finite and the learner is bitwise the same on
    every rank; returns each rank's report (its metrics, update count,
    whether its superstep is graphed, kernel launches and plain calls,
    learner digest), by rank.  A rank's superstep runs as CUDA graphs on
    the card, where a kernel's wrapper counts the eager call and the
    capture of its graph, not the replays."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"dryrun_multichip on {device} but CUDA is not available")
    backend = "nccl" if cuda and n_devices <= torch.cuda.device_count() else "gloo"
    reports = spawn_ranks(_dryrun_rank, n_devices, device, backend)
    cfg = dryrun_config(n_devices)
    for r in reports:
        agg = r["metrics"]
        if agg["env_steps"] != cfg.steps_per_superstep * cfg.num_envs or agg["loss"] != agg["loss"]:
            raise RuntimeError(f"dryrun_multichip: rank {r['rank']} reports {agg}")
    if len({r["learner_sha256"] for r in reports}) != 1:
        raise RuntimeError("dryrun_multichip: the ranks' learners differ")
    return reports
