"""Metric logs, plots, timers and profiler spans (``deep_q_learning_tpu/utils/metrics.py``).

``MetricLogger`` appends one JSON record a line; ``plot_history`` draws the
reward and loss curves (matplotlib, imported when called); ``stopwatch``
times a phase on the host clock; ``trace`` names a span in a
``torch.profiler`` trace, and ``start_profiler_trace`` /
``stop_profiler_trace`` record one into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterable, List, Optional

import torch


class MetricLogger:
    """Append-only JSONL metric stream (one record per logged superstep)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.records: List[Dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, record: Dict) -> None:
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
        if self.echo:
            print(record, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def import_matplotlib():
    """``matplotlib.pyplot`` on the Agg backend; an ``ImportError`` that
    names the package where it is absent."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"matplotlib is needed to draw figures and is not installed ({e})") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_history(
    history: Iterable[Dict],
    path: str,
    x_key: str = "env_steps",
    y_keys: Iterable[str] = ("window_mean", "loss"),
) -> str:
    """Reward and loss curves of a run's history, one panel a key."""
    plt = import_matplotlib()
    history = list(history)
    y_keys = list(y_keys)
    fig, axes = plt.subplots(len(y_keys), 1, figsize=(8, 3 * len(y_keys)), sharex=True)
    if len(y_keys) == 1:
        axes = [axes]
    xs = [r[x_key] for r in history]
    for ax, key in zip(axes, y_keys):
        ax.plot(xs, [r.get(key, float("nan")) for r in history])
        ax.set_ylabel(key)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel(x_key)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


@contextlib.contextmanager
def stopwatch(name: str, sink=print):
    """Wall-clock timer of the block; ``sink`` gets ``"<name>: <s>s"``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def trace(name: str):
    """A named span in a ``torch.profiler`` trace (a no-op when no profiler
    runs)."""
    with torch.profiler.record_function(name):
        yield


def start_profiler_trace(logdir: str) -> torch.profiler.profile:
    """Start recording the host and (where there is one) the GPU into a
    trace that :func:`stop_profiler_trace` writes under ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    )
    prof.start()
    return prof


def stop_profiler_trace(prof: torch.profiler.profile) -> None:
    """Stop ``prof`` and write its trace."""
    prof.stop()
