"""A function over tensors, called through static buffers and, on a CUDA
device, captured once in a CUDA graph and replayed.

The JAX package compiles its whole superstep, env step included, with
``jax.jit`` (``deep_q_learning_tpu/train.py:123``), so a frame of the
jointed lander is one XLA program.  Eager PyTorch issues every one of the
frame's kernels from the host, and waits on the host's time per launch
(a few hundred a jointed frame around the solver kernel S1 on the card;
~56k with the plain solver).  :class:`GraphedStep` is the port's counterpart of that ``jit``: it
owns static input buffers and the call's outputs, and

  * on a CUDA device it runs the call once eagerly on a side stream, then
    captures it in a CUDA graph, and replays the graph on every call: the
    same kernels in the same order, so a replay is the eager call bit for
    bit;
  * on the CPU it makes a direct call on the same static inputs and copies
    the result into the same static outputs.

So on both devices an output is overwritten by the next call: a caller
that keeps one past the next call copies it first.  Each call copies its
arguments into the static inputs, except an argument that already is the
static input (a copy onto itself).  The function must take no random
numbers from a generator and read nothing back to the host: its caller
draws the random numbers first and passes them in (``Environment.
step_draws`` and ``reset_draws``).  A capture that fails raises; nothing
falls back to the eager call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List

import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of tensors, tuples, lists, dataclasses and
    ``None``, in a fixed order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to each tensor (``None`` kept)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})


def copy_into(dst: Any, src: Any) -> None:
    """Copy every tensor of ``src`` into the same place of ``dst``, whose
    structure, shapes and dtypes must match; a tensor that already is its
    destination is left alone."""
    dst_leaves, src_leaves = tree_leaves(dst), tree_leaves(src)
    if len(dst_leaves) != len(src_leaves):
        raise ValueError(f"{len(src_leaves)} tensors given where {len(dst_leaves)} are held")
    for d, s in zip(dst_leaves, src_leaves):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a {s.dtype} {tuple(s.shape)} tensor given where a "
                             f"{d.dtype} {tuple(d.shape)} one is held")
        d.copy_(s)


class GraphedStep:
    """``fn(*args)`` through static buffers; captured in a CUDA graph on the
    first call whose inputs lie on a CUDA device, replayed after."""

    def __init__(self, fn: Callable, name: str = "step"):
        self.fn = fn
        self.name = name
        self.inputs = None  # the static inputs: a clone of the first call's arguments
        self.outputs = None  # the static outputs
        self.graph = None
        # host seconds of the eager warm-up call and of the capture (with the
        # graph's instantiation), on a CUDA device
        self.warmup_s = self.capture_s = None

    def __call__(self, *args):
        if self.inputs is None:
            self.inputs = tree_map(torch.clone, args)
        else:
            copy_into(self.inputs, args)
        leaves = tree_leaves(self.inputs)
        if leaves and leaves[0].device.type == "cuda":
            if self.graph is None:
                self._capture()
            self.graph.replay()
        else:
            out = self.fn(*self.inputs)
            if self.outputs is None:
                self.outputs = tree_map(torch.clone, out)
            else:
                copy_into(self.outputs, out)
        return self.outputs

    def _capture(self) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # one eager call first, as capture asks
            self.fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: another thread's CUDA work (a process group's)
            # may go on during the capture; this thread's may not sync
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self.fn(*self.inputs)
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed: the call must launch kernels only, "
                f"with no read back to the host; build its VectorEnv with graphed=False to "
                f"run it eagerly") from err
        self.outputs, self.graph = outputs, graph
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
