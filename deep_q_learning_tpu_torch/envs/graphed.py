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
static input (a copy onto itself).  The function reads nothing back to
the host.  It takes no random numbers from a generator, its caller drawing
them first and passing them in (``Environment.step_draws`` and
``reset_draws``), unless the step is given that ``generator``: the
generator is then registered with the graph before the capture, so that a
replay takes from it the numbers the captured calls would have taken
(CUDA's Philox generator reads its seed and offset from the device at
each replay and advances its offset on the host by the graph's whole
consumption), in the order of the eager call.  A capture that fails
raises; nothing falls back to the eager call.

``in_place=True`` is for a function that writes its results into tensors
it is given (the learner's update, ``algos/superstep.py``), where a second
run of the warm-up would apply everything twice.  Such a step has no
static buffers of its own: it is bound to the tensors of its arguments,
and every call is one real call of the function on them.  On a CUDA
device the first call with those tensors runs eagerly on a side stream
(the warm-up, which counts as the call), the second captures the graph and
replays it once, and later calls replay it.  A call with tensors at other
addresses (a restored runner) starts over with an eager call.  Python code
in the function runs at the eager call and at the capture only, never at a
replay: host counters belong outside it.  ``warm_up=False`` skips the eager
call, for a function whose every operation has already run in this
process (the whole superstep, after its frames ran as graphs of their
own): the first call captures and replays.  Such a graph is captured
with its ``cudaGraph_t`` kept, so that its capture and its
instantiation are timed apart and its nodes counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import time
from typing import Any, Callable, List, Optional

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


def tensors_of(obj: Any) -> List[torch.Tensor]:
    """The tensors of ``obj``, in a fixed order: a module's parameters and
    buffers, and the tensors of dataclasses, lists and tuples; numbers,
    generators and ``None`` hold none.  What an in-place step is bound to."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in tensors_of(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors_of(x)]
    return []


def device_mirror(device_field: str):
    """A dataclass field for a host int that mirrors the device tensor in
    ``device_field``: a counter that CUDA graphs advance on the device and
    the host tracks without reading it back.  ``utils/checkpoint.py``
    saves the int, after checking it against the tensor, and restores
    both from it."""
    return dataclasses.field(metadata={"device": device_field})


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


_side_streams: dict = {}


def side_stream() -> torch.cuda.Stream:
    """The current device's side stream for every eager call before a
    capture.  A stream's cuBLAS workspace is allocated at its first matmul
    and kept for the life of the process, so a new stream for each capture
    would keep one more workspace (tens of MiB) each time."""
    device = torch.cuda.current_device()
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class GraphedStep:
    """``fn(*args)`` through static buffers; captured in a CUDA graph on the
    first call whose inputs lie on a CUDA device, replayed after.  With
    ``in_place``, ``fn`` writes into its arguments' tensors (module
    docstring)."""

    def __init__(self, fn: Callable, name: str = "step", in_place: bool = False,
                 generator: Optional[torch.Generator] = None, warm_up: bool = True):
        self.fn = fn
        self.name = name
        self.in_place = in_place
        self.generator = generator  # registered with the graph: fn draws from it
        self.warm_up = warm_up
        self.inputs = None  # the static inputs: a clone of the first call's arguments
        self.outputs = None  # the static outputs
        self.graph = None
        self.bound = None  # in place: the addresses of the tensors the graph was made for
        # host seconds of the eager warm-up call and of the capture (with the
        # graph's instantiation, but where warm_up is off), on a CUDA device;
        # without warm-up, the instantiation's seconds, the graph's nodes and
        # the device memory its capture reserved (its private pool)
        self.warmup_s = self.capture_s = self.instantiate_s = self.nodes = None
        self.pool_bytes = None

    def __call__(self, *args):
        if self.in_place:
            return self._call_in_place(args)
        if self.inputs is None:
            self.inputs = tree_map(torch.clone, args)
        else:
            copy_into(self.inputs, args)
        leaves = tree_leaves(self.inputs)
        if leaves and leaves[0].device.type == "cuda":
            if self.graph is None:
                self._eager_on_side_stream(self.inputs)
                self.outputs = self._capture(self.inputs)
            self.graph.replay()
        else:
            out = self.fn(*self.inputs)
            if self.outputs is None:
                self.outputs = tree_map(torch.clone, out)
            else:
                copy_into(self.outputs, out)
        return self.outputs

    def _call_in_place(self, args) -> None:
        leaves = tree_leaves(args)
        if not (leaves and leaves[0].device.type == "cuda"):
            self.fn(*args)
            return
        bound = tuple(t.data_ptr() for t in leaves)
        if bound != self.bound:  # other tensors: this call is the warm-up
            self.graph, self.bound = None, bound
            if self.warm_up:
                self._eager_on_side_stream(args)
                return
        if self.graph is None:
            self._capture(args)
        self.graph.replay()

    def _eager_on_side_stream(self, args) -> None:
        """One eager call on a side stream, as capture asks of a first call."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0

    def _capture(self, args):
        """Capture ``fn(*args)`` into ``self.graph``; returns its outputs."""
        t0 = time.perf_counter()
        # a collection during the capture may free an unreachable graph, whose
        # reset is a CUDA call the capture refuses: collect first, and hold
        # the collector off while capturing
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph(keep_graph=not self.warm_up)
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        try:
            # thread_local: another thread's CUDA work (a process group's)
            # may go on during the capture; this thread's may not sync
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self.fn(*args)
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed: the call must launch kernels only, "
                f"with no read back to the host; build it with graphed=False to run it "
                f"eagerly") from err
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        if not self.warm_up:
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            self.nodes = graph_nodes(graph.raw_cuda_graph())
            t0 = time.perf_counter()
            graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
        self.graph = graph
        return outputs


def graph_nodes(raw_graph: int) -> int:
    """The nodes of a captured ``cudaGraph_t`` (kernels, copies and fills),
    counted by libcuda's ``cuGraphGetNodes``."""
    count = ctypes.c_size_t(0)
    status = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(raw_graph), None, ctypes.byref(count))
    if status != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {status}")
    return count.value
