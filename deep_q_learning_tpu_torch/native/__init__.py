"""Native (C++) host runtime: the replay ring buffer + uniform sampler of
the host-compat training loop (``compat/host_loop.py``), bound with
``ctypes`` (``deep_q_learning_tpu/native/__init__.py``).

The source is the port's own copy (``replay_buffer.cc``), with the JAX
package's ``extern "C"`` interface and random stream.  At first use ``g++``
compiles it into ``build/torch_native/`` at the root of the checkout,
named after a hash of the source and the flags, under a file lock
(``ops/build.py::cached_build``).  There is no fallback: without a C++
compiler the loader raises.  The storage is host memory by design; the
device path keeps its replay on the device (``replay/``).
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

from deep_q_learning_tpu_torch.ops.build import PACKAGE_DIR, cached_build

SOURCE = Path(__file__).resolve().parent / "replay_buffer.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def find_cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: the host replay buffer "
            f"({SOURCE.name}) is compiled at first use and has no fallback"
        )
    return found


def build_library() -> Path:
    """The compiled buffer under :data:`BUILD_DIR`, built if it is missing
    or stale."""

    def compile_to(out: Path) -> None:
        proc = subprocess.run(
            [find_cxx(), *CXX_FLAGS, str(SOURCE), "-o", str(out)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )

    return cached_build(SOURCE, CXX_FLAGS, BUILD_DIR, compile_to)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and load; cached per process."""
    lib = ctypes.CDLL(str(build_library()))
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
    lib.rb_destroy.restype = None
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = ctypes.c_int64
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_int64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rb_add.restype = None
    lib.rb_add.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int32, ctypes.c_float, f32p, ctypes.c_uint8,
    ]
    lib.rb_add_batch.restype = None
    lib.rb_add_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, f32p, i32p, f32p, f32p, u8p,
    ]
    lib.rb_sample.restype = None
    lib.rb_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, f32p, i32p, f32p, f32p, u8p,
    ]
    return lib


def _rows(name: str, x, dtype, shape) -> np.ndarray:
    """``x`` as a C-contiguous array of ``dtype``; raises unless its shape
    is ``shape`` (the C side copies exactly that many values)."""
    a = np.ascontiguousarray(x, dtype)
    if a.shape != shape:
        raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    return a


class HostReplayBuffer:
    """numpy-facing wrapper over the C++ ring buffer.

    Mirrors the reference ``ReplayBuffer`` + ``sample_batch`` semantics
    (preallocated circular storage, overwrite-oldest, uniform sampling with
    replacement), with the JAX package's methods: ``add``, ``add_batch``,
    ``sample``, ``size``, ``capacity``."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0):
        if capacity < 1 or obs_dim < 1:
            raise ValueError(f"capacity {capacity} and obs_dim {obs_dim} must be positive")
        self._lib = load_library()
        self._handle = self._lib.rb_create(capacity, obs_dim, seed)
        self.capacity = capacity
        self.obs_dim = obs_dim

    def close(self) -> None:
        """Free the C++ storage (also on garbage collection)."""
        if getattr(self, "_handle", None):
            self._lib.rb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    @property
    def size(self) -> int:
        return self._lib.rb_size(self._handle)

    def add(self, obs, action: int, reward: float, next_obs, done: bool) -> None:
        d = (self.obs_dim,)
        self._lib.rb_add(
            self._handle,
            _rows("obs", np.reshape(obs, -1), np.float32, d),
            int(action),
            float(reward),
            _rows("next_obs", np.reshape(next_obs, -1), np.float32, d),
            int(bool(done)),
        )

    def add_batch(self, obs, action, reward, next_obs, done) -> None:
        obs = np.ascontiguousarray(obs, np.float32)
        n = obs.shape[0]
        self._lib.rb_add_batch(
            self._handle,
            n,
            _rows("obs", obs, np.float32, (n, self.obs_dim)),
            _rows("action", action, np.int32, (n,)),
            _rows("reward", reward, np.float32, (n,)),
            _rows("next_obs", next_obs, np.float32, (n, self.obs_dim)),
            _rows("done", done, np.uint8, (n,)),
        )

    def sample(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        """``batch_size`` transitions drawn uniformly with replacement:
        ``(obs, action, reward, next_obs, done)``, ``done`` bool."""
        if batch_size < 0:
            raise ValueError(f"batch_size {batch_size} is negative")
        obs = np.empty((batch_size, self.obs_dim), np.float32)
        action = np.empty((batch_size,), np.int32)
        reward = np.empty((batch_size,), np.float32)
        next_obs = np.empty((batch_size, self.obs_dim), np.float32)
        done = np.empty((batch_size,), np.uint8)
        self._lib.rb_sample(self._handle, batch_size, obs, action, reward, next_obs, done)
        return obs, action, reward, next_obs, done.astype(bool)
