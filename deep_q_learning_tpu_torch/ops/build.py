"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface.  At first use
``nvcc`` compiles it for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout, named after a hash of
the source, the headers it includes from ``csrc/`` and the flags, so an
edited source is rebuilt; ``ctypes`` loads it.  A build takes seconds: no
PyTorch headers are involved.  A source may add flags of its own
(``SOURCE_FLAGS``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the envs' steps round every product and sum, as PyTorch's elementwise
# kernels do (csrc/lander_solver.cu, csrc/lander_rigid.cu, csrc/lander_jointed.cu,
# csrc/classic_envs.cu)
SOURCE_FLAGS = {"lander_solver.cu": ("--fmad=false",), "lander_rigid.cu": ("--fmad=false",),
                "lander_jointed.cu": ("--fmad=false",), "classic_envs.cu": ("--fmad=false",)}

# seconds spent in nvcc by this process, and ptxas's report, by source file name
build_seconds: dict = {}
ptxas_reports: dict = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the CUDA "
            "kernels are built from source on the machine with the GPU"
        )
    return found


@functools.cache
def load_library(source_name: str, csrc_dir: Path = CSRC_DIR) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` (or ``<csrc_dir>/<source_name>``) if
    its build is missing or stale, and load it.  Cached per process."""
    source = csrc_dir / source_name
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(source_name, ())

    def compile_to(out: Path) -> None:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [find_nvcc(), *flags, "-o", str(out), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        build_seconds[source_name] = time.perf_counter() - t0
        ptxas_reports[source_name] = proc.stdout + proc.stderr

    return ctypes.CDLL(str(cached_build(source, flags, BUILD_DIR, compile_to)))


def cached_build(source: Path, flags, build_dir: Path, compile_to) -> Path:
    """The library built from ``source`` with ``flags``: under ``build_dir``,
    named after a hash of the source, the headers it includes
    (:func:`included`) and the flags, so an edited source or header is
    rebuilt.  Where it is missing,
    ``compile_to(path)`` writes it to a temporary path that then replaces it
    atomically (a loader sees all or nothing).  One build at a time: processes that start together (the
    ranks of a run that share a checkout) wait on a file lock and then find
    the library; the kernel releases the lock if its holder dies."""
    content = source.read_bytes() + b"".join(h.read_bytes() for h in included(source))
    digest = hashlib.sha256(content + " ".join(flags).encode()).hexdigest()
    lib_path = build_dir / f"{source.stem}-{digest[:16]}.so"
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        with open(build_dir / f"{lib_path.stem}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
                    out = Path(tmp) / lib_path.name
                    compile_to(out)
                    os.replace(out, lib_path)
    return lib_path


def included(source: Path) -> list:
    """The headers ``source`` includes by a quoted name from its own
    directory, and theirs in turn (``csrc/lander_jointed.cu`` includes
    ``lander_jointed.cuh``, which includes ``lander_frame.cuh`` and
    ``lander_solver.cuh``); a CPU test's host build of a ``.cuh`` takes
    them too."""
    found, todo = [], [source]
    while todo:
        for name in re.findall(r'^#include "([^"]+)"', todo.pop().read_text(), re.M):
            path = source.parent / name
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def ptxas_summary(report: str) -> dict:
    """``{kernel: {"registers", "smem", "spill_stores", "spill_loads"}}`` from
    a ``-Xptxas -v`` report; a kernel is named by its function and its
    template arguments (``slot_warp_kernel<4,1>``)."""
    out, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"[a-z_]+_kernel", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = (base.group(0) if base else mangled) + (f"<{','.join(args)}>" if args else "")
            out[name] = {"registers": 0, "smem": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, spills.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[name]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out
