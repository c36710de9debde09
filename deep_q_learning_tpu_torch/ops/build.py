"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface.  At first use
``nvcc`` compiles it for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout, named after a hash of
the source and the flags, so an edited source is rebuilt; ``ctypes`` loads
it.  A build takes seconds: no PyTorch headers are involved.
"""

from __future__ import annotations

import ctypes
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
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / lib_path.name
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(out, lib_path)  # atomic: a concurrent loader sees all or nothing
        build_seconds[source_name] = time.perf_counter() - t0
        ptxas_reports[source_name] = proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib_path))


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
