"""``ops/build.py``'s build at first use when several processes start
together, as the ranks of a run that share a checkout do: one ``nvcc``
runs, the others wait for it and load its library.  A stand-in ``nvcc``
(this host has none) counts its calls and copies a shared library that
``ctypes`` can load into place."""

import subprocess
import sys
import textwrap
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def test_concurrent_first_builds_run_nvcc_once(tmp_path):
    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    calls = tmp_path / "calls.txt"
    some_library = Path(torch.__file__).parent / "lib" / "libc10.so"
    nvcc = cuda_home / "bin" / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import shutil, sys, time
        with open({str(calls)!r}, "a") as f:
            f.write("call\\n")
        time.sleep(1.0)
        shutil.copy({str(some_library)!r}, sys.argv[sys.argv.index("-o") + 1])
    """))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    code = (
        "import sys; from pathlib import Path; from deep_q_learning_tpu_torch.ops import build; "
        "build.BUILD_DIR = Path(sys.argv[1]); build.load_library('k.cu', Path(sys.argv[2])); "
        "print(sorted(build.build_seconds))"
    )
    env = {"CUDA_HOME": str(cuda_home), "PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build"), str(csrc)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert calls.read_text().count("call") == 1
    assert sorted(o for o, _ in outs) == ["['k.cu']\n", "[]\n", "[]\n"]
    assert len(list((tmp_path / "build").glob("k-*.so"))) == 1
