"""Builds the package's CUDA sources (csrc/*.cu) with nvcc into shared
libraries with a plain C interface, loaded through ctypes by the kernels'
wrappers (ops/dp_cuda.py, ops/anchor_cuda.py).

Each source is compiled once a process, on first use, into the package's
git-ignored `_build/kernels/` directory; `build` runs one nvcc for each
source not yet built, all at once, and waits for them (`seconds` keeps
each compile's wall time; the process counter `kernel_build_ns` of
utils/metrics, the wall time `build` waited for them). Nothing here runs
when a module is imported: this package imports on machines without the
CUDA toolkit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils import metrics

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_built: dict[str, tuple[str, str]] = {}
seconds: dict[str, float] = {}     # source -> its compile's wall seconds


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _compile(src: str) -> tuple[str, str, float]:
    """nvcc on one source into BUILD_DIR/<stem>.so: (library path, the
    compiler's -Xptxas -v report, wall seconds). Raises if it fails."""
    stem = os.path.splitext(os.path.basename(src))[0]
    so_path = os.path.join(BUILD_DIR, f"{stem}.so")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path, proc.stderr, time.perf_counter() - t0


def build(*sources: str) -> list[tuple[str, str]]:
    """Compile each source (a path under csrc/) into BUILD_DIR/<stem>.so,
    once a process: one nvcc for each source not yet built, all at once.
    Returns, in the order given, (library path, the compiler's -Xptxas -v
    report) for each. Raises if a compile fails."""
    todo = [s for s in dict.fromkeys(sources) if s not in _built]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter_ns()
        with ThreadPoolExecutor(len(todo)) as pool:
            for src, (so_path, report, sec) in zip(todo,
                                                   pool.map(_compile, todo)):
                _built[src] = (so_path, report)
                seconds[src] = sec
        metrics.count_process("kernel_build_ns", time.perf_counter_ns() - t0)
    return [_built[s] for s in sources]
