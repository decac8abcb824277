"""Batched affine-gap DP score: the CUDA kernel's wrapper.

Counterpart of hisat2_tpu/ops/dp_pallas.py. The kernel is
csrc/dp_score.cu (CUDA C++ for sm_90a), built with nvcc on first use into
the package's git-ignored `_build/kernels/` directory and bound through
ctypes to a plain C entry point. A CUDA tensor always goes through a
kernel; a CPU tensor always goes through the plain version,
ops/sw.dp_fill_plain. Windows of up to 256 columns (W + 1 <= 256, the SE
path) take the one-warp-per-candidate kernel, counted in
`launches["dp_score"]`; wider ones, up to 2,048 columns (the paired-end
mate rescue), the one-block-per-candidate kernel, counted in
`launches["dp_score_wide"]`. A window wider than that raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

from .sw import dp_fill_plain

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dp_score.cu")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"dp_score": 0, "dp_score_wide": 0}
_state: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the DP kernel builds only on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> tuple[str, str]:
    """Compile csrc/dp_score.cu into a shared library (once per process).
    Returns (library path, the compiler's -Xptxas -v report)."""
    if "lib_path" in _state:
        return _state["lib_path"], _state["ptxas"]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, "dp_score.so")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _state["lib_path"], _state["ptxas"] = so_path, proc.stderr
    return so_path, proc.stderr


def _lib() -> ctypes.CDLL:
    lib = _state.get("lib")
    if lib is None:
        lib = ctypes.CDLL(build()[0])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dp_score_launch.restype = ci
        lib.dp_score_launch.argtypes = [vp] * 6 + [ci] * 9 + [vp]
        for fn in (lib.dp_score_max_cols, lib.dp_score_warp_max_cols):
            fn.restype = ci
            fn.argtypes = []
        _state["lib"] = lib
    return lib


def warp_max_cols() -> int:
    """Widest window (W + 1 columns) of the one-warp kernel; wider ones
    take the one-block kernel. Builds the library on first use."""
    return _lib().dp_score_warp_max_cols()


def dp_score(rd: torch.Tensor, pen: torch.Tensor, rdlens: torch.Tensor,
             ref: torch.Tensor, scp_cum: torch.Tensor, *, match_bonus: int,
             n_pen: int, rd_open: int, rd_ext: int, rf_open: int,
             rf_ext: int) -> torch.Tensor:
    """Batched DP scores. rd (C, L) codes, pen (C, L) per-position
    mismatch penalties, rdlens (C,), ref (C, W) codes, scp_cum (C, L+1)
    cumulative soft-clip penalties (scp_cum[:, j] = clip cost of
    rd[0:j)); all int32. Returns (C,) int32 scores."""
    consts = dict(match_bonus=match_bonus, n_pen=n_pen, rd_open=rd_open,
                  rd_ext=rd_ext, rf_open=rf_open, rf_ext=rf_ext)
    if rd.device.type == "cpu":
        return dp_fill_plain(rd, pen, rdlens, ref, scp_cum, **consts)
    if rd.device.type != "cuda":
        raise ValueError(f"dp_score: no kernel for device {rd.device}")
    C, L = rd.shape
    W = ref.shape[1]
    shapes = {"rd": (rd, (C, L)), "pen": (pen, (C, L)),
              "rdlens": (rdlens, (C,)), "ref": (ref, (C, W)),
              "scp_cum": (scp_cum, (C, L + 1))}
    for name, (t, shape) in shapes.items():
        if t.device != rd.device:
            raise ValueError(f"dp_score: {name} on {t.device}, rd on "
                             f"{rd.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"dp_score: {name} must be int32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dp_score: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"dp_score: {name} must be contiguous")
    lib = _lib()
    if W + 1 > lib.dp_score_max_cols():
        raise ValueError(f"dp_score: window W={W} exceeds the kernel's "
                         f"{lib.dp_score_max_cols() - 1}")
    out = torch.empty(C, dtype=torch.int32, device=rd.device)
    if C == 0:
        return out
    with torch.cuda.device(rd.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_score_launch(
            rd.data_ptr(), pen.data_ptr(), rdlens.data_ptr(), ref.data_ptr(),
            scp_cum.data_ptr(), out.data_ptr(), C, L, W, match_bonus, n_pen,
            rd_open, rd_ext, rf_open, rf_ext, stream)
    if err != 0:
        raise RuntimeError(f"dp_score kernel launch failed: CUDA error {err}")
    wide = W + 1 > warp_max_cols()
    launches["dp_score_wide" if wide else "dp_score"] += 1
    return out
