"""Batched affine-gap DP score: the CUDA kernel's wrapper.

Counterpart of hisat2_tpu/ops/dp_pallas.py. The kernel is
csrc/dp_score.cu (CUDA C++ for sm_90a), built with nvcc on first use into
the package's git-ignored `_build/kernels/` directory (ops/nvcc.py) and
bound through ctypes to a plain C entry point. A CUDA tensor always goes
through a kernel; a CPU tensor always goes through the plain version,
ops/sw.dp_fill_plain. `dispatch_plan` picks the kernel by the window, and
every window W >= 0 has one:
  * up to 256 columns (W + 1 <= 256, the SE path): the one-warp-per-
    candidate kernel, counted in `launches["dp_score"]`;
  * up to 2,048 columns (the paired-end mate rescue at -X up to 1943 for
    100 bp reads): the one-block-per-candidate kernel in one pass (4
    warps, 3 to 16 columns a lane), counted in `launches["dp_score_wide"]`;
  * wider: the same kernel walking the window in column tiles of 128 *
    CPL columns (CPL in TILE_CPLS), carrying each read row's last H and
    running-max prefix from one tile to the next in shared memory, counted
    in `launches["dp_score_tiled"]`.
With `ov` (the SNV-overlay nibbles of a graph index's windows) each kernel
runs in its overlay instantiation, the same variant the window takes
without one, counted in `launches["dp_score_ov"]` as well. The JAX
package has no overlay in its TPU kernel and runs its plain scan there.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from . import nvcc
from .sw import dp_fill_plain

SOURCE = os.path.join(nvcc.CSRC, "dp_score.cu")

NARROW_MAX_COLS = 256     # widest window (W + 1) of the one-warp kernel
MAX_COLS = 2048           # widest window (W + 1) of one one-block pass
WIDE_WARPS = 4            # warps per candidate of the one-block kernel
# (warps, columns per lane) the one-block kernel is compiled for in one
# pass: capacities of 384 to 2,048 columns in steps of 128
WIDE_VARIANTS = tuple((WIDE_WARPS, k) for k in range(3, 17))
# columns per lane of the column-tiled form (tiles of 128 * CPL columns)
TILE_CPLS = (4, 8, 12, 16)

launches = {"dp_score": 0, "dp_score_wide": 0, "dp_score_tiled": 0,
            "dp_score_ov": 0}
_state: dict = {}


class Plan(NamedTuple):
    """Which kernel fills a window, and in what shape."""
    kernel: str       # the key in `launches`
    warps: int        # warps per candidate
    cpl: int          # adjacent columns per lane

    @property
    def tiled(self) -> bool:
        """Walks the window in tiles of `capacity` columns."""
        return self.kernel == "dp_score_tiled"

    @property
    def capacity(self) -> int:
        """Columns of one pass (of one tile, where tiled)."""
        return 32 * self.warps * self.cpl


def dispatch_plan(W: int) -> Plan:
    """The kernel variant for a window of W reference bases (W + 1 DP
    columns), with or without the SNV overlay: the smallest one-pass
    capacity that covers it, so fewer than one thread-row (32 * warps
    columns) is padding; past the widest one-pass variant, the fewest
    tiles of the widest tiled variant, each as narrow as TILE_CPLS allows
    with those tiles still covering the window."""
    cols = W + 1
    if W < 0:
        raise ValueError(f"dp_score: window W={W} < 0")
    if cols <= NARROW_MAX_COLS:
        return Plan("dp_score", 1, -(-cols // 32))
    row = 32 * WIDE_WARPS
    if cols <= row * WIDE_VARIANTS[-1][1]:
        return Plan("dp_score_wide", WIDE_WARPS, -(-cols // row))
    ntiles = -(-cols // (row * TILE_CPLS[-1]))
    cpl = min(c for c in TILE_CPLS if row * c * ntiles >= cols)
    return Plan("dp_score_tiled", WIDE_WARPS, cpl)


def build() -> tuple[str, str]:
    """Compile csrc/dp_score.cu into a shared library (once per process).
    Returns (library path, the compiler's -Xptxas -v report)."""
    return nvcc.build(SOURCE)[0]


def _lib() -> ctypes.CDLL:
    lib = _state.get("lib")
    if lib is None:
        lib = ctypes.CDLL(build()[0])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dp_score_launch.restype = ci
        lib.dp_score_launch.argtypes = [vp] * 7 + [ci] * 12 + [vp]
        lib.dp_score_fused_form.restype = ci
        lib.dp_score_fused_form.argtypes = []
        _state["lib"] = lib
    return lib


def fused_form() -> bool:
    """Whether the library's cell update was compiled on the fused add-max
    and three-way-max intrinsics (else on their plain forms). Builds the
    library on first use."""
    return bool(_lib().dp_score_fused_form())


def dp_score(rd: torch.Tensor, pen: torch.Tensor, rdlens: torch.Tensor,
             ref: torch.Tensor, scp_cum: torch.Tensor, *, match_bonus: int,
             n_pen: int, rd_open: int, rd_ext: int, rf_open: int,
             rf_ext: int, ov: torch.Tensor | None = None,
             plan: Plan | None = None) -> torch.Tensor:
    """Batched DP scores. rd (C, L) codes, pen (C, L) per-position
    mismatch penalties, rdlens (C,), ref (C, W) codes, scp_cum (C, L+1)
    cumulative soft-clip penalties (scp_cum[:, j] = clip cost of
    rd[0:j)); ov, where given, (C, W) SNV-overlay nibbles of the window
    bases (0 none, 1..4 alt code + 1, 15 several: a mismatch on a known
    alt allele scores as a match); all int32. Any W >= 0. Returns (C,)
    int32 scores. `plan` overrides dispatch_plan's choice of variant
    (measurements only)."""
    consts = dict(match_bonus=match_bonus, n_pen=n_pen, rd_open=rd_open,
                  rd_ext=rd_ext, rf_open=rf_open, rf_ext=rf_ext)
    if rd.device.type == "cpu":
        return dp_fill_plain(rd, pen, rdlens, ref, scp_cum, ov=ov, **consts)
    if rd.device.type != "cuda":
        raise ValueError(f"dp_score: no kernel for device {rd.device}")
    C, L = rd.shape
    W = ref.shape[1]
    shapes = {"rd": (rd, (C, L)), "pen": (pen, (C, L)),
              "rdlens": (rdlens, (C,)), "ref": (ref, (C, W)),
              "scp_cum": (scp_cum, (C, L + 1))}
    if ov is not None:
        shapes["ov"] = (ov, (C, W))
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
    if plan is None:
        plan = dispatch_plan(W)
    lib = _lib()
    out = torch.empty(C, dtype=torch.int32, device=rd.device)
    if C == 0:
        return out
    with torch.cuda.device(rd.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_score_launch(
            rd.data_ptr(), pen.data_ptr(), rdlens.data_ptr(), ref.data_ptr(),
            scp_cum.data_ptr(), None if ov is None else ov.data_ptr(),
            out.data_ptr(), C, L, W, match_bonus, n_pen,
            rd_open, rd_ext, rf_open, rf_ext, plan.warps, plan.cpl,
            int(plan.tiled), stream)
    if err != 0:
        raise RuntimeError(f"dp_score kernel launch refused or failed for "
                           f"W={W}, {plan}: CUDA error {err}")
    launches[plan.kernel] += 1
    if ov is not None:
        launches["dp_score_ov"] += 1
    return out
