"""Batched affine-gap DP score: the CUDA kernel's wrapper.

Counterpart of hisat2_tpu/ops/dp_pallas.py. The kernel is
csrc/dp_score.cu (CUDA C++ for sm_90a), built with nvcc on first use into
the package's git-ignored `_build/kernels/` directory (ops/nvcc.py) and
bound through ctypes to a plain C entry point. A CUDA tensor always goes
through a kernel; a CPU tensor always goes through the plain version,
ops/sw.dp_fill_plain. `dispatch_plan` picks the kernel by the window and
the candidates, and every window W >= 0 has one:
  * up to 384 columns (W + 1 <= 384: the SE path, graph reads of 250 bp):
    the one-warp-per-candidate kernel, 1 to 12 columns a lane, counted in
    `launches["dp_score"]`;
  * up to 2,048 columns (the paired-end mate rescue at -X up to 1943 for
    100 bp reads): the one-block-per-candidate kernel in one pass (4
    warps in lockstep, 4 to 16 columns a lane), counted in
    `launches["dp_score_wide"]`;
  * wider (reads of about 2 kb and more): the ring kernel, NW warps a
    candidate (2 to RING_MAX_WARPS[CPL]) at CPL columns a lane (3 to 12)
    handing each row on through rings in shared memory, in one pass up to
    ONE_PASS_COLS (5,376 columns) and in column tiles past it, counted in
    `launches["dp_score_ring"]`.
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

NARROW_MAX_COLS = 384     # widest window (W + 1) of the one-warp kernel
NARROW_BLOCK = 4          # candidates (warps) a block of the one-warp kernel
MAX_COLS = 2048           # widest window (W + 1) of the lockstep kernel
WIDE_WARPS = 4            # warps per candidate of the lockstep kernel
# (warps, columns per lane) the lockstep kernel is compiled for:
# capacities of 512 to 2,048 columns in steps of 128
WIDE_VARIANTS = tuple((WIDE_WARPS, k) for k in range(4, 17))
# columns a lane of the ring kernel, and the most warps a block may have
# at each (csrc/dp_score.cu kRingMaxWarps: its __launch_bounds__ leave a
# thread 65,536 / (32 * warps) registers)
RING_CPLS = tuple(range(3, 13))
RING_MAX_WARPS = {k: 32 if k <= 4 else 28 if k <= 5 else 24 if k <= 7
                  else 16 if k <= 10 else 12 for k in RING_CPLS}
# widest window (W + 1) one pass of the ring kernel covers
ONE_PASS_COLS = max(32 * k * RING_MAX_WARPS[k] for k in RING_CPLS)
RING = 4                  # slots of each ring between neighbouring warps
# columns a lane the ring kernel is planned at where the launch fills the
# card (the fewest instructions a cell without the registers of wider
# lanes), and the warps an SM should have for it to be full (below, more
# warps at fewer columns a lane hide the rows' latency); measured on the
# H100 with scripts/dp_kernel_bench.py --sweep (PERF.md, section 6)
RING_CPL = 12
FILL_WARPS = 8
SMS = 132                 # streaming multiprocessors of an H100 SXM

launches = {"dp_score": 0, "dp_score_wide": 0, "dp_score_ring": 0,
            "dp_score_ov": 0}
_state: dict = {}


class Plan(NamedTuple):
    """Which kernel fills a window, and in what shape."""
    kernel: str       # the key in `launches`
    warps: int        # warps per candidate
    cpl: int          # adjacent columns per lane

    @property
    def ring(self) -> bool:
        """The ring kernel: any number of warps, column tiles past one
        pass."""
        return self.kernel == "dp_score_ring"

    @property
    def capacity(self) -> int:
        """Columns of one pass (of one tile, for the ring kernel)."""
        return 32 * self.warps * self.cpl

    def tiles(self, W: int) -> int:
        """Passes over a window of W + 1 columns."""
        return -(-(W + 1) // self.capacity) if self.ring else 1


def _ring_plan(cols: int, nw: int) -> Plan:
    """The ring kernel at `nw` warps, or the fewest more (else the most
    fewer) that the lane widths allow: at n warps, the fewest columns a
    lane that cover `cols` (so fewer than one thread-row, 32 * n columns,
    is padding)."""
    nw = max(nw, 2)
    for n in [*range(nw, 33), *range(nw - 1, 1, -1)]:
        cpl = max(RING_CPLS[0], -(-cols // (32 * n)))
        if cpl <= RING_CPLS[-1] and n <= RING_MAX_WARPS[cpl]:
            return Plan("dp_score_ring", n, cpl)
    raise ValueError(f"dp_score: no one-pass ring plan for {cols} columns")


def dispatch_plan(W: int, C: int | None = None) -> Plan:
    """The kernel variant for a window of W reference bases (W + 1 DP
    columns) and C candidates, with or without the SNV overlay:
      * W + 1 <= 384: the one-warp kernel at ceil((W + 1) / 32) columns a
        lane;
      * up to 2,048: the lockstep kernel at ceil((W + 1) / 128) columns a
        lane;
      * up to ONE_PASS_COLS: the ring kernel in one pass, with the warps
        that take RING_CPL columns a lane; where C candidates of those
        warps leave the card short of FILL_WARPS warps an SM, more warps
        (down to 3 columns a lane) until they do; no more warps than a
        lane width allows;
      * past that: column tiles of RING_MAX_WARPS[RING_CPL] warps at
        RING_CPL columns a lane."""
    cols = W + 1
    if W < 0:
        raise ValueError(f"dp_score: window W={W} < 0")
    if cols <= NARROW_MAX_COLS:
        return Plan("dp_score", 1, -(-cols // 32))
    if cols <= MAX_COLS:
        return Plan("dp_score_wide", WIDE_WARPS, -(-cols // (32 * WIDE_WARPS)))
    if cols > ONE_PASS_COLS:
        return Plan("dp_score_ring", RING_MAX_WARPS[RING_CPL], RING_CPL)
    nw = -(-cols // (32 * RING_CPL))
    if C:
        fill = -(-FILL_WARPS * SMS // C)
        nw = max(nw, min(fill, -(-cols // (32 * RING_CPLS[0]))))
    return _ring_plan(cols, nw)


def plans_for(W: int) -> list[Plan]:
    """Every plan the compiled kernels take for a window of W (the
    measurements' alternatives): the one-warp kernel where it covers the
    window; the lockstep kernel at each lane width that covers it; the
    ring kernel in one pass at each lane width (the fewest warps that
    cover the window at that width, then the fewest columns a lane that
    cover it with those warps) where the warp limit allows; past one
    pass, its column tiles at each width's most warps."""
    cols = W + 1
    out = []
    if cols <= NARROW_MAX_COLS:
        out.append(Plan("dp_score", 1, -(-cols // 32)))
    out += [Plan("dp_score_wide", w, k) for w, k in WIDE_VARIANTS
            if 32 * w * k >= cols]
    for k in RING_CPLS:
        n = max(2, -(-cols // (32 * k)))
        p = Plan("dp_score_ring", n, max(RING_CPLS[0], -(-cols // (32 * n))))
        if (p.cpl <= RING_CPLS[-1] and n <= RING_MAX_WARPS[p.cpl]
                and p not in out):
            out.append(p)
    if cols > ONE_PASS_COLS:
        out += [Plan("dp_score_ring", RING_MAX_WARPS[k], k)
                for k in RING_CPLS]
    return out


def smem_bytes(plan: Plan, L: int, W: int) -> int:
    """Dynamic shared memory of one block of a launch: the one-warp
    kernel's staged rows of each warp, the lockstep kernel's staged rows,
    the ring kernel's rows, rings, edge slots, tile carries (past one
    pass), row counts and best scores (csrc/dp_score.cu ring_smem)."""
    if plan.warps == 1:
        return NARROW_BLOCK * 16 * L
    if not plan.ring:
        return 16 * L
    return (16 * L + 8 * (plan.warps * RING + 2)
            + (8 * L if plan.tiles(W) > 1 else 0) + 8 * plan.warps)


def plan_geometry(plan: Plan, C: int, L: int, W: int, rows: int):
    """(threads a block, blocks, dynamic shared bytes a block, tiles,
    steps of a block for `rows` read rows, the ptxas report's variant name
    without its closing '>') of a launch: the one-warp kernel runs a row a
    step; the lockstep kernel's warps rows + 3 steps; the ring kernel's
    warps pipeline over the rows of every tile, rows * tiles + warps - 1
    steps."""
    smem = smem_bytes(plan, L, W)
    if plan.warps == 1:
        return (32 * NARROW_BLOCK, -(-C // NARROW_BLOCK), smem, 1, rows,
                f"dp_score_kernel<CPL={plan.cpl}")
    if not plan.ring:
        return (32 * plan.warps, C, smem, 1, rows + plan.warps - 1,
                f"dp_score_wide_kernel<CPL={plan.cpl}")
    tiles = plan.tiles(W)
    return (32 * plan.warps, C, smem, tiles, rows * tiles + plan.warps - 1,
            f"dp_score_ring_kernel<CPL={plan.cpl}")


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
        plan = dispatch_plan(W, C)
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
            int(plan.ring), stream)
    if err != 0:
        raise RuntimeError(f"dp_score kernel launch refused or failed for "
                           f"W={W}, {plan}: CUDA error {err}")
    launches[plan.kernel] += 1
    if ov is not None:
        launches["dp_score_ov"] += 1
    return out
