"""The yardstick of the kernels: the card's peaks and the least work a
kernel's call needs.

Peaks: NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W (the
power limit is printed beside every result):

  HBM_BYTES_PER_S   3.35e12
  INT32_OPS_PER_S   16.75e12  the data sheet gives 67 TFLOP/s of float32
                              outside the tensor cores: 128 float32 lanes an
                              SM, an FMA counted 2; an SM has 64 int32
                              lanes, so int32 instructions issue at a
                              quarter of that figure

The DP fill (ops.dp_cuda.dp_score). A call of C candidates, L read rows
and a window of W bases fills, for candidate c, rdlens[c] rows of W + 1
columns: rows past a read's end are frozen and cost nothing that these
inputs need. Each cell needs at least DP_OPS_PER_CELL integer
instructions (chip_smoke.py's count, a fused add-max or three-way max
counted as one):

  substitution score   2   compare window and read base, select the score
  F                    1   max(H + (ext - open), F), rows kept with
                           row * ext added
  G                    1   max(Hdiag + s, F)
  running max          1   max(G + ext * j, run)
  E and H, clip floor  3   four values and two sums in three-input steps
  row maximum          0.5 one three-way max takes two cells

An exact fill need not use 32-bit lanes: the scores of these windows stay
within 16 bits (a read's score is at least minus its clip penalty, 2 a
base at most), and Hopper's DPX instructions add and take maxima on two
16-bit halves in one instruction (`__viaddmax_s16x2`, `__vimax3_s16x2`),
as upstream HISAT2's SSE path packs 16-bit lanes. So the bound counts
DP_LANES = 2 cells an instruction, and no exact kernel can read over 100%.
(Four 8-bit lanes would fit these scores too, but Hopper has no 8-bit
add-max: its 8-bit SIMD operations are emulated by several instructions,
so they cannot beat the 16-bit pairs.)

Bytes: each input read once and the scores written once, int32 each: rd
and pen (C x L), rdlens (C), ref (C x W), scp_cum (C x (L + 1)), the
overlay (C x W) where given, the scores (C).

The bound of a call is the larger of its bytes over the memory rate and
its instructions over DP_LANES times the int32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
DP_OPS_PER_CELL = 8.5
DP_LANES = 2


def dp_bytes(C: int, L: int, W: int, ov: bool) -> int:
    return 4 * (2 * C * L + C + C * W + C * (L + 1)
                + (C * W if ov else 0) + C)


def dp_bound_s(cells: int, C: int, L: int, W: int, ov: bool) -> float:
    """The least seconds a DP call can take: cells = sum of rdlens * (W + 1)."""
    return max(dp_bytes(C, L, W, ov) / HBM_BYTES_PER_S,
               cells * DP_OPS_PER_CELL / (DP_LANES * INT32_OPS_PER_S))
