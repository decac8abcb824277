"""The yardstick of the anchor-scan kernel (ops.anchor_cuda.anchor_scan_core,
csrc/anchor_scan.cu): the least time a scan's window tests take at the
card's int32 rate (harness/roofline.py's INT32_OPS_PER_S, not edited here).

A window test asks whether the 8-mer at one of a text word's 16 shifts is
the read's anchor code. The program counts the tests its scans need
(counter `anchor.window_tests`, traced runs only): 16 a word, each row
testing words nearest first until it holds its NC-th hit, else to the end
of tile 0, or of its last tile where the deep branch was taken
(chip_smoke.anchor_need's rule). Each test needs at least
ANCHOR_OPS_PER_TEST integer instructions: one funnel shift of the word
pair serves two shifts, then an XOR with the anchor code in both 16-bit
halves, a zero test of both halves and an OR into the word's flags, four
instructions for two tests (chip_smoke.py's count).

The bound leaves the bytes out: the text words the rows read cost memory
time too, so the true bound is at least this one, and the share it gives
(ops.anchor_roofline) can only read low, never above what the kernel
reaches.
"""

from __future__ import annotations

from .roofline import INT32_OPS_PER_S

ANCHOR_OPS_PER_TEST = 2.0


def anchor_bound_s(window_tests: int) -> float:
    """The least seconds the scans' window tests can take."""
    return window_tests * ANCHOR_OPS_PER_TEST / INT32_OPS_PER_S
