"""ops.dp_roofline (%): the DP kernel against its bound over the window:
the sum of the bound times of the window's ops.dp_cuda.dp_score calls
(harness/roofline.py: shapes and read lengths from the wrapper on
dp_score) over the sum of the device times of the DP kernels' launches
(dp_score_kernel, dp_score_wide_kernel, dp_score_ring_kernel; from the
trace). The count and the peaks are derived in harness/roofline.py."""

import re

from harness import roofline

LAYER = "kernels"
SPANS = []
KERNEL = re.compile(r"\bdp_score(_wide|_ring)?_kernel\b")


def read(ctx):
    if ctx.trace is None or not ctx.dp_shapes:
        return None
    dev_ns = sum(b - a for name, a, b, kind in ctx.trace.ops
                 if kind == "kernel" and KERNEL.search(name))
    if dev_ns == 0:
        return None
    bound = sum(roofline.dp_bound_s(int(lens.sum()) * (W + 1), C, L, W, ov)
                for C, L, W, ov, lens in ctx.dp_shapes)
    return 100.0 * bound / (dev_ns / 1e9)
