"""ops.anchor_roofline (%): the anchor-scan kernel against its bound over
the run: the bound time of the program's counted window tests
(harness/anchor_roofline.py: the counter `anchor.window_tests` of the
program's tracer, harness/program.py) over the device time of the anchor
scan's launches in the trace (anchor_scan_tile0 and anchor_scan_deep).
Nothing where the program counts no window tests (an older checkout) or
the trace holds no anchor-scan launch."""

import re

from harness import anchor_roofline, program

LAYER = "kernels"
SPANS = program.SPANS
KERNEL = re.compile(r"\banchor_scan_(tile0|deep)\b")
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or ctx.trace is None:
        return None
    tests = p.counters.get("anchor.window_tests")
    dev_ns = sum(b - a for name, a, b, kind in ctx.trace.ops
                 if kind == "kernel" and KERNEL.search(name))
    if not tests or dev_ns == 0:
        return None
    return 100.0 * anchor_roofline.anchor_bound_s(tests) / (dev_ns / 1e9)
