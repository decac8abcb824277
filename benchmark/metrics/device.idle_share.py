"""device.idle_share (share): 1 - the union of the kernel, copy and set
intervals over the traced window (from the spin marker after the window
opens to the one after the timed call returns)."""

from harness import trace as tr

LAYER = "device"
SPANS = []


def read(ctx):
    if ctx.trace is None:
        return None
    w0, w1 = ctx.trace.window
    if w1 <= w0:
        return None
    return 1.0 - tr.busy_ns(ctx.trace) / (w1 - w0)
