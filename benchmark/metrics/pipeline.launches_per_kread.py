"""pipeline.launches_per_kread (launches/kread): CUDA kernels of every kind
(the hand kernels and PyTorch's own) in the traced window, per 1,000
reads."""

LAYER = "device step, queued"
SPANS = []


def read(ctx):
    if ctx.trace is None or ctx.trace.kernels == 0 or ctx.reads == 0:
        return None
    return ctx.trace.kernels / (ctx.reads / 1000.0)
