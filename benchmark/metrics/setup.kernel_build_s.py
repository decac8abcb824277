"""setup.kernel_build_s (s): the wall time ops.nvcc.build waited for the
CUDA kernels' compiles in this process (the program's process counter
kernel_build_ns; the warm-up's builds, in set-up). 0 where nothing was
built (the CPU). From the program's tracer (harness/program.py)."""

from harness import program

LAYER = "set-up"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.counters.get("kernel_build_ns", 0) / 1e9
