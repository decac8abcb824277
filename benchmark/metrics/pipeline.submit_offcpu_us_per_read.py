"""pipeline.submit_offcpu_us_per_read (us/read): the main thread's time off
the CPU in the program's `submit` spans (align.emit.submit_se and
submit_pe: packing and uploads, queueing the step, the result copies), per
read: wall time less the thread's CPU time (time.thread_time_ns), the
waits for the interpreter lock and for the CUDA runtime. From the
program's tracer (harness/program.py)."""

from harness import program

LAYER = "device step, queued"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(p.offcpu_ns("submit"))
