"""pipeline.step_us_per_read (us/read): the main thread's wall time in the
program's `submit.step` spans, per read: queueing the step's launches
(pipeline._stage_align_packed, paired.stage_pe_packed); a part of
pipeline.submit_us_per_read. From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "device step, queued"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(
        p.wall_ns("submit.step", main=True))
