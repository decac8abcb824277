"""emit.ladder_us_per_read (us/read): wall time in the program's
`finish.ladder` spans, summed over the threads that run finishes, per
read: the per-read Python ladder for the other reads (emit.slow_read_share
of them); a part of emit.finish_us_per_read. From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(p.wall_ns("finish.ladder"))
