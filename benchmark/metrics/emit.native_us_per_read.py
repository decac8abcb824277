"""emit.native_us_per_read (us/read): wall time in the program's
`finish.native` spans, summed over the threads that run finishes, per
read: the native samfmt formatting of the reads the device step settled; a
part of emit.finish_us_per_read. From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(p.wall_ns("finish.native"))
