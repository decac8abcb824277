"""stream.wait_us_per_read (us/read): the main thread's wall time in the
program's `stream.wait` spans, per read: align.emit._stream waiting on a
finish thread's result before it can queue more batches. From the
program's tracer (harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(
        p.wall_ns("stream.wait", main=True))
