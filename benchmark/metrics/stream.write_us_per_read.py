"""stream.write_us_per_read (us/read): the main thread's wall time in the
program's `stream.write` spans, per read: align.emit._stream writing a
finished batch's SAM to the output (a pipe the sink drains). From the
program's tracer (harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(
        p.wall_ns("stream.write", main=True))
