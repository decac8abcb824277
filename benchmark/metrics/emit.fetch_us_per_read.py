"""emit.fetch_us_per_read (us/read): wall time in the program's
`finish.fetch` spans, the finishes waiting for their step's result copies
(the `ready` event), summed over the threads that run finishes, per read:
the finishes' wait for the card. The same spans feed the --met table's
t_fetch. From the program's tracer (harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(p.wall_ns("finish.fetch"))
