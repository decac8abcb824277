"""pipeline.pack_us_per_read (us/read): the main thread's wall time in the
program's `submit.pack` spans, per read: packing the batch
(ReadBatch.packed) and uploading it; a part of
pipeline.submit_us_per_read. From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "device step, queued"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(
        p.wall_ns("submit.pack", main=True))
