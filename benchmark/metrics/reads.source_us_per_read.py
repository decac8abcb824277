"""reads.source_us_per_read (us/read): wall time of the raw reads under
the gzipped reads' decompressor (the program's counter input.source_ns,
io.reads), per read: the read layer waiting for the input pipe, a part of
reads.offcpu_us_per_read. From the program's tracer (harness/program.py)."""

from harness import program

LAYER = "read layer"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or "input.source_ns" not in p.counters:
        return None
    return p.per_read_us(p.counters["input.source_ns"])
