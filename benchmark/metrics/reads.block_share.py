"""reads.block_share (share): the program's counters reads_block over
reads_batched: the share of the reads io.reads.batch_iter yielded that
the native FASTQ block parser put into their batch (the rest went read by
read through batchify). Counted over the tracer's whole time, from just
before the timed call (harness/program.py)."""

from harness import program

LAYER = "read layer"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or not p.counters.get("reads_batched"):
        return None
    return p.counters.get("reads_block", 0) / p.counters["reads_batched"]
