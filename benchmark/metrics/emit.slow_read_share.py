"""emit.slow_read_share (share): the program's counters slow_reads over
reads_finished: the share of the finished reads sent to the per-read
ladder (the slow rows of the native finishes, and every read of a batch
aligned at finish time). Counted over the tracer's whole time, from just
before the timed call (harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or not p.counters.get("reads_finished"):
        return None
    return p.counters.get("slow_reads", 0) / p.counters["reads_finished"]
