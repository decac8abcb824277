"""reads.offcpu_us_per_read (us/read): the read layer's main-thread time
off the CPU, per read: the wall time of the program's `reads` spans (each
step of io.reads.batch_iter, SE; the PE loop's batch of pairs) less the
main thread's CPU time in them (time.thread_time_ns): waits for the
interpreter lock that the finish threads hold, and for the input pipe
(reads.source_us_per_read). From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "read layer"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    return None if p is None else p.per_read_us(p.offcpu_ns("reads"))
