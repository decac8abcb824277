"""pipeline.graph_share (share): the program's counters step_graph_reads
over step_reads: the share of the reads the SE fast step ran
(pipeline.Aligner.device_align_fast) whose step was replayed from CUDA
graphs rather than queued op by op. Counted over the tracer's whole time,
from just before the timed call (harness/program.py); absent where the
program has no such counters."""

from harness import program

LAYER = "device step, queued"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or not p.counters.get("step_reads"):
        return None
    return p.counters.get("step_graph_reads", 0) / p.counters["step_reads"]
