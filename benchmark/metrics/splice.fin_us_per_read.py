"""splice.fin_us_per_read (us/read): wall time in the program's
`finish.splice` spans, summed over the threads that run finishes, per
read: the vectorized finalization of the spliced records
(paired_rna._fin_mate_records' spliced rows, the SE spliced finish). From
the program's tracer (harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or not any(s.name == "finish.splice" for s in p.spans):
        return None
    return p.per_read_us(p.wall_ns("finish.splice"))
