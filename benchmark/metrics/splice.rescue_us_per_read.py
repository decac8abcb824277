"""splice.rescue_us_per_read (us/read): wall time in the program's
`finish.rescue` spans, summed over the threads that run finishes, per
read: the spliced PE finish's splice rescue and novel-site rounds
(paired_rna._rna_rescue_rounds), on the main thread where the spliced
stream runs its finishes serially. From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "host finish"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or not any(s.name == "finish.rescue" for s in p.spans):
        return None
    return p.per_read_us(p.wall_ns("finish.rescue"))
