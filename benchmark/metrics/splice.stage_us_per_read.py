"""splice.stage_us_per_read (us/read): the main thread's wall time in the
program's `submit.splice` spans, per read: queueing the spliced step's
splice pass (ops/splice.spliced_stage: lane enumeration, junction scoring
and gates, the anchor scan) inside `submit.step`. From the program's tracer
(harness/program.py)."""

from harness import program

LAYER = "device step, queued"
SPANS = program.SPANS
program.reset()


def read(ctx):
    p = program.collect(ctx)
    if p is None or not any(s.name == "submit.splice" for s in p.spans):
        return None
    return p.per_read_us(p.wall_ns("submit.splice", main=True))
