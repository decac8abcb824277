"""emit.finish_us_per_read (us/read): thread time in align.emit.finish_se
and finish_pe, per read: the wait for the step's results, the native
samfmt finish, the ladder, the RNA PE finish, and in the fused PE path the
whole step. Summed over the threads that run finishes: three DNA SE
finish threads overlap, so this can exceed the window's time per read."""

LAYER = "host finish"
SPANS = [("hisat2_tpu_torch.align.emit", "finish_se", "call", "finish"),
         ("hisat2_tpu_torch.align.emit", "finish_pe", "call", "finish")]


def read(ctx):
    ns = sum(t1 - t0 for tag, _main, t0, t1, nested in ctx.spans
             if tag == "finish" and not nested)
    if ns == 0 or ctx.reads == 0:
        return None
    return ns / 1e3 / ctx.reads
