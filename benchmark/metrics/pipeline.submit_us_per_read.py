"""pipeline.submit_us_per_read (us/read): host time in align.emit.submit_se
and submit_pe, per read: queueing the device step (align.pipeline,
align.paired, align.paired_rna). A batch that the stream aligns at finish
time (per-base-quality pairs take the fused step there) spends almost
nothing here."""

LAYER = "device step, queued"
SPANS = [("hisat2_tpu_torch.align.emit", "submit_se", "call", "submit"),
         ("hisat2_tpu_torch.align.emit", "submit_pe", "call", "submit")]


def read(ctx):
    ns = sum(t1 - t0 for tag, _main, t0, t1, nested in ctx.spans
             if tag == "submit" and not nested)
    if ns == 0 or ctx.reads == 0:
        return None
    return ns / 1e3 / ctx.reads
