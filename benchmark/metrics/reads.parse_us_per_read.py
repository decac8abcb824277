"""reads.parse_us_per_read (us/read): main-thread time inside the read
layer, per read. Spans: each step of io.reads.batch_iter (SE: gzip, FASTQ
parse, cli.align._reindex and io.reads.batchify inside it), each pair of
cli.align._reindex_pairs and each io.reads.batchify call (PE); a span
inside another of the read layer counts once. The time includes waiting
for the interpreter lock that the finish threads hold."""

LAYER = "read layer"
SPANS = [("hisat2_tpu_torch.io.reads", "batch_iter", "iter", "reads"),
         ("hisat2_tpu_torch.cli.align", "_reindex_pairs", "iter", "reads"),
         ("hisat2_tpu_torch.io.reads", "batchify", "call", "reads")]


def read(ctx):
    ns = sum(t1 - t0 for tag, main, t0, t1, nested in ctx.spans
             if tag == "reads" and main and not nested)
    if ns == 0 or ctx.reads == 0:
        return None
    return ns / 1e3 / ctx.reads
