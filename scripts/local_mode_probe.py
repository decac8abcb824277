#!/usr/bin/env python3
"""Local mode (`Scoring.local_default()`: match bonus 2, score_min G,20,8)
through the JAX package on the CPU: one error-free 100 bp read (SE stream
and align_batch) and one error-free FR pair (PE stream and align_pairs),
printed beside Scoring.min_score(100) and the linear score_min value the
device steps compute, ceil(I + S * L).

    JAX_PLATFORMS=cpu python scripts/local_mode_probe.py
"""

import io
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hisat2_tpu.align import emit, paired  # noqa: E402
from hisat2_tpu.align.pipeline import Aligner, results_to_sam  # noqa: E402
from hisat2_tpu.align.scoring import Scoring  # noqa: E402
from hisat2_tpu.index.fm_index import build_fm_index  # noqa: E402
from hisat2_tpu.io import sam as samio  # noqa: E402
from hisat2_tpu.io.reads import Read, batchify  # noqa: E402
from hisat2_tpu.io.reference import reference_from_seqs  # noqa: E402
from hisat2_tpu.utils import alphabet  # noqa: E402


def main():
    g = np.random.default_rng(0).integers(0, 4, 20000).astype(np.uint8)
    ref = reference_from_seqs({"chrL": alphabet.decode(g)})
    fm = build_fm_index(ref)
    sc = Scoring.local_default()
    q = np.full(100, 40, np.int8)
    se = batchify([Read("r0", g[5000:5100].copy(), q, 0)], pad_to=104)
    b1 = batchify([Read("p0", g[8000:8100].copy(), q, 0)], pad_to=104)
    b2 = batchify([Read("p0", alphabet.revcomp(g[8200:8300]), q, 0)],
                  pad_to=104)
    print(f"Scoring.min_score(100) = {sc.min_score(100)}; device steps' "
          f"ceil(I + S * L) = "
          f"{math.ceil(sc.score_min.I + sc.score_min.S * 100)}; perfect "
          f"score {sc.perfect_score(100)}")

    def run(what, fn):
        buf = io.StringIO()
        w = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                            no_head=True)
        st = fn(Aligner(fm, scoring=sc), w)
        w.flush()
        print(f"== {what}: stats {st}")
        for ln in buf.getvalue().splitlines():
            f = ln.split("\t")
            print("  " + "\t".join(f[:9] + f[11:]))

    run("SE, align_and_emit_stream",
        lambda al, w: emit.align_and_emit_stream(al, [se], w))
    run("SE, align_batch + results_to_sam",
        lambda al, w: results_to_sam(se, al.align_batch(se), al, w))
    run("PE, align_and_emit_pe_stream",
        lambda al, w: emit.align_and_emit_pe_stream(al, [(b1, b2)], w))
    run("PE, align_pairs + pairs_to_sam",
        lambda al, w: paired.pairs_to_sam(
            b1, b2, paired.align_pairs(al, b1, b2), al, w))


if __name__ == "__main__":
    main()
