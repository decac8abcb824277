"""The numbers that decide `correct`, worked out once the window has
closed, and their judgement against the cell's limits
(`benchmark/limits/<workload>.json`).

  missing         reads the feeder wrote whose primary record never came
  extra           primary records beyond one a read the feeder wrote
                  (a read or a batch written twice)
  dp_wrong        candidates of the sampled DP calls whose kernel score is
                  not the reference's (reference/dp.py, int32)
  anchor_wrong    rows of the sampled anchor-scan calls whose answer is not
                  the reference's (reference/anchor.py, from the genome)
  records_wrong   records of the sampled reads whose CIGAR, SEQ, QUAL or
                  tags disagree with the genome (reference/samcheck.py)
  misplaced       share of the sampled reads (each mate one) whose primary
                  record is not where the generator took the read from

The reference imports nothing of the program: it gets numpy arrays and
tensors that the harness copied out of the run, the genome, the variants
and the reads.
"""

from __future__ import annotations

import numpy as np

from . import anchor as anchor_ref
from . import samcheck
from .dp import dp_fill


def dp_wrong(kept, device) -> tuple[int, int]:
    """(candidates that differ, candidates compared) over kept DP calls:
    (inputs dict of tensors, the six constants, the kernel's scores)."""
    wrong = total = 0
    for ins, consts, out in kept:
        ins = {k: v.to(device) for k, v in ins.items()}
        ref = dp_fill(ins["rd"], ins["pen"], ins["rdlens"], ins["ref"],
                      ins["scp_cum"], ov=ins.get("ov"), **consts)
        wrong += int((ref.cpu() != out.cpu()).sum())
        total += int(out.numel())
    return wrong, total


def anchor_wrong(kept, genome) -> tuple[int, int]:
    if not kept:
        return 0, 0
    kx = anchor_ref.KmerIndex(genome, int(kept[0][0]["A"]))
    wrong = total = 0
    for ins, kv, mpos in kept:
        ins = {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
               for k, v in ins.items()}
        ins["min_intron"] = int(np.asarray(ins["min_intron"]))
        w, t = anchor_ref.count_wrong(kx, ins, kv.cpu().numpy().astype(bool),
                                      mpos.cpu().numpy())
        wrong += w
        total += t
    return wrong, total


def records(kept: dict, pool, sample, genome, known) -> dict:
    """records_wrong and misplaced over the sampled reads (pool indices),
    from the sink's records of each read's first appearance."""
    wrong = seen = misplaced = reads = 0
    first_bad = None
    for i in sample:
        lines = kept.get(pool.names[i], [])
        prim = [None] * pool.mates
        for ln in lines:
            rec = samcheck.parse(ln)
            m = 0 if pool.mates == 1 or rec["flag"] & 64 else 1
            seen += 1
            why = samcheck.check_record(rec, pool.seqs[m, i],
                                        pool.quals[m, i], genome, known)
            if why is not None:
                wrong += 1
                first_bad = first_bad or f"{pool.names[i]}: {why}"
            if not rec["flag"] & 0x900:
                prim[m] = rec
        for m in range(pool.mates):
            reads += 1
            if not samcheck.placed_right(prim[m], pool.gpos[m, i],
                                         bool(pool.rev[m, i])):
                misplaced += 1
    return {"records_wrong": wrong, "records_checked": seen,
            "misplaced": misplaced / max(reads, 1), "reads_checked": reads,
            "first_bad": first_bad}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit. Correct when every one is
    read and none is over it; a number with nothing to compare (no kernel
    call kept, no record seen) reads None and fails."""
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
