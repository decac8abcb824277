"""Shared GTF parsing for the extract tools.

Behavioral contract matches the reference extract scripts
(hisat2_extract_splice_sites.py:30-75): exon features only, attributes
gene_id/transcript_id required, per-transcript exons sorted and merged when
the separating intron is <= 5bp.
"""

from __future__ import annotations

from collections import defaultdict
from typing import IO


def parse_transcripts(gtf_file: IO) -> dict[str, tuple[str, str, list[list[int]]]]:
    """transcript_id -> (chrom, strand, [[left, right], ...]) with 1-based
    inclusive GTF coordinates, exons merged across <=5bp gaps."""
    trans: dict[str, tuple] = {}
    for line in gtf_file:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "#" in line:
            line = line.split("#")[0].strip()
        f = line.split("\t")
        if len(f) != 9:
            continue
        chrom, _src, feature, left, right, _score, strand, _frame, attrs = f
        if feature != "exon":
            continue
        left, right = int(left), int(right)
        if left >= right:
            continue
        vals = {}
        for attr in attrs.split(";"):
            attr = attr.strip()
            if attr:
                k, _, v = attr.partition(" ")
                vals[k] = v.strip('"')
        if "gene_id" not in vals or "transcript_id" not in vals:
            continue
        tid = vals["transcript_id"]
        if tid not in trans:
            trans[tid] = (chrom, strand, [[left, right]])
        else:
            trans[tid][2].append([left, right])

    for tid, (chrom, strand, exons) in trans.items():
        exons.sort()
        merged = [exons[0]]
        for l, r in exons[1:]:
            if l - merged[-1][1] <= 5:
                merged[-1][1] = max(merged[-1][1], r)
            else:
                merged.append([l, r])
        trans[tid] = (chrom, strand, merged)
    return trans
