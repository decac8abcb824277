"""GTF -> .exon file (reference hisat2_extract_exons.py).

Output line: chrom <TAB> left <TAB> right <TAB> strand, 0-based inclusive,
with overlapping exons across transcripts merged (reference :76-104).
"""

from __future__ import annotations

import argparse
import sys

from .gtf import parse_transcripts


def extract_exons(gtf_file, out=sys.stdout) -> int:
    trans = parse_transcripts(gtf_file)
    all_exons = set()
    for chrom, strand, exons in trans.values():
        for l, r in exons:
            all_exons.add((chrom, l, r, strand))
    exons_sorted = sorted(all_exons)
    if not exons_sorted:
        return 0
    merged = [exons_sorted[0]]
    for exon in exons_sorted[1:]:
        prev = merged[-1]
        if exon[0] != prev[0] or prev[2] < exon[1]:
            merged.append(exon)
            continue
        if prev[2] < exon[2]:
            strand = prev[3] if prev[3] in "+-" else exon[3]
            merged[-1] = (prev[0], prev[1], exon[2], strand)
    for chrom, left, right, strand in merged:
        out.write(f"{chrom}\t{left - 1}\t{right - 1}\t{strand}\n")
    return len(merged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hisat2_tpu_torch_extract_exons",
        description="Extract exons from a GTF file")
    ap.add_argument("gtf", type=argparse.FileType("r"))
    args = ap.parse_args(argv)
    extract_exons(args.gtf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
