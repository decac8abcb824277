"""GTF -> .ss splice-site file (reference hisat2_extract_splice_sites.py).

Output line: chrom <TAB> left <TAB> right <TAB> strand, 0-based, where
left = last base of the upstream exon, right = first base of the
downstream exon (reference :85 prints exon_end-1 / exon_start-1).
"""

from __future__ import annotations

import argparse
import sys

from .gtf import parse_transcripts


def extract_splice_sites(gtf_file, out=sys.stdout) -> int:
    trans = parse_transcripts(gtf_file)
    junctions = set()
    for chrom, strand, exons in trans.values():
        for i in range(1, len(exons)):
            junctions.add((chrom, exons[i - 1][1], exons[i][0], strand))
    for chrom, left, right, strand in sorted(junctions):
        out.write(f"{chrom}\t{left - 1}\t{right - 1}\t{strand}\n")
    return len(junctions)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hisat2_tpu_torch_extract_splice_sites",
        description="Extract splice junctions from a GTF file")
    ap.add_argument("gtf", type=argparse.FileType("r"))
    args = ap.parse_args(argv)
    extract_splice_sites(args.gtf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
