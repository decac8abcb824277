"""Read-length statistics (reference hisat2_read_statistics.py role): the
wrapper feeds these to the aligner for repeat-index read-length-group
selection. Prints count / min / max / mean and a length histogram."""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from ..io.reads import read_reads


def read_stats(paths, fmt=None, sample: int = 10000):
    lengths = Counter()
    n = 0
    for p in paths:
        for r in read_reads(p, fmt):
            lengths[len(r)] += 1
            n += 1
            if n >= sample:
                break
        if n >= sample:
            break
    return lengths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hisat2_tpu_torch_read_statistics")
    ap.add_argument("reads", help="comma-separated read files")
    ap.add_argument("-n", "--sample", type=int, default=10000,
                    help="number of reads to sample")
    args = ap.parse_args(argv)
    lengths = read_stats(args.reads.split(","), sample=args.sample)
    total = sum(lengths.values())
    if total == 0:
        print("0 reads")
        return 0
    mean = sum(l * c for l, c in lengths.items()) / total
    print(f"reads: {total}, min: {min(lengths)}, max: {max(lengths)}, "
          f"mean: {mean:.1f}")
    for l in sorted(lengths):
        print(f"{l}\t{lengths[l]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
