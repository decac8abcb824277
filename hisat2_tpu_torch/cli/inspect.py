"""hisat2-inspect equivalent (reference hisat2_inspect.cpp:725).

Reconstructs reference FASTA from the index, prints names (-n), summary
(-s), or SNPs (--snp). The reference LF-walks the BWT to rebuild the text
(print_index_sequences :271); our index keeps the packed joined text +
fragment table, so reconstruction re-inserts N runs from the fragment map.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hisat2-tpu-torch-inspect")
    ap.add_argument("prefix")
    ap.add_argument("-n", "--names", action="store_true")
    ap.add_argument("-s", "--summary", action="store_true")
    ap.add_argument("--snp", action="store_true")
    ap.add_argument("--ss", action="store_true",
                    help="print splice sites baked into the index")
    ap.add_argument("--ss-all", dest="ss_all", action="store_true",
                    help="print splice sites including those not in the "
                         "global index (we bake every loadable site, so "
                         "this equals --ss; the reference additionally "
                         "keeps 'excluded' sites, hisat2_inspect.cpp:473)")
    ap.add_argument("--exon", action="store_true",
                    help="print exons baked into the index")
    ap.add_argument("-a", "--across", type=int, default=60,
                    help="bases per FASTA line")
    args = ap.parse_args(argv)

    from ..index.fm_index import FMIndex
    from ..utils import alphabet

    fm = FMIndex.load(args.prefix)
    ref = fm.ref
    w = sys.stdout.write

    if args.names:
        for n in ref.names:
            w(n + "\n")
        return 0
    if args.summary:
        w(f"Index\t{args.prefix}\n")
        w(f"Flags\tlinear-fm\n")
        w(f"Joined length\t{fm.n}\n")
        w(f"SA rows\t{fm.m}\n")
        w(f"ftab chars\t{fm.ftab_k}\n")
        w(f"Sequences\t{len(ref.names)}\n")
        for i, (n, l) in enumerate(zip(ref.names, ref.tlens)):
            w(f"Sequence-{i+1}\t{n}\t{int(l)}\n")
        return 0
    if args.snp:
        snps = getattr(fm, "snps", None)
        if snps is not None:
            for line in snps.to_snp_lines(ref):
                w(line + "\n")
        return 0
    if args.ss or args.ss_all or args.exon:
        rows = getattr(fm, "known_exons" if args.exon else "known_ss", None)
        if rows is None:
            rows = __import__("numpy").zeros((0, 3), "int64")
        if args.ss_all:
            # --ss-all additionally prints sites the build EXCLUDED for
            # repetitive flanks (hisat2_inspect.cpp:473
            # splicesite_all_only; gfm.h ss_seq duplicate check)
            exc = getattr(fm, "excluded_ss", None)
            if exc is not None and getattr(exc, "size", 0):
                import numpy as _np
                rows = _np.concatenate([rows, exc])
                rows = rows[_np.lexsort((rows[:, 1], rows[:, 0]))]
        for jl, jr, strand in rows:
            ll = ref.joined_to_text(int(jl))
            rr = ref.joined_to_text(int(jr))
            if ll is None or rr is None:
                continue
            sc = "+" if strand > 0 else ("-" if strand < 0 else ".")
            w(f"{ref.names[ll[0]]}\t{ll[1]}\t{rr[1]}\t{sc}\n")
        return 0

    # reconstruct per-chromosome sequence: N everywhere, fragments filled in
    for tidx, name in enumerate(ref.names):
        seq = np.full(int(ref.tlens[tidx]), 4, dtype=np.uint8)
        for f in range(len(ref.frag_joined)):
            if int(ref.frag_tidx[f]) != tidx:
                continue
            lo = int(ref.frag_toff[f])
            ln = int(ref.frag_len[f])
            jo = int(ref.frag_joined[f])
            seq[lo:lo + ln] = ref.joined[jo:jo + ln]
        w(f">{name}\n")
        s = alphabet.decode(seq)
        for i in range(0, len(s), args.across):
            w(s[i:i + args.across] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
