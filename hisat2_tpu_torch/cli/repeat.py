"""hisat2-repeat equivalent CLI (reference hisat2_repeat.cpp:778):
discover genome-wide repeats and write <base>.rep.fa / <base>.rep.info,
optionally building the repeat FM index (<base>.rep.npz)."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hisat2-tpu-torch-repeat",
        description="Find repeats and build the repeat database/index")
    ap.add_argument("reference", help="comma-separated FASTA file(s)")
    ap.add_argument("base", help="output base name")
    ap.add_argument("--repeat-length", type=int, default=100)
    ap.add_argument("--repeat-count", type=int, default=5)
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--save-sa", default=None, metavar="FILE",
                    help="persist the suffix array after construction "
                         "(reference hisat2-repeat --save-sa)")
    ap.add_argument("--load-sa", default=None, metavar="FILE",
                    help="reuse a previously saved suffix array")
    ap.add_argument("--no-index", action="store_true",
                    help="skip building the repeat FM index")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from ..io.reference import load_reference, reference_from_seqs
    from ..index.repeats import build_repeats
    from ..index.fm_index import build_fm_index
    from ..utils import alphabet

    t0 = time.time()
    ref = load_reference(args.reference.split(","))
    sa = None
    if args.load_sa:
        import numpy as np
        sa = np.load(args.load_sa)["sa"]
        if not args.quiet:
            print(f"  loaded suffix array from {args.load_sa}",
                  file=sys.stderr)
    elif args.save_sa:
        import numpy as np
        from ..index.suffix_array import build_suffix_array
        text = ref.joined if args.forward_only else np.concatenate(
            [ref.joined, alphabet.revcomp(ref.joined)])
        sa = build_suffix_array(text)
        np.savez(args.save_sa, sa=sa)
        if not args.quiet:
            print(f"  suffix array saved to {args.save_sa}",
                  file=sys.stderr)
    db = build_repeats(ref, args.repeat_length, args.repeat_count,
                       forward_only=args.forward_only, sa=sa)
    db.save(args.base)
    if not args.quiet:
        print(f"  {len(db.repeats)} repeats "
              f"({sum(len(r.positions) for r in db.repeats)} placements) "
              f"written to {args.base}.rep.fa ({time.time()-t0:.1f}s)",
              file=sys.stderr)
    if not args.no_index and db.repeats:
        rep_ref = reference_from_seqs(
            {r.name: alphabet.decode(r.seq) for r in db.repeats})
        fm = build_fm_index(rep_ref)
        fm.save(args.base + ".rep")
        # read pre-classifier minimizer set (reference RB_KmerTable,
        # built alongside the RFM)
        import numpy as np
        from ..index.repeats import build_kmer_table
        np.save(args.base + ".rep.kmer.npy", build_kmer_table(db))
        if not args.quiet:
            print(f"  repeat index written to {args.base}.rep.npz",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
