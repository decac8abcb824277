"""hisat2-build equivalent (reference hisat2_build.cpp:668 driver).

Builds the native index (<prefix>.npz + <prefix>.meta.json — the role of the
eight .ht2 files, SURVEY.md §2.2) from FASTA, optionally ingesting SNP
(--snp) files for the graph index.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hisat2-tpu-torch-build",
        description="Build a hisat2_tpu index from FASTA reference(s).")
    ap.add_argument("reference", help="comma-separated FASTA file(s)")
    ap.add_argument("prefix", help="output index prefix")
    ap.add_argument("--ftabchars", type=int, default=10,
                    help="ftab k-mer length (auto-shrunk for tiny refs)")
    ap.add_argument("-o", "--offrate", type=int, default=0,
                    help="sample the SA every 2^<int> values (0 = full SA)")
    ap.add_argument("--snp", default=None, help="SNP file (hisat2 .snp format)")
    ap.add_argument("--haplotype", default=None,
                    help=".haplotype file (phased variant groups)")
    ap.add_argument("--ss", default=None,
                    help="splice-site file (.ss, transcriptome-aware index)")
    ap.add_argument("--exon", default=None,
                    help="exon file (.exon; splice sites derived from exons)")
    ap.add_argument("--sharded", action="store_true",
                    help="force the genome-sharded index (automatic for "
                         "references over 2^31-2^28 joined bases)")
    ap.add_argument("--table-stride", type=int, default=0,
                    help="seed-table position sampling stride (0 = auto: "
                         "3 for shards over 1 Gbp, so several shards "
                         "stay HBM-resident; 1 = full table). The "
                         "offrate role of gfm.h _offs")
    ap.add_argument("--shard-bases", type=int, default=None,
                    help="max joined bases per shard (implies --sharded; "
                         "default 2^31-2^28)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from ..index.fm_index import build_fm_index
    from ..io.reference import load_reference

    t0 = time.time()
    paths = args.reference.split(",")
    ref = load_reference(paths)
    if not args.quiet:
        print(f"  joined reference: {ref.n} bp in {len(ref.names)} sequence(s)",
              file=sys.stderr)
    snps = haps = None
    if args.snp:
        from ..io.annotations import read_snps, read_haplotypes
        snps = read_snps(args.snp, ref)
        haps = (read_haplotypes(args.haplotype, ref, snps)
                if args.haplotype else None)
    from ..index.sharded import MAX_SHARD_BASES
    if args.sharded or args.shard_bases or ref.n > MAX_SHARD_BASES:
        # >2^31-bp (or forced) genomes: int32 shards, one fused-pipeline
        # compile for all shards (reference large-index .ht2l role)
        from ..index.sharded import build_sharded
        stride = args.table_stride or (
            3 if min(ref.n, args.shard_bases or MAX_SHARD_BASES)
            > 1_000_000_000 else 1)
        sh = build_sharded(ref, max_bases=args.shard_bases or
                           MAX_SHARD_BASES, snps=snps, haplotypes=haps,
                           table_stride=stride)
        if args.ss:
            sh.known_ss = _load_ss(args.ss, ref)
            if not args.quiet:
                print(f"  {sh.known_ss.shape[0]} splice sites baked into "
                      "sharded index (global coordinates)", file=sys.stderr)
        if args.exon:
            sh.known_exons = _load_exons(args.exon, ref)
        sh.save(args.prefix)
        if not args.quiet:
            print(f"  sharded index ({len(sh)} shard(s)"
                  f"{', graph' if snps is not None else ''}) written to "
                  f"{args.prefix}.shard*.npz ({time.time()-t0:.1f}s)",
                  file=sys.stderr)
        return 0
    if args.snp:
        from ..index.graph_index import build_graph_index
        fm = build_graph_index(ref, snps, ftab_k=args.ftabchars,
                               haplotypes=haps)
    else:
        fm = build_fm_index(ref, ftab_k=args.ftabchars,
                            offrate=args.offrate)
    if args.ss:
        fm.known_ss, fm.excluded_ss = _load_ss(args.ss, ref,
                                               with_excluded=True)
        if not args.quiet:
            print(f"  {fm.known_ss.shape[0]} splice sites baked into index"
                  + (f" ({fm.excluded_ss.shape[0]} excluded for "
                     "repetitive flanks)" if fm.excluded_ss.size else ""),
                  file=sys.stderr)
    if args.exon:
        fm.known_exons = _load_exons(args.exon, ref)
        if not args.quiet:
            print(f"  {fm.known_exons.shape[0]} exons baked into index",
                  file=sys.stderr)
        if not args.ss:
            print("warning: --exon without --ss: exons alone don't define "
                  "junctions; pass the .ss file from extract_splice_sites "
                  "(the reference's make_*_tran recipes pass both)",
                  file=sys.stderr)
    fm.save(args.prefix)
    if not args.quiet:
        print(f"  index written to {args.prefix}.npz "
              f"({time.time()-t0:.1f}s)", file=sys.stderr)
    return 0


def _joined_mapper(ref):
    """(name_to_tidx, to_joined) for text->joined coordinate mapping
    (per-chromosome sorted fragment lookup, not the O(F) per-site scan)."""
    import numpy as np
    name_to_tidx = {n: i for i, n in enumerate(ref.names)}
    by_tidx = {}
    for t in range(len(ref.names)):
        m = ref.frag_tidx == t
        order = np.argsort(ref.frag_toff[m])
        by_tidx[t] = (ref.frag_toff[m][order], ref.frag_len[m][order],
                      ref.frag_joined[m][order])

    def to_joined(tidx, pos):
        toffs, flens, fjoins = by_tidx[tidx]
        fi = int(np.searchsorted(toffs, pos, side="right")) - 1
        if fi < 0 or pos >= toffs[fi] + flens[fi]:
            return None
        return int(fjoins[fi] + pos - toffs[fi])

    return name_to_tidx, to_joined


def _strand_code(s: str) -> int:
    return 1 if s == "+" else (-1 if s == "-" else 0)


def _load_ss(path, ref, with_excluded: bool = False):
    """Map a .ss file to joined coordinates -> (K, 3) int64 array.

    with_excluded: also apply the reference's repetitive-flank exclusion
    (gfm.h:1736-1751: sites whose 16bp+16bp flanking context appears at
    more than one site are excluded from the index's search tables —
    they would explode the local-search combinatorics — but are still
    recorded for `hisat2-inspect --ss-all`); returns (included,
    excluded)."""
    import numpy as np
    from ..io.annotations import read_splice_sites
    name_to_tidx, to_joined = _joined_mapper(ref)
    rows = []
    for s in read_splice_sites(path):
        tidx = name_to_tidx.get(s.chrom)
        if tidx is None:
            continue
        jl = to_joined(tidx, s.left)
        jr = to_joined(tidx, s.right)
        if jl is None or jr is None:
            continue
        rows.append((jl, jr, _strand_code(s.strand)))
    arr = (np.asarray(rows, np.int64).reshape(-1, 3) if rows
           else np.zeros((0, 3), np.int64))
    if not with_excluded:
        return arr
    if arr.shape[0] == 0:
        return arr, arr
    # 32bp flank context key: 16 bases ending at the last exonic base +
    # 16 bases from the first exonic base (the reference extracts
    # [left-16, left) and [right+1, right+17) around the INTRON bounds)
    j = ref.joined
    n = j.size
    ok = (arr[:, 0] >= 15) & (arr[:, 1] + 16 <= n)
    off = np.arange(16)
    ctx = np.zeros((arr.shape[0], 32), np.uint8)
    a0 = np.clip(arr[:, 0] - 15, 0, n - 1)
    a1 = np.clip(arr[:, 1], 0, n - 16)
    ctx[:, :16] = j[np.clip(a0[:, None] + off[None, :], 0, n - 1)]
    ctx[:, 16:] = j[np.clip(a1[:, None] + off[None, :], 0, n - 1)]
    key = np.zeros(arr.shape[0], np.uint64)
    for c in range(32):
        key = (key << np.uint64(2)) | ctx[:, c].astype(np.uint64)
    _uniq, inv, cnt = np.unique(key, return_inverse=True,
                                return_counts=True)
    dup = (cnt[inv] > 1) & ok
    return arr[~dup], arr[dup]


def _load_exons(path, ref):
    """Map a .exon file to joined coordinates -> (K, 3) int64 array
    (the reference stores exons as EXON ALTs in .7.ht2, gfm_build
    exon loading; printed back by hisat2-inspect --exon)."""
    import numpy as np
    from ..io.annotations import read_exons
    name_to_tidx, to_joined = _joined_mapper(ref)
    rows = []
    for chrom, left, right, strand in read_exons(path):
        tidx = name_to_tidx.get(chrom)
        if tidx is None:
            continue
        jl = to_joined(tidx, left)
        jr = to_joined(tidx, right)
        if jl is None or jr is None:
            continue
        rows.append((jl, jr, _strand_code(strand)))
    return (np.asarray(rows, np.int64).reshape(-1, 3) if rows
            else np.zeros((0, 3), np.int64))


if __name__ == "__main__":
    sys.exit(main())
