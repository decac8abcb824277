"""Flagship-scale validation: a snp_tran-style sharded GRAPH index and
paired-end RNA alignment at human scale, the PyTorch port of hisat2_tpu's
scripts/scale_rna_validate.py (the reference's GRCh38 snp_tran
configuration, scripts/make_grch38_snp_tran.sh).

The genome is synthetic: 16 chromosomes (3.2 Gbp by default), about one
SNV a kb baked into graph shards (build_sharded(ref, snps=...,
table_stride=2)), about 6,000 planted multi-exon genes a Gbp with
GT..AG introns. 100 bp FR pairs sample the spliced transcripts with 0.5%
mismatches and go through ShardedAligner.align_and_emit_pe with
opts.spliced = True, then a full second pass. The run reports build and
align seconds, device and host memory, %concordant, and exonic and
junction placement against the planted truth, as one JSON line printed
last.

    python -m hisat2_tpu_torch.tools.scale_rna_validate           # on the card
    python -m hisat2_tpu_torch.tools.scale_rna_validate --device cpu \\
        --bases 3200000 --pairs 512 --batch 256                   # small, CPU

Half the genes' splice sites go into `sh.known_ss`, as in the JAX script,
and, as there, nothing reads them: ShardedAligner takes known sites only
through its host aligner's ssdb (cli/align.py loads `known_ss` into it),
so every junction of the run is found as a novel one (ROADMAP Queue C).

At the default size the run needs about 44 GB of host memory
(host_need_rna); it stops before the build when less is available.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

import numpy as np

from .scale_validate import (GiB, NCHROM, build_or_load, check_host_memory,
                             device_report, log, open_device, peak_rss,
                             reference_of, shard_sizes, write_report)

RDLEN = 100


def plant_genes(joined, rng, n_genes, lo, hi):
    """Gene structures in [lo, hi): exon/intron runs with GT..AG motifs
    written in place. Returns list of exon lists [(start, len), ...]."""
    genes = []
    pos = lo + 1000
    while len(genes) < n_genes and pos < hi - 30000:
        nex = int(rng.integers(2, 6))
        exons = []
        for _ in range(nex):
            elen = int(rng.integers(80, 300))
            exons.append((pos, elen))
            ie = pos + elen
            ilen = int(2 ** rng.uniform(8, 15))
            joined[ie:ie + 2] = [2, 3]
            joined[ie + ilen - 2:ie + ilen] = [0, 2]
            pos += elen + ilen
        genes.append(exons)
        pos += int(rng.integers(2000, 12000))
    return genes


def make_genome(bases: int, genes_per_gbp: int, rng):
    """The random joined text with genes planted chromosome by chromosome
    (bases // NCHROM each). Returns (joined, genes)."""
    clen = bases // NCHROM
    joined = rng.integers(0, 4, bases, dtype=np.uint8)
    n_genes = max(64, int(genes_per_gbp * bases / 1e9))
    log(f"planting {n_genes} genes")
    genes = []
    per_chrom = n_genes // NCHROM
    for c in range(NCHROM):
        genes += plant_genes(joined, rng, per_chrom, c * clen,
                             (c + 1) * clen)
    return joined, genes


def make_snps(joined: np.ndarray, snp_rate: float, rng):
    """About len(joined) * snp_rate SNVs at distinct uniform positions
    (drawn with replacement, made unique, the first n kept), each alt !=
    ref. Returns the global SNPDB."""
    from ..io.annotations import SNP_SGL, SNPDB
    bases = joined.size
    clen = bases // NCHROM
    n_snp = int(bases * snp_rate)
    spos = np.unique(rng.integers(0, bases, int(n_snp * 1.01)))
    spos = spos[:n_snp]
    n_snp = spos.size
    salt = (joined[spos].astype(np.int64)
            + rng.integers(1, 4, n_snp)) % 4
    tidx = (spos // clen).astype(np.int64)
    return SNPDB(
        names=[f"s{i}" for i in range(n_snp)],
        types=np.full(n_snp, SNP_SGL, np.int8),
        jpos=spos.astype(np.int64),
        lens=np.ones(n_snp, np.int32),
        alt_codes=salt.astype(np.int8),
        ins_seqs=[np.zeros(0, np.uint8)] * n_snp,
        chroms=[f"chr{int(t) + 1}" for t in tidx],
        tpos=(spos - tidx * clen).astype(np.int64))


def baked_sites(genes) -> np.ndarray:
    """(K, 3) int64 [left, right, strand] of every second gene's introns
    (left = last exonic base, right = first exonic base after it)."""
    rows = []
    for g in genes[::2]:
        for k in range(len(g) - 1):
            rows.append((g[k][0] + g[k][1] - 1, g[k + 1][0], 1))
    return np.asarray(rows, np.int64).reshape(-1, 3)


def simulate_pairs(joined: np.ndarray, genes, n: int, batch: int, rng):
    """n FR pairs of RDLEN bp from random genes' spliced transcripts: a
    gap of 60-219 transcript bases between the mates, each base mismatched
    with probability 0.005, mate 2 reverse-complemented; named
    p{i}_{mate 1's joined start}_{junctions mate 1 crosses}. Returns
    (mate 1 batch, mate 2 batch) tuples of `batch` pairs padded to 104."""
    from ..io.reads import Read, batchify
    from ..utils import alphabet
    r1s, r2s = [], []
    q = np.full(RDLEN, 40, np.int8)
    while len(r1s) < n:
        g = genes[int(rng.integers(0, len(genes)))]
        jmap = np.concatenate([np.arange(s, s + ln) for s, ln in g])
        gap = int(rng.integers(60, 220))
        need = 2 * RDLEN + gap
        if jmap.size < need + 1:
            continue
        toff = int(rng.integers(0, jmap.size - need))
        jp1 = jmap[toff:toff + RDLEN]
        jp2 = jmap[toff + RDLEN + gap:toff + need]
        s1 = joined[jp1].copy()
        s2 = joined[jp2].copy()
        for s in (s1, s2):
            mm = rng.random(RDLEN) < 0.005
            s[mm] = (s[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
        s2 = alphabet.revcomp(s2)
        rid = len(r1s)
        nj1 = int((np.diff(jp1) != 1).sum())
        nm = f"p{rid}_{int(jp1[0])}_{nj1}"
        r1s.append(Read(nm, s1, q, rid))
        r2s.append(Read(nm, s2, q, rid))
    return [(batchify(r1s[i:i + batch], pad_to=104),
             batchify(r2s[i:i + batch], pad_to=104))
            for i in range(0, len(r1s), batch)]


def tally(text: str, names: list, clen: int) -> dict:
    """Over the primary mate-1 records (QNAME p{i}_{start}_{junctions}):
    proper pairs, unaligned mates 1, and mates 1 within 40 bp of their
    start, split by whether they cross a junction (then also with an N in
    the CIGAR)."""
    out = dict(conc=0, unal=0, exonic_correct=0, exonic_wrong=0,
               junction_correct=0, junction_wrong=0)
    tix = {nm: i for i, nm in enumerate(names)}
    for ln in text.splitlines():
        f = ln.split("\t", 6)
        flag = int(f[1])
        if flag & 256 or not (flag & 64):
            continue
        start, njunc = (int(x) for x in f[0].split("_")[1:3])
        if flag & 2:
            out["conc"] += 1
        if flag & 4:
            out["unal"] += 1
            continue
        near = abs(tix[f[2]] * clen + int(f[3]) - 1 - start) <= 40
        if njunc > 0:
            good = near and f[5].count("N") >= 1
            out["junction_correct" if good else "junction_wrong"] += 1
        else:
            out["exonic_correct" if near else "exonic_wrong"] += 1
    return out


def host_need_rna(bases: int, n_snp: int, max_bases: int) -> int:
    """Estimated peak host bytes of the graph build and the first upload:
    the joined text and the global SNV overlay (1 byte a base each); every
    shard padded to the largest, n bases, whose augmented text is about
    1.08 n (an 81 bp patch a SNV): the augmented text, the shard overlay
    (1), the stride-2 st_pos (2.16) and the packed text (0.27); the
    transient of pack_2bit over the augmented text (8.64); 500 bytes a
    SNV of Python objects (names, chromosome names, patch arrays); 4 GiB
    for the interpreter, torch, the CUDA context and the reads."""
    sizes = shard_sizes(bases, max_bases)
    n = max(sizes)
    return int(2 * bases + len(sizes) * 4.51 * n + 8.64 * n + 500 * n_snp
               + 4 * GiB)


def run(args, bake_ss: bool = True) -> dict:
    """The whole run. bake_ss=False leaves sh.known_ss unset (the tests
    show the result does not depend on it)."""
    from ..align.sharded import ShardedAligner
    from ..index.sharded import MAX_SHARD_BASES, build_sharded
    from ..io import sam as samio
    from ..ops import read_launches, zero_launches

    device = open_device(args.device)
    check_host_memory(
        host_need_rna(args.bases, int(args.bases * args.snp_rate),
                      MAX_SHARD_BASES),
        f"{args.bases} bp graph build")
    rng = np.random.default_rng(0)
    clen = args.bases // NCHROM
    t0 = time.time()
    log(f"generating {args.bases / 1e9:.2f} Gbp genome "
        f"({NCHROM} x {clen / 1e6:.0f} Mbp)")
    joined, genes = make_genome(args.bases, args.genes_per_gbp, rng)
    log(f"planting {args.snp_rate:.4f}/bp SNVs")
    snps = make_snps(joined, args.snp_rate, rng)
    gen_s = time.time() - t0
    ref = reference_of(joined)

    t0 = time.time()
    log("building sharded GRAPH index (SNVs baked)")
    sh = build_or_load(
        args.cache,
        f"scale_rna_{args.bases}_{args.snp_rate}_{args.genes_per_gbp}",
        lambda: build_sharded(ref, snps=snps, table_stride=2))
    ss = baked_sites(genes)
    if bake_ss:
        # the JAX script's "--ss" half: set here and, as there, read by
        # nothing (ShardedAligner takes known sites only through
        # sa.host.ssdb), so every junction below is found as novel
        sh.known_ss = ss
    build_s = time.time() - t0
    bundle = [int(s.bundle_nbytes()) for s in sh.shards]
    log(f"built {len(sh)} shard(s) in {build_s:.0f}s; {ss.shape[0]} splice "
        f"sites baked; bundle bytes {bundle}")

    t0 = time.time()
    batches = simulate_pairs(joined, genes, args.pairs, args.batch, rng)
    n_pairs = sum(len(b1) for b1, _ in batches)
    log(f"simulated {n_pairs} pairs ({time.time() - t0:.0f}s), "
        f"{len(batches)} batches")

    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    sal = ShardedAligner(sh, device=device)
    sal.opts.spliced = True
    buf = io.StringIO()
    w = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                        no_head=True)
    t0 = time.time()
    zero_launches()
    stats = sal.align_and_emit_pe(batches, w)
    align_s = time.time() - t0
    launches = read_launches()
    n_reads = 2 * n_pairs
    # a full second pass: the shards stay resident when they fit the
    # budget, so this is the pass without uploads
    t0 = time.time()
    w2 = samio.SamWriter(io.StringIO(), ref.names,
                         [int(x) for x in ref.tlens], no_head=True)
    sal.align_and_emit_pe(batches, w2)
    steady = n_reads / (time.time() - t0)

    dev_gb = []
    if device.type == "cuda":
        import torch
        dev_gb.append(round(torch.cuda.memory_allocated(device) / GiB, 2))
    rss = peak_rss()
    t = tally(buf.getvalue(), ref.names, clen)
    return dict(
        bases=args.bases, shards=len(sh), pairs=n_pairs,
        snps=len(snps), genes=len(genes), ss_baked=int(ss.shape[0]),
        gen_s=round(gen_s, 1), build_s=round(build_s, 1),
        align_s=round(align_s, 1),
        reads_per_s=round(n_reads / align_s, 1),
        steady_reads_per_s=round(steady, 1),
        pct_concordant=round(100 * t["conc"] / n_pairs, 2),
        exonic_correct=t["exonic_correct"], exonic_wrong=t["exonic_wrong"],
        junction_correct=t["junction_correct"],
        junction_wrong=t["junction_wrong"], mate1_unaligned=t["unal"],
        device_gb=dev_gb, host_rss_gb=round(rss / GiB, 1),
        stats={k: int(v) for k, v in stats.items()},
        device=device.type, uploads=sal.uploads, evictions=sal.evictions,
        upload_s=sal.upload_s, bundle_nbytes=bundle,
        host_peak_rss_bytes=rss, launches=launches, **device_report(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hisat2_tpu_torch.tools.scale_rna_validate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--bases", type=int, default=3_200_000_000)
    ap.add_argument("--pairs", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--snp-rate", type=float, default=0.001)
    ap.add_argument("--genes-per-gbp", type=int, default=6000)
    ap.add_argument("--out", help="also write the result as markdown here")
    ap.add_argument("--cache", help="directory for the built shards "
                    "(ShardedIndex.save/load); nothing is cached without it")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res = run(args)
    if args.out:
        write_report(
            args.out, "Flagship-scale snp_tran PE RNA validation, "
            "hisat2_tpu_torch",
            f"Synthetic {args.bases / 1e9:.1f} Gbp genome ({NCHROM} "
            f"chromosomes), {res['snps']} planted SNVs baked into a sharded "
            f"graph index, {res['genes']} planted genes ({res['ss_baked']} "
            f"splice sites set as sh.known_ss, which the aligner does not "
            f"read), {res['pairs']} 100 bp FR pairs from the transcripts "
            f"with 0.5% mismatches; device {res['device']} "
            f"({res['card']}).", res)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
