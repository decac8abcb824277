"""Read simulator (reference hisat2_simulate_reads.py role): sample DNA or
RNA (transcriptome) reads from a genome (+GTF, +.snp), with mismatch
error model, emitting FASTA/FASTQ plus a ground-truth SAM for accuracy
scoring (the reference's evaluation framework consumes the same shape of
truth data, SURVEY.md §2.7)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.reference import load_reference
from ..io.annotations import read_snps
from ..utils import alphabet


def simulate(ref, rng, num_reads: int, read_len: int, *, paired=False,
             frag_len=250, error_rate=0.0, snp_db=None, snp_prob=0.33,
             transcripts=None):
    """Yield (name, seq_codes [, seq2_codes], truth) tuples.

    truth = (tidx, toff, fw) of the leftmost base (mate1 for PE).
    """
    joined = ref.joined
    n = joined.size
    span = frag_len if paired else read_len
    for i in range(num_reads):
        while True:
            p = int(rng.integers(0, n - span))
            loc = ref.joined_to_text(p, span)
            if loc is not None:
                break
        frag = joined[p:p + span].copy()
        # apply alt alleles with probability snp_prob
        if snp_db is not None and len(snp_db):
            lo = int(np.searchsorted(snp_db.jpos, p))
            hi = int(np.searchsorted(snp_db.jpos, p + span))
            for si in range(lo, hi):
                if snp_db.types[si] == 0 and rng.random() < snp_prob:
                    frag[int(snp_db.jpos[si]) - p] = snp_db.alt_codes[si]
        fw = bool(rng.random() < 0.5)

        def with_errors(codes):
            if error_rate > 0:
                m = rng.random(codes.size) < error_rate
                codes = codes.copy()
                codes[m] = (codes[m] + rng.integers(1, 4, int(m.sum()))) % 4
            return codes

        if paired:
            m1 = with_errors(frag[:read_len])
            m2 = alphabet.revcomp(with_errors(frag[-read_len:]))
            if not fw:
                m1, m2 = alphabet.revcomp(frag[-read_len:]), frag[:read_len]
                m1, m2 = with_errors(m1), with_errors(m2.copy())
            yield f"sim{i}", m1, m2, (*loc, fw)
        else:
            s = with_errors(frag)
            if not fw:
                s = alphabet.revcomp(s)
            yield f"sim{i}", s, None, (*loc, fw)


def simulate_rna(ref, trans, rng, num_reads: int, read_len: int, *,
                 paired=False, frag_len=250, error_rate=0.0):
    """Transcriptome (RNA) reads: sample positions in spliced transcript
    space, emit reads + GENOMIC truth (pos + M/N CIGAR across exons) —
    the reference simulator's --rna role."""
    name_to_tidx = {n: i for i, n in enumerate(ref.names)}
    tx = []
    for tid, (chrom, strand, exons) in trans.items():
        if chrom not in name_to_tidx:
            continue
        tlen = sum(e - s + 1 for s, e in exons)
        if tlen >= (frag_len if paired else read_len):
            tx.append((tid, name_to_tidx[chrom], exons, tlen))
    if not tx:
        raise SystemExit("no usable transcripts for the given genome")
    weights = np.asarray([t[3] for t in tx], np.float64)
    weights /= weights.sum()

    def project(tidx, exons, tpos, length):
        """Transcript-space [tpos, tpos+length) -> genomic pos + CIGAR."""
        cig = []
        gpos = None
        remaining = length
        off = tpos
        for k, (s, e) in enumerate(exons):
            elen = e - s + 1
            if off >= elen:
                off -= elen
                continue
            take = min(elen - off, remaining)
            if gpos is None:
                gpos = s - 1 + off
            cig.append(("M", take))
            remaining -= take
            if remaining == 0:
                break
            nxt = exons[k + 1]
            cig.append(("N", nxt[0] - e - 1))
            off = 0
        return gpos, cig

    span = frag_len if paired else read_len
    for i in range(num_reads):
        ti = int(rng.choice(len(tx), p=weights))
        tid, tidx, exons, tlen = tx[ti]
        tp = int(rng.integers(0, tlen - span + 1))
        # transcript sequence for the sampled window
        seq = []
        gpos1, cig1 = project(tidx, exons, tp, read_len)
        chunks = []
        need = span
        off = tp
        for s, e in exons:
            elen = e - s + 1
            if off >= elen:
                off -= elen
                continue
            take = min(elen - off, need)
            jstart = ref.text_to_joined(tidx, s - 1 + off)
            chunks.append(ref.joined[jstart:jstart + take])
            need -= take
            off = 0
            if need == 0:
                break
        frag = np.concatenate(chunks)
        fw = bool(rng.random() < 0.5)

        def with_errors(codes):
            if error_rate > 0:
                m = rng.random(codes.size) < error_rate
                codes = codes.copy()
                codes[m] = (codes[m]
                            + rng.integers(1, 4, int(m.sum()))) % 4
            return codes

        if paired:
            gpos2, cig2 = project(tidx, exons, tp + frag_len - read_len,
                                  read_len)
            m1 = with_errors(frag[:read_len].copy())
            m2 = alphabet.revcomp(with_errors(frag[-read_len:].copy()))
            if not fw:
                m1, m2 = alphabet.revcomp(frag[-read_len:].copy()), \
                    frag[:read_len].copy()
                m1, m2 = with_errors(m1), with_errors(m2)
            yield (f"sim{i}", m1, m2,
                   (tidx, gpos1, fw, cig1, gpos2, cig2))
        else:
            s = with_errors(frag.copy())
            if not fw:
                s = alphabet.revcomp(s)
            yield f"sim{i}", s, None, (tidx, gpos1, fw, cig1, None, None)


def _cigar_str(cig):
    return "".join(f"{n}{op}" for op, n in cig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hisat2_tpu_torch_simulate_reads",
        description="Simulate reads from a reference genome")
    ap.add_argument("reference", help="FASTA file(s), comma-separated")
    ap.add_argument("base", help="output base name")
    ap.add_argument("--num-reads", type=int, default=10000)
    ap.add_argument("--read-length", type=int, default=100)
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--fragment-length", type=int, default=250)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--snp", default=None, help=".snp file to sample alts from")
    ap.add_argument("--gtf", default=None,
                    help="GTF: sample RNA reads from transcripts (genomic "
                         "truth CIGARs carry N gaps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fasta", action="store_true", help="emit FASTA not FASTQ")
    args = ap.parse_args(argv)

    ref = load_reference(args.reference.split(","))
    snp_db = read_snps(args.snp, ref) if args.snp else None
    rng = np.random.default_rng(args.seed)

    truth = open(args.base + ".truth.sam", "w")
    for tname, tlen in zip(ref.names, ref.tlens):
        truth.write(f"@SQ\tSN:{tname}\tLN:{int(tlen)}\n")

    def emit(fh, name, codes):
        s = alphabet.decode(codes)
        if args.fasta:
            fh.write(f">{name}\n{s}\n")
        else:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")

    ext = ".fa" if args.fasta else ".fq"
    if args.paired:
        f1 = open(args.base + "_1" + ext, "w")
        f2 = open(args.base + "_2" + ext, "w")
    else:
        f1 = open(args.base + ext, "w")
        f2 = None
    if args.gtf:
        from .gtf import parse_transcripts
        trans = parse_transcripts(args.gtf)
        for name, s1, s2, (tidx, g1, fw, cig1, g2, cig2) in simulate_rna(
                ref, trans, rng, args.num_reads, args.read_length,
                paired=args.paired, frag_len=args.fragment_length,
                error_rate=args.error_rate):
            emit(f1, name, s1)
            if s2 is not None:
                emit(f2, name, s2)
            flag = 0 if fw else 16
            truth.write(
                f"{name}\t{flag}\t{ref.names[tidx]}\t{g1 + 1}\t255\t"
                f"{_cigar_str(cig1)}\t*\t0\t0\t*\t*\n")
            if cig2 is not None:
                truth.write(
                    f"{name}\t{(16 if fw else 0) | 128}\t"
                    f"{ref.names[tidx]}\t{g2 + 1}\t255\t"
                    f"{_cigar_str(cig2)}\t*\t0\t0\t*\t*\n")
    else:
        for name, s1, s2, (tidx, toff, fw) in simulate(
                ref, rng, args.num_reads, args.read_length,
                paired=args.paired, frag_len=args.fragment_length,
                error_rate=args.error_rate, snp_db=snp_db):
            emit(f1, name, s1)
            if s2 is not None:
                emit(f2, name, s2)
            flag = 0 if fw else 16
            truth.write(f"{name}\t{flag}\t{ref.names[tidx]}\t{toff + 1}\t"
                        f"255\t{args.read_length}M\t*\t0\t0\t*\t*\n")
    for fh in (f1, f2, truth):
        if fh:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
