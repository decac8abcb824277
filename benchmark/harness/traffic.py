"""The one generator of the benchmark's traffic, driven by a traffic file
(`benchmark/traffic/<name>.json`) and a seed.

The read simulators are frozen copies of chip_smoke.py's (`simulate_reads`,
`simulate_pairs`, `simulate_gene_model`, `simulate_rna_pairs`,
`simulate_variants`, `apply_haplotype`), changed in three ways: every read
carries per-base qualities binned as a NovaSeq writes them, its errors fall
on its bases with the probability its quality states (so low-quality bases
take most of them), and each read keeps its truth as the genome position of
every base (`gpos`, -1 for an inserted base) in forward-strand order, with
`rev` set where the read as sequenced is the reverse complement.

Nothing here imports the program: the variants are plain arrays, and a
pool is plain FASTQ text compressed into gzip members.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

COMP = np.array([3, 2, 1, 0, 4], np.uint8)
LETTERS = np.frombuffer(b"ACGTN", np.uint8)


@dataclass
class Pool:
    """Reads as sequenced. SE: one mate; PE: mates 0 and 1 of each pair.
    seqs (M, n, L) uint8, quals (M, n, L) uint8 phred, gpos (M, n, L)
    int32 forward-strand genome positions, rev (M, n) bool."""
    names: list
    seqs: np.ndarray
    quals: np.ndarray
    gpos: np.ndarray
    rev: np.ndarray

    @property
    def mates(self) -> int:
        return self.seqs.shape[0]

    def __len__(self) -> int:
        return self.seqs.shape[1]


def names(t: dict, n: int) -> list:
    """Read names of a pool of n (pairs share a name)."""
    p = "r" if t["mix"] == "se_dna" else "p"
    return [f"{p}{i}" for i in range(n)]


# ---- deployment: genes and variants (frozen copies) ----------------------

def simulate_gene_model(codes: np.ndarray, seed: int, n_tx: int):
    """chip_smoke.simulate_gene_model: plant n_tx transcripts of 2-6 exons
    of 60-300 bp with introns of 60 to 50,000 bp (log-uniform), half on
    each strand, canonical motifs written at both ends of every intron
    (codes changed in place). Returns the kept transcripts as
    (strand, [(start, end), ...]) with 0-based, end-exclusive exons."""
    rng = np.random.default_rng(seed)
    txs = []
    for _ in range(n_tx):
        ne = int(rng.integers(2, 7))
        ex_len = rng.integers(60, 301, ne)
        in_len = np.exp(rng.uniform(np.log(60), np.log(50_000),
                                    ne - 1)).astype(np.int64)
        span = int(ex_len.sum() + in_len.sum())
        s = int(rng.integers(1000, codes.size - span - 1000))
        exons = []
        for k in range(ne):
            exons.append((s, s + int(ex_len[k])))
            s += int(ex_len[k]) + (int(in_len[k]) if k < ne - 1 else 0)
        strand = "+" if rng.random() < 0.5 else "-"
        motif = ([2, 3], [0, 2]) if strand == "+" else ([1, 3], [0, 1])
        for (_, e), (a, _) in zip(exons, exons[1:]):
            codes[e:e + 2] = motif[0]
            codes[a - 2:a] = motif[1]
        txs.append((strand, exons, motif))
    return [(st, ex) for st, ex, (dn, ac) in txs
            if all((codes[e:e + 2] == dn).all()
                   and (codes[a - 2:a] == ac).all()
                   for (_, e), (a, _) in zip(ex, ex[1:]))]


def simulate_variants(joined: np.ndarray, seed: int, every: int) -> dict:
    """chip_smoke.simulate_variants without phased pairs: one variant per
    `every` bp on a jittered grid, 90% SNVs, 5% deletions and 5%
    insertions of 1-3 bp. Returns sorted arrays pos, type (0 SNV, 1
    deletion, 2 insertion before pos), len, alt (SNV code, else -1) and
    ins (inserted codes per variant)."""
    rng = np.random.default_rng(seed)
    cells = np.arange((joined.size - 64) // every)
    off = rng.integers(8, every - 8, cells.size)
    pos = cells * every + off
    u = rng.random(pos.size)
    types = np.where(u < 0.90, 0, np.where(u < 0.95, 1, 2))
    lens = np.where(types == 0, 1, rng.integers(1, 4, pos.size))
    alt = np.where(types == 0,
                   (joined[pos] + rng.integers(1, 4, pos.size)) % 4, -1)
    ins = [rng.integers(0, 4, int(ln)).astype(np.uint8) if t == 2
           else np.zeros(0, np.uint8) for t, ln in zip(types, lens)]
    return {"pos": pos.astype(np.int64), "type": types.astype(np.int8),
            "len": lens.astype(np.int32), "alt": alt.astype(np.int8),
            "ins": ins}


def haplotype_transcripts(genome, genes, variants, seed: int):
    """chip_smoke.apply_haplotype, restricted to the exons: one
    individual's haplotype takes every known variant with probability 0.5.
    Returns per transcript (codes, gpos) of its spliced sequence on that
    haplotype (gpos -1 for an inserted base)."""
    rng = np.random.default_rng(seed)
    vp = variants["pos"] if variants is not None else np.zeros(0, np.int64)
    take = rng.random(vp.size) < 0.5
    out = []
    for _strand, exons in genes:
        gp = np.concatenate([np.arange(a, e) for a, e in exons])
        codes = genome[gp].copy()
        keep = np.ones(gp.size, bool)
        ins_at, ins_codes = [], []
        if vp.size:
            lo = np.searchsorted(vp, gp[0] - 4)
            hi = np.searchsorted(vp, gp[-1] + 1)
            for i in range(lo, hi):
                if not take[i]:
                    continue
                t, p = int(variants["type"][i]), int(vp[i])
                k = np.searchsorted(gp, p)
                if t == 0:
                    if k < gp.size and gp[k] == p:
                        codes[k] = variants["alt"][i]
                elif t == 1:
                    dl = int(variants["len"][i])
                    keep &= ~((gp >= p) & (gp < p + dl))
                elif k < gp.size and gp[k] == p and k > 0:
                    ins_at.append(k)
                    ins_codes.append(variants["ins"][i])
        gpos = gp.astype(np.int32)
        if ins_at:
            at = np.repeat(ins_at, [c.size for c in ins_codes])
            codes = np.insert(codes, at, np.concatenate(ins_codes))
            gpos = np.insert(gpos, at, -1)
            keep = np.insert(keep, at, True)
        out.append((codes[keep], gpos[keep]))
    return out


# ---- qualities and errors --------------------------------------------------

def draw_quals(rng, shape, q: dict) -> np.ndarray:
    """Binned per-base qualities: at read position i of L the bin
    probabilities run linearly from q["start"] to q["end"] (low bins grow
    toward the 3' end)."""
    n, L = shape
    bins = np.asarray(q["bins"], np.uint8)
    x = np.linspace(0.0, 1.0, L)[:, None]
    p = (1 - x) * np.asarray(q["start"]) + x * np.asarray(q["end"])
    cdf = np.cumsum(p / p.sum(axis=1, keepdims=True), axis=1)    # (L, K)
    u = rng.random((n, L))
    k = (u[:, :, None] > cdf[None, :, :]).sum(axis=2)
    return bins[np.minimum(k, bins.size - 1)]


def add_errors(rng, seqs: np.ndarray, quals: np.ndarray) -> None:
    """A base turns into another with probability 10^(-Q/10), Q its
    quality (in place)."""
    err = rng.random(seqs.shape) < 10.0 ** (-quals.astype(np.float64) / 10)
    seqs[err] = (seqs[err] + rng.integers(1, 4, int(err.sum()))) % 4


def _sequenced(rng, fwd, rev, qprof):
    """Reads as the sequencer reports them from forward-strand bases:
    reverse-complemented where rev, qualities drawn, errors added."""
    seqs = np.where(rev[:, None], COMP[fwd[:, ::-1]], fwd).astype(np.uint8)
    quals = draw_quals(rng, seqs.shape, qprof)
    add_errors(rng, seqs, quals)
    return seqs, quals


def _with_indel(rng, genome, s, d, p, L, insert):
    """chip_smoke._with_indel with truth: L bases read forward from
    genome[s], a d bp deletion after p read bases, or d random bases
    inserted there. Returns (codes, gpos)."""
    if insert:
        gp = np.concatenate([np.arange(s, s + p), np.full(d, -1),
                             np.arange(s + p, s + L - d)])
        codes = genome[np.maximum(gp, 0)].copy()
        codes[p:p + d] = rng.integers(0, 4, d)
        return codes, gp
    gp = np.concatenate([np.arange(s, s + p), np.arange(s + p + d, s + L + d)])
    return genome[gp].copy(), gp


# ---- the three read mixes --------------------------------------------------

def se_dna(genome, n, seed, t) -> Pool:
    """chip_smoke.simulate_reads: L bp reads from uniform starts, a share
    with one 1-3 bp indel in the middle three fifths, half reverse-
    complemented."""
    rng = np.random.default_rng(seed)
    L = int(t["read_len"])
    starts = rng.integers(0, genome.size - L - 8, n)
    gpos = (starts[:, None] + np.arange(L)).astype(np.int32)
    fwd = genome[gpos].copy()
    indel = rng.random(n) < float(t["indel_read_rate"])
    for i in np.flatnonzero(indel):
        s, d = int(starts[i]), int(rng.integers(1, 4))
        p = int(rng.integers(L // 5, L - L // 5))
        fwd[i], gpos[i] = _with_indel(rng, genome, s, d, p, L,
                                      rng.random() >= 0.5)
    rev = rng.random(n) < float(t["revcomp_rate"])
    seqs, quals = _sequenced(rng, fwd, rev, t["quality"])
    return Pool(names(t, n), seqs[None], quals[None], gpos[None], rev[None])


def pe_dna(genome, n, seed, t) -> Pool:
    """chip_smoke.simulate_pairs: FR pairs from fragments of the stated
    lengths, mate 1 the fragment's start, mate 2 the reverse complement of
    its end, a share of mates with one 1-3 bp indel, half the pairs with
    mates swapped."""
    rng = np.random.default_rng(seed)
    L = int(t["read_len"])
    flo, fhi = t["fragment"]
    frag = rng.integers(flo, fhi + 1, n)
    starts = rng.integers(0, genome.size - fhi - 20, n)
    ends = starts + frag - L
    fwd = np.empty((2, n, L), np.uint8)
    gpos = np.empty((2, n, L), np.int32)
    for m, s0 in enumerate((starts, ends)):
        gpos[m] = s0[:, None] + np.arange(L)
        fwd[m] = genome[gpos[m]]
    indel = rng.random((n, 2)) < float(t["indel_mate_rate"])
    for i, m in zip(*np.nonzero(indel)):
        d, p = int(rng.integers(1, 4)), int(rng.integers(20, 80))
        s = int(starts[i] if m == 0 else ends[i])
        fwd[m, i], gpos[m, i] = _with_indel(rng, genome, s, d, p, L,
                                            rng.random() < 0.5)
    return _pairs(rng, fwd, gpos, t)


def pe_rna(genome, genes, variants, n, seed, t) -> Pool:
    """chip_smoke.simulate_rna_pairs on one haplotype: FR pairs from
    fragments measured along the transcripts' spliced sequences (a
    transcript at least as long as the fragment, and an offset in it,
    uniformly at random), half the pairs with mates swapped."""
    rng = np.random.default_rng(seed)
    L = int(t["read_len"])
    hap = haplotype_transcripts(genome, genes, variants,
                                int(rng.integers(1 << 62)))
    tl = np.array([c.size for c, _ in hap])
    by_len = np.argsort(tl, kind="stable")
    flo, fhi = t["fragment"]
    frag = rng.integers(flo, fhi + 1, n)
    first = np.searchsorted(tl[by_len], frag)
    pick = by_len[first + (rng.random(n) * (len(hap) - first)).astype(
        np.int64)]
    fwd = np.empty((2, n, L), np.uint8)
    gpos = np.empty((2, n, L), np.int32)
    for i in range(n):
        codes, gp = hap[pick[i]]
        o = int(rng.integers(0, codes.size - frag[i] + 1))
        for m, a in enumerate((o, o + frag[i] - L)):
            fwd[m, i] = codes[a:a + L]
            gpos[m, i] = gp[a:a + L]
    return _pairs(rng, fwd, gpos, t)


def _pairs(rng, fwd, gpos, t) -> Pool:
    n = fwd.shape[1]
    rev = np.zeros((2, n), bool)
    rev[1] = True                           # mate 2 reads the minus strand
    swap = rng.random(n) < float(t["swap_rate"])
    for a in (fwd, gpos, rev):
        a[0, swap], a[1, swap] = a[1, swap], a[0, swap].copy()
    seqs = np.empty_like(fwd)
    quals = np.empty_like(fwd)
    for m in range(2):
        seqs[m], quals[m] = _sequenced(rng, fwd[m], rev[m], t["quality"])
    return Pool(names(t, n), seqs, quals, gpos, rev)


def make_pool(t: dict, dep, n: int, seed: int, limit: int | None = None):
    """n reads (SE) or pairs (PE) of traffic `t` on deployment `dep`,
    from the genome's first `limit` bases (and the genes inside them)
    where given."""
    genome = dep.genome if limit is None else dep.genome[:limit]
    if t["mix"] == "se_dna":
        return se_dna(genome, n, seed, t)
    if t["mix"] == "pe_dna":
        return pe_dna(genome, n, seed, t)
    if t["mix"] == "pe_rna":
        genes = [g for g in dep.genes if limit is None
                 or g[1][-1][1] < limit]
        return pe_rna(genome, genes, dep.variants, n, seed, t)
    raise ValueError(f"unknown traffic mix {t['mix']!r}")


# ---- FASTQ and gzip ----------------------------------------------------------

def fastq_text(pool: Pool, m: int, lo: int, hi: int) -> bytes:
    """Mate m of reads lo..hi as FASTQ (phred+33)."""
    seq = LETTERS[pool.seqs[m, lo:hi]]
    qual = (pool.quals[m, lo:hi] + 33).astype(np.uint8)
    out = []
    for i in range(hi - lo):
        out.append(b"@%s\n%s\n+\n%s\n" % (pool.names[lo + i].encode(),
                                         seq[i].tobytes(), qual[i].tobytes()))
    return b"".join(out)


def gzip_members(pool: Pool, m: int, per: int, level: int = 6) -> list:
    """Mate m's FASTQ as gzip members of `per` reads each (a concatenation
    of members is one valid gzip stream)."""
    n = len(pool)
    return [gzip.compress(fastq_text(pool, m, a, min(a + per, n)),
                          compresslevel=level, mtime=0)
            for a in range(0, n, per)]
