"""Where the port rightly differs from the JAX package: the parity tests'
records and alignments that differ are held to a plain walk of their CIGAR
over the genome instead.

The JAX package writes two kinds of record whose tags its own alignment
does not give (ROADMAP.md Queue C 18 and 19), and the port writes them
right:
  - graph mode: the host DP traceback of a gapped candidate and the mate
    rescue's DP score a known SNV's alternative allele as a mismatch (AS,
    NM, XM), where every other finalizer frees it;
  - a spliced candidate whose optimal clip takes a whole anchor.
On such a record the port and the JAX package differ in AS, NM and XM only
(the first) or in the CIGAR and its tags too (the second). The helpers
here accept a record that differs only where the port's agrees with the
walk and the JAX package's does not; every other record must be equal.

The walk, under the aligner's scoring: a mismatch costs its quality's
penalty, an N the N penalty, a soft-clipped base its clip penalty, a gap
its open and extend penalties; a read base that is a known SNV's
alternative allele (the index's overlay) costs nothing and is no mismatch
in NM or XM; a known deletion or insertion may be taken either way (free
and uncounted, or as a gap). Spliced records (N) take HISAT2's intron
penalty and are left to the spliced tests (tests/test_torch_spliced_clip.py)
here: a differing spliced record fails."""

from __future__ import annotations

import re

import numpy as np

CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
ENC = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
TAGS = ("AS", "NM", "XM")


def walk(al, cigar, joined_pos: int, rd: np.ndarray, q: np.ndarray):
    """The set of (AS, NM, XM) the walk allows for an alignment of the read
    rd (codes, alignment orientation) with qualities q: one entry for each
    way of taking its known indels. None where the CIGAR spells an intron
    or leaves the genome."""
    sc = al.scoring
    joined = al.fm.ref.joined
    ov = al.overlay
    mm_pens, sc_pens = sc.mm_pens(), sc.sc_pens()
    g, r = joined_pos, 0
    score = nm = xm = 0
    optional = []
    for n, op in cigar:
        if op in "M=X":
            if g < 0 or g + n > joined.size:
                return None
            for k in range(n):
                b, f = int(rd[r + k]), int(joined[g + k])
                if b >= 4 or f >= 4:
                    score -= sc.n_pen
                    nm, xm = nm + 1, xm + 1
                elif b != f:
                    o = 0 if ov is None else int(ov[g + k])
                    if o != b + 1 and o != 15:
                        score -= int(mm_pens[min(int(q[r + k]), 63)])
                        nm, xm = nm + 1, xm + 1
                else:
                    score += sc.match_bonus
            g, r = g + n, r + n
        elif op == "D":
            pen = sc.read_gap_open() + (n - 1) * sc.read_gap_extend()
            if (g, n) in al._del_snps:
                optional.append((pen, n))
            score -= pen
            nm += n
            g += n
        elif op == "I":
            pen = sc.ref_gap_open() + (n - 1) * sc.ref_gap_extend()
            ins = al._ins_snps.get(g)
            if ins is not None and ins.size == n and np.array_equal(
                    rd[r:r + n], ins):
                optional.append((pen, n))
            score -= pen
            nm += n
            r += n
        elif op == "S":
            score -= int(sum(int(sc_pens[min(int(x), 63)])
                             for x in q[r:r + n]))
            r += n
        else:
            return None
    out = {(score, nm, xm)}
    for pen, n in optional:
        out |= {(s + pen, m - n, x) for s, m, x in out}
    return out


def aln_walks(al, aln, batch, i: int) -> bool:
    """Whether an Alignment of read i of `batch` agrees with the walk."""
    n = int(batch.lens[i])
    rd = batch.seqs[i, :n].astype(np.uint8)
    q = batch.quals[i, :n].astype(np.int64)
    if not aln.fw:
        rd, q = COMP[rd[::-1]], q[::-1]
    w = walk(al, [(k, op) for op, k in aln.cigar], aln.joined_pos, rd, q)
    return w is not None and (aln.score, aln.nm, aln.nmm) in w


def assert_alns_like_reference(al, t, j, batch, i: int,
                               fields=("joined_pos", "fw", "score", "cigar",
                                       "nmm", "md", "nm")) -> bool:
    """Alignment t (port) equals j (JAX) in `fields`, or differs only in
    score, nm and nmm where t agrees with the walk and j does not. Returns
    whether they differ."""
    same = [f for f in fields if f not in ("score", "nm", "nmm")]
    assert [getattr(t, f) for f in same] == [getattr(j, f) for f in same]
    if all(getattr(t, f) == getattr(j, f) for f in fields):
        return False
    assert aln_walks(al, t, batch, i), (t, j)
    assert not aln_walks(al, j, batch, i), (t, j)
    return True


def _joined(ref, rname: str, pos0: int) -> int:
    t = list(ref.names).index(rname)
    k = np.flatnonzero((ref.frag_tidx == t) & (ref.frag_toff <= pos0)
                       & (pos0 < ref.frag_toff + ref.frag_len))[0]
    return int(ref.frag_joined[k] + pos0 - ref.frag_toff[k])


def _tags(f):
    return {x.split(":", 1)[0]: x for x in f[11:]}


def line_walks(al, f, seq: str, qual: str) -> bool:
    """Whether a SAM record (its fields) agrees with the walk; seq and qual
    as the record holds them (forward strand of the genome)."""
    tags = _tags(f)
    got = tuple(int(tags[k].split(":")[2]) for k in TAGS)
    rd = ENC[np.frombuffer(seq.encode(), np.uint8)]
    q = np.frombuffer(qual.encode(), np.uint8).astype(np.int64) - 33
    cig = [(int(n), op) for n, op in CIGAR.findall(f[5])]
    w = walk(al, cig, _joined(al.fm.ref, f[2], int(f[3]) - 1), rd, q)
    return w is not None and got in w


def assert_sam_like_reference(al, ttext: str, jtext: str) -> int:
    """The port's SAM text equals the JAX package's, record for record,
    but for records that differ only in AS, NM and XM, where the port's
    agrees with the walk and the JAX package's does not. Returns the
    number of such records."""
    tl, jl = ttext.splitlines(), jtext.splitlines()
    assert len(tl) == len(jl)
    seqs = {}
    for ln in tl:
        f = ln.split("\t")
        if not ln.startswith("@") and f[9] != "*":
            fwd = (f[9], f[10])
            if int(f[1]) & 16:
                fwd = ("".join("TGCAN"["ACGTN".index(c)]
                               for c in f[9][::-1]), f[10][::-1])
            seqs[(f[0], int(f[1]) & 192)] = fwd
    n = 0
    for t, j in zip(tl, jl):
        if t == j:
            continue
        ft, fj = t.split("\t"), j.split("\t")
        assert ft[:11] == fj[:11], (t, j)
        tt, tj = _tags(ft), _tags(fj)
        assert list(tt) == list(tj), (t, j)
        assert all(tt[k] == tj[k] for k in tt if k not in TAGS), (t, j)
        seq, qual = ft[9], ft[10]
        if seq == "*":
            seq, qual = seqs[(ft[0], int(ft[1]) & 192)]
            if int(ft[1]) & 16:
                seq = "".join("TGCAN"["ACGTN".index(c)] for c in seq[::-1])
                qual = qual[::-1]
        assert line_walks(al, ft, seq, qual), (t, j)
        assert not line_walks(al, fj, seq, qual), (t, j)
        n += 1
    return n
