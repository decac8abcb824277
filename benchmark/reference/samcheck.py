"""The plain check of SAM records against the genome and the reads' truth.

It reads nothing the program made but the records themselves: the genome,
the known variants and the reads are the benchmark's own. For a record it
walks the CIGAR over the genome and works out again what HISAT2's tags
state, under HISAT2's end-to-end scoring (the program's defaults):

  mismatch        MN + floor((MX - MN) * min(Q, 40) / 40), MX 6, MN 2; a
                  read base that is a known SNV's alternative allele at its
                  position costs nothing and is no mismatch in XM or NM (MD,
                  which spells the linear reference, still shows it)
  N (either side) 1
  gap of k bases  5 + 3k (read or reference gap), one XO gap open and k - 1
                  XG extensions; a deletion or insertion that is a known
                  variant may be taken either way: through the graph's edge
                  (no cost, no XO/XG/NM count) or as a plain gap, and a
                  record is right if one choice for each explains it
  soft clip       1 + floor(min(Q, 40) / 40) per clipped base
  intron          max(0, trunc(-8 + ln(length))), plus 12 where its motif
                  is not canonical (GT-AG on +, CT-AC on -) and it is no
                  annotated site; XS:A gives the motif's strand

and NM (mismatches, inserted and deleted bases), MD, XM, XO, XG, AS, the
read's bases and qualities (SEQ, QUAL: the read as sequenced, reverse-
complemented under flag 16), and that M, I and S cover the read.

Placement: a read is placed right when its primary record is on the
strand it was read from and at least half of the record's M bases sit at
the genome position the generator put that base at.
"""

from __future__ import annotations

import math
import re

import numpy as np

MX, MN, NPEN = 6, 2, 1
GAP_CONST, GAP_LIN = 5, 3
SC_MAX, SC_MIN = 2, 1
NONCANON_PEN = 12
CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
ENC = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i
    ENC[ord(chr(_c).lower())] = _i


def mm_pen(q: int) -> int:
    return MN + (min(q, 40) * (MX - MN)) // 40


def sc_pen(q: int) -> int:
    return SC_MIN + (min(q, 40) * (SC_MAX - SC_MIN)) // 40


def intron_pen(length: int) -> int:
    if length <= 0:
        return 0
    return max(0, int(-8.0 + math.log(length)))


class Known:
    """The deployment's known variants and annotated splice sites, for
    lookups by position."""

    def __init__(self, variants=None, genes=None):
        self.snv = {}
        self.dels = set()
        self.ins = set()
        if variants is not None:
            for i in range(variants["pos"].size):
                p, t = int(variants["pos"][i]), int(variants["type"][i])
                if t == 0:
                    self.snv[p] = int(variants["alt"][i])
                elif t == 1:
                    self.dels.add((p, int(variants["len"][i])))
                else:
                    self.ins.add((p, bytes(variants["ins"][i])))
        self.sites = set()
        for _strand, exons in genes or []:
            for (_, e), (a, _) in zip(exons, exons[1:]):
                self.sites.add((e - 1, a))


def parse(line: str) -> dict:
    f = line.rstrip("\n").split("\t")
    tags = {}
    for t in f[11:]:
        k, typ, v = t.split(":", 2)
        tags[k] = int(v) if typ == "i" else v
    return {"qname": f[0], "flag": int(f[1]), "rname": f[2],
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "seq": f[9], "qual": f[10], "tags": tags}


def expected_tags(rec: dict, genome: np.ndarray, known: Known):
    """What a record's tags should say, walked over the genome: a dict of
    AS, NM, MD, XM, XO, XG and XS (None where no intron) with every known
    indel taken through its edge, and `optional`, the lengths of those
    indels; or a string that says why the record cannot be right (CIGAR
    off the genome, or not covering the read)."""
    ops = [(int(n), op) for n, op in CIGAR_RE.findall(rec["cigar"])]
    seq = ENC[np.frombuffer(rec["seq"].encode(), np.uint8)]
    qual = np.frombuffer(rec["qual"].encode(), np.uint8).astype(int) - 33
    if sum(n for n, op in ops if op in "MIS=X") != seq.size:
        return "CIGAR does not cover the read"
    g = rec["pos"] - 1
    ri = 0
    score = nm = xm = xo = xg = 0
    md, run = [], 0
    xs = None
    optional = []             # lengths of the known indels on the path
    for n, op in ops:
        if op in "M=X":
            if g < 0 or g + n > genome.size:
                return "alignment off the genome"
            rf = genome[g:g + n]
            rd = seq[ri:ri + n]
            prev = 0
            for k in np.flatnonzero((rd != rf) | (rd >= 4) | (rf >= 4)):
                k = int(k)
                md.append(str(run + k - prev))
                md.append("ACGTN"[int(rf[k])])
                run, prev = 0, k + 1
                if rd[k] >= 4 or rf[k] >= 4:
                    score -= NPEN
                    nm, xm = nm + 1, xm + 1
                elif known.snv.get(g + k) != int(rd[k]):
                    score -= mm_pen(int(qual[ri + k]))
                    nm, xm = nm + 1, xm + 1
            run += n - prev
            g += n
            ri += n
        elif op == "I":
            if (g, bytes(seq[ri:ri + n])) in known.ins:
                optional.append(n)
            else:
                score -= GAP_CONST + GAP_LIN * n
                nm, xo, xg = nm + n, xo + 1, xg + n - 1
            ri += n
        elif op == "D":
            if g < 0 or g + n > genome.size:
                return "alignment off the genome"
            md.append(str(run))
            run = 0
            md.append("^" + "".join("ACGTN"[c] for c in genome[g:g + n]))
            if (g, n) in known.dels:
                optional.append(n)
            else:
                score -= GAP_CONST + GAP_LIN * n
                nm, xo, xg = nm + n, xo + 1, xg + n - 1
            g += n
        elif op == "N":
            if g < 2 or g + n > genome.size:
                return "intron off the genome"
            don = tuple(genome[g:g + 2])
            acc = tuple(genome[g + n - 2:g + n])
            strand = ("+" if (don, acc) == ((2, 3), (0, 2)) else
                      "-" if (don, acc) == ((1, 3), (0, 1)) else None)
            annotated = (g - 1, g + n) in known.sites
            score -= intron_pen(n)
            if strand is None and not annotated:
                score -= NONCANON_PEN
            xs = xs or strand
            g += n
        elif op == "S":
            score -= sum(sc_pen(int(q)) for q in qual[ri:ri + n])
            ri += n
        else:
            return f"unexpected CIGAR operation {op}"
    md.append(str(run))
    return {"AS": score, "NM": nm, "MD": "".join(md), "XM": xm,
            "XO": xo, "XG": xg, "XS": xs, "optional": optional}


def check_record(rec: dict, read_seq: np.ndarray, read_qual: np.ndarray,
                 genome: np.ndarray, known: Known) -> str | None:
    """None if the record agrees with the genome and the read, else what
    disagrees. read_seq / read_qual: the read as sequenced (codes,
    phred)."""
    if rec["flag"] & 4:
        return None
    rev = bool(rec["flag"] & 16)
    want_seq = COMP[read_seq[::-1]] if rev else read_seq
    want_qual = read_qual[::-1] if rev else read_qual
    if rec["seq"] != "*":
        if not np.array_equal(ENC[np.frombuffer(rec["seq"].encode(),
                                                np.uint8)], want_seq):
            return "SEQ is not the read"
        got_q = np.frombuffer(rec["qual"].encode(), np.uint8) - 33
        if not np.array_equal(got_q, want_qual):
            return "QUAL is not the read's"
    else:
        rec = dict(rec, seq="".join("ACGTN"[c] for c in want_seq),
                   qual=(want_qual + 33).astype(np.uint8).tobytes().decode())
    exp = expected_tags(rec, genome, known)
    if isinstance(exp, str):
        return exp
    tags = rec["tags"]
    if tags.get("MD") != exp["MD"]:
        return f"MD {tags.get('MD')} against {exp['MD']}"
    got = tuple(tags.get(k) for k in ("AS", "NM", "XM", "XO", "XG"))
    base = (exp["AS"], exp["NM"], exp["XM"], exp["XO"], exp["XG"])
    choices = [base]
    for n in exp["optional"][:8]:        # each known indel: edge or gap
        gap = (-(GAP_CONST + GAP_LIN * n), n, 0, 1, n - 1)
        choices += [tuple(a + b for a, b in zip(c, gap)) for c in choices]
    if got not in choices:
        return f"AS/NM/XM/XO/XG {got} against {base}"
    if exp["XS"] is not None and tags.get("XS") != exp["XS"]:
        return f"XS {tags.get('XS')} against {exp['XS']}"
    return None


def placed_right(rec: dict, gpos: np.ndarray, rev: bool) -> bool:
    """Whether a primary record puts the read where it came from: on its
    strand, with at least half of its M bases at their true positions
    (gpos: forward-strand genome position of each base, -1 inserted)."""
    if rec is None or rec["flag"] & 4 or bool(rec["flag"] & 16) != rev:
        return False
    g = rec["pos"] - 1
    ri = hit = tot = 0
    for n, op in ((int(n), op) for n, op in CIGAR_RE.findall(rec["cigar"])):
        if op in "M=X":
            hit += int((gpos[ri:ri + n] == np.arange(g, g + n)).sum())
            tot += n
            g += n
            ri += n
        elif op in "IS":
            ri += n
        elif op in "DN":
            g += n
    return tot > 0 and 2 * hit >= tot
