"""Annotation file parsers: .snp / .haplotype / .ss / .exon.

Formats are the reference's (MANUAL.markdown:2064-2089; written by
hisat2_extract_snps_haplotypes_*.py and hisat2_extract_splice_sites.py):

  .snp        name  single|deletion|insertion  chrom  pos(0-based)  allele|len
  .haplotype  name  chrom  left  right  snp-id-list(comma)
  .ss         chrom  left  right  strand       (0-based, exon-boundary-1)
  .exon       chrom  left  right  strand

SNPs are resolved to *joined-text* coordinates against a JoinedReference so
the device overlay/patch arrays can be built directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import alphabet
from .reads import _open_text

SNP_SGL, SNP_DEL, SNP_INS = 0, 1, 2
_TYPES = {"single": SNP_SGL, "deletion": SNP_DEL, "insertion": SNP_INS}
_TYPE_NAMES = {v: k for k, v in _TYPES.items()}


@dataclass
class SNPDB:
    """Sorted SNP table in joined coordinates (reference ALTDB role for
    SNP-type ALTs, alt.h:258)."""
    names: list[str]
    types: np.ndarray        # (S,) int8
    jpos: np.ndarray         # (S,) int64 joined position (site of change)
    lens: np.ndarray         # (S,) int32 (del length; ins length; 1 for SNV)
    alt_codes: np.ndarray    # (S,) int8 alt base for SNV, -1 otherwise
    ins_seqs: list[np.ndarray] = field(default_factory=list)  # per-SNP codes
    chroms: list[str] = field(default_factory=list)
    tpos: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __len__(self) -> int:
        return int(self.jpos.size)

    @property
    def n_snv(self) -> int:
        return int((self.types == SNP_SGL).sum())

    def to_snp_lines(self, ref) -> list[str]:
        out = []
        for i in range(len(self)):
            t = int(self.types[i])
            if t == SNP_SGL:
                allele = alphabet.decode([int(self.alt_codes[i])])
            elif t == SNP_DEL:
                allele = str(int(self.lens[i]))
            else:
                allele = alphabet.decode(self.ins_seqs[i])
            out.append("\t".join([self.names[i], _TYPE_NAMES[t],
                                  self.chroms[i], str(int(self.tpos[i])),
                                  allele]))
        return out


def read_snps(path, ref) -> SNPDB:
    """Parse a .snp file, mapping (chrom, pos) -> joined offsets.

    SNPs on excluded (ambiguous) stretches or unknown chromosomes are
    dropped, matching the reference's ingestion (gfm.h:1410+ skips ALTs it
    can't place)."""
    name_to_tidx = {n: i for i, n in enumerate(ref.names)}
    rows = []
    with _open_text(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 5:
                continue
            name, typ, chrom, pos, allele = f[0], f[1], f[2], int(f[3]), f[4]
            if typ not in _TYPES or chrom not in name_to_tidx:
                continue
            rows.append((name, _TYPES[typ], chrom, name_to_tidx[chrom],
                         pos, allele))

    names, types, jposs, lens, altc, ins_seqs, chroms, tpos = \
        [], [], [], [], [], [], [], []
    # fragment lookup per chromosome for fast text->joined mapping
    by_tidx: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for t in set(r[3] for r in rows):
        m = ref.frag_tidx == t
        order = np.argsort(ref.frag_toff[m])
        by_tidx[t] = (ref.frag_toff[m][order], ref.frag_len[m][order],
                      ref.frag_joined[m][order])

    for name, typ, chrom, tidx, pos, allele in rows:
        toffs, flens, fjoins = by_tidx[tidx]
        fi = int(np.searchsorted(toffs, pos, side="right")) - 1
        if fi < 0 or pos >= toffs[fi] + flens[fi]:
            continue
        jp = int(fjoins[fi] + pos - toffs[fi])
        if typ == SNP_SGL:
            code = int(alphabet.encode(allele)[0])
            if code > 3:
                continue
            length, ac, iseq = 1, code, None
        elif typ == SNP_DEL:
            length, ac, iseq = int(allele), -1, None
            if pos + length > toffs[fi] + flens[fi]:
                continue
        else:
            iseq = alphabet.encode(allele)
            if iseq.size == 0 or iseq.max() > 3:
                continue
            length, ac = int(iseq.size), -1
        names.append(name)
        types.append(typ)
        jposs.append(jp)
        lens.append(length)
        altc.append(ac)
        ins_seqs.append(iseq if iseq is not None else np.zeros(0, np.uint8))
        chroms.append(chrom)
        tpos.append(pos)

    order = np.argsort(np.asarray(jposs, dtype=np.int64), kind="stable")
    reord = lambda lst: [lst[i] for i in order]
    return SNPDB(
        names=reord(names),
        types=np.asarray(types, np.int8)[order],
        jpos=np.asarray(jposs, np.int64)[order],
        lens=np.asarray(lens, np.int32)[order],
        alt_codes=np.asarray(altc, np.int8)[order],
        ins_seqs=reord(ins_seqs),
        chroms=reord(chroms),
        tpos=np.asarray(tpos, np.int64)[order],
    )


def read_haplotypes(path, ref, snps: SNPDB) -> list[list[int]]:
    """Parse a .haplotype file (name, chrom, left, right, snp-id list) into
    lists of SNP indices into `snps` (unknown ids skipped)."""
    id_to_idx = {n: i for i, n in enumerate(snps.names)}
    out = []
    with _open_text(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 5:
                continue
            ids = [id_to_idx[x] for x in f[4].split(",") if x in id_to_idx]
            if len(ids) > 1:
                out.append(sorted(ids, key=lambda i: int(snps.jpos[i])))
    return out


@dataclass
class SpliceSiteRec:
    chrom: str
    left: int      # last base of left exon (0-based), per .ss convention
    right: int     # first base of right exon
    strand: str    # '+', '-', '.'


def read_splice_sites(path) -> list[SpliceSiteRec]:
    out = []
    with _open_text(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) >= 4:
                out.append(SpliceSiteRec(f[0], int(f[1]), int(f[2]), f[3]))
    return out


def write_splice_sites(path, sites: list[SpliceSiteRec]) -> None:
    with open(path, "w") as fh:
        for s in sites:
            fh.write(f"{s.chrom}\t{s.left}\t{s.right}\t{s.strand}\n")


def read_exons(path) -> list[tuple[str, int, int, str]]:
    out = []
    with _open_text(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) >= 4:
                out.append((f[0], int(f[1]), int(f[2]), f[3]))
    return out
