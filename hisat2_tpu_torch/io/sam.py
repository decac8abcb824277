"""SAM output: header + record formatting.

Equivalent role to the reference's sam.h (SamConfig :57, printHeader :446)
and aln_sink.h AlnSinkSam::appendMate (:3024): @HD/@SQ/@PG header, FLAG /
POS / MAPQ / CIGAR (N for introns), and the optional-field set AS:i NM:i
ZS:i XM:i XO:i XG:i XN:i MD:Z YF:Z YT:Z NH:i XS:A Zs:Z (sam.h:930-1010).

All formatting is host-side string work on already-resolved alignments; the
device never sees strings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, TextIO

from ..utils import alphabet

# FLAG bits (SAM spec)
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80
FLAG_SECONDARY = 0x100


@dataclass
class SamAlignment:
    """One resolved alignment, ready to print."""
    rname: str                 # chromosome name
    pos: int                   # 0-based leftmost position
    fw: bool                   # query strand
    mapq: int
    cigar: list[tuple[str, int]]     # [('M', 100), ...]
    score: int                 # AS:i
    nmm: int = 0               # XM:i mismatches
    gap_opens: int = 0         # XO:i
    gap_exts: int = 0          # XG:i
    n_refns: int = 0           # XN:i ambiguous ref bases
    md: str = ""               # MD:Z
    nm: int = 0                # NM:i edit distance
    zs: int | None = None      # ZS:i second-best score
    yt: str = "UU"             # YT:Z pair class (UU/UP/CP/DP)
    xs_strand: str | None = None   # XS:A splice strand
    zs_snps: str | None = None     # Zs:Z snp edits
    nh: int | None = None      # NH:i number of reported hits
    secondary: bool = False
    # pairing fields
    paired: bool = False
    mate1: bool = True
    proper_pair: bool = False
    mate_mapped: bool = False
    mate_rname: str | None = None
    mate_pos: int = 0
    mate_fw: bool = True
    tlen: int = 0


def cigar_str(cigar: list[tuple[str, int]]) -> str:
    if not cigar:
        return "*"
    return "".join(f"{n}{op}" for op, n in cigar)


def make_md(read_codes, ref_codes, cigar) -> tuple[str, int]:
    """Build MD:Z + NM:i from aligned read/ref codes and a CIGAR.

    read_codes / ref_codes: the full read (aligned portion) and the reference
    stretch covering the alignment footprint (len = sum of M+D).
    """
    import numpy as np
    if len(cigar) == 1 and cigar[0][0] in ("M", "=", "X"):
        # vectorized fast path for the ubiquitous all-M case
        n = cigar[0][1]
        rd = np.asarray(read_codes[:n])
        rf = np.asarray(ref_codes[:n])
        mmpos = np.flatnonzero((rd != rf) | (rd >= 4) | (rf >= 4))
        parts = []
        last = -1
        for p in mmpos:
            parts.append(str(int(p) - last - 1))
            parts.append("ACGTN"[int(rf[p])])
            last = int(p)
        parts.append(str(n - 1 - last))
        return "".join(parts), int(mmpos.size)
    md = []
    run = 0
    nm = 0
    ri = 0   # read index
    fi = 0   # ref index
    for op, n in cigar:
        if op in ("M", "=", "X"):
            for _ in range(n):
                rc, fc = int(read_codes[ri]), int(ref_codes[fi])
                if rc == fc and rc < 4:
                    run += 1
                else:
                    md.append(str(run))
                    md.append(alphabet.decode([fc]))
                    run = 0
                    nm += 1
                ri += 1
                fi += 1
        elif op == "I" or op == "S":
            ri += n
            if op == "I":
                nm += n
        elif op == "D":
            md.append(str(run))
            run = 0
            md.append("^" + alphabet.decode(ref_codes[fi:fi + n]))
            nm += n
            fi += n
        elif op == "N":
            fi += n
    md.append(str(run))
    return "".join(md), nm


class SamWriter:
    """Streams SAM records; reference SamConfig equivalent."""

    def __init__(self, out: TextIO, ref_names: list[str], ref_lens: list[int],
                 prog_args: str = "", rg_line: str | None = None,
                 no_head: bool = False, reorder: bool = False):
        self.out = out
        self.ref_names = ref_names
        self.reorder = reorder
        self._pending: dict[int, list[str]] = {}
        self._next_rdid = 0
        if not no_head:
            self._header(ref_names, ref_lens, prog_args, rg_line)

    def _header(self, names, lens, prog_args, rg_line):
        w = self.out.write
        w("@HD\tVN:1.0\tSO:unsorted\n")
        for n, l in zip(names, lens):
            w(f"@SQ\tSN:{n}\tLN:{l}\n")
        if rg_line:
            w("@RG\t" + rg_line + "\n")
        w("@PG\tID:hisat2-tpu\tPN:hisat2-tpu\tVN:0.1.0"
          + (f"\tCL:\"{prog_args}\"" if prog_args else "") + "\n")

    # ------------- record emission -------------

    def emit(self, rdid: int, lines: list[str]) -> None:
        """Queue all SAM lines of one read (pair); flush in rdid order when
        reorder is set (reference OutputQueue, outq.h:37)."""
        if not self.reorder:
            self.out.writelines(lines)
            return
        self._pending[rdid] = lines
        while self._next_rdid in self._pending:
            self.out.writelines(self._pending.pop(self._next_rdid))
            self._next_rdid += 1

    def flush(self) -> None:
        for rdid in sorted(self._pending):
            self.out.writelines(self._pending[rdid])
        self._pending.clear()


def format_aligned(name: str, seq_fw_codes, qual_str_fw: str,
                   a: SamAlignment, omit_sec_seq: bool = False) -> str:
    """Format one aligned SAM record. seq_fw_codes is the read in its
    original (input) orientation; SEQ is reverse-complemented when the
    alignment is on the reverse strand (SAM spec / sam.h)."""
    flag = 0
    if a.paired:
        flag |= FLAG_PAIRED | (FLAG_MATE1 if a.mate1 else FLAG_MATE2)
        if a.proper_pair:
            flag |= FLAG_PROPER_PAIR
        if not a.mate_mapped:
            flag |= FLAG_MATE_UNMAPPED
        elif not a.mate_fw:
            flag |= FLAG_MATE_REVERSE
    if not a.fw:
        flag |= FLAG_REVERSE
    if a.secondary:
        flag |= FLAG_SECONDARY

    if omit_sec_seq and a.secondary:
        seq = qual = "*"          # --omit-sec-seq (sam.h secondary policy)
    elif a.fw:
        seq = alphabet.decode(seq_fw_codes)
        qual = qual_str_fw
    else:
        seq = alphabet.decode(alphabet.revcomp(seq_fw_codes))
        qual = qual_str_fw[::-1]

    if a.paired and a.mate_mapped:
        rnext = "=" if a.mate_rname == a.rname else (a.mate_rname or "*")
        pnext, tlen = a.mate_pos + 1, a.tlen
    elif a.paired:
        rnext, pnext, tlen = "=", a.pos + 1, 0
    else:
        rnext, pnext, tlen = "*", 0, 0

    opts = [f"AS:i:{a.score}"]
    if a.zs is not None:
        opts.append(f"ZS:i:{a.zs}")
    opts += [f"XN:i:{a.n_refns}", f"XM:i:{a.nmm}",
             f"XO:i:{a.gap_opens}", f"XG:i:{a.gap_exts}",
             f"NM:i:{a.nm}", f"MD:Z:{a.md}"]
    if a.xs_strand:
        opts.append(f"XS:A:{a.xs_strand}")
    if a.zs_snps:
        opts.append(f"Zs:Z:{a.zs_snps}")
    opts.append(f"YT:Z:{a.yt}")
    if a.nh is not None:
        opts.append(f"NH:i:{a.nh}")

    return "\t".join([
        name[:255], str(flag), a.rname, str(a.pos + 1), str(a.mapq),
        cigar_str(a.cigar), rnext, str(pnext), str(tlen), seq, qual,
        "\t".join(opts)]) + "\n"


def format_unaligned(name: str, seq_fw_codes, qual_str: str,
                     paired: bool = False, mate1: bool = True,
                     mate_mapped: bool = False, mate_rname: str = "*",
                     mate_pos: int = 0, mate_fw: bool = True,
                     yt: str = "UU", yf: str | None = None) -> str:
    flag = FLAG_UNMAPPED
    if paired:
        flag |= FLAG_PAIRED | (FLAG_MATE1 if mate1 else FLAG_MATE2)
        if not mate_mapped:
            flag |= FLAG_MATE_UNMAPPED
        # note: the reference does NOT set 0x20 (mate-reverse) on unmapped
        # records even when the mapped mate is reverse — matched here
    rname = mate_rname if (paired and mate_mapped) else "*"
    pos = str(mate_pos + 1) if (paired and mate_mapped) else "0"
    opts = []
    if yf:
        opts.append(f"YF:Z:{yf}")
    opts.append(f"YT:Z:{yt}")
    return "\t".join([
        name[:255], str(flag), rname, pos, "0", "*",
        "=" if (paired and mate_mapped) else "*", pos if (paired and mate_mapped) else "0",
        "0", alphabet.decode(seq_fw_codes), qual_str,
        "\t".join(opts)]) + "\n"
