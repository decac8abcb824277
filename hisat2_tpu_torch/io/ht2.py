"""Reader for the reference's .ht2 index files (small/32-bit, linear FM).

Layout per gfm.h readIntoMemory (gfm.h:5823-6440) and BitPairReference
(reference.cpp:73-150), little-endian `index_t = uint32` ("small" index;
MANUAL.markdown:221-231):

  .1.ht2  u32 1; u32 version; u32 len, gbwtLen, numNodes; i32 lineRate,
          linesPerSide, offRate, ftabChars; u32 eftabLen; i32 flags;
          u32 nPat; u32 plen[nPat]; u32 nFrag; u32 rstarts[3*nFrag];
          GBWT sides (numSides x 2^lineRate bytes, each = packed 2-bit
          BWT chars + 4 u32 checkpoints at the side end for linear FM);
          u32 nZOffs; u32 zOffs[]; u32 fchr[5]; u32 ftab[4^ftabChars+1];
          u32 eftab[eftabLen]; refnames ('\n'-separated, NUL-terminated)
  .2.ht2  u32 1; u32 offs[(numNodes + 2^offRate - 1) >> offRate]
          (row-sampled SA values)
  .3.ht2  u32 1; u32 nRecs; nRecs x {u32 off, u32 len, u8 first}
  .4.ht2  2-bit packed reference stretches (4 bases/byte, first base in
          the low bits)

The loader recovers the reference text + names and REBUILDS our native
device index from them (our layouts are our own); the raw BWT and
SA sample are also decoded so tests can verify the file was truly
understood (our recomputed BWT must equal the stored one).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .reference import JoinedReference


def _u32s(buf: bytes, off: int, n: int):
    return np.frombuffer(buf, np.uint32, count=n, offset=off), off + 4 * n


def read_ht2_primary(prefix: str) -> dict:
    """Parse <prefix>.1.ht2 fully (header, BWT chars, zOffs, fchr, ftab,
    refnames).

    Linear AND graph headers are handled: `_linearFM = (len + 1 ==
    gbwtLen)` (gfm.h:121) decides the side geometry — linear sides pack
    4 chars/byte with 4 u32 checkpoints, graph sides pack 2 positions/
    byte (char + F/M bits) with 6 u32 checkpoints (gfm.h:172-183). The
    graph GBWT itself is not decoded (`bwt` is None): load_ht2 rebuilds
    our patched-fragment graph index from the text + .7/.8 ALTs instead
    of translating the GCSA row space."""
    with open(prefix + ".1.ht2", "rb") as fh:
        buf = fh.read()
    off = 0
    (one, version, length, gbwt_len, num_nodes), off = \
        np.frombuffer(buf, np.uint32, 5, off), 20
    assert one == 1, "big-endian .ht2 not supported"
    (line_rate, lines_per_side, off_rate, ftab_chars), off = \
        np.frombuffer(buf, np.int32, 4, off), off + 16
    (eftab_len,), off = _u32s(buf, off, 1)
    (flags,), off = np.frombuffer(buf, np.int32, 1, off), off + 4
    (npat,), off = _u32s(buf, off, 1)
    plens, off = _u32s(buf, off, int(npat))
    (nfrag,), off = _u32s(buf, off, 1)
    rstarts, off = _u32s(buf, off, 3 * int(nfrag))

    linear = int(gbwt_len) == int(length) + 1 or int(gbwt_len) == 0
    side_sz = 1 << int(line_rate)
    if linear:
        gbwt_sz = int(gbwt_len) // 4 + 1        # 4 chars/byte
        side_gbwt_sz = side_sz - 16             # 4 x u32 checkpoints
    else:
        gbwt_sz = int(gbwt_len) // 2 + 1        # graph: 2 positions/byte
        side_gbwt_sz = side_sz - 24             # 6 x u32 checkpoints
    num_sides = (gbwt_sz + side_gbwt_sz - 1) // side_gbwt_sz
    tot = num_sides * side_sz
    bwt = None
    if linear:
        sides = np.frombuffer(buf, np.uint8, tot, off).reshape(
            num_sides, side_sz)
        packed = sides[:, :side_gbwt_sz].reshape(-1)
        codes = np.empty(packed.size * 4, np.uint8)
        for j in range(4):
            codes[j::4] = (packed >> (2 * j)) & 3
        bwt = codes[:int(gbwt_len)]
    off += tot

    (nz,), off = _u32s(buf, off, 1)
    zoffs, off = _u32s(buf, off, int(nz))
    fchr, off = _u32s(buf, off, 5)
    ftab, off = _u32s(buf, off, (1 << (2 * int(ftab_chars))) + 1)
    eftab, off = _u32s(buf, off, int(eftab_len))
    end = buf.index(b"\x00", off)
    names = [n for n in buf[off:end].decode().split("\n") if n]
    return dict(length=int(length), gbwt_len=int(gbwt_len),
                num_nodes=int(num_nodes), line_rate=int(line_rate),
                off_rate=int(off_rate), ftab_chars=int(ftab_chars),
                flags=int(flags), plens=plens.astype(np.int64),
                nfrag=int(nfrag), rstarts=rstarts.astype(np.int64),
                bwt=bwt, linear=linear, zoffs=zoffs.astype(np.int64),
                fchr=fchr.astype(np.int64), ftab=ftab, eftab=eftab,
                names=names)


def read_ht2_offs(prefix: str) -> np.ndarray:
    """.2.ht2: row-sampled SA values (offs[k] ~ SA[k << offRate])."""
    with open(prefix + ".2.ht2", "rb") as fh:
        buf = fh.read()
    one = struct.unpack("<I", buf[:4])[0]
    assert one == 1
    return np.frombuffer(buf, np.uint32, offset=4).astype(np.int64)


def read_ht2_reference(prefix: str, names: list[str],
                       plens: np.ndarray) -> JoinedReference:
    """.3/.4.ht2 -> JoinedReference (excluded-ambiguity fragment runs)."""
    with open(prefix + ".3.ht2", "rb") as fh:
        b3 = fh.read()
    one, nrecs = struct.unpack("<II", b3[:8])
    assert one == 1
    recs = []
    off = 8
    for _ in range(nrecs):
        o, l = struct.unpack_from("<II", b3, off)
        first = b3[off + 8] != 0
        recs.append((o, l, first))
        off += 9
    with open(prefix + ".4.ht2", "rb") as fh:
        b4 = np.frombuffer(fh.read(), np.uint8)
    total = sum(l for _, l, _ in recs)
    codes = np.empty(b4.size * 4, np.uint8)
    for j in range(4):
        codes[j::4] = (b4 >> (2 * j)) & 3
    joined = codes[:total]

    frag_joined, frag_toff, frag_tidx, frag_len = [], [], [], []
    tidx = -1
    toff = 0
    jpos = 0
    for o, l, first in recs:
        if first:
            tidx += 1
            toff = 0
        toff += o
        if l:
            frag_joined.append(jpos)
            frag_toff.append(toff)
            frag_tidx.append(tidx)
            frag_len.append(l)
        jpos += l
        toff += l
    return JoinedReference(
        names=list(names), tlens=np.asarray(plens, np.int64),
        joined=joined,
        frag_joined=np.asarray(frag_joined, np.int64),
        frag_toff=np.asarray(frag_toff, np.int64),
        frag_tidx=np.asarray(frag_tidx, np.int64),
        frag_len=np.asarray(frag_len, np.int64))


_ALT_SGL, _ALT_INS, _ALT_DEL = 1, 2, 3
_ALT_SPLICESITE, _ALT_EXON = 5, 6
_ALT_DTYPE = np.dtype([("pos", "<u4"), ("type", "<u4"),
                       ("len", "<u4"), ("seq", "<u8")])     # packed, 20B


def read_ht2_alts(prefix: str) -> dict:
    """Parse <prefix>.7.ht2 / .8.ht2: ALT records (SNVs, indels, splice
    sites, exons — alt.h:42-76 write format: pos u32, type u32, len u32,
    seq u64), the haplotype section, and the ALT name list.

    Positions are JOINED-text coordinates (ambiguous runs excluded), as
    written by the build's chromosome->joined conversion (gfm.h:1700-
    1727). Splice-site/exon ALTs store the intron/interval FIRST and
    LAST positions (the .ss/.exon file values ±1, gfm.h:1680); the fw
    strand and the repeat-exclusion flag ride seq bytes 0/1."""
    with open(prefix + ".7.ht2", "rb") as fh:
        b7 = fh.read()
    off = 4                                     # i32 endianness tag
    (num_alts,), off = _u32s(b7, off, 1)
    alts = np.frombuffer(b7, _ALT_DTYPE, int(num_alts), off)
    off += int(num_alts) * _ALT_DTYPE.itemsize
    haplotypes = []
    if off + 4 <= len(b7):
        (num_haps,), off = _u32s(b7, off, 1)
        for _ in range(int(num_haps)):
            (left, right, n), off = _u32s(b7, off, 3)
            ids, off = _u32s(b7, off, int(n))
            haplotypes.append((int(left), int(right),
                               ids.astype(np.int64)))
    names: list[str] = []
    try:
        with open(prefix + ".8.ht2", "rb") as fh:
            b8 = fh.read()
        names = b8[8:].decode("ascii", "replace").split()
    except FileNotFoundError:
        pass
    return dict(alts=alts, haplotypes=haplotypes, names=names)


def alts_to_annotations(raw: dict, ref: JoinedReference):
    """Convert parsed .7/.8 ALTs into our build-side structures:
    (SNPDB, known_ss (K,3) [left right strand] joined, known_exons
    (K,3), excluded_ss (K,3), haplotype index lists). known_ss rows use
    our .ss-file convention (last exonic base / first exonic base) —
    the inverse of the build's `left += 1; right -= 1` (gfm.h:1680)."""
    from .annotations import SNPDB, SNP_SGL, SNP_DEL, SNP_INS

    alts = raw["alts"]
    altnames = raw["names"]
    snames, stypes, sjpos, slens, saltc, sseqs, schroms, stpos = \
        [], [], [], [], [], [], [], []
    alt_to_snp = np.full(len(alts), -1, np.int64)
    ss_rows, ss_excl, exon_rows = [], [], []
    for k in range(len(alts)):
        pos = int(alts["pos"][k])
        typ = int(alts["type"][k])
        ln = int(alts["len"][k])
        seq = int(alts["seq"][k])
        nm = altnames[k] if k < len(altnames) else f"alt{k}"
        if typ == _ALT_SGL:
            stypes.append(SNP_SGL)
            slens.append(1)
            saltc.append(seq & 3)
            sseqs.append(np.zeros(0, np.uint8))
        elif typ == _ALT_DEL:
            stypes.append(SNP_DEL)
            slens.append(ln)
            saltc.append(-1)
            sseqs.append(np.zeros(0, np.uint8))
        elif typ == _ALT_INS:
            stypes.append(SNP_INS)
            slens.append(ln)
            saltc.append(-1)
            sseqs.append(np.asarray(
                [(seq >> (2 * (ln - 1 - j))) & 3 for j in range(ln)],
                np.uint8))
        elif typ == _ALT_SPLICESITE:
            strand = 1 if (seq & 0xFF) else -1
            row = (pos - 1, ln + 1, strand)
            if (seq >> 8) & 0xFF:               # excluded (repeat flank)
                ss_excl.append(row)
            else:
                ss_rows.append(row)
            continue
        elif typ == _ALT_EXON:
            exon_rows.append((pos - 1, ln + 1,
                              1 if (seq & 0xFF) else -1))
            continue
        else:
            continue
        alt_to_snp[k] = len(snames)
        snames.append(nm)
        sjpos.append(pos)
        loc = ref.joined_to_text(pos)
        if loc is None:
            schroms.append(ref.names[0] if ref.names else "")
            stpos.append(pos)
        else:
            schroms.append(ref.names[loc[0]])
            stpos.append(loc[1])

    order = np.argsort(np.asarray(sjpos, np.int64), kind="stable")
    reord = lambda lst: [lst[i] for i in order]
    inv = np.zeros(order.size, np.int64)
    inv[order] = np.arange(order.size)
    snps = SNPDB(
        names=reord(snames),
        types=np.asarray(stypes, np.int8)[order],
        jpos=np.asarray(sjpos, np.int64)[order],
        lens=np.asarray(slens, np.int32)[order],
        alt_codes=np.asarray(saltc, np.int8)[order],
        ins_seqs=reord(sseqs),
        chroms=reord(schroms),
        tpos=np.asarray(stpos, np.int64)[order],
    )
    haps = []
    for left, right, ids in raw["haplotypes"]:
        rows = [int(inv[alt_to_snp[i]]) for i in ids
                if 0 <= i < alt_to_snp.size and alt_to_snp[i] >= 0]
        if len(rows) > 1:
            haps.append(sorted(rows, key=lambda r: int(snps.jpos[r])))

    def arr(rows):
        return (np.asarray(rows, np.int64).reshape(-1, 3) if rows
                else np.zeros((0, 3), np.int64))
    return snps, arr(ss_rows), arr(exon_rows), arr(ss_excl), haps


def load_ht2(prefix: str):
    """Load a reference-built .ht2 index into our native FMIndex /
    GraphFMIndex: text/names/fragments come from .1/.3/.4; SNVs, indels,
    haplotypes, splice sites, and exons come from .7/.8 (graph indexes
    rebuild our patched-fragment graph from them — the GCSA GBWT row
    space is not translated). Local GFMs (.5/.6) and repeat files
    (.rep.*) carry no information our design needs and are skipped.
    For linear indexes the stored BWT is LF-inverted to cross-check the
    parse — a mismatch means the files were misread."""
    from ..index.fm_index import build_fm_index

    hdr = read_ht2_primary(prefix)
    ref = read_ht2_reference(prefix, hdr["names"], hdr["plens"])
    ftab_k = max(4, min(int(hdr["ftab_chars"]), 10))
    snps = ss = exons = ss_excl = None
    haps = None
    if os.path.exists(prefix + ".7.ht2"):
        raw = read_ht2_alts(prefix)
        if raw["alts"].size:
            snps, ss, exons, ss_excl, haps = alts_to_annotations(raw, ref)
    if snps is not None and len(snps):
        from ..index.graph_index import build_graph_index
        fm = build_graph_index(ref, snps, ftab_k=ftab_k,
                               haplotypes=haps or None)
    else:
        fm = build_fm_index(ref, ftab_k=ftab_k)
    # cross-validation: LF-invert the STORED BWT (GFM::restore semantics,
    # gfm.h) and compare against the .4 text tail — proves the side
    # layout/zoff/fchr were truly understood, not just the .3/.4 files
    if (hdr["linear"] and hdr["bwt"] is not None
            and hdr["gbwt_len"] == fm.n + 1 and hdr["zoffs"].size == 1):
        k = min(fm.n, 50_000)
        tail = restore_text(hdr, steps=k)
        if not (tail == ref.joined[fm.n - k:]).all():
            raise ValueError(
                ".ht2 BWT cross-check failed — file misparsed?")
    if ss is not None and ss.size:
        fm.known_ss = ss
    if exons is not None and exons.size:
        fm.known_exons = exons
    if ss_excl is not None and ss_excl.size:
        fm.excluded_ss = ss_excl
    return fm


def restore_text(hdr: dict, steps: int | None = None) -> np.ndarray:
    """LF-invert the stored BWT starting at the last row (the reference's
    GFM::restore): returns the LAST `steps` characters of the joined
    text (all of it when steps is None). The '$' sentinel is stored as
    an 'A' at row zoffs[0] and excluded from A-ranks (countBt2Side's
    z-adjustment, gfm.h:2969)."""
    bwt = hdr["bwt"]
    z = int(hdr["zoffs"][0])
    n = bwt.size
    L = n - 1
    steps = L if steps is None else min(steps, L)
    C = hdr["fchr"].astype(np.int64)
    occ = np.zeros((n + 1, 4), np.int64)
    for c in range(4):
        occ[1:, c] = np.cumsum(bwt == c)
    out = np.zeros(steps, np.uint8)
    i = L
    for j in range(steps):
        c = int(bwt[i])
        out[steps - j - 1] = c
        r = int(occ[i, c]) - (1 if (c == 0 and z < i) else 0)
        i = int(C[c]) + r
    return out
