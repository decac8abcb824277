"""Repeat discovery + repeat database (numpy; a copy of hisat2_tpu's
index/repeats.py for the PyTorch port).

Equivalent role to the reference's hisat2-repeat / repeat_builder.{h,cpp}
(RB_SubSA suffix grouping :4247, buildRepeatBase :4406, saveRepeats :4024)
+ repeat.h RepeatDB and ht2_repeat_expand (ht2_repeat.cpp:52):

  * find all sequences of length >= `repeat_length` occurring >=
    `repeat_count` times, via suffix-array + LCP runs (the reference walks
    its own suffix-array subset the same way);
  * write <base>.rep.fa + <base>.rep.info and keep an in-memory RepeatDB
    mapping each repeat to its genomic occurrence list;
  * expand(name, pos, len) -> [(chr_id, strand, pos), ...] — the ht2lib
    repeat-expansion contract.

The alignment path uses the repeat FM index (built over .rep.fa with the
ordinary builder) to place repetitive reads once
(align/pipeline.RepeatAligner), then expands coordinates on demand
instead of enumerating every genomic copy. The .rep.fa / .rep.info files
are the JAX package's, so either package reads what the other wrote.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..io.reference import JoinedReference
from ..utils import alphabet
from .suffix_array import build_suffix_array


def lcp_array(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP: lcp[i] = LCP(suffix sa[i-1], suffix sa[i]); lcp[0]=0.

    An SA over text + sentinel (build_suffix_array's contract) goes
    through the native Kasai (native/sais.cpp kasai_lcp_i64); the Python
    loop takes any other SA (one without the sentinel row)."""
    from .. import native as _native
    n = int(text.size)
    if n and sa.size == n + 1:
        # standard Kasai over text + a unique 0xFF sentinel char
        t2 = np.empty(n + 1, np.uint8)
        t2[:n] = text.astype(np.uint8)
        t2[n] = 0xFF
        sa64 = np.ascontiguousarray(sa, np.int64)
        lcp = np.zeros(n + 1, np.int64)
        _native.sais_lib().kasai_lcp_i64(t2, sa64, lcp, np.int64(n + 1))
        return lcp
    sa = np.asarray(sa)
    rank = np.empty(sa.size, np.int64)
    rank[sa] = np.arange(sa.size)
    lcp = np.zeros(sa.size, np.int64)
    h = 0
    t = text
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = int(sa[r - 1])
            m = min(n - i, n - j)
            while h < m and t[i + h] == t[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


@dataclass
class Repeat:
    name: str
    seq: np.ndarray                       # consensus codes
    positions: list[tuple[int, bool]]     # (joined_pos, fw) occurrences

    def __len__(self) -> int:
        return int(self.seq.size)


@dataclass
class RepeatDB:
    repeats: list[Repeat] = field(default_factory=list)
    ref: JoinedReference | None = None

    def by_name(self, name: str) -> Repeat:
        for r in self.repeats:
            if r.name == name:
                return r
        raise KeyError(name)

    def expand(self, name: str, pos: int, length: int
               ) -> list[tuple[int, int, int]]:
        """Repeat-space alignment -> genomic placements
        [(chr_id, direction, pos)] (direction 0=+ 1=-), ht2_repeat.cpp:52."""
        rpt = self.by_name(name)
        out = []
        for jpos, fw in rpt.positions:
            if fw:
                g = jpos + pos
            else:
                g = jpos + (len(rpt) - pos - length)
            loc = self.ref.joined_to_text(g, length)
            if loc is not None:
                out.append((loc[0], 0 if fw else 1, loc[1]))
        return out

    # ---- persistence: .rep.fa / .rep.info (reference saveRepeats) ----

    def save(self, base: str) -> None:
        with open(base + ".rep.fa", "w") as fa, \
                open(base + ".rep.info", "w") as info:
            for r in self.repeats:
                fa.write(f">{r.name}\n{alphabet.decode(r.seq)}\n")
                coords = " ".join(
                    f"{j}:{'+' if fw else '-'}" for j, fw in r.positions)
                info.write(f"{r.name}\t{len(r)}\t{len(r.positions)}\t{coords}\n")

    @staticmethod
    def load(base: str, ref: JoinedReference) -> "RepeatDB":
        db = RepeatDB(ref=ref)
        seqs = {}
        name = None
        for line in open(base + ".rep.fa"):
            line = line.strip()
            if line.startswith(">"):
                name = line[1:]
                seqs[name] = ""
            elif name:
                seqs[name] += line
        for line in open(base + ".rep.info"):
            f = line.rstrip("\n").split("\t")
            name, length, cnt, coords = f[0], int(f[1]), int(f[2]), f[3]
            positions = []
            for c in coords.split():
                j, s = c.split(":")
                positions.append((int(j), s == "+"))
            db.repeats.append(Repeat(name, alphabet.encode(seqs[name]),
                                     positions))
        return db


# ---------------------------------------------------------------------------
# Repeat k-mer read pre-classifier (reference RB_KmerTable/RB_Minimizer,
# repeat_kmer.h:34,178-238): a read is "repetitive" iff ANY (w=5, k=31)
# minimizer of either strand appears among the repeat sequences'
# minimizers. The classification runs inside the NORMAL alignment path
# (hi_aligner.h:4274-4282) to route repetitive reads through the repeat
# index automatically.
# ---------------------------------------------------------------------------

KMER_W = 5
KMER_K = 31


def _kmers_u64(codes: np.ndarray, k: int) -> np.ndarray:
    """(B, L) base codes -> (B, L-k+1) packed uint64 k-mers (first base in
    the high bits, reference get_kmer/get_next_kmer); N counts as A
    (callers mask N-containing windows)."""
    c = np.where(codes > 3, 0, codes).astype(np.uint64)
    B, L = c.shape
    m = L - k + 1
    if m <= 0:
        return np.zeros((B, 0), np.uint64)
    km = np.zeros((B, m), np.uint64)
    for j in range(k):
        km |= c[:, j:j + m] << np.uint64(2 * (k - 1 - j))
    return km


def _minimizers(codes: np.ndarray, w: int, k: int) -> np.ndarray:
    km = _kmers_u64(codes, k)
    m = km.shape[1] - w + 1
    if m <= 0:
        return np.zeros((codes.shape[0], 0), np.uint64)
    mins = km[:, :m].copy()
    for d in range(1, w):
        np.minimum(mins, km[:, d:d + m], out=mins)
    return mins


def build_kmer_table(db: "RepeatDB", w: int = KMER_W, k: int = KMER_K
                     ) -> np.ndarray:
    """Sorted unique minimizer set of all repeat sequences."""
    out = []
    for r in db.repeats:
        if r.seq.size >= k + w - 1:
            out.append(_minimizers(r.seq[None, :], w, k)[0])
    if not out:
        return np.zeros(0, np.uint64)
    return np.unique(np.concatenate(out))


def classify_repetitive(seqs: np.ndarray, lens: np.ndarray,
                        table: np.ndarray, w: int = KMER_W,
                        k: int = KMER_K) -> np.ndarray:
    """(B,) bool: read (either strand) shares a minimizer with the repeat
    set. Vectorized host work (~20 probes/read)."""
    if table.size == 0:
        return np.zeros(seqs.shape[0], bool)
    B, L = seqs.shape
    # pad columns beyond each read's length with N so every out-of-read
    # window is excluded by the N mask below
    padded = np.where(np.arange(L)[None, :] < lens[:, None], seqs, 4)
    hit = np.zeros(B, bool)
    span = k + w - 1
    for strand in (0, 1):
        c = padded if strand == 0 else np.where(
            padded[:, ::-1] > 3, 4, 3 - padded[:, ::-1])
        mins = _minimizers(c, w, k)
        m = mins.shape[1]
        if m == 0:
            continue
        isn = (c > 3).astype(np.int32)
        cs = np.concatenate(
            [np.zeros((B, 1), np.int32), np.cumsum(isn, axis=1)], axis=1)
        hasn = (cs[:, span:span + m] - cs[:, :m]) > 0
        idx = np.searchsorted(table, mins)
        member = (idx < table.size) & (table[np.minimum(idx, table.size - 1)]
                                       == mins)
        hit |= (member & ~hasn).any(axis=1)
    return hit


SEED_MM = 5            # per-copy mismatch budget per extension side
EXT_MAX = 400          # max consensus extension per side (SeedExt reach)


def _consensus_extend(text, starts, rlen, repeat_count,
                      seed_mm=SEED_MM, ext_max=EXT_MAX):
    """SNP-aware consensus extension of an exact repeat core (the
    reference's SeedExt, repeat_builder.cpp:3947/repeat_builder.h:208):
    extend the group left/right column-by-column, each column's
    consensus = majority base over the still-live copies; a copy dies
    after `seed_mm` disagreements on that side; a side stops when live
    copies drop below repeat_count or `ext_max` is reached.

    Returns (extL, extR, consensus_seq, live_mask): copies that survived
    either side with their full extent."""
    n = text.size
    s = np.asarray(starts, np.int64)
    K = s.size
    cons_r, cons_l = [], []
    for sign in (1, -1):
        mm = np.zeros(K, np.int64)
        alive = np.ones(K, bool)
        cons = []
        for d in range(ext_max):
            col = s + rlen + d if sign == 1 else s - 1 - d
            inb = (col >= 0) & (col < n) & alive
            if inb.sum() < repeat_count:
                break
            bases = text[np.clip(col, 0, n - 1)]
            cnt = np.bincount(bases[inb], minlength=4)[:4]
            maj = int(cnt.argmax())
            # a real repeat column is near-unanimous modulo SNP'd copies;
            # random flanks (~max 40% agreement over 4 symbols) stop the
            # extension immediately
            if cnt[maj] < max(repeat_count, (3 * int(inb.sum())) // 4 + 1):
                break
            mm += inb & (bases != maj)
            alive &= inb & (mm <= seed_mm)
            if alive.sum() < repeat_count:
                break
            cons.append(maj)
        if sign == 1:
            cons_r = cons
        else:
            cons_l = cons
    extL, extR = len(cons_l), len(cons_r)
    seq = np.concatenate([
        np.asarray(cons_l[::-1], np.uint8),
        text[int(s[0]):int(s[0]) + rlen].astype(np.uint8),
        np.asarray(cons_r, np.uint8)])
    return extL, extR, seq


def build_repeats(ref: JoinedReference, repeat_length: int = 100,
                  repeat_count: int = 5, max_repeats: int = 100000,
                  forward_only: bool = False, sa: np.ndarray | None = None,
                  consensus: bool = True) -> RepeatDB:
    """Find repeats of length >= repeat_length occurring >= repeat_count
    times (both strands unless forward_only, mirroring hisat2-repeat's
    default two-strand construction), then extend each exact core into a
    mismatch-tolerant consensus (SeedExt role).

    sa: optional precomputed suffix array over the (fw [+ rc]) text
    (hisat2-repeat --load-sa equivalent; cli/repeat.py persists it)."""
    fw_text = ref.joined
    if forward_only:
        text = fw_text
        n_fw = text.size
    else:
        rc = alphabet.revcomp(ref.joined)
        text = np.concatenate([fw_text, rc])
        n_fw = fw_text.size
    if sa is None:
        sa = build_suffix_array(text)
    lcp = lcp_array(text, sa)

    from bisect import bisect_right, insort

    db = RepeatDB(ref=ref)
    m = sa.size
    rid = 0
    # shifted sub-repeats of an already-emitted repeat are redundant (the
    # reference merges them during seed extension / consensus building);
    # dedup by marking the text covered by accepted occurrences. cov_rid
    # remembers WHICH repeat covered a start so later shifted groups can
    # donate their still-uncovered copies to it (allele-coordinate
    # adoption, reference RB_AlleleCoord role, repeat_builder.h:435).
    covered = np.zeros(text.size + 1, bool)
    cov_rid = np.full(text.size + 1, -1, np.int32)
    tstarts: list[list[int]] = []     # per-rid sorted text-space starts
    tot_of: list[int] = []

    def mark(p0, tot, r):
        covered[p0:p0 + tot] = True
        cov_rid[p0:p0 + tot] = r

    # vectorized run walk: maximal runs of lcp >= repeat_length
    ge = lcp >= repeat_length
    ge[0] = False
    d = np.diff(ge.astype(np.int8))
    run_s = np.flatnonzero(d == 1) + 1            # first r with ge
    run_e = np.flatnonzero(d == -1) + 1           # one past last
    if ge.size and ge[-1]:
        run_e = np.append(run_e, m)
    for t in range(run_s.size):
        if rid >= max_repeats:
            break
        i, j = int(run_s[t]), int(run_e[t])
        group = sa[i - 1:j]
        if group.size < repeat_count:
            continue
        rlen = int(lcp[i:j].min())
        starts = group[group + rlen <= text.size].astype(np.int64)
        if starts.size < repeat_count:
            continue
        # groups mostly covered by an earlier repeat: don't re-emit a
        # shifted duplicate — but DO adopt their uncovered copies into
        # the dominant covering repeat (the shared exact window fixes
        # the consensus offset via any covered member)
        fresh = sum(int((~covered[g:g + rlen]).sum()) for g in starts)
        if fresh < (starts.size * rlen) // 2:
            rids = cov_rid[starts]
            have = rids >= 0
            if not have.any():
                continue
            vals, cnts = np.unique(rids[have], return_counts=True)
            r_star = int(vals[cnts.argmax()])
            tot = tot_of[r_star]
            ts = tstarts[r_star]
            # consensus offset from any covered member of this group
            gc = int(starts[have][rids[have] == r_star][0])
            k = bisect_right(ts, gc) - 1
            if k < 0 or gc >= ts[k] + tot:
                continue
            shift = gc - ts[k]
            rep = db.repeats[r_star]
            for g in starts[~have]:
                p0 = int(g) - shift
                if (p0 < 0 or p0 + tot > text.size
                        or (p0 < n_fw) != (g < n_fw) or covered[p0]):
                    continue
                mark(p0, tot, r_star)
                insort(ts, p0)
                if p0 < n_fw:
                    rep.positions.append((p0, True))
                    if not forward_only:
                        mark(max(0, 2 * n_fw - (p0 + tot)), tot, r_star)
                else:
                    fwpos = max(0, 2 * n_fw - (p0 + tot))
                    rep.positions.append((fwpos, False))
                    mark(fwpos, tot, r_star)
            continue
        extL = extR = 0
        seq = text[int(starts[0]):int(starts[0]) + rlen]
        if consensus:
            extL, extR, seq = _consensus_extend(
                text, starts, rlen, repeat_count)
        tot = rlen + extL + extR
        positions = []
        ts = []
        for g in starts:
            g0 = max(0, int(g) - extL)
            mark(g0, tot, rid)
            ts.append(g0)
            if g < n_fw:
                positions.append((g0, True))
                if not forward_only:   # mark the rc twin too
                    mark(max(0, 2 * n_fw - (g0 + tot)), tot, rid)
            else:
                fwpos = max(0, 2 * n_fw - (g0 + tot))
                positions.append((fwpos, False))
                mark(fwpos, tot, rid)
        db.repeats.append(
            Repeat(f"rpt_{rid}", np.asarray(seq, np.uint8).copy(),
                   positions))
        tstarts.append(sorted(ts))
        tot_of.append(tot)
        rid += 1
    return db
