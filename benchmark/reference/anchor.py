"""The anchor-scan kernel's plain reference, worked out from the genome.

The kernel (`ops.anchor_cuda.anchor_scan_core`) answers, for each scan row,
where the read's far-end A-mer (`acode`, 2 bits a base, base k at bits 2k)
occurs in the intron-reachable windows next to a seeded diagonal. For tile t
of W characters the window starts at

    down:  pos + min_intron + rdlen - A + t * W
    up:    pos - min_intron - (t + 1) * W

clamped at 0 and rounded down to a word of 16 characters; the W / 16 words
from there are scanned. A word holds a hit where an A-mer starting at one of
its 16 characters equals the anchor; a down row keeps the nearest words
first (its first hit in each), an up row the farthest first (its last
hit), NC entries a row, tile 0's before the deeper tiles'. The deeper tiles
count only when some live row without an N in its anchor found nothing in
tile 0. The answer is (valid (S, NC) bool, match position (S, NC)).

Here the A-mers are read off the benchmark's own genome; the program's
packed text is not used. A row whose windows reach past the chromosome's
end (where the program's text continues with its own additions) is not
compared, and where such rows leave the deep-tile rule open, either
answer is accepted for the rows that it decides.
"""

from __future__ import annotations

import numpy as np


class KmerIndex:
    """Positions of every A-mer of the genome, grouped by code."""

    def __init__(self, genome: np.ndarray, A: int = 8):
        n = genome.size - A + 1
        code = np.zeros(n, np.int64)
        for k in range(A):
            code |= genome[k:k + n].astype(np.int64) << (2 * k)
        self.order = np.argsort(code.astype(np.uint32), kind="stable")
        self.start = np.concatenate(
            [[0], np.cumsum(np.bincount(code, minlength=4 ** A))])
        self.n = genome.size
        self.A = A

    def hits(self, acode: int, lo: int, hi: int) -> np.ndarray:
        """Sorted start positions c in [lo, hi) of the A-mer acode."""
        p = self.order[self.start[acode]:self.start[acode + 1]]
        return p[np.searchsorted(p, lo):np.searchsorted(p, hi)]


def _tile_hits(kx, acode, ws, W, NC, down):
    """One tile of one row: [match position] in the kernel's order."""
    base = max(ws, 0) >> 4
    lo, hi = 16 * base, 16 * (base + W // 16)
    p = kx.hits(int(acode), lo, hi)
    if p.size == 0:
        return []
    words = p >> 4
    if down:
        _, first = np.unique(words, return_index=True)
        return [int(x) for x in p[first][:NC]]
    _, last = np.unique(words[::-1], return_index=True)
    pos = p[::-1][last]                          # last hit of each word
    return [int(x) for x in pos[::-1][:NC]]


def anchor_scan(kx: KmerIndex, ins: dict):
    """The reference's answer for captured inputs `ins` (numpy arrays pos,
    down, rdlens, acode, has_n, live or None; ints min_intron, W, A, NC,
    tiles). Returns (rows compared (bool S), per compared row the list of
    match positions for tile 0 alone and with the deeper tiles, and the
    deep-tile rule: True, False or None where it is left open)."""
    pos, down, rdl = ins["pos"], ins["down"], ins["rdlens"]
    acode, has_n = ins["acode"], ins["has_n"]
    live = ins["live"]
    W, A, NC, tiles = ins["W"], ins["A"], ins["NC"], ins["tiles"]
    mi = int(ins["min_intron"])
    S = pos.size
    reach = np.where(down, pos + mi + rdl - A + tiles * W + 32,
                     pos + 32)
    inside = reach < kx.n - A
    matters = ~has_n if live is None else (~has_n & live)
    shallow, deep = {}, {}
    found0_known = True
    missing = False
    for r in range(S):
        if not inside[r]:
            if matters[r]:
                found0_known = False
            continue
        d = bool(down[r])
        ws = [(int(pos[r]) + mi + int(rdl[r]) - A + t * W) if d else
              (int(pos[r]) - mi - (t + 1) * W) for t in range(tiles)]
        t0 = _tile_hits(kx, acode[r], ws[0], W, NC, d)
        if matters[r] and not t0:
            missing = True
        shallow[r] = t0
        if tiles > 1:
            allh = list(t0)
            for t in range(1, tiles):
                if len(allh) >= NC:
                    break
                allh += _tile_hits(kx, acode[r], ws[t], W, NC, d)
            deep[r] = allh[:NC]
        else:
            deep[r] = t0
    if tiles == 1:
        rule = False
    elif missing:
        rule = True
    else:
        rule = False if found0_known else None
    compared = np.zeros(S, bool)
    for r in shallow:
        compared[r] = bool(matters[r])
    return compared, shallow, deep, rule


def count_wrong(kx: KmerIndex, ins: dict, kvalid: np.ndarray,
                mpos: np.ndarray) -> tuple[int, int]:
    """(rows whose kernel answer differs from the reference, rows
    compared) for one captured call."""
    compared, shallow, deep, rule = anchor_scan(kx, ins)
    wrong = 0
    for r in np.flatnonzero(compared):
        got = [int(mpos[r, k]) for k in range(kvalid.shape[1])
               if kvalid[r, k]]
        valid_prefix = bool(kvalid[r, :len(got)].all())
        want = ([shallow[r]] if rule is False else [deep[r]] if rule
                else [shallow[r], deep[r]])
        if not valid_prefix or got not in want:
            wrong += 1
    return wrong, int(compared.sum())
