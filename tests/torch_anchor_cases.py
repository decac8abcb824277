"""Synthetic anchor-scan rows for the kernel's checks: chip_smoke.py's
phase 3 and the CPU and card tests of tests/test_torch_splice_ops.py
build their cases here. numpy and the port only."""

from __future__ import annotations

import numpy as np

RDLEN = 100                   # read length of the synthetic rows
ANCHOR_W = 65536              # the anchor scan's tile, on every caller
ANCHOR_TEXT = 1 << 20         # the random text's length


def text_rows_of(codes: np.ndarray) -> np.ndarray:
    """A text of codes 0..3 as FMIndex.device_bundle lays out text_rows:
    2-bit packed words (base i at bits 2 * (i % 16) of word i // 16) as
    int64, 16 a row, and one row of zeros past the end."""
    nw = -(-codes.size // 16)
    padded = np.zeros(nw * 16, np.int64)
    padded[:codes.size] = codes
    words = (padded.reshape(nw, 16) << (2 * np.arange(16))).sum(axis=1)
    rows = np.zeros((-(-nw // 16) + 1, 16), np.int64)
    rows.reshape(-1)[:nw] = words
    return rows


def kmer8_codes(codes: np.ndarray) -> np.ndarray:
    """The anchor code of the 8-mer at every text position p (p + 8 <= n),
    little-endian 2-bit as ops/splice.anchor_codes builds it."""
    c = codes.astype(np.int64)
    m = c.size - 7
    return sum(c[k:k + m] << (2 * k) for k in range(8))


def anchor_window(pos, down, rdl, t, mi, W=ANCHOR_W, A=8):
    """First character of tile t's window, 16 * base, as the anchor scan
    addresses it (the start clamped at 0, then down to its word)."""
    ws = np.where(down, pos + mi + rdl - A + t * W, pos - mi - (t + 1) * W)
    return (np.maximum(ws, 0) >> 4) << 4


def make_anchor_case(seed, S, tiles, resolve0=False, mask=True,
                     text_len=ANCHOR_TEXT, strip_edge=False):
    """Anchor-scan rows of every kind over a random text of text_len
    bases, 100 bp reads, min_intron 20. Each row is one of: an anchor cut
    from its tile-0 window (three kinds in eight); one cut from a deeper
    tile and absent from tile 0; a code absent from tile 0 (no hit
    there); an N in the anchor; a read shorter than 15 bp; and an edge
    row, half of them up scans off the text's start and half down scans
    whose window starts past the text's end (reading its last row again)
    or, with resolve0, halfway into it. With resolve0 no row is of the
    two kinds without a tile-0 hit, so every live row without an N anchor
    resolves in tile 0 and the deep branch is not taken; without it,
    rows that miss tile 0 take it whenever tiles > 1. `mask` gives a live
    mask (about 15% of the rows dead), else live is None. With resolve0,
    half the dead rows and half the rows with an N anchor or a short read
    carry a code absent from tile 0: rows that must not set the branch.
    With strip_edge, each row of the three kinds with a tile-0 anchor
    takes a fresh code planted in tile 0 on both sides of a boundary
    between two strips (plant_strip_edge), after the other rows are made.
    Returns dict(rows, rd, rdl, pos, down, live, mi)."""
    from hisat2_tpu_torch.ops import anchor_cuda
    from hisat2_tpu_torch.ops.splice import MIN_ANCHOR_CANON
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, text_len).astype(np.uint8)
    k8 = kmer8_codes(codes)
    L, A, W, mi = RDLEN, 8, ANCHOR_W, 20
    rd = rng.integers(0, 4, (S, L)).astype(np.int32)
    rdl = np.full(S, L, np.int32)
    down = rng.random(S) < 0.5
    pos = np.empty(S, np.int64)
    kind = rng.integers(0, 8, S)
    live = rng.random(S) > 0.15 if mask else None
    if resolve0:
        kind = np.where((kind == 3) | (kind == 4), 0, kind)
    if tiles == 1:
        kind = np.where(kind == 3, 4, kind)

    def put(i, code_bases):
        if down[i]:
            rd[i, rdl[i] - A:rdl[i]] = code_bases
        else:
            rd[i, :A] = code_bases

    def span(i, t):
        lo = int(anchor_window(pos[i], down[i], rdl[i], t, mi))
        return lo, min(lo + W, text_len) - A

    def plant(i, t):
        lo, hi = span(i, t)
        if hi > lo:
            p = int(rng.integers(lo, hi))
            put(i, codes[p:p + A])
        return hi > lo

    def absent_from_tile0(i):
        lo, hi = span(i, 0)
        present = np.zeros(1 << 16, bool)
        present[k8[max(lo, 0):max(hi, 0)]] = True
        return np.flatnonzero(~present)

    for i in range(S):
        k = kind[i]
        if k == 6:
            rdl[i] = rng.integers(A, A + MIN_ANCHOR_CANON)
        if k == 7:
            if i % 2:
                down[i] = False
                pos[i] = rng.integers(0, mi + W)
            else:
                down[i] = True
                pos[i] = (text_len - W // 2 if resolve0
                          else text_len - rng.integers(0, 3000))
        elif down[i]:
            pos[i] = rng.integers(0, max(1, text_len - tiles * W - 200))
        else:
            pos[i] = rng.integers(min(tiles * W + 100, text_len - L),
                                  text_len - L)
        if k == 3:
            t = int(rng.integers(1, tiles))
            miss0 = absent_from_tile0(i)
            for _ in range(50):
                lo, hi = span(i, t)
                p = int(rng.integers(lo, hi))
                if np.isin(k8[p], miss0):
                    put(i, codes[p:p + A])
                    break
        elif k == 4 or (resolve0 and i % 2 and (
                k in (5, 6) or (live is not None and not live[i]))):
            code = int(rng.choice(absent_from_tile0(i)))
            put(i, (code >> (2 * np.arange(A))) & 3)
        else:
            plant(i, 0)
        if k == 5:
            rd[i, (rdl[i] - A if down[i] else 0) + int(rng.integers(0, A))] = 4

    def plant_strip_edge(i):
        """A fresh code for row i, planted in its tile 0 at a random
        boundary b between two strips (in words, nearest first): one or two
        hits just nearer (distances b - 1, b - 3), two more than NC = 4 just
        past it (b .. b + 5), each at a shift of 0..7 so the planted 8-mers
        stay inside their words."""
        NW, sw = W // 16, anchor_cuda.STRIP_WORDS
        bases = rng.integers(0, 4, A).astype(np.uint8)
        put(i, bases)
        b = sw * int(rng.integers(1, NW // sw))
        lo = int(anchor_window(pos[i], down[i], rdl[i], 0, mi))
        for d in [b - 1, b - 3][:int(rng.integers(1, 3))] + list(
                range(b, b + 6)):
            p = lo + 16 * (d if down[i] else NW - 1 - d) + int(
                rng.integers(0, 8))
            codes[p:p + A] = bases

    if strip_edge:
        for i in np.flatnonzero(kind < 3):
            plant_strip_edge(i)
    return dict(rows=text_rows_of(codes), rd=rd, rdl=rdl, pos=pos,
                down=down, live=live, mi=mi)


def anchor_core_inputs(case, dev):
    """The anchor-scan core's inputs of a make_anchor_case on `dev`, the
    prelude (ops/splice.anchor_codes) run there: (rows, pos, down, rdlens,
    acode, has_n, live, min_intron)."""
    import torch
    from hisat2_tpu_torch.ops import splice
    i32 = torch.int32
    rd = torch.from_numpy(case["rd"]).to(dev)
    rdl = torch.from_numpy(case["rdl"]).to(dev)
    down = torch.from_numpy(case["down"]).to(dev)
    acode, has_n = splice.anchor_codes(rd, rdl, down)
    live = (None if case["live"] is None
            else torch.from_numpy(case["live"]).to(dev))
    return (torch.from_numpy(case["rows"]).to(dev),
            torch.from_numpy(case["pos"]).to(dev, i32), down, rdl, acode,
            has_n, live, case["mi"])
