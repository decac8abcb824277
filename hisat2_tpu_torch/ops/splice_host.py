"""Host (NumPy) mirror of the junction scorer (ops/splice.py); a copy of
hisat2_tpu's.

The RNA finish scores its small lane sets here rather than queue a device
call mid-finish behind the next batch's step: the cleanup rescue of rows
the step's splice pass did not cover, the new-site repair (_newp_rescue)
and second-pass chaining, against the host copy of the joined text.

Semantics mirror ops/splice.junction_score + _gate_pack (same reference
policy: hi_aligner.h:3753-3786, tp.h anchors, splice_site.cpp PWM), in
float64 where the device scorer is float32, as the JAX package has it;
tests/test_torch_splice_ops.py holds each against the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..align import splice_model as _sm
from .splice import (CANON_PEN, NONCANON_PEN, MIN_ANCHOR_CANON,
                     MIN_ANCHOR_NONCANON, NEG)


def _window(joined: np.ndarray, start: np.ndarray, length: int,
            overlay: np.ndarray | None):
    """(C, length) text codes at joined[start + k] (4 beyond the ends),
    plus the matching SNV-overlay nibbles (0 where absent)."""
    idx = start[:, None].astype(np.int64) + np.arange(length)[None, :]
    inb = (idx >= 0) & (idx < joined.size)
    w = np.where(inb, joined[np.clip(idx, 0, joined.size - 1)], 4
                 ).astype(np.int64)
    if overlay is None:
        ov = None
    else:
        ov = np.where(inb, overlay[np.clip(idx, 0, overlay.size - 1)], 0
                      ).astype(np.int64)
    return w, ov


def junction_score_host(joined: np.ndarray, scoring, rd, q, rdlens,
                        posA, posB, kleft, kright,
                        overlay: np.ndarray | None = None) -> dict:
    """NumPy junction_score: rd (C, L) codes in alignment orientation,
    posA/posB (C,) joined diagonals. kleft/kright: known sites sorted by
    (left, right). overlay: optional global 4-bit SNV overlay (graph
    mode free alt-allele matches). Returns the same per-lane dict as the
    device kernel."""
    C, L = rd.shape
    rd = rd.astype(np.int64)
    q = np.clip(q.astype(np.int64), 0, 63)
    rdlens = rdlens.astype(np.int64)
    posA = posA.astype(np.int64)
    posB = posB.astype(np.int64)
    delta = posB - posA

    winA, ovA = _window(joined, posA, L + 16, overlay)
    winB_ext, ovBx = _window(joined, posB - 16, L + 18, overlay)
    winB = winB_ext[:, 16:16 + L]
    ovB = None if ovBx is None else ovBx[:, 16:16 + L]

    ar = np.arange(L)[None, :]
    in_read = ar < rdlens[:, None]
    mm_pens = scoring.mm_pens()
    sc_pens = scoring.sc_pens()

    def pos_scores(win, ov):
        isn = ((rd >= 4) | (win >= 4)) & in_read
        mm = (rd != win) & ~isn & in_read
        if ov is not None:
            mm = mm & ~((ov == rd + 1) | (ov == 15))
        s = -np.where(mm, mm_pens[q], 0) \
            - np.where(isn, scoring.n_pen, 0) \
            + np.where(~mm & ~isn & in_read, scoring.match_bonus, 0)
        return s.astype(np.int64)

    sA = pos_scores(winA[:, :L], None if ovA is None else ovA[:, :L])
    sB = pos_scores(winB, ovB)
    scp = np.where(in_read, sc_pens[q], 0).astype(np.int64)
    SCP = np.zeros((C, L + 1), np.int64)
    np.cumsum(scp, axis=1, out=SCP[:, 1:])
    A = np.zeros((C, L + 1), np.int64)
    np.cumsum(sA, axis=1, out=A[:, 1:])
    prefix = A - np.minimum.accumulate(A + SCP, axis=1)
    SB = np.zeros((C, L + 1), np.int64)
    np.cumsum(sB, axis=1, out=SB[:, 1:])
    sufsum = SB[:, -1:] - SB
    tailclip = SCP[:, -1:] - SCP
    suffix = sufsum - np.minimum.accumulate(
        (sufsum + tailclip)[:, ::-1], axis=1)[:, ::-1]
    base = prefix + suffix

    jcol = np.arange(L + 1)[None, :]
    don1 = winA[:, 0:L + 1]
    don2 = winA[:, 1:L + 2]
    acc1 = winB_ext[:, 14:L + 15]
    acc2 = winB_ext[:, 15:L + 16]
    plus = (don1 == 2) & (don2 == 3) & (acc1 == 0) & (acc2 == 2)
    minus = (don1 == 1) & (don2 == 3) & (acc1 == 0) & (acc2 == 1)
    canonical = plus | minus

    known = np.zeros((C, L + 1), bool)
    if kleft.size:
        base_l = np.searchsorted(kleft, posA)
        nk = kleft.size
        for dpr in range(12):
            kk = np.clip(base_l + dpr, 0, nk - 1)
            l_p = kleft[kk]
            r_p = kright[kk]
            jv = (l_p - posA + 1).astype(np.int64)
            okp = (l_p < posA + L) & (r_p == posB + jv) \
                & (jv >= 0) & (jv <= L)
            known |= okp[:, None] & (jcol == jv[:, None])

    ilp = np.maximum(
        0, (-8.0 + np.log(np.maximum(delta, 1).astype(np.float64)))
    ).astype(np.int64)[:, None]
    pen_canon = ilp + CANON_PEN
    pen_non = ilp + NONCANON_PEN

    def anchor_ok(a):
        return (jcol >= a) & (jcol <= rdlens[:, None] - a)
    cand_known = np.where(known & anchor_ok(1), base - ilp, NEG)
    cand_canon = np.where(canonical & anchor_ok(MIN_ANCHOR_CANON),
                          base - pen_canon, NEG)
    cand_non = np.where(anchor_ok(MIN_ANCHOR_NONCANON),
                        base - pen_non, NEG)
    allc = np.maximum(np.maximum(cand_known, cand_canon), cand_non)

    best_j = np.argmax(allc, axis=1).astype(np.int64)
    rr = np.arange(C)
    best = allc[rr, best_j]
    bknown = known[rr, best_j]
    bcanon = canonical[rr, best_j]
    bplus = plus[rr, best_j]
    ok = (delta >= 20) & (best > NEG // 2)
    strand = np.where(bplus | (bknown & ~bcanon), 1, 2)

    mmA = ((rd != winA[:, :L]) | (rd >= 4) | (winA[:, :L] >= 4)) & in_read
    mmB = ((rd != winB) | (rd >= 4) | (winB >= 4)) & in_read
    MA = np.zeros((C, L + 1), np.int64)
    np.cumsum(mmA, axis=1, out=MA[:, 1:])
    MBc = np.zeros((C, L + 1), np.int64)
    np.cumsum(mmB, axis=1, out=MBc[:, 1:])
    mmL = MA[rr, best_j]
    mmR = MBc[rr, rdlens] - MBc[rr, best_j]

    # PWM probscore at the chosen junction (splice_model; '-' junctions
    # score the reverse-complemented windows; N -> base 0 pre-complement,
    # hi_aligner.h:1672)
    md = np.arange(_sm.DONOR_LEN)[None, :]
    ma = np.arange(_sm.ACCEPTOR_LEN)[None, :]
    j1 = best_j[:, None]
    fixn = lambda w: np.where(w > 3, 0, w)
    dp_idx = np.clip(j1 - 3 + md, 0, L + 15)
    ap_idx = np.clip(2 + j1 + ma, 0, L + 17)
    dm_idx = np.clip(18 + j1 - md, 0, L + 17)
    am_idx = np.clip(j1 + 13 - ma, 0, L + 15)
    dplus = fixn(np.take_along_axis(winA, dp_idx, 1))
    aplus = fixn(np.take_along_axis(winB_ext, ap_idx, 1))
    dmin = 3 - fixn(np.take_along_axis(winB_ext, dm_idx, 1))
    amin = 3 - fixn(np.take_along_axis(winA, am_idx, 1))
    use_plus = bplus[:, None]
    dwin = np.where(use_plus, dplus, dmin)
    awin = np.where(use_plus, aplus, amin)
    # gather log-odds by (base, position)
    dlo = _sm.DONOR_LOGODDS
    alo = _sm.ACCEPTOR_LOGODDS
    s_sig = dlo[dwin, md].sum(axis=1) + alo[awin, ma].sum(axis=1)
    pscore = (1.0 / (1.0 + np.exp(-s_sig))).astype(np.float32)

    return dict(
        score=np.where(ok, best, NEG),
        j=best_j,
        strand=np.where(ok, strand, 0).astype(np.int64),
        canon=np.where(bknown, 1, np.where(bcanon, 2, 0)).astype(np.int64),
        probscore=pscore,
        mmL=mmL.astype(np.int64),
        mmR=mmR.astype(np.int64),
    )


def gate_pack_host(r: dict, scoring, rdlens, posA, posB, max_intron,
                   dta: bool) -> np.ndarray:
    """NumPy _gate_pack: acceptance gates (hi_aligner.h:3753-3786) ->
    (C, 3) int64 [score, j, flags]."""
    score, j, strand, canon = r["score"], r["j"], r["strand"], r["canon"]
    rdlens = rdlens.astype(np.int64)
    delta = (posB - posA).astype(np.int64)
    min_sc = np.ceil(scoring.score_min.I
                     + scoring.score_min.S * rdlens).astype(np.int64)
    alive = strand != 0
    below = score < min_sc
    part = alive & below & (canon != 0) & (score > NEG // 2)
    aL = j - 2 * r["mmL"]
    aR = rdlens - j - 2 * r["mmR"]
    shorter = np.maximum(np.minimum(aL, aR), 1)
    lim_c = _sm.max_intron_len(shorter)
    lim_n = _sm.max_intron_len_noncan(shorter)
    ok = np.ones(score.shape, bool)
    is_can = canon == 2
    gate_c = lim_c < max_intron
    ok &= ~(is_can & gate_c & (delta > lim_c))
    ok &= ~(is_can & gate_c
            & (r["probscore"] < _sm.probscore_thresh(delta)))
    is_non = canon == 0
    ok &= ~(is_non & (lim_n < max_intron) & (delta > lim_n))
    if dta:
        anchor = np.minimum(j, rdlens - j)
        ok &= ~(is_can & (anchor < 14))
    accept = alive & ~below & ok
    flags = (strand | (canon << 2) | (accept.astype(np.int64) << 4)
             | (part.astype(np.int64) << 5))
    return np.stack([score, j, flags], axis=1)


_PWM32 = None


def junction_score_gate(joined, scoring, rd, q, rdlens, posA, posB,
                        kleft, kright, overlay, max_intron, dta,
                        n_threads: int = 4):
    """junction_score_host + gate_pack_host in one call, on the native
    scorer (native/juncscore.cpp) — the RNA finish scores residual and
    cleanup lanes on the host, and the NumPy mirror's ~20 (C, L)
    temporaries cost more than the lanes. Returns (rdict, pack) with the
    same contents as the NumPy pair."""
    from ..native import juncscore_lib
    global _PWM32
    C = int(rd.shape[0])
    if C == 0:
        r = junction_score_host(joined, scoring, rd, q, rdlens,
                                posA, posB, kleft, kright,
                                overlay=overlay)
        return r, gate_pack_host(r, scoring, rdlens, posA, posB,
                                 max_intron, dta)
    lib = juncscore_lib()
    L = int(rd.shape[1])
    if _PWM32 is None:
        _PWM32 = (np.ascontiguousarray(_sm.DONOR_LOGODDS, np.float64),
                  np.ascontiguousarray(_sm.ACCEPTOR_LOGODDS, np.float64))
    dlo, alo = _PWM32
    rd8 = np.ascontiguousarray(rd, np.int8)
    q8 = np.ascontiguousarray(q, np.int8)
    rl = np.ascontiguousarray(rdlens, np.int64)
    pa = np.ascontiguousarray(posA, np.int64)
    pb = np.ascontiguousarray(posB, np.int64)
    kl = np.ascontiguousarray(kleft, np.int64)
    kr = np.ascontiguousarray(kright, np.int64)
    jt = joined if joined.dtype == np.uint8 else joined.astype(np.uint8)
    jt = np.ascontiguousarray(jt)
    mm = np.ascontiguousarray(scoring.mm_pens(), np.int64)
    sc = np.ascontiguousarray(scoring.sc_pens(), np.int64)
    out = np.empty((C, 7), np.int64)
    out_ps = np.empty(C, np.float32)
    if overlay is not None:
        ovc = np.ascontiguousarray(overlay, np.uint8)
        ovp = ovc.ctypes.data
    else:
        ovp = None
    lib.junc_score_batch(
        jt, np.int64(jt.size), ovp, rd8, q8, rl, pa, pb,
        np.int64(C), np.int64(L), kl, kr, np.int64(kl.size),
        mm, sc, np.int64(scoring.n_pen), np.int64(scoring.match_bonus),
        float(scoring.score_min.I), float(scoring.score_min.S),
        np.int64(max_intron), np.int32(1 if dta else 0),
        np.int64(CANON_PEN), np.int64(NONCANON_PEN),
        dlo, alo, out, out_ps, np.int32(n_threads))
    r = dict(score=out[:, 0], j=out[:, 1], strand=out[:, 2],
             canon=out[:, 3], probscore=out_ps, mmL=out[:, 4],
             mmR=out[:, 5])
    pack = np.stack([out[:, 0], out[:, 1], out[:, 6]], axis=1)
    return r, pack


def dp_score_host(scoring, rd, q, rdlens, win):
    """NumPy mirror of ops/sw.dp_score_batch (affine-gap score with
    clip-penalty soft clips): the sharded/host-mode mate rescue gates
    its per-lane tracebacks on this score instead of tracing every lane
    (512-lane batches of junk windows cost seconds per batch at Gbp).

    rd (C, L) codes 0..4, q (C, L), rdlens (C,), win (C, W) codes 0..4.
    Returns (C,) int64 scores."""
    import numpy as np
    C, L = rd.shape
    W = win.shape[1]
    NEGv = -(1 << 28)
    rd = rd.astype(np.int64)
    qc = np.clip(q.astype(np.int64), 0, 63)
    mm_pens = scoring.mm_pens()
    sc_pens = scoring.sc_pens()
    ro, re = scoring.read_gap_open(), scoring.read_gap_extend()
    fo, fe = scoring.ref_gap_open(), scoring.ref_gap_extend()
    mb, npen = scoring.match_bonus, scoring.n_pen
    in_read = np.arange(L)[None, :] < rdlens[:, None]
    scp = np.where(in_read, sc_pens[qc], 0)
    scp_cum = np.cumsum(scp, axis=1)
    scp_tot = scp_cum[:, -1]
    jcols = np.arange(W + 1, dtype=np.int64)
    H = np.zeros((C, W + 1), np.int64)
    F = np.full((C, W + 1), NEGv, np.int64)
    best = -scp_tot.copy()
    winN = win >= 4
    for i in range(L):
        act = in_read[:, i]
        if not act.any():
            break
        rc = rd[:, i][:, None]
        isn = (rc >= 4) | winN
        mm = (win != rc) & ~isn
        sub = np.where(mm, -mm_pens[qc[:, i]][:, None], mb)
        sub = np.where(isn, -npen, sub)
        diag = H[:, :-1] + sub
        Fn_tail = np.maximum(H[:, 1:] - fo, F[:, 1:] - fe)
        col0 = np.full((C, 1), -(fo + i * fe), np.int64)
        G = np.concatenate([col0, np.maximum(diag, Fn_tail)], axis=1)
        M = np.maximum.accumulate(G + re * jcols[None, :], axis=1)
        E_tail = M[:, :-1] - ro - re * (jcols[1:][None, :] - 1)
        Hn = np.concatenate([col0, np.maximum(G[:, 1:], E_tail)], axis=1)
        Hn = np.maximum(Hn, -scp_cum[:, i][:, None])
        Fn = np.concatenate([col0, Fn_tail], axis=1)
        H = np.where(act[:, None], Hn, H)
        F = np.where(act[:, None], Fn, F)
        tail = scp_tot - scp_cum[:, i]
        best = np.where(act, np.maximum(best, Hn.max(axis=1) - tail),
                        best)
    return np.maximum(best, H.max(axis=1))
