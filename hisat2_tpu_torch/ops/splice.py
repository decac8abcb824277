"""Batched splice-junction stitching (PyTorch port of hisat2_tpu's
ops/splice.py).

Equivalent role to the reference's SplicedAligner::hybridSearch_recur
(spliced_aligner.h:331) + SpliceSiteDB signal checks (splice_site.cpp
donor/acceptor scoring): given a candidate *pair* of exon diagonals
(posA upstream, posB downstream, intron = posB - posA), find the read
offset where the alignment switches diagonals, maximizing per-position
match score + splice-motif bonus, under the reference's anchor/penalty
policy (tp.h: min anchor 7 canonical / 14 non-canonical; canonical
GT..AG penalty 0, non-canonical 12; intron-length penalty G,-8,1 —
hisat2.cpp:493-497).

One lane per (read, diagonal pair); the junction offset search is a
closed-form argmax over prefix/suffix score sums: three window fetches
and cumulative sums a lane, plain tensor code (the JAX package has no
Pallas kernel here either). anchor_scan's scan is a plain XLA scan in
the JAX package; here it is a hand-written CUDA kernel on the card
(csrc/anchor_scan.cu through ops/anchor_cuda.anchor_scan_core), with
anchor_scan_plain_core as the CPU path and the oracle.

What is not integer arithmetic gives the JAX version's float32 results
on the CPU and the same bits on the card: the intron-length penalty
(max(0, -8 + ln(len)) in float32, truncated) is a count of integer
thresholds, the least lengths at which that float32 value reaches each
integer, found once with torch's float32 log on the CPU (_ilp_thresholds);
the splice-signal score sums its float32 log-odds base by base, donor
before acceptor, each window in position order, and gates on
1 / (1 + exp(-s)) with exp computed as XLA computes it on the CPU
(Cephes' expf with fused multiply-adds, _exp_f32), from operations that
round the same on every device. Every lax.top_k becomes
a stable descending sort (ties in ascending index order, as top_k keeps
them). The JAX version's lax.cond over the deeper anchor-scan tiles
is decided on the device, so no device value decides a branch on the
host: the plain core computes every tile and selects with torch.where;
the kernel's tile-0 launch sets a device flag when some live row without
an N anchor found nothing, and its deep launch, queued always, returns
at once while the flag is 0.
"""

from __future__ import annotations

import torch

from . import anchor_cuda as _anchor_cuda
from . import rank as _rank
from ..align import splice_model as _sm
from ..align.scoring import mm_pen_of as _mm_pen_of, sc_pen_of as _sc_pen_of

I32 = torch.int32
NEG = -(1 << 28)

CANON_PEN = 0
NONCANON_PEN = 12
MIN_ANCHOR_CANON = 7
MIN_ANCHOR_NONCANON = 14


def _arange(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


def _sorted_desc(key: torch.Tensor, k: int):
    """lax.top_k(key, k) along the last axis: (values, int64 indices),
    largest first, ties in ascending index order."""
    v, ix = torch.sort(key, dim=-1, descending=True, stable=True)
    return v[..., :k], ix[..., :k]


def _topk01(mask: torch.Tensor, k: int):
    """lax.top_k over a 1-D 0/1 mask: (values int32, indices int64)."""
    return _sorted_desc(mask.to(I32), k)


def _scatter_max(n: int, index: torch.Tensor, src: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """A (n,) int32 tensor of `fill`, raised by scatter-max of src at index."""
    out = torch.full((n,), fill, dtype=I32, device=src.device)
    return out.scatter_reduce_(0, index.long().reshape(-1),
                               src.to(I32).reshape(-1), reduce="amax")


def _scatter_any(n: int, index: torch.Tensor, src: torch.Tensor):
    """A (n,) bool tensor: True where some src at that index is."""
    return _scatter_max(n, index, src.to(I32), 0) > 0


def _searchsorted(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """searchsorted(table, q), side left, as int32."""
    return torch.searchsorted(table, q.to(table.dtype).contiguous(),
                              out_int32=True)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


_ILP: list = []


def _ilp_thresholds() -> list:
    """T[k - 1]: the least intron length at which max(0, -8 + ln(len)),
    computed in float32 and truncated, reaches k — for every k an int32
    length can reach. Found once on the CPU, where torch's float32 log
    gives XLA's penalty at every length up to 500,000
    (tests/test_torch_splice_ops.py); the penalty is then an integer count
    on any device."""
    if not _ILP:
        def pen(n: int) -> int:
            v = -8.0 + torch.log(torch.tensor(float(n), dtype=torch.float32))
            return int(v.clamp_min(0.0))
        for k in range(1, 14):
            lo, hi = 1, (1 << 31) - 1        # pen(lo) < k <= pen(hi)
            if pen(hi) < k:
                break
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (lo, mid) if pen(mid) >= k else (mid, hi)
            _ILP.append(hi)
    return _ILP


def _intron_len_pen(delta):
    """G,-8,1 intron-length penalty: max(0, -8 + ln(len)) in float32,
    truncated (0 for len <= 0, as XLA converts the NaN and -inf), counted
    as the thresholds of _ilp_thresholds that delta reaches."""
    d = delta.to(torch.int64)
    pen = torch.zeros(delta.shape, dtype=I32, device=delta.device)
    for t in _ilp_thresholds():
        pen += (d >= t).to(I32)
    return pen


def _f32_const(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


_EXP_LO, _EXP_HI = _f32_const(-88.3762626647949), _f32_const(88.3762626647950)
_LOG2E = _f32_const(1.44269504088896341)
_EXP_C1, _EXP_C2 = _f32_const(0.693359375), _f32_const(-2.12194440e-4)
_EXP_P = tuple(_f32_const(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _fma(a, b, c):
    """a * b + c rounded once to float32: a float32 product is exact in
    float64. b and c are float32 tensors or float32 constants."""
    def d(v):
        return v.double() if torch.is_tensor(v) else v
    return (d(a) * d(b) + d(c)).float()


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2 ** e for integral float32 e in [-126, 127], built from its bits."""
    return ((e.to(I32) + 127) << 23).view(torch.float32)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor with XLA's CPU result, bit for bit, for
    |x| < 87 (beyond, XLA flushes to 0 or saturates; the splice score
    stays far inside): Cephes' expf (range reduction by ln 2 in two
    parts, a degree-5 polynomial) with every multiply-add fused, as XLA
    emits it. The same bits on the CPU and the card."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(x * _LOG2E + 0.5)
    r = _fma(fx, -_EXP_C1, x)
    r = _fma(fx, -_EXP_C2, r)
    z = r * r
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, z, r) + 1.0
    # 2 ** fx in two factors, so fx = 128 does not overflow the exponent
    h = torch.floor(fx * 0.5)
    return y * _pow2(h) * _pow2(fx - h)


def _probscore(dwin: torch.Tensor, awin: torch.Tensor) -> torch.Tensor:
    """Splice-signal probscore of (C, 9) donor and (C, 15) acceptor
    windows of codes 0..3: float32 log-odds summed base by base, the donor
    window before the acceptor's, each in position order; then
    1 / (1 + exp(-s)), exp as _exp_f32 computes it."""
    dev = dwin.device
    dlo = torch.from_numpy(_sm.DONOR_LOGODDS).to(dev)       # (4, 9)
    alo = torch.from_numpy(_sm.ACCEPTOR_LOGODDS).to(dev)    # (4, 15)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    s_sig = torch.zeros(dwin.shape[0], dtype=torch.float32, device=dev)
    for b in range(4):
        for win, lo in ((dwin, dlo), (awin, alo)):
            part = torch.where(win == b, lo[b][None, :], z)
            acc = part[:, 0]
            for k in range(1, part.shape[1]):
                acc = acc + part[:, k]
            s_sig = s_sig + acc
    return 1.0 / (1.0 + _exp_f32(-s_sig))


def junction_score(idx: dict, sctab: dict, rd, q, rdlens, posA, posB,
                   known_left, known_right) -> dict:
    """Score the best junction for each (read, diagonal-pair) lane.

    rd (C, L) codes in alignment orientation; q (C, L); rdlens (C,);
    posA/posB (C,) joined positions of the two exon diagonals
    (posB > posA); known_left/known_right: known splice sites sorted
    lexicographically by (left, right), possibly empty.

    Returns dict with per-lane:
      score   — total alignment score (mismatches + splice penalties)
      j       — junction read offset (read[0:j] on A, read[j:] on B)
      strand  — 1 '+', 2 '-', 0 none
      canon   — motif class: 2 canonical, 1 known, 0 non-canonical
      probscore, mmL, mmR
    """
    C, L = rd.shape
    dev = rd.device
    rd = rd.to(I32)
    q = q.to(I32).clamp(0, 63)
    rdlens = rdlens.to(I32)
    posA = posA.to(I32)
    posB = posB.to(I32)
    delta = posB - posA

    # windows widened to cover the splice-signal model's 9bp donor /
    # 15bp acceptor contexts on either strand (align/splice_model.py)
    winA = _rank.text_window(idx, posA, L + 16)          # text[posA + k]
    winB_ext = _rank.text_window(idx, posB - 16, L + 18)  # text[posB-16+k]
    winB = winB_ext[:, 16:16 + L]                        # at read offsets

    ar = _arange(L, dev)[None, :]
    in_read = ar < rdlens[:, None]

    def pos_scores(win, ov):
        isn = ((rd >= 4) | (win >= 4)) & in_read
        mm = (rd != win) & ~isn & in_read
        if ov is not None:   # graph mode: known alt alleles are free
            mm = mm & ~((ov == rd + 1) | (ov == 15))
        return (-torch.where(mm, _mm_pen_of(sctab, q), 0)
                - torch.where(isn, sctab["n_pen"], 0)
                + torch.where(~mm & ~isn & in_read, sctab["match_bonus"], 0))

    if "snv_packed" in idx:
        ovA = _rank.nib4_window(idx, posA, L)
        ovB = _rank.nib4_window(idx, posB, L)
    else:
        ovA = ovB = None
    sA = pos_scores(winA[:, :L], ovA)
    sB = pos_scores(winB, ovB)
    # clip-aware prefix/suffix (soft clips at the outer read ends of a
    # spliced alignment too, e.g. 1S98M200N1M):
    #   prefix[j] = max_{c5<=j} sum sA[c5:j] - SCP[c5]  (cummin trick)
    #   suffix[j] = max_{e>=j}  sum sB[j:e]  - (SCP[L]-SCP[e])
    zc = torch.zeros((C, 1), dtype=I32, device=dev)
    scp = torch.where(in_read, _sc_pen_of(sctab, q), 0)
    SCP = torch.cat([zc, torch.cumsum(scp, 1, dtype=I32)], 1)
    A = torch.cat([zc, torch.cumsum(sA, 1, dtype=I32)], 1)
    prefix = A - torch.cummin(A + SCP, dim=1).values
    SB = torch.cat([zc, torch.cumsum(sB, 1, dtype=I32)], 1)
    sufsum = SB[:, -1:] - SB                             # sum sB[j:]
    tailclip = SCP[:, -1:] - SCP
    suffix = sufsum - torch.cummin((sufsum + tailclip).flip(1),
                                   dim=1).values.flip(1)
    base = prefix + suffix                               # (C, L+1)

    jcol = _arange(L + 1, dev)[None, :]
    # splice motifs at junction j: intron = [posA+j, posB+j)
    don1 = winA[:, 0:L + 1]
    don2 = winA[:, 1:L + 2]
    acc1 = winB_ext[:, 14:L + 15]
    acc2 = winB_ext[:, 15:L + 16]
    # + strand: GT...AG;  - strand: CT...AC  (G=2,T=3,A=0,C=1)
    plus = (don1 == 2) & (don2 == 3) & (acc1 == 0) & (acc2 == 2)
    minus = (don1 == 1) & (don2 == 3) & (acc1 == 0) & (acc2 == 1)
    canonical = plus | minus

    # known splice sites: (left, right) = (posA+j-1, posB+j) — one
    # searchsorted per lane at posA, then probe the next 12 sites
    known = torch.zeros((C, L + 1), dtype=torch.bool, device=dev)
    if known_left.shape[0] > 0:
        base_l = _searchsorted(known_left, posA)
        nk = known_left.shape[0]
        for dpr in range(12):
            kk = (base_l + dpr).clamp(0, nk - 1).long()
            l_p = known_left[kk]
            r_p = known_right[kk]
            jv = l_p - posA + 1
            okp = ((l_p < posA + L) & (r_p == posB + jv)
                   & (jv >= 0) & (jv <= L))
            known |= okp[:, None] & (jcol == jv[:, None])

    ilp = _intron_len_pen(delta)[:, None]
    pen_canon = ilp + CANON_PEN
    pen_non = ilp + NONCANON_PEN

    def anchor_ok(a):
        return (jcol >= a) & (jcol <= rdlens[:, None] - a)
    cand_known = torch.where(known & anchor_ok(1), base - ilp, NEG)
    cand_canon = torch.where(canonical & anchor_ok(MIN_ANCHOR_CANON),
                             base - pen_canon, NEG)
    cand_non = torch.where(anchor_ok(MIN_ANCHOR_NONCANON), base - pen_non,
                           NEG)
    allc = torch.maximum(torch.maximum(cand_known, cand_canon), cand_non)

    best_j = torch.argmax(allc, dim=1).to(I32)
    bj = best_j[:, None].long()
    best = torch.gather(allc, 1, bj)[:, 0]
    bknown = torch.gather(known, 1, bj)[:, 0]
    bcanon = torch.gather(canonical, 1, bj)[:, 0]
    bplus = torch.gather(plus, 1, bj)[:, 0]
    # lanes with invalid deltas are dead
    ok = (delta >= 20) & (best > NEG // 2)
    strand = torch.where(bplus | (bknown & ~bcanon), 1, 2)

    # per-side mismatch counts at the chosen junction (anchor purity
    # feeds the shorter_anchor/intron-length acceptance,
    # hi_aligner.h:3753-3767)
    mmA = ((rd != winA[:, :L]) | (rd >= 4) | (winA[:, :L] >= 4)) & in_read
    mmB = ((rd != winB) | (rd >= 4) | (winB >= 4)) & in_read
    MA = torch.cat([zc, torch.cumsum(mmA.to(I32), 1, dtype=I32)], 1)
    MB = torch.cat([zc, torch.cumsum(mmB.to(I32), 1, dtype=I32)], 1)
    mmL = torch.gather(MA, 1, bj)[:, 0]
    mmR = (torch.gather(MB, 1, rdlens[:, None].long())
           - torch.gather(MB, 1, bj))[:, 0]

    # splice-signal probscore at the chosen junction (splice_model PWM;
    # '-' junctions score the reverse-complemented windows)
    md = _arange(_sm.DONOR_LEN, dev)[None, :]
    ma = _arange(_sm.ACCEPTOR_LEN, dev)[None, :]
    j1 = best_j[:, None]
    dp_idx = (j1 - 3 + md).clamp(0, L + 15).long()           # winA, +
    ap_idx = (2 + j1 + ma).clamp(0, L + 17).long()           # winB_ext, +
    dm_idx = (18 + j1 - md).clamp(0, L + 17).long()          # winB_ext, -
    am_idx = (j1 + 13 - ma).clamp(0, L + 15).long()          # winA, -
    # N bases: the reference maps base>3 -> 0 BEFORE any complement
    # (hi_aligner.h:1672 `if(base > 3) base = 0`)
    def fixn(w):
        return torch.where(w > 3, 0, w)
    dplus = fixn(torch.gather(winA, 1, dp_idx))
    aplus = fixn(torch.gather(winB_ext, 1, ap_idx))
    dmin = 3 - fixn(torch.gather(winB_ext, 1, dm_idx))
    amin = 3 - fixn(torch.gather(winA, 1, am_idx))
    use_plus = bplus[:, None]
    pscore = _probscore(torch.where(use_plus, dplus, dmin),
                        torch.where(use_plus, aplus, amin))

    return dict(
        score=torch.where(ok, best, NEG),
        j=best_j,
        strand=torch.where(ok, strand, 0).to(I32),
        canon=torch.where(bknown, 1, torch.where(bcanon, 2, 0)).to(I32),
        probscore=pscore,
        mmL=mmL.to(I32),
        mmR=mmR.to(I32),
    )


def _max_intron_len_dev(anchor, min_anchor):
    """Tensor form of splice_model.max_intron_len (hi_aligner.h:48)."""
    a = anchor.clamp_min(2)
    shift = (2 * a - 4).clamp(13, 30)
    return torch.where(anchor >= min_anchor, torch.ones_like(shift) << shift,
                       0)


def _max_intron_len_noncan_dev(anchor, min_anchor=14):
    a = anchor.clamp_min(5)
    shift = (2 * a - 10).clamp_max(30)
    return torch.where(anchor >= min_anchor, torch.ones_like(shift) << shift,
                       0)


def _probscore_thresh_dev(il):
    """Tensor form of splice_model.probscore_thresh (hi_aligner.h:3778-
    3784), including the 0.99 tier for introns >= 2^16."""
    t = torch.full(il.shape, 0.8, dtype=torch.float32, device=il.device)
    for sh, v in ((12, 0.88), (13, 0.91), (14, 0.94), (15, 0.97),
                  (16, 0.99)):
        t = torch.where(il >> sh != 0, v, t)
    return t


def _min_sc(minsc_i, minsc_s, lens):
    dev = lens.device
    return torch.ceil(_f32(minsc_i, dev)
                      + _f32(minsc_s, dev) * lens.to(torch.float32)).to(I32)


def _gate_pack(r, rdlens, posA, posB, minsc_i, minsc_s, max_intron,
               dta: bool):
    """Acceptance gates (hi_aligner.h:3753-3786) on a junction_score
    result dict -> (C, 3) int16 pack [score, j, flags], flags =
    strand | canon<<2 | accept<<4 | partial<<5."""
    score, j, strand, canon = r["score"], r["j"], r["strand"], r["canon"]
    rdlens = rdlens.to(I32)
    delta = posB.to(I32) - posA.to(I32)
    min_sc = _min_sc(minsc_i, minsc_s, rdlens)
    alive = strand != 0
    below = score < min_sc
    part = alive & below & (canon != 0) & (score > NEG // 2)
    aL = j - 2 * r["mmL"]
    aR = rdlens - j - 2 * r["mmR"]
    shorter = torch.minimum(aL, aR).clamp_min(1)
    lim_c = _max_intron_len_dev(shorter, MIN_ANCHOR_CANON)
    lim_n = _max_intron_len_noncan_dev(shorter)
    ok = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    is_can = canon == 2
    gate_c = lim_c < max_intron
    ok &= ~(is_can & gate_c & (delta > lim_c))
    ok &= ~(is_can & gate_c
            & (r["probscore"] < _probscore_thresh_dev(delta)))
    is_non = canon == 0
    ok &= ~(is_non & (lim_n < max_intron) & (delta > lim_n))
    if dta:
        anchor = torch.minimum(j, rdlens - j)
        ok &= ~(is_can & (anchor < 14))
    accept = alive & ~below & ok
    flags = (strand | (canon << 2) | (accept.to(I32) << 4)
             | (part.to(I32) << 5))
    return torch.stack([score.clamp(-32768, 32767), j, flags],
                       dim=1).to(torch.int16)


def _gather_oriented(seqs2, quals2, lens2, rows, lfw):
    """Per-lane alignment-orientation reads by row gather from the
    device-resident oriented batch (pipeline._with_revcomp layout: rows
    [0:B) forward, [B:2B) reverse-complement, tails padded with 4)."""
    B = seqs2.shape[0] // 2
    rows = rows.long()
    rowidx = rows + torch.where(lfw.to(torch.bool), 0, B)
    rd = seqs2[rowidx]
    q = quals2[rowidx].clamp(0, 63)
    return rd, q, lens2[rows]


def _shifted_segments(rd, q, start, seglen):
    """Residual read segments [start, start+seglen) shifted to offset 0,
    N (4) / quality 0 past their end."""
    C, L = rd.shape
    dbl = torch.cat([rd, torch.full_like(rd, 4)], 1)
    dblq = torch.cat([q, torch.zeros_like(q)], 1)
    rd2 = _rank._shift_words(dbl, start.to(I32), L)
    q2 = _rank._shift_words(dblq, start.to(I32), L)
    inseg = _arange(L, rd.device)[None, :] < seglen[:, None]
    return torch.where(inseg, rd2, 4), torch.where(inseg, q2, 0)


def junction_score_packed_rows(idx: dict, sctab: dict, seqs2, quals2,
                               lens2, rows, lfw, jstart, seglen,
                               posA, posB, known_left, known_right):
    """Second-pass junction scoring over residual read segments
    [jstart, jstart+seglen), gathered and shifted on the device. Returns
    (C, 7) int32 [score, j, strand, canon, probscore bits, mmL, mmR]."""
    rd, q, _rl = _gather_oriented(seqs2, quals2, lens2, rows, lfw)
    seglen = seglen.to(I32)
    rd2, q2 = _shifted_segments(rd, q, jstart, seglen)
    r = junction_score(idx, sctab, rd2, q2, seglen, posA, posB,
                       known_left, known_right)
    return torch.stack(
        [r["score"], r["j"], r["strand"], r["canon"],
         r["probscore"].view(I32), r["mmL"], r["mmR"]], dim=1)


def _scan_lanes(idx, sctab, seqs2, quals2, lens2, row2, fw2, pos2, down2,
                valid2, min_intron, NC, tiles, known_left, known_right,
                minsc_i, minsc_s, max_intron, dta, W=65536):
    """Anchor-scan rows -> scored and gated scan-hit lanes (shared tail of
    rescue_fused and spliced_stage): (pack (S*NC, 3) int16, rows, pA, pB,
    fw (S*NC,), ok (S*NC,) bool)."""
    rd2, _q2, rl2 = _gather_oriented(seqs2, quals2, lens2, row2, fw2)
    scan = anchor_scan(idx, rd2, rl2, pos2, down2, min_intron, W=W, NC=NC,
                       tiles=tiles, live=valid2)             # (S, NC, 2)
    mate = scan[:, :, 0]
    ok = (scan[:, :, 1] > 0) & valid2[:, None]
    # lane set from scan hits: down rows -> (pos, mate), up -> (mate, pos)
    pA2 = torch.where(down2[:, None], pos2[:, None], mate)
    pB2 = torch.where(down2[:, None], mate, pos2[:, None])
    rowsl = row2.repeat_interleave(NC)
    fwl = fw2.repeat_interleave(NC)
    pAl = pA2.reshape(-1)
    okl = ok.reshape(-1)
    # dead lanes get pB = pA (delta 0 -> gated off in junction_score)
    pBl = torch.where(okl, pB2.reshape(-1), pAl)
    r2d, q2g, rl2g = _gather_oriented(seqs2, quals2, lens2, rowsl, fwl)
    r2 = junction_score(idx, sctab, r2d, q2g, rl2g, pAl, pBl,
                        known_left, known_right)
    pack2 = _gate_pack(r2, rl2g, pAl, pBl, minsc_i, minsc_s, max_intron,
                       dta)
    return pack2, rowsl, pAl, pBl, fwl, okl


def rescue_fused(idx: dict, sctab: dict, seqs2, quals2, lens2,
                 rows, lfw, posA, posB,            # seeded lanes (PB,)
                 srow, sfw, spos, slive,           # scan rows (SBk,)
                 known_left, known_right, minsc_i, minsc_s,
                 max_intron, min_intron, margin, AB: int,
                 dta: bool = False, W: int = 65536, NC: int = 4,
                 tiles: int = 1):
    """One-call splice rescue: score and gate the seeded diagonal-pair
    lanes, then run the anchor scan only for scan rows whose seeded
    lanes left score on the table (compacted to AB rows), score and gate
    the scan-hit lanes:

      pack1 (PB, 3) int16   — seeded-lane [score, j, flags]
      pack2 (2*AB*NC, 3)    — scan-lane   [score, j, flags]
      desc2 (2*AB*NC, 4) i32 — scan-lane (row, posA, posB, fw)
    """
    r1d, q1, rl1 = _gather_oriented(seqs2, quals2, lens2, rows, lfw)
    r1 = junction_score(idx, sctab, r1d, q1, rl1, posA, posB,
                        known_left, known_right)
    pack1 = _gate_pack(r1, rl1, posA, posB, minsc_i, minsc_s, max_intron,
                       dta)
    # per-read best accepted seeded-lane score (scatter-max over B): the
    # scan pool keeps rows whose seeded junctions left score on the table
    B = seqs2.shape[0] // 2
    acc1 = (pack1[:, 2].to(I32) >> 4) & 1
    sc1 = torch.where(acc1 == 1, pack1[:, 0].to(I32), NEG)
    row_jbest = _scatter_max(B, rows, sc1, NEG)
    perfect = sctab["match_bonus"] * lens2[:B].to(I32)
    srl = srow.long()
    need = slive & (row_jbest[srl] < perfect[srl] - margin)
    # compact scan rows to AB slots (ascending srow order)
    nv, sel = _topk01(need, AB)
    sel = sel.clamp(0, srow.shape[0] - 1)
    avalid = nv > 0
    dev = seqs2.device
    row2 = srow[sel].repeat(2)
    fw2 = sfw[sel].repeat(2)
    pos2 = spos[sel].repeat(2)
    down2 = torch.cat([torch.ones(AB, dtype=torch.bool, device=dev),
                       torch.zeros(AB, dtype=torch.bool, device=dev)])
    valid2 = avalid.repeat(2)
    pack2, rowsl, pAl, pBl, fwl, okl = _scan_lanes(
        idx, sctab, seqs2, quals2, lens2, row2, fw2, pos2, down2, valid2,
        min_intron, NC, tiles, known_left, known_right, minsc_i, minsc_s,
        max_intron, dta, W=W)
    # kill lanes that weren't real scan hits
    pack2[:, 2] = torch.where(okl, pack2[:, 2], 0)
    desc2 = torch.stack([rowsl.to(I32), pAl, pBl, fwl.to(I32)], dim=1)
    return pack1, pack2, desc2


def _lane_enum(mrows, lens_rows, kleft, kright, krs, klr,
               min_intron, max_intron, PJ: int):
    """Device mirror of pipeline._junction_lanes: per compacted trigger
    row, enumerate known-site-implied diagonal pairs (8 rank variants per
    grid candidate) + same-orientation candidate-pair diagonals from the
    (TB, K2, 3) merged grid, dedup (pa, pb, fw) keeping the lowest rank,
    and keep the PJ lowest-rank lanes per row.

    Returns (pa, pb, fa, ok) each (TB, PJ)."""
    TB, K2, _ = mrows.shape
    dev = mrows.device
    sc = mrows[:, :, 0]
    pos = mrows[:, :, 1]
    fwv = (mrows[:, :, 2] & 1) == 1
    live = sc > NEG // 2
    # first-occurrence dedup of (pos, fw) per row, in column order
    samep = ((pos[:, :, None] == pos[:, None, :])
             & (fwv[:, :, None] == fwv[:, None, :]))
    earlier = torch.tril(torch.ones((K2, K2), dtype=torch.bool, device=dev),
                         -1)
    live = live & ~(samep & earlier[None]).any(dim=2)

    BIGP = 0x7FFFFFFF
    BIGR = 1 << 24
    pas, pbs, fas, rks = [], [], [], []

    def add(pa, pb, fa, ok, rank):
        pas.append(torch.where(ok, pa, BIGP))
        pbs.append(torch.where(ok, pb, BIGP))
        fas.append(fa & ok)
        rks.append(torch.where(ok, rank, BIGR))

    if kleft.shape[0] > 0:
        nk = kleft.shape[0]
        rlen = lens_rows[:, None].to(I32)
        lo = _searchsorted(kleft, pos)
        hi = _searchsorted(kleft, pos + rlen - 1)
        lo2 = _searchsorted(krs, pos)
        hi2 = _searchsorted(krs, pos + rlen)
        cidx = _arange(K2, dev)[None, :]
        for s in range(4):
            # upstream anchor: known left site inside [pa, pa+rl-1)
            ok = live & (lo + s < hi)
            si = (lo + s).clamp_max(nk - 1).long()
            pb = kright[si] - (kleft[si] - pos + 1)
            ok &= pb > pos
            add(pos, pb, fwv, ok, cidx * 8 + s)
            # downstream anchor: known right site inside [pa, pa+rl)
            ok = live & (lo2 + s < hi2)
            si = (lo2 + s).clamp_max(nk - 1).long()
            intron = krs[si] - klr[si] - 1
            pa2 = pos - intron
            ok &= pa2 < pos
            add(pa2, pos, fwv, ok, cidx * 8 + 4 + s)
    # candidate-pair diagonals (same orientation, intron-range delta)
    d = pos[:, None, :] - pos[:, :, None]               # pb - pa
    okcc = (live[:, :, None] & live[:, None, :]
            & (fwv[:, :, None] == fwv[:, None, :])
            & (d >= min_intron) & (d <= max_intron))
    ci = _arange(K2, dev)
    rankcc = 8 * K2 + ci[:, None] * K2 + ci[None, :]
    add(pos[:, :, None].expand(TB, K2, K2).reshape(TB, -1),
        pos[:, None, :].expand(TB, K2, K2).reshape(TB, -1),
        fwv[:, :, None].expand(TB, K2, K2).reshape(TB, -1),
        okcc.reshape(TB, -1),
        rankcc[None].expand(TB, K2, K2).reshape(TB, -1))

    PA = torch.cat(pas, 1)
    PB = torch.cat(pbs, 1)
    FA = torch.cat(fas, 1).to(I32)
    RK = torch.cat(rks, 1)
    # dedup (pa, pb, fa) keeping the lowest rank: lexicographic sort by
    # (pa, pb, fa, rank) as stable sorts from the last key to the first,
    # then mark non-first members of each group dead
    order = torch.arange(PA.shape[1], device=dev).expand(TB, -1)
    for key in (RK, FA, PB, PA):
        k = torch.gather(key, 1, order)
        order = torch.gather(order, 1,
                             torch.sort(k, dim=1, stable=True).indices)
    spa, spb, sfa, srk = (torch.gather(a, 1, order) for a in (PA, PB, FA, RK))
    dup = torch.cat(
        [torch.zeros((TB, 1), dtype=torch.bool, device=dev),
         (spa[:, 1:] == spa[:, :-1]) & (spb[:, 1:] == spb[:, :-1])
         & (sfa[:, 1:] == sfa[:, :-1])], 1)
    srk = torch.where(dup, BIGR, srk)
    # PJ lowest-rank lanes per row, carrying the descriptors (ranks of
    # live lanes are distinct, so the order of ties does not matter)
    o2 = torch.sort(srk, dim=1, stable=True).indices[:, :PJ]
    fr = torch.gather(srk, 1, o2)
    pa = torch.gather(spa, 1, o2)
    pb = torch.gather(spb, 1, o2)
    fa = torch.gather(sfa, 1, o2) > 0
    return pa, pb, fa, fr < BIGR


def spliced_stage(idx: dict, sctab: dict, merged, st, need_base, nNs,
                  B: int, kleft, kright, krs, klr, minsc_i, minsc_s,
                  nceil_i, nceil_s, margin, min_intron, max_intron,
                  TB: int, PJ: int, AB: int, NC: int, NL: int,
                  dta: bool, tiles: int = 1):
    """Splice pass 1 inside the main device step: trigger mirror of the
    host rescue mask, TB-row compaction, lane enumeration (_lane_enum),
    junction scoring + acceptance gates, compacted anchor scan for rows
    whose seeded junctions left score on the table, and compaction of
    accepted/partial lanes to an NL-lane result:

      sp32 (NL, 2) int32: [posA, posB]
      sp16 (NL, 5) int16: [row, fw, score, j, flags]
      need    (B,) bool — updated slow-row prediction
      cov     (B,) int8 — coverage bits: 1 = device trigger mirror,
              2 = triggered but dropped by a bucket (TB/AB overflow) —
              the host re-runs its legacy rescue for those rows only
      nsel    () int32 — accepted/partial lanes before the NL cap
      sp32b, sp16b, nsel2 — pass-2 chain lanes (see below)

    flags == 0 marks padding. Novel-site publication and the known-site
    second pass stay on the host (align/emit.py)."""
    dev = merged.device
    lens_b = st["lens2"][:B].to(I32)
    best = merged[:, 0, 0]
    p0 = merged[:, 0, 1]
    perfect = sctab["match_bonus"] * lens_b
    min_sc = _min_sc(minsc_i, minsc_s, lens_b)
    lf = lens_b.to(torch.float32)
    filt = (lens_b == 0) | (nNs.to(torch.float32)
                            > _f32(nceil_i, dev) + _f32(nceil_s, dev) * lf)
    aligned = (best >= min_sc) & ~filt
    if kleft.shape[0] > 0:
        kspan = ((_searchsorted(kleft, p0 + lens_b - 1)
                  > _searchsorted(kleft, p0 + 1))
                 | (_searchsorted(krs, p0 + lens_b - 1)
                    > _searchsorted(krs, p0 + 1)))
    else:
        kspan = torch.zeros(best.shape, dtype=torch.bool, device=dev)
    emit_trig = aligned & ((best < perfect - margin) | kspan)
    slow = need_base | emit_trig | ~aligned
    allowed = slow & ~filt
    trig = allowed & ((best < perfect) | kspan)
    # TB compaction ranks triggered rows by their best contiguous score:
    # junction reads sit a few penalties under perfect while hopeless
    # rows sit far below, so an overflow falls on the hopeless tail
    tkey = torch.where(trig, best - NEG, 0)
    tv, trows = _sorted_desc(tkey, TB)
    trows = trows.clamp(0, B - 1)
    tvalid = tv > 0
    mrows = merged[trows]
    pa, pb, fa, lok = _lane_enum(mrows, lens_b[trows], kleft, kright,
                                 krs, klr, min_intron, max_intron, PJ)
    lok &= tvalid[:, None]
    # compact real lanes to LB slots before scoring; rows whose lanes
    # overflow LB re-run on the host legacy path
    LB = 6 * TB
    rows_f = trows.repeat_interleave(PJ)
    okf = lok.reshape(-1)
    lvc, lic = _topk01(okf, LB)
    lic = lic.clamp(0, okf.shape[0] - 1)
    okl = lvc > 0
    rowsl = rows_f[lic]
    pal = torch.where(okl, pa.reshape(-1)[lic], 0)
    pbl = torch.where(okl, pb.reshape(-1)[lic], 0)
    fal = fa.reshape(-1)[lic]
    pbl = torch.where(okl, pbl, pal)    # dead lanes: delta 0 -> gated off
    lrank = torch.cumsum(okf.to(I32), 0, dtype=I32) - 1
    lane_lost = _scatter_any(B, rows_f, okf & (lrank >= LB))
    seqs2, quals2, lens2 = st["seqs2"], st["quals2"], st["lens2"]
    rd1, q1, rl1 = _gather_oriented(seqs2, quals2, lens2, rowsl, fal)
    r1 = junction_score(idx, sctab, rd1, q1, rl1, pal, pbl, kleft, kright)
    pack1 = _gate_pack(r1, rl1, pal, pbl, minsc_i, minsc_s, max_intron,
                       dta)
    pack1[:, 2] = torch.where(okl, pack1[:, 2], 0)

    # anchor scan for rows whose best accepted seeded junction still
    # leaves score on the table (same pool rule as rescue_fused)
    acc1 = (pack1[:, 2].to(I32) >> 4) & 1
    sc1 = torch.where(acc1 == 1, pack1[:, 0].to(I32), NEG)
    row_jbest = _scatter_max(B, rowsl, sc1, NEG)
    live0 = (mrows[:, 0, 0] > NEG // 2) & tvalid
    sneed = live0 & (row_jbest[trows] < (perfect - margin)[trows])
    nv, sels = _topk01(sneed, AB)
    sels = sels.clamp(0, TB - 1)
    arow = trows[sels]
    afw = (mrows[sels, 0, 2] & 1) == 1
    apos = mrows[sels, 0, 1]
    avalid = nv > 0
    down2 = torch.cat([torch.ones(AB, dtype=torch.bool, device=dev),
                       torch.zeros(AB, dtype=torch.bool, device=dev)])
    pack2, rows2l, pA2l, pB2l, fw2l, sokl = _scan_lanes(
        idx, sctab, seqs2, quals2, lens2, arow.repeat(2), afw.repeat(2),
        apos.repeat(2), down2, avalid.repeat(2), min_intron, NC, tiles,
        kleft, kright, minsc_i, minsc_s, max_intron, dta)
    # scan lanes: only fully-accepted junctions count (no partials —
    # their far diagonal is an 8-mer guess). Bit 6 tags them: rows that
    # fall out of device coverage keep their scan lanes (the host cleanup
    # rescue re-enumerates seeded lanes but has no anchor scan).
    fl2 = pack2[:, 2].to(I32)
    fl2 = torch.where(sokl & (((fl2 >> 4) & 1) == 1),
                      (fl2 & ~0x20) | 0x40, 0)
    pack2[:, 2] = fl2.to(torch.int16)

    # compact accepted/partial lanes to NL (lane order preserved: seeded
    # row-major first, scan lanes after)
    all_row = torch.cat([rowsl, rows2l])
    all_pa = torch.cat([pal, pA2l])
    all_pb = torch.cat([pbl, pB2l])
    all_fa = torch.cat([fal, fw2l])
    all_pack = torch.cat([pack1, pack2]).to(I32)
    sel_mask = (all_pack[:, 2] >> 4) & 3 != 0
    lv, li = _topk01(sel_mask, NL)
    li = li.clamp(0, all_row.shape[0] - 1)
    l_fl = torch.where(lv > 0, all_pack[li, 2], 0)
    sp32 = torch.stack([all_pa[li], all_pb[li]], dim=1)
    sp16 = torch.stack(
        [all_row[li].to(I32), all_fa[li].to(I32), all_pack[li, 0],
         all_pack[li, 1], l_fl], dim=1).to(torch.int16)
    # ---- fused pass 2: chain a second junction on either side of each
    # row's best accepted lane (device mirror of
    # pipeline._splice_second_pass's enumeration + junction gates; the
    # reference recurses, spliced_aligner.h:331). Chain scoring and
    # attachment stay on the host (_score_segs_rows).
    NLn = sp16.shape[0]
    idxv = _arange(NLn, dev)
    l_row = all_row[li].clamp(0, B - 1)
    l_pa = all_pa[li]
    l_pb = all_pb[li]
    l_fa = all_fa[li]
    l_sc = all_pack[li, 0]
    l_j = all_pack[li, 1]
    l_valid = l_fl != 0
    l_acc = ((l_fl >> 4) & 1) == 1
    l_part = ((l_fl >> 5) & 1) == 1
    l_canon = (l_fl >> 2) & 3
    l_strand = l_fl & 3
    l_rl = lens_b[l_row]
    # winner lane per row: max (score, canon==1) then earliest lane
    wkey = torch.where(l_valid & l_acc,
                       ((l_sc + 32768) << 1) | (l_canon == 1).to(I32), -1)
    row_w = _scatter_max(B, l_row, wkey, -1)
    is_w = l_valid & l_acc & (wkey >= 0) & (wkey == row_w[l_row])
    wfirst = _scatter_max(B, l_row, torch.where(is_w, NLn - idxv, -1), -1)
    is_w &= (NLn - idxv) == wfirst[l_row]
    # winner keeps pass-2 eligibility below perfect-margin, or when a
    # known left site falls in either residual diagonal's span
    w_sc = _scatter_max(B, l_row, torch.where(is_w, l_sc, NEG), NEG)
    keep_w = w_sc < (perfect - margin)
    if kleft.shape[0] > 0:
        kres = ((_searchsorted(kleft, l_pa + l_rl)
                 > _searchsorted(kleft, l_pa))
                | (_searchsorted(kleft, l_pb + l_rl)
                   > _searchsorted(kleft, l_pb)))
        keep_w = keep_w | (_scatter_any(B, l_row, is_w & kres)
                           & (w_sc < perfect))
    # top-2 partial lanes per row (best 2 by (score, earliest))
    pkey = torch.where(l_valid & l_part,
                       ((l_sc + 32768) << 14) | (NLn - 1 - idxv), -1)
    p1 = _scatter_max(B, l_row, pkey, -1)
    is_p1 = (pkey >= 0) & (pkey == p1[l_row])
    pkey2 = torch.where(is_p1, -1, pkey)
    p2m = _scatter_max(B, l_row, pkey2, -1)
    is_p2 = (pkey2 >= 0) & (pkey2 == p2m[l_row])
    base_ok = (is_w & keep_w[l_row]) | is_p1 | is_p2
    # enumerate (base lane x live merged diagonal) chain candidates
    mrows2 = merged[l_row]                       # (NL, K2, 3)
    pd_g = mrows2[:, :, 1]
    fd_g = (mrows2[:, :, 2] & 1) == 1
    live_g = mrows2[:, :, 0] > NEG // 2
    dL = l_pa[:, None] - pd_g
    dR = pd_g - l_pb[:, None]
    sameo = live_g & (fd_g == l_fa[:, None]) & base_ok[:, None]
    okL_g = (sameo & (dL >= min_intron) & (dL <= max_intron)
             & (l_j >= 2)[:, None])
    okR_g = (sameo & ~okL_g & (dR >= min_intron) & (dR <= max_intron)
             & (l_j <= l_rl - 2)[:, None])
    ok_g = okL_g | okR_g
    K2g = pd_g.shape[1]
    L2B = min(2 * TB, NLn * K2g)
    okf2 = ok_g.reshape(-1)
    lv2, li2 = _topk01(okf2, L2B)
    li2 = li2.clamp(0, okf2.shape[0] - 1)
    ok2v = lv2 > 0
    c_base = (li2 // K2g).clamp(0, NLn - 1)
    c_isL = okL_g.reshape(-1)[li2]
    c_pd = pd_g.reshape(-1)[li2]
    c_row = l_row[c_base]
    c_fa = l_fa[c_base]
    c_j = l_j[c_base]
    c_rl = l_rl[c_base]
    c_start = torch.where(c_isL, 0, c_j)
    c_seglen = torch.where(c_isL, c_j, c_rl - c_j)
    c_pA = torch.where(ok2v, torch.where(c_isL, c_pd, l_pb[c_base] + c_j),
                       0)
    c_pB = torch.where(ok2v, torch.where(c_isL, l_pa[c_base], c_pd + c_j),
                       c_pA)
    lrank2 = torch.cumsum(okf2.to(I32), 0, dtype=I32) - 1
    lane_lost2 = _scatter_any(B, l_row.repeat_interleave(K2g),
                              okf2 & (lrank2 >= L2B))
    # residual-segment junction scoring (shift-by-start, mask seglen)
    rdc, qc, _rlc = _gather_oriented(seqs2, quals2, lens2, c_row, c_fa)
    rd2s, q2s = _shifted_segments(rdc, qc, c_start, c_seglen)
    r2p = junction_score(idx, sctab, rd2s, q2s, c_seglen.to(I32),
                         c_pA.to(I32), c_pB.to(I32), kleft, kright)
    # host pass-2 gates (pipeline._splice_second_pass okv)
    j2c = r2p["j"]
    ok2 = ok2v & (r2p["strand"] != 0) & (r2p["score"] > NEG // 2)
    ok2 &= r2p["strand"] == l_strand[c_base]
    ok2 &= (j2c > 0) & (j2c < c_seglen)
    delta2 = c_pB - c_pA
    shorter2 = torch.minimum(j2c, c_seglen - j2c).clamp_min(1)
    lim_c2 = _max_intron_len_dev(shorter2, MIN_ANCHOR_CANON)
    lim_n2 = _max_intron_len_noncan_dev(shorter2)
    is_can2 = r2p["canon"] == 2
    gate_c2 = lim_c2 < max_intron
    ok2 &= ~(is_can2 & gate_c2 & (delta2 > lim_c2))
    ok2 &= ~(is_can2 & gate_c2
             & (r2p["probscore"] < _probscore_thresh_dev(delta2)))
    is_non2 = r2p["canon"] == 0
    ok2 &= ~(is_non2 & (lim_n2 < max_intron) & (delta2 > lim_n2))
    # ship gated chain lanes (chain scoring + comparison on the host)
    L2S = min(max(256, TB // 4), L2B)
    sv2, si2 = _topk01(ok2, L2S)
    si2 = si2.clamp(0, ok2.shape[0] - 1)
    live_s = sv2 > 0
    fl2s = (r2p["strand"][si2] | (r2p["canon"][si2] << 2)
            | (c_isL[si2].to(I32) << 4) | (1 << 5))
    sp32b = torch.stack([c_pA[si2], c_pB[si2]], dim=1)
    sp16b = torch.stack(
        [c_row[si2].to(I32), c_base[si2].to(I32), j2c[si2],
         r2p["score"][si2].clamp(-32768, 32767),
         torch.where(live_s, fl2s, 0)], dim=1).to(torch.int16)
    srank2 = torch.cumsum(ok2.to(I32), 0, dtype=I32) - 1
    lane_lost2 = lane_lost2 | _scatter_any(B, c_row, ok2 & (srank2 >= L2S))
    nsel2 = ok2.sum(dtype=I32)

    # grid shipping: rows with any accepted/partial lane (second pass +
    # ladder) join the slow pool; so do all host-slow rows
    has_lane = _scatter_any(B, all_row, sel_mask)
    need = slow | has_lane
    # coverage report: TB-overflow rows (trigger rank >= TB) re-run on
    # the host legacy path. Scan-pool overflow past AB is dropped as the
    # legacy path's own AB compaction drops it.
    in_tb = _scatter_any(B, trows, tvalid)
    uncov = (trig & ~in_tb) | lane_lost | lane_lost2
    nsel = sel_mask.sum(dtype=I32)
    cov = trig.to(torch.int8) | (uncov.to(torch.int8) << 1)
    return sp32, sp16, need, cov, nsel, sp32b, sp16b, nsel2


_ROW_CHUNK = 1024      # anchor-scan rows per pass (bounds the temporaries)


def anchor_scan(idx: dict, rd, rdlens, pos, down, min_intron,
                W: int = 65536, A: int = 8, NC: int = 4, tiles: int = 1,
                live=None):
    """Find candidate far-exon diagonals for a novel junction whose far
    anchor was too short to seed — the batched equivalent of the
    reference's localGFMSearch over the neighboring LocalGFMs
    (hi_aligner.h:6751, `_minK_local = 8` at hi_aligner.h:3979-3985):
    exact-match the read's far-end A-mer anchor against the
    intron-reachable window next to a seeded exon diagonal, by
    bit-parallel compare over the 2-bit packed text (16 sub-word shifts
    per 32-bit word — no per-position gather).

    rd (S, L) codes in alignment orientation; rdlens (S,); pos (S,)
    seeded diagonal; down (S,) bool — True: the seeded exon is upstream,
    the anchor is the read's last A bases and matches give posB-diagonal
    candidates; False: seeded exon downstream, anchor is the first A
    bases, matches give posA diagonals.

    `tiles` consecutive W-char windows extend the reach to tiles*W;
    candidates merge across tiles nearest-first. The deeper tiles apply
    when some row found nothing in tile 0 (the JAX version's lax.cond).
    The scan itself is the core between a shared prelude (anchor codes,
    has_n) and a shared tail (mate diagonals, guards):
    anchor_scan_plain_core for a CPU tensor, the CUDA kernel
    (ops/anchor_cuda.anchor_scan_core) for a CUDA tensor.

    Returns (S, NC, 2) int32: [mate diagonal, valid].
    """
    dev = rd.device
    rdlens = rdlens.to(I32)
    pos = pos.to(I32)
    mi = torch.as_tensor(min_intron, dtype=I32, device=dev)
    acode, has_n = anchor_codes(rd, rdlens, down, A)
    core = (anchor_scan_plain_core if dev.type == "cpu"
            else _anchor_cuda.anchor_scan_core)
    kvalid, mpos = core(idx["text_rows"], pos, down, rdlens, acode, has_n,
                        live, min_intron, W=W, A=A, NC=NC, tiles=tiles)
    # mate diagonal from match position
    mate = torch.where(down[:, None], mpos - (rdlens - A)[:, None], mpos)
    # same-fragment + intron-range guards (the scorer re-gates; these
    # keep cross-chromosome garbage out of the lane set)
    fj = idx["frag_joined"]
    fr = _rank.searchsorted_right(fj, pos) - 1
    frc = fr.clamp(0, fj.shape[0] - 1).long()
    fs, fe = fj[frc], idx["frag_end"][frc]
    inb = (mpos >= fs[:, None]) & (mpos + A <= fe[:, None])
    delta = torch.where(down[:, None], mate - pos[:, None],
                        pos[:, None] - mate)
    ok = (kvalid & inb & ~has_n[:, None] & (fr >= 0)[:, None]
          & (delta >= mi))
    return torch.stack([mate, ok.to(I32)], dim=2).to(I32)


def anchor_codes(rd, rdlens, down, A: int = 8):
    """anchor_scan's prelude: (acode (S,) int64, the far-end A-mer of each
    read as a little-endian 2-bit code, matching the text's word packing;
    has_n (S,) bool, an N in it or a read shorter than A + 7)."""
    L = rd.shape[1]
    rdlens = rdlens.to(I32)
    ar = _arange(A, rd.device)
    tail_off = (rdlens - A).clamp_min(0)
    offs = torch.where(down[:, None], tail_off[:, None] + ar[None, :],
                       ar[None, :])
    ach = torch.gather(rd.to(I32), 1, offs.clamp(0, L - 1).long())  # (S, A)
    has_n = (ach >= 4).any(dim=1) | (rdlens < A + MIN_ANCHOR_CANON)
    acode = (ach.clamp(0, 3).long() * (4 ** ar.long())[None, :]).sum(dim=1)
    return acode, has_n


def anchor_scan_plain_core(rows, pos, down, rdlens, acode, has_n, live,
                           min_intron, *, W: int, A: int, NC: int,
                           tiles: int):
    """anchor_scan's core in plain PyTorch (the CPU path, and the oracle
    of the CUDA kernel): (kvalid (S, NC) bool, mpos (S, NC) int32)."""
    kv, mpos = anchor_scan_plain_keys(rows, pos, down, rdlens, acode, has_n,
                                      live, min_intron, W=W, A=A, NC=NC,
                                      tiles=tiles)
    return kv > -(1 << 29), mpos


def anchor_scan_plain_keys(rows, pos, down, rdlens, acode, has_n, live,
                           min_intron, *, W: int, A: int, NC: int,
                           tiles: int):
    """The plain core with its sort keys: (kv (S, NC) int32, mpos). A hit
    at distance d (in words, nearest first) in tile t has the key
    -(t * W/16 + d), a miss -2^30; each row keeps the NC largest, ties in
    ascending word order. With tiles > 1 the deeper tiles' lists merge
    in when some live row without an N anchor (has_n false) has no hit
    in tile 0."""
    S = pos.shape[0]
    dev = pos.device
    NW = W // 16
    mi = torch.as_tensor(min_intron, dtype=I32, device=dev)
    wi = _arange(NW, dev)[None, :]
    sh = (2 * torch.arange(16, device=dev))[None, None, :]
    nrow = NW // 16 + 2

    def scan_tile(t, pos_v, down_v, rdl_v, acode_v):
        """Per-tile top-NC over a row subset: (key (Sv, NC) nearest-
        first, mpos (Sv, NC))."""
        Sv = pos_v.shape[0]
        # window start (joined chars): DOWN matches live at
        # matchpos = posB + (rl - A), posB >= pos + min_intron + t*W;
        # UP matches at matchpos = posA >= pos - min_intron - (t+1)*W
        ws_down = pos_v + mi + rdl_v - A + t * W
        ws_up = pos_v - mi - (t + 1) * W
        ws = torch.where(down_v, ws_down, ws_up)
        wsc = ws.clamp_min(0)
        base = wsc >> 4                                      # first word
        r0 = (base >> 4).clamp(0, rows.shape[0] - 1)
        ridx2 = (r0[:, None] + _arange(nrow, dev)).clamp(
            0, rows.shape[0] - 1).long()
        wmat = rows[ridx2].reshape(Sv, nrow * 16)            # (Sv, words)
        woff = base & 15                                     # word in row0
        # align the word axis to the window start, then the 16-bit value
        # at every char offset: 16 shifts a word
        w0 = _rank._shift_words(wmat, woff, NW + 1)
        # word w with the next word's low 16 bits above it: the 16 bits at
        # char offset s < 16 (bits 2s to 2s + 15) lie inside, so one
        # shift a char gives them
        pair = w0[:, :NW] | ((w0[:, 1:NW + 1] & 0xFFFF) << 32)
        vals = (pair[:, :, None] >> sh) & 0xFFFF             # (Sv, NW, 16)
        hitm = vals == acode_v[:, None, None]
        hit_any = hitm.any(dim=2)                            # (Sv, NW)
        # sub-position: first matching shift in the word (nearest for
        # DOWN); for UP prefer the last (largest matchpos)
        h8 = hitm.to(torch.uint8)
        first_s = torch.argmax(h8, dim=2).to(I32)
        last_s = 15 - torch.argmax(h8.flip(2), dim=2).to(I32)
        sub = torch.where(down_v[:, None], first_s, last_s)
        # nearest-first key: DOWN = smallest word of the nearest tile;
        # UP = largest word of the nearest tile
        key = torch.where(hit_any,
                          torch.where(down_v[:, None], -(t * NW + wi),
                                      -(t * NW + (NW - 1 - wi))),
                          -(1 << 30))
        kv, kw = _sorted_desc(key, NC)
        kw = kw.clamp(0, NW - 1)
        # positions anchor at the word boundary 16*base (the shift
        # cascade aligns words, not chars; wsc may sit mid-word)
        mpos_t = ((base << 4)[:, None] + 16 * kw.to(I32)
                  + torch.gather(sub, 1, kw))
        return kv, mpos_t

    def scan_rows(t):
        """scan_tile over every row, _ROW_CHUNK rows at a time."""
        parts = [scan_tile(t, pos[a:a + _ROW_CHUNK], down[a:a + _ROW_CHUNK],
                           rdlens[a:a + _ROW_CHUNK],
                           acode[a:a + _ROW_CHUNK])
                 for a in range(0, S, _ROW_CHUNK)]
        if not parts:
            z = torch.zeros((0, NC), dtype=I32, device=dev)
            return z, z
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    kv, mpos = scan_rows(0)
    if tiles > 1:
        # deeper tiles (reach up to tiles*W): taken when some live row
        # without an N anchor found nothing in tile 0
        found0 = (kv[:, 0] > -(1 << 29)) | has_n
        if live is not None:
            found0 = found0 | ~live
        kvd, mpd = kv, mpos
        for t in range(1, tiles):
            k_t, m_t = scan_rows(t)
            ka = torch.cat([kvd, k_t], 1)                    # (S, 2NC)
            ma = torch.cat([mpd, m_t], 1)
            kvd, ke = _sorted_desc(ka, NC)
            mpd = torch.gather(ma, 1, ke)
        deep = ~found0.all()
        kv = torch.where(deep, kvd, kv)
        mpos = torch.where(deep, mpd, mpos)
    return kv, mpos
