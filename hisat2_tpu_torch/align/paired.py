"""Paired-end DNA alignment: concordance policy, pair selection, mate
rescue, SAM emission (PyTorch port of hisat2_tpu/align/paired.py).

Equivalent role to the reference's pe.{h,cpp} (PairedEndPolicy: FR/RF/FF
orientations, insert min/max, pe.h:43-95) and the concordant ->
discordant -> mixed fallback of AlnSinkWrap::finishRead
(aln_sink.h:1939).

Device step (one call per batch pair, on the aligner's device): both
mates run the SE core (pipeline._se_core), then the (B, K2, K2)
concordance grid picks the top KP combos per pair (_pair_grid). The
packed step (_stage_pe_packed_impl) also dedups combos, finalizes the
reported mates into an int16 pair-pack (wire-coded for the copy to the
host, ops/wire.py), predicts the slow pairs and ships their grids, and
runs the mate rescue: pairs with exactly one aligned mate get the other
mate's window DP (ops/dp_cuda.dp_score, the wide CUDA kernel on a card)
and best ungapped placement (ops/sw.ungapped_place_batch). The fused step
(_stage_pe_fused_impl) serves batches with per-base qualities.

Host: the per-pair ladder (_pair_result_one), the mate rescue's CIGAR/MD
assembly (_rescue_mates) and the SAM lines of one pair (pair_lines). With
seed_mode=False align_pairs runs each mate through the aligner's per-read
device path and forms the concordance grid on the host
(_concordant_grid).

In RNA mode (AlignerOpts.spliced) the fragment ceiling is max_intron + 2L
(_maxins_eff), align_pairs splice-rescues both mates before the ladder,
pairs with spliced candidates pair per candidate, TLEN leaves out the
introns, and pairs_to_sam applies --tmo per pair (_tmo_filter_pair). The
vectorized spliced PE path is align/paired_rna.py. The sharded genomes'
host rescue is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..io import sam as samio
from ..io.reads import ReadBatch
from ..ops import rank as _rank
from ..ops import sw as _sw
from ..ops import wire as _wire
from ..ops.dp_cuda import dp_score
from ..utils import alphabet
from ..utils import metrics as _metrics
from . import mapq as _mapq
from .pipeline import (I32, NEG_INF, Aligner, Alignment, ReadResult,
                       _dedup_alns, _merged_dict, _min_scores, _se_core,
                       _sort_desc,
                       _stage_fin_rows, _tmo_pass, _to_host_async, _topk01,
                       _unpack_reads, tmo_filter_result)


# ---------------------------------------------------------------------------
# Device step
# ---------------------------------------------------------------------------

def _pair_grid(m1, m2, l1, l2, minsc_i: float, minsc_s: float, minins: int,
               maxins: int, K2: int, KP: int, fr_mode: str, pe_geo) -> dict:
    """The (B, K2, K2) concordance grid over both mates' merged candidates
    and its top-KP combos (ties in ascending combo order, as lax.top_k).
    Returns the per-mate candidate columns, min scores and the combo
    list: pair_top (B, KP2, 3) [total, t1, t2]."""
    B = m1.shape[0]
    sc1, p1 = m1[:, :, 0], m1[:, :, 1]
    sc2, p2 = m2[:, :, 0], m2[:, :, 1]
    fw1 = (m1[:, :, 2] & 1) == 1
    fw2 = (m2[:, :, 2] & 1) == 1
    min1 = _min_scores(minsc_i, minsc_s, l1)
    min2 = _min_scores(minsc_i, minsc_s, l2)
    v1 = sc1 >= min1[:, None]
    v2 = sc2 >= min2[:, None]
    P1 = p1[:, :, None]
    P2 = p2[:, None, :]
    E1 = l1.to(I32)[:, None, None]
    E2 = l2.to(I32)[:, None, None]
    left1 = P1 <= P2
    F1g = fw1[:, :, None]
    F2g = fw2[:, None, :]
    up_fw = torch.where(left1, F1g, F2g)
    dn_fw = torch.where(left1, F2g, F1g)
    frag = torch.maximum(P2 + E2, P1 + E1) - torch.minimum(P1, P2)
    if fr_mode == "fr":
        okdir = up_fw & ~dn_fw
    elif fr_mode == "rf":
        okdir = ~up_fw & dn_fw
    else:
        okdir = F1g == F2g
    both = (frag >= minins) & (frag <= maxins) & v1[:, :, None] \
        & v2[:, None, :]
    ok = okdir & both
    # mate-extent geometry (pe.h PE_ALS classes). Dovetailed pairs (the
    # coordinate order contradicting the orientation roles) already fail
    # the direction check above; --dovetail re-admits the crossed
    # pattern, --no-contain/--no-overlap tighten the default
    e1g = P1 + E1
    e2g = P2 + E2
    up_e = torch.where(left1, e1g, e2g)
    dn_e = torch.where(left1, e2g, e1g)
    if pe_geo[0] and fr_mode in ("fr", "rf"):
        dove_dir = (~up_fw & dn_fw) if fr_mode == "fr" else (up_fw & ~dn_fw)
        ok |= dove_dir & both
    if pe_geo[1]:
        ok &= ~(dn_e <= up_e)
    if pe_geo[2]:
        ok &= ~(torch.minimum(e1g, e2g) > torch.maximum(P1, P2))
    total = torch.where(ok, sc1[:, :, None] + sc2[:, None, :], NEG_INF)
    flat = total.reshape(B, -1)
    KP2 = min(KP, flat.shape[1])
    combo = torch.arange(flat.shape[1], dtype=I32,
                         device=flat.device).expand(B, -1)
    ptop, pidx = _sort_desc(flat, combo, k=KP2)
    t1 = pidx // K2
    t2 = pidx % K2
    return dict(sc1=sc1, p1=p1, fw1=fw1, sc2=sc2, p2=p2, fw2=fw2, min1=min1,
                min2=min2, ptop=ptop, t1=t1, t2=t2, KP2=KP2,
                pair_top=torch.stack([ptop, t1, t2], dim=2))


def _take(a, col):
    """a[b, col[b]] for a (B, K) tensor and a (B,) column tensor."""
    return torch.gather(a, 1, col[:, None].long())[:, 0]


def _stage_pe_fused_impl(idx, sctab, s1, q1, l1, s2, q2, l2, minsc_i,
                         minsc_s, gap1, minins, maxins, B, max_seeds,
                         n_seeds, locs_per_seg, top_cands, min_seg_len,
                         ftab_k, K2, KP, KF, max_mm, fb_bucket, dp_bucket,
                         dp_pad, no_dp, nofw, norc, seeder, fb_seeder,
                         sc_const, fr_mode, pe_geo, VC):
    """Both mates' SE cores, the concordance grid and record finalization
    (reference worker pairing loop, hi_aligner.h:4088 pairReads, as a
    dense grid). Returns
      m1, m2      (B, K2, 3)  per-mate merged candidates [score, pos, flags]
      pair_top    (B, KP, 3)  top concordant combos [total, t1, t2]
      finp1/finp2 (B, KP, D)  finalization of each combo's mate records
      sfin1/sfin2 (B, KF, D)  per-mate SE finalization (mixed fallback)
    """
    core = (minsc_i, minsc_s, gap1, B, max_seeds, n_seeds, locs_per_seg,
            top_cands, min_seg_len, ftab_k, K2, fb_bucket, dp_bucket, dp_pad,
            no_dp, nofw, norc, seeder, fb_seeder, sc_const)
    m1, st1 = _se_core(idx, sctab, s1, q1, l1, *core, verify_cands=VC)
    m2, st2 = _se_core(idx, sctab, s2, q2, l2, *core, verify_cands=VC)
    g = _pair_grid(m1, m2, l1, l2, minsc_i, minsc_s, minins, maxins, K2, KP,
                   fr_mode, pe_geo)
    t1, t2, KP2 = g["t1"], g["t2"], g["KP2"]

    def fin(st, pos, fw, reads, n):
        return _stage_fin_rows(idx, sctab, st["seqs2"], st["quals2"],
                               st["lens2"], pos.reshape(-1), fw.reshape(-1),
                               reads, B, max_mm).reshape(B, n, -1)
    reads = torch.arange(B, dtype=I32, device=m1.device).repeat_interleave(
        KP2)
    finp1 = fin(st1, torch.gather(g["p1"], 1, t1.long()),
                torch.gather(g["fw1"], 1, t1.long()), reads, KP2)
    finp2 = fin(st2, torch.gather(g["p2"], 1, t2.long()),
                torch.gather(g["fw2"], 1, t2.long()), reads, KP2)
    # per-mate SE finalization for the mixed fallback
    KF2 = max(1, min(KF, K2))
    readsK = torch.arange(B, dtype=I32, device=m1.device).repeat_interleave(
        KF2)
    sfin1 = fin(st1, m1[:, :KF2, 1], (m1[:, :KF2, 2] & 1) == 1, readsK, KF2)
    sfin2 = fin(st2, m2[:, :KF2, 1], (m2[:, :KF2, 2] & 1) == 1, readsK, KF2)
    return m1, m2, g["pair_top"], finp1, finp2, sfin1, sfin2


# PE pack layout: int16 lanes per pair —
#   [0] n distinct valid combos  [1] best total  [2] sec total (-32768)
#   [3] reserved
#   per report k at base 4 + 23*k:
#       [0] flagk: fw1 | g1<<1 | fw2<<2 | g2<<3
#       mate1 [pos lo, pos hi, c5, c3, nmm, nmm_all, score,
#              mm x4 (col<<3|ref)] (11 lanes), mate2 same (11)
#   trailing aux lane: m1_has | m2_has<<1 (appended after the reports)
# The host recovers the report-slot count from the pack width (pepack_nr).
PEPACK_MM = 4
PEPACK_MATE = 7 + PEPACK_MM          # lanes per mate per report
PEPACK_REP = 2 * PEPACK_MATE + 1     # 23: [flagk] + mate1 + mate2
PEPACK_HDR = 4                       # nvalid, best, sec, reserved


def pepack_w(nr: int) -> int:
    """Pack width (without the trailing aux lane) for nr report slots."""
    return PEPACK_HDR + nr * PEPACK_REP


def pepack_nr(w_total: int) -> int:
    """Report slots from the total pack width (including the aux lane)."""
    return (w_total - 1 - PEPACK_HDR) // PEPACK_REP


def _stage_pe_packed_impl(idx, sctab, sw1, nw1, l1, sw2, nw2, l2, qconst,
                          minsc_i, minsc_s, gap1, minins, maxins, B, L,
                          max_seeds, n_seeds, locs_per_seg, top_cands,
                          min_seg_len, ftab_k, K2, KP, fb_bucket, dp_bucket,
                          dp_pad, no_dp, nofw, norc, seeder, fb_seeder,
                          sc_const, fr_mode, pe_geo, VC, khits, SB, RB,
                          w_resc, omit_sec, n_rep, MB, wire_nvbits):
    """Transfer-packed PE step: packed reads in, int16 pair-pack out;
    per-mate merged grids and the combo list stay on the device for the
    slow-pair gather. Constant-quality batches only.

    With SB > 0 the pairs the host fast path will reject are predicted on
    the device and their m1/m2/pair_top rows ship with the pack (extras);
    with RB > 0 the mate rescue (reference HI_Aligner::alignMate,
    hi_aligner.h:4107) runs in the same step: pairs with exactly one
    aligned mate get the missing mate's window DP and diagonal placement
    against the FR-policy window, so the host finish needs no device
    round trip. Returns (pack, m1, m2, pair_top, extras)."""
    s1, q1 = _unpack_reads(sw1, nw1, None, qconst, l1, L)
    s2, q2 = _unpack_reads(sw2, nw2, None, qconst, l2, L)
    core = (minsc_i, minsc_s, gap1, B, max_seeds, n_seeds, locs_per_seg,
            top_cands, min_seg_len, ftab_k, K2, fb_bucket, dp_bucket, dp_pad,
            no_dp, nofw, norc, seeder, fb_seeder, sc_const)
    m1, st1 = _se_core(idx, sctab, s1, q1, l1, *core, verify_cands=VC)
    m2, st2 = _se_core(idx, sctab, s2, q2, l2, *core, verify_cands=VC)
    dev = m1.device
    g = _pair_grid(m1, m2, l1, l2, minsc_i, minsc_s, minins, maxins, K2, KP,
                   fr_mode, pe_geo)
    sc1, p1, fw1, sc2, p2, fw2 = (g[k] for k in ("sc1", "p1", "fw1", "sc2",
                                                 "p2", "fw2"))
    ptop, t1, t2, KP2 = g["ptop"], g["t1"].long(), g["t2"].long(), g["KP2"]
    pair_top = g["pair_top"]
    g1 = (m1[:, :, 2] & 2) > 0
    g2 = (m2[:, :, 2] & 2) > 0

    ridx = torch.arange(B, dtype=I32, device=dev)
    # distinct-combo dedup over the KP list (device mirror of the host
    # merge of the legacy path)
    cp1 = torch.gather(p1, 1, t1)
    cp2 = torch.gather(p2, 1, t2)
    cf1 = torch.gather(fw1, 1, t1)
    cf2 = torch.gather(fw2, 1, t2)
    valid = ptop > NEG_INF // 2
    dup = [torch.zeros(B, dtype=torch.bool, device=dev)]
    for t in range(1, KP2):
        eq = ((cp1[:, :t] == cp1[:, t:t + 1])
              & (cf1[:, :t] == cf1[:, t:t + 1])
              & (cp2[:, :t] == cp2[:, t:t + 1])
              & (cf2[:, :t] == cf2[:, t:t + 1]))
        dup.append(eq.any(dim=1))
    pvalid = valid & ~torch.stack(dup, dim=1)
    nvalid = pvalid.sum(dim=1, dtype=I32)
    vrank = torch.where(pvalid, torch.cumsum(pvalid, dim=1, dtype=I32) - 1,
                        KP2 + 1)

    def rank_col(vr, k):
        # column of the k-th distinct valid combo (0 when absent)
        return torch.argmax((vr == k).to(I32), dim=1)

    best = ptop[:, 0]
    sec = torch.where(nvalid >= 2, _take(ptop, rank_col(vrank, 1)), -32768)

    NR = max(2, min(int(n_rep), KP2))
    # with MB buckets the base pack carries report slot 0 only; report 1
    # ships compacted for pairs with >= 2 distinct placements (tier 0)
    # and reports 2..NR-1 for pairs with >= 3 (tier 1), as extras
    # mrows{t}/mrep{t}
    NRB = 1 if (MB > 0 and NR > 1) else NR
    g1t = torch.gather(g1, 1, t1)                # gapped per combo
    g2t = torch.gather(g2, 1, t2)
    sc1t = torch.gather(sc1, 1, t1)
    sc2t = torch.gather(sc2, 1, t2)

    def flag4(f1, gg1, f2, gg2):
        return (f1.to(I32) | (gg1.to(I32) << 1) | (f2.to(I32) << 2)
                | (gg2.to(I32) << 3))

    rflags = []                           # per-report 4-bit flag lanes
    reps = []
    for k in range(NRB):
        selk = (torch.zeros(B, dtype=torch.int64, device=dev) if k == 0
                else rank_col(vrank, k))
        reps.append((_take(cp1, selk), _take(cf1, selk), _take(cp2, selk),
                     _take(cf2, selk), selk))
        rflags.append(flag4(reps[k][1], _take(g1t, selk), reps[k][3],
                            _take(g2t, selk)))

    def fin(st, pos, fw, reads, n):
        return _stage_fin_rows(idx, sctab, st["seqs2"], st["quals2"],
                               st["lens2"], pos, fw, reads, B,
                               PEPACK_MM).reshape(n, reads.numel() // n, -1)

    # finalize both mates of the base reports: 2*NRB*B rows
    fread = ridx.repeat(NRB)
    fin1 = fin(st1, torch.cat([r[0] for r in reps]),
               torch.cat([r[1] for r in reps]), fread, NRB)
    fin2 = fin(st2, torch.cat([r[2] for r in reps]),
               torch.cat([r[3] for r in reps]), fread, NRB)

    def mate_lanes(f, pos, score_m):
        mm = f[:, 5:5 + PEPACK_MM]
        mch = f[:, 5 + PEPACK_MM:]
        mmp = mm.clamp(0, 4095) << 3 | mch.clamp(0, 7)
        return [pos & 0xFFFF, (pos >> 16) & 0xFFFF, f[:, 0], f[:, 1],
                f[:, 3], f[:, 4], score_m.clamp(-32768, 32767)] + \
            [mmp[:, j] for j in range(PEPACK_MM)]

    cols = [nvalid, best.clamp(-32768, 32767), sec.clamp(-32768, 32767),
            torch.zeros(B, dtype=I32, device=dev)]
    for k in range(NRB):
        cols += [rflags[k]]
        cols += mate_lanes(fin1[k], reps[k][0], _take(sc1t, reps[k][4]))
        cols += mate_lanes(fin2[k], reps[k][2], _take(sc2t, reps[k][4]))
    # per-mate aligned flags route mixed pairs without a gather
    m1_has = (sc1 >= g["min1"][:, None]).any(dim=1)
    m2_has = (sc2 >= g["min2"][:, None]).any(dim=1)
    aux = m1_has.to(I32) | (m2_has.to(I32) << 1)
    pack = torch.stack(cols + [aux], dim=1).to(torch.int16)

    def containd(pos, c5, c3, lm):
        astart = pos + c5
        span = lm.to(I32) - c5 - c3
        fj = idx["frag_joined"]
        f = _rank.searchsorted_right(fj, astart) - 1
        fc = f.clamp(0, fj.shape[0] - 1).long()
        okc = (f >= 0) & (span > 0) & (astart + span <= idx["frag_end"][fc])
        return okc, fc

    def report_ok(f1, pos1, f2, pos2, rflag, lm1, lm2):
        # the host fast path's test of one report (mirror of
        # finish_pe_native): both mates inside one chromosome, ungapped,
        # at most PEPACK_MM mismatches
        ok1c, fc1 = containd(pos1, f1[:, 0], f1[:, 1], lm1)
        ok2c, fc2 = containd(pos2, f2[:, 0], f2[:, 1], lm2)
        return (ok1c & ok2c
                & (idx["frag_tidx"][fc1] == idx["frag_tidx"][fc2])
                & (((rflag >> 1) & 1) == 0) & (((rflag >> 3) & 1) == 0)
                & (f1[:, 4] <= PEPACK_MM) & (f2[:, 4] <= PEPACK_MM))

    extras = {}
    ok_bucket = {}          # report k >= NRB -> full-B fast eligibility
    # tiered multi-pair buckets: tier t carries reports k0..k1-1 for the
    # first MBt pairs with >= k0+1 distinct placements; pairs past a
    # bucket (or failing the containment mirror) fall to the slow path
    tiers = []
    if NRB < NR:
        tiers.append((NRB, NRB + 1, min(max(4 * MB, B // 4), B)))
        if NR > NRB + 1:
            tiers.append((NRB + 1, NR, min(max(MB, B // 8), B)))
    for t, (k0, k1, MBs) in enumerate(tiers):
        NB2 = k1 - k0
        multi = nvalid >= (k0 + 1)
        mv, mrs = _topk01(multi, MBs)
        mrows = mrs.clamp(0, B - 1).long()
        vrank_b = vrank[mrows]
        breps, brflags, bsc1, bsc2 = [], [], [], []
        for k in range(k0, k1):
            selk = rank_col(vrank_b, k)

            def tk(a, s=selk):
                return _take(a[mrows], s)
            bp1, bf1, bp2, bf2 = tk(cp1), tk(cf1), tk(cp2), tk(cf2)
            breps.append((bp1, bf1, bp2, bf2))
            brflags.append(flag4(bf1, tk(g1t), bf2, tk(g2t)))
            bsc1.append(tk(sc1t))
            bsc2.append(tk(sc2t))
        bread = mrows.to(I32).repeat(NB2)
        bfin1 = fin(st1, torch.cat([r[0] for r in breps]),
                    torch.cat([r[1] for r in breps]), bread, NB2)
        bfin2 = fin(st2, torch.cat([r[2] for r in breps]),
                    torch.cat([r[3] for r in breps]), bread, NB2)
        mcols = []
        l1_b, l2_b = l1[mrows], l2[mrows]
        # tier slots hold the multi rows in ascending index order, so row
        # i's slot is its rank among multi rows: a gather maps them back
        # to full-B lanes
        rank = torch.cumsum(multi.to(I32), dim=0) - 1
        in_t = multi & (rank < MBs)
        for j in range(NB2):
            mcols += [brflags[j]]
            mcols += mate_lanes(bfin1[j], breps[j][0], bsc1[j])
            mcols += mate_lanes(bfin2[j], breps[j][2], bsc2[j])
            okb = report_ok(bfin1[j], breps[j][0], bfin2[j], breps[j][2],
                            brflags[j], l1_b, l2_b) & (mv > 0)
            ok_bucket[k0 + j] = in_t & okb[rank.clamp(0, MBs - 1).long()]
        extras[f"mrows{t}"] = torch.where(mv > 0, mrs, -1)
        extras[f"mrep{t}"] = torch.stack(mcols, dim=1).to(torch.int16)

    if SB:
        # device slow-pair prediction (mirror of the host fast tests) so
        # the slow pairs' grids ship with the pack instead of a follow-up
        # gather
        nrep = nvalid.clamp(max=khits)
        fastd = (nvalid >= 1) & (nrep <= NR)
        if omit_sec:
            fastd &= nrep <= 1
        for k in range(NRB):
            okk = report_ok(fin1[k], reps[k][0], fin2[k], reps[k][2],
                            rflags[k], l1, l2)
            fastd &= (nrep <= k) | okk
        for k, full in ok_bucket.items():
            fastd &= (nrep <= k) | full
        need = ~fastd & (aux != 0)
        sv, srs = _topk01(need, min(SB, B))
        rc_ = srs.clamp(0, B - 1).long()
        extras["srows"] = torch.where(sv > 0, srs, -1)
        extras["sm1"] = m1[rc_]
        extras["sm2"] = m2[rc_]
        extras["spt"] = pair_top[rc_]

    if RB:
        # ---- mate rescue (reference alignMate window DP) ----
        resc = (nvalid == 0) & (m1_has ^ m2_has)
        anch1 = m1_has
        apos = torch.where(anch1, p1[:, 0], p2[:, 0])
        afw = torch.where(anch1, fw1[:, 0], fw2[:, 0])
        aext = torch.where(anch1, l1, l2).to(I32)
        W = w_resc
        wstart = torch.where(afw, apos, apos + aext - W)
        mate_fw = ~afw            # FR: rescued mate opposite orientation
        rl_all = torch.where(anch1, l2, l1).to(I32)
        resc &= rl_all > 0
        rv, rsel = _topk01(resc, min(RB, B))
        rows = rsel.clamp(0, B - 1).long()
        a1_l = anch1[rows]
        mf_l = mate_fw[rows]
        ws_l = wstart[rows]
        rl_l = rl_all[rows].contiguous()
        orow = torch.where(mf_l, rows, rows + B)
        rd_l = torch.where(a1_l[:, None], st2["seqs2"][orow],
                           st1["seqs2"][orow]).contiguous()
        ql_l = torch.where(a1_l[:, None], st2["quals2"][orow],
                           st1["quals2"][orow])
        win = _rank.text_window(idx, ws_l, W).contiguous()
        pen, scp_cum = _sw.dp_inputs(sctab, ql_l, rl_l)
        dsc = dp_score(rd_l, pen.contiguous(), rl_l, win,
                       scp_cum.contiguous(), **sc_const)
        ub, u0, i1, i2 = _sw.ungapped_place_batch(sctab, rd_l, ql_l, rl_l,
                                                  win)
        extras["rescue"] = torch.stack(
            [torch.where(rv > 0, rsel, -1), a1_l.to(I32), dsc, ub, u0, i1,
             i2, ws_l.to(I32), mf_l.to(I32)], dim=1)
    if wire_nvbits and NRB == 1:
        # bit-pack the copy to the host (ops/wire.py); the host restores
        # the lanes exactly
        pack = _wire.encode_lanes(pack, _wire.pe_pack_table(L, L,
                                                            wire_nvbits))
        rt = _wire.pe_rep_table(L, L)
        for t in range(len(tiers)):
            rep = extras[f"mrep{t}"]
            nb2 = rep.shape[1] // PEPACK_REP
            extras[f"mrep{t}"] = torch.cat(
                [_wire.encode_lanes(
                    rep[:, j * PEPACK_REP:(j + 1) * PEPACK_REP], rt)
                 for j in range(nb2)], dim=1)
    return pack, m1, m2, pair_top, extras


def _pe_consts(aligner: Aligner, B: int) -> dict:
    """Static arguments both PE steps share with the SE step's sizing."""
    o = aligner.opts
    return dict(B=B, max_seeds=o.max_seeds, n_seeds=o.n_seeds,
                locs_per_seg=o.locs_per_seg, top_cands=o.top_cands,
                min_seg_len=aligner.min_seg_len, ftab_k=aligner.fm.ftab_k,
                seeder=aligner.seeder, fb_seeder=aligner.fb_seeder,
                K2=min(2 * o.top_cands, max(8, o.khits + 3)),
                fb_bucket=min(B, max(32, B // 8)),
                dp_bucket=min(B, max(64, B // 8)), dp_pad=o.dp_pad,
                no_dp=o.no_dp, nofw=o.nofw, norc=o.norc,
                sc_const=aligner.sc_const, fr_mode=o.fr,
                pe_geo=(o.dovetail, o.no_contain, o.no_overlap),
                VC=o.verify_cands)


def _score_args(aligner: Aligner, L: int):
    sc = aligner.scoring
    return (float(sc.score_min.I), float(sc.score_min.S),
            min(sc.read_gap_open(), sc.ref_gap_open()), aligner.opts.minins,
            _maxins_eff(aligner.opts, L))


def stage_pe_packed(aligner: Aligner, b1: ReadBatch, b2: ReadBatch,
                    KP: int):
    """Queue the packed PE step and the copies of its results to the
    host. Returns None for batches without one shared constant quality
    (the caller takes the fused step), else (pack, m1, m2, pair_top,
    extras, ready): pack and extras are host tensors, complete once
    `ready` (a CUDA event, None on the CPU) has been waited on, with
    extras["_wire"] = (L, nvalid bits) for the wire decode; m1, m2 and
    pair_top stay on the device for the slow-pair gather. Its spans
    submit.pack, submit.step and submit.d2h feed Metrics.t_pack."""
    o = aligner.opts
    m = aligner.metrics
    B = len(b1)
    L = b1.seqs.shape[1]
    with _metrics.span("submit.pack", None, m, "t_pack"):
        sw1, nw1, quals1, qc1, l1 = b1.packed()
        sw2, nw2, quals2, qc2, l2 = b2.packed()
        if quals1 is not None or quals2 is not None or qc1 != qc2:
            return None
        dev = aligner.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
        dev_in = (up(sw1.astype(np.int64), torch.int64),
                  up(nw1.astype(np.int64), torch.int64), up(l1, I32),
                  up(sw2.astype(np.int64), torch.int64),
                  up(nw2.astype(np.int64), torch.int64), up(l2, I32), qc1)
    # wire codec parameters (ops/wire.py): nvalid bit width from the
    # combo top-k cap; both sides derive the lane table from (L, nvbits)
    K2 = min(2 * o.top_cands, max(8, o.khits + 3))
    wire_nvbits = max(4, min(KP, K2 ** 2).bit_length())
    with _metrics.span("submit.step", None, m, "t_pack"):
        pack, m1, m2, pt, extras = _stage_pe_packed_impl(
            aligner.idx, aligner.sctab, *dev_in,
            *_score_args(aligner, L), L=L, KP=KP, **_pe_consts(aligner, B),
            khits=o.khits, SB=min(B, max(64, B // 16)), RB=min(B, 512),
            w_resc=rescue_width(o, L), omit_sec=o.omit_sec_seq,
            n_rep=max(2, min(o.khits, 5)), MB=min(B, max(32, B // 16)),
            wire_nvbits=wire_nvbits)
    with _metrics.span("submit.d2h", None, m, "t_pack"):
        host, ready = _to_host_async({"pack": pack, **extras})
    pack_h = host.pop("pack")
    host["_wire"] = (L, wire_nvbits)
    m.reads += 2 * B
    m.bases += int(b1.lens.sum()) + int(b2.lens.sum())
    m.batches += 1
    return pack_h, m1, m2, pt, host, ready


def _gather_pe_slow(m1_dev, m2_dev, pt_dev, rows: np.ndarray):
    """Start the gather and host copy of the merged grids and combo lists
    of slow pairs; returns a closure that waits for them (numpy), or None
    when there are no rows."""
    if rows.size == 0:
        return None
    ix = torch.from_numpy(rows.astype(np.int64)).to(m1_dev.device)
    got, ready = _to_host_async({"g1": m1_dev[ix], "g2": m2_dev[ix],
                                 "gp": pt_dev[ix]})

    def wait():
        if ready is not None:
            ready.synchronize()
        return got["g1"].numpy(), got["g2"].numpy(), got["gp"].numpy()
    return wait


def rescue_width(o, L: int) -> int:
    """Columns of a mate-rescue window: the -X fragment ceiling (capped at
    1000) plus the padded read length. The device step, the ladder's
    rescue and the mixed-vector path's check of the step's rows all use
    it."""
    return min(o.maxins, 1000) + L


def _maxins_eff(o, L: int) -> int:
    """Effective fragment-length ceiling: in spliced mode the reference
    skips peClassifyPair and accepts properly oriented pairs whose
    inter-mate gap is within the maximum intron length
    (hi_aligner.h:6010-6040: right.off() + maxIntronLen >= left2.off());
    fragment = gap + both extents, hence + 2L. Otherwise -X."""
    return o.max_intron + 2 * L if o.spliced else o.maxins


def stage_pe_fused(aligner: Aligner, b1: ReadBatch, b2: ReadBatch,
                   KP: int, KF: int):
    """One fused PE step on the unpacked batches (any qualities); numpy
    outputs: the per-mate candidate dicts, pair_top and the
    finalizations."""
    dev = aligner.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, I32)
    out = _stage_pe_fused_impl(
        aligner.idx, aligner.sctab, up(b1.seqs), up(b1.quals), up(b1.lens),
        up(b2.seqs), up(b2.quals), up(b2.lens),
        *_score_args(aligner, int(b1.seqs.shape[1])), KP=KP, KF=KF,
        max_mm=8, **_pe_consts(aligner, len(b1)))
    m1p, m2p, pair_top, finp1, finp2, sfin1, sfin2 = (
        t.cpu().numpy() for t in out)
    return (_merged_dict(m1p), _merged_dict(m2p), pair_top, finp1, finp2,
            sfin1, sfin2)


# ---------------------------------------------------------------------------
# Host ladder
# ---------------------------------------------------------------------------

@dataclass
class PairResult:
    """Outcome for one read pair."""
    kind: str = "unal"            # 'concordant' | 'discordant' | 'mixed' | 'unal'
    aln1: Alignment | None = None
    aln2: Alignment | None = None
    best: int = NEG_INF           # summed pair score
    secbest: int | None = None
    res1: ReadResult | None = None  # per-mate fallbacks (mixed mode)
    res2: ReadResult | None = None
    # secondary concordant pairs (-k > 1): [(total, aln1, aln2), ...]
    alt_pairs: list = field(default_factory=list)


def _concordant(o1_fw, o1_pos, len1, o2_fw, o2_pos, len2,
                minins: int, maxins: int, mode: str,
                geo=(False, False, False)) -> tuple[bool, int]:
    """Check one candidate combo for concordance; returns (ok, tlen).

    mode 'fr' (default): upstream mate forward, downstream mate reverse
    (pe.h PE_POL_FR). 'rf' and 'ff' mirror the reference's other policies.
    """
    if o1_pos <= o2_pos:
        up_fw, dn_fw = o1_fw, o2_fw
        frag = max(o2_pos + len2, o1_pos + len1) - o1_pos
    else:
        up_fw, dn_fw = o2_fw, o1_fw
        frag = max(o1_pos + len1, o2_pos + len2) - o2_pos
    if mode == "fr":
        ok = up_fw and not dn_fw
    elif mode == "rf":
        ok = (not up_fw) and dn_fw
    else:  # ff
        ok = o1_fw == o2_fw
    if geo[0] and mode in ("fr", "rf"):
        # --dovetail: the crossed pattern is concordant too
        want = (not up_fw) and dn_fw if mode == "fr" else up_fw and not dn_fw
        ok = ok or want
    if geo[1] or geo[2]:
        s1e, e1e = o1_pos, o1_pos + len1
        s2e, e2e = o2_pos, o2_pos + len2
        up_e = e1e if s1e <= s2e else e2e
        dn_e = e2e if s1e <= s2e else e1e
        if geo[1] and dn_e <= up_e:
            ok = False
        if geo[2] and min(e1e, e2e) > max(s1e, s2e):
            ok = False
    return ok and minins <= frag <= maxins, frag


def _concordant_grid(m1, m2, b1, b2, o, scoring):
    """Vectorized concordance over the full (B, K, K) candidate grid of
    two host candidate dicts: the best combo and the second-best total at
    a distinct locus per pair, all NumPy. The per-pair path's grid where
    no device step made one (seed_mode=False)."""
    s1, s2 = m1["score"], m2["score"]           # (B, K)
    B, K = s1.shape
    l1 = b1.lens.astype(np.int64)
    l2 = b2.lens.astype(np.int64)
    min1 = np.ceil(scoring.score_min.I + scoring.score_min.S * l1)
    min2 = np.ceil(scoring.score_min.I + scoring.score_min.S * l2)
    v1 = s1 >= min1[:, None]
    v2 = s2 >= min2[:, None]
    p1 = m1["pos"].astype(np.int64)
    p2 = m2["pos"].astype(np.int64)
    f1, f2 = m1["fw"], m2["fw"]
    P1 = p1[:, :, None]
    P2 = p2[:, None, :]
    E1 = l1[:, None, None]
    E2 = l2[:, None, None]
    left1 = P1 <= P2
    up_fw = np.where(left1, f1[:, :, None], f2[:, None, :])
    dn_fw = np.where(left1, f2[:, None, :], f1[:, :, None])
    frag = np.maximum(P2 + E2, P1 + E1) - np.minimum(P1, P2)
    if o.fr == "fr":
        okdir = up_fw & ~dn_fw
    elif o.fr == "rf":
        okdir = ~up_fw & dn_fw
    else:
        okdir = f1[:, :, None] == f2[:, None, :]
    mxeff = _maxins_eff(o, int(b1.seqs.shape[1]))
    both = ((frag >= o.minins) & (frag <= mxeff)
            & v1[:, :, None] & v2[:, None, :])
    ok = okdir & both
    if o.dovetail and o.fr in ("fr", "rf"):
        ok |= ((~up_fw & dn_fw) if o.fr == "fr" else (up_fw & ~dn_fw)) & both
    if o.no_contain or o.no_overlap:
        e1g = P1 + E1
        e2g = P2 + E2
        up_e = np.where(left1, e1g, e2g)
        dn_e = np.where(left1, e2g, e1g)
        if o.no_contain:
            ok &= ~(dn_e <= up_e)
        if o.no_overlap:
            ok &= ~(np.minimum(e1g, e2g) > np.maximum(P1, P2))
    total = np.where(ok, s1[:, :, None] + s2[:, None, :],
                     np.int64(NEG_INF))
    flat = total.reshape(B, -1)
    bi = np.argmax(flat, axis=1)
    best = flat[np.arange(B), bi]
    has = best > NEG_INF // 2
    t1, t2 = bi // K, bi % K
    bp1 = p1[np.arange(B), t1]
    bp2 = p2[np.arange(B), t2]
    same = ((p1 == bp1[:, None])[:, :, None]
            & (p2 == bp2[:, None])[:, None, :]).reshape(B, -1)
    sec = np.where(same, np.int64(NEG_INF), flat).max(axis=1)
    return dict(has=has, t1=t1, t2=t2, total=best, sec=sec)


def _grid_from_pairtop(pair_top, m1, m2):
    """Best and second-best-distinct concordant combo from the device's
    top-KP list, plus the full top-KP combo columns for -k secondary pair
    reporting."""
    B, KP, _ = pair_top.shape
    total = pair_top[:, :, 0].astype(np.int64)
    t1 = pair_top[:, :, 1].astype(np.int64)
    t2 = pair_top[:, :, 2].astype(np.int64)
    has = total[:, 0] > NEG_INF // 2
    bp1 = m1["pos"][np.arange(B), t1[:, 0]]
    bp2 = m2["pos"][np.arange(B), t2[:, 0]]
    ap1 = np.take_along_axis(m1["pos"], t1, 1)
    ap2 = np.take_along_axis(m2["pos"], t2, 1)
    distinct = ((ap1 != bp1[:, None]) | (ap2 != bp2[:, None])) \
        & (total > NEG_INF // 2)
    distinct[:, 0] = False
    any_d = distinct.any(axis=1)
    firstd = np.argmax(distinct, axis=1)
    sec = np.where(any_d, total[np.arange(B), firstd], np.int64(NEG_INF))
    return dict(has=has, t1=t1[:, 0], t2=t2[:, 0], total=total[:, 0],
                sec=sec, t1s=t1, t2s=t2, totals=total)


def mate_fns(aligner: Aligner):
    """(mate_cands, finalize) of the ladder: each mate's candidates, the
    contiguous ones and (in RNA mode) the spliced ones, best first, with
    baked known-site junctions ahead of equal-scoring contiguous
    placements (splice_db.is_baked; runtime novel sites do not count);
    spliced candidates finalize through _finalize_spliced."""
    o = aligner.opts

    def mate_cands(m, batch, i, min_sc, rdlen):
        cs = []
        for s, p, fw, gapped, *_ in aligner._ranked_candidates(
                m, i, min_sc, limit=o.top_cands):
            cs.append(dict(score=s, pos=p, fw=fw, kind="reg", gapped=gapped,
                           extent=rdlen))
        for c in m.get("splice", {}).get(i, []):
            if c["score"] >= min_sc:
                cs.append(dict(score=c["score"], pos=c["posA"], fw=c["fw"],
                               kind="spl", c=c, extent=rdlen + c["delta"]))
        cs.sort(key=lambda x: (
            -x["score"],
            0 if (x["kind"] == "spl" and x["c"]["canon"] == 1
                  and aligner.ssdb.is_baked(
                      x["c"]["posA"] + x["c"]["j"] - 1,
                      x["c"]["posB"] + x["c"]["j"])) else 1))
        return cs[:o.top_cands]

    def finalize(batch, i, c, rdlen):
        if c["kind"] == "spl":
            return aligner._finalize_spliced(i, batch, c["c"], rdlen)
        return aligner._finalize(i, batch, c["score"], c["pos"], c["fw"],
                                 c["gapped"], rdlen)
    return mate_cands, finalize


def align_pairs(aligner: Aligner, b1: ReadBatch, b2: ReadBatch,
                premerged=None, dev_lanes=None) -> list[PairResult]:
    """The per-pair path: the fused step (or, with seed_mode=False, each
    mate's per-read device path and the host grid), in RNA mode each
    mate's splice rescue (paired_rna.rescue_pair_rna), then the ladder for
    every pair (the oracle of the fast emit paths).

    premerged: optional (m1, m2) candidate dicts already computed (the
    sharded path merges per-shard grids into global coordinates and runs
    the rest of the pairing on the host). dev_lanes: optional per-mate
    splice-lane tuples of the device steps, fed to the splice rescue."""
    o = aligner.opts
    B = len(b1)
    pair_top = None
    if premerged is not None:
        m1, m2 = premerged
    elif o.seed_mode:
        m1, m2, pair_top, _f1, _f2, _s1, _s2 = stage_pe_fused(
            aligner, b1, b2, KP=max(8, o.khits + 3), KF=1)
    else:
        st1, dp1 = aligner._device_align(b1)
        st2, dp2 = aligner._device_align(b2)
        m1 = aligner._merged_host(st1, dp1, B)
        m2 = aligner._merged_host(st2, dp2, B)
    if o.spliced:
        from .paired_rna import rescue_pair_rna
        rescue_pair_rna(aligner, b1, b2, m1, m2,
                        dev_lanes=dev_lanes or (None, None))
    mate_cands, finalize = mate_fns(aligner)

    if pair_top is not None:
        grid = _grid_from_pairtop(pair_top, m1, m2)
    else:
        grid = _concordant_grid(m1, m2, b1, b2, o, aligner.scoring)
    out: list[PairResult] = []
    rescue: list[tuple] = []
    for i in range(B):
        out.append(_pair_result_one(aligner, i, b1, b2, m1, m2, grid,
                                    mate_cands, finalize, rescue))
    if rescue:
        _rescue_mates(aligner, b1, b2, dict(enumerate(out)), rescue,
                      finalize)
    return out


def _pair_result_one(aligner, i, b1, b2, m1, m2, grid, mate_cands,
                     finalize, rescue) -> PairResult:
    """Concordant -> discordant -> mixed resolution for one pair (the
    reference's finishRead fallback ladder, aln_sink.h:1939). Appends a
    (i, mate, candidate) tuple to `rescue` when one mate anchors alone.
    A pair with spliced candidates (or no grid) skips the grid and pairs
    candidate by candidate, each with its genomic extent (read length
    plus intron span)."""
    o = aligner.opts
    l1, l2 = int(b1.lens[i]), int(b2.lens[i])
    min1 = aligner.scoring.min_score(l1)
    min2 = aligner.scoring.min_score(l2)
    has_spl = i in m1.get("splice", {}) or i in m2.get("splice", {})

    combos = []
    c1 = c2 = None
    if grid is not None and not has_spl:
        if grid["has"][i]:
            def mk(m, t, rdlen):
                return dict(score=int(m["score"][i, t]),
                            pos=int(m["pos"][i, t]),
                            fw=bool(m["fw"][i, t]), kind="reg",
                            gapped=bool(m["gapped"][i, t]), extent=rdlen)
            if "t1s" in grid:
                for k in range(grid["totals"].shape[1]):
                    tk = int(grid["totals"][i, k])
                    if tk <= NEG_INF // 2:
                        break
                    combos.append((tk, mk(m1, int(grid["t1s"][i, k]), l1),
                                   mk(m2, int(grid["t2s"][i, k]), l2)))
            else:
                # the host grid gives the best combo and the second-best
                # total only: the latter feeds MAPQ and is never finalized
                combos = [(int(grid["total"][i]),
                           mk(m1, int(grid["t1"][i]), l1),
                           mk(m2, int(grid["t2"][i]), l2))]
                if grid["sec"][i] > NEG_INF // 2:
                    combos.append((int(grid["sec"][i]), dict(pos=-1),
                                   dict(pos=-1)))
    else:
        c1 = mate_cands(m1, b1, i, min1, l1)
        c2 = mate_cands(m2, b2, i, min2, l2)
        mxeff = _maxins_eff(o, int(b1.seqs.shape[1]))
        geo = (o.dovetail, o.no_contain, o.no_overlap)
        for x1 in c1:
            for x2 in c2:
                ok, _frag = _concordant(x1["fw"], x1["pos"], x1["extent"],
                                        x2["fw"], x2["pos"], x2["extent"],
                                        o.minins, mxeff, o.fr, geo)
                if ok:
                    combos.append((x1["score"] + x2["score"], x1, x2))
        combos.sort(key=lambda x: -x[0])

    pr = PairResult()
    if combos:
        total, w1, w2 = combos[0]
        a1 = finalize(b1, i, w1, l1)
        a2 = finalize(b2, i, w2, l2)
        if a1 is not None and a2 is not None and a1.tidx == a2.tidx:
            pr.kind = "concordant"
            pr.aln1, pr.aln2 = a1, a2
            pr.best = total
            # distinct secondary concordant pairs (-k; reference reports
            # up to khits concordant combos, aln_sink.h selection)
            def place(x, b, rdlen):
                """A candidate's placement key, worked out once: a spliced
                candidate written unspliced keys by its diagonal, so it
                and the contiguous candidate there count once."""
                k = x.get("key")
                if k is None:
                    k = x["key"] = (
                        aligner._spliced_diag(i, b, x["c"], rdlen)
                        if x.get("kind") == "spl" else x["pos"])
                return k
            seen = {(place(w1, b1, l1), w1.get("fw"),
                     place(w2, b2, l2), w2.get("fw"))}
            for t, x1, x2 in combos[1:]:
                key = (place(x1, b1, l1), x1.get("fw"),
                       place(x2, b2, l2), x2.get("fw"))
                if key in seen:
                    continue
                seen.add(key)
                if pr.secbest is None:
                    pr.secbest = t
                if (len(pr.alt_pairs) + 1 < o.khits and "fw" in x1
                        and "fw" in x2):
                    s1 = finalize(b1, i, x1, l1)
                    s2 = finalize(b2, i, x2, l2)
                    if (s1 is not None and s2 is not None
                            and s1.tidx == s2.tidx):
                        pr.alt_pairs.append((t, s1, s2))
            return pr
    if c1 is None:
        c1 = mate_cands(m1, b1, i, min1, l1)
        c2 = mate_cands(m2, b2, i, min2, l2)
    # ---- discordant: both mates unique ----
    if (not o.no_discordant and len(c1) >= 1 and len(c2) >= 1
            and (len(c1) == 1 or c1[0]["score"] > c1[1]["score"])
            and (len(c2) == 1 or c2[0]["score"] > c2[1]["score"])):
        a1 = finalize(b1, i, c1[0], l1)
        a2 = finalize(b2, i, c2[0], l2)
        if a1 is not None and a2 is not None:
            pr.kind = "discordant"
            pr.aln1, pr.aln2 = a1, a2
            pr.best = c1[0]["score"] + c2[0]["score"]
            return pr
    # ---- mate rescue candidates: one mate anchored, other missing ----
    if c1 and not c2:
        rescue.append((i, 1, c1[0]))
    elif c2 and not c1:
        rescue.append((i, 2, c2[0]))
    # ---- mixed: report mates individually ----
    if not o.no_mixed:
        pr.kind = "mixed"
        pr.res1 = _mate_result(aligner, b1, i, c1, min1, l1, finalize)
        pr.res2 = _mate_result(aligner, b2, i, c2, min2, l2, finalize)
        if not pr.res1.aligned and not pr.res2.aligned:
            pr.kind = "unal"
    return pr


def _rescue_mates(aligner, b1, b2, results, rescue, finalize,
                  dev_cache=None) -> None:
    """Mate rescue (reference HI_Aligner::alignMate, hi_aligner.h:4107):
    DP the unaligned mate against the window the paired-end policy implies
    from its anchored partner; a passing score upgrades the pair to
    concordant. One batched DP (ops/dp_cuda.dp_score: the wide kernel on
    a card) and one ungapped placement over all rescue lanes, or none
    when `dev_cache` (the packed step's rescue rows) already carries each
    lane's DP score and placement. A finalization-only aligner (the
    sharded finish, Aligner.host_only) has no text on the device: its
    windows come from the host reference, the same DP kernel scores them
    on the aligner's device, and the ungapped placement runs on the host
    (_rescue_ungapped), in global coordinates."""
    o = aligner.opts
    sc = aligner.scoring
    lanes = []
    L = max(b1.seqs.shape[1], b2.seqs.shape[1])
    W = rescue_width(o, L)
    for i, anchored, ac in rescue[:512]:
        tb = b2 if anchored == 1 else b1
        rdlen = int(tb.lens[i])
        if rdlen == 0:
            continue
        # FR policy: mate opposite orientation, downstream of a fw anchor /
        # upstream of an rc anchor
        if ac["fw"]:
            wstart = ac["pos"]
            mate_fw = False
        else:
            wstart = ac["pos"] + ac["extent"] - W
            mate_fw = True
        lanes.append((i, anchored, ac, wstart, mate_fw, rdlen))
    if not lanes:
        return
    P = len(lanes)
    rd = np.full((P, L), 4, np.int64)
    q = np.full((P, L), 40, np.int64)
    rls = np.zeros(P, np.int32)
    wstarts = np.zeros(P, np.int64)
    for k, (i, anchored, ac, wstart, mate_fw, rdlen) in enumerate(lanes):
        tb = b2 if anchored == 1 else b1
        s = tb.seqs[i, :rdlen].astype(np.uint8)
        qq = np.clip(tb.quals[i, :rdlen].astype(np.int64), 0, 63)
        if not mate_fw:
            s = alphabet.revcomp(s)
            qq = qq[::-1].copy()
        rd[k, :rdlen] = s
        q[k, :rdlen] = qq
        rls[k] = rdlen
        wstarts[k] = wstart
    host_mode = not aligner.idx
    cached = None
    if dev_cache is not None and not host_mode:
        cached = []
        for (i, anchored, ac, wstart, mate_fw, rdlen) in lanes:
            ent = dev_cache.get(i)
            if (ent is None
                    or int(ent[1]) != (1 if anchored == 1 else 0)
                    or int(ent[7]) != int(wstart)
                    or bool(int(ent[8])) != mate_fw):
                cached = None        # misprediction: score on the device
                break
            cached.append(ent)
    if cached is not None:
        ce = np.asarray(cached, np.int64)
        scores = ce[:, 2]
        ub, ut0, ui1, ui2 = ce[:, 3], ce[:, 4], ce[:, 5], ce[:, 6]
    else:
        dev = aligner.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, I32)
        rd_t, q_t, rl_t = up(rd), up(q), up(rls)
        if host_mode:
            # global windows (int64 starts, past 2^31 on a human genome)
            win = up(np.stack([aligner.fm.ref.get_stretch(int(l[3]), W)
                               for l in lanes]))
        else:
            win = _rank.text_window(aligner.idx, up(wstarts), W)
        win = win.contiguous()
        pen, scp_cum = _sw.dp_inputs(aligner.sctab, q_t, rl_t)
        scores = dp_score(rd_t, pen.contiguous(), rl_t, win,
                          scp_cum.contiguous(), **aligner.sc_const
                          ).cpu().numpy()
        if not host_mode:
            ub, ut0, ui1, ui2 = (x.cpu().numpy() for x in
                                 _sw.ungapped_place_batch(
                                     aligner.sctab, rd_t, q_t, rl_t, win))

    # vectorized ungapped placement for every passing lane: most rescued
    # mates align without gaps, and where the best diagonal scores the
    # DP's optimum it is that optimum; dp_traceback only for true gaps
    passing = [k for k, (i, a, ac, ws, mf, rl) in enumerate(lanes)
               if scores[k] >= sc.min_score(rl)]
    windows = {k: aligner.fm.ref.get_stretch(int(lanes[k][3]), W)
               for k in passing}
    if host_mode:
        ung = _rescue_ungapped(sc, rd, q, rls, lanes, windows, scores,
                               passing)
    else:
        ung = {}
        for k in passing:
            if int(ub[k]) < scores[k]:
                continue                                  # gapped optimum
            t0, i1, i2 = int(ut0[k]), int(ui1[k]), int(ui2[k])
            rdlen = int(rls[k])
            cigar = []
            if i1:
                cigar.append(("S", i1))
            cigar.append(("M", i2 - i1))
            if rdlen - i2:
                cigar.append(("S", rdlen - i2))
            wl = windows[k][t0 + i1:t0 + i2].astype(np.int64)
            rl_ = rd[k, i1:i2]
            bad = (wl != rl_) | (wl >= 4) | (rl_ >= 4)
            mds = [(int(i + i1), int(t0 + i + i1))
                   for i in np.flatnonzero(bad)]
            ung[k] = (int(ub[k]), t0 + i1, cigar, mds)

    for k, (i, anchored, ac, wstart, mate_fw, rdlen) in enumerate(lanes):
        min_sc = sc.min_score(rdlen)
        if scores[k] < min_sc:
            continue
        window = windows[k]
        if k in ung:
            s2, ref_start, cigar, mds = ung[k]
        else:
            # gapped: host traceback against the window for the placement
            s2, ref_start, cigar, mds = _sw.dp_traceback(
                sc, rd[k, :rdlen].astype(np.uint8), q[k, :rdlen], window)
        if s2 < min_sc:
            # device score and host traceback can disagree near window
            # edges (clipped windows at chromosome starts): gate the
            # final score too
            continue
        jpos = int(wstart) + ref_start
        span = sum(n for op, n in cigar if op in ("M", "D"))
        md, nm = samio.make_md(rd[k, :rdlen].astype(np.uint8),
                               window[ref_start:ref_start + span], cigar)
        a_resc = Alignment(joined_pos=jpos, fw=mate_fw, score=int(s2),
                           cigar=cigar, nmm=len(mds), md=md, nm=nm,
                           gap_opens=sum(1 for op, n in cigar
                                         if op in ("I", "D")),
                           gap_exts=sum(n - 1 for op, n in cigar
                                        if op in ("I", "D")))
        aligner._free_known_snvs(a_resc, rd[k], q[k], mds, int(wstart))
        loc = aligner.fm.ref.joined_to_text(jpos, a_resc.ref_span)
        if loc is None:
            continue
        a_resc.tidx, a_resc.toff = loc
        ab = b1 if anchored == 1 else b2
        a_anchor = finalize(ab, i, ac, int(ab.lens[i]))
        if a_anchor is None or a_anchor.tidx != a_resc.tidx:
            continue
        ok, _frag = _concordant(
            a_anchor.fw, a_anchor.joined_pos, ac["extent"],
            a_resc.fw, a_resc.joined_pos, a_resc.ref_span, o.minins,
            _maxins_eff(o, int(ab.seqs.shape[1])), o.fr,
            (o.dovetail, o.no_contain, o.no_overlap))
        if not ok:
            continue
        pr = results[i]
        pr.kind = "concordant"
        if anchored == 1:
            pr.aln1, pr.aln2 = a_anchor, a_resc
        else:
            pr.aln1, pr.aln2 = a_resc, a_anchor
        pr.best = ac["score"] + int(s2)
        pr.secbest = None
        pr.res1 = pr.res2 = None


def _rescue_ungapped(sc, rd, q, rls, lanes, windows, scores, passing):
    """Exact ungapped placements for rescue lanes, vectorized.

    For each passing lane, scores every diagonal placement of the mate in
    its window with the same substitution/soft-clip model as the DP
    (ops/sw.py): per-diagonal best clip pair is a max-subarray over
    A[i] = cumsum(sub) + SCP(i). A lane whose best ungapped score equals
    its device DP score needs no traceback — the optimum IS ungapped.
    Returns {lane_k: (score, ref_start, cigar, mds)}.
    """
    out = {}
    if not passing:
        return out
    mm_pens = sc.mm_pens()
    sc_pens = sc.sc_pens()
    mb, npen = sc.match_bonus, sc.n_pen
    L = rd.shape[1]
    BAD = -(10 ** 6)
    for c0 in range(0, len(passing), 64):
        ks = passing[c0:c0 + 64]
        P2 = len(ks)
        rdp = rd[ks].astype(np.int32)                      # (P2, L)
        qp = np.clip(q[ks].astype(np.int32), 0, 63)
        win = np.stack([windows[k] for k in ks]).astype(np.int32)
        W = win.shape[1]
        # pad L sentinel columns each side: covers diagonals whose clipped
        # ends overhang the window (the DP clips them too — sentinel cols
        # are BAD so no aligned base ever lands outside the real window)
        wp = np.full((P2, W + 2 * L), 5, np.int32)
        wp[:, L:L + W] = win
        sv = np.lib.stride_tricks.sliding_window_view(wp, L, axis=1)
        T = sv.shape[1]                                    # W + L + 1 diags
        mm = sv != rdp[:, None, :]
        isn = (sv >= 4) | (rdp >= 4)[:, None, :]
        sub = np.where(mm & ~isn, -mm_pens[qp][:, None, :], 0)
        sub = sub + np.where(~mm & ~isn, mb, 0)
        sub = np.where(isn, -npen, sub)
        sub = np.where(sv == 5, BAD, sub)
        in_read = np.arange(L)[None, :] < rls[ks][:, None]
        sub = np.where(in_read[:, None, :], sub, BAD)
        scp = np.where(in_read, sc_pens[qp], 0)
        SCP = np.concatenate(
            [np.zeros((P2, 1), np.int64), np.cumsum(scp, axis=1)], axis=1)
        A = SCP[:, None, :] + np.concatenate(
            [np.zeros((P2, T, 1), np.int64), np.cumsum(sub, axis=2)],
            axis=2)
        runmin = np.minimum.accumulate(A, axis=2)
        gains = A[:, :, 1:] - runmin[:, :, :-1]            # (P2, T, L)
        best_it = gains.max(axis=2)
        best = best_it.max(axis=1) - SCP[:, -1]
        for kk, k in enumerate(ks):
            if best[kk] < scores[k]:
                continue                                   # gapped optimum
            ti = int(best_it[kk].argmax())
            i2 = int(gains[kk, ti].argmax()) + 1
            i1 = int(A[kk, ti, :i2].argmin())
            t = ti - L                                     # undo left pad
            rdlen = int(rls[k])
            cigar = []
            if i1:
                cigar.append(("S", i1))
            cigar.append(("M", i2 - i1))
            if rdlen - i2:
                cigar.append(("S", rdlen - i2))
            bad = mm[kk, ti] | isn[kk, ti]
            mds = [(int(i), int(t + i)) for i in range(i1, i2) if bad[i]]
            out[k] = (int(best[kk]), t + i1, cigar, mds)
    return out


def _mate_result(aligner, batch, i, cands, min_sc, rdlen, finalize
                 ) -> ReadResult:
    res = ReadResult()
    valid = [c for c in cands if c["score"] >= min_sc]
    if not valid:
        return res
    res.best = valid[0]["score"]
    if len(valid) > 1:
        res.secbest = valid[1]["score"]
    for c in valid[: aligner.opts.khits + 1]:
        a = finalize(batch, i, c, rdlen)
        if a is not None:
            res.alns.append(a)
    if not res.alns:
        return ReadResult()
    _dedup_alns(res, aligner.opts.khits)
    return res


def pairs_to_sam(b1: ReadBatch, b2: ReadBatch, results: list[PairResult],
                 aligner: Aligner, writer: samio.SamWriter) -> dict:
    stats = new_pair_stats()
    for i, pr in enumerate(results):
        if aligner.opts.tmo:
            pr = _tmo_filter_pair(aligner, pr)
        lines = pair_lines(aligner, b1, b2, i, pr, stats)
        writer.emit(int(b1.rdids[i]), lines)
    return stats


def _tmo_filter_pair(aligner: Aligner, pr: PairResult) -> PairResult:
    """--tmo per mate alignment (the reference gates each reported hit,
    hi_aligner.h:6126): a pair survives only if both mates pass; a failing
    pair falls to its next passing alternative pair, else to mixed/unal
    with each mate's surviving alignments."""
    if pr.kind in ("concordant", "discordant"):
        alts = [t for t in pr.alt_pairs
                if _tmo_pass(aligner, t[1]) and _tmo_pass(aligner, t[2])]
        if _tmo_pass(aligner, pr.aln1) and _tmo_pass(aligner, pr.aln2):
            if len(alts) == len(pr.alt_pairs):
                return pr
            return PairResult(kind=pr.kind, aln1=pr.aln1, aln2=pr.aln2,
                              best=pr.best,
                              secbest=alts[0][0] if alts else None,
                              alt_pairs=alts)
        if alts:
            t0, a1, a2 = alts[0]
            return PairResult(kind=pr.kind, aln1=a1, aln2=a2, best=t0,
                              secbest=alts[1][0] if len(alts) > 1 else None,
                              alt_pairs=alts[1:])
        return PairResult(kind="unal", res1=ReadResult(), res2=ReadResult())
    r1 = tmo_filter_result(aligner, pr.res1) if pr.res1 else ReadResult()
    r2 = tmo_filter_result(aligner, pr.res2) if pr.res2 else ReadResult()
    return PairResult(kind=pr.kind, res1=r1, res2=r2)


def new_pair_stats() -> dict:
    return dict(pairs=0, conc_uniq=0, conc_multi=0, disc=0,
                mixed_al=0, unal=0, mates_al=0,
                mate_un=0, mate_uniq=0, mate_multi=0)


def tlen_of(aligner: Aligner, a1: Alignment, a2: Alignment) -> int:
    """TLEN of mate 1: the unclipped fragment (the reference's
    setMateParams counts soft-clipped bases), negative when mate 1 lies
    downstream, less the introns: each mate's aligned N ops (one intron
    counted once) and the known sites' introns that lie wholly between the
    mates (templateLenAdjustment through the SpliceSiteDB)."""
    def clips(a):
        c5 = a.cigar[0][1] if a.cigar and a.cigar[0][0] == "S" else 0
        c3 = a.cigar[-1][1] if a.cigar and a.cigar[-1][0] == "S" else 0
        return c5, c3
    c15, c13 = clips(a1)
    c25, c23 = clips(a2)
    left = min(a1.toff - c15, a2.toff - c25)
    right = max(a1.toff + a1.ref_span + c13, a2.toff + a2.ref_span + c23)
    introns = set()
    for a in (a1, a2):
        r = a.toff
        for op, n in a.cigar:
            if op == "N":
                introns.add((r, n))
            if op in ("M", "D", "N", "=", "X"):
                r += n
    inner_l = min(a1.toff + a1.ref_span, a2.toff + a2.ref_span)
    inner_r = max(a1.toff, a2.toff)
    if inner_r > inner_l and len(aligner.ssdb):
        kl, kr = aligner.ssdb.lefts_rights()
        jl = aligner.fm.ref.text_to_joined(a1.tidx, inner_l)
        if jl is not None:
            goff = inner_l - jl
            lo = np.searchsorted(kl, inner_l - goff)
            hi = np.searchsorted(kl, inner_r - goff)
            for si in range(lo, hi):
                if kr[si] <= inner_r - goff:
                    introns.add((int(kl[si]) + goff + 1,
                                 int(kr[si] - kl[si] - 1)))
    tl = right - left - sum(n for _, n in introns)
    return tl if a1.toff <= a2.toff else -tl


def pair_lines(aligner: Aligner, b1: ReadBatch, b2: ReadBatch, i: int,
               pr: PairResult, stats: dict) -> list[str]:
    """SAM lines for one resolved pair (and summary-stat updates): the
    per-pair body shared by pairs_to_sam and the fast emit's slow path."""
    sc = aligner.scoring
    ref = aligner.fm.ref

    def qstr(b, i, ln):
        return (b.quals[i, :ln].astype(np.uint8) + 33).tobytes().decode(
            "ascii")

    stats["pairs"] += 1
    l1, l2 = int(b1.lens[i]), int(b2.lens[i])
    name = b1.names[i]
    seq1, seq2 = b1.seqs[i, :l1], b2.seqs[i, :l2]
    q1, q2 = qstr(b1, i, l1), qstr(b2, i, l2)

    if pr.kind in ("concordant", "discordant"):
        conc = pr.kind == "concordant"
        if conc:
            # >1 times: any second distinct concordant pair exists
            # (reference counts distinct concordant alignments, not only
            # score ties: aln_sink.h nconcord semantics)
            if pr.secbest is not None:
                stats["conc_multi"] += 1
            else:
                stats["conc_uniq"] += 1
        else:
            stats["disc"] += 1
        perfect = sc.perfect_score(l1) + sc.perfect_score(l2)
        minsc = sc.min_score(l1) + sc.min_score(l2)
        mq = _mapq.mapq_v2(pr.best, pr.secbest, perfect, minsc,
                           local=sc.local)
        yt = "CP" if conc else "DP"
        nh = 1 + len(pr.alt_pairs)
        lines = []
        for k, (a1, a2) in enumerate(
                [(pr.aln1, pr.aln2)] + [(x1, x2) for _t, x1, x2
                                        in pr.alt_pairs]):
            t1 = tlen_of(aligner, a1, a2)
            for mate1, a, other, t, seq, q in (
                    (True, a1, a2, t1, seq1, q1),
                    (False, a2, a1, -t1, seq2, q2)):
                rec = samio.SamAlignment(
                    rname=ref.names[a.tidx], pos=a.toff, fw=a.fw,
                    mapq=mq if k == 0 else 255,
                    cigar=a.cigar, score=a.score, nmm=a.nmm,
                    gap_opens=a.gap_opens, gap_exts=a.gap_exts, md=a.md,
                    nm=a.nm, yt=yt, nh=nh, paired=True, mate1=mate1,
                    xs_strand=a.xs_strand, secondary=k > 0,
                    proper_pair=conc, mate_mapped=True,
                    mate_rname=ref.names[other.tidx], mate_pos=other.toff,
                    mate_fw=other.fw, tlen=t)
                lines.append(samio.format_aligned(
                    name, seq, q, rec,
                    omit_sec_seq=aligner.opts.omit_sec_seq))
        stats["mates_al"] += 2
        return lines

    # mixed / unal
    r1 = pr.res1 or ReadResult()
    r2 = pr.res2 or ReadResult()
    if r1.aligned or r2.aligned:
        stats["mixed_al"] += 1
    else:
        stats["unal"] += 1
    lines = []
    for mate1, res, other, seq, q, ln in (
            (True, r1, r2, seq1, q1, l1), (False, r2, r1, seq2, q2, l2)):
        oa = other.alns[0] if other.aligned else None
        if not res.aligned:
            stats["mate_un"] += 1
        elif len(res.alns) > 1 or (res.secbest is not None
                                   and res.secbest == res.best):
            stats["mate_multi"] += 1
        else:
            stats["mate_uniq"] += 1
        if res.aligned:
            stats["mates_al"] += 1
            a = res.alns[0]
            mq = _mapq.mapq_v2(res.best, res.secbest, sc.perfect_score(ln),
                               sc.min_score(ln), local=sc.local)
            rec = samio.SamAlignment(
                rname=ref.names[a.tidx], pos=a.toff, fw=a.fw, mapq=mq,
                cigar=a.cigar, score=a.score, nmm=a.nmm,
                gap_opens=a.gap_opens, gap_exts=a.gap_exts, md=a.md,
                nm=a.nm, zs=res.secbest, yt="UP", nh=len(res.alns),
                xs_strand=a.xs_strand, paired=True, mate1=mate1,
                mate_mapped=oa is not None,
                mate_rname=ref.names[oa.tidx] if oa else None,
                mate_pos=oa.toff if oa else 0,
                mate_fw=oa.fw if oa else True, tlen=0)
            lines.append(samio.format_aligned(name, seq, q, rec))
        else:
            lines.append(samio.format_unaligned(
                name, seq, q, paired=True, mate1=mate1,
                mate_mapped=oa is not None,
                mate_rname=ref.names[oa.tidx] if oa else "*",
                mate_pos=oa.toff if oa else 0,
                mate_fw=oa.fw if oa else True,
                yt="UP", yf=res.filtered))
    return lines
