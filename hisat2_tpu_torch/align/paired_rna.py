"""Vectorized paired-end RNA (spliced) alignment (PyTorch port of
hisat2_tpu/align/paired_rna.py).

The reference resolves spliced paired-end reads inside the same
finishRead ladder as DNA pairs (aln_sink.h:1939, hi_aligner.h:4088-4147).
Here the equivalent is built batch-first:

  * SUBMIT: both mates go as ONE concatenated 2B-read batch through the
    spliced SE step (pipeline.Aligner.device_align_fast): seed, extend,
    DP (ops/dp_cuda.dp_score), fastpack, the splice pass-1/pass-2 lanes
    and the all-rows grid ship (ops/splice.spliced_stage). One device step
    per pair batch.

  * FINISH: the host splice rescue (native junction scorer,
    ops/splice_host.py) runs once over the 2B rows; pairing is then a
    dense (B, KA, KA) NumPy concordance grid in which spliced candidates
    are columns of their own carrying their genomic extents (read length
    plus intron span), so a junction-spanning mate pairs without the
    per-pair Python ladder.

  * EMIT: winning combos (contiguous ungapped or single-junction spliced
    mates) format through the native PE batch formatter
    (native/samfmt.cpp format_pe_batch) with intron-aware CIGARs and the
    known-intron TLEN adjustment (splice_site.h templateLenAdjustment)
    computed vectorized. Only discordant / mixed / gapped / multi-intron
    pairs re-enter the per-pair ladder (paired._pair_result_one, with the
    mate rescue of paired._rescue_mates), with its output exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.reads import ReadBatch
from ..utils import metrics as _metrics
from .pipeline import NEG_INF, Aligner
from . import paired as _paired

NEG_INF_HALF = -(1 << 29)
_SPL_COLS = 4          # spliced candidate columns per mate in the grid


def _concat_pair(b1: ReadBatch, b2: ReadBatch) -> ReadBatch:
    """One 2B-read batch: mate-1 rows [0, B), mate-2 rows [B, 2B)."""
    L = max(b1.seqs.shape[1], b2.seqs.shape[1])

    def pad(x, fill):
        if x.shape[1] == L:
            return x
        return np.pad(x, ((0, 0), (0, L - x.shape[1])),
                      constant_values=fill)
    return ReadBatch(
        np.concatenate([pad(b1.seqs, 4), pad(b2.seqs, 4)]),
        np.concatenate([pad(b1.quals, 0), pad(b2.quals, 0)]),
        np.concatenate([b1.lens, b2.lens]),
        list(b1.names) + list(b2.names))


def submit_pe_rna(al: Aligner, b1: ReadBatch, b2: ReadBatch):
    """Queue one spliced PE batch: the spliced SE step over the
    concatenated mates. The handle carries the step's host copies and
    their `ready` event; merged stays on the device for gathers."""
    bcat = _concat_pair(b1, b2)
    fp, merged_dev, extras, ready = al.device_align_fast(bcat)
    return ("rna", b1, b2, bcat, fp, merged_dev, extras, ready)


def _rna_rescue_rounds(al: Aligner, bcat: ReadBatch, merged, ex,
                       lens) -> None:
    """Splice rescue and novel-site repair rounds over the 2B concatenated
    rows (the PE mirror of emit._finish_fastpack_cols's rescue): the step's
    pass-1 lanes first, then the batch's newly published junctions fold
    into one combined cleanup rescue (cross-read site sharing)."""
    B2 = len(bcat)
    # every live row may trigger: _splice_rescue applies its own
    # imperfection/known-site trigger inside the mask
    allowed = lens > 0
    dev_lanes = None
    if ex is not None and "splanes16" in ex:
        dev_lanes = (ex["splanes32"], ex["splanes16"],
                     ex["spl_cov"], int(ex["spl_nsel"]),
                     int(ex["spl_ssv"]),
                     ex.get("splanes32b"), ex.get("splanes16b"),
                     int(ex.get("spl_nsel2", 0)))
    n_ss0 = len(al.ssdb)
    ssv0 = al.ssdb.version()
    resid = al._splice_rescue(bcat, merged, rows=allowed,
                              dev_lanes=dev_lanes, defer_resid=True)
    cleanup = resid if resid is not None else np.zeros(B2, bool)
    perfect_v = (al.scoring.match_bonus * lens).astype(np.int64)
    prev_n, prev_v = n_ss0, ssv0
    for _round in range(2):
        newp_mask = np.zeros(B2, bool)
        newp = np.zeros((0, 2), np.int64)
        if len(al.ssdb) != prev_n:
            newp = al.ssdb.added_since(prev_v)
            if newp.size:
                aff = allowed & al._spl_affected(merged, lens, newp)
                prevtrig = merged["score"][:, 0] < perfect_v
                newp_mask = aff & prevtrig & ~cleanup
                cleanup = cleanup | (aff & ~prevtrig)
        prev_n, prev_v = len(al.ssdb), al.ssdb.version()
        if not (cleanup.any() or newp_mask.any()):
            break
        if newp_mask.any():
            al._newp_rescue(bcat, merged, newp_mask, newp)
        if cleanup.any():
            al._splice_rescue(bcat, merged, rows=cleanup,
                              scan_covered=dev_lanes is not None)
        cleanup = np.zeros(B2, bool)


def _augmented_mate(m, spl: dict, lens_m: np.ndarray, min_m: np.ndarray):
    """Per-mate candidate columns for the concordance grid: the K2
    regular grid columns followed by up to _SPL_COLS spliced candidates
    (score, genomic start, fw, genomic extent). Returns the column dict
    plus a per-row 'overflow' mask (more spliced candidates than columns:
    that pair must use the exact per-pair ladder)."""
    B, K2 = m["score"].shape
    KA = K2 + _SPL_COLS
    sc = np.full((B, KA), np.int64(NEG_INF))
    sc[:, :K2] = m["score"]
    pos = np.zeros((B, KA), np.int64)
    pos[:, :K2] = m["pos"]
    fw = np.zeros((B, KA), bool)
    fw[:, :K2] = m["fw"]
    gap = np.zeros((B, KA), bool)
    gap[:, :K2] = m["gapped"]
    ext = np.repeat(lens_m[:, None], KA, axis=1)
    tie = np.ones((B, KA), np.int64)    # 0 = baked canonical junction
    sid = np.full((B, KA), -1, np.int64)
    overflow = np.zeros(B, bool)
    if spl:
        for i, cands in spl.items():
            if len(cands) > _SPL_COLS:
                overflow[i] = True
            for s_i, c in enumerate(cands[:_SPL_COLS]):
                t = K2 + s_i
                sc[i, t] = c["score"]
                pos[i, t] = c["posA"]
                fw[i, t] = c["fw"]
                ext[i, t] = lens_m[i] + c["delta"]
                sid[i, t] = s_i
    valid = sc >= min_m[:, None]
    # per-mate candidate rank, mirroring the ladder's mate_cands order:
    # (-score, baked-canonical-spliced first, insertion order)
    score_c = np.clip(sc, -(1 << 20), 1 << 20)
    bigkey = ((1 << 21) - score_c) * (2 * KA) + tie * KA \
        + np.arange(KA)[None, :]
    rank = np.argsort(np.argsort(bigkey, axis=1, kind="stable"),
                      axis=1, kind="stable").astype(np.int64)
    return dict(score=sc, pos=pos, fw=fw, gapped=gap, ext=ext,
                sid=sid, valid=valid, rank=rank), overflow


def _mark_baked_ties(al, aug, m, spl, lens_m):
    """Promote baked known-canonical junction candidates in the tie rank
    (the ladder prefers them to equal-scoring contiguous placements)."""
    if not spl or not len(al.ssdb):
        return
    K2 = m["score"].shape[1]
    KA = aug["score"].shape[1]
    for i, cands in spl.items():
        tie = None
        for s_i, c in enumerate(cands[:_SPL_COLS]):
            if (c["canon"] == 1 and al.ssdb.is_baked(
                    c["posA"] + c["j"] - 1, c["posB"] + c["j"])):
                if tie is None:
                    tie = np.ones(KA, np.int64)
                tie[K2 + s_i] = 0
        if tie is not None:
            # re-rank this row with the baked columns promoted
            scr = np.clip(aug["score"][i], -(1 << 20), 1 << 20)
            bigkey = ((1 << 21) - scr) * (2 * KA) + tie * KA \
                + np.arange(KA)
            aug["rank"][i] = np.argsort(np.argsort(bigkey, kind="stable"),
                                        kind="stable")


def _pair_grid(a1, a2, o, L: int):
    """Dense concordance over the augmented (B, KA, KA) combo grid with
    per-candidate genomic extents; returns the int64 sort key (total
    score, per-mate rank tie-break) and the totals (NEG_INF where a combo
    is not concordant)."""
    P1 = a1["pos"][:, :, None]
    P2 = a2["pos"][:, None, :]
    E1 = a1["ext"][:, :, None]
    E2 = a2["ext"][:, None, :]
    F1 = a1["fw"][:, :, None]
    F2 = a2["fw"][:, None, :]
    left1 = P1 <= P2
    up_fw = np.where(left1, F1, F2)
    dn_fw = np.where(left1, F2, F1)
    frag = np.maximum(P2 + E2, P1 + E1) - np.minimum(P1, P2)
    if o.fr == "fr":
        okdir = up_fw & ~dn_fw
    elif o.fr == "rf":
        okdir = ~up_fw & dn_fw
    else:
        okdir = F1 == F2
    mxeff = _paired._maxins_eff(o, L)
    inwin = (frag >= o.minins) & (frag <= mxeff)
    vv = a1["valid"][:, :, None] & a2["valid"][:, None, :]
    ok = okdir & inwin & vv
    if o.dovetail and o.fr in ("fr", "rf"):
        dd = (~up_fw & dn_fw) if o.fr == "fr" else (up_fw & ~dn_fw)
        ok |= dd & inwin & vv
    if o.no_contain or o.no_overlap:
        e1g = P1 + E1
        e2g = P2 + E2
        up_e = np.where(left1, e1g, e2g)
        dn_e = np.where(left1, e2g, e1g)
        if o.no_contain:
            ok &= ~(dn_e <= up_e)
        if o.no_overlap:
            ok &= ~(np.minimum(e1g, e2g) > np.maximum(P1, P2))
    total = np.where(ok, a1["score"][:, :, None] + a2["score"][:, None, :],
                     np.int64(NEG_INF))
    KA = a1["score"].shape[1]
    TK = KA * KA + 1
    # lexicographic (total desc, mate-1 rank asc, mate-2 rank asc) in one
    # int64 key: the ladder's stable sort over mate_cands order
    key = total * TK - (a1["rank"][:, :, None] * KA + a2["rank"][:, None, :])
    return key, total


def _tlen_intron_sum(al, a1s, a1e, a2s, a2e, i1s, g1, i2s, g2):
    """Intron lengths to subtract from TLEN (paired.tlen_of): each mate's
    aligned intron (counted once when both mates splice the same one)
    plus the known sites' introns wholly inside the inter-mate gap. All
    coordinates joined-genome."""
    s = np.where(g1 > 0, g1, 0).astype(np.int64) \
        + np.where(g2 > 0, g2, 0).astype(np.int64)
    same = (g1 > 0) & (g2 > 0) & (i1s == i2s) & (g1 == g2)
    s -= np.where(same, g1, 0)
    if len(al.ssdb):
        inner_l = np.minimum(a1e, a2e)
        inner_r = np.maximum(a1s, a2s)
        kl, kr = al.ssdb.lefts_rights()
        lo = np.searchsorted(kl, inner_l)
        hi = np.searchsorted(kl, inner_r)
        m = (inner_r > inner_l) & (hi > lo)
        rows = np.flatnonzero(m)
        if rows.size:
            n = (hi - lo)[rows]
            tot = int(n.sum())
            ri = np.repeat(rows, n)
            off = np.zeros(rows.size, np.int64)
            np.cumsum(n[:-1], out=off[1:])
            within = np.arange(tot) - np.repeat(off, n)
            si = np.repeat(lo[rows], n) + within
            ilen = kr[si] - kl[si] - 1
            okk = (kr[si] <= inner_r[ri]) & (ilen > 0)
            # dedup against the mates' own aligned introns (tlen_of keys
            # introns as (start, len); joined start = kl + 1)
            okk &= ~(((kl[si] + 1) == i1s[ri]) & (ilen == g1[ri]))
            okk &= ~(((kl[si] + 1) == i2s[ri]) & (ilen == g2[ri]))
            add = np.where(okk, ilen, 0).astype(np.float64)
            s[rows] += np.bincount(
                ri, weights=add, minlength=a1s.size)[rows].astype(np.int64)
    return s


def _fin_mate_records(al, bcat, B, rec_pair, tcol, aug, spl, mate2: bool,
                      lens_m):
    """Finalization columns for one mate of each reported combo record.
    Regular candidates run through the vectorized host finalizer
    (_ungapped_arrays); spliced ones through _spliced_fin_rows. Returns
    a per-record column dict with an `ok` mask (records that fail
    containment / score-mismatch / multi-intron fall to the ladder)."""
    from .emit import _DEC_ASCII
    N = rec_pair.size
    rows_c = rec_pair + (B if mate2 else 0)
    K2 = aug["score"].shape[1] - _SPL_COLS
    is_spl = tcol >= K2
    out = dict(
        ok=np.zeros(N, bool),
        tidx=np.zeros(N, np.int32), toff=np.zeros(N, np.int64),
        astart=np.zeros(N, np.int64),
        c5=np.zeros(N, np.int32), mid=np.zeros(N, np.int32),
        c3=np.zeros(N, np.int32), m1=np.zeros(N, np.int32),
        gap=np.zeros(N, np.int32), xs=np.zeros(N, np.int32),
        score=np.zeros(N, np.int32), nmm=np.zeros(N, np.int32),
        fw=np.zeros(N, bool), istart=np.zeros(N, np.int64))
    mm_cnt = np.zeros(N, np.int64)
    mm_store: list = [None] * 2

    reg = np.flatnonzero(~is_spl)
    if reg.size:
        rr = rows_c[reg]
        pos_r = aug["pos"][rec_pair[reg], tcol[reg]]
        fw_r = aug["fw"][rec_pair[reg], tcol[reg]]
        rdl = lens_m[rec_pair[reg]]
        A = al._ungapped_arrays(bcat, rr, pos_r, fw_r, rdl)
        exp = aug["score"][rec_pair[reg], tcol[reg]]
        okr = A["ok"] & (A["score"] == exp)
        out["ok"][reg] = okr
        out["tidx"][reg] = A["tidx"]
        out["toff"][reg] = A["toff"]
        out["astart"][reg] = A["astart"]
        out["c5"][reg] = A["c5"]
        out["mid"][reg] = (rdl - A["c5"] - A["c3"]).astype(np.int32)
        out["c3"][reg] = A["c3"]
        out["score"][reg] = exp.astype(np.int32)
        out["nmm"][reg] = A["nmm"].astype(np.int32)
        out["fw"][reg] = fw_r
        cnt_r = np.bincount(A["mm_rows"], minlength=reg.size)
        mm_cnt[reg] = cnt_r
        mm_store[0] = (reg, A["mm_rows"],
                       (A["mm_cols"] - A["c5"][A["mm_rows"]]
                        ).astype(np.int32),
                       np.ascontiguousarray(
                           _DEC_ASCII[np.clip(A["mm_ref"], 0, 4)]))

    spl_idx = np.flatnonzero(is_spl)
    if spl_idx.size:
        with _metrics.span("finish.splice"):
            cands = [spl[int(rec_pair[t])][int(tcol[t]) - K2]
                     for t in spl_idx]
            multi = np.asarray(["segs" in c for c in cands], bool)
            vA = np.asarray([c["posA"] for c in cands], np.int64)
            vB = np.asarray([c["posB"] for c in cands], np.int64)
            vJ = np.asarray([c["j"] for c in cands], np.int64)
            vF = np.asarray([c["fw"] for c in cands], bool)
            vStr = np.asarray([c["strand"] for c in cands])
            vSc = np.asarray([c["score"] for c in cands], np.int64)
            rdl = lens_m[rec_pair[spl_idx]]
            F = al._spliced_fin_rows(bcat, rows_c[spl_idx], vA, vB, vJ, vF,
                                     vStr, rdl)
            oks = F["ok"] & ~multi & (F["gap"] > 0) & (F["m1"] > 0) \
                & (F["m1"] < F["mid"])
            out["ok"][spl_idx] = oks
            out["tidx"][spl_idx] = F["tidx"]
            out["toff"][spl_idx] = F["toff"]
            out["astart"][spl_idx] = vA + F["c5"]
            out["c5"][spl_idx] = F["c5"]
            out["mid"][spl_idx] = F["mid"]
            out["c3"][spl_idx] = F["c3"]
            out["m1"][spl_idx] = F["m1"]
            out["gap"][spl_idx] = F["gap"]
            out["xs"][spl_idx] = F["xs"]
            out["score"][spl_idx] = vSc.astype(np.int32)
            out["nmm"][spl_idx] = F["nm"]
            out["fw"][spl_idx] = vF
            out["istart"][spl_idx] = vA + F["c5"] + F["m1"]
            cnt_s = np.diff(F["mm_off"])
            mm_cnt[spl_idx] = cnt_s
            mm_store[1] = (spl_idx,
                           np.repeat(np.arange(spl_idx.size), cnt_s),
                           F["mm_cols"], F["mm_ref"])

    # merge the two ragged mismatch streams into record order
    mm_off = np.zeros(N + 1, np.int64)
    np.cumsum(mm_cnt, out=mm_off[1:])
    tot = int(mm_off[-1])
    mm_cols = np.zeros(tot, np.int32)
    mm_ref = np.zeros(tot, np.uint8)
    for st in mm_store:
        if st is None:
            continue
        sub, sub_rows, cols, refs = st
        if cols.size == 0:
            continue
        loc_off = np.zeros(sub.size, np.int64)
        cnts = np.bincount(sub_rows, minlength=sub.size)
        np.cumsum(cnts[:-1], out=loc_off[1:])
        tgt = mm_off[sub[sub_rows]] + (np.arange(cols.size)
                                       - loc_off[sub_rows])
        mm_cols[tgt] = cols
        mm_ref[tgt] = refs
    out["mm_cols"] = mm_cols
    out["mm_ref"] = mm_ref
    out["mm_off"] = mm_off
    out["ref_span"] = out["mid"].astype(np.int64) + out["gap"]
    return out


def finish_pe_rna(al: Aligner, handle, writer) -> dict:
    """Host half of the spliced PE path: wait for the step's copies,
    splice-rescue the 2B rows, pair on the augmented grid, format fast
    pairs natively, ladder the rest."""
    _, b1, b2, bcat, _fp, merged_dev, extras, ready = handle
    m = al.metrics
    with _metrics.span("finish", b1, m, "t_host"):
        with _metrics.span("finish.fetch", None, m, "t_fetch"):
            if ready is not None:
                ready.synchronize()
        return _finish_pe_rna(al, b1, b2, bcat, merged_dev, extras, writer)


def _finish_pe_rna(al: Aligner, b1: ReadBatch, b2: ReadBatch,
                   bcat: ReadBatch, merged_dev, extras, writer) -> dict:
    """finish_pe_rna once the step's copies have come."""
    from . import emit as _emit
    ex = {k: v.numpy() if torch.is_tensor(v) else v
          for k, v in extras.items()}
    B = len(b1)
    B2 = 2 * B
    lens_c = bcat.lens.astype(np.int64)

    # full candidate grids (RNA mode ships every row with the fastpack)
    K2 = merged_dev.shape[1]
    msc = np.full((B2, K2), np.int64(NEG_INF))
    mpos = np.zeros((B2, K2), np.int64)
    mfw = np.zeros((B2, K2), bool)
    mgap = np.zeros((B2, K2), bool)
    if "srows" in ex:
        srows_h = ex["srows"]
        g = _emit._unpack_smerged(ex["smerged"])
        sv = srows_h >= 0
        rowsv = srows_h[sv]
        msc[rowsv] = g[sv, :, 0]
        mpos[rowsv] = g[sv, :, 1]
        mfw[rowsv] = (g[sv, :, 2] & 1) > 0
        mgap[rowsv] = (g[sv, :, 2] & 2) > 0
        miss = np.flatnonzero(~np.isin(np.arange(B2), rowsv))
    else:
        miss = np.arange(B2)
    if miss.size:
        mg = al.gather_merged_async(merged_dev, miss)()
        msc[miss] = mg[:, :, 0]
        mpos[miss] = mg[:, :, 1]
        mfw[miss] = (mg[:, :, 2] & 1) > 0
        mgap[miss] = (mg[:, :, 2] & 2) > 0
    merged = dict(score=msc, pos=mpos, fw=mfw, gapped=mgap)

    with _metrics.span("finish.rescue", None, al.metrics, "t_rescue"):
        _rna_rescue_rounds(al, bcat, merged, ex, lens_c)

    # split into mates
    def sub(lo, hi):
        return dict(score=msc[lo:hi], pos=mpos[lo:hi], fw=mfw[lo:hi],
                    gapped=mgap[lo:hi])
    m1 = sub(0, B)
    m2 = sub(B, B2)
    spl_all = merged.get("splice", {})
    m1["splice"] = {i: v for i, v in spl_all.items() if i < B}
    m2["splice"] = {i - B: v for i, v in spl_all.items() if i >= B}
    return pair_finish_rna(al, b1, b2, bcat, m1, m2, writer)


def rescue_pair_rna(al: Aligner, b1: ReadBatch, b2: ReadBatch, m1, m2,
                    dev_lanes=(None, None)) -> None:
    """Per-mate splice rescue over grids that arrive per mate (the per-pair
    path, paired.align_pairs; the sharded genomes' merged grids), then up
    to two rounds that repair the rows the sites published meanwhile can
    affect (cross-read site sharing): rows that triggered before get the
    new sites' lanes (_newp_rescue), the rest a full cleanup rescue. The
    site table's version is taken before the first rescue, so the sites it
    publishes count as new in round 1. The per-mate twin of
    _rna_rescue_rounds."""
    B = len(b1)
    dl1, dl2 = dev_lanes
    prev_n, prev_v = len(al.ssdb), al.ssdb.version()
    r1 = al._splice_rescue(b1, m1, dev_lanes=dl1, defer_resid=True)
    r2 = al._splice_rescue(b2, m2, dev_lanes=dl2, defer_resid=True)
    c1 = r1 if r1 is not None else np.zeros(B, bool)
    c2 = r2 if r2 is not None else np.zeros(B, bool)
    l1 = b1.lens.astype(np.int64)
    l2 = b2.lens.astype(np.int64)
    pf1 = (al.scoring.match_bonus * l1).astype(np.int64)
    pf2 = (al.scoring.match_bonus * l2).astype(np.int64)
    for _round in range(2):
        nm1 = np.zeros(B, bool)
        nm2 = np.zeros(B, bool)
        newp = np.zeros((0, 2), np.int64)
        if len(al.ssdb) != prev_n:
            newp = al.ssdb.added_since(prev_v)
            if newp.size:
                a1 = al._spl_affected(m1, l1, newp)
                a2 = al._spl_affected(m2, l2, newp)
                pt1 = m1["score"][:, 0] < pf1
                pt2 = m2["score"][:, 0] < pf2
                nm1 = a1 & pt1 & ~c1
                nm2 = a2 & pt2 & ~c2
                c1 = c1 | (a1 & ~pt1)
                c2 = c2 | (a2 & ~pt2)
        prev_n, prev_v = len(al.ssdb), al.ssdb.version()
        if not (c1.any() or c2.any() or nm1.any() or nm2.any()):
            break
        if nm1.any():
            al._newp_rescue(b1, m1, nm1, newp)
        if c1.any():
            al._splice_rescue(b1, m1, rows=c1, scan_covered=dl1 is not None)
        if nm2.any():
            al._newp_rescue(b2, m2, nm2, newp)
        if c2.any():
            al._splice_rescue(b2, m2, rows=c2, scan_covered=dl2 is not None)
        c1 = np.zeros(B, bool)
        c2 = np.zeros(B, bool)


def pair_finish_rna(al: Aligner, b1: ReadBatch, b2: ReadBatch,
                    bcat: ReadBatch, m1, m2, writer) -> dict:
    """Vectorized pairing and emission over per-mate candidate dicts
    (with the `splice` maps the rescue attached). Pairs whose reported
    combos are all contiguous-ungapped or single-junction spliced format
    natively; the rest take the per-pair ladder. Output in pair order."""
    from . import emit as _emit
    from .emit import INT32_MIN
    o = al.opts
    sc = al.scoring
    B = len(b1)
    L = bcat.seqs.shape[1]
    lens1 = b1.lens.astype(np.int64)
    lens2 = b2.lens.astype(np.int64)
    spl1 = m1.get("splice", {})
    spl2 = m2.get("splice", {})

    min1 = np.ceil(sc.score_min.I + sc.score_min.S * lens1).astype(np.int64)
    min2 = np.ceil(sc.score_min.I + sc.score_min.S * lens2).astype(np.int64)
    a1, ovf1 = _augmented_mate(m1, spl1, lens1, min1)
    a2, ovf2 = _augmented_mate(m2, spl2, lens2, min2)
    _mark_baked_ties(al, a1, m1, spl1, lens1)
    _mark_baked_ties(al, a2, m2, spl2, lens2)

    key, total = _pair_grid(a1, a2, o, L)
    KA = a1["score"].shape[1]
    khits = o.khits
    KP = min(max(8, khits + 3), KA * KA)
    ordk = np.argsort(-key.reshape(B, -1), axis=1, kind="stable")[:, :KP]
    tot_k = np.take_along_axis(total.reshape(B, -1), ordk, 1)
    t1 = (ordk // KA).astype(np.int64)
    t2 = (ordk % KA).astype(np.int64)
    validk = tot_k > NEG_INF_HALF

    rows = np.arange(B)[:, None]
    cp1 = a1["pos"][rows, t1]
    cp2 = a2["pos"][rows, t2]
    cf1 = a1["fw"][rows, t1]
    cf2 = a2["fw"][rows, t2]
    dup = np.zeros((B, KP), bool)
    for k in range(1, KP):
        eq = ((cp1[:, :k] == cp1[:, k:k + 1])
              & (cf1[:, :k] == cf1[:, k:k + 1])
              & (cp2[:, :k] == cp2[:, k:k + 1])
              & (cf2[:, :k] == cf2[:, k:k + 1]))
        dup[:, k] = eq.any(axis=1)
    pvalid = validk & ~dup
    nvalid = pvalid.sum(axis=1)
    nrep = np.minimum(nvalid, khits)
    vrank = np.where(pvalid, np.cumsum(pvalid, axis=1) - 1, KP + 1)
    KFu = min(KP, khits)
    sel = np.full((B, KFu), KP, np.int64)
    for j in range(KFu):
        hit = vrank == j
        has = hit.any(axis=1)
        sel[has, j] = np.argmax(hit[has], axis=1)
    hit2 = vrank == 1
    sec_total = np.where(hit2.any(axis=1),
                         tot_k[np.arange(B), np.argmax(hit2, axis=1)],
                         np.int64(NEG_INF))
    has_conc = pvalid[:, 0]

    # vectorized-finish eligibility: every reported combo's mates either
    # contiguous-ungapped or single-junction spliced; no overflow rows
    fastpe = has_conc & ~ovf1 & ~ovf2 & (nrep <= KFu)
    selc = np.minimum(sel, KP - 1)
    in_rep = np.arange(KFu)[None, :] < nrep[:, None]
    t1sel = np.take_along_axis(t1, selc, 1)
    t2sel = np.take_along_axis(t2, selc, 1)
    g1sel = a1["gapped"][rows, t1sel]
    g2sel = a2["gapped"][rows, t2sel]
    fastpe &= ~(in_rep & (g1sel | g2sel)).any(axis=1)
    if khits < 2:
        # the second-best combo's total feeds MAPQ unreported: where it
        # holds a spliced candidate, which the ladder may count as a
        # duplicate of the first (one written unspliced), the ladder decides
        j2 = np.argmax(hit2, axis=1)
        K2 = KA - _SPL_COLS
        fastpe &= ~(hit2.any(axis=1) & ((t1[rows[:, 0], j2] >= K2)
                                        | (t2[rows[:, 0], j2] >= K2)))

    stats = _paired.new_pair_stats()
    mqc = _emit._MapqCache(sc)
    fbuf = b""
    pair_end = np.zeros(B, np.int64)

    frows = np.flatnonzero(fastpe)
    if frows.size:
        nr = nrep[frows]
        rec_pair = np.repeat(frows, nr)
        rec_k = np.arange(rec_pair.size) - np.repeat(
            np.concatenate([[0], np.cumsum(nr)[:-1]]), nr)
        col = sel[rec_pair, rec_k]
        t1c = t1[rec_pair, col]
        t2c = t2[rec_pair, col]
        f1 = _fin_mate_records(al, bcat, B, rec_pair, t1c, a1, spl1,
                               False, lens1)
        f2 = _fin_mate_records(al, bcat, B, rec_pair, t2c, a2, spl2,
                               True, lens2)
        okrec = f1["ok"] & f2["ok"] & (f1["tidx"] == f2["tidx"])
        okpair_all = np.ones(B, bool)
        bad = np.flatnonzero(~okrec)
        if bad.size:
            okpair_all[rec_pair[bad]] = False
            keep = okpair_all[rec_pair]
            # the pairs with a failing record go to the ladder: keep the
            # records of the others
            fastpe &= okpair_all
            frows = np.flatnonzero(fastpe)
            nr = nrep[frows]
            rec_pair2 = np.repeat(frows, nr)
            krows = np.flatnonzero(keep)
            assert krows.size == rec_pair2.size
            rec_k = rec_k[krows]

            def subf(f):
                g = {k: v[krows] for k, v in f.items()
                     if k not in ("mm_cols", "mm_ref", "mm_off")}
                cnts = np.diff(f["mm_off"])[krows]
                off = np.zeros(krows.size + 1, np.int64)
                np.cumsum(cnts, out=off[1:])
                src = np.repeat(f["mm_off"][krows], cnts) + (
                    np.arange(int(cnts.sum()))
                    - np.repeat(off[:-1], cnts))
                g["mm_cols"] = f["mm_cols"][src]
                g["mm_ref"] = f["mm_ref"][src]
                g["mm_off"] = off
                return g
            f1 = subf(f1)
            f2 = subf(f2)
            rec_pair = rec_pair2

        if frows.size:
            nrec = rec_pair.size
            toff1, toff2 = f1["toff"], f2["toff"]
            # TLEN over the unclipped fragment minus intron lengths
            left = np.minimum(toff1 - f1["c5"], toff2 - f2["c5"])
            right = np.maximum(toff1 + f1["ref_span"] + f1["c3"],
                               toff2 + f2["ref_span"] + f2["c3"])
            isum = _tlen_intron_sum(
                al, f1["astart"], f1["astart"] + f1["ref_span"],
                f2["astart"], f2["astart"] + f2["ref_span"],
                f1["istart"], f1["gap"].astype(np.int64),
                f2["istart"], f2["gap"].astype(np.int64))
            tl = right - left - isum
            tl1 = np.where(toff1 <= toff2, tl, -tl)

            bt = tot_k[frows, 0]
            st2_ = sec_total[frows]
            need_tab = (st2_ > NEG_INF_HALF) & (st2_ == bt)
            mapq_pair = np.full(frows.size, 60, np.int32)
            for j in np.flatnonzero(need_tab):
                i = frows[j]
                mapq_pair[j] = mqc.get(
                    int(bt[j]), int(st2_[j]), None, False,
                    perfect=sc.perfect_score(int(lens1[i]))
                    + sc.perfect_score(int(lens2[i])),
                    minsc=sc.min_score(int(lens1[i]))
                    + sc.min_score(int(lens2[i])))
            pairloc = np.zeros(int(frows.max()) + 1, np.int64)
            pairloc[frows] = np.arange(frows.size)
            mq_rec = np.where(rec_k == 0, mapq_pair[pairloc[rec_pair]],
                              255).astype(np.int32)
            fw1r, fw2r = f1["fw"], f2["fw"]
            flag1 = (1 | 64 | 2 | np.where(fw1r, 0, 16)
                     | np.where(fw2r, 0, 32)
                     | np.where(rec_k > 0, 256, 0)).astype(np.int32)
            flag2 = (1 | 128 | 2 | np.where(fw2r, 0, 16)
                     | np.where(fw1r, 0, 32)
                     | np.where(rec_k > 0, 256, 0)).astype(np.int32)
            nh = np.repeat(nr, nr).astype(np.int32)

            def ilv(x1, x2):
                out = np.empty(2 * nrec, x1.dtype)
                out[0::2] = x1
                out[1::2] = x2
                return out

            iread = ilv(rec_pair.astype(np.int32) * 2,
                        rec_pair.astype(np.int32) * 2 + 1)
            immoff = np.zeros(2 * nrec + 1, np.int64)
            immoff[1::2] = np.diff(f1["mm_off"])
            immoff[2::2] = np.diff(f2["mm_off"])
            np.cumsum(immoff, out=immoff)
            immcols, immref = _emit._interleave_runs(
                (f1["mm_cols"], f1["mm_ref"], f1["mm_off"],
                 np.diff(f1["mm_off"])),
                (f2["mm_cols"], f2["mm_ref"], f2["mm_off"],
                 np.diff(f2["mm_off"])), nrec)
            with _metrics.span("finish.native"):
                fbuf, rec_ends = _emit._format_pe_records(
                    al, b1, b2, frows, iread, ilv(flag1, flag2),
                    ilv(f1["tidx"], f2["tidx"]),
                    ilv((toff1 + 1).astype(np.int32),
                        (toff2 + 1).astype(np.int32)),
                    ilv(mq_rec, mq_rec),
                    ilv(f1["c5"], f2["c5"]), ilv(f1["mid"], f2["mid"]),
                    ilv(f1["c3"], f2["c3"]),
                    ilv((toff2 + 1).astype(np.int32),
                        (toff1 + 1).astype(np.int32)),
                    ilv(tl1.astype(np.int32), (-tl1).astype(np.int32)),
                    np.full(2 * nrec, 1, np.int32),
                    ilv(f1["score"], f2["score"]),
                    ilv(f1["nmm"], f2["nmm"]),
                    np.full(2 * nrec, INT32_MIN, np.int32),
                    ilv(nh, nh), immcols, immref, immoff,
                    m1=ilv(f1["m1"], f2["m1"]),
                    gapn=ilv(f1["gap"], f2["gap"]),
                    xs=ilv(f1["xs"], f2["xs"]))
            last_rec = 2 * np.cumsum(nr) - 1
            pair_end[frows] = rec_ends[last_rec]
            stats["pairs"] += int(frows.size)
            stats["mates_al"] += 2 * int(frows.size)
            multi = nvalid[frows] >= 2
            stats["conc_multi"] += int(multi.sum())
            stats["conc_uniq"] += int((~multi).sum())

    # ---- per-pair ladder for everything else ----
    slow = np.flatnonzero(~fastpe)
    slow_out: dict[int, list] = {}
    _metrics.count("slow_reads", 2 * int(slow.size))
    if slow.size:
        with _metrics.span("finish.ladder"):
            mate_cands, finalize = _paired.mate_fns(al)
            rescue: list[tuple] = []
            prs: dict[int, object] = {}
            for i in slow:
                i = int(i)
                prs[i] = _paired._pair_result_one(
                    al, i, b1, b2, m1, m2, None, mate_cands, finalize,
                    rescue)
            if rescue:
                _paired._rescue_mates(al, b1, b2, prs, rescue, finalize)
            for i, pr in prs.items():
                slow_out[i] = _paired.pair_lines(al, b1, b2, i, pr, stats)

    _emit._write_in_order(writer, fbuf, fastpe, pair_end, slow_out)
    return stats
