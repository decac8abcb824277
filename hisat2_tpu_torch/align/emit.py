"""Fused align + SAM emission, single-end (PyTorch port of hisat2_tpu's
SE native path).

Ungapped, unspliced reads — multi-mapped ones included — skip all
per-read Python: the device finalizes the top-k candidates of every read
into the int16 fastpack (pipeline._stage_fastpack), and one native call
(native/samfmt.cpp finish_se_native) selects the reportable records and
formats their SAM lines. Only odd reads (gapped, filtered,
fragment-boundary, more than FASTPACK_MM mismatches, candidate overflow)
drop to the per-read ReadResult ladder. Output order is read order.

With seed_mode=False the batch takes the unpacked path instead
(_align_and_emit_legacy): the aligner's per-read device path, a NumPy
selection of the reportable records and the native column formatter
(format_se_batch2), the same ladder for the odd reads. So does --tmo.

In RNA mode (AlignerOpts.spliced) the packed path's host half is
_finish_fastpack_cols: the splice rescue runs first and the formatting
after, so contiguous winners rejoin the column formatter and
single-junction winners take a vectorized spliced finish; the legacy
path runs the same rescue and ranks spliced candidates in its ladder.
The sharded finish (align/sharded.py) takes _finish_fastpack_cols too,
DNA or RNA, with the host-merged pack, a force_slow mask of cross-shard
multireads and the merged candidate grid of every read. Local mode stays
off the native fast paths, as in hisat2_tpu: SE takes the column
formatter, PE the NumPy fast path (_numpy_fast_pe).
Spliced paired-end batches take align/paired_rna.py (both mates as one
2B-read spliced step, pairing on the host); with --tmo, or Zs:Z tags on a
graph index, the per-pair ladder (paired.align_pairs + pairs_to_sam).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..io.reads import ReadBatch
from ..io import sam as samio
from ..native import samfmt_lib
from ..ops import wire as _wire
from . import mapq as _mapq
from . import paired as _paired
from . import paired_rna as _prna
from .paired import PEPACK_HDR, PEPACK_MATE, PEPACK_MM, PEPACK_REP
from .pipeline import (FASTPACK_MM, FASTPACK_REP, NEG_INF, Aligner,
                       ReadResult, _dedup_alns, _filter_reason,
                       _stage_primary_fin, tmo_filter_result)


_DEC_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
# ASCII complement table for reverse-complementing SEQ strings directly
_COMP_ASCII = np.arange(256, dtype=np.uint8)
for _a, _b in ((65, 84), (67, 71), (71, 67), (84, 65)):  # A<->T C<->G
    _COMP_ASCII[_a] = _b
INT32_MIN = np.int32(-(1 << 31))
MAX_FAST_MM = 8
NEG_INF_HALF = -(1 << 29)


class _MapqCache:
    """Memoized MAPQ v2: scores are small ints, so per-batch distinct
    (best, secbest, len, exhausted) tuples number in the dozens."""

    def __init__(self, scoring):
        self.sc = scoring
        self.cache: dict[tuple, int] = {}

    def get(self, best: int, secbest, rdlen, exhausted: bool,
            perfect: int | None = None, minsc: int | None = None) -> int:
        if perfect is None:
            perfect = self.sc.perfect_score(rdlen)
            minsc = self.sc.min_score(rdlen)
        key = (best, secbest, perfect, minsc, exhausted)
        v = self.cache.get(key)
        if v is None:
            v = _mapq.mapq_v2(best, secbest, perfect, minsc,
                              local=self.sc.local, exhausted=exhausted)
            self.cache[key] = v
        return v


def align_and_emit(al: Aligner, batch: ReadBatch, writer) -> dict:
    """Align one SE batch and emit SAM; returns the summary-stats dict."""
    return finish_se(al, submit_se(al, batch), writer)


def submit_se(al: Aligner, batch: ReadBatch):
    """Queue one SE batch's device work and its result copies. Pair with
    finish_se; several submits in flight overlap device work with host
    finishing (align_and_emit_stream). With seed_mode=False the whole
    batch is aligned at finish time, on the per-read path; so is a run
    with Zs:Z tags on a graph index (the tags come from the per-read
    finalizers), and a --tmo run (contiguous records never report)."""
    if not al.opts.seed_mode or al.opts.tmo or _zs_run(al):
        return ("legacy", batch)
    return ("fast", batch, *al.device_align_fast(batch))


def _zs_run(al: Aligner) -> bool:
    """Zs:Z tags asked for on an index that has an SNV overlay."""
    return al.opts.zs_tags and al.overlay is not None


def finish_se(al: Aligner, handle, writer) -> dict:
    if handle[0] == "legacy":
        return _align_and_emit_legacy(al, handle[1], writer)
    _, batch, fp, merged_dev, extras, ready = handle
    t0 = time.perf_counter()
    if ready is not None:
        ready.synchronize()
    al.metrics.t_fetch += time.perf_counter() - t0
    st = _finish_fastpack(al, batch, fp.numpy(), merged_dev, writer,
                          {k: v.numpy() if torch.is_tensor(v) else v
                           for k, v in extras.items()})
    al.metrics.t_host += time.perf_counter() - t0
    return st


def align_and_emit_stream(al: Aligner, batches, writer,
                          on_batch=None, depth: int = 4,
                          workers: int = 3) -> dict:
    """Pipelined SE loop: batch k+1's device work is queued before batch
    k's results are finished, so device work, copies and host formatting
    overlap. Output order is submit order.

    The finish half (native selection + SAM formatting, slow-read ladder)
    runs in `workers` threads: the native formatter releases the GIL, so
    several batches finish concurrently while the main thread keeps
    submitting. depth = max in-flight batches.

    In RNA mode the splice rescue adds to the novel-junction table, so
    finishes run serially on this thread (later batches see earlier
    discoveries in order), and at most one batch is in flight: each submit
    bakes the site table into its step, and a deeper queue leaves every
    batch's step lanes stale."""
    if al.opts.spliced:
        workers = 0
        depth = min(depth, 1)
    return _stream(al, ((b,) for b in batches), writer, submit_se,
                   finish_se, on_batch, depth, workers)


class _TextShim:
    """Duck-typed writer capturing a finisher's output for ordered replay
    (the finishers only touch writer.out.write)."""
    __slots__ = ("out",)

    def __init__(self):
        import io as _io
        self.out = _io.StringIO()


def _finish_to_text(al, handle, finish_fn):
    shim = _TextShim()
    st = finish_fn(al, handle, shim)
    return shim.out.getvalue(), st


def _stream(al, item_tuples, writer, submit_fn, finish_fn,
            on_batch, depth: int, workers: int) -> dict:
    from collections import deque
    totals: dict = {}

    def done(st, pt):
        _merge_stats(totals, st)
        if on_batch:
            on_batch(pt[0] if len(pt) == 1 else pt, st)

    if workers <= 0:
        pending: deque = deque()
        for tup in item_tuples:
            pending.append((submit_fn(al, *tup), tup))
            if len(pending) > depth:
                ph, pt = pending.popleft()
                done(finish_fn(al, ph, writer), pt)
        while pending:
            ph, pt = pending.popleft()
            done(finish_fn(al, ph, writer), pt)
        return totals

    from concurrent.futures import ThreadPoolExecutor
    w = writer.out.write
    pending = deque()        # (future or None, handle, tup) in submit order

    def drain_one():
        fut, h, pt = pending.popleft()
        if fut is not None:
            text, st = fut.result()
            if text:
                w(text)
        else:                # legacy handle: aligned here, on the real writer
            st = finish_fn(al, h, writer)
        done(st, pt)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for tup in item_tuples:
            h = submit_fn(al, *tup)
            if h[0] == "legacy":
                # its device work runs at finish time, and the per-read
                # path writes through writer.emit: keep it on this thread,
                # after everything queued ahead of it
                while pending:
                    drain_one()
                pending.append((None, h, tup))
            else:
                pending.append((ex.submit(_finish_to_text, al, h, finish_fn),
                                h, tup))
            if len(pending) > depth:
                drain_one()
        while pending:
            drain_one()
    return totals


def _merge_stats(tot: dict, st: dict) -> None:
    for k, v in st.items():
        tot[k] = tot.get(k, 0) + v


def _native_fast_se(al, batch, fp, ex, KFB, lens, L):
    """Run the whole SE fast path (mask + record columns + SAM bytes +
    stats) in ONE native call with the GIL released (finish_se_native,
    native/samfmt.cpp). Returns (fast, fbuf, read_end, stats, nvalid)."""
    lib = samfmt_lib()
    B = len(batch)
    o = al.opts
    sc = al.scoring
    ref = al.fm.ref

    # tier extras
    z_i32 = np.zeros(0, np.int32)
    z_i16 = np.zeros(0, np.int16)
    t0r, t0p, tn0, tk00, tk10 = z_i32, z_i16, 0, KFB, KFB
    t1r, t1p, tn1, tk01, tk11 = z_i32, z_i16, 0, KFB, KFB
    KF = KFB
    if ex is not None and "smrep0" in ex:
        t0r = np.ascontiguousarray(ex["smrows0"].astype(np.int32))
        t0p = np.ascontiguousarray(ex["smrep0"].astype(np.int16))
        tn0 = t0r.size
        nb0 = t0p.shape[1] // FASTPACK_REP if t0p.ndim == 2 else 0
        tk00, tk10 = KF, KF + nb0
        KF += nb0
        if "smrep1" in ex:
            t1r = np.ascontiguousarray(ex["smrows1"].astype(np.int32))
            t1p = np.ascontiguousarray(ex["smrep1"].astype(np.int16))
            tn1 = t1r.size
            nb1 = t1p.shape[1] // FASTPACK_REP if t1p.ndim == 2 else 0
            tk01, tk11 = KF, KF + nb1
            KF += nb1

    name_buf, name_off, _ = _name_buf(batch.names)

    rn_buf, rn_off, rn_lens = _refname_cache(al)
    yf_qc = np.zeros(B, np.uint8)
    if (lens == 0).any() and batch.reads:
        qcf = np.fromiter((not getattr(r, "qc_ok", True)
                           for r in batch.reads), bool, B)
        yf_qc[qcf & (lens == 0)] = 1

    qconst = _batch_qconst(batch)
    seqs = batch.seqs if batch.seqs.dtype == np.uint8 \
        else batch.seqs.astype(np.uint8)

    capr = B * max(KF, 1)
    maxrn = int(rn_lens.max()) if rn_lens.size else 1
    cap = int(capr * (242 + maxrn + 2 * L + 12 * FASTPACK_MM + 255) + 4096)
    cols = np.zeros(13 * capr, np.int32)
    mm_out = np.zeros(capr * FASTPACK_MM, np.int16)
    rec_ends = np.zeros(capr, np.int64)
    outbuf = ctypes.create_string_buffer(cap)

    fast_u8 = np.zeros(B, np.uint8)
    read_end = np.zeros(B, np.int64)
    stats_a = np.zeros(4, np.int64)
    total = lib.finish_se_native(
        np.int32(B), np.int64(L), np.int32(3),
        np.ascontiguousarray(fp), np.int32(fp.shape[1]), np.int32(KFB),
        t0r, t0p, np.int32(tn0), np.int32(tk00), np.int32(tk10),
        t1r, t1p, np.int32(tn1), np.int32(tk01), np.int32(tk11),
        np.ascontiguousarray(seqs), np.ascontiguousarray(_u8(batch.quals)),
        np.int32(qconst), np.ascontiguousarray(lens), yf_qc,
        np.ascontiguousarray(ref.frag_joined),
        np.ascontiguousarray(ref.frag_len.astype(np.int64)),
        np.ascontiguousarray(ref.frag_toff),
        np.ascontiguousarray(ref.frag_tidx.astype(np.int32)),
        np.int32(ref.frag_joined.size),
        rn_buf, rn_off, name_buf, name_off,
        float(sc.score_min.I), float(sc.score_min.S),
        float(sc.n_ceil.I), float(sc.n_ceil.S),
        np.int32(sc.match_bonus), np.int32(o.khits), np.int32(KF),
        np.int32(1 if o.omit_sec_seq else 0),
        fast_u8, read_end, outbuf, np.int64(cap), stats_a,
        cols, mm_out, rec_ends)
    if total < 0:
        raise RuntimeError("finish_se_native: SAM buffer overflow")
    stats = dict(reads=B, unal=int(stats_a[2]), uniq=int(stats_a[0]),
                 multi=int(stats_a[1]))
    nvalid = fp[:, 0].astype(np.int64)
    fbuf = ctypes.string_at(ctypes.addressof(outbuf), int(total))
    return fast_u8.astype(bool), fbuf, read_end, stats, nvalid


def _unpack_smerged(g) -> np.ndarray:
    """Inverse of the device-side grid pack (_stage_align_packed SB
    block): (n, K2, 2) [pos, score<<8|flags] -> (n, K2, 3)
    [score, pos, flags], dead candidates restored to NEG_INF."""
    g = np.asarray(g)
    sc = (g[:, :, 1] >> 8).astype(np.int64)
    sc = np.where(sc <= -(1 << 22), np.int64(NEG_INF), sc)
    return np.stack([sc, g[:, :, 0].astype(np.int64),
                     (g[:, :, 1] & 0xFF).astype(np.int64)], axis=2)


def _finish_slow_and_stitch(al, batch, ex, merged_dev, writer, fast,
                            filtered, nvalid, min_scs, lens, fbuf,
                            read_end, stats) -> dict:
    """Slow-row ladder + ordered stitch for the native fast path."""
    B = len(batch)
    slow = np.flatnonzero(~fast)
    grows = slow[~filtered[slow] & (nvalid[slow] >= 1)]
    srows_h = smg_h = None
    mg_fut = None
    if ex is not None and "srows" in ex:
        srows_h = ex["srows"]
        smg_h = _unpack_smerged(ex["smerged"])
        miss = grows[~np.isin(grows, srows_h)]
        mg_fut = (al.gather_merged_async(merged_dev, miss)
                  if miss.size else None)
        grows = miss
    elif merged_dev is not None:
        mg_fut = al.gather_merged_async(merged_dev, grows)

    slow_out: dict[int, list] = {}
    if slow.size:
        K2 = (smg_h.shape[1] if smg_h is not None else merged_dev.shape[1])
        msc = np.full((B, K2), NEG_INF, np.int64)
        mpos = np.zeros((B, K2), np.int64)
        mfw = np.zeros((B, K2), bool)
        mgap = np.zeros((B, K2), bool)

        def fill(rows, g):
            msc[rows] = g[:, :, 0]
            mpos[rows] = g[:, :, 1]
            mfw[rows] = (g[:, :, 2] & 1) > 0
            mgap[rows] = (g[:, :, 2] & 2) > 0
        if smg_h is not None:
            sv = srows_h >= 0
            if sv.any():
                fill(srows_h[sv], smg_h[sv])
        if mg_fut is not None:
            mg = mg_fut()
            if mg.size:
                fill(grows, mg)
        merged = dict(score=msc, pos=mpos, fw=mfw, gapped=mgap)

        slow_out = _slow_ladder(al, batch, merged, slow, filtered,
                                min_scs, lens, stats)

    _write_in_order(writer, fbuf, fast, read_end, slow_out)
    return stats


def _slow_ladder(al, batch, merged, slow, filtered, min_scs, lens,
                 stats, spl=None) -> dict:
    """The per-read ladder for the rows `slow` of a host candidate dict:
    rank each read's candidates (with `spl`, its spliced candidates too),
    finalize the ungapped ones in one vectorized pass, the gapped ones by
    traceback and the spliced ones by _finalize_spliced, dedup, format.
    Under --tmo only spliced candidates rank, and the survivors pass
    tmo_filter_result. Returns {row: SAM lines} and adds the rows to
    `stats`."""
    sc = al.scoring
    tmo = al.opts.tmo
    slow_out: dict[int, list] = {}
    plans: dict[int, list] = {}
    ug_items: list[tuple[int, int, bool]] = []
    for i in slow:
        i = int(i)
        if filtered[i]:
            continue
        entries = [("reg", s, p, f, g) for s, p, f, g, _, _
                   in al._ranked_candidates(merged, i, int(min_scs[i]))]
        if spl and i in spl:
            entries += [("spl", c["score"], c["posA"], c["fw"], c)
                        for c in spl[i] if c["score"] >= min_scs[i]]
            # ties: baked known-site junctions beat contiguous alignments
            # (runtime novel sites do not — splice_db.is_baked)
            entries.sort(key=lambda e: (
                -e[1], 0 if (e[0] == "spl" and e[4]["canon"] == 1
                             and al.ssdb.is_baked(
                                 e[4]["posA"] + e[4]["j"] - 1,
                                 e[4]["posB"] + e[4]["j"])) else 1))
        if tmo:
            # contiguous candidates never pass _tmo_pass: drop them before
            # the -k cut so they do not evict a reportable spliced one
            entries = [e for e in entries if e[0] == "spl"]
        entries = entries[: al.opts.khits + 1]
        plans[i] = entries
        for kind, s, p, f, g in entries:
            if kind == "reg" and not g:
                ug_items.append((i, int(p), bool(f)))
    lookup: dict[tuple, object] = {}
    if ug_items:
        ridx = np.asarray([x[0] for x in ug_items])
        upos = np.asarray([x[1] for x in ug_items])
        ufw = np.asarray([x[2] for x in ug_items])
        alns = al._finalize_ungapped_list(batch, ridx, upos, ufw, lens[ridx])
        for (i, p, f), a in zip(ug_items, alns):
            lookup[(i, p, f)] = a

    for i in slow:
        i = int(i)
        if filtered[i]:
            res = ReadResult(filtered=_filter_reason(batch, i, lens))
        else:
            res = ReadResult()
            entries = plans.get(i, [])
            if entries:
                res.best = entries[0][1]
                if len(entries) > 1:
                    res.secbest = entries[1][1]
                for kind, s, p, f, g in entries:
                    if kind == "spl":
                        a = al._finalize_spliced(i, batch, g, int(lens[i]))
                    elif g:
                        a = al._finalize(i, batch, s, p, f, True,
                                         int(lens[i]))
                    else:
                        a = lookup.get((i, p, f))
                    if a is not None:
                        res.alns.append(a)
                if res.alns:
                    _dedup_alns(res, al.opts.khits)
                else:
                    res = ReadResult()
                if tmo:
                    res = tmo_filter_result(al, res)
        lines = _format_slow(al, batch, i, res, sc)
        if not res.aligned:
            stats["unal"] += 1
        elif len(res.alns) > 1 or (res.secbest is not None
                                   and res.secbest >= min_scs[i]):
            stats["multi"] += 1
        else:
            stats["uniq"] += 1
        slow_out[i] = lines
    return slow_out


def _finish_fastpack(al: Aligner, batch: ReadBatch, fp: np.ndarray,
                     merged_dev, writer, ex: dict | None, force_slow=None,
                     merged_full=None) -> dict:
    """Host half of the packed SE path: format fast reads natively from
    the int16 fastpack, run the slow reads' ladder, and stitch output in
    read order.

    The sharded finish passes a host-merged fastpack, `ex` = the merged
    splice lanes (slow_pack, RNA) or None, a force_slow mask (cross-shard
    multireads take the ladder) and merged_full (every read's candidate
    grid, global coordinates) with merged_dev None; those take the column
    formatter, as in hisat2_tpu."""
    sc = al.scoring
    lens = batch.lens.astype(np.int64)
    L = batch.seqs.shape[1]
    min_scs = np.ceil(sc.score_min.I + sc.score_min.S * lens).astype(np.int64)
    nNs = ((batch.seqs >= 4)
           & (np.arange(L)[None, :] < lens[:, None])).sum(axis=1)
    filtered = (lens == 0) | (nNs > sc.n_ceil.I + sc.n_ceil.S * lens)
    KFB = (fp.shape[1] - 4) // FASTPACK_REP
    # local mode stays off the native fast path, as in hisat2_tpu
    if (al.opts.spliced or sc.local or force_slow is not None
            or merged_full is not None):
        return _finish_fastpack_cols(al, batch, fp, merged_dev, writer, ex,
                                     lens, L, min_scs, filtered, KFB,
                                     force_slow, merged_full)
    fast, fbuf, read_end, stats, nvalid = _native_fast_se(
        al, batch, fp, ex, KFB, lens, L)
    return _finish_slow_and_stitch(
        al, batch, ex, merged_dev, writer, fast, filtered, nvalid, min_scs,
        lens, fbuf, read_end, stats)


def _finish_fastpack_cols(al: Aligner, batch: ReadBatch, fp: np.ndarray,
                          merged_dev, writer, ex: dict | None, lens, L: int,
                          min_scs, filtered, KFB: int, force_slow=None,
                          merged_full=None) -> dict:
    """The column-formatter host half of the packed SE path (the JAX
    package's non-native tail of _finish_fastpack): unpack the fastpack's
    report lanes and format the fast reads with _format_records3. DNA:
    the slow reads (force_slow ones among them) take the per-read ladder.
    RNA: hold back the reads whose score can hide a junction, run the
    splice rescue on them first — the step's pass-1 lanes, then one
    cleanup for the rows the step missed and the sites published since —
    and format after: contiguous winners rejoin the column formatter,
    single-junction winners take the vectorized spliced finish
    (_spliced_fin_rows + _format_records), the rest the per-read
    finalization. Output order is read order."""
    B = len(batch)
    o = al.opts
    rna = o.spliced
    sc = al.scoring
    khits = o.khits
    # tiered multi-report buckets (_stage_fastpack MB extras): tier t
    # carries a slice of reports >= KFB for reads with enough placements,
    # scattered to full-B lanes here
    tier_rows: list = []
    tier_reps: list = []
    tier_has: list = []
    k_tier: dict[int, tuple] = {}        # report k -> (tier, col)
    KF = KFB
    if ex is not None:
        t = 0
        while f"smrep{t}" in ex:
            rows_t = ex[f"smrows{t}"]
            rep_t = ex[f"smrep{t}"].reshape(rows_t.size, -1, FASTPACK_REP)
            has_t = np.zeros(B, bool)
            has_t[rows_t[rows_t >= 0]] = True
            tier_rows.append(rows_t)
            tier_reps.append(rep_t)
            tier_has.append(has_t)
            for c in range(rep_t.shape[1]):
                k_tier[KF + c] = (t, c)
            KF += rep_t.shape[1]
            t += 1
    nvalid = fp[:, 0].astype(np.int64)
    best = fp[:, 1].astype(np.int64)
    secb = fp[:, 2].astype(np.int64)
    flags = fp[:, 3].astype(np.int64)
    has_sec = secb != -32768

    def rep(k):
        if k < KFB:
            b0 = 4 + FASTPACK_REP * k
            lanes = fp[:, b0:b0 + FASTPACK_REP].astype(np.int64)
        else:
            ti, c = k_tier[k]
            rows_t, rep_t = tier_rows[ti], tier_reps[ti]
            bokt = rows_t >= 0
            lanes = np.zeros((B, FASTPACK_REP), np.int64)
            lanes[rows_t[bokt]] = rep_t[bokt, c].astype(np.int64)
        lo = lanes[:, 0].astype(np.uint16).astype(np.uint32)
        hi = lanes[:, 1].astype(np.uint16).astype(np.uint32)
        return dict(
            pos=(lo | (hi << 16)).astype(np.int64),
            c5=lanes[:, 2],
            c3=lanes[:, 3],
            nmm=lanes[:, 4],
            nmm_all=lanes[:, 5],
            score=lanes[:, 6],
            mm=lanes[:, 7:7 + FASTPACK_MM],
            fw=(flags >> (2 * k)) & 1 > 0,
            gapped=(flags >> (2 * k + 1)) & 1 > 0)
    reps = [rep(k) for k in range(KF)]

    aligned = ~filtered & (nvalid >= 1)
    # unaligned/filtered reads emit exactly one flag-4 record — the native
    # formatter handles them (rname_idx -1; YF code in the mapq column), so
    # they stay off the per-read Python path entirely
    unal = ~aligned
    nrep = np.minimum(nvalid, khits)
    fast = aligned & (nrep <= KF)
    if al.opts.omit_sec_seq:
        fast &= nrep <= 1          # secondary records go per-read
    ref = al.fm.ref
    okfs = []
    for k in range(KF):
        r = reps[k]
        astart = r["pos"] + r["c5"]
        span = lens - r["c5"] - r["c3"]
        f = np.searchsorted(ref.frag_joined, astart, side="right") - 1
        okf = (f >= 0) & (span > 0)
        fc = np.clip(f, 0, len(ref.frag_joined) - 1)
        okf &= astart + span <= ref.frag_joined[fc] + ref.frag_len[fc]
        okf &= ~r["gapped"] & (r["nmm_all"] <= FASTPACK_MM)
        r["fc"], r["astart"] = fc, astart
        if k >= KFB:
            okf &= tier_has[k_tier[k][0]]
        okfs.append(okf)
        fast &= (nrep <= k) | okf
    fastble = fast.copy()     # native eligibility, before the RNA gate
    fast |= unal
    if rna:
        # splice-rescue trigger (host source of truth; the device ships
        # grids for its own prediction of this set): imperfect beyond the
        # min-anchor clip margin, or a known junction inside the primary
        # span. Unfiltered unaligned reads may hide junction-only
        # placements in their sub-threshold grids — they stay slow too.
        perfect = (sc.match_bonus * lens).astype(np.int64)
        margin = al._spl_margin(batch)
        p0 = reps[0]["pos"]
        trig = aligned & (best < perfect - margin)
        if len(al.ssdb):
            kl, _kr = al.ssdb.lefts_rights()
            kr_sorted, _klr = al.ssdb.rights_sorted()
            trig |= aligned & (
                (np.searchsorted(kl, p0 + lens - 1)
                 > np.searchsorted(kl, p0 + 1))
                | (np.searchsorted(kr_sorted, p0 + lens - 1)
                   > np.searchsorted(kr_sorted, p0 + 1)))
        fast &= ~(trig | (unal & ~filtered))
    if force_slow is not None:
        fast &= ~force_slow
        fastble &= ~force_slow

    mqc = _MapqCache(sc)
    stats = dict(reads=B, unal=0, uniq=0, multi=0)

    # slow rows' merged grids normally ship with the fastpack (device
    # slow-row prediction, _stage_align_packed SB); any rows the device
    # missed fall back to a gather, dispatched BEFORE formatting fast
    # reads so its dispatch+transfer latency hides under the host work
    slow = np.flatnonzero(~fast)
    if rna:
        # junction reads often have NO contiguous candidate above min
        # score — their sub-threshold grids still seed the diagonal pairs
        grows = slow[~filtered[slow]]
    else:
        grows = slow[~filtered[slow] & (nvalid[slow] >= 1)]
    srows_h = smg_h = None
    mg_fut = None
    if merged_full is None and ex is not None and "srows" in ex:
        srows_h = ex["srows"]
        smg_h = _unpack_smerged(ex["smerged"])
        miss = grows[~np.isin(grows, srows_h)]
        mg_fut = (al.gather_merged_async(merged_dev, miss)
                  if miss.size else None)
        grows = miss
    elif merged_full is None:
        mg_fut = al.gather_merged_async(merged_dev, grows)

    def fmt_fast(fastm):
        fbuf = b""
        read_end = np.zeros(B, np.int64)
        frows = np.flatnonzero(fastm)
        if frows.size:
            nr = np.where(aligned[frows], nrep[frows], 1)
            rec_read = np.repeat(frows, nr)
            rec_lidx = np.repeat(np.arange(frows.size), nr)
            rec_k = np.arange(rec_read.size) - np.repeat(
                np.concatenate([[0], np.cumsum(nr)[:-1]]), nr)
            # stacked (KF, B) field arrays -> per-record select by rec_k
            stk = {f: np.stack([r[f] for r in reps])
                   for f in ("pos", "c5", "c3", "nmm", "nmm_all", "score",
                             "fw", "fc", "astart")}
            take = lambda fld: stk[fld][rec_k, rec_read]
            pos = take("pos")
            c5 = take("c5").astype(np.int32)
            c3 = take("c3").astype(np.int32)
            nmm = take("nmm").astype(np.int32)
            cnt = take("nmm_all")
            fw = take("fw")
            score = take("score").astype(np.int32)
            fc_r = take("fc")
            astart_r = take("astart")
            mid = (lens[rec_read] - c5 - c3).astype(np.int32)
            tidx = ref.frag_tidx[fc_r].astype(np.int32)
            toff = ref.frag_toff[fc_r] + astart_r - ref.frag_joined[fc_r]
            flag = (np.where(fw, 0, 16) | np.where(rec_k > 0, 256, 0)
                    ).astype(np.int32)
            nh = np.repeat(nr, nr).astype(np.int32)
            # MAPQ (reference 60 fast path; table only on equal second-best)
            mapq_read = np.full(frows.size, 60, np.int32)
            need_tab = (has_sec & (secb == best) & aligned)[frows]
            for j in np.flatnonzero(need_tab):
                i = frows[j]
                mapq_read[j] = mqc.get(int(best[i]), int(secb[i]),
                                       int(lens[i]), False)
            mapq = np.where(rec_k == 0, mapq_read[rec_lidx], 255).astype(np.int32)
            zs = np.where(has_sec[rec_read], secb[rec_read],
                          np.int64(INT32_MIN)).astype(np.int32)
            ur = unal[rec_read]
            if ur.any():
                # flag-4 records: rname -1, pos1 0, YF code rides the mapq col
                tidx = np.where(ur, -1, tidx).astype(np.int32)
                toff = np.where(ur, -1, toff)
                flag = np.where(ur, 4, flag).astype(np.int32)
                yf_code = np.where(lens == 0, 2, np.where(filtered, 1, 0))
                if (lens == 0).any() and batch.reads:
                    qcf = np.fromiter(
                        (not getattr(r, "qc_ok", True) for r in batch.reads),
                        bool, B)
                    yf_code = np.where(qcf & (lens == 0), 3, yf_code)
                mapq = np.where(ur, yf_code[rec_read], mapq).astype(np.int32)
                cnt = np.where(ur, 0, cnt)

            mmstk = np.stack([r["mm"] for r in reps])      # (KF, B, MM)
            mmpk = mmstk[rec_k, rec_read]
            cnt = cnt.astype(np.int32)

            fbuf, rec_ends = _format_records3(
                al, batch, frows, rec_read, flag, tidx,
                toff, mapq, c5, mid, c3, score, nmm, zs, nh,
                mmpk.astype(np.int16), cnt)
            last_rec = np.cumsum(nr) - 1
            read_end[frows] = rec_ends[last_rec]
            fal = aligned[frows]
            stats["uniq"] += int((fal & (nvalid[frows] == 1)).sum())
            stats["multi"] += int((fal & (nvalid[frows] >= 2)).sum())
            stats["unal"] += int((~fal).sum())

        return fbuf, read_end

    def build_merged():
        if merged_full is not None:
            return merged_full
        K2 = (smg_h.shape[1] if smg_h is not None
              else merged_dev.shape[1])
        msc = np.full((B, K2), NEG_INF, np.int64)
        mpos = np.zeros((B, K2), np.int64)
        mfw = np.zeros((B, K2), bool)
        mgap = np.zeros((B, K2), bool)

        def fill(rows, g):
            msc[rows] = g[:, :, 0]
            mpos[rows] = g[:, :, 1]
            mfw[rows] = (g[:, :, 2] & 1) > 0
            mgap[rows] = (g[:, :, 2] & 2) > 0
        if smg_h is not None:
            sv = srows_h >= 0
            if sv.any():
                fill(srows_h[sv], smg_h[sv])
        if mg_fut is not None:
            mg = mg_fut()
            if mg.size:
                fill(grows, mg)
        return dict(score=msc, pos=mpos, fw=mfw, gapped=mgap)

    slow_out: dict[int, list] = {}
    if not rna:
        fbuf, read_end = fmt_fast(fast)
        if slow.size:
            slow_out = _slow_ladder(al, batch, build_merged(), slow,
                                    filtered, min_scs, lens, stats)
        return _stitch_cols(writer, fbuf, fast, read_end, slow_out, stats)
    # RNA: rescue FIRST, format after — contiguous winners rejoin
    # the native fast path instead of the per-read ladder, and
    # spliced winners format through the vectorized column path.
    merged = build_merged()
    allowed = np.zeros(B, bool)
    allowed[slow] = True
    allowed &= ~filtered
    n_ss0 = len(al.ssdb)
    ssv0 = al.ssdb.version()
    # fused pass-1 lanes from the submit dispatch (spliced_stage):
    # legacy rescue runs only for rows the device missed
    dev_lanes = None
    if ex is not None and "splanes16" in ex:
        dev_lanes = (ex["splanes32"], ex["splanes16"],
                     ex["spl_cov"], int(ex["spl_nsel"]),
                     int(ex["spl_ssv"]),
                     ex.get("splanes32b"), ex.get("splanes16b"),
                     int(ex.get("spl_nsel2", 0)))
    resid = al._splice_rescue(batch, merged, rows=allowed,
                              dev_lanes=dev_lanes, defer_resid=True)
    cleanup = resid if resid is not None else np.zeros(B, bool)
    perfect_v = (al.scoring.match_bonus * lens).astype(np.int64)
    prev_n, prev_v = n_ss0, ssv0
    for _round in range(2):
        newp_mask = np.zeros(B, bool)
        newp = np.zeros((0, 2), np.int64)
        if len(al.ssdb) != prev_n:
            # newly published junctions unlock short-anchor reads
            # (reference cross-thread splice-site sharing, P5): rows
            # not yet rescued whose primary span now contains a known
            # site join the pool; already-rescued rows re-run only
            # where a new site can add a lane. All of it folds into
            # ONE cleanup rescue together with the rows the fused
            # dispatch missed (resid).
            cand = np.flatnonzero(~allowed & aligned)
            demoted = np.zeros(0, np.int64)
            if cand.size:
                kl, _kr2 = al.ssdb.lefts_rights()
                kr_sorted, _klr2 = al.ssdb.rights_sorted()
                p0f = reps[0]["pos"][cand]
                s_l = p0f + 1
                s_r = p0f + lens[cand] - 1
                hit = ((np.searchsorted(kl, s_r)
                        > np.searchsorted(kl, s_l))
                       | (np.searchsorted(kr_sorted, s_r)
                          > np.searchsorted(kr_sorted, s_l)))
                demoted = cand[hit]
            if demoted.size:
                all_shipped = (srows_h is not None
                               and srows_h.size >= B
                               and (srows_h >= 0).all())
                if not all_shipped and merged_dev is not None:
                    mg2 = al.gather_merged_async(merged_dev,
                                                 demoted)()
                    merged["score"][demoted] = mg2[:, :, 0]
                    merged["pos"][demoted] = mg2[:, :, 1]
                    merged["fw"][demoted] = (mg2[:, :, 2] & 1) > 0
                    merged["gapped"][demoted] = (mg2[:, :, 2]
                                                 & 2) > 0
                # all-B grid ship (RNA SB=B): merged already holds
                # every row's grid — no gather needed
                allowed[demoted] = True
            newp = al.ssdb.added_since(prev_v)
            if newp.size:
                aff = allowed & al._spl_affected(merged, lens, newp)
                # previously-TRIGGERED affected rows only need the
                # new-site-implied lanes (precision host repair);
                # affected rows that never triggered (perfect score,
                # site newly in span) need full enumeration
                prevtrig = merged["score"][:, 0] < perfect_v
                newp_mask = aff & prevtrig & ~cleanup
                cleanup = cleanup | (aff & ~prevtrig)
            if demoted.size:
                cleanup[demoted] = True
                newp_mask[demoted] = False
        prev_n, prev_v = len(al.ssdb), al.ssdb.version()
        if not (cleanup.any() or newp_mask.any()):
            break
        if newp_mask.any():
            al._newp_rescue(batch, merged, newp_mask, newp)
        if cleanup.any():
            al._splice_rescue(batch, merged, rows=cleanup,
                              scan_covered=dev_lanes is not None)
        cleanup = np.zeros(B, bool)
    # ---- spliced-winner selection (columns) ----
    spl_map = merged.get("splice", {})
    swin = np.zeros(B, bool)       # spliced candidate wins selection
    svec = np.zeros(B, bool)       # eligible for vectorized finish
    vf: dict[int, dict] = {}
    msc0 = merged["score"][:, 0]
    for i, cands in spl_map.items():
        if not allowed[i]:
            continue
        c0 = cands[0]
        if not (not aligned[i] or c0["score"] > msc0[i]
                or (c0["score"] == msc0[i] and c0["canon"] == 1
                    and al.ssdb.is_baked(c0["posA"] + c0["j"] - 1,
                                         c0["posB"] + c0["j"]))):
            continue
        swin[i] = True
        if (len(cands) == 1 and "segs" not in c0
                and c0["score"] >= min_scs[i]):
            svec[i] = True
            vf[i] = c0
    # contiguous winners (and unaligned leftovers) rejoin the native
    # path; spliced winners + non-native-eligible rows handled below
    fast = (fastble | unal) & ~swin
    if force_slow is not None:
        fast &= ~force_slow
    vec_done = np.zeros(B, bool)
    if svec.any():
        vr = np.flatnonzero(svec)
        c0s = [vf[int(i)] for i in vr]
        vA = np.asarray([c["posA"] for c in c0s], np.int64)
        vB = np.asarray([c["posB"] for c in c0s], np.int64)
        vJ = np.asarray([c["j"] for c in c0s], np.int64)
        vF = np.asarray([c["fw"] for c in c0s], bool)
        vStr = np.asarray([c["strand"] for c in c0s])
        vSc = np.asarray([c["score"] for c in c0s], np.int32)
        fin2 = al._spliced_fin_rows(batch, vr, vA, vB, vJ, vF,
                                    vStr, lens[vr])
        okm = fin2["ok"].copy()
        # every contiguous placement must be redundant with the
        # spliced span (reference RedundantAlns start/end dedup,
        # pipeline._dedup_alns); rows keeping a real secondary fall
        # to the per-read ladder (genuinely multimapped junction
        # reads), as do rows with more placements than rep slots
        spl_start = vA + fin2["c5"]
        spl_end = vB + fin2["c5"] + fin2["mid"]
        nsurv = np.zeros(vr.size, np.int64)
        for k in range(KF):
            r = reps[k]
            in_rep = nrep[vr] > k
            st_k = r["astart"][vr]
            en_k = st_k + (lens[vr] - r["c5"][vr] - r["c3"][vr])
            same = ((r["fw"][vr] == vF) & ~r["gapped"][vr]
                    & ((st_k == spl_start) | (en_k == spl_end)))
            nsurv += (in_rep & ~same).astype(np.int64)
        okm &= (nsurv == 0) & (nrep[vr] <= KF)
        if okm.any():
            sel = np.flatnonzero(okm)
            elig = vr[sel]
            ntrip = np.diff(fin2["mm_off"])
            keep3 = np.repeat(okm, ntrip)
            mm_off2 = np.zeros(sel.size + 1, np.int64)
            np.cumsum(ntrip[sel], out=mm_off2[1:])
            flag2 = np.where(vF[sel], 0, 16).astype(np.int32)
            ones = np.ones(sel.size, np.int32)
            sbuf, sends = _format_records(
                al, batch, elig, elig, flag2,
                fin2["tidx"][sel], fin2["toff"][sel],
                60 * ones, fin2["c5"][sel], fin2["mid"][sel],
                fin2["c3"][sel], vSc[sel], fin2["nm"][sel],
                np.full(sel.size, INT32_MIN, np.int32), ones,
                fin2["mm_cols"][keep3], fin2["mm_ref"][keep3],
                mm_off2, m1=fin2["m1"][sel],
                gapn=fin2["gap"][sel], xs=fin2["xs"][sel])
            stext = sbuf.decode("ascii")
            prev = 0
            for kk, i in enumerate(elig):
                slow_out[int(i)] = [stext[prev:int(sends[kk])]]
                prev = int(sends[kk])
            vec_done[elig] = True
            stats["uniq"] += int(elig.size)
    # ---- per-read stragglers ----
    pr = np.flatnonzero(~fast & ~vec_done)
    if pr.size:
        res_map = al._finalize_results(batch, merged, only_rows=pr)
        for i in pr:
            i = int(i)
            res = res_map.get(i)
            if res is None:
                res = ReadResult(filtered=_filter_reason(batch, i,
                                                         lens))
            lines = _format_slow(al, batch, i, res, sc)
            if not res.aligned:
                stats["unal"] += 1
            elif len(res.alns) > 1 or (res.secbest is not None
                                       and res.secbest >= min_scs[i]):
                stats["multi"] += 1
            else:
                stats["uniq"] += 1
            slow_out[i] = lines
    fbuf, read_end = fmt_fast(fast)
    return _stitch_cols(writer, fbuf, fast, read_end, slow_out, stats)


def _stitch_cols(writer, fbuf: bytes, fast, read_end, slow_out: dict,
                 stats: dict) -> dict:
    """Write the column formatter's text of the fast reads and the ladder's
    lines of the slow ones in read order; returns `stats`."""
    w = writer.out.write
    if not slow_out:
        if fbuf:
            w(fbuf.decode("ascii"))
        return stats
    text = fbuf.decode("ascii") if fbuf else ""
    last_end = np.maximum.accumulate(np.where(fast, read_end, 0))
    prev_end = 0
    for i in sorted(slow_out):
        if text and i > 0:
            end = int(last_end[i - 1])
            if end > prev_end:
                w(text[prev_end:end])
                prev_end = end
        for ln in slow_out[i]:
            w(ln)
        if text and read_end[i] > 0:
            # demoted read (RNA second pass): its already-formatted native
            # record is replaced by the slow lines — skip its bytes
            prev_end = max(prev_end, int(read_end[i]))
    if text and prev_end < len(text):
        w(text[prev_end:])
    return stats


def _refname_cache(al):
    """Concatenated reference-name buffer + offsets (immutable per index)."""
    rc = getattr(al, "_rn_cache", None)
    if rc is None:
        ref = al.fm.ref
        rn_parts = [n.encode("ascii") for n in ref.names]
        rn_off = np.zeros(len(rn_parts) + 1, np.int64)
        np.cumsum([len(x) for x in rn_parts], out=rn_off[1:])
        rn_buf = np.frombuffer(b"".join(rn_parts), np.uint8)
        rc = al._rn_cache = (rn_buf, rn_off, np.diff(rn_off))
    return rc


def _format_slow(al, batch, i, res: ReadResult, sc) -> list[str]:
    ref = al.fm.ref
    name = batch.names[i]
    rdlen = int(batch.lens[i])
    seq = batch.seqs[i, :rdlen]
    qual = (batch.quals[i, :rdlen].astype(np.uint8) + 33
            ).tobytes().decode("ascii")
    if not res.aligned:
        return [samio.format_unaligned(name, seq, qual, yf=res.filtered)]
    # exhausted deliberately not passed: the reference's exhaustive[] flag
    # is initialized false and never set (hisat2.cpp:3259,3461), so its
    # MAPQ 60 fast path (unique.h:212) only fails on equal second-best
    mq = _mapq.mapq_v2(res.best, res.secbest, sc.perfect_score(rdlen),
                       sc.min_score(rdlen), local=sc.local)
    nh = len(res.alns)
    omit = al.opts.omit_sec_seq
    lines = []
    for k, aln in enumerate(res.alns):
        rec = samio.SamAlignment(
            rname=(aln.rname_override if aln.rname_override is not None
                   else ref.names[aln.tidx]),
            pos=aln.toff, fw=aln.fw,
            mapq=mq if k == 0 else 255, cigar=aln.cigar, score=aln.score,
            nmm=aln.nmm, gap_opens=aln.gap_opens, gap_exts=aln.gap_exts,
            md=aln.md, nm=aln.nm,
            zs=res.secbest if res.secbest is not None else None,
            xs_strand=aln.xs_strand, zs_snps=aln.zs_snps,
            nh=(aln.nh_override if aln.nh_override is not None else nh),
            secondary=k > 0)
        lines.append(samio.format_aligned(name, seq, qual, rec,
                                          omit_sec_seq=omit))
    return lines


def _align_and_emit_legacy(al: Aligner, batch: ReadBatch, writer) -> dict:
    """Unpacked-transfer SE path (seed_mode=False reaches it through
    submit_se): the aligner's device path on the unpacked batch, then a
    vectorized host selection of every read's reportable records (up to
    -k, ungapped, at most MAX_FAST_MM mismatches, inside one fragment)
    formatted natively from column arrays; the other reads take the
    ladder. Output order is read order."""
    B = len(batch)
    if al.opts.seed_mode:
        merged, fin = al.device_align_fused(batch)      # fin (B, KF, D)
    else:
        st, dp = al._device_align(batch)
        merged = al._merged_host(st, dp, B)
        fin = _stage_primary_fin(
            al.idx, al.sctab, st["seqs2"], st["quals2"], st["lens2"],
            al._up(merged["pos"][:, 0].astype(np.int32)),
            al._up(merged["fw"][:, 0], torch.bool), B
        ).cpu().numpy()[:, None, :]
    if al.opts.spliced:
        n_ss = len(al.ssdb)
        al._splice_rescue(batch, merged)
        if len(al.ssdb) != n_ss:
            al._splice_rescue(batch, merged)

    sc = al.scoring
    lens = batch.lens.astype(np.int64)
    L = batch.seqs.shape[1]
    min_scs = np.ceil(sc.score_min.I + sc.score_min.S * lens).astype(np.int64)
    nNs = ((batch.seqs >= 4)
           & (np.arange(L)[None, :] < lens[:, None])).sum(axis=1)
    filtered = (lens == 0) | (nNs > sc.n_ceil.I + sc.n_ceil.S * lens)

    msc, mpos = merged["score"], merged["pos"]
    mfw, mgap = merged["fw"], merged["gapped"]
    K2 = msc.shape[1]
    KF = fin.shape[1]
    khits = al.opts.khits
    aligned = ~filtered & (msc[:, 0] >= min_scs)

    # distinct-placement dedup across the merged top-K2 (same (pos, fw)
    # can reach the list via seed and DP routes)
    dup = np.zeros((B, K2), bool)
    for t in range(1, K2):
        eq = (mpos[:, :t] == mpos[:, t:t + 1]) & (mfw[:, :t] == mfw[:, t:t + 1])
        dup[:, t] = eq.any(axis=1)
    valid = (msc >= min_scs[:, None]) & ~dup
    nvalid = valid.sum(axis=1)
    nrep = np.minimum(nvalid, khits)

    # column index of the j-th valid entry per read
    vrank = np.where(valid, np.cumsum(valid, axis=1) - 1, K2 + 1)
    KFu = min(KF, khits)
    sel = np.full((B, KFu), K2, np.int64)
    for j in range(KFu):
        hit = vrank == j
        has = hit.any(axis=1)
        sel[has, j] = np.argmax(hit[has], axis=1)
    # 2nd distinct valid column (secbest for MAPQ/ZS, independent of -k)
    hit2 = vrank == 1
    sel2 = np.where(hit2.any(axis=1), np.argmax(hit2, axis=1), K2)

    # fast eligibility: every reported record is an ungapped, <=8-mismatch,
    # fragment-contained finalized candidate within the fin window
    fast = aligned & (nrep <= KFu)
    in_rep = (np.arange(KFu)[None, :] < nrep[:, None])
    selc = np.minimum(sel, K2 - 1)
    rows_all = np.arange(B)[:, None]
    fast &= ~(in_rep & (sel >= KF)).any(axis=1)
    fast &= ~(in_rep & mgap[rows_all, selc]).any(axis=1)
    F_c5 = np.take_along_axis(fin[:, :, 0], np.minimum(sel, KF - 1), 1)
    F_c3 = np.take_along_axis(fin[:, :, 1], np.minimum(sel, KF - 1), 1)
    F_nmm_all = np.take_along_axis(fin[:, :, 4], np.minimum(sel, KF - 1), 1)
    fast &= ~(in_rep & (F_nmm_all > MAX_FAST_MM)).any(axis=1)
    if _zs_run(al):
        fast[:] = False            # Zs tags come from the per-read path
    if al.opts.tmo:
        fast[:] = False            # --tmo: contiguous records never report
    if al.opts.omit_sec_seq:
        fast &= nrep <= 1          # secondary records go per-read
    spl = merged.get("splice", {})
    if spl:
        fast[np.fromiter(spl.keys(), dtype=np.int64)] = False

    # fragment containment of every reported record
    ref = al.fm.ref
    okf, fc, astart = _contain(ref, mpos[rows_all, selc], F_c5, F_c3, lens)
    fast &= ~(in_rep & ~okf).any(axis=1)

    stats = dict(reads=B, unal=0, uniq=0, multi=0)
    fbuf = b""
    read_end = np.zeros(B, np.int64)   # fbuf end offset per fast read
    frows = np.flatnonzero(fast)
    if frows.size:
        # flatten (read, k) -> records
        nr = nrep[frows]
        rec_read = np.repeat(frows, nr)                     # global read idx
        rec_lidx = np.repeat(np.arange(frows.size), nr)     # local fast idx
        rec_k = np.arange(rec_read.size) - np.repeat(
            np.concatenate([[0], np.cumsum(nr)[:-1]]), nr)
        col = sel[rec_read, rec_k]
        finc = fin[rec_read, col]
        c5 = finc[:, 0].astype(np.int32)
        c3 = finc[:, 1].astype(np.int32)
        nmm = finc[:, 3].astype(np.int32)
        nmm_all = finc[:, 4].astype(np.int32)
        score = msc[rec_read, col].astype(np.int32)
        fw = mfw[rec_read, col]
        mid = (lens[rec_read] - c5 - c3).astype(np.int32)
        fc_r = fc[rec_read, rec_k]
        tidx = ref.frag_tidx[fc_r].astype(np.int32)
        toff = (ref.frag_toff[fc_r] + astart[rec_read, rec_k]
                - ref.frag_joined[fc_r])
        flag = (np.where(fw, 0, 16) | np.where(rec_k > 0, 256, 0)
                ).astype(np.int32)
        nh = np.repeat(nr, nr).astype(np.int32)
        # best/secbest per read -> MAPQ (primary) / 255 (secondary), ZS.
        # The reference never sets its exhausted flag (hisat2.cpp:3259,
        # :3461), so the MAPQ 60 fast path (unique.h:212) fails only on an
        # equal-scoring second-best; only those reads need the table
        has_sec = nvalid[frows] >= 2
        best = msc[frows, 0]
        sec_col = np.minimum(sel2[frows], K2 - 1)
        secbest = np.where(has_sec, msc[frows, sec_col], INT32_MIN)
        mapq_read = np.full(frows.size, 60, np.int32)
        for j in np.flatnonzero(has_sec & (secbest == best)):
            ln = int(lens[frows][j])
            mapq_read[j] = _mapq.mapq_v2(
                int(best[j]), int(secbest[j]), sc.perfect_score(ln),
                sc.min_score(ln), local=sc.local, exhausted=False)
        mapq = np.where(rec_k == 0, mapq_read[rec_lidx], 255).astype(np.int32)
        zs = np.where(has_sec[rec_lidx], secbest[rec_lidx].astype(np.int64),
                      int(INT32_MIN)).astype(np.int32)

        # mismatch (col, refchar) pairs from the device finalization
        mc = finc[:, 5:5 + MAX_FAST_MM].astype(np.int32)
        mch = finc[:, 5 + MAX_FAST_MM:5 + 2 * MAX_FAST_MM].astype(np.int64)
        cnt = nmm_all.astype(np.int64)
        mm_off = np.zeros(rec_read.size + 1, np.int64)
        np.cumsum(cnt, out=mm_off[1:])
        selm = np.arange(MAX_FAST_MM)[None, :] < cnt[:, None]
        mm_cols2 = (mc[selm] - np.repeat(c5, cnt)).astype(np.int32)
        mm_ref2 = np.ascontiguousarray(_DEC_ASCII[np.clip(mch[selm], 0, 4)])

        fbuf, rec_ends = _format_records(
            al, batch, frows, rec_read, flag, tidx, toff, mapq, c5, mid, c3,
            score, nmm, zs, nh, mm_cols2, mm_ref2, mm_off)
        read_end[frows] = rec_ends[np.cumsum(nr) - 1]
        stats["uniq"] += int((nvalid[frows] == 1).sum())
        stats["multi"] += int((nvalid[frows] >= 2).sum())

    slow_out = _slow_ladder(al, batch, merged, np.flatnonzero(~fast),
                            filtered, min_scs, lens, stats, spl)
    _write_in_order(writer, fbuf, fast, read_end, slow_out)
    return stats


def _seq_orientations(raw, quals, lens):
    """SEQ and QUAL text of every row in both orientations, packed by true
    length: (seq_f, qual_f, seq_r, qual_r, offsets (N + 1,))."""
    N, Lp = raw.shape
    ar = np.arange(Lp)
    in_read = ar[None, :] < lens[:, None]
    seq_f = _DEC_ASCII[np.clip(raw, 0, 4)]
    qual_f = (np.clip(quals, 0, 93) + 33).astype(np.uint8)
    if N and (lens == lens[0]).all():
        # uniform read length (the common batch): reversal is a plain flip
        l0 = int(lens[0])
        seq_r = np.zeros_like(seq_f)
        qual_r = np.zeros_like(qual_f)
        seq_r[:, :l0] = _COMP_ASCII[seq_f[:, l0 - 1::-1]]
        qual_r[:, :l0] = qual_f[:, l0 - 1::-1]
    else:
        rcidx = np.clip(lens[:, None] - 1 - ar[None, :], 0, Lp - 1)
        seq_r = _COMP_ASCII[np.take_along_axis(seq_f, rcidx, 1)]
        qual_r = np.take_along_axis(qual_f, rcidx, 1)
    seq_off = np.zeros(N + 1, np.int64)
    np.cumsum(lens, out=seq_off[1:])
    return (np.ascontiguousarray(seq_f[in_read]),
            np.ascontiguousarray(qual_f[in_read]),
            np.ascontiguousarray(seq_r[in_read]),
            np.ascontiguousarray(qual_r[in_read]), seq_off)


def _format_records(al, batch, frows, rec_read, flag, tidx, toff, mapq,
                    c5, mid, c3, score, nmm, zs, nh, mm_cols, mm_ref, mm_off,
                    m1=None, gapn=None, xs=None):
    """Column arrays -> native formatter (format_se_batch2). frows: fast
    read indices (name/seq data is per read); rec_*: per-record arrays
    with read indices; m1/gapn/xs: spliced-record columns (one intron and
    the XS:A strand). Returns (SAM bytes, end offset of every record)."""
    Nf = frows.size
    lens = batch.lens.astype(np.int64)[frows]
    name_buf, name_off, name_lens = _name_buf(
        [batch.names[int(i)] for i in frows])
    sf, qf, sr, qr, seq_off = _seq_orientations(
        batch.seqs[frows], batch.quals[frows], lens)

    # map global read idx -> local fast idx for the C indirection
    l_of = np.zeros(int(frows.max()) + 1 if Nf else 1, np.int64)
    l_of[frows] = np.arange(Nf)
    read_of = l_of[rec_read].astype(np.int32)

    rn_buf, rn_off, rn_lens = _refname_cache(al)
    nrec = rec_read.size
    per_rec = (240 + name_lens[read_of] + rn_lens[tidx]
               + 2 * lens[read_of] + 12 * np.diff(mm_off))
    cap = int(per_rec.sum()) + 1024
    z = np.zeros(nrec, np.int32)
    m1, gapn, xs = (z if a is None else np.ascontiguousarray(
        a.astype(np.int32)) for a in (m1, gapn, xs))
    out = ctypes.create_string_buffer(cap)
    ends = np.zeros(nrec, np.int64)
    total = samfmt_lib().format_se_batch2(
        np.int32(nrec), read_of, flag,
        np.ascontiguousarray(tidx.astype(np.int32)),
        np.ascontiguousarray((toff + 1).astype(np.int32)),
        mapq, c5, mid, c3, score, nmm, nmm, zs, nh,
        name_buf, name_off, sf, qf, sr, qr, seq_off,
        np.ascontiguousarray(mm_cols), mm_ref, mm_off,
        np.ascontiguousarray(rn_buf), rn_off,
        out, np.int64(cap), ends, m1, gapn, xs)
    if total < 0:
        raise RuntimeError("format_se_batch2: SAM buffer overflow")
    return out.raw[:total], ends


def _format_records3(al, batch, frows, rec_read, flag, tidx, toff, mapq,
                     c5, mid, c3, score, nmm, zs, nh, mm_lanes, mm_cnt):
    """Threaded native formatter (format_se_batch3): takes the batch's raw
    code/quality arrays and the fastpack's mismatch lanes, decodes SEQ and
    QUAL in both orientations, assembles MD and formats the records with
    the GIL released. Returns (SAM bytes, end offset of every record)."""
    Nf = frows.size
    lens_l = batch.lens.astype(np.int32)[frows]
    name_buf, name_off, name_lens = _name_buf(
        [batch.names[int(i)] for i in frows])
    l_of = np.zeros(int(frows.max()) + 1 if Nf else 1, np.int64)
    l_of[frows] = np.arange(Nf)
    read_of = l_of[rec_read].astype(np.int32)

    rn_buf, rn_off, rn_lens = _refname_cache(al)
    nrec = rec_read.size
    per_rec = (240 + name_lens[read_of]
               + np.where(tidx >= 0, rn_lens[np.clip(tidx, 0, None)], 0)
               + 2 * lens_l[read_of].astype(np.int64)
               + 12 * mm_cnt.astype(np.int64))
    cap = int(per_rec.sum()) + 1024
    q = batch.quals
    qconst = -1
    if q.size and bool((q == q.flat[0]).all()):
        qconst = int(q.flat[0])
    z = np.zeros(nrec, np.int32)
    out = ctypes.create_string_buffer(cap)
    ends = np.zeros(nrec, np.int64)
    seqs = batch.seqs if batch.seqs.dtype == np.uint8 \
        else batch.seqs.astype(np.uint8)
    total = samfmt_lib().format_se_batch3(
        np.int32(nrec), np.int32(3), read_of, flag,
        np.ascontiguousarray(tidx.astype(np.int32)),
        np.ascontiguousarray((toff + 1).astype(np.int32)),
        mapq, c5, mid, c3, score, nmm, zs, nh,
        np.ascontiguousarray(mm_lanes),
        np.ascontiguousarray(mm_cnt.astype(np.int32)),
        np.int32(mm_lanes.shape[1] if mm_lanes.ndim == 2 else FASTPACK_MM),
        name_buf, name_off,
        np.ascontiguousarray(frows.astype(np.int32)),
        np.ascontiguousarray(seqs), np.ascontiguousarray(_u8(q)),
        np.int32(qconst), np.int64(seqs.shape[1]), lens_l,
        rn_buf, rn_off, out, np.int64(cap), ends, z, z, z)
    if total < 0:
        raise RuntimeError("format_se_batch3: SAM buffer overflow")
    return out.raw[:total], ends


# ---------------------------------------------------------------------------
# Paired-end
# ---------------------------------------------------------------------------



def align_and_emit_pe(al: Aligner, b1: ReadBatch, b2: ReadBatch,
                      writer) -> dict:
    """Align one PE batch pair (two batchify'd mate batches with the same
    pad_to) and emit SAM; returns the summary-stats dict."""
    return finish_pe(al, submit_pe(al, b1, b2), writer)


def _pe_rna_ok(al: Aligner) -> bool:
    """Spliced PE batches take the vectorized path (paired_rna) unless
    --tmo or Zs:Z tags on a graph index send them to the per-pair ladder
    (pairs_to_sam filters), or seed_mode=False to the per-read path."""
    o = al.opts
    return o.spliced and o.seed_mode and not o.tmo and not _zs_run(al)


def submit_pe(al: Aligner, b1: ReadBatch, b2: ReadBatch):
    """Queue one PE batch pair's device step: in RNA mode the spliced
    step over both mates (paired_rna.submit_pe_rna), else the packed step
    for constant-quality batches. Pair with finish_pe. The other batches
    are aligned at finish time (_align_and_emit_pe_legacy): seed_mode=False
    and --tmo on the per-pair path, Zs:Z-tag runs on a graph index, DNA
    batches with known splice sites (TLEN leaves out their introns) and
    per-base qualities on the fused step."""
    o = al.opts
    if _pe_rna_ok(al):
        return _prna.submit_pe_rna(al, b1, b2)
    if not o.seed_mode or o.tmo or _zs_run(al) or len(al.ssdb):
        return ("legacy", b1, b2)
    out = _paired.stage_pe_packed(al, b1, b2, KP=max(8, o.khits + 3))
    if out is None:                      # per-base qualities
        return ("legacy", b1, b2)
    return ("fast", b1, b2, out)


def finish_pe(al: Aligner, handle, writer) -> dict:
    if handle[0] == "legacy":
        return _align_and_emit_pe_legacy(al, handle[1], handle[2], writer)
    if handle[0] == "rna":
        return _prna.finish_pe_rna(al, handle, writer)
    _, b1, b2, out = handle
    ready = out[5]
    t0 = time.perf_counter()
    if ready is not None:
        ready.synchronize()
    al.metrics.t_fetch += time.perf_counter() - t0
    st = _finish_pe_pack(al, b1, b2, out, writer)
    al.metrics.t_host += time.perf_counter() - t0
    return st


def align_and_emit_pe_stream(al: Aligner, pair_batches, writer,
                             on_batch=None, depth: int = 4,
                             workers: int = 3) -> dict:
    """Pipelined PE loop over (mate-1 batch, mate-2 batch) tuples, the
    same overlap structure as the SE stream: finish halves run in
    `workers` threads, output replays in submit order; depth = max
    queued-but-unfinished batch pairs. In RNA mode finishes run serially
    with one batch in flight, as in the SE stream: the splice rescue adds
    to the novel-site table, so a threaded finish would make the bytes
    depend on timing."""
    if al.opts.spliced:
        workers = 0
        depth = min(depth, 1)
    return _stream(al, iter(pair_batches), writer, submit_pe, finish_pe,
                   on_batch, depth, workers)


def _batch_qconst(batch) -> int:
    q = batch.quals
    return int(q.flat[0]) if q.size and bool((q == q.flat[0]).all()) else -1


def _name_buf(names):
    """Concatenated ASCII names + offsets for the native formatters."""
    nb = np.array(names, dtype="S255")
    name_lens = np.char.str_len(nb).astype(np.int64)
    name_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum(name_lens, out=name_off[1:])
    wide = nb.view(np.uint8).reshape(len(names), -1)
    name_buf = np.ascontiguousarray(
        wide[np.arange(wide.shape[1])[None, :] < name_lens[:, None]])
    return name_buf, name_off, name_lens


def _u8(a):
    return a.view(np.uint8) if a.dtype == np.int8 else \
        np.ascontiguousarray(a.astype(np.uint8))


def _native_fast_pe(al, b1, b2, fp, ex, NRB, force_slow=None):
    """One-call native PE fast path (finish_pe_native): pair-pack ->
    fast-pair mask + interleaved concordant records + SAM bytes + stats
    with the GIL released. force_slow marks pairs that must take the
    ladder (the sharded merge's cross-shard multi-placements). Returns
    (fast, fbuf, pair_end, stats)."""
    lib = samfmt_lib()
    B = len(b1)
    o = al.opts
    sc = al.scoring
    ref = al.fm.ref

    z_i32 = np.zeros(0, np.int32)
    z_i16 = np.zeros(0, np.int16)
    t0r, t0p, tn0, tk00, tk10 = z_i32, z_i16, 0, NRB, NRB
    t1r, t1p, tn1, tk01, tk11 = z_i32, z_i16, 0, NRB, NRB
    NR = NRB
    if ex is not None and "mrep0" in ex:
        t0r = np.ascontiguousarray(ex["mrows0"].astype(np.int32))
        t0p = np.ascontiguousarray(ex["mrep0"].astype(np.int16))
        tn0 = t0r.size
        nb0 = t0p.shape[1] // PEPACK_REP if t0p.ndim == 2 else 0
        tk00, tk10 = NR, NR + nb0
        NR += nb0
        if "mrep1" in ex:
            t1r = np.ascontiguousarray(ex["mrows1"].astype(np.int32))
            t1p = np.ascontiguousarray(ex["mrep1"].astype(np.int16))
            tn1 = t1r.size
            nb1 = t1p.shape[1] // PEPACK_REP if t1p.ndim == 2 else 0
            tk01, tk11 = NR, NR + nb1
            NR += nb1

    name_buf, name_off, _ = _name_buf(b1.names)
    rn_buf, rn_off, rn_lens = _refname_cache(al)
    qc1, qc2 = _batch_qconst(b1), _batch_qconst(b2)
    qconst = qc1 if (qc1 >= 0 and qc1 == qc2) else -1
    s1 = b1.seqs if b1.seqs.dtype == np.uint8 else b1.seqs.astype(np.uint8)
    s2 = b2.seqs if b2.seqs.dtype == np.uint8 else b2.seqs.astype(np.uint8)
    L1, L2 = s1.shape[1], s2.shape[1]

    # scratch is per call: finishes run concurrently in worker threads
    capr = B * 2 * max(NR, 1)
    maxrn = int(rn_lens.max()) if rn_lens.size else 1
    cap = int(capr * (252 + maxrn + 2 * max(L1, L2) + 12 * PEPACK_MM + 255)
              + 4096)
    cols = np.zeros(14 * capr, np.int32)
    mm_out = np.zeros(capr * PEPACK_MM, np.int16)
    rec_ends = np.zeros(capr, np.int64)
    outbuf = ctypes.create_string_buffer(cap)

    fast_u8 = np.zeros(B, np.uint8)
    pair_end = np.zeros(B, np.int64)
    stats_a = np.zeros(4, np.int64)
    total = lib.finish_pe_native(
        np.int32(B), np.int64(L1), np.int64(L2), np.int32(3),
        np.ascontiguousarray(fp), np.int32(fp.shape[1]), np.int32(NRB),
        t0r, t0p, np.int32(tn0), np.int32(tk00), np.int32(tk10),
        t1r, t1p, np.int32(tn1), np.int32(tk01), np.int32(tk11),
        np.ascontiguousarray(s1), _u8(b1.quals),
        np.ascontiguousarray(b1.lens.astype(np.int64)),
        np.ascontiguousarray(s2), _u8(b2.quals),
        np.ascontiguousarray(b2.lens.astype(np.int64)),
        np.int32(qconst),
        np.ascontiguousarray(ref.frag_joined),
        np.ascontiguousarray(ref.frag_len.astype(np.int64)),
        np.ascontiguousarray(ref.frag_toff),
        np.ascontiguousarray(ref.frag_tidx.astype(np.int32)),
        np.int32(ref.frag_joined.size),
        rn_buf, rn_off, name_buf, name_off,
        float(sc.score_min.I), float(sc.score_min.S),
        np.int32(sc.match_bonus), np.int32(o.khits), np.int32(NR),
        np.int32(1 if o.omit_sec_seq else 0),
        np.zeros(B, np.uint8) if force_slow is None else
        np.ascontiguousarray(np.asarray(force_slow).astype(np.uint8)),
        fast_u8, pair_end, outbuf, np.int64(cap), stats_a,
        cols, mm_out, rec_ends)
    if total < 0:
        raise RuntimeError("finish_pe_native: SAM buffer overflow")
    stats = _paired.new_pair_stats()
    stats["pairs"] += int(stats_a[0])
    stats["mates_al"] += 2 * int(stats_a[0])
    stats["conc_uniq"] += int(stats_a[1])
    stats["conc_multi"] += int(stats_a[2])
    fbuf = ctypes.string_at(ctypes.addressof(outbuf), int(total))
    return fast_u8.astype(bool), fbuf, pair_end, stats


def _numpy_fast_pe(al, b1, b2, fp, ex, NRB, force_slow=None):
    """The PE fast path in NumPy (hisat2_tpu's _finish_pe_pack when its
    native path stands aside, as it does in local mode): the same fast-pair
    test and concordant records as _native_fast_pe, formatted by
    _format_pe_records. Returns (fast, fbuf, pair_end, stats)."""
    B = len(b1)
    o = al.opts
    sc = al.scoring
    khits = o.khits
    # tiered multi-pair buckets (stage_pe_packed MB extras): tier t
    # carries a slice of reports >= NRB, scattered to full-B lanes here
    tier_rows: list = []
    tier_reps: list = []
    tier_has: list = []
    k_tier: dict[int, tuple] = {}
    NR = NRB
    if ex is not None:
        t = 0
        while f"mrep{t}" in ex:
            rows_t = ex[f"mrows{t}"]
            rep_t = ex[f"mrep{t}"].reshape(rows_t.size, -1, PEPACK_REP)
            has_t = np.zeros(B, bool)
            has_t[rows_t[rows_t >= 0]] = True
            tier_rows.append(rows_t)
            tier_reps.append(rep_t)
            tier_has.append(has_t)
            for c in range(rep_t.shape[1]):
                k_tier[NR + c] = (t, c)
            NR += rep_t.shape[1]
            t += 1
    l1 = b1.lens.astype(np.int64)
    l2 = b2.lens.astype(np.int64)
    nvalid = fp[:, 0].astype(np.int64)
    best = fp[:, 1].astype(np.int64)
    sec = fp[:, 2].astype(np.int64)
    has_sec = sec != -32768

    def mate(k, m):
        if k < NRB:
            rb = PEPACK_HDR + PEPACK_REP * k
            lanes = fp[:, rb:rb + PEPACK_REP].astype(np.int64)
        else:
            # scatter the bucket report to full-B lanes (garbage outside
            # bucket rows; fast-path eligibility masks with tier_has)
            ti, c = k_tier[k]
            rows_t, rep_t = tier_rows[ti], tier_reps[ti]
            bokt = rows_t >= 0
            lanes = np.zeros((B, PEPACK_REP), np.int64)
            lanes[rows_t[bokt]] = rep_t[bokt, c].astype(np.int64)
        b0 = 1 + PEPACK_MATE * m
        rfl = lanes[:, 0]
        lo = lanes[:, b0].astype(np.uint16).astype(np.uint32)
        hi = lanes[:, b0 + 1].astype(np.uint16).astype(np.uint32)
        return dict(
            pos=(lo | (hi << 16)).astype(np.int64),
            c5=lanes[:, b0 + 2],
            c3=lanes[:, b0 + 3],
            nmm=lanes[:, b0 + 4],
            nmm_all=lanes[:, b0 + 5],
            score=lanes[:, b0 + 6],
            mm=lanes[:, b0 + 7:b0 + 7 + PEPACK_MM],
            fw=(rfl >> (2 * m)) & 1 > 0,
            gapped=(rfl >> (2 * m + 1)) & 1 > 0)
    reps = [[mate(k, m) for m in (0, 1)] for k in range(NR)]

    conc = nvalid >= 1
    nrep = np.minimum(nvalid, khits)
    fast = conc & (nrep <= NR)
    if o.omit_sec_seq:
        fast &= nrep <= 1
    if force_slow is not None:
        # cross-shard multi-placement pairs: NH and report interleaving
        # need the exact per-pair path
        fast &= ~np.asarray(force_slow)
    ref = al.fm.ref
    for k in range(NR):
        r1, r2 = reps[k]
        ok1, fc1, as1 = _contain(ref, r1["pos"][:, None], r1["c5"][:, None],
                                 r1["c3"][:, None], l1)
        ok2, fc2, as2 = _contain(ref, r2["pos"][:, None], r2["c5"][:, None],
                                 r2["c3"][:, None], l2)
        r1["fc"], r1["astart"] = fc1[:, 0], as1[:, 0]
        r2["fc"], r2["astart"] = fc2[:, 0], as2[:, 0]
        okk = (ok1[:, 0] & ok2[:, 0]
               & (ref.frag_tidx[r1["fc"]] == ref.frag_tidx[r2["fc"]])
               & ~r1["gapped"] & ~r2["gapped"]
               & (r1["nmm_all"] <= PEPACK_MM)
               & (r2["nmm_all"] <= PEPACK_MM))
        if k >= NRB:
            okk &= tier_has[k_tier[k][0]]
        fast &= (nrep <= k) | okk

    mqc = _MapqCache(sc)
    stats = _paired.new_pair_stats()
    fbuf = b""
    pair_end = np.zeros(B, np.int64)
    frows = np.flatnonzero(fast)
    if frows.size:
        nr = nrep[frows]
        rec_pair = np.repeat(frows, nr)
        rec_k = np.arange(rec_pair.size) - np.repeat(
            np.concatenate([[0], np.cumsum(nr)[:-1]]), nr)
        nrec = rec_pair.size

        def take(m, fld):
            arrs = np.stack([reps[k][m][fld] for k in range(NR)])
            if arrs.ndim == 2:
                return arrs[rec_k, rec_pair]
            return arrs[rec_k, rec_pair, :]

        toff, cc5, cc3, mids, fws, tidxs, scs, nmms, mms = ([] for _ in
                                                            range(9))
        for m, lm in ((0, l1), (1, l2)):
            fc = take(m, "fc")
            astart = take(m, "astart")
            toff.append(ref.frag_toff[fc] + astart - ref.frag_joined[fc])
            tidxs.append(ref.frag_tidx[fc].astype(np.int32))
            c5m = take(m, "c5").astype(np.int32)
            c3m = take(m, "c3").astype(np.int32)
            cc5.append(c5m)
            cc3.append(c3m)
            mids.append((lm[rec_pair] - c5m - c3m).astype(np.int32))
            fws.append(take(m, "fw"))
            scs.append(take(m, "score").astype(np.int32))
            nmms.append(take(m, "nmm").astype(np.int32))
            mmp = take(m, "mm")
            cnt = take(m, "nmm_all").astype(np.int64)
            off_m = np.zeros(nrec + 1, np.int64)
            np.cumsum(cnt, out=off_m[1:])
            selm = np.arange(PEPACK_MM)[None, :] < cnt[:, None]
            vals = mmp[selm]
            mms.append(((vals >> 3) - np.repeat(c5m, cnt)).astype(np.int32))
            mms.append(np.ascontiguousarray(
                _DEC_ASCII[np.clip(vals & 7, 0, 4)]))
            mms.append(off_m)
            mms.append(cnt)

        left = np.minimum(toff[0] - cc5[0], toff[1] - cc5[1])
        right = np.maximum(toff[0] + mids[0] + cc3[0],
                           toff[1] + mids[1] + cc3[1])
        tl = right - left
        tl1 = np.where(toff[0] <= toff[1], tl, -tl)

        bt = best[frows]
        st_ = sec[frows]
        need_tab = (has_sec & (sec == best))[frows]
        mapq_pair = np.full(frows.size, 60, np.int32)
        for j in np.flatnonzero(need_tab):
            i = frows[j]
            mapq_pair[j] = mqc.get(
                int(bt[j]), int(st_[j]), None, False,
                perfect=sc.perfect_score(int(l1[i]))
                + sc.perfect_score(int(l2[i])),
                minsc=sc.min_score(int(l1[i])) + sc.min_score(int(l2[i])))
        pairloc = np.zeros(int(frows.max()) + 1, np.int64)
        pairloc[frows] = np.arange(frows.size)
        mq_rec = np.where(rec_k == 0, mapq_pair[pairloc[rec_pair]],
                          255).astype(np.int32)

        flag1 = (1 | 64 | 2 | np.where(fws[0], 0, 16)
                 | np.where(fws[1], 0, 32)
                 | np.where(rec_k > 0, 256, 0)).astype(np.int32)
        flag2 = (1 | 128 | 2 | np.where(fws[1], 0, 16)
                 | np.where(fws[0], 0, 32)
                 | np.where(rec_k > 0, 256, 0)).astype(np.int32)
        nh = np.repeat(nr, nr).astype(np.int32)

        def ilv(a1, a2):
            z = np.empty(2 * nrec, a1.dtype)
            z[0::2] = a1
            z[1::2] = a2
            return z

        immoff = np.zeros(2 * nrec + 1, np.int64)
        immoff[1::2] = mms[3]
        immoff[2::2] = mms[7]
        np.cumsum(immoff, out=immoff)
        immcols, immref = _interleave_runs(
            (mms[0], mms[1], mms[2], mms[3]),
            (mms[4], mms[5], mms[6], mms[7]), nrec)
        fbuf, rec_ends = _format_pe_records(
            al, b1, b2, frows,
            ilv(rec_pair.astype(np.int32) * 2,
                rec_pair.astype(np.int32) * 2 + 1),
            ilv(flag1, flag2), ilv(tidxs[0], tidxs[1]),
            ilv((toff[0] + 1).astype(np.int32),
                (toff[1] + 1).astype(np.int32)),
            ilv(mq_rec, mq_rec), ilv(cc5[0], cc5[1]),
            ilv(mids[0], mids[1]), ilv(cc3[0], cc3[1]),
            ilv((toff[1] + 1).astype(np.int32),
                (toff[0] + 1).astype(np.int32)),
            ilv(tl1.astype(np.int32), (-tl1).astype(np.int32)),
            np.full(2 * nrec, 1, np.int32), ilv(scs[0], scs[1]),
            ilv(nmms[0], nmms[1]), np.full(2 * nrec, INT32_MIN, np.int32),
            ilv(nh, nh), immcols, immref, immoff)
        last_rec = 2 * np.cumsum(nr) - 1
        pair_end[frows] = rec_ends[last_rec]
        stats["pairs"] += int(frows.size)
        stats["mates_al"] += 2 * int(frows.size)
        multi = nvalid[frows] >= 2
        stats["conc_multi"] += int(multi.sum())
        stats["conc_uniq"] += int((~multi).sum())
    return fast, fbuf, pair_end, stats


def _finish_pe_pack(al: Aligner, b1: ReadBatch, b2: ReadBatch, out,
                    writer, force_slow=None) -> dict:
    """Host half of the packed PE step: decode the wire-coded pack,
    format the fast pairs natively, run the slow pairs' ladder, and stitch
    output in pair order.

    The sharded finish passes out = (pack, m1, m2, pair_top, None, None)
    as numpy arrays merged on the host (int16 pack, global coordinates)
    and a force_slow mask of its cross-shard multi-placement pairs."""
    pack, _m1, _m2, _pt, extras, _ready = out
    if isinstance(pack, np.ndarray):
        fp, ex = pack, None
    else:
        fp = pack.numpy()
        ex = {k: v.numpy() for k, v in extras.items() if k != "_wire"}
    if torch.is_tensor(pack) and pack.dtype == torch.int32:
        # wire-coded copy (ops/wire.py): expand to int16 lanes
        fp = _wire.as_words(fp)
        Lw, nvb = extras["_wire"]
        fp = _wire.pe_pack_decode(fp, Lw, Lw, nvb)
        NWr = _wire.n_words(_wire.pe_rep_table(Lw, Lw))
        t = 0
        while f"mrep{t}" in ex:
            wr = _wire.as_words(ex[f"mrep{t}"])
            ex[f"mrep{t}"] = _wire.pe_rep_decode(wr, Lw, Lw,
                                                 wr.shape[1] // NWr)
            t += 1
    NRB = _paired.pepack_nr(fp.shape[1])     # report slots in the base pack
    # local mode takes the NumPy fast path, as in hisat2_tpu
    fast_pe = _numpy_fast_pe if al.scoring.local else _native_fast_pe
    fast, fbuf, pair_end, stats = fast_pe(al, b1, b2, fp, ex, NRB,
                                          force_slow)
    return _finish_pe_slow_and_stitch(
        al, b1, b2, ex, out, writer, fast, fp[:, -1].astype(np.int64),
        fp[:, 0].astype(np.int64), b1.lens.astype(np.int64),
        b2.lens.astype(np.int64), fbuf, pair_end, stats)


def _pe_mixed_vec(al, b1, b2, slow, nvalid, m1h, m2h, l1, l2, ex, stats):
    """Vectorized mixed/unaligned resolution for no-concordant slow
    pairs: a byte-identical replica of the _pair_result_one ->
    _mate_result -> pair_lines chain for the two bulk categories:

    * neither mate has a valid candidate  -> two flag-4 records
    * exactly one mate aligned AND the in-step rescue DP (the rescue
      extras) provably failed (score below the mate's minimum) AND all
      reportable candidates are ungapped -> one aligned + one unaligned
      record (YT:Z:UP), NH/ZS/MAPQ per _dedup_alns semantics

    Everything else (rescue successes, discordant, gapped, local
    mode) stays with the
    per-pair ladder. Returns ({row: [sam_text]}, remaining_slow_rows).
    """
    o = al.opts
    sc = al.scoring
    if (o.no_mixed or o.tmo or sc.local or o.zs_tags
            or slow.size == 0):
        return {}, slow
    S = slow[nvalid[slow] == 0]
    if S.size == 0:
        return {}, slow

    def minv(lens):
        u, inv = np.unique(lens, return_inverse=True)
        vals = np.array([sc.min_score(int(x)) for x in u], np.int64)
        return vals[inv]

    min1 = minv(l1[S])
    min2 = minv(l2[S])
    v1 = m1h["score"][S] >= min1[:, None]
    v2 = m2h["score"][S] >= min2[:, None]
    has1 = v1.any(1)
    has2 = v2.any(1)

    # ---- both mates unaligned ----
    unal_rows = S[~has1 & ~has2]
    # ---- one mate aligned: rescue-failure proof via the rescue extras ----
    rmap = np.full(len(b1), -1, np.int64)
    rr = None
    if ex is not None and "rescue" in ex:
        rr = np.asarray(ex["rescue"]).astype(np.int64)
        rok = rr[:, 0] >= 0
        rmap[rr[rok, 0]] = np.flatnonzero(rok)
    L = max(b1.seqs.shape[1], b2.seqs.shape[1])
    W = _paired.rescue_width(o, L)
    groups = []          # (rows_global, anchored_mate01, m, batch, lens, minsc)
    for anch01, om, mh, bb, lm, mn, lo in (
            (0, has1 & ~has2, m1h, b1, l1, min1, l2),
            (1, has2 & ~has1, m2h, b2, l2, min2, l1)):
        rows_l = np.flatnonzero(om)          # indices into S
        if rows_l.size == 0 or rr is None:
            continue
        rg = S[rows_l]
        v = (v1 if anch01 == 0 else v2)[rows_l]
        k0 = np.argmax(v, axis=1)
        pos0 = mh["pos"][rg, k0]
        fw0 = mh["fw"][rg, k0]
        g0 = mh["gapped"][rg, k0]
        ext = lm[rg]
        wstart = np.where(fw0, pos0, pos0 + ext - W)
        mate_fw = ~fw0
        j = rmap[rg]
        ent_ok = j >= 0
        jj = np.clip(j, 0, max(len(rr) - 1, 0))
        # rescue row [1] is "mate 1 anchored", i.e. 1 when the anchored
        # mate's index is 0
        ent_ok &= (rr[jj, 1] == (1 - anch01)) & (rr[jj, 7] == wstart) \
            & (rr[jj, 8].astype(bool) == mate_fw)
        failed = rr[jj, 2] < minv(lo[rg])
        pick = ent_ok & failed & ~g0
        if not pick.any():
            continue
        groups.append((rg[pick], anch01, mh, bb, lm, mn[rows_l][pick]))

    if unal_rows.size == 0 and not groups:
        return {}, slow

    # ---- per-group candidate selection (mate_cands replica) ----
    kcap = min(o.khits + 1, o.top_cands)
    MMX = 16
    # per emitted pair, two records as column tuples: (mate, flag, rname,
    # pos1, mapq, c5, mid, c3, rnext, pn1, score, zs, nmm, nh, cnt, lanes)
    rec_cols: list[tuple] = []
    row_order: list[int] = []     # global row per emitted pair, in order

    for rg, anch01, mh, bb, lm, mins in groups:
        R = rg.size
        pos = mh["pos"][rg]
        fw = mh["fw"][rg]
        gp = mh["gapped"][rg]
        scg = mh["score"][rg]
        v = scg >= mins[:, None]
        K = pos.shape[1]
        same = (pos[:, :, None] == pos[:, None, :]) \
            & (fw[:, :, None] == fw[:, None, :])
        lower = np.tril(np.ones((K, K), bool), -1)[None]
        dup = (same & v[:, None, :] & lower).any(2)
        keep = v & ~dup
        rank = np.cumsum(keep, axis=1)
        keep &= rank <= o.top_cands
        sel = keep & (rank <= kcap)
        # rows needing a gapped finalize go to the ladder
        bad = (sel & gp).any(1)
        # flatten items row-major (candidate order preserved)
        rloc, kidx = np.nonzero(sel & ~bad[:, None])
        if rloc.size == 0:
            continue
        ridx = rg[rloc]
        upos = pos[rloc, kidx]
        ufw = fw[rloc, kidx]
        A = al._ungapped_arrays(bb, ridx, upos, ufw, lm[ridx])
        mm_rows, mm_cols = A["mm_rows"], A["mm_cols"]
        mm_ref = A["mm_ref"]
        cnt_item = np.bincount(mm_rows, minlength=rloc.size)
        mm_off = np.zeros(rloc.size + 1, np.int64)
        np.cumsum(cnt_item, out=mm_off[1:])
        spans = lm[ridx] - A["c5"] - A["c3"]
        starts_i = np.searchsorted(rloc, np.arange(R))
        ends_i = np.searchsorted(rloc, np.arange(R), side="right")
        for rl in range(R):
            grow = int(rg[rl])
            if bad[rl]:
                continue
            i0, i1 = int(starts_i[rl]), int(ends_i[rl])
            items = [t for t in range(i0, i1) if A["ok"][t]]
            if not items or any(cnt_item[t] > MMX for t in items):
                continue
            iscore = A["score"]
            order = sorted(items, key=lambda t: -int(iscore[t]))
            sset, eset = set(), set()
            surv = []
            for t in order:
                ks = (int(A["astart"][t]), bool(ufw[t]))
                ke = (int(A["astart"][t] + spans[t]), bool(ufw[t]))
                if ks in sset or ke in eset:
                    continue
                sset.add(ks)
                eset.add(ke)
                surv.append(t)
            best = int(iscore[surv[0]])
            secbest = int(iscore[surv[1]]) if len(surv) > 1 else None
            nh = min(len(surv), o.khits)
            t0 = surv[0]
            ln = int(lm[grow])
            mq = _mapq.mapq_v2(best, secbest, sc.perfect_score(ln),
                               sc.min_score(ln), local=sc.local)
            tidx = int(A["tidx"][t0])
            toff = int(A["toff"][t0])
            afw = bool(ufw[t0])
            c5v, c3v = int(A["c5"][t0]), int(A["c3"][t0])
            lanes = ((mm_cols[mm_off[t0]:mm_off[t0 + 1]]
                      .astype(np.int64) << 3)
                     | mm_ref[mm_off[t0]:mm_off[t0 + 1]].astype(np.int64))
            base_fl = 1 | (64 if anch01 == 0 else 128)
            al_fl = base_fl | 8 | (0 if afw else 16)
            un_fl = (1 | 4 | (128 if anch01 == 0 else 64))
            al_rec = (anch01, al_fl, tidx, toff + 1, mq, c5v,
                      ln - c5v - c3v, c3v, 1, toff + 1, int(A["score"][t0]),
                      secbest if secbest is not None else INT32_MIN,
                      int(A["nmm"][t0]), nh, int(cnt_item[t0]),
                      lanes.astype(np.int16))
            un_rec = (1 - anch01, un_fl, tidx, toff + 1, 0, 0, 0, 0,
                      1, toff + 1, 0, INT32_MIN, 0, 1, 0,
                      np.zeros(0, np.int16))
            pair_recs = (al_rec, un_rec) if anch01 == 0 else \
                (un_rec, al_rec)
            row_order.append(grow)
            rec_cols.append(pair_recs)
            stats["pairs"] += 1
            stats["mixed_al"] += 1
            stats["mates_al"] += 1
            stats["mate_un"] += 1
            if nh > 1 or (secbest is not None and secbest == best):
                stats["mate_multi"] += 1
            else:
                stats["mate_uniq"] += 1

    for grow in unal_rows.tolist():
        un1 = (0, 1 | 4 | 8 | 64, -1, 0, 0, 0, 0, 0, 0, 0, 0,
               INT32_MIN, 0, 1, 0, np.zeros(0, np.int16))
        un2 = (1, 1 | 4 | 8 | 128, -1, 0, 0, 0, 0, 0, 0, 0, 0,
               INT32_MIN, 0, 1, 0, np.zeros(0, np.int16))
        row_order.append(int(grow))
        rec_cols.append((un1, un2))
        stats["pairs"] += 1
        stats["unal"] += 1
        stats["mate_un"] += 2

    if not rec_cols:
        return {}, slow

    # ---- native formatting (subset buffers, local pair indices) ----
    rows_np = np.asarray(row_order, np.int64)
    name_buf, name_off, name_lens = _name_buf(
        [b1.names[int(i)] for i in row_order])
    if name_buf.size == 0:
        name_buf = np.zeros(1, np.uint8)
    s1 = np.ascontiguousarray(b1.seqs[rows_np].astype(np.uint8))
    s2 = np.ascontiguousarray(b2.seqs[rows_np].astype(np.uint8))
    q1 = np.ascontiguousarray(_u8(b1.quals)[rows_np])
    q2 = np.ascontiguousarray(_u8(b2.quals)[rows_np])
    le1 = np.ascontiguousarray(l1[rows_np].astype(np.int32))
    le2 = np.ascontiguousarray(l2[rows_np].astype(np.int32))
    qc1, qc2 = _batch_qconst(b1), _batch_qconst(b2)
    qconst = qc1 if (qc1 >= 0 and qc1 == qc2) else -1
    rn_buf, rn_off, rn_lens = _refname_cache(al)

    NRECS = 2 * len(rec_cols)
    names = ("pair", "mate", "flag", "rname", "pos1", "mapq", "c5", "mid",
             "c3", "rnext", "pn1", "score", "zs", "nmm", "nh", "cnt")
    carr = {k: np.zeros(NRECS, np.int32) for k in names}
    mm_arr = np.zeros((NRECS, MMX), np.int16)
    n = 0
    for pl, recs in enumerate(rec_cols):
        for rec in recs:
            carr["pair"][n] = pl
            for k, v in zip(names[1:], rec[:-1]):
                carr[k][n] = v
            lanes = rec[-1]
            if lanes.size:
                mm_arr[n, :lanes.size] = lanes
            n += 1
    maxrn = int(rn_lens.max()) if rn_lens.size else 1
    Lp1, Lp2 = s1.shape[1], s2.shape[1]
    cap = int(NRECS * (260 + maxrn + 2 * max(Lp1, Lp2) + 12 * MMX)
              + int(name_lens.sum()) + 4096)
    outbuf = ctypes.create_string_buffer(cap)
    rec_ends = np.zeros(NRECS, np.int64)
    total = samfmt_lib().format_pe_mix(
        np.int32(NRECS), *(carr[k] for k in names),
        np.ascontiguousarray(mm_arr), np.int32(MMX),
        name_buf, name_off,
        s1, q1, np.int64(Lp1), le1,
        s2, q2, np.int64(Lp2), le2, np.int32(qconst),
        rn_buf, rn_off,
        outbuf, np.int64(cap), rec_ends)
    if total < 0:
        raise RuntimeError("format_pe_mix: SAM buffer overflow")
    text = ctypes.string_at(ctypes.addressof(outbuf), int(total)) \
        .decode("ascii")
    vec_lines: dict[int, list[str]] = {}
    for pl, grow in enumerate(row_order):
        a0 = int(rec_ends[2 * pl - 1]) if pl > 0 else 0
        vec_lines[grow] = [text[a0:int(rec_ends[2 * pl + 1])]]
    remaining = np.asarray([int(x) for x in slow if int(x) not in vec_lines],
                           np.int64)
    return vec_lines, remaining


def _write_in_order(writer, fbuf: bytes, fast, pair_end, slow_out: dict):
    """Replay the native text of the fast rows and the ladder's lines of
    the slow rows in row order."""
    w = writer.out.write
    if not slow_out:
        if fbuf:
            w(fbuf.decode("ascii"))
        return
    text = fbuf.decode("ascii") if fbuf else ""
    last_end = np.maximum.accumulate(np.where(fast, pair_end, 0))
    prev_end = 0
    for i in sorted(slow_out):
        if text and i > 0:
            end = int(last_end[i - 1])
            if end > prev_end:
                w(text[prev_end:end])
                prev_end = end
        for ln in slow_out[i]:
            w(ln)
    if text and prev_end < len(text):
        w(text[prev_end:])


def _finish_pe_slow_and_stitch(al, b1, b2, ex, out, writer, fast, aux,
                               nvalid, l1, l2, fbuf, pair_end,
                               stats) -> dict:
    """Slow-pair ladder and ordered stitch of the native PE fast path
    (per-pair ladder: _pair_result_one / mate rescue / pair_lines)."""
    _, m1_dev, m2_dev, pt_dev, _, _ = out
    B = len(b1)
    o = al.opts
    sc = al.scoring

    slow = np.flatnonzero(~fast)
    grows = slow[aux[slow] != 0]
    # device-predicted slow pairs (the SB extras) shipped their grid rows
    # with the pack: gather only the mispredictions
    pred_j: dict[int, int] = {}
    if ex is not None and "srows" in ex:
        for j, r in enumerate(ex["srows"]):
            if r >= 0:
                pred_j[int(r)] = j
    if grows.size and pred_j:
        hit = np.fromiter((int(r) in pred_j for r in grows), bool,
                          grows.size)
    else:
        hit = np.zeros(grows.size, bool)
    miss = grows[~hit]
    if isinstance(m1_dev, np.ndarray):
        # host-merged global grids (the sharded finish): slice directly,
        # keeping int64 global positions
        g_fut = ((lambda: (m1_dev[miss], m2_dev[miss], pt_dev[miss]))
                 if miss.size else None)
    else:
        g_fut = _paired._gather_pe_slow(m1_dev, m2_dev, pt_dev, miss)

    slow_out: dict[int, list] = {}
    if slow.size:
        K2 = int(m1_dev.shape[1])
        KP2 = int(pt_dev.shape[1])
        msc1 = np.full((B, K2), NEG_INF, np.int64)
        msc2 = np.full((B, K2), NEG_INF, np.int64)
        mpos1 = np.zeros((B, K2), np.int64)
        mpos2 = np.zeros((B, K2), np.int64)
        mfw1 = np.zeros((B, K2), bool)
        mfw2 = np.zeros((B, K2), bool)
        mg1 = np.zeros((B, K2), bool)
        mg2 = np.zeros((B, K2), bool)
        ptf = np.zeros((B, KP2, 3), np.int64)
        ptf[:, :, 0] = NEG_INF

        def fill(rows, ga, gb):
            msc1[rows] = ga[:, :, 0]
            mpos1[rows] = ga[:, :, 1]
            mfw1[rows] = (ga[:, :, 2] & 1) > 0
            mg1[rows] = (ga[:, :, 2] & 2) > 0
            msc2[rows] = gb[:, :, 0]
            mpos2[rows] = gb[:, :, 1]
            mfw2[rows] = (gb[:, :, 2] & 1) > 0
            mg2[rows] = (gb[:, :, 2] & 2) > 0
        if g_fut is not None:
            ga, gb, gp = g_fut()
            fill(miss, ga, gb)
            ptf[miss] = gp
        hrows = grows[hit]
        if hrows.size:
            js = np.fromiter((pred_j[int(r)] for r in hrows), np.int64,
                             hrows.size)
            fill(hrows, ex["sm1"][js], ex["sm2"][js])
            ptf[hrows] = ex["spt"][js]
        m1h = dict(score=msc1, pos=mpos1, fw=mfw1, gapped=mg1)
        m2h = dict(score=msc2, pos=mpos2, fw=mfw2, gapped=mg2)
        grid = _paired._grid_from_pairtop(ptf, m1h, m2h)

        # vectorized mixed/unal resolution: the dominant slow category is
        # "no concordant pair, one mate aligned, in-step rescue DP
        # failed"; only rescued/discordant/gapped/alt rows are left to the
        # per-pair ladder below
        vec_lines, slow = _pe_mixed_vec(al, b1, b2, slow, nvalid, m1h,
                                        m2h, l1, l2, ex, stats)
        slow_out.update(vec_lines)

        def mate_cands(m, batch, i, min_sc, rdlen):
            cs = []
            seen = set()
            for s, p, f, g in zip(*(m[x][i] for x in
                                    ("score", "pos", "fw", "gapped"))):
                key = (int(p), bool(f))
                if s >= min_sc and key not in seen:
                    seen.add(key)
                    cs.append(dict(score=int(s), pos=key[0], fw=key[1],
                                   kind="reg", gapped=bool(g),
                                   extent=rdlen))
            return cs[:o.top_cands]

        # finalize every ungapped slow-pair candidate in one vectorized
        # pass per mate
        fin_cache: dict[tuple, object] = {}
        items = {0: [], 1: []}
        for i in slow:
            i = int(i)
            for mi, (mh, bb, lm) in enumerate(((m1h, b1, l1),
                                               (m2h, b2, l2))):
                min_i = sc.min_score(int(lm[i]))
                for c in mate_cands(mh, bb, i, min_i, int(lm[i])):
                    if not c["gapped"]:
                        items[mi].append((i, c["pos"], c["fw"]))
        for mi, bb, lm in ((0, b1, l1), (1, b2, l2)):
            if not items[mi]:
                continue
            ridx = np.asarray([x[0] for x in items[mi]])
            upos = np.asarray([x[1] for x in items[mi]])
            ufw = np.asarray([x[2] for x in items[mi]])
            alns = al._finalize_ungapped_list(bb, ridx, upos, ufw, lm[ridx])
            for (i, p, f), a in zip(items[mi], alns):
                fin_cache[(mi, i, p, f)] = a

        def finalize(batch, i, c, rdlen):
            mi = 0 if batch is b1 else 1
            key = (mi, i, c["pos"], c["fw"])
            if not c["gapped"] and key in fin_cache:
                return fin_cache[key]
            return al._finalize(i, batch, c["score"], c["pos"], c["fw"],
                                c["gapped"], rdlen)

        rescue: list[tuple] = []
        prs: dict[int, object] = {}
        for i in slow:
            i = int(i)
            prs[i] = _paired._pair_result_one(
                al, i, b1, b2, m1h, m2h, grid, mate_cands, finalize,
                rescue)
        if rescue:
            dev_resc = None
            if ex is not None and "rescue" in ex:
                dev_resc = {int(row[0]): row for row in ex["rescue"]
                            if int(row[0]) >= 0}
            _paired._rescue_mates(al, b1, b2, prs, rescue, finalize,
                                  dev_cache=dev_resc)
        for i, pr in prs.items():
            slow_out[i] = _paired.pair_lines(al, b1, b2, i, pr, stats)

    _write_in_order(writer, fbuf, fast, pair_end, slow_out)
    return stats


def _align_and_emit_pe_legacy(al: Aligner, b1: ReadBatch, b2: ReadBatch,
                              writer) -> dict:
    """Fused paired-end align + SAM emission for batches with per-base
    qualities, Zs:Z-tag runs on a graph index and batches with known
    splice sites; with seed_mode=False or --tmo the per-pair path
    (paired.align_pairs + pairs_to_sam, where _tmo_filter_pair gates the
    pairs) instead.

    One device call (paired.stage_pe_fused: both mates' cores, the
    concordance grid, record finalization), in RNA mode each mate's
    splice rescue, then a vectorized host fast path for concordant pairs,
    -k secondary pairs included, through the native formatter.
    Discordant / mixed / rescued / spliced pairs, and every pair once the
    site table holds a site (TLEN leaves out known introns), take the
    per-pair ladder (paired._pair_result_one). Output order matches
    pairs_to_sam (pair order, mate 1 then mate 2 per reported pair)."""
    o = al.opts
    B = len(b1)
    if not o.seed_mode or o.tmo:
        res = _paired.align_pairs(al, b1, b2)
        return _paired.pairs_to_sam(b1, b2, res, al, writer)
    sc = al.scoring
    khits = o.khits
    KP = max(8, khits + 3)
    m1, m2, pt, finp1, finp2, _sfin1, _sfin2 = _paired.stage_pe_fused(
        al, b1, b2, KP=KP, KF=1)
    if o.spliced:
        n_ss = len(al.ssdb)
        al._splice_rescue(b1, m1)
        al._splice_rescue(b2, m2)
        if len(al.ssdb) != n_ss:
            al._splice_rescue(b1, m1)
            al._splice_rescue(b2, m2)
    spl_pairs = set(m1.get("splice", {})) | set(m2.get("splice", {}))

    l1 = b1.lens.astype(np.int64)
    l2 = b2.lens.astype(np.int64)
    total = pt[:, :, 0].astype(np.int64)
    t1 = pt[:, :, 1].astype(np.int64)
    t2 = pt[:, :, 2].astype(np.int64)
    KPr = total.shape[1]
    valid = total > NEG_INF_HALF
    has_conc = valid[:, 0]

    rows = np.arange(B)[:, None]
    cp1 = m1["pos"][rows, t1]
    cp2 = m2["pos"][rows, t2]
    cf1 = m1["fw"][rows, t1]
    cf2 = m2["fw"][rows, t2]
    cg1 = m1["gapped"][rows, t1]
    cg2 = m2["gapped"][rows, t2]
    cs1 = m1["score"][rows, t1].astype(np.int64)
    cs2 = m2["score"][rows, t2].astype(np.int64)

    # distinct-placement dedup across combos
    dup = np.zeros((B, KPr), bool)
    for k in range(1, KPr):
        eq = ((cp1[:, :k] == cp1[:, k:k + 1])
              & (cf1[:, :k] == cf1[:, k:k + 1])
              & (cp2[:, :k] == cp2[:, k:k + 1])
              & (cf2[:, :k] == cf2[:, k:k + 1]))
        dup[:, k] = eq.any(axis=1)
    pvalid = valid & ~dup
    nvalid = pvalid.sum(axis=1)
    nrep = np.minimum(nvalid, khits)
    vrank = np.where(pvalid, np.cumsum(pvalid, axis=1) - 1, KPr + 1)
    KFu = min(KPr, khits)
    sel = np.full((B, KFu), KPr, np.int64)
    for j in range(KFu):
        hit = vrank == j
        has = hit.any(axis=1)
        sel[has, j] = np.argmax(hit[has], axis=1)
    hit2 = vrank == 1
    sec_total = np.where(hit2.any(axis=1),
                         total[np.arange(B), np.argmax(hit2, axis=1)],
                         np.int64(NEG_INF))

    # fast eligibility
    selc = np.minimum(sel, KPr - 1)
    in_rep = np.arange(KFu)[None, :] < nrep[:, None]
    F1 = {n: np.take_along_axis(finp1[:, :, c], selc, 1)
          for n, c in (("c5", 0), ("c3", 1), ("nmm", 3), ("nmm_all", 4))}
    F2 = {n: np.take_along_axis(finp2[:, :, c], selc, 1)
          for n, c in (("c5", 0), ("c3", 1), ("nmm", 3), ("nmm_all", 4))}
    fast = has_conc.copy()
    fast &= ~(in_rep & (np.take_along_axis(cg1, selc, 1)
                        | np.take_along_axis(cg2, selc, 1))).any(axis=1)
    fast &= ~(in_rep & ((F1["nmm_all"] > MAX_FAST_MM)
                        | (F2["nmm_all"] > MAX_FAST_MM))).any(axis=1)
    if len(al.ssdb):
        fast[:] = False        # TLEN leaves out known introns: the ladder
    if spl_pairs:
        fast[np.fromiter(spl_pairs, dtype=np.int64)] = False

    # fragment containment + coordinates for every reported record
    ref = al.fm.ref
    ok1, fc1, ast1 = _contain(ref, np.take_along_axis(cp1, selc, 1),
                              F1["c5"], F1["c3"], l1)
    ok2, fc2, ast2 = _contain(ref, np.take_along_axis(cp2, selc, 1),
                              F2["c5"], F2["c3"], l2)
    tidx1 = ref.frag_tidx[fc1]
    tidx2 = ref.frag_tidx[fc2]
    fast &= ~(in_rep & ~(ok1 & ok2 & (tidx1 == tidx2))).any(axis=1)

    stats = _paired.new_pair_stats()

    fbuf = b""
    pair_end = np.zeros(B, np.int64)
    frows = np.flatnonzero(fast)
    if frows.size:
        nr = nrep[frows]
        rec_pair = np.repeat(frows, nr)                 # one per combo
        rec_k = np.arange(rec_pair.size) - np.repeat(
            np.concatenate([[0], np.cumsum(nr)[:-1]]), nr)
        col = sel[rec_pair, rec_k]

        toff1 = (ref.frag_toff[fc1] + ast1 - ref.frag_joined[fc1]
                 )[rec_pair, rec_k]
        toff2 = (ref.frag_toff[fc2] + ast2 - ref.frag_joined[fc2]
                 )[rec_pair, rec_k]
        cc51 = F1["c5"][rec_pair, rec_k]
        cc31 = F1["c3"][rec_pair, rec_k]
        cc52 = F2["c5"][rec_pair, rec_k]
        cc32 = F2["c3"][rec_pair, rec_k]
        mid1 = l1[rec_pair] - cc51 - cc31
        mid2 = l2[rec_pair] - cc52 - cc32
        fw1 = cf1[rec_pair, col]
        fw2 = cf2[rec_pair, col]
        # TLEN over the unclipped fragment
        left = np.minimum(toff1 - cc51, toff2 - cc52)
        right = np.maximum(toff1 + mid1 + cc31, toff2 + mid2 + cc32)
        tl = right - left
        tl1 = np.where(toff1 <= toff2, tl, -tl)
        # MAPQ per pair
        bt = total[frows, 0]
        st2_ = sec_total[frows]
        hs = st2_ > NEG_INF_HALF
        need_tab = hs & (st2_ == bt)
        mapq_pair = np.full(frows.size, 60, np.int32)
        for j in np.flatnonzero(need_tab):
            i = frows[j]
            mapq_pair[j] = _mapq.mapq_v2(
                int(bt[j]), int(st2_[j]),
                sc.perfect_score(int(l1[i])) + sc.perfect_score(int(l2[i])),
                sc.min_score(int(l1[i])) + sc.min_score(int(l2[i])),
                local=sc.local)
        pairloc = np.zeros(int(frows.max()) + 1, np.int64)
        pairloc[frows] = np.arange(frows.size)
        mq_rec = np.where(rec_k == 0, mapq_pair[pairloc[rec_pair]],
                          255).astype(np.int32)

        nrec = rec_pair.size
        flag1 = (1 | 64 | 2 | np.where(fw1, 0, 16) | np.where(fw2, 0, 32)
                 | np.where(rec_k > 0, 256, 0)).astype(np.int32)
        flag2 = (1 | 128 | 2 | np.where(fw2, 0, 16) | np.where(fw1, 0, 32)
                 | np.where(rec_k > 0, 256, 0)).astype(np.int32)
        nh = np.repeat(nr, nr).astype(np.int32)

        def mate_mm(finp, cc5):
            finc = finp[rec_pair, col]
            mc = finc[:, 5:5 + MAX_FAST_MM].astype(np.int32)
            mch = finc[:, 5 + MAX_FAST_MM:].astype(np.int64)
            cnt = finc[:, 4].astype(np.int64)
            off = np.zeros(nrec + 1, np.int64)
            np.cumsum(cnt, out=off[1:])
            selm = np.arange(MAX_FAST_MM)[None, :] < cnt[:, None]
            cols = (mc[selm] - np.repeat(cc5, cnt)).astype(np.int32)
            refs = np.ascontiguousarray(
                _DEC_ASCII[np.clip(mch[selm], 0, 4)])
            return cols, refs, off, cnt

        mm1 = mate_mm(finp1, cc51)
        mm2 = mate_mm(finp2, cc52)

        # interleave mate1/mate2 records: 2*nrec records total
        def ilv(a1, a2):
            out = np.empty(2 * nrec, a1.dtype)
            out[0::2] = a1
            out[1::2] = a2
            return out

        iread = ilv(rec_pair.astype(np.int32) * 2,
                    rec_pair.astype(np.int32) * 2 + 1)
        iflag = ilv(flag1, flag2)
        irname = ilv(tidx1[rec_pair, rec_k].astype(np.int32),
                     tidx2[rec_pair, rec_k].astype(np.int32))
        ipos = ilv((toff1 + 1).astype(np.int32), (toff2 + 1).astype(np.int32))
        ipnext = ilv((toff2 + 1).astype(np.int32),
                     (toff1 + 1).astype(np.int32))
        itlen = ilv(tl1.astype(np.int32), (-tl1).astype(np.int32))
        ic5 = ilv(cc51.astype(np.int32), cc52.astype(np.int32))
        ic3 = ilv(cc31.astype(np.int32), cc32.astype(np.int32))
        imid = ilv(mid1.astype(np.int32), mid2.astype(np.int32))
        iscore = ilv(cs1[rec_pair, col].astype(np.int32),
                     cs2[rec_pair, col].astype(np.int32))
        inmm = ilv(F1["nmm"][rec_pair, rec_k].astype(np.int32),
                   F2["nmm"][rec_pair, rec_k].astype(np.int32))
        imapq = ilv(mq_rec, mq_rec)
        inh = ilv(nh, nh)
        izs = np.full(2 * nrec, INT32_MIN, np.int32)
        iyt = np.full(2 * nrec, 1, np.int32)        # CP
        immoff = np.zeros(2 * nrec + 1, np.int64)
        immoff[1::2] = mm1[3]
        immoff[2::2] = mm2[3]
        np.cumsum(immoff, out=immoff)
        immcols, immref = _interleave_runs(mm1, mm2, nrec)

        fbuf, rec_ends = _format_pe_records(
            al, b1, b2, frows, iread, iflag, irname, ipos, imapq,
            ic5, imid, ic3, ipnext, itlen, iyt, iscore, inmm, izs, inh,
            immcols, immref, immoff)
        last_rec = 2 * np.cumsum(nr) - 1
        pair_end[frows] = rec_ends[last_rec]

        stats["pairs"] += int(frows.size)
        stats["mates_al"] += 2 * int(frows.size)
        multi = nvalid[frows] >= 2
        stats["conc_multi"] += int(multi.sum())
        stats["conc_uniq"] += int((~multi).sum())

    # ---- slow pairs ----
    slow = np.flatnonzero(~fast)
    slow_out: dict[int, list] = {}
    if slow.size:
        grid = _paired._grid_from_pairtop(pt, m1, m2)
        mate_cands, finalize = _paired.mate_fns(al)
        rescue: list[tuple] = []
        prs: dict[int, object] = {}
        for i in slow:
            i = int(i)
            prs[i] = _paired._pair_result_one(
                al, i, b1, b2, m1, m2, grid, mate_cands, finalize, rescue)
        if rescue:
            _paired._rescue_mates(al, b1, b2, prs, rescue, finalize)
        for i, pr in prs.items():
            slow_out[i] = _paired.pair_lines(al, b1, b2, i, pr, stats)

    _write_in_order(writer, fbuf, fast, pair_end, slow_out)
    return stats


def _contain(ref, pos, c5, c3, lens):
    astart = pos + c5
    span = lens[:, None] - c5 - c3
    f = np.searchsorted(ref.frag_joined, astart, side="right") - 1
    ok = (f >= 0) & (span > 0)
    fc = np.clip(f, 0, len(ref.frag_joined) - 1)
    ok &= astart + span <= ref.frag_joined[fc] + ref.frag_len[fc]
    return ok, fc, astart


def _interleave_runs(src1, src2, nrec):
    """Interleave per-record variable-length (cols, refs) runs of two
    parallel record streams into mate1/mate2 alternating order."""
    cols1, refs1, off1, cnt1 = src1
    cols2, refs2, off2, cnt2 = src2
    n1 = cols1.size
    n2 = cols2.size
    out_cols = np.empty(n1 + n2, np.int32)
    out_refs = np.empty(n1 + n2, np.uint8)
    # output start offset of each mate-1 run: off1[i] + off2[i]
    # (everything from earlier records of both streams precedes it)
    start1 = off1[:-1] + off2[:-1]
    start2 = off1[1:] + off2[:-1]
    idx1 = np.repeat(start1 - off1[:-1], cnt1) + np.arange(n1)
    idx2 = np.repeat(start2 - off2[:-1], cnt2) + np.arange(n2)
    out_cols[idx1] = cols1
    out_refs[idx1] = refs1
    out_cols[idx2] = cols2
    out_refs[idx2] = refs2
    return out_cols, np.ascontiguousarray(out_refs)


def _format_pe_records(al, b1, b2, frows, read_of, flag, rname, pos1, mapq,
                       c5, mid, c3, pnext, tlen, yt, score, nmm, zs, nh,
                       mm_cols, mm_ref, mm_off, m1=None, gapn=None, xs=None):
    """Per-read name/seq buffers hold mate 1 and mate 2 of each fast pair
    as consecutive rows (read_of = 2*pair + mate). m1/gapn/xs: spliced-
    record columns (one intron and the XS:A strand)."""
    Nf = frows.size
    lens = np.empty(2 * Nf, np.int64)
    lens[0::2] = b1.lens.astype(np.int64)[frows]
    lens[1::2] = b2.lens.astype(np.int64)[frows]

    name_buf, name_off, name_lens = _name_buf(
        [b1.names[int(i)] for i in frows for _mate in (1, 2)])

    Lp = max(b1.seqs.shape[1], b2.seqs.shape[1])

    def pad_to(x, L):
        if x.shape[1] == L:
            return x
        return np.pad(x, ((0, 0), (0, L - x.shape[1])))

    raw = np.empty((2 * Nf, Lp), b1.seqs.dtype)
    raw[0::2] = pad_to(b1.seqs, Lp)[frows]
    raw[1::2] = pad_to(b2.seqs, Lp)[frows]
    quals = np.empty((2 * Nf, Lp), b1.quals.dtype)
    quals[0::2] = pad_to(b1.quals, Lp)[frows]
    quals[1::2] = pad_to(b2.quals, Lp)[frows]

    sf, qf, sr, qr, seq_off = _seq_orientations(raw, quals, lens)

    # read_of is 2*global_pair + mate; remap to the local row
    l_of = np.zeros(2 * (int(frows.max()) + 1) if Nf else 2, np.int64)
    l_of[2 * frows] = 2 * np.arange(Nf)
    l_of[2 * frows + 1] = 2 * np.arange(Nf) + 1
    read_local = l_of[read_of].astype(np.int32)

    rn_buf, rn_off, rn_lens = _refname_cache(al)
    nrec = read_of.size
    per_rec = (280 + name_lens[read_local] + rn_lens[rname]
               + 2 * lens[read_local] + 12 * np.diff(mm_off))
    cap = int(per_rec.sum()) + 1024

    z = np.zeros(nrec, np.int32)
    m1 = z if m1 is None else np.ascontiguousarray(m1.astype(np.int32))
    gapn = z if gapn is None else np.ascontiguousarray(gapn.astype(np.int32))
    xs = z if xs is None else np.ascontiguousarray(xs.astype(np.int32))
    out = ctypes.create_string_buffer(cap)
    ends = np.zeros(nrec, np.int64)
    total = samfmt_lib().format_pe_batch(
        np.int32(nrec), read_local, np.ascontiguousarray(flag),
        np.ascontiguousarray(rname), np.ascontiguousarray(pos1),
        np.ascontiguousarray(mapq), np.ascontiguousarray(c5),
        np.ascontiguousarray(mid), np.ascontiguousarray(c3),
        np.ascontiguousarray(pnext), np.ascontiguousarray(tlen),
        np.ascontiguousarray(yt), np.ascontiguousarray(score),
        np.ascontiguousarray(nmm), np.ascontiguousarray(nmm),
        np.ascontiguousarray(zs), np.ascontiguousarray(nh),
        name_buf, name_off,
        sf, qf, sr, qr, seq_off,
        np.ascontiguousarray(mm_cols), mm_ref, mm_off,
        np.ascontiguousarray(rn_buf), rn_off,
        out, np.int64(cap), ends, m1, gapn, xs)
    if total < 0:
        raise RuntimeError("format_pe_batch: SAM buffer overflow")
    return out.raw[:total], ends
