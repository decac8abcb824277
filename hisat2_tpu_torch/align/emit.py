"""Fused align + SAM emission, single-end (PyTorch port of hisat2_tpu's
SE native path).

Ungapped, unspliced reads — multi-mapped ones included — skip all
per-read Python: the device finalizes the top-k candidates of every read
into the int16 fastpack (pipeline._stage_fastpack), and one native call
(native/samfmt.cpp finish_se_native) selects the reportable records and
formats their SAM lines. Only odd reads (gapped, filtered,
fragment-boundary, more than FASTPACK_MM mismatches, candidate overflow)
drop to the per-read ReadResult ladder. Output order is read order.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ..io.reads import ReadBatch
from ..io import sam as samio
from ..native import samfmt_lib
from . import mapq as _mapq
from .pipeline import (FASTPACK_MM, FASTPACK_REP, NEG_INF, Aligner,
                       ReadResult, _dedup_alns, _filter_reason)


def align_and_emit(al: Aligner, batch: ReadBatch, writer) -> dict:
    """Align one SE batch and emit SAM; returns the summary-stats dict."""
    return finish_se(al, submit_se(al, batch), writer)


def submit_se(al: Aligner, batch: ReadBatch):
    """Queue one SE batch's device work and its result copies. Pair with
    finish_se; several submits in flight overlap device work with host
    finishing (align_and_emit_stream)."""
    return (batch, *al.device_align_fast(batch))


def finish_se(al: Aligner, handle, writer) -> dict:
    batch, fp, merged_dev, extras, ready = handle
    t0 = time.perf_counter()
    if ready is not None:
        ready.synchronize()
    al.metrics.t_fetch += time.perf_counter() - t0
    st = _finish_fastpack(al, batch, fp.numpy(), merged_dev, writer,
                          {k: v.numpy() for k, v in extras.items()})
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
    submitting. depth = max in-flight batches."""
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
    pending = deque()        # (future, tup) in submit order

    def drain_one():
        fut, pt = pending.popleft()
        text, st = fut.result()
        if text:
            w(text)
        done(st, pt)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for tup in item_tuples:
            h = submit_fn(al, *tup)
            pending.append((ex.submit(_finish_to_text, al, h, finish_fn),
                            tup))
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

    nb = np.array(batch.names, dtype="S255")
    name_lens = np.char.str_len(nb).astype(np.int64)
    name_off = np.zeros(B + 1, np.int64)
    np.cumsum(name_lens, out=name_off[1:])
    wide = nb.view(np.uint8).reshape(B, -1)
    name_buf = np.ascontiguousarray(
        wide[np.arange(wide.shape[1])[None, :] < name_lens[:, None]])

    rn_buf, rn_off, rn_lens = _refname_cache(al)
    yf_qc = np.zeros(B, np.uint8)
    if (lens == 0).any() and batch.reads:
        qcf = np.fromiter((not getattr(r, "qc_ok", True)
                           for r in batch.reads), bool, B)
        yf_qc[qcf & (lens == 0)] = 1

    q = batch.quals
    qconst = int(q.flat[0]) if q.size and bool((q == q.flat[0]).all()) \
        else -1
    seqs = batch.seqs if batch.seqs.dtype == np.uint8 \
        else batch.seqs.astype(np.uint8)
    quals_u8 = q.view(np.uint8) if q.dtype == np.int8 \
        else np.ascontiguousarray(q.astype(np.uint8))

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
        np.ascontiguousarray(seqs), np.ascontiguousarray(quals_u8),
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
    sc = al.scoring
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

        plans: dict[int, list] = {}
        ug_items: list[tuple[int, int, bool]] = []
        for i in slow:
            i = int(i)
            if filtered[i]:
                continue
            entries = [(s, p, f, g) for s, p, f, g, _, _
                       in al._ranked_candidates(merged, i,
                                                int(min_scs[i]))]
            entries = entries[: al.opts.khits + 1]
            plans[i] = entries
            for s, p, f, g in entries:
                if not g:
                    ug_items.append((i, int(p), bool(f)))
        lookup: dict[tuple, object] = {}
        if ug_items:
            ridx = np.asarray([x[0] for x in ug_items])
            upos = np.asarray([x[1] for x in ug_items])
            ufw = np.asarray([x[2] for x in ug_items])
            alns = al._finalize_ungapped_list(batch, ridx, upos, ufw,
                                              lens[ridx])
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
                    res.best = entries[0][0]
                    if len(entries) > 1:
                        res.secbest = entries[1][0]
                    for s, p, f, g in entries:
                        if g:
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
            lines = _format_slow(al, batch, i, res, sc)
            if not res.aligned:
                stats["unal"] += 1
            elif len(res.alns) > 1 or (res.secbest is not None
                                       and res.secbest >= min_scs[i]):
                stats["multi"] += 1
            else:
                stats["uniq"] += 1
            slow_out[i] = lines

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
    if text and prev_end < len(text):
        w(text[prev_end:])
    return stats


def _finish_fastpack(al: Aligner, batch: ReadBatch, fp: np.ndarray,
                     merged_dev, writer, ex: dict | None) -> dict:
    """Host half of the packed SE path: format fast reads natively from
    the int16 fastpack, run the slow reads' ladder, and stitch output in
    read order."""
    sc = al.scoring
    lens = batch.lens.astype(np.int64)
    L = batch.seqs.shape[1]
    min_scs = np.ceil(sc.score_min.I + sc.score_min.S * lens).astype(np.int64)
    nNs = ((batch.seqs >= 4)
           & (np.arange(L)[None, :] < lens[:, None])).sum(axis=1)
    filtered = (lens == 0) | (nNs > sc.n_ceil.I + sc.n_ceil.S * lens)
    KFB = (fp.shape[1] - 4) // FASTPACK_REP
    fast, fbuf, read_end, stats, nvalid = _native_fast_se(
        al, batch, fp, ex, KFB, lens, L)
    return _finish_slow_and_stitch(
        al, batch, ex, merged_dev, writer, fast, filtered, nvalid, min_scs,
        lens, fbuf, read_end, stats)


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
