"""Alignment over a genome-sharded index (index/sharded.py): the PyTorch
port of hisat2_tpu's align/sharded.py.

On one card the aligner streams shards: every read batch's device step
runs against shard k (its index arrays on the card), fastpacks and
candidate grids are collected per shard, and the per-read results merge
in GLOBAL coordinates on the host before the shared finishing path
(Aligner.host_only) emits SAM.

Shards stay resident on the card while their estimated bundle bytes fit
a device-memory budget, and the oldest is evicted first when the next
does not fit. The budget is HISAT2_TPU_HBM_GB (GiB) where set; else on a
card the free memory when the aligner is built less DEVICE_HEADROOM, and
8 GiB on the CPU. Eviction changes where the time goes, never the bytes.

Merge policy: the winning shard's report list is used verbatim when only
one shard places the read (the overwhelming case); reads hit by several
shards fall to the exact per-read ladder over the concatenated candidate
grids (cross-shard multireads must interleave reports by score).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..index.sharded import ShardedIndex
from ..io.annotations import SNP_DEL, SNP_INS
from ..io.reads import ReadBatch
from ..ops import wire as _wire
from . import emit as _emit
from . import paired as _paired
from . import paired_rna as _prna
from .pipeline import (FASTPACK_REP, Aligner, AlignerOpts, _to_host_async,
                       results_to_sam)
from .scoring import DEFAULT_SCORING, Scoring

# device memory left beside the resident shards for one step's
# temporaries: the peaks of one batch of 16,384 were 2,136.1 MiB (SE) and
# 4,614.5 MiB (RNA PE, a 32,768-row spliced step) on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md)
DEVICE_HEADROOM = 6 << 30
CPU_BUDGET_GB = 8.0

_SPL_KEYS = ("splanes32", "splanes16", "spl_cov", "spl_nsel",
             "splanes32b", "splanes16b", "spl_nsel2")


def device_budget(device: torch.device) -> int:
    """Bytes of shard bundles the aligner keeps resident on `device`."""
    gb = os.environ.get("HISAT2_TPU_HBM_GB")
    if gb is not None:
        return int(float(gb) * (1 << 30))
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return max(0, int(free) - DEVICE_HEADROOM)
    return int(CPU_BUDGET_GB * (1 << 30))


def _wait(ready) -> None:
    if ready is not None:
        ready.synchronize()


def _spl_lanes(sp: dict | None):
    """A merged splice-lane dict as the dev_lanes tuple of
    Aligner._splice_rescue."""
    if sp is None:
        return None
    return (sp["splanes32"], sp["splanes16"], sp["spl_cov"],
            int(sp["spl_nsel"]), int(sp["spl_ssv"]), sp.get("splanes32b"),
            sp.get("splanes16b"), int(sp.get("spl_nsel2", 0)))


class _ShardSSView:
    """Shard-local device view of the GLOBAL splice-site DB: the step's
    splice pass reads site tables in that shard's local coordinates.
    Mirrors hisat2_tpu's padding (power-of-two cap from 1,024, INT32_MAX
    sentinels)."""

    def __init__(self, db, base: int, length: int):
        self.db = db
        self.base = int(base)
        self.length = int(length)
        self._cache = {}
        self._cache_v = -1

    def version(self) -> int:
        return self.db.version()

    def __len__(self) -> int:
        return len(self.db)

    def device_arrays4(self, device):
        device = torch.device(device)
        if self._cache_v != self.db.version():
            self._cache = {}
            self._cache_v = self.db.version()
        if device in self._cache:
            return self._cache[device]
        arr = self.db._sorted_pairs()
        inb = ((arr[:, 0] >= self.base)
               & (arr[:, 1] < self.base + self.length))
        loc = arr[inb] - self.base
        n = loc.shape[0]
        cap = 1024
        while cap < n:
            cap *= 2
        big = np.int32(0x7FFFFFFF)
        pads = np.full((4, cap), big, np.int32)
        pads[0, :n] = loc[:, 0]
        pads[1, :n] = loc[:, 1]
        order = np.argsort(loc[:, 1], kind="stable")
        pads[2, :n] = loc[order, 1]
        pads[3, :n] = loc[order, 0]
        got = self._cache[device] = tuple(torch.from_numpy(p).to(device)
                                          for p in pads)
        return got


class ShardedAligner:
    """Aligner over a ShardedIndex on one device ("cuda" unless the
    caller asks for "cpu"). uploads, evictions and upload_s count the
    shard bundles brought to the device, dropped from it, and the seconds
    the uploads took (host preparation and copy)."""

    def __init__(self, sh: ShardedIndex, scoring: Scoring = DEFAULT_SCORING,
                 opts: AlignerOpts | None = None, device="cuda"):
        self.sh = sh
        self.scoring = scoring
        self.opts = opts or AlignerOpts()
        self.device = torch.device(device)
        # fast-path packs carry positions in two 16-bit lanes; genomes
        # whose joined length exceeds 2^32 would wrap silently — refuse
        # loudly (slow-path grids are int64 and unaffected)
        total_len = int(sh.bases[-1]) + int(sh.shards[-1].ref.n)
        if total_len >= (1 << 32):
            raise ValueError(
                f"sharded fast-path positions are 32-bit: joined genome "
                f"length {total_len} exceeds 2^32 (split the reference "
                f"or raise the pack position width)")
        self.host = Aligner.host_only(sh.ref, scoring, self.opts,
                                      device=self.device)
        if getattr(sh, "snps", None) is not None:
            # graph mode: the host finish needs the GLOBAL SNV overlay
            # (free alt-allele mismatches, Zs edits) and SNP table
            self.host.overlay = sh.snv_overlay
            self.host.snps = sh.snps
            for si in range(len(sh.snps)):
                t = int(sh.snps.types[si])
                if t == SNP_DEL:
                    self.host._del_snps.add((int(sh.snps.jpos[si]),
                                             int(sh.snps.lens[si])))
                elif t == SNP_INS:
                    self.host._ins_snps[int(sh.snps.jpos[si])] = \
                        sh.snps.ins_seqs[si]
        # resident shards, oldest first
        self._resident: dict[int, Aligner] = {}
        self.budget = device_budget(self.device)
        self.uploads = 0
        self.evictions = 0
        self.upload_s = 0.0

    def _shard_dev_bytes(self, i: int) -> int:
        """Device bytes of shard i's index bundle, from its shapes."""
        return self.sh.shards[i].bundle_nbytes()

    def _activate(self, i: int) -> Aligner:
        """Shard i's aligner with its arrays on the device, keeping
        earlier shards resident while the budget allows (oldest evicted
        first). An evicted aligner drops its bundle, and the allocator's
        cache is emptied, before the next bundle is built."""
        if i in self._resident:
            return self._resident[i]
        need = self._shard_dev_bytes(i)
        used = sum(self._shard_dev_bytes(j) for j in self._resident)
        evicted = False
        while self._resident and used + need > self.budget:
            j = next(iter(self._resident))
            self._resident.pop(j).idx = None
            used -= self._shard_dev_bytes(j)
            self.evictions += 1
            evicted = True
        if evicted and self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        al = Aligner(self.sh.shards[i], self.scoring, self.opts,
                     device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s += time.perf_counter() - t0
        self.uploads += 1
        if self.opts.spliced:
            # the step's splice pass sees the GLOBAL site DB through a
            # shard-local coordinate view
            al.ssdb = _ShardSSView(self.host.ssdb, self.sh.bases[i],
                                   int(self.sh.shards[i].n))
        self._resident[i] = al
        return al

    def _se_steps(self, batches: list[ReadBatch]) -> list[list[tuple]]:
        """Every batch's SE step on every shard: per shard a list of
        (fastpack, merged (B, K2, 3), splice-lane extras) numpy triples.
        A shard's batches are all queued before the first is read."""
        per = []
        for s in range(len(self.sh)):
            al = self._activate(s)
            pend = []
            for b in batches:
                fp, merged, ex, ready = al.device_align_fast(b)
                mg, ready_mg = _to_host_async({"mg": merged})
                pend.append((fp, mg, ex, ready, ready_mg))
            del al
            out = []
            for fp, mg, ex, ready, ready_mg in pend:
                _wait(ready)
                _wait(ready_mg)
                out.append((fp.numpy(), mg["mg"].numpy(),
                            {k: np.asarray(ex[k]) for k in _SPL_KEYS
                             if k in ex}))
            per.append(out)
        return per

    def align_and_emit(self, batches: list[ReadBatch], writer) -> dict:
        """Pass-per-shard SE alignment + SAM emission for a list of
        batches; returns merged summary stats. In spliced (RNA) mode each
        shard's step also runs splice pass-1 against its local text
        (shard-local site view), and the lanes merge into global
        coordinates for the host finish."""
        S = len(self.sh)
        spliced = self.opts.spliced
        ssv0 = self.host.ssdb.version()
        per = self._se_steps(batches)
        totals: dict = {}
        for bi, b in enumerate(batches):
            fp, force_slow, merged = self._merge_shard_results(
                [per[s][bi][0] for s in range(S)],
                [per[s][bi][1] for s in range(S)])
            slow_pack = (self._merge_splice_lanes(
                [per[s][bi][2] for s in range(S)], ssv0)
                if spliced else None)
            if self.opts.tmo:
                # --tmo re-derives best/secbest from the surviving
                # (known-junction-spliced) candidates, so it takes the
                # per-read ReadResult path (results_to_sam applies
                # tmo_filter_result per read)
                if spliced:
                    n0 = len(self.host.ssdb)
                    self.host._splice_rescue(b, merged,
                                             dev_lanes=_spl_lanes(slow_pack))
                    if len(self.host.ssdb) != n0:
                        self.host._splice_rescue(b, merged)
                res = self.host._finalize_results(b, merged)
                st = results_to_sam(b, res, self.host, writer)
            else:
                st = _emit._finish_fastpack(self.host, b, fp, None, writer,
                                            slow_pack, force_slow=force_slow,
                                            merged_full=merged)
            _emit._merge_stats(totals, st)
        return totals

    def _merge_splice_lanes(self, exs: list[dict], ssv0: int
                            ) -> dict | None:
        """Globalize + concatenate per-shard splice lanes. Returns a
        slow_pack dict for emit._finish_fastpack (splanes32/16, spl_cov,
        spl_nsel, spl_ssv) or None when any shard lacked lanes or
        overflowed its NL cap (the host rescue then enumerates them)."""
        if not exs or any("splanes16" not in ex for ex in exs):
            return None
        sp32s, sp16s = [], []
        sp32bs, sp16bs = [], []
        cov0 = np.zeros_like(np.asarray(exs[0]["spl_cov"]))
        cov1 = np.zeros_like(cov0)
        off = 0
        for s, ex in enumerate(exs):
            if int(ex["spl_nsel"]) > ex["splanes16"].shape[0]:
                return None
            base = int(self.sh.bases[s])
            sp16 = ex["splanes16"].astype(np.int64)
            live = sp16[:, 4] != 0
            remap = np.cumsum(live) - 1 + off     # old NL idx -> merged
            sp16s.append(sp16[live])
            sp32s.append(ex["splanes32"].astype(np.int64)[live] + base)
            if "splanes16b" in ex:
                s16b = ex["splanes16b"].astype(np.int64)
                lb = s16b[:, 4] != 0
                s16b = s16b[lb]
                s16b[:, 1] = remap[np.clip(s16b[:, 1], 0, live.size - 1)]
                sp16bs.append(s16b)
                sp32bs.append(ex["splanes32b"].astype(np.int64)[lb]
                              + base)
            off += int(live.sum())
            cov = np.asarray(ex["spl_cov"])
            cov0 |= cov & 1
            cov1 |= cov & 2
        sp16c = np.concatenate(sp16s)
        sp32c = np.concatenate(sp32s)
        out = dict(splanes32=sp32c, splanes16=sp16c,
                   spl_cov=(cov0 | cov1).astype(np.int8),
                   spl_nsel=np.int64(sp16c.shape[0]),
                   spl_ssv=np.int64(ssv0))
        if sp16bs and len(sp16bs) == len(exs):
            out["splanes16b"] = np.concatenate(sp16bs)
            out["splanes32b"] = np.concatenate(sp32bs)
            out["spl_nsel2"] = np.int64(out["splanes16b"].shape[0])
        return out

    def _merge_grids(self, mgs: list[np.ndarray]) -> dict:
        """Per-shard (B, K2, 3) candidate grids -> one global-coordinate
        merged dict sorted by score (the grid half of
        _merge_shard_results)."""
        bases = np.asarray(self.sh.bases, np.int64)
        msc = np.concatenate([m[:, :, 0].astype(np.int64) for m in mgs], 1)
        mpos = np.concatenate(
            [m[:, :, 1].astype(np.int64) + bases[s]
             for s, m in enumerate(mgs)], 1)
        mfl = np.concatenate([m[:, :, 2] for m in mgs], 1)
        order = np.argsort(-msc, axis=1, kind="stable")
        return dict(
            score=np.take_along_axis(msc, order, 1),
            pos=np.take_along_axis(mpos, order, 1),
            fw=np.take_along_axis((mfl & 1) > 0, order, 1),
            gapped=np.take_along_axis((mfl & 2) > 0, order, 1))

    def align_and_emit_pe_rna(self, pair_batches, writer) -> dict:
        """Paired-end SPLICED alignment over a sharded index: each mate
        runs the per-shard spliced step (SE core + splice pass-1); grids
        and junction lanes merge into global coordinates, and the host
        pairing (paired_rna.rescue_pair_rna + pair_finish_rna, or under
        --tmo paired.align_pairs over the premerged grids) resolves
        concordance — junctions and mate windows are intra-chromosome,
        hence intra-shard, so every shard's candidate search is
        complete."""
        S = len(self.sh)
        ssv0 = self.host.ssdb.version()
        mates = [b for pair in pair_batches for b in pair]
        per = self._se_steps(mates)
        totals: dict = {}
        for bi, (b1, b2) in enumerate(pair_batches):
            k1, k2 = 2 * bi, 2 * bi + 1
            m1 = self._merge_grids([per[s][k1][1] for s in range(S)])
            m2 = self._merge_grids([per[s][k2][1] for s in range(S)])
            dls = tuple(_spl_lanes(self._merge_splice_lanes(
                [per[s][k][2] for s in range(S)], ssv0)) for k in (k1, k2))
            if self.opts.tmo:
                # --tmo: the pair ladder + pairs_to_sam apply
                # _tmo_filter_pair (alt-pair fallback, mixed demotion)
                res = _paired.align_pairs(self.host, b1, b2,
                                          premerged=(m1, m2), dev_lanes=dls)
                st = _paired.pairs_to_sam(b1, b2, res, self.host, writer)
            else:
                _prna.rescue_pair_rna(self.host, b1, b2, m1, m2,
                                      dev_lanes=dls)
                st = _prna.pair_finish_rna(self.host, b1, b2,
                                           _prna._concat_pair(b1, b2), m1,
                                           m2, writer)
            _emit._merge_stats(totals, st)
        return totals

    def align_and_emit_pe(self, pair_batches: list[tuple[ReadBatch,
                                                         ReadBatch]],
                          writer) -> dict:
        """Pass-per-shard paired-end alignment + SAM emission.

        Each shard runs the full packed PE step (both mates + concordance
        grid) in shard-local coordinates; mates of a genuine pair share a
        chromosome, hence a shard, so every shard's concordance search is
        complete. The host merge (_merge_pe_shards): best-total shard
        wins, position lanes rebase to global, other shards' best folds
        into secbest, per-mate aux bits OR. Pairs hit by several shards
        fall to the exact per-pair ladder over the concatenated candidate
        grids (reference .ht2l role, MANUAL.markdown:221-231)."""
        if self.opts.spliced:
            return self.align_and_emit_pe_rna(pair_batches, writer)

        S = len(self.sh)
        KP = max(8, self.opts.khits + 3)
        per: list[list[tuple]] = []
        for s in range(S):
            al = self._activate(s)
            pend = []
            for b1, b2 in pair_batches:
                out = _paired.stage_pe_packed(al, b1, b2, KP)
                if out is None:
                    raise ValueError(
                        "sharded paired-end alignment currently requires "
                        "constant per-read qualities (FASTA input, -f, or "
                        "FASTQ with uniform quality strings); this batch "
                        "has varying quality values")
                pack, m1, m2, pt, extras, ready = out
                grids, ready_g = _to_host_async({"m1": m1, "m2": m2,
                                                 "pt": pt})
                pend.append((pack, grids, extras["_wire"], ready, ready_g))
            del al
            outs = []
            for pack, grids, (Lw, nvb), ready, ready_g in pend:
                _wait(ready)
                _wait(ready_g)
                fp = pack.numpy()
                if pack.dtype == torch.int32:
                    fp = _wire.pe_pack_decode(_wire.as_words(fp), Lw, Lw,
                                              nvb)
                outs.append((fp, grids["m1"].numpy(), grids["m2"].numpy(),
                             grids["pt"].numpy()))
            per.append(outs)

        totals: dict = {}
        for bi, (b1, b2) in enumerate(pair_batches):
            pack, fslow, m1g, m2g, ptg = self._merge_pe_shards(
                [per[s][bi] for s in range(S)])
            st = _emit._finish_pe_pack(self.host, b1, b2,
                                       (pack, m1g, m2g, ptg, None, None),
                                       writer, force_slow=fslow)
            _emit._merge_stats(totals, st)
        return totals

    def _merge_pe_shards(self, souts):
        """Per-shard (pack, m1, m2, pt) -> (pack_global int16, force_slow,
        m1_all, m2_all, pt_all) with positions in global coordinates and
        pair-top indices remapped into the concatenated candidate
        grids."""
        from .paired import PEPACK_MATE, PEPACK_REP, PEPACK_HDR, pepack_nr
        bases = np.asarray(self.sh.bases, np.int64)
        pk = np.stack([t[0] for t in souts]).astype(np.int64)   # (S, B, W)
        _, B, W = pk.shape
        NR = pepack_nr(W)
        nv = pk[:, :, 0]
        best = pk[:, :, 1]
        win = np.argmax(np.where(nv > 0, best, np.int64(-32768)), axis=0)
        hits = (nv > 0).sum(axis=0)
        fp = np.take_along_axis(pk, win[None, :, None], axis=0)[0].copy()
        base_w = bases[win].astype(np.uint64)
        for k in range(NR):
            rb = PEPACK_HDR + PEPACK_REP * k
            for m in range(2):
                b0 = rb + 1 + m * PEPACK_MATE
                lo = fp[:, b0].astype(np.uint16).astype(np.uint64)
                hi = fp[:, b0 + 1].astype(np.uint16).astype(np.uint64)
                pos = (lo | (hi << 16)) + base_w
                fp[:, b0] = (pos & 0xFFFF).astype(np.int64)
                fp[:, b0 + 1] = ((pos >> 16) & 0xFFFF).astype(np.int64)
        aux = pk[:, :, W - 1]
        fp[:, W - 1] = ((aux & 1).max(axis=0)
                        | (((aux >> 1) & 1).max(axis=0) << 1))
        masked = np.where(nv > 0, best, np.int64(-32768)).copy()
        masked[win, np.arange(B)] = -32768
        fp[:, 2] = np.maximum(fp[:, 2], masked.max(axis=0))
        pack = (fp.astype(np.uint64) & 0xFFFF).astype(
            np.uint16).view(np.int16)

        K2 = souts[0][1].shape[1]
        m1s, m2s, pts = [], [], []
        for s, t in enumerate(souts):
            m1 = t[1].astype(np.int64)
            m1[:, :, 1] += bases[s]
            m1s.append(m1)
            m2 = t[2].astype(np.int64)
            m2[:, :, 1] += bases[s]
            m2s.append(m2)
            p = t[3].astype(np.int64)
            p[:, :, 1] += s * K2
            p[:, :, 2] += s * K2
            pts.append(p)
        m1_all = np.concatenate(m1s, axis=1)
        m2_all = np.concatenate(m2s, axis=1)
        ptm = np.concatenate(pts, axis=1)
        order = np.argsort(-ptm[:, :, 0], axis=1, kind="stable")
        ptm = np.take_along_axis(ptm, order[:, :, None], axis=1)
        return pack, hits >= 2, m1_all, m2_all, ptm

    def _merge_shard_results(self, fps, mgs):
        """Combine per-shard fastpacks + candidate grids into global
        coordinates. Returns (fp_global, force_slow, merged_full)."""
        S = len(fps)
        bases = np.asarray(self.sh.bases, np.int64)
        B = fps[0].shape[0]
        KF = (fps[0].shape[1] - 4) // FASTPACK_REP
        nv = np.stack([fp[:, 0].astype(np.int64) for fp in fps])   # (S, B)
        best = np.stack([fp[:, 1].astype(np.int64) for fp in fps])
        win = np.argmax(np.where(nv > 0, best, np.int64(-32768)),
                        axis=0)                                     # (B,)
        hits = (nv > 0).sum(axis=0)
        fp = np.take_along_axis(np.stack(fps), win[None, :, None],
                                axis=0)[0].copy()
        # shard-local -> global positions in the report lanes
        for k in range(KF):
            b0 = 4 + FASTPACK_REP * k
            lo = fp[:, b0].astype(np.uint16).astype(np.uint64)
            hi = fp[:, b0 + 1].astype(np.uint16).astype(np.uint64)
            pos = (lo | (hi << 16)) + bases[win].astype(np.uint64)
            fp[:, b0] = (pos & 0xFFFF).astype(np.uint16).astype(np.int16)
            fp[:, b0 + 1] = ((pos >> 16) & 0xFFFF).astype(
                np.uint16).astype(np.int16)
        # cross-shard second best can beat the winner's own secbest
        if S > 1:
            masked = np.where(nv > 0, best, np.int64(-32768)).copy()
            masked[win, np.arange(B)] = -32768
            other_best = masked.max(axis=0)
            secb = fp[:, 2].astype(np.int64)
            fp[:, 2] = np.maximum(secb, other_best).astype(np.int16)
        return fp, hits >= 2, self._merge_grids(mgs)
