"""Genome-sharded index: >2^31-bp references across int32-addressed shards
(numpy; the PyTorch port of hisat2_tpu's index/sharded.py).

Equivalent role to the reference's large-index (.ht2l, 64-bit rows) path
(btypes.h BOWTIE_64BIT_INDEX; MANUAL.markdown:221-231): instead of
promoting every device integer to 64 bits, the genome splits at sequence
boundaries into shards of <2^31 joined bases. Each shard is a normal
int32 index; shard-local positions + a per-shard global base give global
coordinates.

On one card the aligner (align/sharded.py) runs every batch against
shard k, then k+1, merging per-read candidate lists on the host, and
keeps shards resident on the card while a device-memory budget allows.
The on-disk format (<prefix>.sharded.json, <prefix>.global.npz and one
index per shard) is the JAX package's: what either saves, the other
loads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.reference import JoinedReference
from .fm_index import FMIndex, build_fm_index


@dataclass
class ShardedIndex:
    shards: list            # FMIndex per shard (frag tables -> global tidx)
    bases: list             # global joined-offset base of each shard
    ref: JoinedReference    # the full (global) reference, host-side
    snps: object = None     # global SNPDB (graph mode)
    snv_overlay: np.ndarray = None   # global 0/alt+1/15 overlay (graph mode)
    known_ss: np.ndarray = None      # (K, 3) int64 [left, right, strand]
    known_exons: np.ndarray = None   # (K, 3) int64 — global joined coords

    def __len__(self):
        return len(self.shards)

    # -------- persistence (reference large-index .ht2l role) --------

    def save(self, prefix: str) -> None:
        import json
        for k, s in enumerate(self.shards):
            s.save(f"{prefix}.shard{k}")
        r = self.ref
        extra = {}
        if self.snps is not None:
            from ..utils import alphabet as _al
            s = self.snps
            extra = dict(
                snp_types=s.types, snp_jpos=s.jpos, snp_lens=s.lens,
                snp_alt=s.alt_codes, snp_tpos=s.tpos,
                snp_names=np.asarray(s.names),
                snp_chroms=np.asarray(s.chroms),
                snp_ins=np.asarray([_al.decode(x) for x in s.ins_seqs]),
                snv_overlay=self.snv_overlay)
        if self.known_ss is not None:
            extra["known_ss"] = self.known_ss
        if self.known_exons is not None:
            extra["known_exons"] = self.known_exons
        np.savez_compressed(
            prefix + ".global.npz",
            bases=np.asarray(self.bases, np.int64), tlens=r.tlens,
            frag_joined=r.frag_joined, frag_toff=r.frag_toff,
            frag_tidx=r.frag_tidx, frag_len=r.frag_len, **extra)
        with open(prefix + ".sharded.json", "w") as fh:
            json.dump(dict(nshards=len(self.shards), names=r.names,
                           graph=self.snps is not None), fh)

    @staticmethod
    def load(prefix: str) -> "ShardedIndex":
        import json
        from .fm_index import FMIndex
        with open(prefix + ".sharded.json") as fh:
            meta = json.load(fh)
        shards = [FMIndex.load(f"{prefix}.shard{k}")
                  for k in range(meta["nshards"])]
        z = np.load(prefix + ".global.npz", allow_pickle=False)
        joined = np.concatenate([s.ref.joined for s in shards])
        ref = JoinedReference(
            names=list(meta["names"]), tlens=z["tlens"], joined=joined,
            frag_joined=z["frag_joined"], frag_toff=z["frag_toff"],
            frag_tidx=z["frag_tidx"], frag_len=z["frag_len"])
        snps = overlay = None
        if meta.get("graph"):
            from ..io.annotations import SNPDB
            from ..utils import alphabet as _al
            snps = SNPDB(
                names=[str(x) for x in z["snp_names"]],
                types=z["snp_types"], jpos=z["snp_jpos"],
                lens=z["snp_lens"], alt_codes=z["snp_alt"],
                ins_seqs=[_al.encode(str(x)) for x in z["snp_ins"]],
                chroms=[str(x) for x in z["snp_chroms"]],
                tpos=z["snp_tpos"])
            overlay = z["snv_overlay"]
        return ShardedIndex(shards=shards,
                            bases=[int(b) for b in z["bases"]], ref=ref,
                            snps=snps, snv_overlay=overlay,
                            known_ss=(z["known_ss"] if "known_ss" in z
                                      else None),
                            known_exons=(z["known_exons"]
                                         if "known_exons" in z else None))


def build_table_index(ref: JoinedReference, kt: int | None = None,
                      table_stride: int = 1) -> FMIndex:
    """Seed-table-only index: the direct-address kmer table + packed text
    + fragment tables, WITHOUT the FM components (BWT/SA/ftab). The
    table-seeded step never touches the FM arrays, and skipping the
    suffix array makes Gbp-scale shard builds minutes instead of hours.
    FM fields hold 1-block dummies; FMIndex.device_bundle uploads none of
    them (the index has a table)."""
    from .seed_table import build_seed_table
    from ..utils import alphabet

    text = ref.joined
    n = int(text.size)
    packed = alphabet.pack_2bit(text)
    pad = (-packed.size) % 8
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint32)])
    fm = FMIndex(
        ref=ref, n=n, zoff=0, ftab_k=1,
        bwt_packed=np.zeros(8, np.uint32),
        text_packed=packed,
        occ=np.zeros((2, 4), np.int32),
        ccount=np.asarray([1, 1, 1, 1, n + 1], np.int32),
        sa=np.zeros(1, np.int32),
        ftab=np.zeros((4, 2), np.int32),
    )
    fm.st_starts, fm.st_pos, fm.st_k = build_seed_table(
        text, kt=kt, stride=table_stride)
    fm.st_stride = table_stride
    fm.table_only = True
    return fm


# default shard cap: comfortably under 2^31 with headroom for graph
# patches (~20% at human SNP density)
MAX_SHARD_BASES = (1 << 31) - (1 << 28)


def build_sharded(ref: JoinedReference, max_bases: int = MAX_SHARD_BASES,
                  table_only: bool = True, kt: int | None = None,
                  snps=None, haplotypes=None,
                  table_stride: int = 1) -> ShardedIndex:
    """Split at sequence boundaries into shards of <= max_bases joined
    length; each shard indexes its own joined text but carries GLOBAL
    sequence ids/names in its fragment tables, so alignments come out in
    global coordinates directly.

    With `snps` (a global-coordinate SNPDB), every shard becomes a graph
    (patched-fragment + SNV overlay) index over its SNP subset — the
    sharded equivalent of the reference's GRCh38+SNP .ht2l config
    (MANUAL.markdown:221-231); `haplotypes` are global SNP-index lists."""
    nfrag = len(ref.frag_joined)
    if kt is None:
        from .seed_table import pick_kt
        kt = pick_kt(min(int(ref.joined.size), max_bases))
    shards, bases = [], []
    start_f = 0
    while start_f < nfrag:
        end_f = start_f
        size = 0
        while end_f < nfrag:
            flen = int(ref.frag_len[end_f])
            if size and size + flen > max_bases:
                break
            size += flen
            end_f += 1
        base = int(ref.frag_joined[start_f])
        jend = int(ref.frag_joined[end_f - 1] + ref.frag_len[end_f - 1])
        sub = JoinedReference(
            names=ref.names, tlens=ref.tlens,
            joined=ref.joined[base:jend],
            frag_joined=ref.frag_joined[start_f:end_f] - base,
            frag_toff=ref.frag_toff[start_f:end_f],
            frag_tidx=ref.frag_tidx[start_f:end_f],
            frag_len=ref.frag_len[start_f:end_f])
        if snps is not None:
            from .graph_index import build_graph_table_index
            lsnps, lhaps = _slice_snps(snps, haplotypes, base, jend)
            fm = build_graph_table_index(sub, lsnps, haplotypes=lhaps,
                                         kt=kt, table_stride=table_stride)
        elif table_only:
            fm = build_table_index(sub, kt=kt, table_stride=table_stride)
        else:
            fm = build_fm_index(sub)
        shards.append(fm)
        bases.append(base)
        start_f = end_f
    _harmonize(shards)
    overlay = None
    if snps is not None:
        overlay = np.zeros(int(ref.joined.size), np.uint8)
        for s, b in zip(shards, bases):
            # overlays are zero-padded by _harmonize: only the true
            # primary span of each shard may write its global slice
            ov = s.snv_overlay[:s.primary_n]
            overlay[b:b + ov.size] = ov
    return ShardedIndex(shards=shards, bases=bases, ref=ref,
                        snps=snps, snv_overlay=overlay)


def _slice_snps(snps, haplotypes, base: int, jend: int):
    """Subset a global SNPDB to [base, jend) with shard-local jpos;
    haplotype index lists remap to local indices (groups crossing the
    boundary are dropped — shards split at sequence boundaries, so only
    malformed inputs ever do)."""
    from ..io.annotations import SNPDB

    sel = np.flatnonzero((snps.jpos >= base) & (snps.jpos < jend))
    remap = {int(g): l for l, g in enumerate(sel)}
    lsnps = SNPDB(
        names=[snps.names[int(i)] for i in sel],
        types=snps.types[sel],
        jpos=snps.jpos[sel] - base,
        lens=snps.lens[sel],
        alt_codes=snps.alt_codes[sel],
        ins_seqs=[snps.ins_seqs[int(i)] for i in sel],
        chroms=[snps.chroms[int(i)] for i in sel] if snps.chroms else [],
        tpos=snps.tpos[sel] if snps.tpos.size else snps.tpos)
    lhaps = None
    if haplotypes:
        lhaps = []
        for hap in haplotypes:
            if all(int(si) in remap for si in hap):
                lhaps.append([remap[int(si)] for si in hap])
    return lsnps, lhaps


def _harmonize(shards) -> None:
    """Pad every shard's device-visible arrays to common shapes, as the
    JAX package does to compile its step once for all shards. The port
    compiles nothing per shape but keeps the padding: the shard arrays,
    and so the SAM bytes, stay those of hisat2_tpu. Padding is
    unreachable: position rows beyond a shard's kmer count are masked by
    bucket counts; fragment padding sits past every valid joined
    offset."""
    if len(shards) <= 1:
        return
    max_pos = max(s.st_pos.size for s in shards)
    max_txt = max(s.text_packed.size for s in shards)
    max_frag = max(len(s.ref.frag_joined) for s in shards)
    for s in shards:
        if s.st_pos.size < max_pos:
            s.st_pos = np.pad(s.st_pos, (0, max_pos - s.st_pos.size))
        if s.text_packed.size < max_txt:
            s.text_packed = np.pad(
                s.text_packed, (0, max_txt - s.text_packed.size))
        r = s.ref
        nf = len(r.frag_joined)
        if nf < max_frag:
            pad = max_frag - nf
            big = np.int64(s.n + 1)
            r.frag_joined = np.concatenate(
                [r.frag_joined, np.full(pad, big, r.frag_joined.dtype)])
            r.frag_toff = np.concatenate(
                [r.frag_toff, np.zeros(pad, r.frag_toff.dtype)])
            r.frag_tidx = np.concatenate(
                [r.frag_tidx, np.zeros(pad, r.frag_tidx.dtype)])
            r.frag_len = np.concatenate(
                [r.frag_len, np.zeros(pad, r.frag_len.dtype)])
    # graph shards: equal patch/overlay shapes too. Patch padding uses a
    # +inf-like start so searchsorted never selects a padded patch for
    # any real augmented position.
    if hasattr(shards[0], "patch_start"):
        max_patch = max(s.patch_start.size for s in shards)
        max_ov = max(s.snv_overlay.size for s in shards)
        for s in shards:
            np_pad = max_patch - s.patch_start.size
            if np_pad:
                s.patch_start = np.concatenate(
                    [s.patch_start,
                     np.full(np_pad, (1 << 31) - 1, s.patch_start.dtype)])
                s.patch_ref = np.pad(s.patch_ref, (0, np_pad))
                s.patch_vpos = np.pad(s.patch_vpos, (0, np_pad))
                s.patch_shift = np.pad(s.patch_shift, (0, np_pad))
                s.patch_len = np.pad(s.patch_len, (0, np_pad))
            if s.snv_overlay.size < max_ov:
                s.snv_overlay = np.pad(
                    s.snv_overlay, (0, max_ov - s.snv_overlay.size))
