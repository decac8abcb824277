"""FM index: host build + device-resident bit-packed arrays (PyTorch port).

Equivalent role to the reference's GFM in linear mode (_linearFM, gfm.h:149) —
BWT + Occ checkpoints + ftab + SA sample + packed reference. The reference
stores the BWT in 64-byte cache-line "sides" with interleaved checkpoints
(gfm.h:2958 countBt2Side) because its unit of parallelism is one pthread; on
TPU the unit is a *batch of reads*, so we instead store:

  * bwt_packed:  2-bit-packed BWT in uint32 words (16 bases/word) — HBM
  * occ:         (nblocks+1, 4) int32 checkpoint counts every 128 symbols;
                 intra-block rank is popcount over 8 uint32 words (VPU work)
  * ccount:      (5,) int32 — C[] array, C[c] = 1 + #{chars < c} ('$' is row 0)
  * sa:          (m,) int32 full suffix array (offrate-0 equivalent; sampled
                 scheme for Gbp genomes is a follow-up)
  * ftab:        (4^k + 1,) int32 — interval of every k-mer is
                 ftab[p] = [top, bot), same role as gfm.h _ftab (k=10 default,
                 MANUAL.markdown:2023-2030); lookup is one gather
  * text_packed: 2-bit-packed joined text for verification windows
                 (BitPairReference equivalent, reference.h:99-112)

The on-disk format (save/load) is the JAX package's, so one built index
feeds both packages. `device_bundle(device)` carries the tensors the
aligner reads: the packed text, the fragment tables, the k-mer seed table
where the index has one, and (on request) the FM keys of backward search
and locate. Packed uint32 words travel as int64 tensors holding the
unsigned value: torch's `>>` on int32 is arithmetic, torch has no shifts
on uint32, and a word whose last base is G or T has bit 31 set.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..io.reference import JoinedReference, load_reference
from ..utils import alphabet
from .suffix_array import build_suffix_array, bwt_from_sa

OCC_BLOCK = 128                      # symbols per Occ checkpoint block
WORDS_PER_BLOCK = OCC_BLOCK // alphabet.BASES_PER_WORD  # 8 uint32 words

FORMAT_VERSION = 1


@dataclass
class FMIndex:
    ref: JoinedReference
    n: int                 # joined text length (BWT rows m = n + 1)
    zoff: int              # BWT row holding '$'
    ftab_k: int
    bwt_packed: np.ndarray    # (W,) uint32, padded to whole blocks
    text_packed: np.ndarray   # (Wt,) uint32
    occ: np.ndarray           # (nblocks + 1, 4) int32
    ccount: np.ndarray        # (5,) int32, ccount[4] = m
    sa: np.ndarray            # (m,) int32
    ftab: np.ndarray          # (4^k, 2) int32 [top, bot) per k-mer
    # transcriptome annotations baked at build time (--ss/--exon; the
    # reference stores these as SPLICESITE/EXON ALTs in .7.ht2)
    known_ss: np.ndarray = None   # (K, 3) int64 [left, right, strand(+1/-1/0)]
    known_exons: np.ndarray = None  # (K, 3) int64 [left, right, strand]
    # sites excluded at build for repetitive 16bp flanks (gfm.h:1736-1751
    # ss_seq duplicate check; printed only by hisat2-inspect --ss-all)
    excluded_ss: np.ndarray = None  # (K, 3) int64
    # sampled-SA mode (--offrate k, reference _offs/offRate semantics,
    # MANUAL.markdown:2008-2019): rows whose SA value % 2^k == 0 are
    # marked; lookups walk LF to a marked row. offrate 0 = full SA.
    offrate: int = 0
    samp_bits: np.ndarray = None   # (ceil(m/32),) uint32 marked-row bits
    samp_rank: np.ndarray = None   # (nblk+1,) int32, marked count / 512 rows
    samp_vals: np.ndarray = None   # (n_marked,) int32 SA values, row order
    # direct-address seed table (TPU-first seeding; index/seed_table.py):
    # kmer code -> contiguous slice of sorted positions. Replaces the LF
    # chain + SA walk on the hot path with two gather rounds.
    st_starts: np.ndarray = None   # (4^st_k + 1,) int32
    st_pos: np.ndarray = None      # (n_kmers + pad,) int32
    st_k: int = 0
    # stride-sampled table (Gbp memory diet): only kmer starts at
    # positions %% st_stride == 0 are stored; seed offsets jitter by
    # residue so every diagonal stays reachable (ops/search.table_seed)
    st_stride: int = 1
    # a table-only index (index/sharded.build_table_index) holds 1-block
    # dummies in its FM fields; its bundle, having a table, uploads none
    table_only: bool = False

    @property
    def m(self) -> int:
        return self.n + 1

    # ---------------- device bundle ----------------

    def device_bundle(self, device="cuda") -> dict:
        """Tensors on `device` for the aligner's device stages.

        Always present. Packed text views (int64 words holding uint32
        values):
          text_packed   (Wt,) the 2-bit text
          text_rows     (nr+1, 16) row view: a window of <= 256 chars is
                        two whole-row gathers (ops/rank.gather_rows2)
          text_rows_ov  (nro+1, 16) 50%-overlapping rows (8-word stride),
                        padded with 128 leading zero chars: a window of
                        <= 128 chars lies inside ONE row, and negative
                        starts (chromosome-start DP windows) align with
                        no right-shift cascade
        Fragment tables (int32): frag_joined, frag_end, frag_tidx. `n` is
        the joined text length, an int.

        With a seed table (st_k > 0), int32: st_starts (4^kt+1,), st_pairs
        (4^kt, 2) [start, end] rows for kt <= 12, st_pos_rows (nrp+1, RW)
        with RW = 128 for high-load tables else 32; plus st_k and
        st_stride as ints.

        FM keys, present exactly when the index has no seed table, which
        is when the aligner seeds by backward search (an index with a
        table seeds from the table, with seed_mode=False too, and never
        reads them, so the table path's device memory does not grow):
          sides       (nblocks, 12) int64: a block's 4 Occ checkpoints and
                      its 8 BWT words, one contiguous row per rank. As
                      int64 a row is 96 bytes where the uint32 original is
                      48: 0.75 byte a base, 3.5 MB at 4.6 Mbp and 2.3 GB
                      at 3.1 Gbp
          bwt_packed  (W,) int64 holding uint32 words
          ccount      (5,) int32; `m` = ccount[4] (BWT rows) as an int
          ftab        (4^ftab_k, 2) int32 [top, bot); ftab_k, zoff ints
          sa          (m,) int32, empty for a sampled index
        and with offrate > 0 the sample: samp_bits (ceil(m/32),) int64
        holding uint32 words, samp_rank, samp_vals (int32), samp_ival =
        2^offrate as an int.
        """
        import torch

        def dev(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=device, dtype=dtype)
        r = self.ref
        out = {}
        if self.st_k and self.st_starts is not None:
            sp = self.st_pos
            rw = 128 if self.n > 3 * (4 ** self.st_k) else 32
            nrp = -(-sp.size // rw)
            sp_rows = np.zeros((nrp + 1, rw), np.int32)
            sp_rows.reshape(-1)[:sp.size] = sp
            out.update(st_starts=dev(self.st_starts, torch.int32),
                       st_pos_rows=dev(sp_rows),
                       st_k=int(self.st_k),
                       st_stride=max(1, int(self.st_stride)))
            if self.st_starts.size <= (1 << 24) + 1:
                out["st_pairs"] = dev(np.stack(
                    [self.st_starts[:-1], self.st_starts[1:]], axis=1),
                    torch.int32)
        tp = self.text_packed.astype(np.int64)
        nr = -(-tp.size // 16)
        trows = np.zeros((nr + 1, 16), np.int64)
        trows.reshape(-1)[:tp.size] = tp
        flat = np.zeros(8 + (nr + 1) * 16, np.int64)
        flat[8:8 + tp.size] = tp
        nro = max(1, -(-(tp.size + 8) // 8))
        ov = np.zeros((nro + 1, 16), np.int64)
        for j in range(2):
            ov[:nro, 8 * j: 8 * (j + 1)] = \
                flat[8 * j: 8 * (nro + j)].reshape(nro, 8)
        out.update(
            text_packed=dev(tp),
            text_rows=dev(trows),
            text_rows_ov=dev(ov),
            frag_joined=dev(r.frag_joined, torch.int32),
            frag_end=dev(r.frag_joined + r.frag_len, torch.int32),
            frag_tidx=dev(r.frag_tidx, torch.int32),
            n=int(self.n),
        )
        if "st_starts" not in out:
            nblocks = self.occ.shape[0] - 1
            sides = np.empty((nblocks, 4 + WORDS_PER_BLOCK), np.int64)
            sides[:, :4] = self.occ[:-1]
            sides[:, 4:] = self.bwt_packed[
                : nblocks * WORDS_PER_BLOCK].reshape(nblocks, WORDS_PER_BLOCK)
            out.update(
                sides=dev(sides),
                bwt_packed=dev(self.bwt_packed.astype(np.int64)),
                ccount=dev(self.ccount, torch.int32),
                m=int(self.ccount[4]),
                sa=dev(self.sa, torch.int32),
                ftab=dev(self.ftab, torch.int32),
                zoff=int(self.zoff),
                ftab_k=int(self.ftab_k),
            )
            if self.offrate and self.samp_bits is not None:
                out.update(
                    samp_bits=dev(self.samp_bits.astype(np.int64)),
                    samp_rank=dev(self.samp_rank, torch.int32),
                    samp_vals=dev(self.samp_vals, torch.int32),
                    samp_ival=int(1 << self.offrate))
        return out

    def bundle_nbytes(self) -> int:
        """Bytes device_bundle() would put on the device, from the host
        arrays' shapes alone (nothing is built or uploaded): what a shard
        costs before it is brought to the card."""
        tot = 0
        has_table = bool(self.st_k and self.st_starts is not None)
        if has_table:
            rw = 128 if self.n > 3 * (4 ** self.st_k) else 32
            tot += 4 * self.st_starts.size
            tot += 4 * (-(-self.st_pos.size // rw) + 1) * rw
            if self.st_starts.size <= (1 << 24) + 1:
                tot += 8 * (self.st_starts.size - 1)
        wt = self.text_packed.size
        tot += 8 * wt                                   # text_packed
        tot += 8 * 16 * (-(-wt // 16) + 1)              # text_rows
        tot += 8 * 16 * (max(1, -(-(wt + 8) // 8)) + 1)  # text_rows_ov
        tot += 3 * 4 * self.ref.frag_joined.size        # fragment tables
        if not has_table:
            tot += 8 * 12 * (self.occ.shape[0] - 1)      # sides
            tot += 8 * self.bwt_packed.size
            tot += 4 * (self.ccount.size + self.sa.size + self.ftab.size)
            if self.offrate and self.samp_bits is not None:
                tot += 8 * self.samp_bits.size
                tot += 4 * (self.samp_rank.size + self.samp_vals.size)
        return tot

    @staticmethod
    def bundle_bytes(bundle: dict) -> int:
        """Bytes the tensors of a device bundle hold."""
        return sum(t.numel() * t.element_size() for t in bundle.values()
                   if hasattr(t, "element_size"))

    # ---------------- persistence ----------------

    def save(self, prefix: str) -> None:
        """Write <prefix>.npz + <prefix>.meta.json (our native index format,
        filling the role of the 8 .ht2 files, SURVEY.md §2.2)."""
        np.savez_compressed(
            prefix + ".npz",
            bwt_packed=self.bwt_packed, text_packed=self.text_packed,
            occ=self.occ, ccount=self.ccount, sa=self.sa, ftab=self.ftab,
            joined=self.ref.joined,
            frag_joined=self.ref.frag_joined, frag_toff=self.ref.frag_toff,
            frag_tidx=self.ref.frag_tidx, frag_len=self.ref.frag_len,
            tlens=self.ref.tlens,
            known_ss=(self.known_ss if self.known_ss is not None
                      else np.zeros((0, 3), np.int64)),
            known_exons=(self.known_exons if self.known_exons is not None
                         else np.zeros((0, 3), np.int64)),
            excluded_ss=(self.excluded_ss if self.excluded_ss is not None
                         else np.zeros((0, 3), np.int64)),
            samp_bits=(self.samp_bits if self.samp_bits is not None
                       else np.zeros(0, np.uint32)),
            samp_rank=(self.samp_rank if self.samp_rank is not None
                       else np.zeros(0, np.int32)),
            samp_vals=(self.samp_vals if self.samp_vals is not None
                       else np.zeros(0, np.int32)),
            st_starts=(self.st_starts if self.st_starts is not None
                       else np.zeros(0, np.int32)),
            st_pos=(self.st_pos if self.st_pos is not None
                    else np.zeros(0, np.int32)),
        )
        meta = dict(version=FORMAT_VERSION, n=self.n, zoff=self.zoff,
                    ftab_k=self.ftab_k, names=self.ref.names,
                    offrate=self.offrate, st_k=self.st_k,
                    st_stride=self.st_stride)
        with open(prefix + ".meta.json", "w") as fh:
            json.dump(meta, fh)

    @staticmethod
    def load(prefix: str) -> "FMIndex":
        """Read <prefix>.npz + <prefix>.meta.json as either package writes
        them (FMIndex.save; a graph index comes back as a GraphFMIndex).
        A prefix with <prefix>.1.ht2 and no .meta.json is a
        reference-built index: its files are parsed and the index is
        rebuilt from the recovered text (io/ht2.load_ht2)."""
        if not os.path.exists(prefix + ".meta.json") \
                and os.path.exists(prefix + ".1.ht2"):
            from ..io.ht2 import load_ht2
            return load_ht2(prefix)
        with open(prefix + ".meta.json") as fh:
            meta = json.load(fh)
        if meta.get("graph"):
            from .graph_index import GraphFMIndex
            return GraphFMIndex.load(prefix)
        with np.load(prefix + ".npz") as z:
            fields = {k: z[k] for k in z.files}
        return FMIndex.from_arrays({**fields, **meta})

    @staticmethod
    def fields_of(other) -> dict:
        """The saved fields (from_arrays' input) of an index object with
        this class's attributes and a `ref` of JoinedReference's."""
        r = other.ref
        fields = {k: getattr(other, k) for k in (
            "n", "zoff", "ftab_k", "bwt_packed", "text_packed", "occ",
            "ccount", "sa", "ftab", "known_ss", "known_exons",
            "excluded_ss", "offrate", "samp_bits", "samp_rank", "samp_vals",
            "st_starts", "st_pos", "st_k", "st_stride")}
        fields["table_only"] = bool(getattr(other, "table_only", False))
        fields.update(names=r.names, tlens=r.tlens, joined=r.joined,
                      frag_joined=r.frag_joined, frag_toff=r.frag_toff,
                      frag_tidx=r.frag_tidx, frag_len=r.frag_len)
        return fields

    @staticmethod
    def from_object(other) -> "FMIndex":
        """An FMIndex over the arrays of another index object (the JAX
        package's FMIndex, say), so both search the very same arrays; a
        graph index (one with an SNV overlay) gives a GraphFMIndex."""
        if getattr(other, "snv_overlay", None) is not None:
            from .graph_index import GraphFMIndex
            return GraphFMIndex.from_object(other)
        return FMIndex.from_arrays(FMIndex.fields_of(other))

    @staticmethod
    def from_arrays(fields: dict) -> "FMIndex":
        """Build an FMIndex from the saved fields: the arrays of the .npz
        plus the scalars of the .meta.json (n, zoff, ftab_k, names, ...),
        as save() writes them. Empty optional arrays mean "absent"."""
        if fields.get("version", FORMAT_VERSION) != FORMAT_VERSION:
            raise ValueError(f"index format version {fields['version']} "
                             f"!= {FORMAT_VERSION}")

        def opt(k):
            v = fields.get(k)
            return v if v is not None and v.size else None
        ref = JoinedReference(
            names=list(fields["names"]), tlens=fields["tlens"],
            joined=fields["joined"], frag_joined=fields["frag_joined"],
            frag_toff=fields["frag_toff"], frag_tidx=fields["frag_tidx"],
            frag_len=fields["frag_len"])
        ks = fields.get("known_ss")
        ke = fields.get("known_exons")
        return FMIndex(ref=ref, n=int(fields["n"]), zoff=int(fields["zoff"]),
                       ftab_k=int(fields["ftab_k"]),
                       bwt_packed=fields["bwt_packed"],
                       text_packed=fields["text_packed"],
                       occ=fields["occ"], ccount=fields["ccount"],
                       sa=fields["sa"], ftab=fields["ftab"],
                       known_ss=ks, known_exons=ke,
                       excluded_ss=opt("excluded_ss"),
                       offrate=int(fields.get("offrate", 0)),
                       samp_bits=fields.get("samp_bits"),
                       samp_rank=fields.get("samp_rank"),
                       samp_vals=fields.get("samp_vals"),
                       st_k=int(fields.get("st_k", 0)),
                       st_stride=int(fields.get("st_stride", 1)),
                       st_starts=opt("st_starts"), st_pos=opt("st_pos"),
                       table_only=bool(fields.get("table_only", False)))


def _pack_to_blocks(codes: np.ndarray) -> np.ndarray:
    """2-bit pack, padded out to whole OCC_BLOCK blocks."""
    packed = alphabet.pack_2bit(codes)
    nwords = packed.size
    pad = (-nwords) % WORDS_PER_BLOCK
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint32)])
    return packed


def _build_occ(bwt: np.ndarray) -> np.ndarray:
    """occ[b, c] = #occurrences of c in bwt[0 : 128*b) ('$' cell counts as 0;
    queries correct for it via zoff)."""
    m = bwt.size
    nblocks = -(-m // OCC_BLOCK)
    onehot = np.zeros((nblocks * OCC_BLOCK, 4), dtype=np.int32)
    onehot[np.arange(m), bwt] = 1
    per_block = onehot.reshape(nblocks, OCC_BLOCK, 4).sum(axis=1)
    occ = np.zeros((nblocks + 1, 4), dtype=np.int32)
    np.cumsum(per_block, axis=0, out=occ[1:])
    return occ


SAMP_BLOCK = 512  # marked-row rank checkpoint interval (bits)


def build_sampled_sa(sa: np.ndarray, offrate: int):
    """Value-sampled SA (reference offrate semantics): mark rows whose SA
    value is a multiple of 2^offrate (plus row 0, the sentinel), keep only
    their values; lookups LF-walk to a marked row."""
    ival = 1 << offrate
    m = sa.size
    marked = (sa % ival == 0)
    marked[0] = True
    nw = -(-m // 32)
    bits = np.zeros(nw * 32, bool)
    bits[:m] = marked
    lanes = bits.reshape(nw, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    samp_bits = np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)
    nblk = -(-m // SAMP_BLOCK)
    per_blk = np.zeros(nblk * SAMP_BLOCK, np.int32)
    per_blk[:m] = marked
    per_blk = per_blk.reshape(nblk, SAMP_BLOCK).sum(axis=1)
    samp_rank = np.zeros(nblk + 1, np.int32)
    np.cumsum(per_blk, out=samp_rank[1:])
    samp_vals = sa[marked].astype(np.int32)
    return samp_bits, samp_rank, samp_vals


def _build_ftab(text: np.ndarray, sa: np.ndarray, k: int) -> np.ndarray:
    """k-mer interval table: ftab[p] = [top, bot) of pattern p, shape (4^k, 2).

    Key construction: each row's k-prefix as a big-endian base-4 integer, with
    suffixes shorter than k padded with 0s and tie-broken *before* full
    suffixes (the sentinel sorts first) via key*2 + is_full. That keeps keys
    nondecreasing in SA order while excluding short suffixes from every
    interval — the edge case the reference handles with its eftab
    (gfm.h _eftab)."""
    n = text.size
    m = sa.size
    sa64 = sa.astype(np.int64)
    keys = np.zeros(m, dtype=np.int64)
    # digits: text[sa+j] for j < remaining length else 0 (pad)
    for j in range(k):
        pos = sa64 + j
        digit = np.where(pos < n, text[np.minimum(pos, n - 1)], 0)
        keys = keys * 4 + digit
    is_full = (sa64 + k <= n).astype(np.int64)
    keys = keys * 2 + is_full
    pvals = np.arange(4 ** k, dtype=np.int64)
    top = np.searchsorted(keys, 2 * pvals + 1, side="left")
    bot = np.searchsorted(keys, 2 * pvals + 1, side="right")
    return np.stack([top, bot], axis=1).astype(np.int32)


def build_fm_index(ref: JoinedReference, ftab_k: int = 10,
                   offrate: int = 0, seed_table: bool = True) -> FMIndex:
    text = ref.joined
    n = int(text.size)
    # keep ftab small relative to the genome (tiny tests use tiny k)
    while ftab_k > 1 and 4 ** ftab_k > max(64, 4 * n):
        ftab_k -= 1
    sa = build_suffix_array(text)
    bwt, zoff = bwt_from_sa(text, sa)
    counts = np.bincount(text, minlength=4).astype(np.int64)
    ccount = np.zeros(5, dtype=np.int32)
    ccount[0] = 1
    np.cumsum(counts, out=counts)
    ccount[1:] = 1 + counts
    fm = FMIndex(
        ref=ref, n=n, zoff=zoff, ftab_k=ftab_k,
        bwt_packed=_pack_to_blocks(bwt),
        text_packed=_pack_to_blocks(text),
        occ=_build_occ(bwt),
        ccount=ccount,
        sa=sa.astype(np.int32),
        ftab=_build_ftab(text.astype(np.int64), sa, ftab_k),
    )
    if offrate > 0:
        fm.offrate = offrate
        fm.samp_bits, fm.samp_rank, fm.samp_vals = \
            build_sampled_sa(sa, offrate)
        fm.sa = np.zeros(0, np.int32)     # the sample replaces the full SA
    if seed_table:
        from .seed_table import build_seed_table
        fm.st_starts, fm.st_pos, fm.st_k = build_seed_table(text)
    return fm


def build_from_fasta(paths, ftab_k: int = 10) -> FMIndex:
    return build_fm_index(load_reference(paths), ftab_k=ftab_k)
