"""SNP-aware ("graph") index: patched-fragment FM + SNV overlay (PyTorch
port of hisat2_tpu/index/graph_index.py).

Equivalent role to the reference's graph GFM/GBWT (gfm.h graph mode +
gbwt_graph.h RefGraph/PathGraph): align reads through known variants with
no penalty, reporting Zs:Z SNP edits. Not a GBWT translation (its mapGLF
with F/M bitvector rank/select is irregular pointer chasing):

  * the indexed text is augmented with a short "patch" fragment per variant
    (flank + alt allele + flank), so seeds are found *through* any variant
    exactly as the graph index would find them (one alt per patch; the
    2F+len patch covers every read overlap of the variant given
    F >= read anchor length);
  * patch-region seed hits translate back to primary-text diagonals with a
    per-patch shift (indels) before verification, so every later stage
    sees only genomic coordinates (align/pipeline._stage_candidates);
  * scoring consults a dense 4-bit SNV overlay over the primary text: a
    mismatch whose read base equals a known alt allele costs nothing and
    is recorded as a SNP edit (ALT-compatible extension, hi_aligner.h
    GenomeHit::extend semantics).

Haplotype patches (reference .haplotype input) apply all variants of one
phased group in a single patch. The on-disk format (save/load) is the JAX
package's, so an index saved by either package loads in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..io.annotations import SNPDB, SNP_SGL, SNP_DEL, SNP_INS
from ..io.reference import JoinedReference
from ..utils import alphabet
from .fm_index import FMIndex, build_fm_index, FORMAT_VERSION

DEFAULT_FLANK = 40

_PATCH_KEYS = ("patch_start", "patch_ref", "patch_vpos", "patch_shift",
               "patch_len")


@dataclass
class GraphFMIndex(FMIndex):
    """FMIndex over the augmented text + variant metadata. `n` and
    `text_packed` cover the augmented text; `ref.joined` is the primary
    text only."""
    snps: SNPDB | None = None
    primary_n: int = 0
    patch_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    patch_ref: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    patch_vpos: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    patch_shift: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    patch_len: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    snv_overlay: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    # dense uint8 per primary position: 0 none, 1..4 alt+1, 15 multi

    @property
    def is_graph(self) -> bool:
        return True

    def device_bundle(self, device="cuda") -> dict:
        """FMIndex.device_bundle plus the graph keys: snv_packed (ceil(
        primary_n / 8),) int64 holding the uint32 words of the 4-bit
        overlay (8 nibbles a word, LSB first: 1 byte a primary base as
        int64 against the half byte of the uint32 original), primary_n as
        a 0-d int32 tensor (no sync where the step compares against it),
        and the patch tables, int32: patch_start (sorted offsets into the
        augmented text), patch_ref, patch_vpos, patch_shift, patch_len."""
        import torch
        d = super().device_bundle(device)

        def dev(a, dtype):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=device, dtype=dtype)
        d.update(
            snv_packed=dev(_pack4(self.snv_overlay).astype(np.int64),
                           torch.int64),
            primary_n=torch.tensor(int(self.primary_n), dtype=torch.int32,
                                   device=device),
            **{k: dev(getattr(self, k), torch.int32) for k in _PATCH_KEYS})
        return d

    def bundle_nbytes(self) -> int:
        """FMIndex.bundle_nbytes plus the graph keys."""
        return (super().bundle_nbytes()
                + 8 * -(-max(self.snv_overlay.size, 1) // 8)   # snv_packed
                + 4                                             # primary_n
                + 4 * len(_PATCH_KEYS) * self.patch_start.size)

    # ---------------- persistence ----------------

    def save(self, prefix: str) -> None:
        s = self.snps
        np.savez_compressed(
            prefix + ".npz",
            bwt_packed=self.bwt_packed, text_packed=self.text_packed,
            occ=self.occ, ccount=self.ccount, sa=self.sa, ftab=self.ftab,
            joined=self.ref.joined,
            frag_joined=self.ref.frag_joined, frag_toff=self.ref.frag_toff,
            frag_tidx=self.ref.frag_tidx, frag_len=self.ref.frag_len,
            tlens=self.ref.tlens,
            patch_start=self.patch_start, patch_ref=self.patch_ref,
            patch_vpos=self.patch_vpos, patch_shift=self.patch_shift,
            patch_len=self.patch_len, snv_overlay=self.snv_overlay,
            snp_types=s.types, snp_jpos=s.jpos, snp_lens=s.lens,
            snp_alt=s.alt_codes, snp_tpos=s.tpos,
            snp_names=np.asarray(s.names), snp_chroms=np.asarray(s.chroms),
            snp_ins=np.asarray([alphabet.decode(x) for x in s.ins_seqs]),
            known_ss=(self.known_ss if self.known_ss is not None
                      else np.zeros((0, 3), np.int64)),
            excluded_ss=(self.excluded_ss if self.excluded_ss is not None
                         else np.zeros((0, 3), np.int64)),
            st_starts=(self.st_starts if self.st_starts is not None
                       else np.zeros(0, np.int32)),
            st_pos=(self.st_pos if self.st_pos is not None
                    else np.zeros(0, np.int32)),
        )
        meta = dict(version=FORMAT_VERSION, n=self.n, zoff=self.zoff,
                    ftab_k=self.ftab_k, names=self.ref.names,
                    graph=True, primary_n=self.primary_n, st_k=self.st_k)
        with open(prefix + ".meta.json", "w") as fh:
            json.dump(meta, fh)

    @staticmethod
    def load(prefix: str) -> "GraphFMIndex":
        with open(prefix + ".meta.json") as fh:
            meta = json.load(fh)
        with np.load(prefix + ".npz", allow_pickle=False) as z:
            fields = {k: z[k] for k in z.files}
        snps = SNPDB(
            names=[str(x) for x in fields["snp_names"]],
            types=fields["snp_types"], jpos=fields["snp_jpos"],
            lens=fields["snp_lens"], alt_codes=fields["snp_alt"],
            ins_seqs=[alphabet.encode(str(x)) for x in fields["snp_ins"]],
            chroms=[str(x) for x in fields["snp_chroms"]],
            tpos=fields["snp_tpos"])
        return GraphFMIndex.from_arrays({**fields, **meta, "snps": snps})

    @staticmethod
    def from_object(other) -> "GraphFMIndex":
        """A GraphFMIndex over the arrays of another graph index object
        (the JAX package's GraphFMIndex, say): its FM arrays, patches,
        overlay and SNP table, so both packages search the same arrays."""
        s = other.snps
        snps = None if s is None else SNPDB(
            names=list(s.names), types=s.types, jpos=s.jpos, lens=s.lens,
            alt_codes=s.alt_codes, ins_seqs=list(s.ins_seqs),
            chroms=list(s.chroms), tpos=s.tpos)
        fields = FMIndex.fields_of(other)
        fields.update({k: getattr(other, k) for k in _PATCH_KEYS})
        fields.update(snps=snps, primary_n=other.primary_n,
                      snv_overlay=other.snv_overlay)
        return GraphFMIndex.from_arrays(fields)

    @staticmethod
    def from_arrays(fields: dict) -> "GraphFMIndex":
        """FMIndex.from_arrays plus the graph fields (`snps` an SNPDB)."""
        base = FMIndex.from_arrays(fields)
        kw = {f: getattr(base, f) for f in FMIndex.__dataclass_fields__}
        return GraphFMIndex(
            **kw, snps=fields["snps"], primary_n=int(fields["primary_n"]),
            snv_overlay=fields["snv_overlay"],
            **{k: fields[k] for k in _PATCH_KEYS})


def _pack4(overlay: np.ndarray) -> np.ndarray:
    """Pack uint8 nibbles (values 0..15), 8 per uint32, LSB-first."""
    n = overlay.size
    nw = -(-max(n, 1) // 8)
    padded = np.zeros(nw * 8, np.uint32)
    padded[:n] = overlay
    lanes = padded.reshape(nw, 8)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def build_patches(text: np.ndarray, snps: SNPDB,
                  haplotypes: list[list[int]] | None = None,
                  flank: int = DEFAULT_FLANK):
    """Patch-fragment construction shared by build_graph_index and
    build_graph_table_index: returns (aug_text, patch arrays, snv overlay). Patch arrays
    are offsets into aug_text; overlay covers the primary text only."""
    n0 = int(text.size)
    chunks = [text]
    p_start, p_ref, p_vpos, p_shift, p_len = [], [], [], [], []
    cur = n0
    overlay = np.zeros(n0, np.uint8)
    for i in range(len(snps)):
        jp = int(snps.jpos[i])
        t = int(snps.types[i])
        ln = int(snps.lens[i])
        lo = max(0, jp - flank)
        left = text[lo:jp]
        if t == SNP_SGL:
            var = np.array([snps.alt_codes[i]], np.uint8)
            right = text[jp + 1: jp + 1 + flank]
            shift = 0
            overlay[jp] = (snps.alt_codes[i] + 1) if overlay[jp] == 0 else 15
        elif t == SNP_DEL:
            var = np.zeros(0, np.uint8)
            right = text[jp + ln: jp + ln + flank]
            shift = ln
        else:  # insertion
            var = snps.ins_seqs[i]
            right = text[jp: jp + flank]
            shift = -ln
        patch = np.concatenate([left, var, right])
        chunks.append(patch)
        p_start.append(cur)
        p_ref.append(lo)
        p_vpos.append(len(left) + (len(var) if t == SNP_INS else
                                   (1 if t == SNP_SGL else 0)))
        p_shift.append(shift)
        p_len.append(patch.size)
        cur += patch.size

    # haplotype patches: all variants of one phased group applied together
    for hap in (haplotypes or []):
        first = int(snps.jpos[hap[0]])
        lo = max(0, first - flank)
        parts = [text[lo:first]]
        shift = 0
        cursor = first
        ok = True
        for si in hap:
            jp = int(snps.jpos[si])
            if jp < cursor:
                ok = False
                break
            parts.append(text[cursor:jp])
            t = int(snps.types[si])
            ln = int(snps.lens[si])
            if t == SNP_SGL:
                parts.append(np.array([snps.alt_codes[si]], np.uint8))
                cursor = jp + 1
            elif t == SNP_DEL:
                cursor = jp + ln
                shift += ln
            else:
                parts.append(snps.ins_seqs[si])
                cursor = jp
                shift -= ln
        if not ok:
            continue
        parts.append(text[cursor:cursor + flank])
        patch = np.concatenate(parts)
        chunks.append(patch)
        p_start.append(cur)
        p_ref.append(lo)
        # one accumulated shift, applied right of the last variant only
        p_vpos.append(patch.size - min(flank, text.size - cursor))
        p_shift.append(shift)
        p_len.append(patch.size)
        cur += patch.size

    aug = np.concatenate(chunks)
    return (aug,
            np.asarray(p_start, np.int64), np.asarray(p_ref, np.int64),
            np.asarray(p_vpos, np.int32), np.asarray(p_shift, np.int32),
            np.asarray(p_len, np.int32), overlay)


def _with_joined(ref: JoinedReference, joined: np.ndarray) -> JoinedReference:
    return JoinedReference(
        names=ref.names, tlens=ref.tlens, joined=joined,
        frag_joined=ref.frag_joined, frag_toff=ref.frag_toff,
        frag_tidx=ref.frag_tidx, frag_len=ref.frag_len)


def build_graph_index(ref: JoinedReference, snps: SNPDB, ftab_k: int = 10,
                      flank: int = DEFAULT_FLANK,
                      haplotypes: list[list[int]] | None = None
                      ) -> GraphFMIndex:
    """haplotypes: optional lists of SNP indices to co-apply in one patch
    (reference .haplotype input: phased variant combinations get their own
    indexed alt sequence, so a read carrying several nearby variants still
    seeds through all of them at once)."""
    text = ref.joined
    (aug, p_start, p_ref, p_vpos, p_shift, p_len,
     overlay) = build_patches(text, snps, haplotypes, flank)
    base = build_fm_index(_with_joined(ref, aug), ftab_k=ftab_k)
    # the packed text covers the augmented range for search; `ref.joined`
    # stays the primary text for coordinates and the host finish
    return GraphFMIndex(
        ref=_with_joined(ref, text), n=base.n, zoff=base.zoff,
        ftab_k=base.ftab_k,
        bwt_packed=base.bwt_packed, text_packed=base.text_packed,
        occ=base.occ, ccount=base.ccount, sa=base.sa, ftab=base.ftab,
        snps=snps, primary_n=int(text.size),
        patch_start=p_start, patch_ref=p_ref, patch_vpos=p_vpos,
        patch_shift=p_shift, patch_len=p_len,
        snv_overlay=overlay,
        st_starts=base.st_starts, st_pos=base.st_pos, st_k=base.st_k)


def build_graph_table_index(ref: JoinedReference, snps: SNPDB,
                            haplotypes: list[list[int]] | None = None,
                            kt: int | None = None,
                            flank: int = DEFAULT_FLANK,
                            table_stride: int = 1) -> GraphFMIndex:
    """Seed-table-only graph index (for Gbp-scale shards): augmented
    text + patches + SNV overlay WITHOUT the FM components. The
    table-seeded step never touches BWT/SA, and skipping the suffix array
    keeps builds at Gbp scale tractable."""
    from .seed_table import build_seed_table, pick_kt

    text = ref.joined
    (aug, p_start, p_ref, p_vpos, p_shift, p_len,
     overlay) = build_patches(text, snps, haplotypes, flank)
    packed = alphabet.pack_2bit(aug)
    pad = (-packed.size) % 8
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint32)])
    fm = GraphFMIndex(
        ref=ref, n=int(aug.size), zoff=0, ftab_k=1,
        bwt_packed=np.zeros(8, np.uint32),
        text_packed=packed,
        occ=np.zeros((2, 4), np.int32),
        ccount=np.asarray([1, 1, 1, 1, aug.size + 1], np.int32),
        sa=np.zeros(1, np.int32),
        ftab=np.zeros((4, 2), np.int32),
        snps=snps, primary_n=int(text.size),
        patch_start=p_start, patch_ref=p_ref, patch_vpos=p_vpos,
        patch_shift=p_shift, patch_len=p_len,
        snv_overlay=overlay, table_only=True)
    if kt is None:
        kt = pick_kt(int(aug.size))
    fm.st_starts, fm.st_pos, fm.st_k = build_seed_table(
        aug, kt=kt, stride=table_stride)
    fm.st_stride = table_stride
    return fm
