"""Single-end alignment pipeline, DNA and spliced RNA (PyTorch port of
hisat2_tpu's).

Equivalent role to the reference's HI_Aligner::go (hi_aligner.h:4048), as
batched tensor stages over a read wavefront; one call per batch
(_stage_align_packed) runs them all on the aligner's device:

  1. unpack the 2-bit reads, add reverse complements  _unpack_reads,
                                                      _with_revcomp
  2. seed: from the k-mer table where the index has   ops/search.table_lookup
     one, else by FM backward search (22 bp stride    ops/search.seed_search,
     seeds, SA ranges expanded to positions)          ops/locate.expand_range
  3. dedup candidates, rank them by seed votes        _stage_candidates
  4. clip-aware ungapped verify                       ops/extend.verify_ungapped
  5. sensitive re-seed of reads that failed: a dense  _se_core
     table pass, or maximal segments on the FM path   ops/search.partial_search
  6. gapped DP rescue (the CUDA kernel)               _stage_dp
  7. fw/rc merge, top-K2                              _stage_merge
  8. finalize rows into the int16 fastpack            _stage_fin_rows,
                                                      _stage_fastpack
  9. host: SAM through native/samfmt.cpp (align/emit.py); slow reads
     through the Aligner's host finalizers and the native DP traceback.

The fastpack layout is the JAX package's, so the same native finisher
turns it into the same SAM bytes.

RNA mode (AlignerOpts.spliced): the same step also runs the splice pass 1
(ops/splice.spliced_stage: junction lanes from the candidate grid and the
site table, scored and gated, the anchor scan for short far anchors) and
ships every row's grid; the host finish (emit._finish_fastpack_cols) runs
Aligner._splice_rescue and its cleanup rounds, publishes novel sites to
the site table (Aligner.ssdb), chains further introns
(_splice_second_pass) and finalizes spliced winners (_spliced_fin_rows,
_finalize_spliced).

seed_mode=False takes the per-read reference path instead: host-driven
stages with their syncs (Aligner._device_align, _segment_fallback,
_merged_host), finalized by Aligner.align_batch into ReadResults and
written by results_to_sam, or by emit._align_and_emit_legacy.

Ties: every top-k of the JAX version is a stable sort here (descending
0/1 masks and ascending negated scores keep ties in ascending index
order, as lax.top_k and the stable lax.sort do). Index tensors are
clamped explicitly wherever the JAX code relied on clamping gathers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.fm_index import FMIndex
from ..io.annotations import SNP_DEL, SNP_INS, SNP_SGL
from ..io.reads import ReadBatch
from ..io import sam as samio
from ..ops import extend as _extend, locate as _locate, rank as _rank
from ..ops import search as _search
from ..ops import splice as _splice, splice_host as _splice_host
from ..ops import sw as _sw
from ..ops.dp_cuda import dp_score
from ..ops.extend import NEG_INF
from ..utils import alphabet
from ..utils.metrics import Metrics
from . import mapq as _mapq
from . import splice_model as _splice_model
from .scoring import DEFAULT_SCORING, Scoring, mm_pen_of, sc_pen_of
from .splice_db import SpliceSiteDB

I32 = torch.int32
_DEC5 = np.frombuffer(b"ACGTN", dtype=np.uint8)
BIG = 0x7FFFFFFF           # invalid-candidate position sentinel

# dense re-seed width for the table fallback: offsets 0,4,8,... cover a
# 100bp read end to end (the sensitive pass for reads whose stride seeds
# all carry errors)
FB_TABLE_SEEDS = 24


def _filter_reason(batch, i: int, lens) -> str:
    """YF code for a filtered read: NS (N-ceiling), LN (length 0), QC
    (QSEQ filter field, --qc-filter) — reference filter codes."""
    if lens[i]:
        return "NS"
    rds = getattr(batch, "reads", None)
    if rds and i < len(rds) and not getattr(rds[i], "qc_ok", True):
        return "QC"
    return "LN"


def min_anchor(n: int) -> int:
    """The reference's _minK: the minimum anchor of a genome of n bases,
    ceil(log4 n), at least 8."""
    return max(8, int(np.ceil(np.log(max(n, 4)) / np.log(4))))


@dataclass
class AlignerOpts:
    khits: int = 5                 # -k: max alignments reported per read
    max_seeds: int = 16            # segments used per orientation
    n_seeds: int = 8               # stride seeds per orientation (seed mode)
    locs_per_seg: int = 8          # SA rows / positions expanded per seed
    top_cands: int = 16            # candidates kept after ungapped ranking
    verify_cands: int = 16         # vote-ranked loci verified per orientation
    dp_pad: int = 16               # ref-window padding each side for DP
    no_dp: bool = False            # disable gapped rescue
    minins: int = 0                # -I: minimum fragment length (PE)
    maxins: int = 1000             # -X: maximum fragment length (PE)
    fr: str = "fr"                 # --fr/--rf/--ff mate orientations
    no_mixed: bool = False         # --no-mixed
    no_discordant: bool = False    # --no-discordant
    # PE mate-extent geometry (pe.h PE_ALS_* classes): dovetailed pairs
    # are non-concordant unless --dovetail; --no-contain/--no-overlap
    # reject containment/overlap
    dovetail: bool = False
    no_contain: bool = False
    no_overlap: bool = False
    nofw: bool = False             # --nofw: skip forward orientation
    norc: bool = False             # --norc: skip reverse-complement
    omit_sec_seq: bool = False     # --omit-sec-seq: '*' SEQ/QUAL on
    #                                secondary records (sam.h)
    seed_mode: bool = True         # stride seeds (fast) + segment fallback;
    #                                False = the per-read reference path
    zs_tags: bool = False          # emit Zs:Z SNP-edit tags (sam.h:999;
    #                                graph indexes, via the per-read path)
    # spliced alignment (RNA mode — the reference default; DNA is
    # --no-spliced-alignment), single-end and paired-end
    spliced: bool = False
    min_intron: int = 20           # --min-intronlen
    max_intron: int = 500000       # --max-intronlen
    pairs_per_read: int = 8        # junction diagonal-pairs explored
    no_temp_splicesite: bool = False  # disable novel-site reuse
    dta: bool = False              # assembler-tailored: novel splice sites
    #                                require longer anchors (reference --dta)
    tmo: bool = False              # --tmo: transcriptome-mapping only


@dataclass
class Alignment:
    """One resolved alignment on the joined text (host-side)."""
    joined_pos: int
    fw: bool
    score: int
    cigar: list[tuple[str, int]] = field(default_factory=list)
    nmm: int = 0
    gap_opens: int = 0
    gap_exts: int = 0
    md: str = ""
    nm: int = 0
    n_refns: int = 0
    tidx: int = -1
    toff: int = -1
    xs_strand: str | None = None   # splice strand (XS:A)
    zs_snps: str | None = None     # SNP edits (Zs:Z)
    rname_override: str | None = None
    nh_override: int | None = None

    @property
    def ref_span(self) -> int:
        return sum(n for op, n in self.cigar if op in ("M", "D", "N", "=", "X"))


@dataclass
class ReadResult:
    """Alignment outcome for one read: primary + secondaries + MAPQ info."""
    alns: list[Alignment] = field(default_factory=list)   # best first
    best: int = NEG_INF
    secbest: int | None = None
    filtered: str | None = None    # YF:Z code (e.g. 'NS')

    @property
    def aligned(self) -> bool:
        return bool(self.alns)


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

def _topk01(mask: torch.Tensor, k: int):
    """lax.top_k over a 0/1 mask: (values, indices) of the first k rows
    with the 1s first, ties in ascending index order."""
    v, ix = torch.sort(mask.to(I32), descending=True, stable=True)
    return v[:k], ix[:k].to(I32)


def _sort_desc(key: torch.Tensor, *vals: torch.Tensor, k: int):
    """Stable descending sort of `key` along dim 1, first k columns of key
    and of each of `vals` carried along (lax.sort((-key, *vals),
    num_keys=1) sliced to k)."""
    order = torch.sort(-key, dim=1, stable=True).indices[:, :k]
    return [torch.gather(a, 1, order) for a in (key, *vals)]


def _min_scores(minsc_i: float, minsc_s: float, lens: torch.Tensor):
    """ceil(I + S * len) in float32, as the device computes it (the host
    uses float64: emit._finish_fastpack)."""
    f32 = torch.float32
    i = torch.tensor(minsc_i, dtype=f32, device=lens.device)
    s = torch.tensor(minsc_s, dtype=f32, device=lens.device)
    return torch.ceil(i + s * lens.to(f32)).to(I32)


def _with_revcomp(seqs: torch.Tensor, quals: torch.Tensor,
                  lens: torch.Tensor):
    """(B, L) -> (2B, L): rows [0:B) forward, [B:2B) reverse-complement."""
    B, L = seqs.shape
    dev = seqs.device
    lens = lens.to(I32)
    in_read = torch.arange(L, dtype=I32, device=dev)[None, :] < lens[:, None]
    s = torch.where(in_read, seqs.to(I32).clamp(max=4), 4)
    q = torch.where(in_read, quals.to(I32), 0)
    sr = s.flip(1)
    rev = torch.where(sr < 4, 3 - sr, 4)
    dbl = torch.cat([rev, torch.full((B, L), 4, dtype=I32, device=dev)], 1)
    dblq = torch.cat([q.flip(1), torch.zeros((B, L), dtype=I32, device=dev)],
                     1)
    sh = L - lens
    rc = _rank._shift_words(dbl, sh, L)
    rq = _rank._shift_words(dblq, sh, L)
    return torch.cat([s, rc]), torch.cat([q, rq]), torch.cat([lens, lens])


def _stage_candidates(idx: dict, sctab: dict, seqs, quals, lens,
                      max_seeds: int, locs_per_seg: int, top_cands: int,
                      min_seg_len: int = 3, seeder: str = "segments",
                      ftab_k: int = 10, verify_cands: int = 0) -> dict:
    """Orientations, seeding, dedup, vote ranking, ungapped verify, top-T.

    seeder 'table' spreads max_seeds k-mer seeds over the read (the
    throughput pass), 'table_dense' places them every 4 bases (the
    sensitive re-seed); 'seeds' uses fixed 22 bp stride seeds (ftab jump
    + a short LF chain) and 'segments' walks the whole read for maximal
    segments (the sensitive FM pass), both expanding SA ranges to
    positions; min_seg_len and ftab_k only matter to these two.

    Returns per orientation-row (R = 2B): top candidate positions (R, T),
    scores (R, T), nmm (R, T), exhausted flags (R,) — True when no seed's
    bucket or SA interval overflowed locs_per_seg — and the oriented
    reads."""
    seqs2, quals2, lens2 = _with_revcomp(seqs, quals, lens)
    R, L = seqs2.shape
    dev = seqs2.device
    if seeder in ("table", "table_dense"):
        th = _search.table_lookup(
            idx, seqs2, lens2, n_seeds=max_seeds, locs_per_seg=locs_per_seg,
            stride=(4 if seeder == "table_dense" else 0))
        locs, lvalid = th["locs"], th["lvalid"]
        seed_off = th["off"]
        exhausted = th["exhausted"]
    else:
        if seeder == "seeds":
            hits = _search.seed_search(idx, seqs2, lens2, seed_len=22,
                                       n_seeds=max_seeds, ftab_k=ftab_k)
        else:
            hits = _search.partial_search(idx, seqs2, lens2,
                                          max_hits=max_seeds)
        # candidate start = SA[row] - segment read-offset
        locs, lvalid = _locate.expand_range(idx, hits["top"], hits["bot"],
                                            locs_per_seg)    # (R, S, locs)
        seg_ok = (torch.arange(max_seeds, dtype=I32, device=dev)[None, :]
                  < hits["n"][:, None])                      # (R, S)
        # anchor length floor: the reference's _minK = ceil(log4 |genome|)
        # (hi_aligner.h:3979); shorter matches occur by chance everywhere
        seg_ok &= hits["len"] >= min_seg_len
        seed_off = hits["off"]
        lvalid = lvalid & seg_ok[:, :, None]
        width = hits["bot"] - hits["top"]
        exhausted = torch.where(seg_ok, width <= locs_per_seg,
                                torch.ones_like(seg_ok)).all(dim=1)
    if "patch_start" in idx and idx["patch_start"].shape[0] > 0:
        # graph mode: seed occurrences inside variant patch fragments map
        # back to primary-text coordinates (with the indel shift when the
        # seed sits right of the variant) before diagonals are formed, so
        # the rest of the step only ever sees genomic coordinates. The
        # translation uses the occurrence position (always inside one
        # patch), not the diagonal origin (which may precede the patch).
        ps = idx["patch_start"]
        pi = torch.searchsorted(ps, locs.contiguous(), right=True) - 1
        pi = pi.clamp(0, ps.shape[0] - 1)
        o = locs - ps[pi]
        shift = torch.where(o >= idx["patch_vpos"][pi],
                            idx["patch_shift"][pi], 0)
        locs = torch.where(locs >= idx["primary_n"],
                           idx["patch_ref"][pi] + o + shift, locs)
    cand = (locs - seed_off[:, :, None]).reshape(R, -1)
    valid = lvalid.reshape(R, -1)

    # dedup identical positions (sort asc; invalid -> +inf sentinel), then
    # rank distinct loci by seed votes (how many seeds landed on the same
    # diagonal) and verify only the top `verify_cands`
    key = torch.where(valid, cand, BIG)
    C = key.shape[1]
    skey = torch.sort(key, dim=1).values
    first = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                       skey[:, 1:] != skey[:, :-1]], 1) & (skey < BIG)
    arc = torch.arange(C, dtype=I32, device=dev)[None, :]
    ar = torch.where(first, arc, C)
    # votes per run of equal positions: next run-start index minus own
    nxt = torch.cat([ar[:, 1:], torch.full((R, 1), C, dtype=I32, device=dev)],
                    1)
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    vote_key = torch.where(first, nxt - arc, -1)
    verify_cands = min(verify_cands or max(top_cands, 16), C)
    vk, vcand = _sort_desc(vote_key, skey, k=verify_cands)
    vvalid = vk > 0
    vcand = torch.where(vvalid, vcand, BIG)

    res = _extend.verify_ungapped(idx, sctab, seqs2, quals2, lens2,
                                  vcand, vvalid)
    T = top_cands
    Tv = min(T, verify_cands)
    sc_top, pos_top, nmm_top = _sort_desc(res["score"], vcand, res["nmm"],
                                          k=Tv)
    if Tv < T:
        # pad back to the standard T columns
        def pad(a, v):
            return torch.cat([a, torch.full((R, T - Tv), v, dtype=a.dtype,
                                            device=dev)], 1)
        pos_top, sc_top, nmm_top = (pad(pos_top, BIG), pad(sc_top, NEG_INF),
                                    pad(nmm_top, 0))
    return dict(pos=pos_top, score=sc_top, nmm=nmm_top,
                exhausted=exhausted, seqs2=seqs2, quals2=quals2,
                lens2=lens2)


def _stage_dp(idx: dict, sctab: dict, seqs2, quals2, lens2, pos_top,
              dp_rows, dp_pad: int, sc_const: dict):
    """Gapped DP scores for the top candidates of (pre-compacted) rows:
    pos_top (R', T), dp_rows (R',) bool mask. Returns (R', T) scores.
    The fill is ops/dp_cuda.dp_score (the CUDA kernel on a CUDA tensor);
    sc_const holds its six scoring integers (Scoring.dp_consts). On a
    graph index the windows' SNV-overlay nibbles go to the kernel too."""
    R, L = seqs2.shape
    T = pos_top.shape[1]
    W = L + 2 * dp_pad
    wstart = pos_top - dp_pad
    ref = _rank.text_window(idx, wstart.reshape(-1), W)          # (R*T, W)
    ov = (_rank.nib4_window(idx, wstart.reshape(-1), W).contiguous()
          if "snv_packed" in idx else None)
    rd = seqs2.repeat_interleave(T, dim=0).contiguous()
    q = quals2.repeat_interleave(T, dim=0)
    rl = lens2.repeat_interleave(T).contiguous()
    pen, scp_cum = _sw.dp_inputs(sctab, q, rl)
    score = dp_score(rd, pen.contiguous(), rl, ref.contiguous(),
                     scp_cum.contiguous(), ov=ov, **sc_const).reshape(R, T)
    # sentinel (invalid) candidates must stay invalid: their all-N windows
    # would otherwise "score" better than real but poor placements
    ok = dp_rows[:, None] & (pos_top < BIG - (1 << 20)) & (pos_top >= 0)
    return torch.where(ok, score, NEG_INF)


def _stage_primary_fin(idx: dict, sctab: dict, seqs2, quals2, lens2,
                       ppos, pfw, B: int, max_mm: int = 8):
    """Finalization of the primary ungapped candidate of every read."""
    read_of = torch.arange(B, dtype=I32, device=seqs2.device)
    return _stage_fin_rows(idx, sctab, seqs2, quals2, lens2, ppos, pfw,
                           read_of, B, max_mm)


def _stage_fin_rows(idx: dict, sctab: dict, seqs2, quals2, lens2,
                    ppos, pfw, read_of, B: int, max_mm: int = 8):
    """Finalization of one ungapped candidate per output row: optimal
    clips (max-subarray), score, mismatch counts (nmm penalized ones; nmm_all
    every difference, free SNP edits of a graph index included), and the
    first max_mm (col, refchar) mismatch pairs for MD construction. ppos/pfw/
    read_of are (N,), read_of the read index in [0, B) each row
    finalizes. Returns (N, 5 + 2*max_mm) int32:
    [c5, c3, score, nmm, nmm_all, cols.., chars..]."""
    L = seqs2.shape[1]
    dev = seqs2.device
    rowidx = (read_of + torch.where(pfw, 0, B)).long()
    rd = seqs2[rowidx]
    q = quals2[rowidx].clamp(0, 63)
    ln = lens2[read_of.long()]
    win = _rank.text_window(idx, ppos, L)
    ar = torch.arange(L, dtype=I32, device=dev)[None, :]
    in_read = ar < ln[:, None]
    rd = torch.where(in_read, rd, 4)
    isn = ((rd >= 4) | (win >= 4)) & in_read
    mm = (rd != win) & ~isn & in_read
    mm_sc = mm                                  # penalized mismatches
    if "snv_packed" in idx:
        ov = _rank.nib4_window(idx, ppos, L)
        mm_sc = mm & ~((ov == rd + 1) | (ov == 15))
    s = torch.where(mm_sc, -mm_pen_of(sctab, q), 0)
    s = torch.where(isn, -sctab["n_pen"], s)
    s = s + torch.where(~mm_sc & ~isn & in_read, sctab["match_bonus"], 0)
    scp = torch.where(in_read, sc_pen_of(sctab, q), 0)
    N = rd.shape[0]
    P = torch.cat([torch.zeros((N, 1), dtype=I32, device=dev),
                   torch.cumsum(s + scp, dim=1, dtype=I32)], 1)
    ends = P[:, 1:] - torch.cummin(P, dim=1).values[:, :-1]
    ends_m = torch.where(in_read, ends, NEG_INF)
    # last maximum of ends (fewest clipped bases), first minimum of P
    k = (L - 1) - torch.argmax(ends_m.flip(1), dim=1).to(I32)
    arp = torch.arange(L + 1, dtype=I32, device=dev)[None, :]
    Pm = torch.where(arp <= k[:, None], P, 1 << 30)
    c5 = torch.argmin(Pm, dim=1).to(I32)
    best = torch.gather(ends_m, 1, k[:, None].long())[:, 0]
    score = best - scp.sum(dim=1, dtype=I32)
    c3 = ln - (k + 1)
    amask = (ar >= c5[:, None]) & (ar <= k[:, None])
    mm_all = (mm | isn) & amask
    nmm_all = mm_all.sum(dim=1, dtype=I32)
    nmm = (nmm_all if mm_sc is mm
           else ((mm_sc | isn) & amask).sum(dim=1, dtype=I32))
    # first max_mm mismatch columns (ascending) + their ref chars
    colkey = torch.where(mm_all, ar, 1 << 20)
    mcols = torch.sort(colkey, dim=1).values[:, :max_mm]
    onehot = ar[:, None, :] == mcols[:, :, None]           # (N, max_mm, L)
    mchars = torch.where(onehot, win[:, None, :], 0).sum(dim=2, dtype=I32)
    return torch.cat([c5[:, None], c3[:, None], score[:, None], nmm[:, None],
                      nmm_all[:, None], mcols, mchars], 1)


def _stage_align_fused(idx: dict, sctab: dict, seqs, quals, lens,
                       minsc_i: float, minsc_s: float, gap1: int,
                       B: int, max_seeds: int, n_seeds: int,
                       locs_per_seg: int, top_cands: int, min_seg_len: int,
                       ftab_k: int, K2: int, max_mm: int, fb_bucket: int,
                       dp_bucket: int, dp_pad: int, no_dp: bool,
                       nofw: bool = False, norc: bool = False,
                       seeder: str = "seeds", fb_seeder: str = "segments",
                       KF: int = 1, sc_const: dict | None = None,
                       VC: int = 0):
    """The SE device path on unpacked reads (any qualities): the core,
    then the finalization of every read's top-KF candidates. Returns
    (merged (B, K2, 3), fin (B, KF2, 5 + 2*max_mm), exhausted (B,))."""
    merged, st = _se_core(idx, sctab, seqs, quals, lens, minsc_i, minsc_s,
                          gap1, B, max_seeds, n_seeds, locs_per_seg,
                          top_cands, min_seg_len, ftab_k, K2, fb_bucket,
                          dp_bucket, dp_pad, no_dp, nofw, norc, seeder,
                          fb_seeder, sc_const, verify_cands=VC)
    KF2 = max(1, min(KF, K2))
    fpos = merged[:, :KF2, 1].reshape(-1)
    ffw = ((merged[:, :KF2, 2] & 1) == 1).reshape(-1)
    read_of = torch.arange(B, dtype=I32,
                           device=merged.device).repeat_interleave(KF2)
    fin = _stage_fin_rows(idx, sctab, st["seqs2"], st["quals2"],
                          st["lens2"], fpos, ffw, read_of, B, max_mm)
    exh = st["exhausted"][:B] & st["exhausted"][B:]
    return merged, fin.reshape(B, KF2, -1), exh


def _unpack_reads(seq_words, n_words, quals, qual_const: int, lens, L: int):
    """Unpack the transfer-packed read batch (io/reads.ReadBatch.packed):
    2-bit codes + N bitmask (+ optional per-base quals; constant-qual
    batches send none). seq_words and n_words are int64 tensors holding
    the uint32 words, so the shifts are logical."""
    B = seq_words.shape[0]
    dev = seq_words.device
    sh = 2 * torch.arange(16, dtype=torch.int64, device=dev)
    chars = ((seq_words[:, :, None] >> sh) & 3).to(I32)
    seqs = chars.reshape(B, -1)[:, :L]
    shn = torch.arange(32, dtype=torch.int64, device=dev)
    nb = (n_words[:, :, None] >> shn) & 1
    isn = nb.reshape(B, -1)[:, :L] == 1
    seqs = torch.where(isn, 4, seqs)
    if quals is None:
        q = torch.full((B, L), qual_const, dtype=I32, device=dev)
    else:
        q = quals.to(I32)
    return seqs, q


# fastpack layout: int16 lanes per read —
#   [0] nvalid  [1] best  [2] secbest (-32768 = none)
#   [3] flags: (fw_k << 2k | gapped_k << 2k+1) for reports k, exh << 14
#   per report k at base 4 + 11*k:
#     [+0] pos lo16  [+1] pos hi16  [+2] c5  [+3] c3  [+4] nmm
#     [+5] nmm_all  [+6] score  [+7..10] 4 x (mmcol << 3 | refchar)
FASTPACK_MM = 4
FASTPACK_REP = 7 + FASTPACK_MM


def fastpack_width(kf: int) -> int:
    return 4 + FASTPACK_REP * kf


def _stage_fastpack(idx, sctab, merged, st, minsc, B: int, K2: int,
                    KF: int, khits: int | None = None,
                    omit_sec: bool = False, MB: int = 0):
    """Compress what the host fast path needs into fastpack_width(KF)
    int16 lanes per read: distinct-placement dedup and top-KF report
    selection, finalized rows. With MB > 0 and KF > 1 the base pack
    carries report slot 0 only; report 1 ships for the first
    min(max(4*MB, B//4), B) reads with >= 2 distinct placements (tier 0)
    and reports 2..KF-1 for the first min(max(MB, B//8), B) reads with
    >= 3 (tier 1), as extras smrows{t}/smrep{t}.
    Returns (fastpack (B, W) int16, need (B,) bool — rows the host fast
    path will reject, extras dict)."""
    dev = merged.device
    sc = merged[:, :, 0]
    pos = merged[:, :, 1]
    fl = merged[:, :, 2]
    fw = (fl & 1) == 1
    valid = sc >= minsc[:, None]
    dup = [torch.zeros(B, dtype=torch.bool, device=dev)]
    for t in range(1, K2):
        eq = (pos[:, :t] == pos[:, t:t + 1]) & (fw[:, :t] == fw[:, t:t + 1])
        dup.append(eq.any(dim=1))
    pvalid = valid & ~torch.stack(dup, 1)
    nvalid = pvalid.sum(dim=1, dtype=I32)
    vrank = torch.where(pvalid, torch.cumsum(pvalid, dim=1, dtype=I32) - 1,
                        K2 + 1)

    def rank_col(k):
        # column of the k-th distinct valid placement (0 when absent)
        return torch.argmax((vrank == k).to(I32), dim=1)

    def take(a, col):
        return torch.gather(a, 1, col[:, None])[:, 0]

    best = sc[:, 0]
    secb = torch.where(nvalid >= 2, take(sc, rank_col(1)), -32768)
    ridx = torch.arange(B, dtype=I32, device=dev)
    exh = st["exhausted"][:B] & st["exhausted"][B:]
    flags = exh.to(I32) << 14
    KFB = 1 if (MB > 0 and KF > 1) else KF
    sels, fws, poss, gaps = [], [], [], []
    for k in range(KF):
        selk = (torch.zeros(B, dtype=torch.int64, device=dev) if k == 0
                else rank_col(k))
        fk = take(fw, selk)
        gk = (take(fl, selk) & 2) > 0
        flags = flags | (fk.to(I32) << (2 * k)) | (gk.to(I32) << (2 * k + 1))
        sels.append(selk)
        fws.append(fk)
        poss.append(take(pos, selk))
        gaps.append(gk)

    fin = _stage_fin_rows(
        idx, sctab, st["seqs2"], st["quals2"], st["lens2"],
        torch.cat(poss[:KFB]), torch.cat(fws[:KFB]), ridx.repeat(KFB), B,
        FASTPACK_MM)
    D = fin.shape[1]
    fin = fin.reshape(KFB, B, D)

    def rep_lanes(f, posk, sck):
        # [pos lo, pos hi, c5, c3, nmm, nmm_all, score, mm x4]
        mm = f[:, 5:5 + FASTPACK_MM]
        mch = f[:, 5 + FASTPACK_MM:]
        mmp = mm.clamp(0, 4095) << 3 | mch.clamp(0, 7)
        return [posk & 0xFFFF, (posk >> 16) & 0xFFFF, f[:, 0], f[:, 1],
                f[:, 3], f[:, 4], sck.clamp(-32768, 32767)] + \
            [mmp[:, j] for j in range(FASTPACK_MM)]

    def contain_ok(f, posk, lens_k, gk):
        c5k, c3k = f[:, 0], f[:, 1]
        astart = posk + c5k
        span = lens_k - c5k - c3k
        fj = idx["frag_joined"]
        fr = _rank.searchsorted_right(fj, astart) - 1
        fc = fr.clamp(0, fj.shape[0] - 1).long()
        return ((fr >= 0) & (span > 0)
                & (astart + span <= idx["frag_end"][fc])
                & ~gk & (f[:, 4] <= FASTPACK_MM))

    cols = [nvalid, best.clamp(-32768, 32767), secb.clamp(-32768, 32767),
            flags]
    # mirror the HOST fast-read criteria so the slow rows' merged grids
    # can ship with the fastpack
    nrep = nvalid.clamp(max=K2 if khits is None else khits)
    fast_dev = (nvalid >= 1) & (nrep <= KF)
    if omit_sec:
        fast_dev &= nrep <= 1
    lens_b = st["lens2"][:B].to(I32)
    for k in range(KFB):
        f = fin[k]
        cols += rep_lanes(f, poss[k], take(sc, sels[k]))
        fast_dev &= (nrep <= k) | contain_ok(f, poss[k], lens_b, gaps[k])
    out = torch.stack(cols, dim=1).to(torch.int16)

    bex = {}
    # tiered multi-report buckets: tier t carries reports k0..k1-1 for
    # the first MBt reads with >= k0+1 distinct placements
    tiers = []
    if KFB < KF:
        tiers.append((KFB, KFB + 1, min(max(4 * MB, B // 4), B)))
        if KF > KFB + 1:
            tiers.append((KFB + 1, KF, min(max(MB, B // 8), B)))
    for t, (k0, k1, MBs) in enumerate(tiers):
        NB2 = k1 - k0
        multi = nvalid >= (k0 + 1)
        mv, mrs = _topk01(multi, MBs)
        mrows = mrs.clamp(0, B - 1).long()
        bfin = _stage_fin_rows(
            idx, sctab, st["seqs2"], st["quals2"], st["lens2"],
            torch.cat([poss[k][mrows] for k in range(k0, k1)]),
            torch.cat([fws[k][mrows] for k in range(k0, k1)]),
            mrows.to(I32).repeat(NB2), B, FASTPACK_MM).reshape(NB2, MBs, D)
        mcols = []
        lens_mb = lens_b[mrows]
        # tier slots are the multi rows in ascending index order, so a
        # rank gather maps them back to full-B lanes
        rank = torch.cumsum(multi.to(I32), dim=0) - 1
        in_t = multi & (rank < MBs)
        for k in range(k0, k1):
            f = bfin[k - k0]
            posk = poss[k][mrows]
            mcols += rep_lanes(f, posk, take(sc, sels[k])[mrows])
            okb = contain_ok(f, posk, lens_mb, gaps[k][mrows]) & (mv > 0)
            ok_full = in_t & okb[rank.clamp(0, MBs - 1).long()]
            fast_dev &= (nrep <= k) | ok_full
        bex[f"smrows{t}"] = torch.where(mv > 0, mrs, -1)
        bex[f"smrep{t}"] = torch.stack(mcols, dim=1).to(torch.int16)
    need = (nvalid >= 1) & ~fast_dev
    return out, need, bex


def _stage_align_packed(idx: dict, sctab: dict, seq_words, n_words, quals,
                        qual_const: int, lens, minsc_i: float,
                        minsc_s: float, gap1: int, B: int, L: int,
                        max_seeds: int, n_seeds: int, locs_per_seg: int,
                        top_cands: int, min_seg_len: int, ftab_k: int,
                        K2: int, KF: int, fb_bucket: int, dp_bucket: int,
                        dp_pad: int, no_dp: bool, nofw: bool, norc: bool,
                        seeder: str, fb_seeder: str,
                        sc_const: dict, khits: int | None = None,
                        SB: int = 0, omit_sec: bool = False, MB: int = 0,
                        VC: int = 0, spliced: bool = False,
                        spl_margin: int = 0, spl_kss=None,
                        spl_nceil=None, spl_introns=None, SPL=None):
    """SE path with transfer-packed I/O: unpack 2-bit reads, run the
    core, and compress results to the int16 fastpack. Returns
    (fastpack (B, W) int16, merged (B, K2, 3) int32); with SB > 0 or
    tier buckets also an extras dict: srows (SB,) int32 and smerged
    (SB, K2, 2) — the packed merged grids of the reads the host fast path
    will reject — plus the tier buckets.

    spliced: RNA mode. SPL = (TB, PJ, AB, NC, NL, dta, tiles): the
    splice pass 1 runs in this step (ops/splice.spliced_stage: seeded lane
    enumeration, junction scoring and gates, anchor scan) and ships its
    compacted lanes in the extras (splanes32/16, spl_cov, spl_nsel,
    splanes32b/16b, spl_nsel2); spl_kss holds the site table's four
    device arrays, spl_nceil the N ceiling (I, S), spl_introns (min, max).
    In RNA mode with SB >= B every row's grid ships."""
    seqs, quals = _unpack_reads(seq_words, n_words, quals, qual_const,
                                lens, L)
    merged, st = _se_core(idx, sctab, seqs, quals, lens, minsc_i, minsc_s,
                          gap1, B, max_seeds, n_seeds, locs_per_seg,
                          top_cands, min_seg_len, ftab_k, K2, fb_bucket,
                          dp_bucket, dp_pad, no_dp, nofw, norc, seeder,
                          fb_seeder, sc_const, verify_cands=VC)
    minsc = _min_scores(minsc_i, minsc_s, lens)
    fastpack, need, bex = _stage_fastpack(idx, sctab, merged, st, minsc,
                                          B, K2, KF, khits, omit_sec, MB)
    if spliced:
        # RNA mode: splice pass 1 runs inside this step, shipping
        # compacted accepted/partial lanes with the fastpack
        ar = torch.arange(L, dtype=I32, device=seqs.device)[None, :]
        nNs = ((seqs >= 4) & (ar < lens.to(I32)[:, None])).sum(dim=1,
                                                               dtype=I32)
        TBs, PJs, ABs, NCs, NLs, dta_s, tiles_s = SPL
        (sp32, sp16, need, spl_cov, spl_nsel,
         sp32b, sp16b, spl_nsel2) = _splice.spliced_stage(
            idx, sctab, merged, st, need, nNs, B,
            spl_kss[0], spl_kss[1], spl_kss[2], spl_kss[3],
            minsc_i, minsc_s, spl_nceil[0], spl_nceil[1], spl_margin,
            spl_introns[0], spl_introns[1], TBs, PJs, ABs, NCs, NLs,
            dta_s, tiles=tiles_s)
        bex = dict(bex, splanes32=sp32, splanes16=sp16, spl_cov=spl_cov,
                   spl_nsel=spl_nsel, splanes32b=sp32b, splanes16b=sp16b,
                   spl_nsel2=spl_nsel2)
    if SB == 0 and not bex:
        return fastpack, merged
    extras = dict(bex)
    if SB >= B and spliced:
        # RNA: ship every row's grid with the fastpack — junction rescue,
        # site-publication demotion and the ladder reach into grids of
        # rows the slow-row prediction cannot foresee
        sr = torch.arange(B, dtype=I32, device=merged.device)
        extras["srows"] = sr
    elif SB:
        sv, sr = _topk01(need, min(SB, B))
        extras["srows"] = torch.where(sv > 0, sr, -1)
    if SB:
        # packed grid rows: [pos, score<<8 | flags] — the host unpacks
        # (emit._unpack_smerged); scores below -2^22 all mean "dead
        # candidate" so the clamp loses nothing
        sm = merged[sr.clamp(0, B - 1).long()]
        scpk = sm[:, :, 0].clamp(min=-(1 << 22))
        extras["smerged"] = torch.stack(
            [sm[:, :, 1], (scpk << 8) | (sm[:, :, 2] & 0xFF)], dim=2)
    return fastpack, merged, extras


def _stage_oriented(seq_words, n_words, quals, qual_const: int, lens,
                    B: int, L: int):
    """Device-resident oriented reads (fw rows [0:B), rc rows [B:2B))
    from the transfer-packed batch — the splice scorers gather lane reads
    from these instead of shipping host-built (C, L) matrices."""
    seqs, q = _unpack_reads(seq_words, n_words, quals, qual_const, lens, L)
    return _with_revcomp(seqs, q, lens)


def _se_core(idx, sctab, seqs, quals, lens, minsc_i, minsc_s, gap1, B,
             max_seeds, n_seeds, locs_per_seg, top_cands, min_seg_len,
             ftab_k, K2, fb_bucket, dp_bucket, dp_pad, no_dp, nofw, norc,
             seeder, fb_seeder, sc_const, verify_cands: int = 0):
    """Candidates + sensitive fallback + DP rescue + fw/rc merge for one
    read batch: the shared device core of the SE and PE steps. The first
    pass seeds n_seeds seeds with `seeder`; reads it cannot place re-seed
    with `fb_seeder` (FB_TABLE_SEEDS dense table seeds, or max_seeds
    maximal segments). Returns (merged (B, K2, 3) packed [score, pos,
    flags], st)."""
    st = _stage_candidates(idx, sctab, seqs, quals, lens, n_seeds,
                           locs_per_seg, top_cands, min_seg_len, seeder,
                           ftab_k, verify_cands=verify_cands)
    if nofw:
        st["score"][:B] = NEG_INF
    if norc:
        st["score"][B:] = NEG_INF
    pos, score = st["pos"], st["score"]
    min_scs = _min_scores(minsc_i, minsc_s, lens)
    row_best = score.amax(dim=1)
    read_best = torch.maximum(row_best[:B], row_best[B:])

    if fb_bucket > 0:
        # compaction by a stable 0/1 top-k: a selected row's bucket SLOT
        # equals its rank among selected rows, so the merge-back is a rank
        # gather; overflow beyond fb_bucket drops the highest-index rows
        fbmask = read_best < min_scs
        rank = torch.cumsum(fbmask.to(I32), dim=0) - 1
        use = fbmask & (rank < fb_bucket)
        sel = _topk01(fbmask, fb_bucket)[1].long()
        fb_seeds = FB_TABLE_SEEDS if fb_seeder == "table_dense" else max_seeds
        st2 = _stage_candidates(idx, sctab, seqs[sel], quals[sel], lens[sel],
                                fb_seeds, locs_per_seg, top_cands,
                                min_seg_len, fb_seeder, ftab_k)
        slot = rank.clamp(0, fb_bucket - 1).long()
        for k in ("pos", "score", "nmm"):
            fw_new = torch.where(use[:, None], st2[k][slot], st[k][:B])
            rc_new = torch.where(use[:, None], st2[k][slot + fb_bucket],
                                 st[k][B:])
            st[k] = torch.cat([fw_new, rc_new])
        exh_fw = torch.where(use, st2["exhausted"][slot], st["exhausted"][:B])
        exh_rc = torch.where(use, st2["exhausted"][slot + fb_bucket],
                             st["exhausted"][B:])
        st["exhausted"] = torch.cat([exh_fw, exh_rc])
        pos, score = st["pos"], st["score"]
        row_best = score.amax(dim=1)
        read_best = torch.maximum(row_best[:B], row_best[B:])

    dp_sc = None
    if not no_dp:
        # gapped rescue for reads whose best ungapped score one gap could
        # beat, compacted into a fixed dp_bucket of reads
        dpmask = read_best < -gap1
        rankd = torch.cumsum(dpmask.to(I32), dim=0) - 1
        used = dpmask & (rankd < dp_bucket)
        sel = _topk01(dpmask, dp_bucket)[1].long()
        rows = torch.cat([sel, sel + B])
        m2 = torch.cat([used[sel], used[sel]])
        Tdp = min(2, pos.shape[1])
        dpv = _stage_dp(idx, sctab, st["seqs2"][rows], st["quals2"][rows],
                        st["lens2"][rows], pos[rows, :Tdp], m2, dp_pad,
                        sc_const)
        slotd = rankd.clamp(0, dp_bucket - 1).long()
        fw_dp = torch.where(used[:, None], dpv[slotd], NEG_INF)
        rc_dp = torch.where(used[:, None], dpv[slotd + dp_bucket], NEG_INF)
        T = score.shape[1]
        dp_sc = torch.cat(
            [torch.cat([fw_dp, rc_dp]),
             torch.full((2 * B, T - Tdp), NEG_INF, dtype=I32,
                        device=score.device)], 1)

    merged = _stage_merge(pos, score, dp_sc, B, K2)
    return merged, st


def _stage_merge(pos, score, dp_score, B: int, K2: int):
    """Merge fw/rc candidate grids and keep the per-read top-K2:
    (B, K2, 3) [score, pos, flags (1 = fw, 2 = gapped)]."""
    T = pos.shape[1]
    sc = score if dp_score is None else torch.maximum(score, dp_score)
    gap = (torch.zeros_like(sc, dtype=torch.bool) if dp_score is None
           else dp_score > score)

    def cat(a):
        return torch.cat([a[:B], a[B:]], 1)
    sc2, pos2, gap2 = cat(sc), cat(pos), cat(gap)
    fw2 = torch.cat([torch.ones((B, T), dtype=I32, device=sc.device),
                     torch.zeros((B, T), dtype=I32, device=sc.device)], 1)
    fl2 = fw2 | (gap2.to(I32) << 1)
    return torch.stack(_sort_desc(sc2, pos2, fl2, k=K2), dim=2)


# ---------------------------------------------------------------------------
# Aligner: device orchestration + host-side finalization
# ---------------------------------------------------------------------------

class RepeatAligner:
    """Repeat-index alignment (reference RFM path, hi_aligner.h:4151+):
    reads that multi-map in the genome are aligned once against the
    assembled repeat sequences (the per-read path, Aligner.align_batch,
    on `device`); RepeatDB.expand recovers every genomic placement
    (ht2_repeat_expand contract)."""

    def __init__(self, rep_fm: FMIndex, repeat_db,
                 scoring: Scoring = DEFAULT_SCORING, device="cuda"):
        self.aligner = Aligner(rep_fm, scoring, device=device)
        self.db = repeat_db

    def align_repeats(self, batch: ReadBatch):
        """Returns per read: None or (repeat_name, offset, fw, score,
        genomic placements list)."""
        results = self.aligner.align_batch(batch)
        out = []
        for res in results:
            if not res.aligned:
                out.append(None)
                continue
            a = res.alns[0]
            name = self.aligner.fm.ref.names[a.tidx]
            placements = self.db.expand(name, a.toff, a.ref_span)
            out.append((name, a.toff, a.fw, a.score, placements))
        return out


class Aligner:
    """Batched aligner over a built FM index, DNA or (opts.spliced)
    spliced RNA with a splice-site table of its own (ssdb). An index with
    a k-mer seed table seeds from the table; one without seeds by FM
    backward search (full or sampled SA). `device` holds the index bundle
    and runs the batched stages ("cuda" unless the caller asks for
    "cpu")."""

    def __init__(self, fm: FMIndex, scoring: Scoring = DEFAULT_SCORING,
                 opts: AlignerOpts | None = None, device="cuda"):
        self.fm = fm
        self.scoring = scoring
        self.opts = opts or AlignerOpts()
        o = self.opts
        self.device = torch.device(device)
        # the bundle carries the FM keys exactly when there is no table
        self.idx = fm.device_bundle(self.device)
        # seeder choice: the direct-address k-mer table when the index
        # carries one (two gather rounds, no LF chain), FM stride seeds
        # otherwise; the sensitive fallback re-seeds failing reads densely
        if fm.st_k and "st_starts" in self.idx:
            self.seeder, self.fb_seeder = "table", "table_dense"
        else:
            self.seeder = "seeds" if o.seed_mode else "segments"
            self.fb_seeder = "segments"
        self.min_seg_len = min_anchor(fm.n)
        self.sctab = scoring.device_tables(self.device)
        self.sc_const = scoring.dp_consts()
        self.metrics = Metrics()
        self.ssdb = SpliceSiteDB()
        # graph-index extras (SNP-aware scoring on the host finish)
        self.overlay = getattr(fm, "snv_overlay", None)
        if self.overlay is not None and self.overlay.size == 0:
            self.overlay = None
        self.snps = getattr(fm, "snps", None)
        self._del_snps: set[tuple[int, int]] = set()
        self._ins_snps: dict[int, np.ndarray] = {}
        if self.snps is not None:
            for si in range(len(self.snps)):
                t = int(self.snps.types[si])
                if t == SNP_DEL:
                    self._del_snps.add((int(self.snps.jpos[si]),
                                        int(self.snps.lens[si])))
                elif t == SNP_INS:
                    self._ins_snps[int(self.snps.jpos[si])] = \
                        self.snps.ins_seqs[si]

    @classmethod
    def host_only(cls, ref, scoring: Scoring = DEFAULT_SCORING,
                  opts: AlignerOpts | None = None,
                  device="cuda") -> "Aligner":
        """Finalization-only Aligner over a (sharded-global) reference:
        no index bundle (`idx` is empty), just the host-side candidate
        ranking, CIGAR/MD and formatting machinery. The sharded path
        (align/sharded.py) runs its device steps on per-shard Aligners and
        finishes here; the ladder's mate rescue scores its windows with
        the DP kernel on `device` (paired._rescue_mates)."""
        from types import SimpleNamespace
        self = cls.__new__(cls)
        self.fm = SimpleNamespace(ref=ref, st_k=0, ftab_k=1,
                                  n=int(ref.joined.size))
        self.scoring = scoring
        self.opts = opts or AlignerOpts()
        self.device = torch.device(device)
        self.idx = {}
        self.seeder = self.fb_seeder = "host"
        self.min_seg_len = 8
        self.sctab = scoring.device_tables(self.device)
        self.sc_const = scoring.dp_consts()
        self.metrics = Metrics()
        self.ssdb = SpliceSiteDB()
        self.overlay = None
        self.snps = None
        self._del_snps = set()
        self._ins_snps = {}
        return self

    # ---- device orchestration ----

    def device_align_fast(self, batch: ReadBatch):
        """Upload the transfer-packed batch, run _stage_align_packed, and
        start the result copies to the host. Returns (fastpack, merged,
        extras, ready): fastpack and extras are host tensors that are
        complete once `ready` (a CUDA event, None on the CPU) has been
        waited on; merged (B, K2, 3) stays on the device for slow-row
        gathers (gather_merged_async)."""
        t0 = time.perf_counter()
        o = self.opts
        B = len(batch)
        L = batch.seqs.shape[1]
        m = self.metrics
        m.reads += B
        m.bases += int(batch.lens.sum())
        m.batches += 1
        m.seeds += 2 * B * o.n_seeds
        m.table_probes += 2 * B * o.n_seeds
        m.candidates += 2 * B * o.verify_cands
        seq_w, n_w, quals, qconst, lens = batch.packed()
        up = self._up
        sc = self.scoring
        K2 = min(2 * o.top_cands, max(8, o.khits + 3))
        spl_kw = {}
        if o.spliced:
            # the step's splice pass-1 buckets: TB triggered rows (junction
            # reads are routinely about half an RNA batch), AB anchor-scan
            # rows, NL result lanes; the anchor scan's tile count comes
            # from max_intron on the host, so no device value decides it
            TB = min(B, max(256, 5 * B // 8))
            spl_kw = dict(
                spl_kss=self.ssdb.device_arrays4(self.device),
                spl_nceil=(float(sc.n_ceil.I), float(sc.n_ceil.S)),
                spl_introns=(o.min_intron, o.max_intron),
                SPL=(TB, o.pairs_per_read, min(TB, max(128, TB // 4)), 4,
                     2 * TB, o.dta,
                     max(1, min(8, -(-o.max_intron // 65536)))))
        fp, merged, extras = _stage_align_packed(
            self.idx, self.sctab,
            up(seq_w.astype(np.int64), torch.int64),
            up(n_w.astype(np.int64), torch.int64),
            None if quals is None else up(quals, I32), qconst,
            up(lens, I32), float(sc.score_min.I), float(sc.score_min.S),
            min(sc.read_gap_open(), sc.ref_gap_open()),
            B, L, o.max_seeds, o.n_seeds, o.locs_per_seg, o.top_cands,
            self.min_seg_len, self.fm.ftab_k, K2,
            max(1, min(o.khits, 5)), min(B, max(32, B // 8)),
            min(B, max(64, B // 8)), o.dp_pad, o.no_dp, o.nofw, o.norc,
            self.seeder, self.fb_seeder,
            self.sc_const, khits=o.khits,
            SB=B if o.spliced else min(B, max(64, B // 16)),
            omit_sec=o.omit_sec_seq, MB=min(B, max(32, B // 16)),
            VC=o.verify_cands, spliced=o.spliced,
            spl_margin=self._spl_margin(batch), **spl_kw)
        host, ready = _to_host_async({"fp": fp, **extras})
        if spl_kw:
            # lanes were enumerated against this site table; the finish
            # re-runs rows that sites published later could affect
            host["spl_ssv"] = self.ssdb.version()
        m.t_pack += time.perf_counter() - t0
        return host.pop("fp"), merged, host, ready

    def _dev_oriented(self, batch: ReadBatch):
        """(seqs2, quals2, lens2) device tensors for `batch` (both
        orientations, _with_revcomp layout), computed once per device and
        cached on the batch."""
        cache = getattr(batch, "_dev_oriented", None)
        if cache is None:
            cache = batch._dev_oriented = {}
        if self.device in cache:
            return cache[self.device]
        seq_w, n_w, quals, qconst, lens = batch.packed()
        up = self._up
        out = _stage_oriented(
            up(seq_w.astype(np.int64), torch.int64),
            up(n_w.astype(np.int64), torch.int64),
            None if quals is None else up(quals, I32), qconst,
            up(lens, I32), len(batch), batch.seqs.shape[1])
        cache[self.device] = out
        return out

    def _spl_margin(self, batch: ReadBatch) -> int:
        """Splice-rescue trigger margin: a read crossing a junction with
        the canonical minimum far anchor (7 bp, tp.h) scores at most
        perfect - 7 * min-clip-penalty contiguously, so reads above that
        need no junction search. Uses the batch's lowest base quality for
        the clip-penalty floor, and the mismatch penalty where it is
        lower."""
        qmin = int(batch.quals.min()) if batch.quals.size else 0
        pen = int(self.scoring.sc_pens()[max(0, min(qmin, 63))])
        mmp = int(self.scoring.mm_pens()[max(0, min(qmin, 63))])
        return _splice.MIN_ANCHOR_CANON * min(pen, mmp)

    def gather_merged_rows(self, merged_dev, rows: np.ndarray):
        """The merged candidate rows of slow reads (numpy), waited for."""
        return self.gather_merged_async(merged_dev, rows)()

    def gather_merged_async(self, merged_dev, rows: np.ndarray):
        """Start the gather + host copy of the merged rows of slow reads;
        returns a closure that waits for and returns them (numpy)."""
        if rows.size == 0:
            empty = np.zeros((0,) + tuple(merged_dev.shape[1:]), np.int32)
            return lambda: empty
        ix = torch.from_numpy(rows.astype(np.int64)).to(merged_dev.device)
        got, ready = _to_host_async({"g": merged_dev[ix]})

        def wait():
            if ready is not None:
                ready.synchronize()
            return got["g"].numpy()
        return wait

    def _up(self, a, dtype=I32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def _device_align(self, batch: ReadBatch):
        """The per-read reference path's device half, driven from the
        host with its syncs: candidates, (in seed mode) the segment
        fallback, and the gapped rescue of the reads one gap could
        improve, compacted into a fixed bucket of max(64, B/4) reads.
        Returns (st, dp_sc): the candidate dict of _stage_candidates and
        the (2B, T) DP scores, or None where no read needed the DP."""
        o = self.opts
        B = len(batch)
        seqs = self._up(batch.seqs)
        quals = self._up(batch.quals)
        lens = self._up(batch.lens)
        seeder = self.seeder
        nseeds = o.n_seeds if seeder in ("seeds", "table") else o.max_seeds
        self.metrics.reads += B
        self.metrics.batches += 1
        self.metrics.seeds += 2 * B * nseeds
        self.metrics.candidates += 2 * B * min(3 * o.top_cands,
                                               nseeds * o.locs_per_seg)
        st = _stage_candidates(self.idx, self.sctab, seqs, quals, lens,
                               nseeds, o.locs_per_seg, o.top_cands,
                               self.min_seg_len, seeder, self.fm.ftab_k)
        if o.seed_mode:
            st = self._segment_fallback(batch, st, seqs, quals, lens)
        dp_sc = None
        if not o.no_dp:
            # a 1 bp gap costs at least gap1, so a read scoring >= -gap1
            # ungapped is already optimal without the DP
            row_best = st["score"].amax(dim=1).cpu().numpy()
            read_best = np.maximum(row_best[:B], row_best[B:])
            gap1 = min(self.scoring.read_gap_open(),
                       self.scoring.ref_gap_open())
            need_read = read_best < -gap1
            if need_read.any():
                rows = np.concatenate([np.flatnonzero(need_read),
                                       np.flatnonzero(need_read) + B])
                budget = max(64, B // 4)
                rows = rows[:2 * budget]
                # padded to the fixed bucket size, as the reference pads
                rows_p = np.pad(rows, (0, 2 * budget - rows.size))
                ridx = self._up(rows_p, torch.int64)
                # DP only the best few candidates of each triggered row
                Tdp = min(2, st["pos"].shape[1])
                self.metrics.dp_lanes += int(rows.size) * Tdp
                dp_rows = _stage_dp(
                    self.idx, self.sctab,
                    st["seqs2"][ridx], st["quals2"][ridx], st["lens2"][ridx],
                    st["pos"][ridx, :Tdp],
                    torch.ones(rows_p.size, dtype=torch.bool,
                               device=self.device), o.dp_pad, self.sc_const)
                dp_sc = torch.full(st["score"].shape, NEG_INF, dtype=I32,
                                   device=self.device)
                dp_sc[self._up(rows, torch.int64), :Tdp] = \
                    dp_rows[:rows.size]
        return st, dp_sc

    def device_align_fused(self, batch: ReadBatch):
        """One device call on the unpacked batch (_stage_align_fused);
        returns host arrays (merged dict, fin (B, KF, D)). Seed mode
        only."""
        o = self.opts
        B = len(batch)
        self.metrics.reads += B
        self.metrics.batches += 1
        self.metrics.seeds += 2 * B * o.max_seeds
        K2 = min(2 * o.top_cands, max(8, o.khits + 3))
        sc = self.scoring
        merged_d, fin_d, exh_d = _stage_align_fused(
            self.idx, self.sctab, self._up(batch.seqs),
            self._up(batch.quals), self._up(batch.lens),
            float(sc.score_min.I), float(sc.score_min.S),
            min(sc.read_gap_open(), sc.ref_gap_open()),
            B, o.max_seeds, o.n_seeds, o.locs_per_seg, o.top_cands,
            self.min_seg_len, self.fm.ftab_k, K2, 8,
            min(B, max(32, B // 8)), min(B, max(64, B // 8)),
            o.dp_pad, o.no_dp, o.nofw, o.norc,
            self.seeder, self.fb_seeder, max(1, min(o.khits, K2)),
            self.sc_const, o.verify_cands)
        merged = _merged_dict(merged_d.cpu().numpy())
        merged["exhausted"] = exh_d.cpu().numpy()
        return merged, fin_d.cpu().numpy()

    def _segment_fallback(self, batch, st, seqs, quals, lens):
        """Reads the seed pass could not place above the minimum score
        re-run through the sensitive search (a compacted sub-batch of
        max(32, B/8) reads) and their candidate rows are replaced on the
        device."""
        o = self.opts
        B = len(batch)
        row_best = st["score"].amax(dim=1).cpu().numpy()
        read_best = np.maximum(row_best[:B], row_best[B:])
        min_scs = np.ceil(self.scoring.score_min.I
                          + self.scoring.score_min.S
                          * batch.lens).astype(np.int64)
        need = np.flatnonzero(read_best < min_scs)
        if need.size == 0:
            return st
        bucket = max(32, B // 8)
        need = need[:bucket]
        self.metrics.fallback_reads += int(need.size)
        need_p = np.pad(need, (0, bucket - need.size))   # fixed shape
        ridx = self._up(need_p, torch.int64)
        fb_seeds = (FB_TABLE_SEEDS if self.fb_seeder == "table_dense"
                    else o.max_seeds)
        st2 = _stage_candidates(
            self.idx, self.sctab, seqs[ridx], quals[ridx], lens[ridx],
            fb_seeds, o.locs_per_seg, o.top_cands,
            self.min_seg_len, self.fb_seeder, self.fm.ftab_k)
        # the padding repeats read 0: every duplicate row carries the same
        # values (the same read through the same search), so the order in
        # which the scatter writes them does not matter
        rows = torch.cat([ridx, ridx + B])
        out = dict(st)
        for k in ("pos", "score", "nmm"):
            out[k] = st[k].clone()
            out[k][rows] = st2[k]
        return out

    def _merged_host(self, st, dp_dev, B: int):
        """Device-side merge + one small copy -> host candidate dict."""
        K2 = min(2 * st["pos"].shape[1], max(8, self.opts.khits + 3))
        return _merged_dict(_stage_merge(st["pos"], st["score"], dp_dev,
                                         B, K2).cpu().numpy())

    # ---- host finalization ----

    def align_batch(self, batch: ReadBatch) -> list[ReadResult]:
        """The per-read path end to end: one ReadResult per read."""
        B = len(batch)
        st, dp_sc = self._device_align(batch)
        merged = self._merged_host(st, dp_sc, B)
        if self.opts.spliced:
            n_ss = len(self.ssdb)
            self._splice_rescue(batch, merged)
            # second pass: junctions discovered above (or in earlier
            # batches) unlock short-anchor reads via known-site pairs —
            # the batched counterpart of the reference's cross-thread
            # novel-splice-site sharing (hisat2.cpp:3285-3308)
            if len(self.ssdb) != n_ss:
                self._splice_rescue(batch, merged)
        return self._finalize_results(batch, merged)

    # ---- spliced rescue (RNA mode) ----

    def _splice_rescue(self, batch: ReadBatch, merged, rows=None,
                       dev_lanes=None, defer_resid: bool = False,
                       scan_covered: bool = False):
        """Junction search for reads whose contiguous alignment is poor:
        enumerate same-orientation diagonal pairs from the candidate lists,
        score the best junction per pair on device (ops/splice.py), and
        attach winning spliced candidates to `merged['splice']`.

        rows: optional (B,) bool mask restricting which reads may trigger
        (the packed RNA path only fetches slow rows' candidate grids).

        dev_lanes: optional (splanes, cov, nsel, ss_version) from the
        fused dispatch (ops/splice.spliced_stage) — pass-1 lanes already
        enumerated, scored and gated ON DEVICE inside the main submit.
        Rows the device buckets dropped, rows it didn't trigger, and rows
        a site published after submit could affect re-run through the
        legacy rescue_fused path below; in steady state that set is
        empty and pass 1 costs no extra round trip."""
        o = self.opts
        lens = batch.lens.astype(np.int64)
        # trigger: any imperfect contiguous alignment — a clip or mismatch
        # may hide a penalty-free junction (canonical splice costs only the
        # intron-length term, usually 0)
        perfect = (self.scoring.match_bonus * lens).astype(np.int64)
        trig_mask = merged["score"][:, 0] < perfect
        # transcriptome-aware: even a perfect contiguous alignment is
        # re-examined when a KNOWN splice boundary falls inside its span —
        # the reference prefers the known junction (1bp-anchor cases in
        # --ss indexes)
        if len(self.ssdb):
            kl, kr = self.ssdb.lefts_rights()
            kr_sorted, _klr = self.ssdb.rights_sorted()
            p0 = merged["pos"][:, 0].astype(np.int64)
            span_l = p0 + 1
            span_r = p0 + lens - 1
            has_left = (np.searchsorted(kl, span_r)
                        > np.searchsorted(kl, span_l))
            has_right = (np.searchsorted(kr_sorted, span_r)
                         > np.searchsorted(kr_sorted, span_l))
            trig_mask |= has_left | has_right
        if rows is not None:
            trig_mask &= rows
        sc, pos = merged["score"], merged["pos"]
        fw = merged["fw"]

        # ---- device pass-1 lanes (fused dispatch) ----
        resid_mask = trig_mask
        d_res = np.zeros((0, 3), np.int64)
        d_ri = d_pa = d_pb = np.zeros(0, np.int64)
        d_fa = np.zeros(0, bool)
        d2blk = None        # (sp32, sp16, sp32b, sp16b, covered)
        if dev_lanes is not None:
            sp32, sp16, cov, nsel, ssv = dev_lanes[:5]
            if nsel <= sp16.shape[0]:
                covered = (((cov & 1) > 0) & ((cov & 2) == 0)
                           & trig_mask)
                newp = self.ssdb.added_since(ssv)
                if newp.size and covered.any():
                    # sites published between submit and finish: any row
                    # that could GAIN a known-implied lane (new site
                    # inside a candidate span) re-runs legacy
                    covered &= ~self._spl_affected(merged, lens, newp)
                resid_mask = trig_mask & ~covered
                rows16 = sp16[:, 0].astype(np.int64)
                lv = (sp16[:, 4] != 0)
                rclip = np.clip(rows16, 0, covered.size - 1)
                # covered rows keep all their lanes; UNcovered trigger
                # rows keep their anchor-SCAN lanes (bit 6) — the host
                # cleanup re-enumerates seeded lanes but has no scan
                is_scan_l = (sp16[:, 4].astype(np.int64) & 0x40) != 0
                lv &= covered[rclip] | (is_scan_l & trig_mask[rclip])
                d_ri = rows16[lv]
                d_pa = sp32[lv, 0].astype(np.int64)
                d_pb = sp32[lv, 1].astype(np.int64)
                d_fa = sp16[lv, 1] > 0
                d_res = sp16[lv, 2:5].astype(np.int64)
                if len(dev_lanes) >= 8 and dev_lanes[5] is not None:
                    d2blk = (sp32, sp16, dev_lanes[5], dev_lanes[6],
                             covered)
        # defer_resid: process ONLY the fused-dispatch lanes now; rows
        # the device missed (bucket overflow / post-submit sites) are
        # RETURNED so the caller can fold them into one combined cleanup
        # rescue with this batch's newly published sites — one legacy
        # device call per batch instead of two
        ret_resid = None
        if defer_resid:
            ret_resid = resid_mask.copy()
            resid_mask = np.zeros_like(resid_mask)
        trigger = np.flatnonzero(resid_mask)
        if trigger.size == 0 and d_ri.size == 0:
            return ret_resid

        # ---- legacy path for residual rows ----
        res1 = np.zeros((0, 3), np.int64)
        res2 = np.zeros((0, 3), np.int64)
        d2 = np.zeros((0, 4), np.int64)
        keep2 = np.zeros(0, bool)
        s_row = s_pa = s_pb = np.zeros(0, np.int64)
        s_fa = np.zeros(0, bool)
        P1 = 0
        if trigger.size:
            s_row, s_pa, s_pb, s_fa = self._junction_lanes(
                trigger, sc, pos, fw, lens)
            P1 = s_row.size
            # scan rows: triggered reads with a live primary diagonal — the
            # kernel itself decides which still need the anchor scan after
            # seeded-lane acceptance (device compaction to the AB bucket)
            p0 = pos[trigger, 0].astype(np.int64)
            f0 = fw[trigger, 0]
            live0 = sc[trigger, 0] > NEG_INF // 2
            srows = trigger[live0]
        else:
            srows = np.zeros(0, np.int64)
        if (P1 or srows.size) and (not self.idx or scan_covered
                                   or dev_lanes is not None):
            # host-scored legacy: (a) a finalization-only aligner (the
            # sharded finish: no shard's arrays are at hand); (b) the small
            # lane sets of the stream's cleanup: a mid-finish device call
            # queues behind the next batch's submit while the NumPy mirror
            # scores a few thousand lanes in milliseconds. No anchor scan
            # here: the fused dispatch's scan lanes are kept for uncovered
            # trigger rows (bit 6), so only seeded re-enumeration is
            # needed.
            if P1:
                rd_h, q_h = self._host_oriented(batch, s_row, s_fa)
                kl_h, kr_h = self.ssdb.lefts_rights()
                _rh, res1 = _splice_host.junction_score_gate(
                    self.fm.ref.joined, self.scoring, rd_h, q_h,
                    lens[s_row], s_pa, s_pb, kl_h, kr_h,
                    self.overlay, o.max_intron, o.dta)
        elif P1 or srows.size:
            # fixed size-class buckets (small/mid/full), as the JAX
            # package compiles them; PB and SBk are coupled into one
            # class, so three (PB, SBk) shapes in all
            for PB, SBk in ((2048, 512), (8192, 4096), (32768, 8192)):
                if P1 <= PB and srows.size <= SBk:
                    break
            if P1 > PB:          # beyond full: keep the best-ranked lanes
                s_row, s_pa, s_pb, s_fa = (
                    x[:PB] for x in (s_row, s_pa, s_pb, s_fa))
                P1 = PB
            srows_c = srows[:SBk]
            pad = PB - P1
            if P1:
                ridx = np.concatenate(
                    [s_row, np.full(pad, s_row[0])]).astype(np.int32)
                posA = np.concatenate(
                    [s_pa, np.full(pad, s_pa[0])]).astype(np.int32)
                posB = np.concatenate(
                    [s_pb, np.full(pad, s_pb[0])]).astype(np.int32)
                lfw = np.concatenate(
                    [s_fa, np.full(pad, s_fa[0])]).astype(bool)
            else:
                ridx = np.zeros(PB, np.int32)
                posA = np.zeros(PB, np.int32)
                posB = np.zeros(PB, np.int32)
                lfw = np.zeros(PB, bool)
            spad = SBk - srows_c.size
            srow_p = np.pad(srows_c, (0, spad)).astype(np.int32)
            sfw_p = np.pad(f0[live0][:SBk], (0, spad)).astype(bool)
            spos_p = np.pad(p0[live0][:SBk], (0, spad)).astype(np.int32)
            slive_p = np.zeros(SBk, bool)
            slive_p[:srows_c.size] = True
            AB = max(128, SBk // 4)

            seqs2, quals2, lens2 = self._dev_oriented(batch)
            kleft, kright = self.ssdb.device_arrays(self.device)
            up, B8 = self._up, torch.bool
            pack1, pack2, desc2 = _splice.rescue_fused(
                self.idx, self.sctab, seqs2, quals2, lens2,
                up(ridx), up(lfw, B8), up(posA), up(posB), up(srow_p),
                up(sfw_p, B8), up(spos_p), up(slive_p, B8), kleft, kright,
                float(self.scoring.score_min.I),
                float(self.scoring.score_min.S),
                o.max_intron, o.min_intron, self._spl_margin(batch), AB,
                dta=o.dta, tiles=max(1, min(8, -(-o.max_intron // 65536))))
            res1 = pack1.cpu().numpy()[:P1]
            res2 = pack2.cpu().numpy()
            d2 = desc2.cpu().numpy()
            # keep only real scan-hit lanes (flags != 0)
            keep2 = res2[:, 2] != 0
        res = np.concatenate([d_res, res1, res2[keep2]])
        ri = np.concatenate([d_ri, s_row, d2[keep2, 0]]).astype(np.int64)
        pa_v = np.concatenate([d_pa, s_pa, d2[keep2, 1]]).astype(np.int64)
        pb_v = np.concatenate([d_pb, s_pb, d2[keep2, 2]]).astype(np.int64)
        fa_v = np.concatenate([d_fa, s_fa, d2[keep2, 3] > 0]).astype(bool)
        P = ri.size
        # device splanes already cleared scan-lane partial bits, so only
        # the legacy scan tail needs the no-partial rule below
        is_scan = np.zeros(P, bool)
        is_scan[d_ri.size + P1:] = True
        self.metrics.splice_lanes += P
        self.metrics.splice_sites_known = len(self.ssdb.known)
        self.metrics.splice_sites_novel = len(self.ssdb.novel)
        jsc = res[:, 0].astype(np.int64)
        jj = res[:, 1].astype(np.int64)
        fl = res[:, 2].astype(np.int64)
        jstr = fl & 3
        jcan = (fl >> 2) & 3

        spl: dict[int, list] = merged.setdefault("splice", {})
        partial: dict[int, list] = merged.setdefault("splice_partial", {})
        # acceptance gates ran ON DEVICE (ops/splice.junction_gated,
        # reference hi_aligner.h:3753-3786) — only accepted/partial lanes
        # reach the attach below, VECTORIZED: keep-first (row,pa,pb,fw)
        # dedup + lexsort by the candidate order, then per-row slices
        # become pre-sorted lists (the per-lane dict loop was ~40ms/batch
        # at steady state). probscore stays device-side.
        delta_v = pb_v - pa_v
        # anchor-scan lanes may only land fully-accepted junctions: their
        # far diagonal is an 8-mer guess, so a partial (chain-base) entry
        # would seed multi-segment chains from an outer anchor the
        # reference would never admit (spliced_aligner.h:331-560)
        partial_v = (((fl >> 5) & 1) > 0) & ~is_scan
        accept_v = ((fl >> 4) & 1) > 0
        strands = np.where(jstr == 1, "+", "-")
        sortkey = lambda c: (-c["score"], 0 if c["canon"] == 1 else 1)
        acc = np.flatnonzero(accept_v)
        if acc.size:
            keys = np.stack([ri[acc], pa_v[acc], pb_v[acc],
                             fa_v[acc].astype(np.int64)], 1)
            _u, first = np.unique(keys, axis=0, return_index=True)
            acc = acc[np.sort(first)]
            rows_a = ri[acc]
            if spl:
                # later rounds: drop lanes already attached for their row
                exist_rows = np.fromiter(spl.keys(), np.int64, len(spl))
                chk = np.isin(rows_a, exist_rows)
                if chk.any():
                    keep = np.ones(acc.size, bool)
                    for t in np.flatnonzero(chk):
                        k = int(acc[t])
                        cur = spl[int(rows_a[t])]
                        pa, pb, fa = int(pa_v[k]), int(pb_v[k]), \
                            bool(fa_v[k])
                        if any(x["posA"] == pa and x["posB"] == pb
                               and x["fw"] == fa for x in cur):
                            keep[t] = False
                    acc = acc[keep]
                    rows_a = ri[acc]
        if acc.size:
            order = np.lexsort((np.where(jcan[acc] == 1, 0, 1),
                                -jsc[acc], rows_a))
            accs = acc[order]
            rows_s = ri[accs]
            cands = [dict(score=int(s), posA=int(a), posB=int(b),
                          fw=bool(f), j=int(j), delta=int(d),
                          strand=str(st), canon=int(c), probscore=0.0)
                     for s, a, b, f, j, d, st, c in zip(
                         jsc[accs], pa_v[accs], pb_v[accs], fa_v[accs],
                         jj[accs], delta_v[accs], strands[accs],
                         jcan[accs])]
            ub, starts = np.unique(rows_s, return_index=True)
            bounds = np.append(starts, rows_s.size)
            for t in range(ub.size):
                i = int(ub[t])
                lst = cands[bounds[t]:bounds[t + 1]]
                cur = spl.get(i)
                if cur is None:
                    spl[i] = lst          # pre-sorted slice
                else:
                    cur.extend(lst)
                    cur.sort(key=sortkey)
            # publish confidently-discovered canonical junctions so later
            # reads (and the second pass) can use them as known sites
            if not self.opts.no_temp_splicesite:
                for k in accs[jcan[accs] == 2]:
                    k = int(k)
                    self.ssdb.add_novel(int(pa_v[k] + jj[k] - 1),
                                        int(pb_v[k] + jj[k]),
                                        str(strands[k]))
        par = np.flatnonzero(partial_v)
        if par.size:
            order = np.argsort(ri[par], kind="stable")
            pars = par[order]
            rows_ps = ri[pars]
            ub, starts = np.unique(rows_ps, return_index=True)
            bounds = np.append(starts, rows_ps.size)
            for t in range(ub.size):
                i = int(ub[t])
                cur = partial.setdefault(i, [])
                room = 4 - len(cur)
                for k in pars[bounds[t]:bounds[t + 1]][:max(0, room)]:
                    k = int(k)
                    cur.append(dict(
                        score=int(jsc[k]), posA=int(pa_v[k]),
                        posB=int(pb_v[k]), fw=bool(fa_v[k]),
                        j=int(jj[k]), delta=int(delta_v[k]),
                        strand=str(strands[k]), canon=int(jcan[k]),
                        probscore=0.0))
        # second pass: device-covered rows already got their chain lanes
        # from the fused dispatch (ops/splice.spliced_stage pass 2) —
        # attach those, then re-chain only rows OUTSIDE device coverage
        # within this call's scope
        scope = trig_mask
        if ret_resid is not None:
            scope = scope & ~ret_resid
        if d2blk is not None:
            self._attach_dev_chains(batch, spl, d2blk, lens)
            scope = scope & ~d2blk[4]
        if scope.any():
            self._splice_second_pass(batch, merged, spl, lens, perfect,
                                     scope=scope)
        return ret_resid

    def _newp_rescue(self, batch: ReadBatch, merged, rows_mask,
                     newp: np.ndarray) -> None:
        """Precision re-run for already-rescued rows whose spans contain
        sites published AFTER their lanes were scored: a known site
        (l, r) changes lane (posA, posB) scoring iff it fits that
        diagonal pair exactly at j = l - posA + 1 with r == posB + j —
        which is exactly the lane the known-site enumeration below
        generates. So instead of re-enumerating every seeded lane (full
        legacy rescue over ~hundreds of rows), only the handful of
        new-site-implied lanes are scored, on the host mirror
        (ops/splice_host) with the FULL site table; winners attach with
        replace-if-better and only rows whose candidate list changed
        re-run second-pass chaining."""
        o = self.opts
        lens = batch.lens.astype(np.int64)
        rowsv = np.flatnonzero(rows_mask)
        if rowsv.size == 0 or newp.size == 0:
            return
        sc, pos, fw = merged["score"], merged["pos"], merged["fw"]
        posr = pos[rowsv].astype(np.int64)           # (R, K2)
        fwr = fw[rowsv]
        liver = sc[rowsv] > NEG_INF // 2
        rl = lens[rowsv][:, None]
        nl = newp[np.argsort(newp[:, 0], kind="stable")]
        nr = newp[np.argsort(newp[:, 1], kind="stable")]
        rgrid = np.broadcast_to(rowsv[:, None], posr.shape)
        l_row, l_pa, l_pb, l_fa = [], [], [], []

        def add(rr, pa, pb, fa, okm):
            l_row.append(rr[okm])
            l_pa.append(pa[okm])
            l_pb.append(pb[okm])
            l_fa.append(fa[okm])
        lo = np.searchsorted(nl[:, 0], posr)
        hi = np.searchsorted(nl[:, 0], posr + rl - 1)
        for s in range(4):
            okm = liver & (lo + s < hi)
            si = np.minimum(lo + s, nl.shape[0] - 1)
            pb = nl[si, 1] - (nl[si, 0] - posr + 1)
            okm &= pb > posr
            add(rgrid, posr, pb, fwr, okm)
        lo2 = np.searchsorted(nr[:, 1], posr)
        hi2 = np.searchsorted(nr[:, 1], posr + rl)
        for s in range(4):
            okm = liver & (lo2 + s < hi2)
            si = np.minimum(lo2 + s, nr.shape[0] - 1)
            intron = nr[si, 1] - nr[si, 0] - 1
            pa2 = posr - intron
            okm &= pa2 < posr
            add(rgrid, pa2, posr, fwr, okm)
        if not l_row or sum(x.size for x in l_row) == 0:
            return
        ri = np.concatenate(l_row)
        pa_v = np.concatenate(l_pa)
        pb_v = np.concatenate(l_pb)
        fa_v = np.concatenate(l_fa)
        key = np.stack([ri, pa_v, pb_v, fa_v.astype(np.int64)], 1)
        _u, uidx = np.unique(key, axis=0, return_index=True)
        ri, pa_v, pb_v, fa_v = (x[uidx] for x in (ri, pa_v, pb_v, fa_v))
        rd_h, q_h = self._host_oriented(batch, ri, fa_v)
        kl_h, kr_h = self.ssdb.lefts_rights()
        _rh, pack = _splice_host.junction_score_gate(
            self.fm.ref.joined, self.scoring, rd_h, q_h, lens[ri],
            pa_v, pb_v, kl_h, kr_h, self.overlay, o.max_intron, o.dta)
        jsc = pack[:, 0]
        jj = pack[:, 1]
        fl = pack[:, 2]
        accept_v = (fl >> 4) & 1
        partial_v = (fl >> 5) & 1
        jstr = fl & 3
        jcan = (fl >> 2) & 3
        strands = np.where(jstr == 1, "+", "-")
        spl: dict = merged.setdefault("splice", {})
        partial: dict = merged.setdefault("splice_partial", {})
        changed = set()
        for k in np.flatnonzero(partial_v):
            k = int(k)
            i = int(ri[k])
            cur = partial.setdefault(i, [])
            if len(cur) < 4 and not any(
                    x["posA"] == pa_v[k] and x["posB"] == pb_v[k]
                    and x["fw"] == fa_v[k] for x in cur):
                cur.append(dict(
                    score=int(jsc[k]), posA=int(pa_v[k]),
                    posB=int(pb_v[k]), fw=bool(fa_v[k]), j=int(jj[k]),
                    delta=int(pb_v[k] - pa_v[k]),
                    strand=str(strands[k]), canon=int(jcan[k]),
                    probscore=0.0))
                changed.add(i)
        for k in np.flatnonzero(accept_v):
            k = int(k)
            i = int(ri[k])
            pa, pb, fa = int(pa_v[k]), int(pb_v[k]), bool(fa_v[k])
            cur = spl.setdefault(i, [])
            # same dedup rule as the main attach (skip existing
            # (posA, posB, fw) — the full legacy re-run keeps the old
            # entry too); only genuinely NEW lanes change the row
            if any(x["posA"] == pa and x["posB"] == pb
                   and x["fw"] == fa for x in cur):
                continue
            cur.append(dict(
                score=int(jsc[k]), posA=pa, posB=pb, fw=fa,
                j=int(jj[k]), delta=pb - pa,
                strand=str(strands[k]), canon=int(jcan[k]),
                probscore=0.0))
            changed.add(i)
            if (not o.no_temp_splicesite and int(jcan[k]) == 2):
                self.ssdb.add_novel(pa + int(jj[k]) - 1, pb + int(jj[k]),
                                    str(strands[k]))
        if not changed:
            return
        for i in changed:
            if i in spl:
                spl[i].sort(key=lambda c: (-c["score"],
                                           0 if c["canon"] == 1 else 1))
        scope = np.zeros(rows_mask.size, bool)
        scope[list(changed)] = True
        perfect = (self.scoring.match_bonus * lens).astype(np.int64)
        self._splice_second_pass(batch, merged, spl, lens, perfect,
                                 scope=scope)

    def _attach_dev_chains(self, batch, spl, d2blk, lens) -> None:
        """Attach the fused dispatch's gated pass-2 chain lanes (device
        mirror of _splice_second_pass): rebuild 3-segment chains from the
        shipped (base lane, diagonal) descriptors, score them exactly
        (vectorized _score_segs_rows / per-lane overlay path), and attach
        winners to merged['splice']."""
        sp32, sp16, sp32b, sp16b, covered = d2blk
        s16 = sp16b.astype(np.int64)
        valid = s16[:, 4] != 0
        if not valid.any():
            return
        rows2 = s16[valid, 0]
        keep = covered[rows2]
        if not keep.any():
            return
        rows2 = rows2[keep]
        basei = s16[valid, 1][keep]
        j2 = s16[valid, 2][keep]
        fl2 = s16[valid, 4][keep]
        b32 = sp32b.astype(np.int64)[valid][keep]
        pA2, pB2 = b32[:, 0], b32[:, 1]
        s16f = sp16.astype(np.int64)
        pa_b = sp32[basei, 0].astype(np.int64)
        pb_b = sp32[basei, 1].astype(np.int64)
        sc_b = s16f[basei, 2]
        j_b = s16f[basei, 3]
        fw_b = s16f[basei, 1] > 0
        flb = s16f[basei, 4]
        strand_b = flb & 3
        canon_b = (flb >> 2) & 3
        isL = ((fl2 >> 4) & 1) == 1
        canon2 = (fl2 >> 2) & 3
        pd = np.where(isL, pA2, pB2 - j_b)
        # segs [(p0,0),(p1,b1),(p2,b2)]
        p0 = np.where(isL, pd, pa_b)
        p1 = np.where(isL, pa_b, pb_b)
        p2v = np.where(isL, pb_b, pd)
        b1 = np.where(isL, j2, j_b)
        b2 = np.where(isL, j_b, j_b + j2)
        cA = np.where(isL, canon2, canon_b)
        cB = np.where(isL, canon_b, canon2)
        rl = lens[rows2]
        if self.overlay is None:
            score2 = self._score_segs_rows(batch, rows2, p0, p1, p2v,
                                           b1, b2, fw_b, cA, cB, rl)
        else:
            score2 = np.empty(rows2.size, np.int64)
            for k in range(rows2.size):
                score2[k] = self._score_segs(
                    int(rows2[k]), batch,
                    [(int(p0[k]), 0), (int(p1[k]), int(b1[k])),
                     (int(p2v[k]), int(b2[k]))], bool(fw_b[k]),
                    [int(cA[k]), int(cB[k])], int(rl[k]))
        min_sc = np.ceil(self.scoring.score_min.I
                         + self.scoring.score_min.S * rl).astype(np.int64)
        win = (score2 >= min_sc) & (score2 > sc_b)
        strands = np.where(strand_b == 1, "+", "-")
        for k in np.flatnonzero(win):
            k = int(k)
            i = int(rows2[k])
            segs = [(int(p0[k]), 0), (int(p1[k]), int(b1[k])),
                    (int(p2v[k]), int(b2[k]))]
            canons = [int(cA[k]), int(cB[k])]
            c2 = dict(score=int(score2[k]), posA=segs[0][0],
                      posB=segs[1][0], j=segs[1][1],
                      delta=segs[1][0] - segs[0][0], fw=bool(fw_b[k]),
                      strand=str(strands[k]), canon=min(canons),
                      canons=canons, segs=segs)
            cur = spl.setdefault(i, [])
            if any(x.get("segs") == segs for x in cur):
                continue
            cur.append(c2)
            cur.sort(key=lambda x: (-x["score"],
                                    0 if x["canon"] == 1 else 1))

    def _host_oriented(self, batch: ReadBatch, rows, fw):
        """(C, L) reads + quals in alignment orientation for arbitrary
        (row, fw) lanes, on the host (NumPy) — the host scorers'
        counterpart of ops/splice._gather_oriented.

        Both orientations are materialized ONCE per batch (int8, ~2xB*L
        bytes) and cached on the batch; repeated rescue rounds then cost
        one row gather instead of rebuilding take_along_axis temporaries
        (was ~20% of the RNA finish's rescue phase)."""
        cache = getattr(batch, "_host_oriented_cache", None)
        if cache is None:
            B, L = batch.seqs.shape
            seqs = batch.seqs.astype(np.int8)
            quals = np.clip(batch.quals, 0, 63).astype(np.int8)
            lens_b = batch.lens.astype(np.int64)
            ar = np.arange(L)
            in_read = ar[None, :] < lens_b[:, None]
            rcidx = np.clip(lens_b[:, None] - 1 - ar[None, :], 0, L - 1)
            comp = np.array([3, 2, 1, 0, 4], np.int8)
            rd_all = np.empty((2 * B, L), np.int8)
            q_all = np.zeros((2 * B, L), np.int8)
            rd_all[:B] = np.where(in_read, seqs, 4)
            q_all[:B] = np.where(in_read, quals, 0)
            rd_all[B:] = np.where(
                in_read, comp[np.take_along_axis(seqs, rcidx, 1)], 4)
            q_all[B:] = np.where(in_read,
                                 np.take_along_axis(quals, rcidx, 1), 0)
            cache = batch._host_oriented_cache = (rd_all, q_all, B)
        rd_all, q_all, B = cache
        idx = np.asarray(rows) + np.where(np.asarray(fw), 0, B)
        return (rd_all[idx].astype(np.int64),
                q_all[idx].astype(np.int64))

    def _spl_affected(self, merged, lens, newp) -> np.ndarray:
        """(B,) bool — rows whose candidate spans contain one of the
        `newp` (n, 2) splice sites: only these can gain a known-implied
        junction lane from the new sites, so re-rescue is limited to
        them (the reference's cross-thread sharing is likewise
        best-effort within a read-id skew window, hisat2.cpp:3285)."""
        sc, pos = merged["score"], merged["pos"]
        live = sc > NEG_INF // 2
        posl = pos.astype(np.int64)
        nl = np.sort(newp[:, 0])
        nr = np.sort(newp[:, 1])
        aff = np.zeros(sc.shape[0], bool)
        # per-candidate spans (an envelope over all K2 candidates covers
        # most of the genome — junk loci scatter), matching the lane
        # enumerator's per-candidate site windows [pos, pos + len)
        for t in range(sc.shape[1]):
            lo = posl[:, t]
            hi = lo + lens
            aff |= live[:, t] & (
                (np.searchsorted(nl, hi) > np.searchsorted(nl, lo))
                | (np.searchsorted(nr, hi) > np.searchsorted(nr, lo)))
        return aff

    def _junction_lanes(self, trigger, sc, pos, fw, lens):
        """Vectorized diagonal-pair enumeration for the junction kernel:
        per triggered read, known-site-implied pairs (in candidate order,
        left sites then right sites) followed by same-orientation
        candidate-pair diagonals, deduped, capped at pairs_per_read —
        the NumPy equivalent of the former per-read loop (identical lane
        sets and order)."""
        o = self.opts
        K2 = sc.shape[1]
        T = trigger.astype(np.int64)
        scs = sc[T]                                  # (N, K2)
        poss = pos[T].astype(np.int64)
        fws = fw[T]
        live = scs > NEG_INF // 2
        # first-occurrence dedup of (pos, fw) per row, in t order
        samep = (poss[:, :, None] == poss[:, None, :]) \
            & (fws[:, :, None] == fws[:, None, :])
        earlier = np.tril(np.ones((K2, K2), bool), -1)
        first = ~(samep & earlier[None]).any(axis=2)
        live &= first

        rowl, pal, pbl, fal, rankl = [], [], [], [], []
        kl, kr = self.ssdb.lefts_rights()
        if kl.size:
            kr_sorted, kl_by_r = self.ssdb.rights_sorted()
            rlen = lens[T]
            lo = np.searchsorted(kl, poss)                    # (N, K2)
            hi = np.searchsorted(kl, poss + rlen[:, None] - 1)
            lo2 = np.searchsorted(kr_sorted, poss)
            hi2 = np.searchsorted(kr_sorted, poss + rlen[:, None])
            for s in range(4):
                # upstream anchor: known left site inside [pa, pa+rl-1)
                ok = live & (lo + s < hi)
                si = np.minimum(lo + s, kl.size - 1)
                pb = kr[si] - (kl[si] - poss + 1)
                ok &= pb > poss
                r, c = np.nonzero(ok)
                rowl.append(r)
                pal.append(poss[r, c])
                pbl.append(pb[r, c])
                fal.append(fws[r, c])
                rankl.append(c * 8 + s)
                # downstream anchor: known right site inside [pa, pa+rl)
                ok = live & (lo2 + s < hi2)
                si = np.minimum(lo2 + s, kr_sorted.size - 1)
                intron = kr_sorted[si] - kl_by_r[si] - 1
                pa2 = poss - intron
                ok &= pa2 < poss
                r, c = np.nonzero(ok)
                rowl.append(r)
                pal.append(pa2[r, c])
                pbl.append(poss[r, c])
                fal.append(fws[r, c])
                rankl.append(c * 8 + 4 + s)
        # candidate-pair diagonals (same orientation, intron-range delta)
        d = poss[:, None, :] - poss[:, :, None]               # pb - pa
        okcc = (live[:, :, None] & live[:, None, :]
                & (fws[:, :, None] == fws[:, None, :])
                & (d >= o.min_intron) & (d <= o.max_intron))
        r, ci, cj = np.nonzero(okcc)
        rowl.append(r)
        pal.append(poss[r, ci])
        pbl.append(poss[r, cj])
        fal.append(fws[r, ci])
        rankl.append(8 * K2 + ci * K2 + cj)
        row = np.concatenate(rowl) if rowl else np.zeros(0, np.int64)
        empty4 = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros(0, np.int64), np.zeros(0, bool))
        if row.size == 0:
            return empty4
        pa = np.concatenate(pal)
        pb = np.concatenate(pbl)
        fa = np.concatenate(fal)
        rank = np.concatenate(rankl)
        # dedup (row, pa, pb, fa) keeping the lowest rank, then order by
        # rank and cap at pairs_per_read per row (legacy break semantics:
        # the cap counts DISTINCT pairs seen in rank order)
        ordd = np.lexsort((rank, fa, pb, pa, row))
        row, pa, pb, fa, rank = (x[ordd] for x in (row, pa, pb, fa, rank))
        keep = np.ones(row.size, bool)
        keep[1:] = ((row[1:] != row[:-1]) | (pa[1:] != pa[:-1])
                    | (pb[1:] != pb[:-1]) | (fa[1:] != fa[:-1]))
        row, pa, pb, fa, rank = (x[keep] for x in (row, pa, pb, fa, rank))
        ordr = np.lexsort((rank, row))
        row, pa, pb, fa = (x[ordr] for x in (row, pa, pb, fa))
        newrow = np.ones(row.size, bool)
        newrow[1:] = row[1:] != row[:-1]
        grp_start = np.maximum.accumulate(
            np.where(newrow, np.arange(row.size), 0))
        nth = np.arange(row.size) - grp_start
        capped = nth < o.pairs_per_read
        row, pa, pb, fa = (x[capped] for x in (row, pa, pb, fa))
        return T[row], pa, pb, fa.astype(bool)

    def _splice_second_pass(self, batch, merged, spl, lens, perfect,
                            scope=None):
        """Chain a further intron on either side of each read's best
        junction — reads crossing 2+ junctions (short middle exons),
        where the reference recurses (spliced_aligner.h:331
        hybridSearch_recur). The same closed-form junction kernel runs on
        the residual read segment against the remaining candidate
        diagonals; accepted chains become multi-segment candidates."""
        o = self.opts
        sc, pos, fw = merged["score"], merged["pos"], merged["fw"]
        L = batch.seqs.shape[1]
        partial = merged.get("splice_partial", {})
        lanes2 = []      # (i, c, side, pd)
        bases: dict[int, list] = {}
        # a second junction needs a residual exon: gate on the same
        # min-anchor margin as the main trigger (a winner within the
        # margin of perfect has only scattered mismatches left), unless a
        # KNOWN junction falls inside either residual diagonal's span
        margin = self._spl_margin(batch)
        kl_all, _kr_all = self.ssdb.lefts_rights()
        cand_items = [(i, cands[0]) for i, cands in spl.items()
                      if (scope is None or scope[i])
                      and "segs" not in cands[0]
                      and cands[0]["score"] < int(perfect[i])]
        if cand_items:
            csc = np.asarray([c["score"] for _, c in cand_items])
            cperf = perfect[np.asarray([i for i, _ in cand_items])]
            keep = csc < cperf - margin
            if kl_all.size and not keep.all():
                pa0 = np.asarray([c["posA"] for _, c in cand_items])
                pb0 = np.asarray([c["posB"] for _, c in cand_items])
                rl0 = lens[np.asarray([i for i, _ in cand_items])]
                known_res = ((np.searchsorted(kl_all, pa0 + rl0)
                              > np.searchsorted(kl_all, pa0))
                             | (np.searchsorted(kl_all, pb0 + rl0)
                                > np.searchsorted(kl_all, pb0)))
                keep |= known_res
            for (i, c), k in zip(cand_items, keep):
                if k:
                    bases.setdefault(i, []).append(c)
        for i, cands in partial.items():
            if scope is not None and not scope[i]:
                continue
            cands.sort(key=lambda x: -x["score"])
            for c in cands[:2]:
                bases.setdefault(i, []).append(c)
        if not bases:
            return
        # vectorized lane enumeration (was a per-row Python walk over the
        # K2 grid — ~10% of the RNA finish at steady state): one
        # (n_base, K2) broadcast finds every same-orientation residual
        # diagonal within intron range of every base candidate
        blist = [(i, c) for i, cs in bases.items() for c in cs]
        bi = np.asarray([i for i, _ in blist], np.int64)
        bpa = np.asarray([c["posA"] for _, c in blist], np.int64)
        bpb = np.asarray([c["posB"] for _, c in blist], np.int64)
        bj = np.asarray([c["j"] for _, c in blist], np.int64)
        bfw = np.asarray([c["fw"] for _, c in blist], bool)
        bstr = np.asarray([c["strand"] for _, c in blist])
        bcn = np.asarray([c["canon"] for _, c in blist], np.int64)
        bsc0 = np.asarray([c["score"] for _, c in blist], np.int64)
        scb = sc[bi]
        posb = pos[bi].astype(np.int64)
        fwb = fw[bi]
        K2g = scb.shape[1]
        live = scb > NEG_INF // 2
        dupm = np.zeros_like(live)
        for t in range(1, K2g):
            dupm[:, t] = ((posb[:, :t] == posb[:, t:t + 1])
                          & (fwb[:, :t] == fwb[:, t:t + 1])).any(axis=1)
        okb = live & ~dupm & (fwb == bfw[:, None])
        dLv = bpa[:, None] - posb
        dRv = posb - bpb[:, None]
        rlb = lens[bi]
        okL2 = (okb & (dLv >= o.min_intron) & (dLv <= o.max_intron)
                & (bj >= 2)[:, None])
        okR2 = (okb & ~okL2 & (dRv >= o.min_intron) & (dRv <= o.max_intron)
                & (bj <= rlb - 2)[:, None])
        lb, lt = np.nonzero(okL2 | okR2)
        if lb.size == 0:
            return
        l_idx = lb                                 # base-candidate index
        l_sideL = okL2[lb, lt]
        l_pd = posb[lb, lt]
        # cap per read (a global cap would starve multi-intron reads in
        # large batches)
        cap2 = 4 * o.pairs_per_read
        li_l = bi[l_idx]
        perm = np.argsort(li_l, kind="stable")
        sorted_li = li_l[perm]
        grp = np.concatenate([[0], np.flatnonzero(np.diff(sorted_li)) + 1])
        sizes = np.diff(np.append(grp, li_l.size))
        rank_sorted = np.arange(li_l.size) - np.repeat(grp, sizes)
        rank = np.empty(li_l.size, np.int64)
        rank[perm] = rank_sorted
        keep = rank < cap2
        l_idx, l_sideL, l_pd = l_idx[keep], l_sideL[keep], l_pd[keep]
        P = int(l_idx.size)
        self.metrics.splice_second_lanes += P
        # fixed size classes, as the JAX package pads them
        bucket = 1024
        while bucket < P:
            bucket *= 8
        pad_i = np.zeros(bucket - P, l_idx.dtype)
        l_idx_p = np.concatenate([l_idx, pad_i + l_idx[0]])
        l_sideL_p = np.concatenate([l_sideL, np.zeros(bucket - P, bool)
                                    | l_sideL[0]])
        l_pd_p = np.concatenate([l_pd, pad_i + l_pd[0]])
        # residual-segment lane reads are gathered + shifted ON DEVICE
        # (ops/splice.junction_score_packed_rows); the host only ships
        # small per-lane scalars
        li = bi[l_idx_p]
        lfw = bfw[l_idx_p]
        lj = bj[l_idx_p]
        lside_L = l_sideL_p
        lpd = l_pd_p
        lpA = bpa[l_idx_p]
        lpB = bpb[l_idx_p]
        rlv = lens[li]
        start = np.where(lside_L, 0, lj)
        seglen = np.where(lside_L, lj, rlv - lj)
        pA2 = np.where(lside_L, lpd, lpB + lj).astype(np.int32)
        pB2 = np.where(lside_L, lpA, lpd + lj).astype(np.int32)
        if not self.idx or P <= 131072:
            # NumPy segment scoring against the joined text
            # (ops/splice_host): a finalization-only aligner has no index
            # on the device, and small lane sets beat a mid-finish device
            # round trip
            li, lfw, start, seglen = (x[:P] for x in
                                      (li, lfw, start, seglen))
            pA2, pB2 = pA2[:P], pB2[:P]
            rd_f, q_f = self._host_oriented(batch, li, lfw)
            C2 = li.size
            ar2 = np.arange(L)
            take = np.clip(start[:, None] + ar2[None, :], 0, 2 * L - 1)
            dbl = np.concatenate([rd_f, np.full((C2, L), 4, np.int64)], 1)
            dblq = np.concatenate([q_f, np.zeros((C2, L), np.int64)], 1)
            rd2h = np.take_along_axis(dbl, take, 1)
            q2h = np.take_along_axis(dblq, take, 1)
            inseg = ar2[None, :] < seglen[:, None]
            rd2h = np.where(inseg, rd2h, 4)
            q2h = np.where(inseg, q2h, 0)
            kl_h, kr_h = self.ssdb.lefts_rights()
            rh, _pk = _splice_host.junction_score_gate(
                self.fm.ref.joined, self.scoring, rd2h, q2h, seglen,
                pA2.astype(np.int64), pB2.astype(np.int64), kl_h, kr_h,
                self.overlay, o.max_intron, o.dta)
            res2 = np.stack(
                [np.maximum(rh["score"], np.int64(-(1 << 30))), rh["j"],
                 rh["strand"], rh["canon"],
                 rh["probscore"].astype(np.float32).view(np.int32),
                 rh["mmL"], rh["mmR"]], axis=1).astype(np.int32)[:P]
        else:
            seqs2d, quals2d, lens2d = self._dev_oriented(batch)
            kleft, kright = self.ssdb.device_arrays(self.device)
            res2 = _splice.junction_score_packed_rows(
                self.idx, self.sctab, seqs2d, quals2d, lens2d,
                self._up(li), self._up(lfw, torch.bool), self._up(start),
                self._up(seglen), self._up(pA2), self._up(pB2),
                kleft, kright).cpu().numpy()[:P]
        j2 = res2[:, 1]
        st2 = res2[:, 2]
        cn2 = res2[:, 3]
        ps2 = res2[:, 4].view(np.float32)
        sc2 = res2[:, 0]
        # vectorized gates + chain scoring: only lanes passing every gate
        # AND beating their base candidate reach the per-lane Python
        liP = li[:P]
        ljP = lj[:P]
        lLP = lside_L[:P]
        lpdP = lpd[:P]
        lpAP = lpA[:P]
        lpBP = lpB[:P]
        rlP = lens[liP]
        lidxP = l_idx_p[:P]
        lstr = bstr[lidxP]
        lsc0 = bsc0[lidxP]
        str2 = np.where(st2 == 1, "+", "-")
        okv = (st2 != 0) & (sc2 > NEG_INF // 2) & (str2 == lstr)
        gj_v = ljP + j2
        okv &= np.where(lLP, (0 < j2) & (j2 < ljP),
                        (ljP < gj_v) & (gj_v < rlP))
        delta2_v = np.where(lLP, lpAP - lpdP, lpdP - lpBP)
        aL_v = j2
        aR_v = np.where(lLP, ljP, rlP - ljP) - j2
        shorter_v = np.maximum(np.minimum(aL_v, aR_v), 1)
        lim_c = _splice_model.max_intron_len(shorter_v)
        lim_n = _splice_model.max_intron_len_noncan(shorter_v)
        is_can2 = cn2 == 2
        gate_c2 = lim_c < o.max_intron
        okv &= ~(is_can2 & gate_c2 & (delta2_v > lim_c))
        okv &= ~(is_can2 & gate_c2
                 & (ps2 < _splice_model.probscore_thresh(delta2_v)))
        is_non2 = cn2 == 0
        okv &= ~(is_non2 & (lim_n < o.max_intron) & (delta2_v > lim_n))
        score2_v = np.full(P, NEG_INF, np.int64)
        surv = np.flatnonzero(okv)
        if surv.size and self.overlay is None:
            p0 = np.where(lLP, lpdP, lpAP)[surv]
            p1 = np.where(lLP, lpAP, lpBP)[surv]
            p2v = np.where(lLP, lpBP, lpdP)[surv]
            b1 = np.where(lLP[surv], j2[surv], ljP[surv])
            b2 = np.where(lLP[surv], ljP[surv], gj_v[surv])
            cA = np.where(lLP[surv], cn2[surv], bcn[lidxP[surv]])
            cB = np.where(lLP[surv], bcn[lidxP[surv]], cn2[surv])
            score2_v[surv] = self._score_segs_rows(
                batch, liP[surv], p0, p1, p2v, b1, b2,
                bfw[lidxP[surv]], cA, cB, rlP[surv])
        elif surv.size:
            for k in surv:
                k = int(k)
                i, c = blist[int(lidxP[k])]
                side = "L" if lLP[k] else "R"
                pd = int(lpdP[k])
                segs_t = ([(pd, 0), (c["posA"], int(j2[k])),
                           (c["posB"], c["j"])] if side == "L"
                          else [(c["posA"], 0), (c["posB"], c["j"]),
                                (pd, c["j"] + int(j2[k]))])
                canons_t = ([int(cn2[k]), c["canon"]] if side == "L"
                            else [c["canon"], int(cn2[k])])
                score2_v[k] = self._score_segs(i, batch, segs_t, c["fw"],
                                               canons_t, int(lens[i]))
        min_sc_v2 = np.ceil(self.scoring.score_min.I
                            + self.scoring.score_min.S * rlP
                            ).astype(np.int64)
        okv &= (score2_v >= min_sc_v2) & (score2_v > lsc0)
        for k in np.flatnonzero(okv):
            k = int(k)
            i, c = blist[int(lidxP[k])]
            side = "L" if lLP[k] else "R"
            pd = int(lpdP[k])
            jj2 = int(j2[k])
            rl = int(lens[i])
            if side == "L":
                segs = [(pd, 0), (c["posA"], jj2), (c["posB"], c["j"])]
            else:
                segs = [(c["posA"], 0), (c["posB"], c["j"]),
                        (pd, c["j"] + jj2)]
            canons = ([int(cn2[k]), c["canon"]] if side == "L"
                      else [c["canon"], int(cn2[k])])
            score2 = int(score2_v[k])
            c2 = dict(score=int(score2), posA=segs[0][0], posB=segs[1][0],
                      j=segs[1][1], delta=segs[1][0] - segs[0][0],
                      fw=c["fw"], strand=c["strand"],
                      canon=min(canons), canons=canons, segs=segs)
            cur = spl.setdefault(i, [])
            if any(x.get("segs") == segs for x in cur):
                continue
            cur.append(c2)
            cur.sort(key=lambda x: (-x["score"],
                                    0 if x["canon"] == 1 else 1))

    def _score_segs_rows(self, batch, li, p0, p1, p2, b1, b2, fw, cA, cB,
                         rdlens):
        """Vectorized _score_segs for 3-segment chains: exact clip-aware
        score of segs [(p0,0),(p1,b1),(p2,b2)] per lane (linear index —
        no overlay; graph callers use the per-lane path)."""
        ref = self.fm.ref
        N = li.size
        L = batch.seqs.shape[1]
        seqs = batch.seqs[li].astype(np.int64)
        quals = np.clip(batch.quals[li].astype(np.int64), 0, 63)
        ar = np.arange(L)
        rci = np.clip(rdlens[:, None] - 1 - ar[None, :], 0, L - 1)
        compT = np.array([3, 2, 1, 0, 4], np.int64)
        rd = np.where(fw[:, None], seqs,
                      compT[np.take_along_axis(seqs, rci, 1)])
        q = np.where(fw[:, None], quals, np.take_along_axis(quals, rci, 1))
        in_read = ar[None, :] < rdlens[:, None]
        rd = np.where(in_read, rd, 4)
        joined = ref.joined
        posx = np.where(ar[None, :] < b1[:, None], p0[:, None],
                        np.where(ar[None, :] < b2[:, None], p1[:, None],
                                 p2[:, None])) + ar[None, :]
        inb = (posx >= 0) & (posx < joined.size)
        win = np.where(inb, joined[np.clip(posx, 0, joined.size - 1)], 4
                       ).astype(np.int64)
        isn = ((rd >= 4) | (win >= 4)) & in_read
        mm = (rd != win) & ~isn & in_read
        s = np.where(mm, -self.scoring.mm_pens()[q], 0)
        s = np.where(isn, -self.scoring.n_pen, s)
        scp = np.where(in_read, self.scoring.sc_pens()[q], 0)
        A = np.zeros((N, L + 1), np.int64)
        np.cumsum(s, axis=1, out=A[:, 1:])
        SCP = np.zeros((N, L + 1), np.int64)
        np.cumsum(scp, axis=1, out=SCP[:, 1:])
        idx = np.arange(L + 1)[None, :]
        BIG = np.int64(1) << 40
        c5 = np.argmin(np.where(idx <= b1[:, None], A + SCP, BIG), axis=1)
        SL = np.take_along_axis(SCP, rdlens[:, None], 1)
        vals = np.where((idx >= b2[:, None]) & (idx <= rdlens[:, None]),
                        (A - np.take_along_axis(A, b2[:, None], 1))
                        - (SL - SCP), -BIG)
        e = L - np.argmax(vals[:, ::-1], axis=1)
        base = (np.take_along_axis(A, e[:, None], 1)[:, 0]
                - A[np.arange(N), c5] - SCP[np.arange(N), c5]
                - (SL[:, 0] - np.take_along_axis(SCP, e[:, None], 1)[:, 0]))
        d1 = np.maximum(p1 - p0, 1)
        d2 = np.maximum(p2 - p1, 1)
        pen = (np.maximum(0, (-8.0 + np.log(d1)).astype(np.int64))
               + np.maximum(0, (-8.0 + np.log(d2)).astype(np.int64))
               + np.where(cA == 0, _splice.NONCANON_PEN, 0)
               + np.where(cB == 0, _splice.NONCANON_PEN, 0))
        return base - pen

    def _score_segs(self, i, batch, segs, fw_flag, canons, rdlen) -> int:
        """Exact host score of a multi-segment spliced alignment: clips +
        mismatches + per-junction splice penalties (same policy as the
        device kernel: known/canonical = intron-length penalty only,
        non-canonical +12)."""
        ref = self.fm.ref
        rd = batch.seqs[i, :rdlen].astype(np.uint8)
        q = np.clip(batch.quals[i, :rdlen].astype(np.int64), 0, 63)
        if not fw_flag:
            rd = alphabet.revcomp(rd)
            q = q[::-1].copy()
        bounds = [j for _, j in segs] + [rdlen]
        win = np.concatenate(
            [ref.get_stretch(p + j0, j1 - j0)
             for (p, j0), j1 in zip(segs, bounds[1:])])
        isn = (rd >= 4) | (win >= 4)
        mm = (rd != win) & ~isn
        if self.overlay is not None:
            ovw = np.concatenate(
                [self._overlay_window(p + j0, j1 - j0)
                 for (p, j0), j1 in zip(segs, bounds[1:])])
            mm &= ~((ovw == rd + 1) | (ovw == 15))
        s = np.where(mm, -self.scoring.mm_pens()[q], 0)
        s = np.where(isn, -self.scoring.n_pen, s)
        scp = self.scoring.sc_pens()[q].astype(np.int64)
        A = np.concatenate([[0], np.cumsum(s)])
        SCP = np.concatenate([[0], np.cumsum(scp)])
        j1 = bounds[1]
        jlast = bounds[len(segs) - 1]
        c5 = int(np.argmin((A + SCP)[: j1 + 1]))
        vals = (A[jlast:] - A[jlast]) - (SCP[-1] - SCP[jlast:])
        e = rdlen - int(np.argmax(vals[::-1]))
        base = int((A[e] - A[c5]) - SCP[c5] - (SCP[-1] - SCP[e]))
        pen = 0
        for k in range(len(segs) - 1):
            delta = segs[k + 1][0] - segs[k][0]
            pen += max(0, int(-8.0 + np.log(max(delta, 1))))
            if canons[k] == 0:
                pen += _splice.NONCANON_PEN
        return base - pen

    def _spliced_fin_rows(self, batch, rows, posA, posB, jj, fw, strands,
                          rdlens):
        """Vectorized single-junction finalization (the NumPy mirror of
        _finalize_spliced for segs == [(posA,0),(posB,j)]): optimal outer
        clips, per-segment M lengths, NM, and mismatch (col, refchar)
        triples for the native MD builder. Returns column dict with an
        `ok` mask (fragment containment; ineligible rows fall back to the
        per-read path)."""
        ref = self.fm.ref
        N = rows.size
        L = batch.seqs.shape[1]
        seqs = batch.seqs[rows].astype(np.int64)
        quals = np.clip(batch.quals[rows].astype(np.int64), 0, 63)
        ar = np.arange(L)
        rcidx = np.clip(rdlens[:, None] - 1 - ar[None, :], 0, L - 1)
        comp = np.array([3, 2, 1, 0, 4], np.int64)
        rd = np.where(fw[:, None], seqs,
                      comp[np.take_along_axis(seqs, rcidx, 1)])
        q = np.where(fw[:, None], quals, np.take_along_axis(quals, rcidx, 1))
        in_read = ar[None, :] < rdlens[:, None]
        rd = np.where(in_read, rd, 4)

        joined = ref.joined
        posx = np.where(ar[None, :] < jj[:, None], posA[:, None],
                        posB[:, None]) + ar[None, :]
        inb = (posx >= 0) & (posx < joined.size)
        win = np.where(inb, joined[np.clip(posx, 0, joined.size - 1)], 4
                       ).astype(np.int64)

        isn = ((rd >= 4) | (win >= 4)) & in_read
        mm = (rd != win) & ~isn & in_read
        if self.overlay is not None:
            # graph mode: known ALT alleles are penalty-free (and do not
            # count toward NM/XM) but still show in MD, mirroring
            # _finalize_spliced / _ungapped_arrays
            ov = np.where(inb, self.overlay[np.clip(posx, 0,
                                                    joined.size - 1)], 0)
            mm_sc = mm & ~((ov == rd + 1) | (ov == 15))
        else:
            mm_sc = mm
        s = np.where(mm_sc, -self.scoring.mm_pens()[q], 0)
        s = np.where(isn, -self.scoring.n_pen, s)
        scp = np.where(in_read, self.scoring.sc_pens()[q], 0)
        A = np.zeros((N, L + 1), np.int64)
        np.cumsum(s, axis=1, out=A[:, 1:])
        SCP = np.zeros((N, L + 1), np.int64)
        np.cumsum(scp, axis=1, out=SCP[:, 1:])
        idx = np.arange(L + 1)[None, :]
        BIG = np.int64(1) << 40
        # c5 = argmin (A+SCP)[:j+1] (ties toward smaller c5 = np.argmin)
        c5 = np.argmin(np.where(idx <= jj[:, None], A + SCP, BIG),
                       axis=1).astype(np.int64)
        # e in [j, rdlen] maximizing tail score - trailing clip, ties
        # toward larger e (reference reversed-argmax)
        SL = np.take_along_axis(SCP, rdlens[:, None], 1)
        vals = np.where((idx >= jj[:, None]) & (idx <= rdlens[:, None]),
                        (A - np.take_along_axis(A, jj[:, None], 1))
                        - (SL - SCP), -BIG)
        e = (L - np.argmax(vals[:, ::-1], axis=1)).astype(np.int64)
        degen = (jj - c5 <= 0) | (e - jj <= 0)
        c5 = np.where(degen, 0, c5)
        e = np.where(degen, rdlens, e)
        c3 = rdlens - e
        aligned_mask = (ar[None, :] >= c5[:, None]) & (ar[None, :] < e[:, None])
        nm = ((mm_sc | isn) & aligned_mask).sum(axis=1).astype(np.int32)

        # fragment containment of the full spliced span
        delta = posB - posA
        astart = posA + c5
        span = (e - c5) + delta
        f = np.searchsorted(ref.frag_joined, astart, side="right") - 1
        fc = np.clip(f, 0, len(ref.frag_joined) - 1)
        ok = (f >= 0) & (astart + span
                         <= ref.frag_joined[fc] + ref.frag_len[fc])

        mmsel = (mm | isn) & aligned_mask
        ri, cols = np.nonzero(mmsel)
        cnt = mmsel.sum(axis=1).astype(np.int64)
        mm_off = np.zeros(N + 1, np.int64)
        np.cumsum(cnt, out=mm_off[1:])
        mm_cols = (cols - c5[ri]).astype(np.int32)
        mm_ref = np.ascontiguousarray(
            _DEC5[np.clip(win[ri, cols], 0, 4)])
        return dict(ok=ok, c5=c5.astype(np.int32), c3=c3.astype(np.int32),
                    m1=(jj - c5).astype(np.int32),
                    mid=(e - c5).astype(np.int32),
                    gap=delta.astype(np.int32), nm=nm,
                    tidx=ref.frag_tidx[fc].astype(np.int32),
                    toff=(ref.frag_toff[fc] + astart
                          - ref.frag_joined[fc]).astype(np.int64),
                    mm_cols=mm_cols, mm_ref=mm_ref, mm_off=mm_off,
                    xs=np.where(strands == "+", 1, 2).astype(np.int32))

    def _finalize_spliced(self, i, batch, c: dict, rdlen: int
                          ) -> Alignment | None:
        """Materialize a spliced candidate: CIGAR M/N/M(/N/M...), MD over
        the exon windows, XS:A strand (sam.h:930-940). Single-junction
        candidates carry posA/posB/j; multi-intron chains (the reference's
        hybridSearch_recur recursion, spliced_aligner.h:331) carry a
        `segs` list of (joined_pos, read_start) exon segments."""
        ref = self.fm.ref
        rd = batch.seqs[i, :rdlen].astype(np.uint8)
        if not c["fw"]:
            rd = alphabet.revcomp(rd)
        segs = c.get("segs") or [(c["posA"], 0), (c["posB"], c["j"])]
        bounds = [j for _, j in segs] + [rdlen]
        if any(bounds[k + 1] <= bounds[k] for k in range(len(segs))):
            return None
        win = np.concatenate(
            [ref.get_stretch(p + j0, j1 - j0)
             for (p, j0), j1 in zip(segs, bounds[1:])])
        # recover optimal outer soft clips (mirrors the kernel's clip-aware
        # prefix/suffix cummins)
        q = batch.quals[i, :rdlen].astype(np.int64)
        if not c["fw"]:
            q = q[::-1].copy()
        mm_pens = self.scoring.mm_pens()
        isn = (rd >= 4) | (win >= 4)
        mm = (rd != win) & ~isn
        if self.overlay is not None:
            ovw = np.concatenate(
                [self._overlay_window(p + j0, j1 - j0)
                 for (p, j0), j1 in zip(segs, bounds[1:])])
            mm &= ~((ovw == rd + 1) | (ovw == 15))
        s = np.where(mm, -mm_pens[np.clip(q, 0, 63)], 0)
        s = np.where(isn, -self.scoring.n_pen, s)
        scp = self.scoring.sc_pens()[np.clip(q, 0, 63)].astype(np.int64)
        A = np.concatenate([[0], np.cumsum(s)])
        SCP = np.concatenate([[0], np.cumsum(scp)])
        j1 = bounds[1]                      # first junction offset
        jlast = bounds[len(segs) - 1]       # last junction offset
        c5 = int(np.argmin((A + SCP)[: j1 + 1]))
        # end e >= jlast maximizing tail score - trailing clip; ties
        # toward larger e (fewer clipped bases)
        vals = (A[jlast:] - A[jlast]) - (SCP[-1] - SCP[jlast:])
        e = rdlen - int(np.argmax(vals[::-1]))
        c3 = rdlen - e
        if j1 - c5 <= 0 or e - jlast <= 0:
            if len(segs) > 2:
                return None
            c5, c3, e = 0, 0, rdlen
        mid_mask = np.zeros(rdlen, bool)
        mid_mask[c5:e] = True
        nm = int(((mm | isn) & mid_mask).sum())
        md, _ = samio.make_md(rd[c5:e], win[c5:e], [("M", e - c5)])
        cigar = [("S", c5)] if c5 else []
        for k in range(len(segs)):
            lo = max(bounds[k], c5)
            hi = min(bounds[k + 1], e)
            cigar.append(("M", hi - lo))
            if k + 1 < len(segs):
                cigar.append(("N", segs[k + 1][0] - segs[k][0]))
        if c3:
            cigar.append(("S", c3))
        aln = Alignment(joined_pos=segs[0][0] + c5, fw=c["fw"],
                        score=c["score"], cigar=cigar, nmm=nm, md=md, nm=nm,
                        xs_strand=c["strand"])
        loc = ref.joined_to_text(aln.joined_pos, aln.ref_span)
        if loc is None:
            return None
        aln.tidx, aln.toff = loc
        if not self.opts.no_temp_splicesite:
            canons = c.get("canons") or [c["canon"]]
            for k in range(len(segs) - 1):
                if canons[min(k, len(canons) - 1)] == 2:
                    # junction k: intron [seg_k pos + j_{k+1}, seg_{k+1}
                    # pos + j_{k+1})
                    self.ssdb.add_novel(
                        segs[k][0] + bounds[k + 1] - 1,
                        segs[k + 1][0] + bounds[k + 1], c["strand"])
        return aln

    def _select_with_splice(self, i, batch, merged, spl_cands, min_sc,
                            rdlen) -> ReadResult:
        """Slow-path selection mixing contiguous and spliced candidates."""
        res = ReadResult()
        reg = self._ranked_candidates(merged, i, min_sc)
        entries = [(s, ("reg", (p, fw, gapped))) for s, p, fw, gapped, _, _
                   in reg]
        entries += [(c["score"], ("spl", c)) for c in spl_cands]
        # ties: known-splice-site junctions beat contiguous alignments
        # (transcriptome-aware preference, --ss indexes)
        entries.sort(key=lambda e: (-e[0], 0 if (e[1][0] == "spl"
                                                 and e[1][1]["canon"] == 1)
                                    else 1))
        if not entries or entries[0][0] < min_sc:
            return res
        for s, (kind, data) in entries[: self.opts.khits + 1]:
            if s < min_sc:
                break
            if kind == "reg":
                p, fw, gapped = data
                a = self._finalize(i, batch, s, p, fw, gapped, rdlen)
            else:
                a = self._finalize_spliced(i, batch, data, rdlen)
            if a is not None:
                res.alns.append(a)
        if not res.alns:
            return res
        _dedup_alns(res, self.opts.khits)
        return res


    def _finalize_results(self, batch: ReadBatch, merged, only_rows=None):
        """Vectorized host finalization: primary-winner clips/MD/coords
        are computed batch-wide with NumPy; only gapped winners,
        secondaries and fragment-boundary rejects drop to per-read paths.

        only_rows: optional sorted row indices — finalize just those reads
        and return {row: ReadResult}."""
        B = len(batch)
        L = batch.seqs.shape[1]
        lens = batch.lens.astype(np.int64)
        sc = self.scoring
        min_scs = np.ceil(sc.score_min.I
                          + sc.score_min.S * lens).astype(np.int64)
        nNs = ((batch.seqs >= 4)
               & (np.arange(L)[None, :] < lens[:, None])).sum(axis=1)
        max_ns = sc.n_ceil.I + sc.n_ceil.S * lens

        msc, mpos = merged["score"], merged["pos"]
        mfw, mgap = merged["fw"], merged["gapped"]
        filtered = (lens == 0) | (nNs > max_ns)
        aligned = ~filtered & (msc[:, 0] >= min_scs)
        nvalid = (msc >= min_scs[:, None]).sum(axis=1)
        has_sec = ~filtered & (nvalid >= 2)

        # ---- batched primary ungapped finalization ----
        prim_un = aligned & ~mgap[:, 0]
        if only_rows is not None:
            sel = np.zeros(B, bool)
            sel[only_rows] = True
            prim_un &= sel
        rows = np.flatnonzero(prim_un)
        fin: dict[int, Alignment] = {}
        if rows.size:
            fin = self._finalize_ungapped_rows(
                batch, rows, mpos[rows, 0], mfw[rows, 0], lens[rows])
        spl = merged.get("splice", {})
        todo = range(B) if only_rows is None else [int(i) for i in only_rows]
        out = {i: self._finalize_one(batch, merged, i, filtered, aligned,
                                     has_sec, nvalid, lens, min_scs, msc,
                                     mpos, mfw, mgap, fin, spl)
               for i in todo}
        return out if only_rows is not None else [out[i] for i in range(B)]

    def _finalize_one(self, batch, merged, i, filtered, aligned, has_sec,
                      nvalid, lens, min_scs, msc, mpos, mfw, mgap, fin,
                      spl) -> ReadResult:
        """One read's host finalization (contiguous or spliced winner)."""
        if filtered[i]:
            return ReadResult(filtered=_filter_reason(batch, i, lens))
        if i in spl and (not aligned[i]
                         or spl[i][0]["score"] > msc[i, 0]
                         or (spl[i][0]["score"] == msc[i, 0]
                             and spl[i][0]["canon"] == 1)):
            return self._select_with_splice(
                i, batch, merged, spl[i], int(min_scs[i]), int(lens[i]))
        if not aligned[i]:
            return ReadResult()
        res = ReadResult(best=int(msc[i, 0]),
                         secbest=int(msc[i, 1]) if has_sec[i] else None)
        a0 = fin.get(i) if not mgap[i, 0] else self._finalize(
            i, batch, int(msc[i, 0]), int(mpos[i, 0]), bool(mfw[i, 0]),
            True, int(lens[i]))
        if a0 is None:  # fragment-boundary reject: try remaining cands
            cands = self._ranked_candidates(merged, i, int(min_scs[i]))
            return self._select(i, batch, cands,
                                int(min_scs[i]), int(lens[i]))
        res.alns.append(a0)
        if nvalid[i] > 1 and self.opts.khits > 1:
            for t in range(1, min(int(nvalid[i]), self.opts.khits + 1)):
                a = self._finalize(i, batch, int(msc[i, t]),
                                   int(mpos[i, t]), bool(mfw[i, t]),
                                   bool(mgap[i, t]), int(lens[i]))
                if a is not None:
                    res.alns.append(a)
        _dedup_alns(res, self.opts.khits)
        return res

    def _select(self, i, batch, cands, min_sc, rdlen) -> ReadResult:
        res = ReadResult()
        valid = [c for c in cands if c[0] >= min_sc]
        if not valid:
            return res
        res.best = valid[0][0]
        if len(valid) > 1:
            res.secbest = valid[1][0]
        for s, p, fw, gapped, row, t in valid[: self.opts.khits + 1]:
            aln = self._finalize(i, batch, s, p, fw, gapped, rdlen)
            if aln is not None:
                res.alns.append(aln)
        if not res.alns:
            return ReadResult()
        _dedup_alns(res, self.opts.khits)
        return res

    def _ungapped_arrays(self, batch, rows, pos, fw, rdlens) -> dict:
        """Vectorized clips + mismatch extraction + coordinate mapping for
        ungapped placements. Returns column arrays over the `rows` subset
        (ok marks fragment-contained alignments) plus mismatch (row, col,
        refchar) triples for MD construction."""
        sc = self.scoring
        ref = self.fm.ref
        R = rows.size
        L = batch.seqs.shape[1]
        # read in alignment orientation
        seqs = batch.seqs[rows].astype(np.int64)
        quals = np.clip(batch.quals[rows].astype(np.int64), 0, 63)
        ar = np.arange(L)
        rcidx = np.clip(rdlens[:, None] - 1 - ar[None, :], 0, L - 1)
        comp = np.array([3, 2, 1, 0, 4], np.int64)
        rd = np.where(fw[:, None], seqs,
                      comp[np.take_along_axis(seqs, rcidx, 1)])
        q = np.where(fw[:, None], quals, np.take_along_axis(quals, rcidx, 1))
        in_read = ar[None, :] < rdlens[:, None]
        rd = np.where(in_read, rd, 4)
        joined = ref.joined
        wpos = pos[:, None] + ar[None, :]
        inb = (wpos >= 0) & (wpos < joined.size)
        win = np.where(inb, joined[np.clip(wpos, 0, joined.size - 1)], 4
                       ).astype(np.int64)
        isn = ((rd >= 4) | (win >= 4)) & in_read
        mm = (rd != win) & ~isn & in_read
        if self.overlay is not None:
            ov = np.where(inb, self.overlay[np.clip(wpos, 0,
                                                    joined.size - 1)], 0)
            snp_free = mm & ((ov == rd + 1) | (ov == 15))
        else:
            snp_free = np.zeros_like(mm)
        mm_sc = mm & ~snp_free                 # penalized mismatches
        s = np.where(mm_sc, -sc.mm_pens()[q], 0)
        s = np.where(isn, -sc.n_pen, s)
        s = s + np.where(~mm_sc & ~isn & in_read, sc.match_bonus, 0)
        scp = np.where(in_read, sc.sc_pens()[q], 0)
        P = np.concatenate([np.zeros((R, 1), np.int64),
                            np.cumsum(s + scp, axis=1)], axis=1)
        prefmin = np.minimum.accumulate(P, axis=1)
        ends = P[:, 1:] - prefmin[:, :-1]
        ends_m = np.where(in_read, ends, np.int64(-1) << 40)
        k = (L - 1) - np.argmax(ends_m[:, ::-1], axis=1)
        Pm = np.where(np.arange(L + 1)[None, :] <= k[:, None], P,
                      np.int64(1) << 40)
        c5 = np.argmin(Pm, axis=1)
        best = ends_m[np.arange(R), k]
        score = best - scp.sum(axis=1)
        c3 = rdlens - (k + 1)
        # mismatches inside the aligned region: MD shows every diff
        # (SNP-allele positions included), NM/XM count only penalized ones
        amask = (ar[None, :] >= c5[:, None]) & (ar[None, :] <= k[:, None])
        mm_all = (mm | isn) & amask
        nmm = ((mm_sc | isn) & amask).sum(axis=1)
        # coordinates: fragment containment
        astart = pos + c5
        span = rdlens - c5 - c3
        f = np.searchsorted(ref.frag_joined, astart, side="right") - 1
        ok = (f >= 0) & (span > 0)
        fc = np.clip(f, 0, len(ref.frag_joined) - 1)
        ok &= astart + span <= ref.frag_joined[fc] + ref.frag_len[fc]
        tidx = ref.frag_tidx[fc]
        toff = ref.frag_toff[fc] + astart - ref.frag_joined[fc]
        mm_rows, mm_cols = np.nonzero(mm_all)
        return dict(rd=rd, q=q, win=win, c5=c5, c3=c3, k=k, score=score,
                    nmm=nmm, ok=ok, tidx=tidx, toff=toff, astart=astart,
                    in_read=in_read, mm_rows=mm_rows, mm_cols=mm_cols,
                    mm_ref=win[mm_rows, mm_cols])

    def _finalize_ungapped_rows(self, batch, rows, pos, fw, rdlens
                                ) -> dict[int, Alignment]:
        """Alignment objects for ungapped primary winners (reads whose
        alignment crosses a fragment boundary are omitted)."""
        alns = self._finalize_ungapped_list(batch, rows, pos, fw, rdlens)
        return {int(rows[r]): a for r, a in enumerate(alns) if a is not None}

    def _finalize_ungapped_list(self, batch, rows, pos, fw, rdlens) -> list:
        """One vectorized pass over (rows may repeat a read index): an
        Alignment, or None for a fragment-crossing placement, per row."""
        A = self._ungapped_arrays(batch, rows, pos, fw, rdlens)
        mm_rows, mm_cols, win = A["mm_rows"], A["mm_cols"], A["win"]
        out: list = []
        ptr = 0
        for r in range(rows.size):
            if not A["ok"][r]:
                out.append(None)
                continue
            rl, cc5, cc3 = int(rdlens[r]), int(A["c5"][r]), int(A["c3"][r])
            mid = rl - cc5 - cc3
            cigar = ([("S", cc5)] if cc5 else []) + [("M", mid)] \
                + ([("S", cc3)] if cc3 else [])
            while ptr < mm_rows.size and mm_rows[ptr] < r:
                ptr += 1
            md_parts = []
            last = cc5 - 1
            p2 = ptr
            while p2 < mm_rows.size and mm_rows[p2] == r:
                cpos = int(mm_cols[p2])
                md_parts.append(str(cpos - last - 1))
                md_parts.append("ACGTN"[int(win[r, cpos])])
                last = cpos
                p2 += 1
            md_parts.append(str(cc5 + mid - 1 - last))
            a = Alignment(
                joined_pos=int(A["astart"][r]), fw=bool(fw[r]),
                score=int(A["score"][r]), cigar=cigar, nmm=int(A["nmm"][r]),
                md="".join(md_parts), nm=int(A["nmm"][r]),
                tidx=int(A["tidx"][r]), toff=int(A["toff"][r]))
            if self.opts.zs_tags:
                a.zs_snps = self._zs_string(A["rd"][r], int(pos[r]),
                                            cc5, rl - cc3)
            out.append(a)
        return out

    def _ranked_candidates(self, merged, i, min_sc, limit=None):
        """Candidate tuples for read i, best-first, scores >= min_sc,
        deduped by (pos, fw)."""
        limit = limit or (self.opts.khits + 2)
        out = []
        seen = set()
        sc = merged["score"][i]
        for t in range(sc.shape[0]):
            s = int(sc[t])
            if s < min_sc:
                break  # sorted desc
            key = (int(merged["pos"][i, t]), bool(merged["fw"][i, t]))
            if key in seen:
                continue
            seen.add(key)
            out.append((s, key[0], key[1], bool(merged["gapped"][i, t]), i, t))
            if len(out) >= limit:
                break
        return out

    def _finalize(self, i, batch, score, pos, fw, gapped, rdlen
                  ) -> Alignment | None:
        """Build CIGAR/MD for one winning candidate (host, NumPy; gapped
        ones through the native DP traceback)."""
        ref = self.fm.ref
        rd = batch.seqs[i, :rdlen].astype(np.uint8)
        q = batch.quals[i, :rdlen].astype(np.int32)
        if not fw:
            rd = alphabet.revcomp(rd)
            q = q[::-1].copy()
        if not gapped:
            window = ref.get_stretch(pos, rdlen)
            ovw = self._overlay_window(pos, rdlen)
            c5, c3, sub_score = _best_clip(self.scoring, rd, q, window, ovw)
            mid = rdlen - c5 - c3
            if mid <= 0:
                return None
            cigar = ([("S", c5)] if c5 else []) + [("M", mid)] \
                + ([("S", c3)] if c3 else [])
            md, _ = samio.make_md(rd[c5:rdlen - c3], window[c5:rdlen - c3],
                                  [("M", mid)])
            a_rd, a_rf = rd[c5:rdlen - c3], window[c5:rdlen - c3]
            diff = (a_rd != a_rf) | (a_rd >= 4) | (a_rf >= 4)
            if ovw is not None:
                aov = ovw[c5:rdlen - c3]
                diff &= ~((aov == a_rd + 1) | (aov == 15))
            nd = int(diff.sum())
            aln = Alignment(joined_pos=pos + c5, fw=fw, score=sub_score,
                            cigar=cigar, nmm=nd, md=md, nm=nd)
            if self.opts.zs_tags:
                aln.zs_snps = self._zs_string(rd, pos, c5, rdlen - c3)
        else:
            aln = self._try_snp_indels(rd, q, pos, rdlen, fw)
            if aln is None:
                aln = self._traceback(rd, q, pos, rdlen, fw)
                self._adjust_snp_gaps(aln, rd)
        loc = ref.joined_to_text(aln.joined_pos, aln.ref_span)
        if loc is None:
            return None
        aln.tidx, aln.toff = loc
        return aln

    def _traceback(self, rd, q, pos, rdlen, fw) -> Alignment:
        """A gapped candidate's alignment from the native DP traceback
        over its padded window."""
        pad = self.opts.dp_pad
        wstart = pos - pad
        window = self.fm.ref.get_stretch(wstart, rdlen + 2 * pad)
        s, ref_start, cigar, mds = _sw.dp_traceback(
            self.scoring, rd, q, window)
        span = sum(n for op, n in cigar if op in ("M", "D"))
        md, nm = samio.make_md(rd, window[ref_start:ref_start + span],
                               cigar)
        return Alignment(
            joined_pos=wstart + ref_start, fw=fw, score=s, cigar=cigar,
            nmm=len(mds),
            gap_opens=sum(1 for op, n in cigar if op in ("I", "D")),
            gap_exts=sum(n - 1 for op, n in cigar if op in ("I", "D")),
            md=md, nm=nm)

    def _adjust_snp_gaps(self, aln: Alignment, rd: np.ndarray) -> None:
        """Un-penalize DP gaps that exactly match a known DEL/INS SNP
        (reference graph extension treats ALT-consistent gaps as free and
        excludes them from NM/XO/XG)."""
        if not self._del_snps and not self._ins_snps:
            return
        sc = self.scoring
        r = aln.joined_pos
        c = 0
        for op, n in aln.cigar:
            if op == "D":
                if (r, n) in self._del_snps:
                    aln.score += (sc.read_gap_open()
                                  + (n - 1) * sc.read_gap_extend())
                    aln.nm -= n
                    aln.gap_opens -= 1
                    aln.gap_exts -= n - 1
                r += n
            elif op == "I":
                ins = self._ins_snps.get(r)
                if ins is not None and ins.size == n and \
                        np.array_equal(rd[c:c + n], ins):
                    aln.score += (sc.ref_gap_open()
                                  + (n - 1) * sc.ref_gap_extend())
                    aln.nm -= n
                    aln.gap_opens -= 1
                    aln.gap_exts -= n - 1
                c += n
            elif op in ("M", "=", "X"):
                r += n
                c += n
            elif op == "S":
                c += n
            elif op == "N":
                r += n

    def _zs_string(self, rd: np.ndarray, pos: int, c5: int, e: int
                   ) -> str | None:
        """Zs:Z tag for SNP-consistent SNV edits in [c5, e) of an ungapped
        placement at `pos` (reference format: comma-separated
        `dist|S|name`, dist = read-offset gap since the previous SNP edit,
        sam.h:999)."""
        if self.snps is None or self.overlay is None:
            return None
        joined = self.fm.ref.joined
        parts = []
        prev = c5 - 1
        lo = int(np.searchsorted(self.snps.jpos, pos + c5))
        hi = int(np.searchsorted(self.snps.jpos, pos + e))
        for si in range(lo, hi):
            if self.snps.types[si] != SNP_SGL:
                continue
            off = int(self.snps.jpos[si]) - pos
            if rd[off] == self.snps.alt_codes[si] \
                    and rd[off] != joined[pos + off]:
                parts.append(f"{off - prev - 1}|S|{self.snps.names[si]}")
                prev = off
        return ",".join(parts) if parts else None

    def _overlay_window(self, pos: int, length: int) -> np.ndarray | None:
        if self.overlay is None:
            return None
        out = np.zeros(length, np.uint8)
        lo, hi = max(0, pos), min(self.overlay.size, pos + length)
        if hi > lo:
            out[lo - pos: hi - pos] = self.overlay[lo:hi]
        return out

    def _try_snp_indels(self, rd, q, pos, rdlen, fw) -> Alignment | None:
        """Zero-cost known-indel application (graph mode): lay the read on
        the haplotype with one DEL/INS SNP applied; SNP-consistent gaps
        cost nothing and are excluded from NM/XO/XG (as hisat2 --snp
        reports them: e.g. 47M2D53M with AS:i:0 NM:i:0)."""
        if self.snps is None:
            return None
        snps = self.snps
        joined = self.fm.ref.joined
        mm_pens = self.scoring.mm_pens()
        lo = int(np.searchsorted(snps.jpos, pos + 1))
        hi = int(np.searchsorted(snps.jpos, pos + rdlen + 32))
        best: Alignment | None = None
        for si in range(lo, hi):
            t = int(snps.types[si])
            if t == SNP_SGL:
                continue
            d = int(snps.lens[si])
            vp = int(snps.jpos[si])
            a = vp - pos
            if a <= 0 or a >= rdlen:
                continue
            if t == SNP_DEL:
                b = rdlen - a
                span = rdlen + d
                if pos + span > joined.size:
                    continue
                hap = np.concatenate([joined[pos:vp],
                                      joined[vp + d:pos + span]])
                ovw = None
                if self.overlay is not None:
                    ovw = np.concatenate([self._overlay_window(pos, a),
                                          self._overlay_window(vp + d, b)])
                cigar = [("M", a), ("D", d), ("M", b)]
            else:
                ins = snps.ins_seqs[si]
                if d != ins.size or a + d >= rdlen:
                    continue
                if not np.array_equal(rd[a:a + d], ins):
                    continue
                b = rdlen - a - d
                span = rdlen - d
                hap = np.concatenate([joined[pos:vp], ins, joined[vp:vp + b]])
                ovw = None
                if self.overlay is not None:
                    o1 = self._overlay_window(pos, a)
                    o2 = self._overlay_window(vp, b)
                    ovw = np.concatenate([o1, np.zeros(d, np.uint8), o2])
                cigar = [("M", a), ("I", d), ("M", b)]
            if hap.size != rdlen:
                continue
            diff = (rd != hap) | (rd >= 4) | (hap >= 4)
            if ovw is not None:
                diff &= ~((ovw == rd + 1) | (ovw == 15))
            score = -int(mm_pens[np.clip(q, 0, 63)][diff].sum())
            if best is not None and score <= best.score:
                continue
            footprint = self.fm.ref.get_stretch(pos, span)
            md, _ = samio.make_md(rd, footprint, cigar)
            best = Alignment(joined_pos=pos, fw=fw, score=score, cigar=cigar,
                             nmm=int(diff.sum()), md=md, nm=int(diff.sum()))
        if best is not None and best.score < self.scoring.min_score(rdlen):
            return None
        return best


def _merged_dict(packed: np.ndarray) -> dict:
    """Host candidate dict from a packed (B, K2, 3) [score, pos, flags]
    grid."""
    return dict(score=packed[:, :, 0].astype(np.int64),
                pos=packed[:, :, 1],
                fw=(packed[:, :, 2] & 1).astype(bool),
                gapped=(packed[:, :, 2] & 2) > 0)


def _to_host_async(tensors: dict):
    """Start device->host copies of `tensors` into pinned buffers.
    Returns (host dict, ready): `ready` is a CUDA event to wait on before
    reading the host tensors, None when they lie on the CPU."""
    if all(t.device.type == "cpu" for t in tensors.values()):
        return dict(tensors), None
    out = {}
    for k, t in tensors.items():
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out[k] = h
    ready = torch.cuda.Event()
    ready.record()
    return out, ready


def _dedup_alns(res: ReadResult, khits: int | None = None) -> None:
    """Redundant-alignment dedup after finalization (reference
    RedundantAlns, hi_aligner.h:6282): alignments of the same orientation
    sharing a read-anchor coordinate (start or end of the aligned span)
    are the same placement. Keeps the best; re-derives best/secbest from
    the survivors."""
    starts = set()
    ends = set()
    out = []
    for a in sorted(res.alns, key=lambda a: -a.score):
        ks = (a.joined_pos, a.fw)
        ke = (a.joined_pos + a.ref_span, a.fw)
        if ks in starts or ke in ends:
            continue
        starts.add(ks)
        ends.add(ke)
        out.append(a)
    res.alns = out
    if out:
        res.best = out[0].score
        res.secbest = out[1].score if len(out) > 1 else None
    if khits is not None:
        res.alns = res.alns[:khits]


def _best_clip(scoring, rd: np.ndarray, q: np.ndarray, window: np.ndarray,
               ovw: np.ndarray | None = None) -> tuple[int, int, int]:
    """Optimal 5'/3' soft-clip lengths for an ungapped placement (host
    mirror of the max-subarray scorer in ops/extend.py; `ovw` is the SNV
    overlay window for graph-mode free alt-allele matches). Returns
    (clip5, clip3, score)."""
    L = rd.size
    mm_pens = scoring.mm_pens()
    scp = scoring.sc_pens()[np.clip(q, 0, 63)].astype(np.int64)
    isn = (rd >= 4) | (window >= 4)
    mm = (rd != window) & ~isn
    if ovw is not None:
        mm &= ~((ovw == rd + 1) | (ovw == 15))
    s = np.where(mm, -mm_pens[np.clip(q, 0, 63)], 0)
    s = np.where(isn, -scoring.n_pen, s)
    s = s + np.where(~mm & ~isn, scoring.match_bonus, 0)
    P = np.concatenate([[0], np.cumsum(s + scp)])
    pref_min = np.minimum.accumulate(P)
    ends = P[1:] - pref_min[:-1]
    # ties broken toward fewer clipped bases
    k = L - 1 - int(np.argmax(ends[::-1]))
    best = int(ends[k])
    if best <= 0:   # fully-clipped degenerate
        return 0, 0, int(s.sum())
    start = int(np.argmin(P[:k + 1]))
    score = best - int(scp.sum())
    return start, L - (k + 1), score


# ---------------------------------------------------------------------------
# SAM emission (single-end, per-read path)
# ---------------------------------------------------------------------------

def _tmo_pass(aligner: Aligner, aln: Alignment) -> bool:
    """--tmo acceptance for one alignment (reference hi_aligner.h:6126):
    report only alignments spliced entirely through KNOWN splice sites.
    With the reference's default avoid_pseudogene=false, an unspliced
    alignment never sets spliced_to_known (hi_aligner.h:1084-1095), so it
    is always rejected under --tmo."""
    known = aligner.ssdb.known
    spliced = False
    pos = int(aln.joined_pos)
    t = 0
    for op, n in aln.cigar:
        if op == "N":
            spliced = True
            # junction coords: (last base of left exon, first base of
            # right exon) — the add_novel/add_known convention
            if (pos + t - 1, pos + t + n) not in known:
                return False
        if op in ("M", "D", "N", "=", "X"):
            t += n
    return spliced


def tmo_filter_result(aligner: Aligner, res: ReadResult) -> ReadResult:
    """Drop --tmo-failing alignments from a ReadResult; best/secbest
    re-derive from the survivors (the reference gates before AlnRes
    creation, so rejected candidates never feed MAPQ)."""
    if not res.alns:
        return res
    alns = [a for a in res.alns if _tmo_pass(aligner, a)]
    if len(alns) == len(res.alns):
        return res
    out = ReadResult(alns=alns, filtered=res.filtered)
    if alns:
        out.best = alns[0].score
        out.secbest = alns[1].score if len(alns) > 1 else None
    return out


def results_to_sam(batch: ReadBatch, results: list[ReadResult],
                   aligner: Aligner, writer: samio.SamWriter) -> dict:
    """Emit SAM lines for a single-end batch of ReadResults; returns the
    summary counts."""
    sc = aligner.scoring
    ref = aligner.fm.ref
    stats = dict(reads=0, unal=0, uniq=0, multi=0)
    for i, res in enumerate(results):
        stats["reads"] += 1
        if aligner.opts.tmo:
            res = tmo_filter_result(aligner, res)
        name = batch.names[i]
        rdlen = int(batch.lens[i])
        seq = batch.seqs[i, :rdlen]
        qual = (batch.quals[i, :rdlen].astype(np.uint8) + 33
                ).tobytes().decode("ascii")
        if not res.aligned:
            stats["unal"] += 1
            writer.emit(int(batch.rdids[i]), [samio.format_unaligned(
                name, seq, qual, yf=res.filtered)])
            continue
        if len(res.alns) > 1 or (res.secbest is not None
                                 and res.secbest >= sc.min_score(rdlen)):
            stats["multi"] += 1
        else:
            stats["uniq"] += 1
        mq = _mapq.mapq_v2(res.best, res.secbest, sc.perfect_score(rdlen),
                           sc.min_score(rdlen), local=sc.local)
        lines = []
        nh = len(res.alns)
        for k, aln in enumerate(res.alns):
            rec = samio.SamAlignment(
                rname=aln.rname_override or ref.names[aln.tidx],
                pos=aln.toff, fw=aln.fw,
                mapq=mq if k == 0 else 255, cigar=aln.cigar, score=aln.score,
                nmm=aln.nmm, gap_opens=aln.gap_opens, gap_exts=aln.gap_exts,
                md=aln.md, nm=aln.nm,
                zs=res.secbest if res.secbest is not None else None,
                xs_strand=aln.xs_strand, zs_snps=aln.zs_snps,
                nh=aln.nh_override or nh, secondary=k > 0)
            lines.append(samio.format_aligned(name, seq, qual, rec))
        writer.emit(int(batch.rdids[i]), lines)
    return stats
