"""Single-end DNA alignment pipeline (PyTorch port of hisat2_tpu's).

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
from ..ops import sw as _sw
from ..ops.dp_cuda import dp_score
from ..ops.extend import NEG_INF
from ..utils import alphabet
from ..utils.metrics import Metrics
from . import mapq as _mapq
from .scoring import DEFAULT_SCORING, Scoring, mm_pen_of, sc_pen_of

I32 = torch.int32
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
    # not ported yet: each raises NotImplementedError when set
    spliced: bool = False          # spliced (RNA) alignment
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
                        VC: int = 0):
    """SE path with transfer-packed I/O: unpack 2-bit reads, run the
    core, and compress results to the int16 fastpack. Returns
    (fastpack (B, W) int16, merged (B, K2, 3) int32); with SB > 0 or
    tier buckets also an extras dict: srows (SB,) int32 and smerged
    (SB, K2, 2) — the packed merged grids of the reads the host fast path
    will reject — plus the tier buckets."""
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
    if SB == 0 and not bex:
        return fastpack, merged
    extras = dict(bex)
    if SB:
        sv, sr = _topk01(need, min(SB, B))
        extras["srows"] = torch.where(sv > 0, sr, -1)
        # packed grid rows: [pos, score<<8 | flags] — the host unpacks
        # (emit._unpack_smerged); scores below -2^22 all mean "dead
        # candidate" so the clamp loses nothing
        sm = merged[sr.clamp(0, B - 1).long()]
        scpk = sm[:, :, 0].clamp(min=-(1 << 22))
        extras["smerged"] = torch.stack(
            [sm[:, :, 1], (scpk << 8) | (sm[:, :, 2] & 0xFF)], dim=2)
    return fastpack, merged, extras


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

class Aligner:
    """Batched DNA aligner over a built FM index. An index with a k-mer
    seed table seeds from the table; one without seeds by FM backward
    search (full or sampled SA). `device` holds the index bundle and runs
    the batched stages ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, fm: FMIndex, scoring: Scoring = DEFAULT_SCORING,
                 opts: AlignerOpts | None = None, device="cuda"):
        self.fm = fm
        self.scoring = scoring
        self.opts = opts or AlignerOpts()
        o = self.opts
        for flag, what in ((o.spliced, "spliced alignment"),
                           (o.tmo, "--tmo"), (scoring.local, "local mode")):
            if flag:
                raise NotImplementedError(f"{what} is not ported")
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
        # reference _minK: minimum anchor = ceil(log4 |genome|), >= 8
        self.min_seg_len = max(8, int(np.ceil(np.log(max(fm.n, 4))
                                              / np.log(4))))
        self.sctab = scoring.device_tables(self.device)
        self.sc_const = scoring.dp_consts()
        self.metrics = Metrics()
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
            self.sc_const, khits=o.khits, SB=min(B, max(64, B // 16)),
            omit_sec=o.omit_sec_seq, MB=min(B, max(32, B // 16)),
            VC=o.verify_cands)
        host, ready = _to_host_async({"fp": fp, **extras})
        m.t_pack += time.perf_counter() - t0
        return host.pop("fp"), merged, host, ready

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
        return self._finalize_results(batch, merged)

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
            alns = self._finalize_ungapped_list(
                batch, rows, mpos[rows, 0], mfw[rows, 0], lens[rows])
            fin = {int(rows[r]): a for r, a in enumerate(alns)
                   if a is not None}
        todo = range(B) if only_rows is None else [int(i) for i in only_rows]
        out = {i: self._finalize_one(batch, merged, i, filtered, aligned,
                                     has_sec, nvalid, lens, min_scs, msc,
                                     mpos, mfw, mgap, fin) for i in todo}
        return out if only_rows is not None else [out[i] for i in range(B)]

    def _finalize_one(self, batch, merged, i, filtered, aligned, has_sec,
                      nvalid, lens, min_scs, msc, mpos, mfw, mgap, fin
                      ) -> ReadResult:
        """One read's host finalization."""
        if filtered[i]:
            return ReadResult(filtered=_filter_reason(batch, i, lens))
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

def results_to_sam(batch: ReadBatch, results: list[ReadResult],
                   aligner: Aligner, writer: samio.SamWriter) -> dict:
    """Emit SAM lines for a single-end batch of ReadResults; returns the
    summary counts."""
    sc = aligner.scoring
    ref = aligner.fm.ref
    stats = dict(reads=0, unal=0, uniq=0, multi=0)
    for i, res in enumerate(results):
        stats["reads"] += 1
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
