"""Batched seeding: FM backward search and the direct-address k-mer table.

Port of hisat2_tpu/ops/search.py. The FM functions fill the role of the
reference's HI_Aligner::partialSearch (hi_aligner.h:6361-6420): every read
walks right-to-left through the index by LF steps, all reads advancing in
lockstep as a masked wavefront of (B,) tensors, dead lanes riding along;
one Python loop over read positions, no device-to-host sync inside it.
  exact_interval  the SA interval of each whole read
  partial_search  maximal exact-match segments that partition the read
                  (BWTHit, hi_aligner.h:107), up to max_hits a read
  seed_search     fixed 22 bp stride seeds: one ftab gather resolves a
                  seed's last ftab_k characters, 22 - ftab_k LF rounds
                  the rest (the reference's multiseed policy)
table_lookup replaces the LF chain and the SA walk with TWO dependent
gather rounds: bucket bounds at the seed's k-mer code, then one
contiguous slice of sorted positions per seed. Its two modes for
Gbp-scale shards are here too: stride-sampled tables (only positions
% st_stride == 0 stored; seed offsets jitter over the residues) and, for
bucket loads above 3, pairs of consecutive k-mers whose position lists
intersect on one diagonal.
"""

from __future__ import annotations

import torch

from . import rank as _rank
from .rank import gather_slices

I32 = torch.int32
MAX_HITS = 16  # per-read segment buffer (100bp reads rarely exceed ~6)


def exact_interval(idx: dict, seqs: torch.Tensor, lens: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """SA interval of each full read (exact match), batched.

    seqs: (B, L) codes 0..4 (N kills the interval); lens: (B,).
    Returns (top, bot) int32 (B,); empty match iff bot <= top."""
    B, L = seqs.shape
    dev = seqs.device
    seqs = seqs.to(I32)
    lens = lens.to(I32)
    top = torch.zeros(B, dtype=I32, device=dev)
    bot = torch.full((B,), idx["m"], dtype=I32, device=dev)
    for j in range(L):
        pos = lens - 1 - j
        active = (lens > j) & (bot > top)
        c = torch.gather(seqs, 1, pos.clamp(0, L - 1).long()[:, None])[:, 0]
        ntop, nbot = _rank.lf_step_interval(idx, top, bot, c.clamp(max=3))
        dead = c >= 4
        ntop = torch.where(dead, 1, ntop)
        nbot = torch.where(dead, 0, nbot)
        top = torch.where(active, ntop, top)
        bot = torch.where(active, nbot, bot)
    return top, bot


def partial_search(idx: dict, seqs: torch.Tensor, lens: torch.Tensor,
                   max_hits: int = MAX_HITS) -> dict:
    """Batched maximal-segment search. seqs (B, L), lens (B,).

    Returns dict of (B, max_hits) int32 tensors top/bot (the SA interval
    of each segment's full match), off (its leftmost read offset), len,
    and n (B,): the segments found, which may exceed max_hits (the later
    ones are then not stored). Segments partition [0, length)
    right-to-left, skipping N positions, mirroring ReadBWTHit
    (hi_aligner.h:215): on an extension failure the failing base starts
    the next segment."""
    B, L = seqs.shape
    dev = seqs.device
    m = idx["m"]
    ccount = idx["ccount"]
    seqs = seqs.to(I32)
    lens = lens.to(I32)
    # one spare column takes the writes of lanes that record nothing
    bufs = [torch.zeros((B, max_hits + 1), dtype=I32, device=dev)
            for _ in range(4)]

    def record(nh, top, bot, pos, end, do):
        """Store segment [pos+1, end] with interval [top, bot) where do."""
        slot = torch.where(do, nh.clamp(max=max_hits), max_hits)
        for buf, v in zip(bufs, (top, bot, pos + 1, end - pos)):
            buf.scatter_(1, slot.long()[:, None], v[:, None])
        return nh + do.to(I32)

    top = torch.zeros(B, dtype=I32, device=dev)
    bot = torch.full((B,), m, dtype=I32, device=dev)
    end = lens - 1
    nh = torch.zeros(B, dtype=I32, device=dev)
    for j in range(L):
        pos = lens - 1 - j
        active = lens > j
        c = torch.gather(seqs, 1, pos.clamp(0, L - 1).long()[:, None])[:, 0]
        isn = c >= 4
        cc = c.clamp(max=3)
        ntop, nbot = _rank.lf_step_interval(idx, top, bot, cc)
        fail = isn | (nbot <= ntop)
        have = end > pos  # current segment is non-empty
        nh = record(nh, top, bot, pos, end, active & fail & have)
        # restart: non-N failing base is consumed against the full interval
        rtop = torch.where(isn, 0, ccount[cc.long()])
        rbot = torch.where(isn, m, ccount[cc.long() + 1])
        top2 = torch.where(fail, rtop, ntop)
        bot2 = torch.where(fail, rbot, nbot)
        end2 = torch.where(fail, torch.where(isn, pos - 1, pos), end)
        # pathological: base absent from genome entirely
        gone = bot2 <= top2
        top2 = torch.where(gone, 0, top2)
        bot2 = torch.where(gone, m, bot2)
        end2 = torch.where(gone, pos - 1, end2)
        top = torch.where(active, top2, top)
        bot = torch.where(active, bot2, bot)
        end = torch.where(active, end2, end)
    # final segment covers [0, end]
    nh = record(nh, top, bot, torch.full_like(end, -1), end,
                (end >= 0) & (bot > top))
    h_top, h_bot, h_off, h_len = (b[:, :max_hits] for b in bufs)
    return dict(top=h_top, bot=h_bot, off=h_off, len=h_len, n=nh)


def seed_search(idx: dict, seqs: torch.Tensor, lens: torch.Tensor,
                seed_len: int = 22, n_seeds: int = 8,
                ftab_k: int = 10) -> dict:
    """Fixed-length stride-seed search (the reference's *multiseed* policy,
    SEED=0,22 IVAL presets, against partial_search's maximal segments).

    Every (read, seed) lane is independent: the ftab resolves a seed's
    LAST ftab_k characters in one gather (backward search starts from the
    pattern's suffix), and seed_len - ftab_k LF rounds extend it.

    seqs (B, L) codes, lens (B,). Returns dict of (B, n_seeds) int32
    tensors top/bot/off/len + n (B,), the contract of partial_search, so
    the candidate stage is agnostic to the seeder. A seed holding an N,
    and every seed of a read shorter than seed_len, comes back dead
    (top 1, bot 0, len 0)."""
    B, L = seqs.shape
    dev = seqs.device
    k = ftab_k
    seqs = seqs.to(I32)
    lens = lens.to(I32)

    # seed offsets: evenly spread over [0, len - seed_len]
    s_ix = torch.arange(n_seeds, dtype=I32, device=dev)
    span = (lens - seed_len).clamp(min=0)
    if n_seeds > 1:
        offs = torch.div(s_ix[None, :] * span[:, None], n_seeds - 1,
                         rounding_mode="floor")
    else:
        offs = torch.zeros((B, n_seeds), dtype=I32, device=dev)
    usable = (lens >= seed_len)[:, None]   # every slot once the read fits

    # gather the seed characters: (B, S, seed_len)
    pos = offs[:, :, None] + torch.arange(seed_len, dtype=I32, device=dev)
    ch = torch.gather(seqs[:, None, :].expand(B, n_seeds, L), 2,
                      pos.clamp(0, L - 1).long())
    has_n = (ch >= 4).any(dim=2)
    ch = ch.clamp(max=3)

    # ftab jump on the seed's last k characters, big-endian
    weights = 4 ** torch.arange(k - 1, -1, -1, dtype=I32, device=dev)
    code = (ch[:, :, seed_len - k:] * weights).sum(dim=2)
    tb = idx["ftab"][code.long()]                                # (B, S, 2)
    top, bot = tb[..., 0], tb[..., 1]
    for j in range(seed_len - k):
        c = ch[:, :, seed_len - k - 1 - j]
        ntop, nbot = _rank.lf_step_interval(idx, top, bot, c)
        alive = bot > top
        top = torch.where(alive, ntop, top)
        bot = torch.where(alive, nbot, bot)
    dead = has_n | ~usable
    return dict(top=torch.where(dead, 1, top), bot=torch.where(dead, 0, bot),
                off=offs,
                len=torch.where(dead, 0, seed_len).to(I32),
                n=torch.full((B,), n_seeds, dtype=I32, device=dev))


def table_lookup(idx: dict, seqs: torch.Tensor, lens: torch.Tensor,
                 n_seeds: int = 8, locs_per_seg: int = 8,
                 stride: int = 0) -> dict:
    """Seed every row of seqs (R, L) codes 0..4 with n_seeds k-mers.

    stride > 0: fixed-stride offsets (0, stride, 2*stride, ...) for the
    dense/sensitive pass; stride == 0: n_seeds offsets spread evenly over
    [0, len - kt]. The table's own sampling stride (idx["st_stride"]) and
    its bucket load pick the mode (see the module docstring).

    Returns dict: locs (R, S, locs_per_seg) int32 kmer-start positions,
    lvalid (same shape) bool, off (R, S) int32 read offsets, and
    exhausted (R,) bool — True when no bucket overflowed locs_per_seg.
    """
    R, L = seqs.shape
    dev = seqs.device
    kt = idx["st_k"]
    nbuckets0 = idx["st_starts"].shape[0] - 1
    # bucket load decides the mode: Gbp-scale shards overflow kt <= 13
    # buckets (load ~n/4^kt), so seeds become TWO consecutive kt-mers whose
    # position lists intersect on the same diagonal
    pair_mode = idx["st_pos_rows"].numel() / max(nbuckets0, 1) > 3.0
    # stride-sampled table: only positions % St == 0 are stored, so seed
    # offsets jitter over the residues; a read on diagonal d finds seed o
    # iff (d + o) % St == 0
    St = idx.get("st_stride", 1)
    kt2 = kt if St == 1 else -(-kt // St) * St   # 2nd k-mer offset, % St == 0
    lens = lens.to(torch.int32)
    c = seqs.to(torch.int32).clamp(max=3)
    isn = seqs >= 4
    # rolling kt-mer codes for every read offset, with an N-in-window flag
    # riding bit 28 (codes < 4^13 = 2^26)
    NB = 1 << 28
    codes = torch.zeros((R, L), dtype=torch.int32, device=dev)
    nn = torch.zeros((R, L), dtype=torch.bool, device=dev)
    for j in range(kt):
        codes[:, :L - j] += c[:, j:] * (4 ** (kt - 1 - j))
        nn[:, :L - j] |= isn[:, j:]
    codes += nn.to(torch.int32) * NB
    span = (lens - (kt + kt2 if pair_mode else kt)).clamp(min=0)
    s_ix = torch.arange(n_seeds, dtype=torch.int32, device=dev)
    if stride > 0:
        offs = torch.minimum(s_ix[None, :] * stride, span[:, None])
    else:
        offs = torch.div(s_ix[None, :] * span[:, None], max(n_seeds - 1, 1),
                         rounding_mode="floor")
    if St > 1:
        # force o_k = k (mod St): any St consecutive seeds then cover every
        # residue. torch.remainder, like the JAX %, is non-negative here
        offs = torch.minimum(
            offs + torch.remainder(s_ix[None, :] - offs, St), span[:, None])
    csel = torch.gather(codes, 1, offs.long())               # (R, S)
    n_sel = csel >= NB
    code_sel = (csel & (NB - 1)).long()
    if "st_pairs" in idx:
        # (4^kt, 2) [start, end] rows: one row gather for both bounds
        s01 = idx["st_pairs"][code_sel]                      # (R, S, 2)
        s0, s1 = s01[..., 0], s01[..., 1]
    else:
        s0 = idx["st_starts"][code_sel]
        s1 = idx["st_starts"][code_sel + 1]
    cnt = s1 - s0

    if pair_mode:
        SLOT = min(48, idx["st_pos_rows"].shape[1] * 2 - 31)
        usable = (lens >= kt + kt2)[:, None] & ~n_sel
        csel2 = torch.gather(codes, 1, (offs + kt2).clamp(max=L - 1).long())
        code2 = (csel2 & (NB - 1)).long()
        usable &= ~(csel2 >= NB) & (offs + kt + kt2 <= lens[:, None])
        if "st_pairs" in idx:
            t01 = idx["st_pairs"][code2]
            t0, t1 = t01[..., 0], t01[..., 1]
        else:
            t0 = idx["st_starts"][code2]
            t1 = idx["st_starts"][code2 + 1]
        cntB = t1 - t0
        A = gather_slices(idx["st_pos_rows"], s0, SLOT)       # (R, S, SLOT)
        Bp = gather_slices(idx["st_pos_rows"], t0, SLOT) - kt2
        ia = torch.arange(SLOT, dtype=torch.int32, device=dev)
        va = ia < cnt[..., None]
        vb = ia < cntB[..., None]
        hit = ((A[..., :, None] == Bp[..., None, :])
               & va[..., :, None] & vb[..., None, :]).any(dim=-1)
        # keys are distinct slot indices or the sentinel, so the order of
        # equal keys (sentinels only) does not matter
        sel = torch.sort(torch.where(hit, ia, 1 << 20),
                         dim=-1).values[..., :locs_per_seg]
        lvalid = (sel < (1 << 20)) & usable[..., None]
        locs = torch.gather(A, -1, sel.clamp(max=SLOT - 1).long())
        exhausted = torch.where(usable, (cnt <= SLOT) & (cntB <= SLOT),
                                torch.ones_like(usable)).all(dim=1)
        return dict(locs=locs, lvalid=lvalid, off=offs, exhausted=exhausted)

    usable = (lens >= kt)[:, None] & ~n_sel
    locs = gather_slices(idx["st_pos_rows"], s0, locs_per_seg)
    lvalid = ((torch.arange(locs_per_seg, dtype=torch.int32,
                            device=dev)[None, None, :] < cnt[..., None])
              & usable[..., None])
    exhausted = torch.where(usable, cnt <= locs_per_seg,
                            torch.ones_like(usable)).all(dim=1)
    return dict(locs=locs, lvalid=lvalid, off=offs, exhausted=exhausted)
