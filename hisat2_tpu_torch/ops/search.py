"""Seeding through the direct-address k-mer table (index/seed_table.py).

Port of hisat2_tpu/ops/search.table_lookup: it replaces the reference's
partialSearch + GroupWalk chain (hi_aligner.h:6361, group_walk.h:1411)
with TWO dependent gather rounds — bucket bounds at the seed's k-mer code,
then one contiguous slice of sorted positions per seed.

Only the plain table is ported. The paired-k-mer intersect mode and
stride-sampled tables arise for Gbp-scale shards and raise
NotImplementedError here.
"""

from __future__ import annotations

import torch

from .rank import gather_slices


def table_lookup(idx: dict, seqs: torch.Tensor, lens: torch.Tensor,
                 n_seeds: int = 8, locs_per_seg: int = 8,
                 stride: int = 0) -> dict:
    """Seed every row of seqs (R, L) codes 0..4 with n_seeds k-mers.

    stride > 0: fixed-stride offsets (0, stride, 2*stride, ...) for the
    dense/sensitive pass; stride == 0: n_seeds offsets spread evenly over
    [0, len - kt].

    Returns dict: locs (R, S, locs_per_seg) int32 kmer-start positions,
    lvalid (same shape) bool, off (R, S) int32 read offsets, and
    exhausted (R,) bool — True when no bucket overflowed locs_per_seg.
    """
    R, L = seqs.shape
    dev = seqs.device
    kt = idx["st_k"]
    nbuckets0 = idx["st_starts"].shape[0] - 1
    if idx["st_pos_rows"].numel() / max(nbuckets0, 1) > 3.0:
        raise NotImplementedError("paired-k-mer seed tables are not ported")
    if idx.get("st_stride", 1) > 1:
        raise NotImplementedError("stride-sampled seed tables are not ported")
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
    span = (lens - kt).clamp(min=0)
    s_ix = torch.arange(n_seeds, dtype=torch.int32, device=dev)
    if stride > 0:
        offs = torch.minimum(s_ix[None, :] * stride, span[:, None])
    else:
        offs = torch.div(s_ix[None, :] * span[:, None], max(n_seeds - 1, 1),
                         rounding_mode="floor")
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
    usable = (lens >= kt)[:, None] & ~n_sel
    locs = gather_slices(idx["st_pos_rows"], s0, locs_per_seg)
    lvalid = ((torch.arange(locs_per_seg, dtype=torch.int32,
                            device=dev)[None, None, :] < cnt[..., None])
              & usable[..., None])
    exhausted = torch.where(usable, cnt <= locs_per_seg,
                            torch.ones_like(usable)).all(dim=1)
    return dict(locs=locs, lvalid=lvalid, off=offs, exhausted=exhausted)
