"""Batched ungapped candidate verification/scoring.

Port of hisat2_tpu/ops/extend.verify_ungapped (the reference's
GenomeHit::extend, hi_aligner.h:431): score each read laid directly on
the text at each candidate — match bonus / qual-scaled mismatch / N
penalty — with optimal soft clips found as a max-subarray, and reject
candidates that cross a fragment boundary (joinedToTextOff validity,
gfm.h:5527). On a graph index a mismatch whose read base is a known alt
allele of the SNV overlay is a free SNP edit.
"""

from __future__ import annotations

import torch

from . import rank as _rank
from ..align.scoring import mm_pen_of, sc_pen_of

NEG_INF = -(1 << 30)  # plain int: usable both in tensor ops and host code


def verify_ungapped(idx: dict, sctab: dict, seqs: torch.Tensor,
                    quals: torch.Tensor, lens: torch.Tensor,
                    cand_pos: torch.Tensor, cand_valid: torch.Tensor) -> dict:
    """seqs (B, L) codes 0..4; quals (B, L) phred; lens (B,);
    cand_pos (B, K) joined-text start offsets; cand_valid (B, K) bool.

    Returns dict of (B, K) tensors: score int32 (NEG_INF if invalid), nmm
    and nns int32 (mismatch and N counts), valid bool.
    """
    B, L = seqs.shape
    K = cand_pos.shape[1]
    seqs = seqs.to(torch.int32)
    lens = lens.to(torch.int32)

    fj = idx["frag_joined"]
    frag = (_rank.searchsorted_right(fj, cand_pos) - 1).long()
    frag = frag.clamp(0, fj.shape[0] - 1)
    inb = ((cand_pos >= fj[frag])
           & (cand_pos + lens[:, None] <= idx["frag_end"][frag]))
    valid = cand_valid & inb & (cand_pos >= 0)

    ref = _rank.text_window(idx, cand_pos.reshape(-1), L).reshape(B, K, L)
    rd = seqs[:, None, :]                                  # (B, 1, L)
    q = quals.to(torch.int32).clamp(0, 63)[:, None, :]
    in_read = (torch.arange(L, dtype=torch.int32, device=seqs.device)
               [None, None, :] < lens[:, None, None])
    rd_n = rd >= 4
    rf_n = ref >= 4
    isn = (rd_n | rf_n) & in_read
    mm = (rd != ref) & ~rd_n & ~rf_n & in_read
    mtch = (rd == ref) & ~rd_n & in_read
    if "snv_packed" in idx:
        # graph mode: ALT-compatible bases cost nothing and are excluded
        # from NM/XM (the reference's graph alignment)
        ov = _rank.nib4_window(idx, cand_pos.reshape(-1), L).reshape(B, K, L)
        snp_free = mm & ((ov == rd + 1) | (ov == 15))
        mm = mm & ~snp_free
        mtch = mtch | snp_free

    zero = torch.zeros((), dtype=torch.int32, device=seqs.device)
    s = (torch.where(mtch, sctab["match_bonus"], zero)
         - torch.where(mm, mm_pen_of(sctab, q), zero)
         - torch.where(isn, sctab["n_pen"], zero))          # (B, K, L)
    # score = max_{c5,c3} sum_{i in [c5, len-c3)} s(i) - sum_clipped scp(i)
    # = max-subarray of g(i) = s(i) + scp(i), minus the total clip penalty
    scp = torch.where(in_read, sc_pen_of(sctab, q), zero)
    g = s + scp
    P = torch.cumsum(g, dim=2, dtype=torch.int32)
    minP = torch.cummin(P, dim=2).values.clamp(max=0)
    prev = torch.cat([torch.zeros_like(minP[..., :1]), minP[..., :-1]], dim=2)
    best_sub = (P - prev).amax(dim=2).clamp(min=0)
    score = best_sub - scp.sum(dim=2, dtype=torch.int32)
    return dict(
        score=torch.where(valid, score, NEG_INF),
        nmm=mm.sum(dim=2, dtype=torch.int32),
        nns=isn.sum(dim=2, dtype=torch.int32),
        valid=valid,
    )
