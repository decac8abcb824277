"""Batched affine-gap alignment DP: the plain PyTorch fill and the host
traceback.

Port of hisat2_tpu/ops/sw.py (the reference's SSE striped Smith-Waterman,
aligner_sw.{h,cpp}). The batch axis (candidates) is the vector axis and
the DP is a loop over read positions; the within-row read-gap dependency
closes in O(W) with a running max:

    E[i][j] = max_{k<j} ( G[i][k] - open - (j-1-k)*ext )
            = cummax_k ( G[i][k] + ext*k ) - open - ext*(j-1)

Mode: global in the read (end-to-end, reference default) with qual-scaled
soft clips, free end gaps in the reference window. `dp_fill_plain` is the
plain version of the CUDA kernel in ops/dp_cuda.py: it takes the kernel's
inputs, serves CPU tensors, and is the kernel's oracle on the card. Exact
traceback for the few winning candidates runs on the host through the
native dpkernel.cpp (dp_traceback).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG = -(1 << 28)


def dp_fill_plain(rd: torch.Tensor, pen: torch.Tensor, rdlens: torch.Tensor,
                  ref: torch.Tensor, scp_cum: torch.Tensor, *,
                  match_bonus: int, n_pen: int, rd_open: int, rd_ext: int,
                  rf_open: int, rf_ext: int,
                  ov: torch.Tensor | None = None) -> torch.Tensor:
    """Score-only DP, one score per candidate.

    rd (C, L) codes 0..4; pen (C, L) per-position mismatch penalties;
    rdlens (C,); ref (C, W) codes 0..4 (N-padded outside the real
    window); scp_cum (C, L+1) cumulative soft-clip penalties
    (scp_cum[:, i] = clip cost of rd[0:i)). A 5' clip of i bases enters as
    a floor of -scp_cum[:, i] on row i; a 3' clip after row i costs the
    rest of the read's clip penalty; rows past a read's length are frozen.
    `ov` (C, W), the SNV-overlay nibble at each window base (graph
    indexes: 0 none, 1..4 alt code + 1, 15 several alts): a cell whose
    read and window bases are both real and differ scores match_bonus
    where ov == read base + 1 or ov == 15; an N on either side keeps
    -n_pen. Returns (C,) int32.
    """
    C, L = rd.shape
    W = ref.shape[1]
    dev = rd.device
    i32 = torch.int32
    rd = rd.to(i32)
    pen = pen.to(i32)
    ref = ref.to(i32)
    scp_cum = scp_cum.to(i32)
    rdlens = rdlens.to(i32)
    jcols = torch.arange(W + 1, dtype=i32, device=dev)
    ecost = rd_open + rd_ext * (jcols[1:] - 1)
    scp_tot = scp_cum[:, L]
    H = torch.zeros((C, W + 1), dtype=i32, device=dev)     # free leading gap
    F = torch.full((C, W + 1), NEG, dtype=i32, device=dev)
    best = -scp_tot                                         # fully clipped
    ref_n = ref >= 4
    n_sub = torch.tensor(-n_pen, dtype=i32, device=dev)
    m_sub = torch.tensor(match_bonus, dtype=i32, device=dev)
    if ov is not None:
        ov = ov.to(i32)
        ov_any = ov == 15
    for i in range(L):
        rc = rd[:, i:i + 1]
        isn = (rc >= 4) | ref_n
        mm = (rc != ref) & ~isn
        if ov is not None:
            mm = mm & ~((ov == rc + 1) | ov_any)
        s = torch.where(mm, -pen[:, i:i + 1], torch.where(isn, n_sub, m_sub))
        col0 = torch.full((C, 1), -(rf_open + i * rf_ext), dtype=i32,
                          device=dev)
        Fn_tail = torch.maximum(H[:, 1:] - rf_open, F[:, 1:] - rf_ext)
        G = torch.cat([col0, torch.maximum(H[:, :-1] + s, Fn_tail)], dim=1)
        M = torch.cummax(G + rd_ext * jcols, dim=1).values
        E_tail = M[:, :-1] - ecost
        Hn = torch.cat([col0, torch.maximum(G[:, 1:], E_tail)], dim=1)
        # 5' soft clip: restart after clipping read[0:i+1]
        clip5 = scp_cum[:, i + 1:i + 2]
        Hn = torch.maximum(Hn, -clip5)
        Fn = torch.cat([col0, Fn_tail], dim=1)
        act = (i < rdlens)[:, None]
        H = torch.where(act, Hn, H)
        F = torch.where(act, Fn, F)
        # 3' soft clip: end the alignment at read position i+1
        best = torch.maximum(best, H.amax(dim=1) - (scp_tot - clip5[:, 0]))
    return torch.maximum(best, H.amax(dim=1))


def dp_inputs(sctab: dict, quals: torch.Tensor, rdlens: torch.Tensor):
    """(pen, scp_cum) for the DP from per-position qualities, as the
    fused SE step builds them: qual-scaled mismatch penalties, and the
    cumulative clip penalty of the in-read prefix."""
    from ..align.scoring import mm_pen_of, sc_pen_of
    C, L = quals.shape
    qc = quals.to(torch.int32).clamp(0, 63)
    in_read = (torch.arange(L, dtype=torch.int32, device=quals.device)
               [None, :] < rdlens.to(torch.int32)[:, None])
    pen = mm_pen_of(sctab, qc)
    scp = torch.where(in_read, sc_pen_of(sctab, qc), 0)
    scp_cum = torch.cat([torch.zeros((C, 1), dtype=torch.int32,
                                     device=quals.device),
                         torch.cumsum(scp, dim=1, dtype=torch.int32)], dim=1)
    return pen, scp_cum


def dp_score_batch(sctab: dict, rd: torch.Tensor, quals: torch.Tensor,
                   rdlens: torch.Tensor, ref: torch.Tensor,
                   ov: torch.Tensor | None = None) -> torch.Tensor:
    """Affine-gap DP score with soft clips, batched over candidates:
    rd (C, L) codes 0..4, quals (C, L), rdlens (C,), ref (C, W).
    ov (C, W) optional SNV-overlay nibbles. Returns score (C,) int32."""
    pen, scp_cum = dp_inputs(sctab, quals, rdlens)
    return dp_fill_plain(
        rd, pen, rdlens, ref, scp_cum, match_bonus=int(sctab["match_bonus"]),
        n_pen=int(sctab["n_pen"]), rd_open=int(sctab["rd_open"]),
        rd_ext=int(sctab["rd_ext"]), rf_open=int(sctab["rf_open"]),
        rf_ext=int(sctab["rf_ext"]), ov=ov)


def ungapped_place_batch(sctab: dict, rd: torch.Tensor, quals: torch.Tensor,
                         rdlens: torch.Tensor, ref: torch.Tensor):
    """Best ungapped (single-diagonal) placement per lane.

    Scores every diagonal placement of the read in its window with the
    same substitution/soft-clip model as dp_fill_plain: per diagonal the
    best clip pair is a max-subarray over A[i] = SCP(i) + cumsum(sub).
    Where the returned best equals the affine DP score, the optimum is
    ungapped and no host traceback is needed.

    rd (C, L) codes 0..4, quals (C, L), rdlens (C,), ref (C, W).
    Returns (best, t0, i1, i2) each (C,) int32: score, window offset of
    read position 0 (may be negative: clipped ends can overhang), and the
    aligned read span [i1, i2).
    """
    from ..align.scoring import mm_pen_of, sc_pen_of
    C, L = rd.shape
    W = ref.shape[1]
    T = W + L + 1
    dev = rd.device
    i32 = torch.int32
    BAD = -(10 ** 6)
    rd = rd.to(i32)
    q = quals.to(i32).clamp(0, 63)
    rdlens = rdlens.to(i32)
    in_read = (torch.arange(L, dtype=i32, device=dev)[None, :]
               < rdlens[:, None])
    pens = mm_pen_of(sctab, q)
    scp = torch.where(in_read, sc_pen_of(sctab, q), 0)
    scp_total = scp.sum(dim=1, dtype=i32)
    # sentinel (code 5) pad: L columns each side so overhanging clipped
    # ends stay representable without any aligned base landing outside
    wp = torch.full((C, W + 2 * L), 5, dtype=i32, device=dev)
    wp[:, L:L + W] = ref.to(i32)

    # streaming Kadane over read positions: per (lane, diagonal) the
    # prefix sum A, its running first minimum (value and index), and the
    # best gain A[i2] - min_{j<i2} A[j]. Strict comparisons keep the first
    # maximum and the first minimum.
    A = torch.zeros((C, T), dtype=i32, device=dev)
    runmin = A
    rm_idx = torch.zeros((C, T), dtype=i32, device=dev)
    best = torch.full((C, T), -(1 << 30), dtype=i32, device=dev)
    b_i1 = torch.zeros((C, T), dtype=i32, device=dev)
    b_i2 = torch.ones((C, T), dtype=i32, device=dev)
    rdn = rd >= 4
    mbonus = sctab["match_bonus"]
    npen = sctab["n_pen"]
    for i in range(L):
        sv = wp[:, i:i + T]
        mm = sv != rd[:, i:i + 1]
        isn = (sv >= 4) | rdn[:, i:i + 1]
        sub = torch.where(mm & ~isn, -pens[:, i:i + 1], 0)
        sub = sub + torch.where(~mm & ~isn, mbonus, 0)
        sub = torch.where(isn, -npen, sub)
        sub = torch.where(sv == 5, BAD, sub)
        sub = torch.where(in_read[:, i:i + 1], sub, BAD)
        A2 = A + sub + scp[:, i:i + 1]         # A[i+1] = A[i] + sub + scp
        cand = A2 - runmin
        upd = cand > best                      # strict: first max wins
        best = torch.where(upd, cand, best)
        b_i2 = torch.where(upd, i + 1, b_i2)
        b_i1 = torch.where(upd, rm_idx, b_i1)
        newmin = A2 < runmin                   # strict: first min wins
        runmin = torch.where(newmin, A2, runmin)
        rm_idx = torch.where(newmin, i + 1, rm_idx)
        A = A2
    ti = torch.argmax(best, dim=1).to(i32)         # first max

    def take(a):
        return torch.gather(a, 1, ti[:, None].long())[:, 0]
    return ((take(best) - scp_total).to(i32), ti - L, take(b_i1),
            take(b_i2))


def dp_traceback(scoring, rd: np.ndarray, qual: np.ndarray, ref: np.ndarray):
    """Full DP + traceback for one (read, ref window) pair on the host,
    through native/dpkernel.cpp.

    Same scoring/mode as dp_fill_plain. Returns (score, ref_start, cigar,
    mds) where cigar is [(op, len), ...] with ops 'S'/'M'/'I'/'D',
    ref_start is the 0-based window column where the aligned region
    begins, and mds is the list of (read_off, ref_off_in_window) mismatch
    positions (including N positions).
    """
    from ..native import dpkernel_lib
    L, W = int(rd.size), int(ref.size)
    if L == 0 or W == 0:
        raise ValueError("dp_traceback needs a non-empty read and window")
    lib = dpkernel_lib()
    mm_pens = np.ascontiguousarray(scoring.mm_pens().astype(np.int32))
    sc_pens = np.ascontiguousarray(scoring.sc_pens().astype(np.int32))
    rd8 = np.ascontiguousarray(rd.astype(np.uint8))
    q8 = np.ascontiguousarray(np.clip(qual, 0, 63).astype(np.uint8))
    rf8 = np.ascontiguousarray(ref.astype(np.uint8))
    score = ctypes.c_int32()
    ref_start = ctypes.c_int32()
    ncig = ctypes.c_int32()
    nmds = ctypes.c_int32()
    cig_ops = np.zeros(L + W + 2, np.uint8)
    cig_lens = np.zeros(L + W + 2, np.int32)
    mds_buf = np.zeros(2 * L + 2, np.int32)
    rc = lib.dp_traceback_one(
        rd8, q8, L, rf8, W, mm_pens, sc_pens,
        int(scoring.match_bonus), int(scoring.n_pen),
        int(scoring.read_gap_open()), int(scoring.read_gap_extend()),
        int(scoring.ref_gap_open()), int(scoring.ref_gap_extend()),
        ctypes.byref(score), ctypes.byref(ref_start),
        cig_ops, cig_lens, ctypes.byref(ncig), mds_buf, ctypes.byref(nmds))
    if rc != 0:
        raise RuntimeError(f"dp_traceback_one returned {rc}")
    nc = int(ncig.value)
    cigar = [(chr(cig_ops[k]), int(cig_lens[k])) for k in range(nc)]
    nm = int(nmds.value)
    mds = [(int(mds_buf[2 * k]), int(mds_buf[2 * k + 1])) for k in range(nm)]
    return int(score.value), int(ref_start.value), cigar, mds
