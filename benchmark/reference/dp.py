"""The DP kernel's plain reference: a frozen copy of the program's
`ops/sw.dp_fill_plain` (score-only affine-gap fill with 5' and 3' soft
clips and the SNV overlay), in plain PyTorch.

`bits` computes the same recurrence in saturating signed integers of that
width (every sum and difference clamped to the width's range): the lower
precisions that the control puts in the kernel's place. None is int32,
the precision the configurations state.
"""

from __future__ import annotations

import torch

NEG = -(1 << 28)


def dp_fill(rd, pen, rdlens, ref, scp_cum, *, match_bonus: int, n_pen: int,
            rd_open: int, rd_ext: int, rf_open: int, rf_ext: int, ov=None,
            bits: int | None = None) -> torch.Tensor:
    """rd (C, L) codes 0..4; pen (C, L) mismatch penalties; rdlens (C,);
    ref (C, W) codes; scp_cum (C, L+1) cumulative clip penalties; ov (C,
    W) overlay nibbles (0 none, 1..4 alt + 1, 15 several) or None. Returns
    (C,) int32 best scores."""
    i32 = torch.int32
    if bits is None:
        def sat(x):
            return x
    else:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

        def sat(x):
            return x.clamp(lo, hi)
    C, L = rd.shape
    W = ref.shape[1]
    dev = rd.device
    rd, pen, ref = rd.to(i32), pen.to(i32), ref.to(i32)
    scp_cum, rdlens = scp_cum.to(i32), rdlens.to(i32)
    jcols = torch.arange(W + 1, dtype=i32, device=dev)
    ecost = rd_open + rd_ext * (jcols[1:] - 1)
    scp_tot = scp_cum[:, L]
    H = torch.zeros((C, W + 1), dtype=i32, device=dev)
    F = sat(torch.full((C, W + 1), NEG, dtype=i32, device=dev))
    best = sat(-scp_tot)
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
        col0 = sat(torch.full((C, 1), -(rf_open + i * rf_ext), dtype=i32,
                              device=dev))
        Fn_tail = torch.maximum(sat(H[:, 1:] - rf_open),
                                sat(F[:, 1:] - rf_ext))
        G = torch.cat([col0, torch.maximum(sat(H[:, :-1] + s), Fn_tail)],
                      dim=1)
        M = torch.cummax(sat(G + rd_ext * jcols), dim=1).values
        E_tail = sat(M[:, :-1] - ecost)
        Hn = torch.cat([col0, torch.maximum(G[:, 1:], E_tail)], dim=1)
        clip5 = scp_cum[:, i + 1:i + 2]
        Hn = torch.maximum(Hn, sat(-clip5))
        Fn = torch.cat([col0, Fn_tail], dim=1)
        act = (i < rdlens)[:, None]
        H = torch.where(act, Hn, H)
        F = torch.where(act, Fn, F)
        best = torch.maximum(best, sat(H.amax(dim=1) - sat(scp_tot - clip5[:, 0])))
    return torch.maximum(best, H.amax(dim=1))
