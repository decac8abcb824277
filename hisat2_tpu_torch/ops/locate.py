"""SA-row -> joined-text-offset resolution.

Port of hisat2_tpu/ops/locate.py; the role of the reference's GroupWalk2S
(group_walk.h:1411) + joinedToTextOff (gfm.h:5527). A full-SA index
resolves a row with one gather. A sampled-SA index (--offrate k) walks
each row left by LF until a marked row is hit, a fixed 2^k - 1 rounds
with finished lanes standing still, then ranks the marked row in the
bitmap and adds the walked distance.
"""

from __future__ import annotations

import torch

from . import rank as _rank

I32 = torch.int32


def locate_rows(idx: dict, rows: torch.Tensor) -> torch.Tensor:
    """SA values for row indices (any shape), int32. Rows out of range are
    clipped to [0, m - 1]; callers mask with their own validity bits."""
    rows = rows.to(I32).clamp(0, idx["m"] - 1)
    if "samp_bits" not in idx:
        return idx["sa"][rows.long()]
    bits = idx["samp_bits"]

    def marked(r):
        return ((bits[(r >> 5).long()] >> (r & 31).long()) & 1) == 1

    r = rows
    steps = torch.zeros_like(r)
    for _ in range(idx["samp_ival"] - 1):
        done = marked(r)
        nr = _rank.lf(idx, r, _rank.bwt_char(idx, r))
        r = torch.where(done, r, nr)
        steps = steps + (~done).to(I32)
    # rank of marked row r among marked rows: checkpoint + in-block popcount
    blk = r >> 9
    base = idx["samp_rank"][blk.long()]
    ar = torch.arange(16, dtype=I32, device=r.device)
    wix = (blk << 4).unsqueeze(-1) + ar                 # 16 words per block
    words = bits[wix.long().clamp(0, bits.shape[0] - 1)]
    within = r - (blk << 9)                             # bits before r
    nbits = (within.unsqueeze(-1) - 32 * ar).clamp(0, 32)
    mask = (torch.ones((), dtype=torch.int64, device=r.device)
            << nbits.long()) - 1
    cnt = _rank.popcount32(words & mask).sum(dim=-1, dtype=I32)
    vals = idx["samp_vals"]
    return vals[(base + cnt).long().clamp(0, vals.shape[0] - 1)] + steps


def expand_range(idx: dict, top: torch.Tensor, bot: torch.Tensor,
                 max_locs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First max_locs joined offsets of interval [top, bot), rows taken in
    SA order. Returns (offsets (..., max_locs) int32, valid mask)."""
    rows = top.unsqueeze(-1) + torch.arange(max_locs, dtype=I32,
                                            device=top.device)
    return locate_rows(idx, rows), rows < bot.unsqueeze(-1)


def lf_walk_left(idx: dict, row: torch.Tensor, steps: int) -> torch.Tensor:
    """Apply LF `steps` times from each row (batched); a lane that reaches
    the '$' row stays there (reference walkLeft, gfm.h:5658)."""
    r = row.to(I32)
    for _ in range(steps):
        nr = _rank.lf(idx, r, _rank.bwt_char(idx, r))
        r = torch.where(r == idx["zoff"], r, nr)
    return r
