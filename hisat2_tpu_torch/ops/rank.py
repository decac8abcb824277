"""Occ/rank and LF-mapping over the 2-bit-packed BWT, and window and
gather primitives over the 2-bit-packed joined text.

Port of hisat2_tpu/ops/rank.py. rank(c, i) = the Occ checkpoint of i's
128-symbol block + a popcount of symbol matches in the block prefix (the
reference's countBt2Side/mapLF, gfm.h:2958, :3681), batched over a read
wavefront: one gather fetches each lane's side row (4 checkpoints + 8 BWT
words), the match count is elementwise bit operations. Text windows are
the reference's BitPairReference::getStretch (reference.h:108); the
row-blocked slice gathers serve the seed table.

Packed words arrive as int64 tensors holding uint32 values (see
index/fm_index.device_bundle), so `>>` is a logical shift; torch has no
population count, so `popcount32` folds the bits (SWAR). Row indices are
int32 (m < 2^31). Where the JAX
version aligns words with log-step shift cascades (cheap on the TPU's
vector unit, slow as gathers there), these functions use one
`torch.gather` each; the results are the same. Indices are clamped
explicitly wherever the JAX code relied on its clamping gathers.
"""

from __future__ import annotations

import torch

from ..index.fm_index import OCC_BLOCK, WORDS_PER_BLOCK

_MASK32 = 0xFFFFFFFF
_LOG2_BLOCK = OCC_BLOCK.bit_length() - 1      # 7
_M55 = 0x55555555
_WORD_SYMS = 16                                # 2-bit symbols per word


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 value held in an int64 tensor (same shape,
    int64). Pairwise folding: no multiply, and every partial sum fits its
    field, so nothing overflows."""
    x = x - ((x >> 1) & _M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def count_eq_packed(words: torch.Tensor, c: torch.Tensor,
                    nsym: torch.Tensor) -> torch.Tensor:
    """#symbols == c among the first nsym 2-bit symbols of each word.

    words int64 holding uint32 values; c in 0..3 and nsym in [0, 16],
    broadcastable. Returns int32. The mask (1 << 2*nsym) - 1 is exact in
    int64 for nsym = 16 too, the all-ones case the uint32 original has to
    special-case."""
    x = words ^ (c.long() * _M55)
    y = (x | (x >> 1)) & _M55                  # pair-low bit set iff mismatch
    match = ~y & _M55                          # pair-low bit set iff match
    mask = (torch.ones((), dtype=torch.int64, device=words.device)
            << (2 * nsym.long())) - 1
    return popcount32(match & mask).to(torch.int32)


def rank(idx: dict, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """rank(c, i): #occurrences of symbol c in bwt[0:i).

    c (0..3) and i: int32 tensors of one shape. One row gather per lane
    from idx["sides"]; the block index is clamped as the JAX gather clamps
    it. Corrects for the '$' row, stored as symbol 0 at zoff (the
    reference's _zOffs handling, gfm.h:2431)."""
    c = c.to(torch.int32)
    i = i.to(torch.int32)
    sides = idx["sides"]
    blk = (i >> _LOG2_BLOCK).clamp(0, sides.shape[0] - 1)
    side = sides[blk.long()]                              # (..., 12)
    base = torch.gather(side[..., :4], -1,
                        c.clamp(0, 3).long().unsqueeze(-1))[..., 0]
    within = i - (blk << _LOG2_BLOCK)                     # 0..128
    w = torch.arange(WORDS_PER_BLOCK, dtype=torch.int32, device=i.device)
    nsym = (within.unsqueeze(-1) - _WORD_SYMS * w).clamp(0, _WORD_SYMS)
    cnt = count_eq_packed(side[..., 4:], c.unsqueeze(-1), nsym).sum(
        dim=-1, dtype=torch.int32)
    dollar_fix = ((c == 0) & (i > idx["zoff"])).to(torch.int32)
    return base.to(torch.int32) + cnt - dollar_fix


def lf(idx: dict, i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """LF-mapping: row of T'[SA[i]-1] when bwt[i] == c; the backward-search
    step (reference mapLF, gfm.h:3681)."""
    return idx["ccount"][c.long()] + rank(idx, c, i)


def lf_step_interval(idx: dict, top: torch.Tensor, bot: torch.Tensor,
                     c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Extend an SA interval [top, bot) left by symbol c (c in 0..3). Both
    bounds rank in one gather batch."""
    base = idx["ccount"][c.long()]
    tb = torch.stack([top, bot])
    r = rank(idx, c.expand(tb.shape), tb)
    return base + r[0], base + r[1]


def packed_char(packed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Symbol at position pos of a 2-bit packed array (BWT or text), int32.
    The word index is clamped into the array."""
    word = packed[(pos >> 4).long().clamp(0, packed.shape[0] - 1)]
    return ((word >> (2 * (pos & 15)).long()) & 3).to(torch.int32)


def bwt_char(idx: dict, r: torch.Tensor) -> torch.Tensor:
    """BWT symbol at row r (callers must special-case r == zoff)."""
    return packed_char(idx["bwt_packed"], r)


def _shift_words(w: torch.Tensor, ws: torch.Tensor, keep: int) -> torch.Tensor:
    """w (..., NW); per-lane left shift of the last axis by ws
    (0 <= ws < NW), zero-filled on the right, first `keep` entries."""
    NW = w.shape[-1]
    ix = ws.long().unsqueeze(-1) + torch.arange(keep, device=w.device)
    got = torch.gather(w, -1, ix.clamp(max=NW - 1))
    return torch.where(ix < NW, got, torch.zeros((), dtype=w.dtype,
                                                 device=w.device))


def _shift_right_fill(x: torch.Tensor, sh: torch.Tensor,
                      fill: int) -> torch.Tensor:
    """Per-lane RIGHT shift of the last axis by sh (>= 0), filling with
    `fill` on the left. Honors negative window starts on the non-padded
    text views (chromosome-start windows pad with N)."""
    L = x.shape[-1]
    ix = torch.arange(L, device=x.device) - sh.long().unsqueeze(-1)
    got = torch.gather(x, -1, ix.clamp(min=0))
    return torch.where(ix >= 0, got, torch.full((), fill, dtype=x.dtype,
                                                device=x.device))


def gather_rows2(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rows r and r+1 of a 2-D tensor, concatenated -> (..., 2*W)."""
    r = r.long().clamp(0, rows.shape[0] - 2)
    return torch.cat([rows[r], rows[r + 1]], dim=-1)


def gather_slices(arr2d: torch.Tensor, starts: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Contiguous (size,)-windows of a row-blocked 1-D array at per-lane
    element offsets. arr2d is the array viewed as (nrows, RW) with
    RW >= size; each window is rows r and r+1 aligned to the offset."""
    RW = arr2d.shape[1]
    r = torch.div(starts, RW, rounding_mode="floor").long()
    r = r.clamp(0, arr2d.shape[0] - 1)
    w = torch.cat([arr2d[r], arr2d[(r + 1).clamp(max=arr2d.shape[0] - 1)]],
                  dim=-1)
    return _shift_words(w, torch.remainder(starts, RW), size)


def searchsorted_right(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`searchsorted(table, q, side="right")` as int32."""
    if table.shape[0] == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    return torch.searchsorted(table, q.contiguous(), right=True,
                              out_int32=True)


def text_window(idx: dict, start: torch.Tensor, length: int) -> torch.Tensor:
    """Joined-text window [start, start+length) as int32 codes; positions
    outside [0, n) come back as 4 (N). start: (...,) int32; result
    (..., length).

    Windows of <= 128 chars come from ONE row of the padded 50%-overlap
    view, windows of <= 256 from two rows of the plain row view, longer
    ones from per-word gathers of the packed text.
    """
    start = start.to(torch.int32)
    nw = (length + 15) // 16
    if length <= 128:
        rows = idx["text_rows_ov"]
        q = start.clamp(min=-128) + 128
        r = (q >> 7).long().clamp(0, rows.shape[0] - 1)
        words = _shift_words(rows[r], (q >> 4) & 7, nw + 1)
        sh = 2 * (q & 15)
        fill_sh = None
    else:
        cs = start.clamp(min=0)
        sh = 2 * (cs & 15)
        if length <= 256:
            w32 = gather_rows2(idx["text_rows"], cs >> 8)
            words = _shift_words(w32, (cs >> 4) & 15, nw + 1)
        else:
            packed = idx["text_packed"]
            widx = (cs >> 4).long().unsqueeze(-1) + torch.arange(
                nw + 1, device=start.device)
            words = packed[widx.clamp(0, packed.shape[0] - 1)]
        fill_sh = cs - start
    # aligned[w] = words[w] >> sh | words[w+1] << (32-sh), on uint32 values
    sh = sh.long().unsqueeze(-1)
    lo = words[..., :nw] >> sh
    hi = torch.where(sh == 0, torch.zeros_like(lo),
                     (words[..., 1:] << (32 - sh)) & _MASK32)
    aligned = lo | hi                                      # (..., nw)
    shifts = 2 * torch.arange(16, device=start.device)
    chars = ((aligned.unsqueeze(-1) >> shifts) & 3).to(torch.int32)
    out = chars.reshape(*chars.shape[:-2], nw * 16)[..., :length]
    if fill_sh is not None:
        out = _shift_right_fill(out, fill_sh, 4)
    pos = start.unsqueeze(-1) + torch.arange(length, dtype=torch.int32,
                                             device=start.device)
    inb = (pos >= 0) & (pos < idx["n"])
    return torch.where(inb, out, torch.full((), 4, dtype=torch.int32,
                                            device=out.device))


def nib4_window(idx: dict, start: torch.Tensor, length: int) -> torch.Tensor:
    """SNV-overlay window of a graph index: the 4-bit nibbles (0 none,
    1..4 alt code + 1, 15 several alts) at primary-text positions
    [start, start+length), int32; positions outside [0, primary_n) come
    back 0. start: (...,) int32; result (..., length).

    One formulation for every length (the JAX version's three differ only
    in how they gather): each position reads its word of idx["snv_packed"]
    (int64 holding uint32 words, 8 nibbles LSB first) and shifts its
    nibble down, so there is no word alignment and no 32-bit shift by 32.
    """
    start = start.to(torch.int32)
    packed = idx["snv_packed"]
    pos = start.unsqueeze(-1) + torch.arange(length, dtype=torch.int32,
                                             device=start.device)
    word = packed[(pos >> 3).long().clamp(0, packed.shape[0] - 1)]
    nib = ((word >> (4 * (pos & 7)).long()) & 15).to(torch.int32)
    inb = (pos >= 0) & (pos < idx["primary_n"])
    return torch.where(inb, nib, torch.zeros((), dtype=torch.int32,
                                             device=nib.device))
