"""Window and gather primitives over the 2-bit-packed joined text.

Port of the subset of hisat2_tpu/ops/rank.py that the seed-table SE path
uses: text windows (the reference's BitPairReference::getStretch,
reference.h:108), row-blocked slice gathers for the seed table, and the
small-table searchsorted.

Packed words arrive as int64 tensors holding uint32 values (see
index/fm_index.device_bundle), so `>>` is a logical shift. Where the JAX
version aligns words with log-step shift cascades (cheap on the TPU's
vector unit, slow as gathers there), these functions use one
`torch.gather` each; the results are the same. Indices are clamped
explicitly wherever the JAX code relied on its clamping gathers.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


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
