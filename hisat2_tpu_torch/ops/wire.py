"""Wire codec for device->host packs: bit-pack int16 lane arrays into
32-bit words for the copy to the host, expand back to the exact lanes
there.

Port of hisat2_tpu/ops/wire.py. Each lane of a pack travels as a declared
number of low bits (positions need 32, but clips, mismatch columns and
counts fit in a few), so the PE pair-pack crosses to the host in a third
of its int16 bytes; the host restores identical int16 lanes, so every
consumer downstream (the native formatter, the slow-pair ladder) is
unchanged.

A lane table is a tuple of (bits, signed) per int16 lane:
  bits 1..16  - lane travels as that many low bits (signed lanes are
                sign-extended back on decode)
  bits 0      - lane is constant 0 (not shipped)
Decode reproduces the original lanes exactly as long as every value fits
its declared width; widths come from static shape parameters (read length
L -> clip/mismatch-column bits, KP -> nvalid bits), so the fit is
structural, not data-dependent.

torch has no full uint32 arithmetic, and `>>` on int32 is arithmetic, so
the device builds the words in int64, masks them to 32 bits, and returns
their bit patterns as int32; the host reads them as a np.uint32 view
(`as_words`).
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = (1 << 32) - 1


def col_bits(L: int) -> int:
    """Bits for a read-column value (clip lengths, mismatch columns)."""
    return max(7, int(L - 1).bit_length())


def n_words(table) -> int:
    return (sum(b for b, _ in table) + 31) // 32


def encode_lanes(pack: torch.Tensor, table) -> torch.Tensor:
    """Device side: (B, W) int16 lanes -> (B, NW) int32 tensor holding the
    uint32 words' bit patterns."""
    B = pack.shape[0]
    NW = n_words(table)
    words = [torch.zeros(B, dtype=torch.int64, device=pack.device)
             for _ in range(NW)]
    off = 0
    u = pack.to(torch.int64) & 0xFFFF           # two's-complement low 16
    for i, (bits, _signed) in enumerate(table):
        if bits == 0:
            continue
        v = u[:, i] & ((1 << bits) - 1)
        w, b = divmod(off, 32)
        words[w] = words[w] | ((v << b) & _MASK32)
        if b + bits > 32:
            words[w + 1] = words[w + 1] | (v >> (32 - b))
        off += bits
    wd = torch.stack(words, dim=1)
    return torch.where(wd >= (1 << 31), wd - (1 << 32), wd).to(torch.int32)


def as_words(enc: np.ndarray) -> np.ndarray:
    """Host view of encode_lanes' output as the uint32 words."""
    return np.ascontiguousarray(enc).view(np.uint32)


def decode_lanes(words: np.ndarray, table) -> np.ndarray:
    """Host-side inverse: (B, NW) uint32 -> (B, W) int16."""
    B = words.shape[0]
    W = len(table)
    out = np.zeros((B, W), np.int16)
    w64 = words.astype(np.uint64)
    off = 0
    for i, (bits, signed) in enumerate(table):
        if bits == 0:
            continue
        w, b = divmod(off, 32)
        v = w64[:, w] >> np.uint64(b)
        if b + bits > 32:
            v = v | (w64[:, w + 1] << np.uint64(32 - b))
        v = (v & np.uint64((1 << bits) - 1)).astype(np.uint32)
        if signed and bits < 16:
            sign = v >> (bits - 1)
            v = v | (np.uint32(0xFFFFFFFF) << bits) * sign
        out[:, i] = v.astype(np.uint16).astype(np.int16) if not signed \
            else v.astype(np.int32).astype(np.int16)
        off += bits
    return out


# ---------------------------------------------------------------------------
# PE pair-pack tables (align/paired.py PEPACK_* layout, NRB == 1)
# ---------------------------------------------------------------------------

def _mate_table(cb: int):
    mm = cb + 3
    return [
        (16, False), (16, False),       # pos lo / hi
        (cb, False), (cb, False),       # c5 c3
        (3, False), (3, False),         # nmm nmm_all (fast path caps at 4)
        (16, True),                     # score
        (mm, False), (mm, False), (mm, False), (mm, False),
    ]


def pe_pack_table(L1: int, L2: int, nvbits: int):
    """Base PE pack, W = 4 + 23 + 1. Lane 1 (best) is not shipped: for
    nvalid >= 1 it always equals score1 + score2 of report 0 (combo 0 of
    the device top-k, unclipped in any real scoring regime), and for
    nvalid == 0 it is the clipped NEG_INF sentinel; decode reconstructs
    both (pe_pack_decode)."""
    return ([(nvbits, False), (0, True), (16, True), (0, False),
             (4, False)]
            + _mate_table(col_bits(L1)) + _mate_table(col_bits(L2))
            + [(2, False)])


def pe_pack_decode(words: np.ndarray, L1: int, L2: int,
                   nvbits: int) -> np.ndarray:
    t = pe_pack_table(L1, L2, nvbits)
    fp = decode_lanes(words, t)
    s1 = fp[:, 4 + 1 + 6].astype(np.int32)      # mate1 score lane
    s2 = fp[:, 4 + 1 + 11 + 6].astype(np.int32)  # mate2 score lane
    best = np.clip(s1 + s2, -32768, 32767).astype(np.int16)
    fp[:, 1] = np.where(fp[:, 0] >= 1, best, np.int16(-32768))
    return fp


def pe_rep_table(L1: int, L2: int):
    """One tier report row: [rflag] + mate1 + mate2 (23 lanes)."""
    return ([(4, False)]
            + _mate_table(col_bits(L1)) + _mate_table(col_bits(L2)))


def pe_rep_decode(words: np.ndarray, L1: int, L2: int,
                  nrep: int) -> np.ndarray:
    """Tier extras: (rows, nrep * NW) uint32 -> (rows, nrep * 23) int16."""
    t = pe_rep_table(L1, L2)
    NW = n_words(t)
    rows = words.shape[0]
    out = np.empty((rows, nrep * 23), np.int16)
    for j in range(nrep):
        out[:, j * 23:(j + 1) * 23] = decode_lanes(
            words[:, j * NW:(j + 1) * NW], t)
    return out


# ---------------------------------------------------------------------------
# SE fastpack tables (align/pipeline.py fastpack layout, KFB == 1)
# ---------------------------------------------------------------------------

def se_pack_table(L: int, nvbits: int, flbits: int):
    """Base SE fastpack, W = 4 + 11."""
    return ([(nvbits, False), (16, True), (16, True), (flbits, False)]
            + _mate_table(col_bits(L)))


def se_pack_decode(words: np.ndarray, L: int, nvbits: int,
                   flbits: int) -> np.ndarray:
    return decode_lanes(words, se_pack_table(L, nvbits, flbits))


def se_rep_table(L: int):
    """One SE tier report row (11 lanes, no flag lane: fw/gapped bits
    live in the base pack's flags lane)."""
    return _mate_table(col_bits(L))


def se_rep_decode(words: np.ndarray, L: int, nrep: int) -> np.ndarray:
    t = se_rep_table(L)
    NW = n_words(t)
    rows = words.shape[0]
    out = np.empty((rows, nrep * 11), np.int16)
    for j in range(nrep):
        out[:, j * 11:(j + 1) * 11] = decode_lanes(
            words[:, j * NW:(j + 1) * NW], t)
    return out
