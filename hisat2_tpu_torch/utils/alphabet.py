"""DNA alphabet encoding and 2-bit packing utilities.

Equivalent role to the reference's alphabet.{h,cpp} + bitpack.h (SURVEY.md L0),
re-done as NumPy table lookups and vectorized packing: on TPU the index is a
set of 2-bit-packed uint32 arrays, and all host-side encode/pack work is
vectorized NumPy rather than per-char loops.

Encoding: A=0, C=1, G=2, T=3, N(and any ambiguity code)=4. The FM index text
only ever contains 0..3 (ambiguous runs are excluded from the joined text, as
the reference does via RefRecord runs, ref_read.h).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

# char -> code table (uppercase+lowercase; every IUPAC ambiguity code -> N)
_ENC = np.full(256, N, dtype=np.uint8)
for _c, _v in (("A", A), ("C", C), ("G", G), ("T", T)):
    _ENC[ord(_c)] = _v
    _ENC[ord(_c.lower())] = _v

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement of codes 0..4 (N -> N)
_COMP = np.array([T, G, C, A, N], dtype=np.uint8)

BASES_PER_WORD = 16  # 2 bits per base in a uint32, LSB-first


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _ENC[seq]


def decode(codes: np.ndarray) -> str:
    """uint8 codes 0..4 -> ASCII DNA string."""
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N stays N)."""
    return _COMP[np.asarray(codes, dtype=np.uint8)][::-1]


def comp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.uint8)]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack codes 0..3 into uint32 words, 16 bases per word, LSB-first.

    Base i lives at bits [2*(i%16), 2*(i%16)+1] of word i//16. Tail of the
    final word is zero-filled (callers mask by length).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.size and codes.max() > 3:
        raise ValueError("pack_2bit requires codes in 0..3 (no N)")
    n = codes.size
    nwords = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(nwords * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    lanes = padded.reshape(nwords, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit: first n codes."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    lanes = (words[:, None] >> shifts) & 3
    return lanes.reshape(-1)[:n].astype(np.uint8)
