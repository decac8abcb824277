"""Host-side suffix array construction.

Equivalent role to the reference's blockwise_sa.h (Kärkkäinen blockwise
suffix sorting) + diff_sample + multikey_qsort (SURVEY.md §2.2). Blockwise
sorting is a memory optimization for 8GB desktops; here the native SA-IS
builder (native/sais.cpp) sorts the whole joined text in linear time.
"""

from __future__ import annotations

import numpy as np


def build_suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of text (uint8 codes 0..3) + implicit terminal sentinel.

    Returns SA of length n+1 over T' = text + '$' where '$' sorts before
    every symbol; SA[0] == n always (the sentinel suffix). Built by the
    native SA-IS builder (native/sais.cpp, linear time).
    """
    from ..native import sais_lib
    text = np.asarray(text)
    n = int(text.size)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    lib = sais_lib()
    # shift symbols +1 and append the 0 sentinel (SA-IS contract)
    t = np.empty(n + 1, np.uint8)
    t[:n] = text.astype(np.uint8) + 1
    t[n] = 0
    if n + 1 < (1 << 31):
        sa = np.empty(n + 1, np.int32)
        lib.sais_u8_i32(t, sa, n + 1, 6)
        return sa.astype(np.int64)
    sa = np.empty(n + 1, np.int64)
    lib.sais_u8_i64(t, sa, n + 1, 6)
    return sa


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT over text+'$' given its SA.

    Returns (bwt codes with the '$' cell stored as 0, zoff) where zoff is the
    row holding '$' (the reference tracks the same as _zOffs, gfm.h:2431).
    """
    text = np.asarray(text, dtype=np.uint8)
    sa = np.asarray(sa, dtype=np.int64)
    prev = sa - 1
    zoff = int(np.flatnonzero(sa == 0)[0])
    prev_clipped = np.where(sa == 0, 0, prev)
    bwt = text[prev_clipped].astype(np.uint8)
    bwt[zoff] = 0
    return bwt, zoff
