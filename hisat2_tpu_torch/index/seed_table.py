"""Direct-address k-mer seed table: kmer -> sorted genome positions.

Role: replaces the FM backward-search seeding chain (reference
HI_Aligner::partialSearch, hi_aligner.h:6361 + GroupWalk SA resolution,
group_walk.h:1411) on the throughput path. The reference walks each seed
through ~12 sequential LF/rank steps (gfm.h:3681 mapLF) and then walks
rows left to resolve positions — both are pointer-chasing chains. On TPU,
random HBM gathers cost ~the same per *lane* regardless of width, and a
12-step dependent chain is 12 serialized gather rounds; a direct-address
table resolves a seed to its candidate positions in exactly TWO gather
rounds (bucket bounds, then a contiguous position slice), independent of
seed length.

Layout (device):
  st_starts: (4^kt + 1,) int32 — bucket start offsets, so the slots of
             kmer code c are positions[st_starts[c] : st_starts[c+1])
  st_pos:    (n_kmers + pad,) int32 — kmer start positions sorted by code
             (within a bucket: ascending position, so expansion order is
             deterministic like SA-order expansion)
  st_k:      static int — kmer length

kt is sized so the expected bucket load is <~1 (4^kt >= n), clamped to
[8, 13]; the cost of the shorter-than-22bp seed (the reference's SEED=22
multiseed policy) is a few extra spurious candidates per read, all
rejected by the full verify stage — sensitivity is unchanged while the
seeding dependency chain drops from ~12 rounds to 2.
"""

from __future__ import annotations

import numpy as np

MAX_KT = 13
MIN_KT = 8


def pick_kt(n: int) -> int:
    kt = int(np.ceil(np.log(max(n, 4)) / np.log(4))) + 1
    return max(MIN_KT, min(MAX_KT, kt))


def rolling_codes(text: np.ndarray, kt: int) -> np.ndarray:
    """Base-4 big-endian code of every kt-mer; shape (n - kt + 1,)."""
    n = text.size
    m = n - kt + 1
    if m <= 0:
        return np.zeros(0, np.int64)
    codes = np.zeros(m, np.int64)
    t = text.astype(np.int64)
    for j in range(kt):
        codes += t[j:j + m] * (4 ** (kt - 1 - j))
    return codes


def build_seed_table(text: np.ndarray, kt: int | None = None,
                     pad: int = 64, stride: int = 1
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (starts int32 (4^kt + 1,), pos int32 (m_kept + pad,), kt).

    pos is padded with `pad` sentinel entries so device slice-gathers of up
    to `pad` slots never clamp into a neighboring bucket.

    stride > 1 keeps only kmer starts at positions % stride == 0 (the
    Gbp memory diet: stride 2 halves device st_pos residency; the seed
    offsets jitter by residue so every diagonal stays reachable,
    ops/search.table_seed). The offrate-sampling role of gfm.h _offs.

    The build is a stable counting sort of kmer start positions by code:
    the native threaded pass (native/kmersort.cpp — the P4 parallel-build
    equivalent of the reference's blockwise_sa.h bucket workers) for an
    N-free text with kt <= 15, else a torch stable argsort.
    """
    n = int(text.size)
    if kt is None:
        kt = pick_kt(n)
    m = max(0, n - kt + 1)
    mk = (m + stride - 1) // stride if stride > 1 else m
    if m and not (text >= 4).any():
        from .. import native as _native
        lib = _native.kmersort_lib()
        starts = np.empty(4 ** kt + 1, np.int32)
        pos = np.empty(mk + pad, np.int32)
        tc = text if text.dtype == np.uint8 else text.astype(np.uint8)
        rc = lib.kmer_table(np.ascontiguousarray(tc), np.int64(n),
                            np.int32(kt), starts, pos[:mk], 0,
                            np.int32(stride))
        if rc == 0:
            pos[mk:] = 0
            return starts, pos, kt
    codes = rolling_codes(text, kt)
    if stride > 1:
        keep = np.arange(codes.size) % stride == 0
        codes_k = codes[keep]
        kept_pos = np.flatnonzero(keep)
    else:
        codes_k = codes
        kept_pos = None
    counts = np.bincount(codes_k, minlength=4 ** kt)
    starts = np.zeros(4 ** kt + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = _stable_sort_indices(codes_k)
    pos = np.empty(mk + pad, np.int32)
    pos[:codes_k.size] = (order if kept_pos is None
                          else kept_pos[order]).astype(np.int32)
    pos[codes_k.size:] = 0
    return starts.astype(np.int32), pos, kt


def _stable_sort_indices(codes: np.ndarray) -> np.ndarray:
    """argsort(codes, stable) on torch's parallel CPU sort."""
    import torch
    return torch.argsort(torch.from_numpy(codes), stable=True).numpy()
