"""Reference genome ingestion: FASTA -> joined unambiguous text + fragments.

Equivalent role to the reference's ref_read.{h,cpp} (RefRecord runs) +
reference.{h,cpp} (BitPairReference): ambiguous (non-ACGT) stretches are
excluded from the joined text over which the FM index is built, and fragment
records map joined offsets back to (chromosome, offset) — the reference's
joinedToTextOff (gfm.h:5527).

TPU design: the joined text is one contiguous 2-bit-packed uint32 array in
HBM; fragment tables are small device arrays so candidate-validity tests
(alignment must not cross a fragment boundary) run inside the batched verify
kernel via searchsorted.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..utils import alphabet
from .reads import _open_text


@dataclass
class JoinedReference:
    names: list[str]            # chromosome names (first whitespace token)
    tlens: np.ndarray           # (T,) int64 full chromosome lengths (incl. Ns)
    joined: np.ndarray          # (n,) uint8 codes 0..3, ambiguous runs removed
    frag_joined: np.ndarray     # (F,) int64 joined-offset of each fragment start
    frag_toff: np.ndarray       # (F,) int64 chromosome-offset of fragment start
    frag_tidx: np.ndarray       # (F,) int32 chromosome index of fragment
    frag_len: np.ndarray        # (F,) int64 fragment length

    @property
    def n(self) -> int:
        return int(self.joined.size)

    def joined_to_text(self, joff: int, length: int = 1):
        """Map a joined offset (+length) to (tidx, toff); None if it crosses a
        fragment boundary or falls outside. Mirrors gfm.h:5527 semantics."""
        f = int(np.searchsorted(self.frag_joined, joff, side="right")) - 1
        if f < 0:
            return None
        if joff + length > int(self.frag_joined[f]) + int(self.frag_len[f]):
            return None
        return int(self.frag_tidx[f]), int(self.frag_toff[f]) + joff - int(self.frag_joined[f])

    def text_to_joined(self, tidx: int, toff: int) -> int | None:
        """Inverse mapping for test/tooling use."""
        for f in range(len(self.frag_joined)):
            if int(self.frag_tidx[f]) == tidx:
                lo = int(self.frag_toff[f])
                if lo <= toff < lo + int(self.frag_len[f]):
                    return int(self.frag_joined[f]) + toff - lo
        return None

    def get_stretch(self, joff: int, length: int) -> np.ndarray:
        """Joined-text window with out-of-range padded as N (for DP windows)."""
        out = np.full(length, alphabet.N, dtype=np.uint8)
        lo, hi = max(0, joff), min(self.n, joff + length)
        if hi > lo:
            out[lo - joff: hi - joff] = self.joined[lo:hi]
        return out


def load_reference(paths, min_frag_len: int = 1) -> JoinedReference:
    """Parse one or more FASTA files into a JoinedReference.

    Runs of ambiguous bases are dropped from the joined text (the reference
    drops every ambiguous base: ref_read.cpp treats any non-ACGT as a gap
    between RefRecords).
    """
    if isinstance(paths, (str, bytes)) or not hasattr(paths, "__iter__"):
        paths = [paths]
    names: list[str] = []
    tlens: list[int] = []
    joined_chunks: list[np.ndarray] = []
    fj, ft, fi, fl = [], [], [], []
    joff = 0

    def flush_seq(codes: np.ndarray, tidx: int):
        nonlocal joff
        tlens.append(int(codes.size))
        if codes.size == 0:
            return
        is_acgt = codes < 4
        # boundaries of maximal ACGT runs
        diff = np.diff(is_acgt.astype(np.int8))
        starts = np.flatnonzero(diff == 1) + 1
        ends = np.flatnonzero(diff == -1) + 1
        if is_acgt[0]:
            starts = np.concatenate([[0], starts])
        if is_acgt[-1]:
            ends = np.concatenate([ends, [codes.size]])
        for s, e in zip(starts, ends):
            if e - s < min_frag_len:
                continue
            fj.append(joff)
            ft.append(int(s))
            fi.append(tidx)
            fl.append(int(e - s))
            joined_chunks.append(codes[s:e])
            joff += int(e - s)

    for path in paths:
        with _open_text(path) as fh:
            cur_name, chunks = None, []
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(">"):
                    if cur_name is not None:
                        flush_seq(alphabet.encode("".join(chunks)), len(names))
                        names.append(cur_name)
                    cur_name = re.split(r"\s", line[1:], 1)[0]
                    chunks = []
                else:
                    chunks.append(line)
            if cur_name is not None:
                flush_seq(alphabet.encode("".join(chunks)), len(names))
                names.append(cur_name)

    joined = (np.concatenate(joined_chunks) if joined_chunks
              else np.zeros(0, dtype=np.uint8))
    return JoinedReference(
        names=names,
        tlens=np.asarray(tlens, dtype=np.int64),
        joined=joined,
        frag_joined=np.asarray(fj, dtype=np.int64),
        frag_toff=np.asarray(ft, dtype=np.int64),
        frag_tidx=np.asarray(fi, dtype=np.int32),
        frag_len=np.asarray(fl, dtype=np.int64),
    )


def reference_from_seqs(seqs: dict[str, str]) -> JoinedReference:
    """Build a JoinedReference directly from {name: sequence} (tests/tools)."""
    import io as _io
    buf = _io.StringIO()
    for k, v in seqs.items():
        buf.write(f">{k}\n{v}\n")
    import tempfile, os
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as tf:
        tf.write(buf.getvalue())
        tmp = tf.name
    try:
        return load_reference(tmp)
    finally:
        os.unlink(tmp)
