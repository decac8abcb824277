"""Splice-site database (host side; a copy of hisat2_tpu's, whose device
view is torch tensors here).

Equivalent role to the reference's SpliceSiteDB (splice_site.h:519): known
sites loaded from a `.ss` file (or GTF via the extract tool), novel sites
discovered at runtime and shared across subsequent batches — the batched
replacement for the reference's mutex-guarded cross-thread sharing with a
read-id skew window (hisat2.cpp:3285-3308): discoveries merge at batch
boundaries, deterministically.

Sites are keyed in joined-text coordinates: left = last base of the
upstream exon, right = first base of the downstream exon.
"""

from __future__ import annotations

import numpy as np


class SpliceSiteDB:
    def __init__(self):
        self.known: set[tuple[int, int]] = set()         # (left, right)
        self.novel: dict[tuple[int, int], int] = {}      # -> support count
        self.strands: dict[tuple[int, int], str] = {}
        self._keys_cache: np.ndarray | None = None
        self._dirty = True
        # insertion log of distinct sites, for submit-time snapshots:
        # the fused splice stage bakes the site table into the dispatch,
        # and the pipelined stream publishes new sites between a batch's
        # submit and its finish — finish-time consumers re-run rows a
        # post-submit site could affect (pipeline._splice_rescue)
        self._log: list[tuple[int, int]] = []

    # ---- ingestion ----

    def add_known(self, left: int, right: int, strand: str = ".") -> None:
        k = (left, right)
        if k not in self.known and k not in self.novel:
            self._log.append(k)
        self.known.add(k)
        self.strands[k] = strand
        self._dirty = True

    def load_ss_file(self, path, ref) -> int:
        """Load a .ss file (chrom, left, right, strand — exon boundary
        coords) mapping to joined offsets."""
        from ..io.annotations import read_splice_sites
        n = 0
        for s in read_splice_sites(path):
            try:
                tidx = ref.names.index(s.chrom)
            except ValueError:
                continue
            jl = ref.text_to_joined(tidx, s.left)
            jr = ref.text_to_joined(tidx, s.right)
            if jl is None or jr is None:
                continue
            self.add_known(jl, jr, s.strand)
            n += 1
        return n

    def add_novel(self, left: int, right: int, strand: str) -> None:
        k = (left, right)
        if k not in self.novel and k not in self.known:
            self._log.append(k)
        self.novel[k] = self.novel.get(k, 0) + 1
        self.strands.setdefault(k, strand)
        self._dirty = True

    def version(self) -> int:
        """Monotone site-count snapshot (distinct sites inserted)."""
        return len(self._log)

    def added_since(self, version: int) -> np.ndarray:
        """(n, 2) int64 sites inserted after snapshot `version`."""
        new = self._log[version:]
        return (np.asarray(new, np.int64).reshape(-1, 2) if new
                else np.zeros((0, 2), np.int64))

    # ---- device view ----

    def _sorted_pairs(self) -> np.ndarray:
        if self._dirty or self._keys_cache is None:
            pairs = sorted(set(self.known) | set(self.novel))
            self._keys_cache = (np.asarray(pairs, np.int64).reshape(-1, 2)
                                if pairs else np.zeros((0, 2), np.int64))
            self._dirty = False
        return self._keys_cache

    def device_arrays(self, device):
        """(left, right) int32 tensors on `device`, sorted
        lexicographically by (left, right), for the junction scorer's
        known-site check; padded as device_arrays4 pads them."""
        return self.device_arrays4(device)[:2]

    def device_arrays4(self, device):
        """(left, right, rights_sorted, lefts_by_right) int32 tensors on
        `device`, all padded to the same power-of-four cap (4,096 at
        least) with INT32_MAX sentinels (sorted order preserved; a
        sentinel left never equals a real query) — the by-left pair for
        the junction scorer's known-site probe, the by-right pair for
        downstream-anchor lane enumeration (ops/splice.spliced_stage). The
        padding keeps the shapes the JAX package compiles for, so both
        packages probe the same arrays. Cached per device until the DB
        mutates."""
        # keyed on the distinct-site count, NOT _dirty (any _sorted_pairs
        # caller clears _dirty; the key set == the insertion log)
        import torch
        device = torch.device(device)
        cache = getattr(self, "_dev4", None)
        if cache is None or self._dev4_v != len(self._log):
            cache = self._dev4 = {}
            self._dev4_v = len(self._log)
        got = cache.get(device)
        if got is not None:
            return got
        arr = self._sorted_pairs()
        n = arr.shape[0]
        cap = 4096
        while cap < n:
            cap *= 4
        big = np.int32(0x7FFFFFFF)
        pads = np.full((4, cap), big, np.int32)
        pads[0, :n] = arr[:, 0]
        pads[1, :n] = arr[:, 1]
        order = np.argsort(arr[:, 1], kind="stable")
        pads[2, :n] = arr[order, 1]
        pads[3, :n] = arr[order, 0]
        got = cache[device] = tuple(torch.from_numpy(p).to(device)
                                    for p in pads)
        return got

    def lefts_rights(self) -> tuple[np.ndarray, np.ndarray]:
        """Host view for known-site-driven pair generation."""
        arr = self._sorted_pairs()
        return arr[:, 0], arr[:, 1]

    def rights_sorted(self) -> tuple[np.ndarray, np.ndarray]:
        """(rights sorted asc, matching lefts) — for downstream-anchor
        lookups."""
        arr = self._sorted_pairs()
        order = np.argsort(arr[:, 1], kind="stable")
        return arr[order, 1], arr[order, 0]

    def is_baked(self, left: int, right: int) -> bool:
        """True when (left, right) is an INDEX-known site (--ss baked or
        --known-splicesite-infile), as opposed to a runtime novel
        publication. The transcriptome tie preference (known junction
        beats an equal-scoring contiguous placement) applies only to
        baked sites — the reference's recorded behavior keeps the
        contiguous alignment when the tying site was merely discovered
        from another read in the same run."""
        return (left, right) in self.known

    def __len__(self) -> int:
        return len(self.known) + len(self.novel)

    # ---- persistence (--novel-splicesite-outfile equivalent) ----

    def write_novel(self, path, ref) -> None:
        with open(path, "w") as fh:
            for (l, r), cnt in sorted(self.novel.items()):
                locl = ref.joined_to_text(l)
                locr = ref.joined_to_text(r)
                if locl is None or locr is None:
                    continue
                fh.write(f"{ref.names[locl[0]]}\t{locl[1]}\t{locr[1]}\t"
                         f"{self.strands.get((l, r), '.')}\n")
