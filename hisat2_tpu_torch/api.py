"""Embedding API — equivalent role to the reference's ht2lib C API
(hisat2lib/ht2.h: ht2_init, ht2_index_getrefnames, ht2_repeat_expand,
SURVEY.md §2.5) plus its Python wrapper (pymodule/ht2module.c); the
PyTorch port of hisat2_tpu's api.py.

The reference exposes a C handle over loaded GFM+RFM indexes; here the
handle is a thin object over the loaded FMIndex/GraphFMIndex (+ repeat
db when present), with the same operations:

    h = ht2.init("/path/to/index_prefix", no_spliced_alignment=True)
    h.get_refnames()                 -> ["chr1", ...]
    h.repeat_expand(name, pos, len)  -> [(chr_id, strand, pos), ...]
    h.align(reads, khits=5)          -> per-read results (bonus: the
                                        reference has no align() in ht2lib)

init() mirrors the ht2_options struct (ht2.h:42-57): offRate maps to the
sampled-SA offrate override, useHaplotype gates haplotype patches when
loading .ht2 graph files, noSplicedAlignment fixes the aligner mode;
mm/shmem knobs are accepted for API parity but are no-ops (device HBM
residency replaces index mmap/SysV sharing, SURVEY §2.6 P7). align()
forwards AlignerOpts fields (khits, minins/maxins, spliced, ...).
`device` ("cuda" unless the caller asks for "cpu") is where the aligner
runs; init() raises when it names a CUDA device and no card is present.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Handle:
    fm: object
    aligner: object | None = None
    options: dict | None = None
    device: str = "cuda"

    # ---- ht2_index_* ----

    def get_refnames(self) -> list[str]:
        return list(self.fm.ref.names)

    def get_reflens(self) -> list[int]:
        return [int(x) for x in self.fm.ref.tlens]

    # ---- ht2_repeat_* ----

    def repeat_expand(self, name: str, pos: int, length: int
                      ) -> list[tuple[int, int, int]]:
        """Expand a repeat-index alignment to genomic positions:
        [(chr_id, direction, pos), ...] (ht2_repeat.cpp:52 contract).
        As in hisat2_tpu, no index loader sets `repeat_db`, so this
        raises ValueError for every index."""
        rdb = getattr(self.fm, "repeat_db", None)
        if rdb is None:
            raise ValueError("index has no repeat database")
        return rdb.expand(name, pos, length)

    # ---- alignment (library embedding) ----

    def _get_aligner(self, **opt_overrides):
        from .align.pipeline import Aligner
        if self.aligner is None:
            self.aligner = Aligner(self.fm, device=self.device)
            if (self.options or {}).get("no_spliced_alignment"):
                self.aligner.opts.spliced = False
            elif getattr(self.fm, "known_ss", None) is not None:
                self.aligner.opts.spliced = True
        for k, v in opt_overrides.items():
            if not hasattr(self.aligner.opts, k):
                raise TypeError(f"unknown aligner option {k!r}")
            setattr(self.aligner.opts, k, v)
        return self.aligner

    def align(self, seqs: list[str], names: list[str] | None = None,
              **opts):
        """Align raw sequences; returns a list of ReadResult. Keyword
        options forward to AlignerOpts (khits, spliced, minins, maxins,
        no_dp, ... — pipeline.AlignerOpts fields)."""
        from .io.reads import Read, batchify
        from .utils import alphabet
        names = names or [f"r{i}" for i in range(len(seqs))]
        reads = [Read(n, alphabet.encode(s), None, i)
                 for i, (n, s) in enumerate(zip(names, seqs))]
        return self._get_aligner(**opts).align_batch(batchify(reads))


def init(prefix: str, *, off_rate: int = -1, use_mm: bool = False,
         use_shmem: bool = False, mm_sweep: bool = False,
         no_ref_names: bool = False, no_spliced_alignment: bool = False,
         g_verbose: bool = False, start_verbose: bool = False,
         sanity_check: bool = False, use_haplotype: bool = False,
         device: str = "cuda") -> Handle:
    """Load an index (ht2_init equivalent). Keyword options mirror the
    ht2_options struct field-for-field (ht2.h:42-57); useMm/useShmem/
    mmSweep are parity no-ops (P7: HBM residency replaces host index
    sharing), noRefNames/gVerbose/startVerbose/sanityCheck affect only
    logging in the reference and are recorded on the handle."""
    from .index.fm_index import FMIndex
    from .utils import resolve_device
    resolve_device(device)
    opts = dict(off_rate=off_rate, use_mm=use_mm, use_shmem=use_shmem,
                mm_sweep=mm_sweep, no_ref_names=no_ref_names,
                no_spliced_alignment=no_spliced_alignment,
                g_verbose=g_verbose, start_verbose=start_verbose,
                sanity_check=sanity_check, use_haplotype=use_haplotype)
    fm = FMIndex.load(prefix)
    # off_rate (ht2.h offRate; gfm.h _overrideOffRate) is recorded and
    # changes nothing: hisat2_tpu's init imports a resample_offrate that
    # its fm_index does not define and swallows the ImportError, so the
    # override is a no-op there too
    h = Handle(fm, options=opts, device=device)
    if sanity_check:
        n = len(fm.ref.names)
        assert n == len(fm.ref.tlens), "refname/tlen mismatch"
    return h
