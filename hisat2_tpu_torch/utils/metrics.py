"""Alignment metrics counters (reference PerfMetrics/--met role,
hisat2.cpp:2076: periodic tab-table of internal counters).

The reference merges per-thread metric structs under a mutex every 16
reads; here counters are naturally batch-granular — each pipeline stage
bumps them once per batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Metrics:
    start_time: float = field(default_factory=time.time)
    # outer loop (reference OuterLoopMetrics, hisat2.cpp:2027)
    reads: int = 0
    bases: int = 0
    batches: int = 0
    # seeding/verification (HIMetrics + WalkMetrics role: the k-mer
    # table replaces LF walks, so "resolves" = table bucket expansions)
    seeds: int = 0            # seed/segment lanes searched
    table_probes: int = 0     # seed-table bucket lookups
    candidates: int = 0       # loci verified
    # DP (SSEMetrics role, aligner_swsse.h:32 — one CUDA kernel
    # instead of 4 SSE variants; cells = lanes * read x window area)
    dp_lanes: int = 0         # gapped-rescue DP lanes
    dp_cells: int = 0         # DP matrix cells computed (estimate)
    rescue_lanes: int = 0     # PE mate-rescue DP lanes
    # spliced alignment (SpliceSiteDB + hybridSearch_recur role)
    splice_lanes: int = 0     # junction pairs scored
    splice_second_lanes: int = 0   # multi-intron chain lanes
    splice_sites_known: int = 0    # baked/known sites in the table
    splice_sites_novel: int = 0    # runtime-published novel sites
    fallback_reads: int = 0   # seed->segment fallback reads
    # reporting (ReportingMetrics, aln_sink.h:51)
    aligned: int = 0
    unaligned: int = 0
    multi: int = 0
    pairs: int = 0
    conc_uniq: int = 0
    conc_multi: int = 0
    disc: int = 0
    mixed_al: int = 0
    sam_records: int = 0
    # per-stage wall time (seconds) — the profile that locates the next
    # bottleneck (reference Timer/-t + PerfMetrics timing role)
    t_pack: float = 0.0       # host read packing + dispatch enqueue
    t_fetch: float = 0.0      # device->host result transfer waits
    t_gather: float = 0.0     # slow-row gather round trips
    t_host: float = 0.0       # host selection + SAM formatting
    t_rescue: float = 0.0     # splice rescue host work

    COLUMNS = ["elapsed", "reads", "bases", "batches", "seeds",
               "table_probes", "candidates",
               "dp_lanes", "dp_cells", "rescue_lanes",
               "splice_lanes", "splice_second_lanes",
               "splice_sites_known", "splice_sites_novel",
               "fallback_reads",
               "aligned", "unaligned", "multi",
               "pairs", "conc_uniq", "conc_multi", "disc", "mixed_al",
               "sam_records", "reads_per_sec", "bases_per_sec",
               "t_pack", "t_fetch", "t_gather", "t_host", "t_rescue",
               "dev_mb", "host_rss_mb"]

    def row(self) -> list:
        el = time.time() - self.start_time
        import torch
        dev_mb = (torch.cuda.max_memory_allocated() // (1 << 20)
                  if torch.cuda.is_available() else 0)
        rss_mb = 0
        try:
            import resource
            rss_mb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss // 1024
        except Exception:
            pass
        return [f"{el:.1f}", self.reads, self.bases, self.batches,
                self.seeds, self.table_probes, self.candidates,
                self.dp_lanes, self.dp_cells, self.rescue_lanes,
                self.splice_lanes, self.splice_second_lanes,
                self.splice_sites_known, self.splice_sites_novel,
                self.fallback_reads, self.aligned, self.unaligned,
                self.multi, self.pairs, self.conc_uniq, self.conc_multi,
                self.disc, self.mixed_al, self.sam_records,
                f"{self.reads / el:.1f}" if el > 0 else "0",
                f"{self.bases / el:.0f}" if el > 0 else "0",
                f"{self.t_pack:.2f}", f"{self.t_fetch:.2f}",
                f"{self.t_gather:.2f}", f"{self.t_host:.2f}",
                f"{self.t_rescue:.2f}", dev_mb, rss_mb]

    def header_line(self) -> str:
        return "\t".join(self.COLUMNS)

    def line(self) -> str:
        return "\t".join(str(x) for x in self.row())


class MetricsSink:
    """--met-file / --met-stderr periodic emitter."""

    def __init__(self, metrics: Metrics, path: str | None = None,
                 stderr: bool = False, interval: float = 1.0):
        import sys
        self.m = metrics
        self.interval = interval
        self.last = 0.0
        self.fhs = []
        if path:
            fh = open(path, "w")
            self.fhs.append(fh)
        if stderr:
            self.fhs.append(sys.stderr)
        for fh in self.fhs:
            fh.write(metrics.header_line() + "\n")

    def tick(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self.last < self.interval:
            return
        self.last = now
        for fh in self.fhs:
            fh.write(self.m.line() + "\n")
            fh.flush()

    def close(self) -> None:
        self.tick(force=True)
        import sys
        for fh in self.fhs:
            if fh is not sys.stderr:
                fh.close()
