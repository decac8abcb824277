"""Alignment metrics counters (reference PerfMetrics/--met role,
hisat2.cpp:2076: periodic tab-table of internal counters), and the
program's tracer.

The reference merges per-thread metric structs under a mutex every 16
reads; here counters are naturally batch-granular — each pipeline stage
bumps them once per batch.

The tracer is off unless `start_trace()` was called; `stop_trace()`
turns it off and returns what it kept. `span(name, batch)` marks one
stage of one batch (never one read): with the tracer on it records the
span's name, the batch's sequence number, the innermost span open on the
same thread (its parent), the thread, its start and end on
`time.perf_counter_ns()` and the thread's CPU clock at its start and over
it (`time.thread_time_ns()`); with it off, and no Metrics field named, it is
one shared no-op. A span that names a Metrics field (`t_fetch`, ...) adds
its time to that field whether or not the tracer is on, less the time of
the field-naming spans nested in it on its thread, so the `t_*` columns
never count one second twice. `count(name, n)` adds to an integer
counter kept beside the spans; `count_device(name, x)` adds a scalar
tensor to one kept on its device, read once by `stop_trace` (work that the
device step works out, counted with no synchronisation); `count_process`
to one kept for the whole process, tracing or not (set-up work, such as
the kernel builds).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

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
    candidates: int = 0       # loci verified (from the options)
    # DP (SSEMetrics role, aligner_swsse.h:32 — one CUDA kernel
    # instead of 4 SSE variants; cells = lanes * read x window area)
    dp_lanes: int = 0         # gapped-rescue DP lanes
    dp_cells: int = 0         # DP matrix cells computed: never set
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
    # candidates and dp_cells keep the values hisat2_tpu gives them (the
    # count from the options, and 0): the --met-file parity tests hold
    # every column but the timing and memory ones equal to its table.
    # Per-stage wall time (seconds) — the profile that locates the next
    # bottleneck (reference Timer/-t + PerfMetrics timing role), each
    # fed by the spans that name it. Summed over the threads that run
    # finishes: with three finish threads t_fetch + t_gather + t_host
    # can exceed the elapsed time.
    t_pack: float = 0.0       # submit: packing (a per-base-quality pair
    #                           batch's too, before it leaves for the
    #                           fused step), uploads, queueing, copies
    t_fetch: float = 0.0      # finish: waits for the step's host copies
    t_gather: float = 0.0     # finish: waits for slow-row gathers
    t_host: float = 0.0       # finish: the rest (selection, SAM, ladder)
    t_rescue: float = 0.0     # spliced PE finish: the splice rescue rounds

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


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    name: str
    batch: int | None     # the batch's sequence number in this trace
    id: int
    parent: int | None    # the innermost span open on the same thread
    thread: int
    main: bool            # on the main thread
    t0: int               # time.perf_counter_ns()
    t1: int
    cpu0: int             # time.thread_time_ns() at the start
    cpu_ns: int           # the thread's CPU time over the span


class Tracer:
    """What one start_trace .. stop_trace keeps."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.device: dict = {}        # count_device's tensors
        self.lock = threading.Lock()
        self.main = threading.main_thread().ident
        self.ids = itertools.count()
        self.batches = itertools.count()

    def batch_no(self, obj) -> int:
        """The sequence number of a batch object (a ReadBatch), given the
        first time a span names it."""
        n = obj.__dict__.get("_trace_no")
        if n is None or n[0] is not self:
            n = obj._trace_no = (self, next(self.batches))
        return n[1]


_tracer: Tracer | None = None
PROCESS: dict[str, int] = {}      # count_process's counters
_lock = threading.Lock()
_local = threading.local()        # .st: this thread's open spans


def start_trace() -> None:
    """Turn the tracer on (a no-op while it is on)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()


def stop_trace() -> dict | None:
    """Turn the tracer off. Returns {"spans": [Span], "counters": {name:
    int}} (the process's counters among them), or None if it was off."""
    global _tracer
    t, _tracer = _tracer, None
    if t is None:
        return None
    dev = {k: int(v.item()) for k, v in t.device.items()}
    with _lock:
        return {"spans": t.spans,
                "counters": {**t.counters, **dev, **PROCESS}}


def tracing() -> bool:
    """Whether the tracer is on: a site whose count costs work asks first."""
    return _tracer is not None


def count(name: str, n: int = 1) -> None:
    t = _tracer
    if t is not None:
        with t.lock:
            t.counters[name] = t.counters.get(name, 0) + n


def count_device(name: str, x) -> None:
    """Add the scalar tensor x to the counter `name`, on x's device."""
    t = _tracer
    if t is not None:
        with t.lock:
            acc = t.device.get(name)
            if acc is None:
                t.device[name] = x.clone()
            else:
                acc += x


def count_process(name: str, n: int = 1) -> None:
    with _lock:
        PROCESS[name] = PROCESS.get(name, 0) + n


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_batch(self, obj) -> None:
        pass


_NOOP = _Noop()


def span(name: str, batch=None, metrics: Metrics | None = None,
         field: str | None = None):
    """A context manager around one stage of one batch. `batch` is the
    batch object (its mate-1 batch for pairs), or None to take the
    parent's; `metrics`/`field` name the Metrics field the span feeds."""
    t = _tracer
    if t is None and field is None:
        return _NOOP
    return _Span(t, name, batch, metrics, field)


class _Span:
    __slots__ = ("tr", "name", "bno", "m", "field", "up", "id", "t0", "c0",
                 "fed_ns")

    def __init__(self, tr, name, batch, metrics, fld):
        self.tr, self.name, self.m, self.field = tr, name, metrics, fld
        self.bno = None if tr is None or batch is None else tr.batch_no(batch)
        self.fed_ns = 0          # time of the field spans nested in it

    def set_batch(self, obj) -> None:
        """Name the span's batch once it exists (the read layer's)."""
        if self.tr is not None:
            self.bno = self.tr.batch_no(obj)

    def __enter__(self):
        st = getattr(_local, "st", None)
        if st is None:
            st = _local.st = []
        self.up = st[-1] if st else None
        st.append(self)
        if self.tr is not None:
            self.id = next(self.tr.ids)
            if self.bno is None and self.up is not None:
                self.bno = self.up.bno
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.st.pop()
        if self.field is not None:
            ns = t1 - self.t0
            setattr(self.m, self.field,
                    getattr(self.m, self.field) + (ns - self.fed_ns) / 1e9)
            up = self.up
            while up is not None and up.field is None:
                up = up.up
            if up is not None:
                up.fed_ns += ns
        tr = self.tr
        if tr is not None:
            up = self.up
            parent = up.id if up is not None and up.tr is tr else None
            th = threading.get_ident()
            tr.spans.append(Span(self.name, self.bno, self.id, parent, th,
                                 th == tr.main, self.t0, t1, self.c0,
                                 time.thread_time_ns() - self.c0))
        return False
