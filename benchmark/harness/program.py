"""The program's own spans and counters in a `--trace 1` run: the tracer of
hisat2_tpu_torch.utils.metrics, for the per-layer metrics that read what
happens inside the program's calls (benchmark/metrics/, source
`program_span` or `program_counter`).

The tracer goes on just before the timed `cli.align.main`, and only in
traced runs; the spans and counters are read once, after `main` has
returned, by the first of these metrics to be read (`collect`). A program
with no tracer (an older checkout) gives nothing: the harness then skips
these metrics and the line leaves them out.

The seam with harness/cell.py, which knows nothing of the tracer, is one
protocol, and the only one:
  start: each of these metrics names SPANS below; the harness installs
    the SPANS of a traced run's metrics (probes.install_spans) just before
    the timed call, and its attribute lookup of TRIGGER on this module
    (`__getattr__`) starts the tracer;
  stop and read: `collect(ctx)`, from each metric's `read`, after `main`
    has returned; the first call stops the tracer and keeps the result
    for the others (`_last`);
  the breakdown: `collect` appends the program's main-thread spans to
    `ctx.spans`, which is the harness's own list (probes.spans), marked
    nested, so that `trace.breakdown`, which cell.py calls after the
    metrics, labels each idle gap with the innermost span of either;
  reset: each metric module calls `reset()` when the harness loads it,
    at a run's start.
The harness's own sums stay as they were because each of its readers skips
nested spans. Starting the tracer in cell.py itself replaces all of this:
start and stop the tracer there beside the profiler, hand the result to
the readers as `ctx.program`, and join the two span lists only at the
`breakdown` call; TRIGGER, `__getattr__`, `_last` and `reset` then go.

The window opens where the harness's does: the read layer's first
opening of a reads file, just after the harness's wrapper on
io.reads._open_text (which starts the profiler in a traced run); here the
first `input.open` span, which opens inside `_open_text`, within a
`reads` span. Spans that end before it are left out, and that `reads`
span (the read layer's first step, which holds the profiler's start in a
traced run) counts from the opening on, its CPU time too (the span keeps
the thread's CPU clock at its start).
"""

from __future__ import annotations

import sys

TRIGGER = "program_tracer"
SPANS = [("harness.program", TRIGGER, "call", "program")]
_last: list = []            # [(ctx, Program or None)] of this run


def __getattr__(name):
    if name != TRIGGER:
        raise AttributeError(name)
    from hisat2_tpu_torch.utils import metrics
    if not hasattr(metrics, "start_trace"):
        raise AttributeError(name)
    metrics.start_trace()
    return _started


def _started():
    """The value of TRIGGER once made: nothing calls it."""


def reset() -> None:
    """A run's start (each metric's module is loaded anew then): forget
    the last run's trace, and a tracer a failed run left on."""
    vars(sys.modules[__name__]).pop(TRIGGER, None)
    _last.clear()
    from hisat2_tpu_torch.utils import metrics
    if hasattr(metrics, "stop_trace"):
        metrics.stop_trace()


class Program:
    """The window's spans and the counters, per read where asked."""

    def __init__(self, got: dict, reads: int):
        spans = got["spans"]
        ids = {s.id: s for s in spans}
        opens = [s for s in spans if s.name == "input.open"
                 and s.parent in ids and ids[s.parent].name == "reads"]
        if opens:
            o = min(opens, key=lambda s: s.t0)
            first = ids[o.parent]
            spans = [first._replace(
                         t0=o.t0, cpu0=o.cpu0,
                         cpu_ns=first.cpu0 + first.cpu_ns - o.cpu0)
                     if s is first else s
                     for s in spans if s.t1 > o.t0]
        self.spans = spans
        self.counters = got["counters"]
        self.reads = reads

    def wall_ns(self, name: str, main: bool | None = None) -> int:
        return sum(s.t1 - s.t0 for s in self.spans if s.name == name
                   and (main is None or s.main == main))

    def offcpu_ns(self, name: str) -> int:
        """Main-thread wall time less the thread's CPU time in `name`."""
        return sum(s.t1 - s.t0 - s.cpu_ns for s in self.spans
                   if s.name == name and s.main)

    def per_read_us(self, ns: int) -> float | None:
        return ns / 1e3 / self.reads if self.reads else None


def collect(ctx) -> Program | None:
    """The program's trace of this run, read once; None where the program
    has no tracer or nothing was traced."""
    if _last and _last[0][0] is ctx:
        return _last[0][1]
    from hisat2_tpu_torch.utils import metrics
    got = metrics.stop_trace() if hasattr(metrics, "stop_trace") else None
    prog = Program(got, ctx.reads) if got and got["spans"] else None
    _last[:] = [(ctx, prog)]
    if prog is not None:
        ctx.spans.extend((s.name, True, s.t0, s.t1, True)
                         for s in prog.spans if s.main)
    return prog
