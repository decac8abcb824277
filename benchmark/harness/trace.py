"""The device trace of a `--trace 1` run: torch.profiler over the window,
CUDA activity only (kernels, copies, sets), and what is read from it.

The profiler starts when the window opens and stops once the timed call
has returned and the device is idle. A short spin kernel is launched right
after the start and right before the stop, each from a known instant of
the host's clock: their device times bound the traced window and map
device time onto the host's clock, so each idle gap can be labelled with
the span that was open on the main thread.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

COPY_KINDS = ("gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
SPIN_CYCLES = 20000


@dataclass
class Trace:
    ops: list = field(default_factory=list)   # (name, start_ns, end_ns, kind)
    window: tuple = (0, 0)                    # device ns
    offset: int | None = None                 # device ns - host ns
    kernels: int = 0


class Profiler:
    def __init__(self):
        self.prof = None
        self.marks: list = []                  # host perf_counter_ns

    def _mark(self):
        import torch
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(SPIN_CYCLES)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()

    def stop(self) -> Trace:
        import torch
        self._mark()
        torch.cuda.synchronize()
        self.prof.stop()
        return self._read()

    def _read(self) -> Trace:
        from torch.autograd import DeviceType
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            kind = _kind(e)
            if kind is None:
                continue
            t0 = e.start_ns()
            raw.append((e.name(), t0, t0 + e.duration_ns(), kind))
        raw.sort(key=lambda r: r[1])
        marks = [r for r in raw if MARKER in r[0]]
        tr = Trace()
        if len(marks) >= 2:
            tr.window = (marks[0][2], marks[-1][1])
            tr.offset = marks[0][1] - self.marks[0]
        elif raw:
            tr.window = (raw[0][1], raw[-1][2])
        w0, w1 = tr.window
        tr.ops = [r for r in raw if MARKER not in r[0]
                  and r[2] > w0 and r[1] < w1]
        tr.kernels = sum(1 for r in tr.ops if r[3] == "kernel")
        return tr


def _kind(e) -> str | None:
    """'kernel', a copy kind, or None for what is no device work (user
    annotations, synchronisations)."""
    try:
        act = str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        act = ""
    name = e.name()
    if "memcpy" in act or name.startswith("Memcpy"):
        return "gpu_memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "gpu_memset"
    if "annotation" in act or "sync" in act or "runtime" in act:
        return None
    return "kernel"


def union(intervals, lo, hi) -> list:
    """Merged [start, end) intervals clipped to [lo, hi)."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(tr: Trace) -> int:
    w0, w1 = tr.window
    return sum(b - a for a, b in union([(o[1], o[2]) for o in tr.ops],
                                       w0, w1))


def gaps(tr: Trace) -> list:
    """Idle [start, end) stretches of the window, device ns."""
    w0, w1 = tr.window
    u = union([(o[1], o[2]) for o in tr.ops], w0, w1)
    edges = [w0] + [x for iv in u for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def open_span(spans, t_host: int) -> str:
    """The innermost main-thread span open at host time t_host."""
    best = None
    for tag, main, t0, t1, _nested in spans:
        if main and t0 <= t_host < t1 and (best is None or t0 >= best[0]):
            best = (t0, tag)
    return best[1] if best else "no span"


def breakdown(tr: Trace, spans, n: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each with the main thread's open span at its start."""
    by = {}
    for name, a, b, _k in tr.ops:
        by[name] = by.get(name, 0) + (b - a)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    g = sorted(gaps(tr), key=lambda ab: ab[0] - ab[1])[:n]
    lab = [(open_span(spans, a - tr.offset) if tr.offset is not None
            else "unlabelled", (b - a) / 1e9) for a, b in g]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in lab]}
