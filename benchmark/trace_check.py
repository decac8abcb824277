"""One run of a cell, as benchmark/run.py makes it, with what the program's
own tracer says beside the result: the checks behind PERF.md's readings of
the program's spans.

    python3 benchmark/trace_check.py --workload W --seed N --seconds S \
        --trace 0|1 --out FILE
    python3 benchmark/trace_check.py --span-cost

from the root of a checkout on a machine with the card. The run is
`harness.cell.run`, as in run.py; one JSON line goes to FILE and a short
one to standard output. In a traced run of a program with a tracer the
line adds (`program`):

  coverage: the share of the window's wall time covered by the main
    thread's top-level program spans (`reads`, `submit`, `stream.wait`,
    `stream.write`, and `finish` where it runs on the main thread);
  agree: the program's `reads` and `submit` (main thread) and `finish`
    (every thread) a read, each counted whole (the read layer's first
    step too), beside the harness's wrapper metrics that time the same
    calls from outside;
  per: each span name's wall and thread-CPU time a read, main thread and
    finish threads apart, with its count and longest span;
  counters: the program's counters;
  gaps: the ten longest idle gaps' labels, and whether the profiler's
    spin markers were found (labelled) or not (`unlabelled`).

--span-cost prints the cost of one span, tracing off and on, and of the
two clocks it reads, in ns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import timeit

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def span_cost(n: int = 100000) -> dict:
    from hisat2_tpu_torch.utils import metrics as M

    def per(f):
        return min(timeit.repeat(f, number=n, repeat=3)) / n * 1e9

    m = M.Metrics()

    def plain():
        with M.span("x"):
            pass

    def fed():
        with M.span("x", None, m, "t_host"):
            pass
    out = {"thread_time_ns": per(time.thread_time_ns),
           "perf_counter_ns": per(time.perf_counter_ns),
           "span_off": per(plain), "field_span_off": per(fed)}
    M.start_trace()
    try:
        out["span_on"] = per(plain)
    finally:
        M.stop_trace()
    return out


def covered(spans, lo: int, hi: int) -> int:
    """ns of [lo, hi) inside the union of the spans."""
    tot, cur = 0, None
    for a, b in sorted((max(s.t0, lo), min(s.t1, hi)) for s in spans):
        if b <= a:
            continue
        if cur and a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            tot += cur[1] - cur[0] if cur else 0
            cur = [a, b]
    return tot + (cur[1] - cur[0] if cur else 0)


def program_figures(prog, raw: dict, result: dict) -> dict:
    reads = prog.reads
    sp = prog.spans
    m = {k: v["value"] for k, v in result["metrics"].items()}
    t_open = min(s.t0 for s in sp if s.name == "input.open")
    w_ns = result["info"]["window_s"] * 1e9
    top = [s for s in sp if s.main and s.parent is None]
    per = {}
    for name in sorted({s.name for s in sp}):
        for side, main in (("main", True), ("workers", False)):
            ss = [s for s in sp if s.name == name and s.main == main]
            if ss:
                per[f"{name}@{side}"] = {
                    "n": len(ss),
                    "wall_us_per_read": sum(s.t1 - s.t0 for s in ss)
                    / 1e3 / reads,
                    "cpu_us_per_read": sum(s.cpu_ns for s in ss) / 1e3 / reads,
                    "max_ms": max(s.t1 - s.t0 for s in ss) / 1e6}

    def whole(name, main_only):
        return sum(s.t1 - s.t0 for s in raw["spans"] if s.name == name
                   and (s.main or not main_only)) / 1e3 / reads
    return {
        "reads": reads, "window_s": w_ns / 1e9,
        "coverage": covered(top, t_open, t_open + int(w_ns)) / w_ns,
        "agree": {
            "reads": [whole("reads", True), m.get("reads.parse_us_per_read")],
            "submit": [whole("submit", True),
                       m.get("pipeline.submit_us_per_read")],
            "finish": [whole("finish", False),
                       m.get("emit.finish_us_per_read")]},
        "per": per, "counters": prog.counters}


def run_one(workload: str, seed: int, seconds: float, trace: bool,
            out: str, device: str = "cuda", **cell_kw) -> dict:
    """One cell.run, its line (with the program's figures) appended to
    `out`; returns the line. `cell_kw` goes to cell.run (the tests' small
    deployments)."""
    from harness import cell, program
    raw = {}
    try:                      # keep the trace as the program hands it over
        from hisat2_tpu_torch.utils import metrics as M
        stop = M.stop_trace

        def keep():
            got = stop()
            if got:
                raw.update(got)
            return got
        M.stop_trace = keep
    except (ImportError, AttributeError):
        stop = None
    t0 = time.time()
    try:
        result, _ = cell.run(workload, seed, seconds, trace, device, None,
                             **cell_kw)
    finally:
        if stop is not None:
            M.stop_trace = stop
    line = {"checkout": ROOT, "seed": seed, "trace": int(trace),
            "wall": time.time() - t0, "result": result}
    prog = program._last[0][1] if program._last else None
    if prog is not None and raw:
        line["program"] = program_figures(prog, raw, result)
    with open(out, "a") as fh:
        fh.write(json.dumps(line) + "\n")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path[:0] = [HERE, ROOT]
    import run as benchrun
    benchrun.setup_env()
    if args.span_cost:
        print(json.dumps({"checkout": ROOT, "span_cost_ns": span_cost()}),
              flush=True)
        return 0
    line = run_one(args.workload, args.seed, args.seconds, bool(args.trace),
                   args.out)
    result, prog = line["result"], line.get("program", {})
    print(json.dumps({
        "checkout": os.path.basename(ROOT), "seed": args.seed,
        "trace": args.trace, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "gaps": result.get("breakdown", {}).get("idle_gaps"),
        "coverage": prog.get("coverage"), "agree": prog.get("agree")}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
