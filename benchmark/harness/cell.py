"""One run of one cell, once the caller has checked for the card.

set-up (counted in setup_s, from the process's start):
  the deployment (genome, annotations, index; built on a checkout's first
  run); the run's reads, gzip members drawn from the run's seed by a
  process of their own (harness/poolgen.py) while this one warms up; a
  warm-up call of cli.align.main on the warm-up index and reads (builds
  the kernels, loads the native libraries); the timed call's own index
  load and Aligner, up to the read layer's first opening of the reads
  pipe.
window:
  cli.align.main(argv) as a user runs hisat2: reads come through named
  pipes under TMPDIR from the feeder process, the SAM goes to a pipe that
  the sink process drains. The window opens when the read layer opens the
  pipe and closes when main returns, drain included.
after the window:
  memory peak, the reference's numbers, the per-layer metrics (trace runs).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import deploy
from .probes import Probes

BENCH = deploy.BENCH
ROOT = deploy.ROOT
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start, seconds since the epoch (from /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    stat = open("/proc/self/stat").read()
    start = int(stat[stat.rindex(")") + 2:].split()[19])
    btime = next(int(ln.split()[1]) for ln in open("/proc/stat")
                 if ln.startswith("btime"))
    return btime + start / ticks


def load_spec(bench_json: str, workload: str):
    spec = json.load(open(bench_json))
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in {bench_json}")
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    metrics = [m for m in spec["per_layer"]
               if workload in m.get("workloads", [workload])]
    return spec, cell, cfg, metrics


def load_metric(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def reads_args(files: list) -> list:
    return (["-U", files[0]] if len(files) == 1
            else ["-1", files[0], "-2", files[1]])


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", plant: str | None = None,
        bench_json: str | None = None, cache: str = deploy.CACHE,
        data: str = BENCH) -> tuple[dict, dict]:
    """Returns (the result line's object, the checks beside their limits).
    `data` holds the traffic/ and limits/ directories (the tests give
    their own small ones)."""
    t_start = process_start()
    bench_json = bench_json or os.path.join(ROOT, "BENCHMARK.json")
    spec, cell, cfg_entry, metric_specs = load_spec(bench_json, workload)
    cfg_path = os.path.join(ROOT, cfg_entry["file"])
    tpath = os.path.join(data, "traffic", f"{cell['traffic']}.json")
    t = json.load(open(tpath))
    limits = json.load(open(os.path.join(
        data, "limits", f"{workload}.json")))["limits"]
    metrics = {m["name"]: load_metric(m["name"]) for m in metric_specs}

    import torch
    from hisat2_tpu_torch.cli import align as cli_align
    from hisat2_tpu_torch.ops import nvcc

    marks = {"imports": time.time()}      # set-up's parts, as it goes
    dep = deploy.load(cell["config"], cfg_path, cache, log)
    warm_files = deploy.warm_pool(dep, cell["traffic"], tpath)
    rng = np.random.default_rng(seed)
    n_pool, per = int(t["pool"]), int(t["member"])
    pool_seed = int(rng.integers(1 << 62))
    sample = np.sort(rng.choice(n_pool, min(int(t["sample"]), n_pool),
                                replace=False))
    tmp = tempfile.mkdtemp(prefix="bench-")
    procs = []
    probes = Probes(int(rng.integers(1 << 62)), trace)
    prof = None
    try:
        pool_dir = os.path.join(tmp, "pool")
        os.mkdir(pool_dir)
        np.save(os.path.join(tmp, "sample.npy"), sample)
        maker = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "poolgen.py"), cell["config"],
             cfg_path, cache, tpath, str(pool_seed),
             os.path.join(tmp, "sample.npy"), pool_dir])
        procs.append(maker)
        warm_fq = []
        for m, f in enumerate(warm_files):        # the program reads .gz
            p = os.path.join(tmp, f"warm_{m + 1}.fq.gz")
            os.symlink(f, p)
            warm_fq.append(p)
        dev_args = ["--device", "cpu"] if device == "cpu" else []
        align_args = list(dep.cfg.get("align_args", []))

        # warm-up: the same entry on the small index
        marks["deployment"] = time.time()
        rc = cli_align.main(["-x", dep.warm_index, *reads_args(warm_fq),
                             "-S", os.path.join(tmp, "warm.sam"),
                             *align_args, *dev_args])
        if rc != 0:
            raise RuntimeError(f"warm-up cli.align.main returned {rc}")
        if device == "cuda":
            torch.cuda.synchronize()
        os.unlink(os.path.join(tmp, "warm.sam"))

        # the run's reads, pipes, probes, feeder and sink
        marks["warmup"] = time.time()
        if maker.wait() != 0:
            raise RuntimeError(f"poolgen.py exited {maker.returncode}")
        procs.remove(maker)
        pool = deploy.sampled(t, sample, pool_dir)
        pool_files = [os.path.join(pool_dir, f"mate_{m + 1}.bin")
                      for m in range(pool.mates)]
        names = os.path.join(tmp, "sample.txt")
        with open(names, "w") as fh:
            fh.write("\n".join(pool.names) + "\n")
        probes.install_open()
        probes.install_kernels(plant, device)
        if trace:
            probes.install_spans([s for m in metrics.values()
                                  for s in m.SPANS])
            if device == "cuda":
                from .trace import Profiler
                prof = Profiler()
                probes.on_open = prof.start
        fifos = [os.path.join(tmp, f"reads_{m + 1}.fq.gz")
                 for m in range(pool.mates)]
        sam = os.path.join(tmp, "out.sam")
        for p in fifos + [sam]:
            os.mkfifo(p)
        sink_res = os.path.join(tmp, "sink.json")
        feed_res = os.path.join(tmp, "feeder.json")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "sink.py"), sam, names,
             sink_res]))
        feed_argv = [str(seconds), feed_res]
        for pf, ff in zip(pool_files, fifos):
            feed_argv += [pf, ff]
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "feeder.py"), *feed_argv]))

        marks["reads"] = time.time()
        probes.armed = True
        rc = cli_align.main(["-x", dep.index, *reads_args(fifos), "-S", sam,
                             *align_args, *dev_args])
        t_end = (time.time(), time.perf_counter_ns())
        ru_end = resource.getrusage(resource.RUSAGE_SELF)
        if rc != 0:
            raise RuntimeError(f"timed cli.align.main returned {rc}")
        tr = prof.stop() if prof is not None else None
        for p in procs:
            p.wait(timeout=120)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"feeder/sink exited "
                               f"{[p.returncode for p in procs]}")
        sink = json.load(open(sink_res))
        feed = json.load(open(feed_res))
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        probes.restore()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t_open = probes.t_open
        window_s = t_end[0] - t_open[0] if t_open else float("nan")
        sent = int(sum(feed["reads"]))
        # the sampled reads that went out (a short window may stop before
        # the pool's last member)
        went = np.flatnonzero(sample < int(feed["members"]) * per)
        numbers = check_numbers(dep, pool, went, sink, sent, probes, device)
        from reference.check import judge
        correct, checks = judge(numbers, limits)
        setup_s = t_open[0] - t_start
        # a read counts once, however many primary records it came back with
        done = min(sink["primary"], sent)
        e2e = {"reads_per_s": {"value": done / window_s,
                               "unit": "reads/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
        result = {"correct": correct, "attempted": sent,
                  "failed": max(0, sent - sink["primary"]),
                  "metrics": {}, "device": device_info(device, peak)}
        wanted = {m["name"] for m in spec["end_to_end"]
                  if workload in m.get("workloads", [workload])}
        if not trace:
            result["metrics"] = {k: v for k, v in e2e.items()
                                 if k in wanted}
        else:
            ctx = Context(done, probes, tr)
            units = {m["name"]: m["unit"] for m in metric_specs}
            for name, mod in metrics.items():
                if any(tuple(s[:2]) in probes.missing for s in mod.SPANS):
                    continue
                v = mod.read(ctx)
                if v is not None:
                    result["metrics"][name] = {"value": v,
                                               "unit": units[name]}
            if tr is not None:
                from .trace import breakdown, busy_ns
                w0, w1 = tr.window
                result["device"]["busy_s"] = busy_ns(tr) / 1e9
                result["device"]["window_s"] = (w1 - w0) / 1e9
                result["breakdown"] = breakdown(tr, probes.spans)
        result["info"] = {
            "window_s": window_s, "reads": sink["primary"],
            "records": sink["records"], "setup_s": setup_s,
            "dp_calls": probes.dp_calls, "anchor_calls": probes.anchor_calls,
            "members": feed["members"], "index_bytes": dep.index_bytes,
            "setup_parts": setup_parts(t_start, marks, t_open, nvcc),
            "cpu_s": (ru_end.ru_utime + ru_end.ru_stime
                      - probes.ru_open.ru_utime - probes.ru_open.ru_stime),
            "first_bad": numbers.get("first_bad"),
            "compared": {k: numbers.get(k) for k in (
                "dp_compared", "anchor_compared", "records_checked",
                "reads_checked")}}
        result["checks"] = checks
        return result, checks
    finally:
        probes.restore()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def setup_parts(t_start, marks, t_open, nvcc) -> dict:
    """setup_s cut at its marks: the interpreter and imports; the cached
    deployment and warm-up reads; the warm-up call (nvcc's wall seconds
    a source beside it); the wait for the run's reads and the pipes'
    start; the timed call's index load and Aligner up to the pipe's
    opening."""
    t = [t_start, *marks.values(), t_open[0] if t_open else float("nan")]
    parts = dict(zip([*marks, "index_load"], np.diff(t).tolist()))
    parts["nvcc"] = {os.path.basename(k): v for k, v in nvcc.seconds.items()}
    return parts


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, reads, probes, trace):
        self.reads = reads
        self.spans = probes.spans
        self.trace = trace
        self.dp_shapes = [(C, L, W, ov, lens.cpu().numpy())
                          for C, L, W, ov, lens in probes.dp_shapes]


def check_numbers(dep, pool, sample, sink, sent, probes, device) -> dict:
    from reference import check, samcheck
    known = samcheck.Known(dep.variants, dep.genes)
    out = {"missing": max(0, sent - sink["primary"]),
           "extra": max(0, sink["primary"] - sent)}
    w, n = check.dp_wrong(probes.dp_kept, device)
    out.update(dp_wrong=w if n else None, dp_compared=n)
    if dep.genes is not None:
        w, n = check.anchor_wrong(probes.anchor_kept, dep.genome)
        out.update(anchor_wrong=w if n else None, anchor_compared=n)
    rec = check.records(sink["kept"], pool, sample, dep.genome, known)
    out.update(rec)
    if not rec["records_checked"]:
        out["records_wrong"] = None
    return out


def device_info(device: str, peak: int) -> dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
