"""Runs of one cell in a row, each a new process of run.py, and their
spread: how the bounds and limits in PERF.md were measured.

    python3 benchmark/sets.py --workload NAME --seconds S \
        --seeds 11,12,13 [--trace 1] [--plant NAME] [--out FILE.jsonl]

Each run's seed, exit code, wall seconds, result line and the end of its
standard error go to FILE.jsonl (one line a run); the summary printed at
the end gives, for each metric, the median and the spread (the distance
between the first and the third quartile, statistics.quantiles(n=4), over
the median), and each check's readings. The card's name and power limit
come first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--plant", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    rows = []
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds.split(","):
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds", args.seconds,
               "--trace", args.trace]
        if args.plant:
            cmd += ["--plant", args.plant]
        t0 = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.time() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        row = {"seed": int(seed), "rc": p.returncode, "wall_s": wall,
               "plant": args.plant, "result": res,
               "stderr": p.stderr[-3000:]}
        rows.append(row)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        short = ({k: v["value"] for k, v in res["metrics"].items()}
                 if res else None)
        checks = ({k: v["value"] for k, v in res["checks"].items()}
                  if res else None)
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f} correct "
              f"{res and res['correct']} metrics {short} checks {checks}",
              flush=True)
        if res is None:
            print(p.stderr[-2000:], flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        print(f"summary {k} n {len(vals)} median {statistics.median(vals)} "
              f"spread {spread(vals)} values {vals}")
    for k in sorted({k for r in ok for k in r["checks"]}):
        vals = [r["checks"][k]["value"] for r in ok]
        print(f"readings {k} {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
