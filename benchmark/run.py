"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout on a machine with an NVIDIA card. The cell
(BENCHMARK.json's `workloads`) names a configuration (benchmark/configs/)
and a traffic mix (benchmark/traffic/); its limits are in
benchmark/limits/. The window drives hisat2_tpu_torch.cli.align.main on
gzipped FASTQ from named pipes (harness/cell.py). The last line of
standard output is the result as one JSON object; the numbers that decide
`correct` are the last lines of standard error, each beside its limit.

Exits 2 without a result when the card or the program is missing, 3 when a
module of JAX or of the JAX package was loaded, 1 when the run fails.
`--plant NAME` puts the correctness check's control or one of its faults
in the program's place (harness/plants.py); the benchmark's own runs never
pass it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hisat2_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: hisat2_tpu_torch is not hisat2_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def setup_env() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX on their own."""
    cache = os.path.join(HERE, "_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    setup_env()
    from harness import plants
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--plant", default=None, choices=plants.PLANTS,
                    help="the control or a fault (harness/plants.py)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "hisat2_tpu_torch")):
        print("bench: the program (hisat2_tpu_torch/) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("bench: no CUDA device; this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    from harness import cell
    try:
        result, checks = cell.run(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", args.plant)
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"bench: loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    print_checks(checks, result["info"]["first_bad"])
    print(json.dumps(result))
    return 0


def print_checks(checks: dict, first_bad) -> None:
    if first_bad:
        print(f"first wrong record: {first_bad}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()


if __name__ == "__main__":
    sys.exit(main())
