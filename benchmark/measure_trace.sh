#!/bin/bash
# The chip runs behind PERF.md's readings of the program's own spans and
# the tracer's cost, replayable:
#
#   bash benchmark/measure_trace.sh OTHER PREFIX [OUT]
#
# from the root of a checkout on a machine with the card. OTHER is the
# root of the checkout to compare with (the parent, with this checkout's
# BENCHMARK.json and benchmark/ laid over it); seeds are PREFIX followed
# by two digits; every run's line goes to OUT (chiprun_out/trace.jsonl by
# default). In order: the cost of a span here; a 10 s untraced run on each
# side (each checkout's first: it builds the deployment; the call stops
# if this one is not correct); three traced and three untraced 51 s runs
# of ecoli_se100 on each side in turns, each seed on both sides, the side
# that goes first alternating; then benchmark/run.py --trace 1 once on
# each side, its last line (the result) appended to OUT.runpy.
set -u
OTHER=$(cd "$1" && pwd)
P=$2
OUT=${3:-chiprun_out/trace.jsonl}
mkdir -p "$(dirname "$OUT")"
OUT=$(cd "$(dirname "$OUT")" && pwd)/$(basename "$OUT")
HERE=$(pwd)
W=ecoli_se100
R() {  # checkout seed seconds trace
  (cd "$1" && python3 benchmark/trace_check.py --workload $W --seed $2 \
      --seconds $3 --trace $4 --out "$OUT" 2>> "$OUT.$(basename "$1").err")
  echo "rc=$? $(basename "$1") $2 $3 $4"
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 benchmark/trace_check.py --span-cost
R "$HERE" ${P}00 10 0 | tee /dev/stderr | grep -q '"correct": true' || exit 1
R "$OTHER" ${P}00 10 0
for s in 11 12 13; do
  if [ $s = 12 ]; then A=$HERE; B=$OTHER; else A=$OTHER; B=$HERE; fi
  R "$A" ${P}$s 51 1
  R "$B" ${P}$s 51 1
done
for s in 21 22 23; do
  if [ $s = 22 ]; then A=$OTHER; B=$HERE; else A=$HERE; B=$OTHER; fi
  R "$A" ${P}$s 51 0
  R "$B" ${P}$s 51 0
done
for d in "$HERE" "$OTHER"; do
  (cd "$d" && python3 benchmark/run.py --workload $W --seed ${P}31 \
      --seconds 51 --trace 1 2>> "$OUT.$(basename "$d").err" | tail -n 1 \
      >> "$OUT.runpy")
  echo "rc=$? run.py $(basename "$d") ${P}31 51 1"
done
python3 benchmark/trace_check.py --span-cost
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
