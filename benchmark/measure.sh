#!/bin/bash
# The chip runs that set a cell's bounds and limits (PERF.md), replayable:
#
#   bash benchmark/measure.sh WORKLOAD PREFIX
#
# from the root of a checkout on a machine with the card, in the
# environment a user has (nothing set). Seeds are PREFIX followed by two
# digits. In order: one 10 s run (the checkout's first: it builds the
# deployment; the call stops if it is not correct), two sets of the same
# six seeds at 51 s (the spreads), three traced runs at 51 s (the
# per-layer metrics and the breakdown), three more seeds at 10 s
# (`correct` on a dozen seeds), and the control (--plant int8) on three
# seeds at 10 s. Every run's line goes to chiprun_out/WORKLOAD.jsonl.
set -u
W=$1
P=$2
B="python3 benchmark/sets.py --workload $W --out chiprun_out/$W.jsonl"
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
$B --seconds 10 --seeds ${P}00 | tee /dev/stderr | grep "correct True" >/dev/null \
    || exit 1
$B --seconds 51 --seeds ${P}01,${P}02,${P}03,${P}04,${P}05,${P}06
$B --seconds 51 --seeds ${P}01,${P}02,${P}03,${P}04,${P}05,${P}06
$B --seconds 51 --trace 1 --seeds ${P}11,${P}12,${P}13
$B --seconds 10 --seeds ${P}14,${P}15,${P}16
$B --seconds 10 --plant int8 --seeds ${P}21,${P}22,${P}23
