"""On the card (skips without one): a cell's short run is correct, and
with the control in the DP kernel's place it is not.

    python -m pytest benchmark/tests/test_bench_chip.py -m chip
"""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def run_cell(*extra):
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "ecoli_se100", "--seed", "2718281828",
                        "--seconds", "5", "--trace", "0", *extra],
                       cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.chip
def test_sound_run_and_control_on_the_card(card):
    res = run_cell()
    assert res["correct"] and res["device"]["kind"] == card
    ctl = run_cell("--plant", "int8")
    assert not ctl["correct"]
    assert ctl["checks"]["dp_wrong"]["value"] > 0
