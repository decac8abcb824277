"""No module of JAX or of the JAX package in a run's process, and the
reference loads nothing of the program."""

import os
import subprocess
import sys

import run as bench_run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_forbidden_names_compare_whole_top_level(monkeypatch):
    mods = dict(sys.modules)
    for name in ("hisat2_tpu_torch", "hisat2_tpu_torch.align.emit",
                 "jax_like", "myjax"):
        mods.setdefault(name, object())
    monkeypatch.setattr(sys, "modules", mods)
    assert bench_run.forbidden_modules() == []
    mods["hisat2_tpu.ops"] = object()
    mods["jaxlib.xla_client"] = object()
    assert bench_run.forbidden_modules() == ["hisat2_tpu", "jaxlib"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=f"{BENCH}:{ROOT}"))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    mods = _loaded(
        "import sys, run\n"
        "from harness import cell, deploy, traffic, probes, plants, trace\n"
        "import hisat2_tpu_torch.cli.align, hisat2_tpu_torch.cli.build\n"
        "import hisat2_tpu_torch.align.paired_rna\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not mods & {"jax", "jaxlib", "flax", "hisat2_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _loaded(
        "import sys\n"
        "from reference import check, samcheck, dp, anchor\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not mods & {"jax", "jaxlib", "flax", "hisat2_tpu",
                       "hisat2_tpu_torch"}
