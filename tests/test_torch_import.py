"""hisat2_tpu_torch stands alone: every module imports with `jax` blocked,
and none of them pulls in the JAX package."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import hisat2_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import hisat2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hisat2_tpu_torch.__path__,
                                               "hisat2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
jax_pkg = sorted(m for m in sys.modules
                 if m == "hisat2_tpu" or m.startswith("hisat2_tpu."))
print(json.dumps({"modules": names, "jax_package": jax_pkg}))
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["jax_package"] == []
    expected = [m.name for m in pkgutil.walk_packages(
        hisat2_tpu_torch.__path__, "hisat2_tpu_torch.")]
    assert got["modules"] == expected
    for mod in ("hisat2_tpu_torch.ops.dp_cuda",
                "hisat2_tpu_torch.ops.anchor_cuda",
                "hisat2_tpu_torch.ops.nvcc",
                "hisat2_tpu_torch.ops.locate",
                "hisat2_tpu_torch.ops.wire",
                "hisat2_tpu_torch.align.emit",
                "hisat2_tpu_torch.align.paired",
                "hisat2_tpu_torch.align.paired_rna",
                "hisat2_tpu_torch.index.fm_index",
                "hisat2_tpu_torch.index.graph_index",
                "hisat2_tpu_torch.io.annotations",
                "hisat2_tpu_torch.io.ht2",
                "hisat2_tpu_torch.ops.splice",
                "hisat2_tpu_torch.ops.splice_host",
                "hisat2_tpu_torch.align.splice_db",
                "hisat2_tpu_torch.align.splice_model",
                "hisat2_tpu_torch.index.repeats",
                "hisat2_tpu_torch.index.sharded",
                "hisat2_tpu_torch.align.sharded",
                "hisat2_tpu_torch.align.policy",
                "hisat2_tpu_torch.api",
                "hisat2_tpu_torch.cli",
                "hisat2_tpu_torch.cli.align",
                "hisat2_tpu_torch.cli.build",
                "hisat2_tpu_torch.cli.inspect",
                "hisat2_tpu_torch.cli.repeat",
                "hisat2_tpu_torch.tools",
                "hisat2_tpu_torch.tools.gtf",
                "hisat2_tpu_torch.tools.extract_splice_sites",
                "hisat2_tpu_torch.tools.extract_exons",
                "hisat2_tpu_torch.tools.extract_snps",
                "hisat2_tpu_torch.tools.simulate_reads",
                "hisat2_tpu_torch.tools.read_statistics",
                "hisat2_tpu_torch.tools.scale_validate",
                "hisat2_tpu_torch.tools.scale_rna_validate",
                "hisat2_tpu_torch.parallel",
                "hisat2_tpu_torch.parallel.mesh",
                "hisat2_tpu_torch.parallel.multihost"):
        assert mod in expected


_HELP = r"""
import runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises
mod = sys.argv[1]
sys.argv = [mod, "--help"]
runpy.run_module(mod, run_name="__main__")
"""


@pytest.mark.parametrize("cli", ["align", "build", "inspect", "repeat"])
def test_cli_help_without_jax(cli):
    """python -m hisat2_tpu_torch.cli.<cli> --help runs with jax blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _HELP,
                           f"hisat2_tpu_torch.cli.{cli}"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage: hisat2-tpu-torch")
    if cli == "align":
        assert "--device {cuda,cpu}" in proc.stdout


_TOOL_HELP = r"""
import runpy, sys
for blocked in ("jax", "bench", "hisat2_tpu"):
    sys.modules[blocked] = None    # importing any of them now raises
mod = sys.argv[1]
sys.argv = [mod, "--help"]
runpy.run_module(mod, run_name="__main__")
"""


@pytest.mark.parametrize("tool", ["scale_validate", "scale_rna_validate"])
def test_scale_tools_help_without_jax(tool):
    """python -m hisat2_tpu_torch.tools.<tool> --help runs with jax, the
    JAX package and bench.py blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _TOOL_HELP,
                           f"hisat2_tpu_torch.tools.{tool}"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(
        f"usage: python -m hisat2_tpu_torch.tools.{tool}")
    assert "--device {cuda,cpu}" in proc.stdout
    assert "--cache CACHE" in proc.stdout


def test_sources_never_name_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports hisat2_tpu
    or jax (a text check, so imports inside functions count too)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "hisat2_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for ln in fh:
                s = ln.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert not (mod == "jax" or mod.startswith("jax.")
                                or mod == "hisat2_tpu"
                                or mod.startswith("hisat2_tpu.")), \
                        f"{path}: {s}"
