"""hisat2_tpu_torch stands alone: every module imports with `jax` blocked,
and none of them pulls in the JAX package."""

import json
import os
import pkgutil
import subprocess
import sys

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
                "hisat2_tpu_torch.align.sharded"):
        assert mod in expected


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
