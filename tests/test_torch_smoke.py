"""chip_smoke.py's read simulator and SAM checks, driven through the port
on the CPU at a small size; and its refusal to run without a card."""

import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from hisat2_tpu_torch.align.pipeline import Aligner
from hisat2_tpu_torch.index.fm_index import build_fm_index
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.utils import alphabet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_path_checks_on_cpu():
    g = np.random.default_rng(3).integers(0, 4, 48000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrS": alphabet.decode(g)}))
    seqs, starts, indel = chip_smoke.simulate_reads(fm.ref.joined, 512, 5)
    assert seqs.shape == (512, chip_smoke.RDLEN) and 5 < indel.sum() < 60
    batches = chip_smoke.make_batches(seqs, 0, 256)
    assert [len(b) for b in batches] == [256, 256]
    al = Aligner(fm, device="cpu")
    text, stats = chip_smoke.run_stream(al, batches, fm.ref)
    assert stats["reads"] == 512
    rate, true_rate, indel_rate = chip_smoke.check_sam(text, 512, starts,
                                                       indel)
    assert rate >= 0.9 and true_rate >= 0.95 and indel_rate > 0.5


def test_dp_case_generator():
    rd, quals, lens, ref = chip_smoke.make_dp_case(0, 24, 60, 92)
    assert rd.shape == (24, 60) and ref.shape == (24, 92)
    assert lens[4] == 0 and lens[5] == 1 and (ref[2] == 4).all()


def test_refuses_without_card(tmp_path):
    """Without CUDA the script fails before printing any result, and a
    copy standing alone (no package beside it) fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src, \
                    open(script, "w") as dst:
                dst.write(src.read())
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
