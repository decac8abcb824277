"""The SE path on the card against the same path on the CPU (plain
versions of the kernels): identical SAM bytes. Skips where CUDA is
absent; the DP kernel's own card tests are in tests/test_torch_dp.py."""

import io

import numpy as np
import pytest
import torch

from hisat2_tpu_torch.align.emit import align_and_emit_stream
from hisat2_tpu_torch.align.pipeline import Aligner
from hisat2_tpu_torch.index.fm_index import build_fm_index
from hisat2_tpu_torch.io import sam as samio
from hisat2_tpu_torch.io.reads import Read, batchify
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.ops import dp_cuda
from hisat2_tpu_torch.utils import alphabet


@pytest.mark.gpu
def test_se_sam_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the SE path on the card needs one")
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrG": alphabet.decode(g)}))
    reads = []
    for i in range(512):
        s = int(rng.integers(0, g.size - 110))
        r = g[s:s + 100].copy()
        if i % 10 == 0:                       # a 2 bp deletion
            r = np.concatenate([g[s:s + 50], g[s + 52:s + 102]])
        m = rng.random(100) < 0.02
        r[m] = (r[m] + 1) % 4
        if i % 2:
            r = alphabet.revcomp(r)
        reads.append(Read(f"q{i}", r, rng.integers(5, 41, 100).astype(
            np.int8), i))
    batches = [batchify(reads[:256], pad_to=104),
               batchify(reads[256:], pad_to=104)]

    def sam(device):
        buf = io.StringIO()
        al = Aligner(fm, device=device)
        align_and_emit_stream(al, batches, samio.SamWriter(
            buf, fm.ref.names, [int(x) for x in fm.ref.tlens], no_head=True))
        return buf.getvalue()
    before = dp_cuda.launches["dp_score"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == sam("cpu")
