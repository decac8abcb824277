"""The SE path on the card against the same path on the CPU (plain
versions of the kernels): identical SAM bytes, on the table index and on
every FM configuration (no table; sampled SA; seed_mode=False, SE and PE;
the paired-k-mer and stride-sampled table modes). Skips where CUDA is
absent; the DP kernel's own card tests are in tests/test_torch_dp.py."""

import io

import numpy as np
import pytest
import torch

import chip_smoke
from hisat2_tpu_torch.align.emit import (align_and_emit_pe_stream,
                                         align_and_emit_stream)
from hisat2_tpu_torch.align.paired import align_pairs, pairs_to_sam
from hisat2_tpu_torch.align.pipeline import (Aligner, AlignerOpts,
                                             results_to_sam)
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


@pytest.mark.gpu
@pytest.mark.parametrize("name,seed_mode,how", [
    ("A", True, "stream"), ("B", True, "stream"), ("pair", True, "stream"),
    ("stride2", True, "stream"), ("A", False, "stream"),
    ("T", False, "stream"), ("A", False, "align_batch"),
    ("B", False, "align_batch"), ("A", True, "pe"), ("A", False, "pe"),
    ("A", False, "align_pairs")])
def test_fm_sam_on_card_equals_cpu(name, seed_mode, how):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the FM paths on the card need one")
    rng = np.random.default_rng(10)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrG": alphabet.decode(g)}))
    if name != "T":
        fm = chip_smoke.fm_variants(fm)[name]

    def mk(i, s, rc):
        r = g[s:s + 100].copy()
        if i % 10 == 0:                       # a 2 bp deletion
            r = np.concatenate([g[s:s + 50], g[s + 52:s + 102]])
        m = rng.random(100) < 0.02
        r[m] = (r[m] + 1) % 4
        if i % 13 == 0:
            r[::9] = 4
        return alphabet.revcomp(r) if rc else r
    q = np.full(100, 40, np.int8)
    starts = rng.integers(0, g.size - 700, 256)
    b1 = batchify([Read(f"q{i}", mk(i, int(s), i % 2 == 1), q, i)
                   for i, s in enumerate(starts)], pad_to=104)
    b2 = batchify([Read(f"q{i}", mk(i + 5, int(s) + 250, i % 2 == 0), q, i)
                   for i, s in enumerate(starts)], pad_to=104)

    def sam(device):
        buf = io.StringIO()
        al = Aligner(fm, opts=AlignerOpts(seed_mode=seed_mode),
                     device=device)
        w = samio.SamWriter(buf, fm.ref.names,
                            [int(x) for x in fm.ref.tlens], no_head=True)
        if how == "stream":
            align_and_emit_stream(al, [b1], w)
        elif how == "align_batch":
            results_to_sam(b1, al.align_batch(b1), al, w)
        elif how == "pe":
            align_and_emit_pe_stream(al, [(b1, b2)], w)
        else:
            pairs_to_sam(b1, b2, align_pairs(al, b1, b2), al, w)
        w.flush()
        return buf.getvalue()
    before = dp_cuda.launches["dp_score"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == sam("cpu")
