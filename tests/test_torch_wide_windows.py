"""DP windows past the lockstep one-block kernel's single pass and
overlay windows past 256 columns, end to end against the JAX package:
SAM bytes and stats equal, exact. On the card these windows take the ring
kernel and the one-warp kernel's overlay instantiation at 10 columns a
lane (ops/dp_cuda); here, as on any CPU tensor, the plain version.

  * single-end reads of 2,100 bp: _stage_dp's window is L + 2 * dp_pad =
    2104 + 32 = 2136 bases (W + 1 = 2137 > 2048 columns: the ring kernel
    in one pass), reads with mismatches and a deletion, so every one takes
    the DP;
  * paired-end at -X 2500, on tests/test_torch_paired_emit's genome and
    pair kinds (N-laden mates only the rescue places, random mates it
    fails on), packed and fused steps. The mate rescue's window is
    min(maxins, 1000) + L in both packages (paired.rescue_width), so it
    stays at 1104 bases: -X never takes the rescue past the one-block
    kernel's single pass;
  * single-end reads of 250 bp on a graph index: _stage_dp's window is
    L + 2 * dp_pad = 256 + 32 = 288 bases, with the SNV overlay, on
    tests/test_torch_graph_index's genome, reads cut from haplotypes."""

import io

import numpy as np
import pytest
import torch

from test_torch_graph_index import graph_world
from test_torch_graph_pipeline import haplotype
from test_torch_paired_emit import RDLEN, _batches, _genome, _pairs
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.pipeline import results_to_sam as j_results_to_sam
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.pipeline import results_to_sam as t_results_to_sam
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)


def _sam(run, mod, al, ref):
    buf = io.StringIO()
    st = run(al, mod.SamWriter(buf, list(ref.names),
                               [int(x) for x in ref.tlens], no_head=True))
    return buf.getvalue(), st


def test_pe_at_maxins_2500():
    rng = np.random.default_rng(2500)
    jfm = build_fm_index(reference_from_seqs(_genome(rng)))
    tfm = FMIndex.from_object(jfm)
    pairs = _pairs(jfm.ref.joined, int(jfm.ref.frag_joined[-1]), rng, 144)
    const = [(np.full(RDLEN, 40, np.int8),) * 2] * 96
    perbase = [(rng.integers(2, 42, RDLEN).astype(np.int8),
                rng.integers(2, 42, RDLEN).astype(np.int8))
               for _ in range(48)]
    parts = [(pairs[:96], const), (pairs[96:], perbase)]
    jb = [_batches(JRead, jbatchify, p, q) for p, q in parts]
    tb = [_batches(TRead, tbatchify, p, q) for p, q in parts]
    jal = JAligner(jfm, opts=JOpts(maxins=2500))
    tal = TAligner(tfm, opts=TOpts(maxins=2500), device="cpu")
    W = tpaired.rescue_width(tal.opts, tb[0][0].seqs.shape[1])
    assert W == 1104 and dp_cuda.dispatch_plan(W).kernel == "dp_score_wide"
    jt, js = _sam(lambda al, w: jemit.align_and_emit_pe_stream(al, jb, w),
                  jsam, jal, jfm.ref)
    tt, ts = _sam(lambda al, w: temit.align_and_emit_pe_stream(al, tb, w),
                  tsam, tal, jfm.ref)
    assert ts == js and tt == jt
    # N-laden mates that no seed places come out aligned: the rescue
    recs = [ln.split("\t") for ln in tt.splitlines()]
    assert any(f[9].count("N") >= 10 and not int(f[1]) & 4 for f in recs)


@pytest.mark.parametrize("how", ["stream", "align_batch"])
def test_se_long_reads(how):
    rng = np.random.default_rng(2100)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    jfm = build_fm_index(reference_from_seqs({"chrL": jalphabet.decode(g)}))
    L = 2100
    reads = []
    for k in range(12):
        s = int(rng.integers(0, g.size - L - 10))
        seq = g[s:s + L].copy()
        if k % 3 == 0:                     # a 1-3 bp deletion
            d = int(rng.integers(1, 4))
            p = int(rng.integers(300, 1800))
            seq = np.concatenate([g[s:s + p], g[s + p + d:s + L + d]])
        m = rng.random(L) < 0.01
        seq[m] = (seq[m] + 1) % 4
        reads.append((f"long{k}", jalphabet.revcomp(seq) if k % 2 else seq))
    q = np.full(L, 40, np.int8)
    jb = jbatchify([JRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                   pad_to=2104)
    tb = tbatchify([TRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                   pad_to=2104)
    jal = JAligner(jfm)
    tal = TAligner(FMIndex.from_object(jfm), device="cpu")
    W = tb.seqs.shape[1] + 2 * tal.opts.dp_pad
    assert W == 2136 and dp_cuda.dispatch_plan(W).kernel == "dp_score_ring"
    if how == "stream":
        jt, js = _sam(lambda al, wr: jemit.align_and_emit_stream(al, [jb],
                                                                 wr),
                      jsam, jal, jfm.ref)
        tt, ts = _sam(lambda al, wr: temit.align_and_emit_stream(al, [tb],
                                                                 wr),
                      tsam, tal, jfm.ref)
    else:
        jt, js = _sam(lambda al, wr: j_results_to_sam(
            jb, al.align_batch(jb), al, wr), jsam, jal, jfm.ref)
        tt, ts = _sam(lambda al, wr: t_results_to_sam(
            tb, al.align_batch(tb), al, wr), tsam, tal, jfm.ref)
    assert ts == js and tt == jt
    assert sum("D" in ln.split("\t")[5] for ln in tt.splitlines()) >= 3


@pytest.fixture(scope="module")
def graph250(tmp_path_factory):
    w = graph_world(tmp_path_factory.mktemp("graph250"))
    codes, snps = w["codes"], w["snps"]
    rng = np.random.default_rng(250)
    reads = []
    for k in range(96):
        s = int(rng.integers(0, 29000 - 300))
        seq = haplotype(codes, snps, s, 250, rng, 0.7).copy()
        if k % 4 == 0:                     # a 1-3 bp deletion
            d = int(rng.integers(1, 4))
            p = int(rng.integers(60, 190))
            seq = np.concatenate([seq[:p], haplotype(codes, snps, s + p + d,
                                                     250 - p, rng, 0.7)])
        m = rng.random(250) < 0.012
        seq[m] = (seq[m] + 1) % 4
        reads.append((f"w{k}", jalphabet.revcomp(seq) if k % 2 else seq))
    q = np.full(250, 40, np.int8)
    jb = jbatchify([JRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                   pad_to=256)
    tb = tbatchify([TRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                   pad_to=256)
    return w, jb, tb


@pytest.mark.parametrize("how", ["stream", "align_batch"])
def test_graph_se_250bp(graph250, how):
    w, jb, tb = graph250
    jal = JAligner(w["jfm"])
    tal = TAligner(FMIndex.from_object(w["jfm"]), device="cpu")
    assert tal.overlay is not None
    W = tb.seqs.shape[1] + 2 * tal.opts.dp_pad
    assert W == 288 and dp_cuda.dispatch_plan(W).kernel == "dp_score"
    if how == "stream":
        jt, js = _sam(lambda al, wr: jemit.align_and_emit_stream(al, [jb],
                                                                 wr),
                      jsam, jal, w["ref"])
        tt, ts = _sam(lambda al, wr: temit.align_and_emit_stream(al, [tb],
                                                                 wr),
                      tsam, tal, w["ref"])
    else:
        jt, js = _sam(lambda al, wr: j_results_to_sam(
            jb, al.align_batch(jb), al, wr), jsam, jal, w["ref"])
        tt, ts = _sam(lambda al, wr: t_results_to_sam(
            tb, al.align_batch(tb), al, wr), tsam, tal, w["ref"])
    assert ts == js and tt == jt
    assert sum("D" in ln.split("\t")[5] for ln in tt.splitlines()) >= 5
