"""Local mode (`Scoring.local_default()`: match bonus 2, score_min
G,20,8) through the port against the JAX package, byte for byte.

One index over scripts/local_mode_probe.py's 20 kb genome, built by
hisat2_tpu and handed to the port as the same arrays. Inputs: the probe's
error-free 100 bp read and FR pair, a batch of 256 reads and one of 256
pairs with mismatches, 1-3 bp indels, random sequence and both strands
(constant quality: the packed steps). Each goes through the SE stream,
align_batch + results_to_sam, the PE stream and align_pairs +
pairs_to_sam in both packages; SAM bytes and stats must be equal.

The reference's defect is matched, not fixed: its device steps read the
log-type score_min as linear, ceil(20 + 8 * 100) = 820 for a 100 bp read
where Scoring.min_score gives 57, so the probe read comes out unaligned
(flag 4) through the stream, while the per-pair ladder, which uses 57,
reports the probe pair discordant (YT:Z:DP, AS:i:200). The tests pin it.

The NumPy PE fast path that local mode takes in place of the native one
formats nothing there (no pair passes 820). So it is also held to the JAX
package's NumPy path and to the port's native path in end-to-end mode, and
in local mode with a linear score_min, where pairs reach it: there the
native path, which has no local-mode MAPQ, would give other bytes."""

import io

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align import paired as jpaired
from hisat2_tpu.align import pipeline as jpipe
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.scoring import Scoring as JScoring
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.scoring import Scoring as TScoring
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify

torch.set_num_threads(1)

PAD = 104
N_BATCH = 256


def _errors(rng, s, i):
    """Phase 4's kinds of error on read i: 1% mismatches, a 1-3 bp
    deletion or insertion on one read in eight each, random sequence on
    one in sixteen."""
    if i % 16 == 15:
        return rng.integers(0, 4, s.size).astype(np.uint8)
    s = s.copy()
    m = rng.random(s.size) < 0.01
    s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
    d = int(rng.integers(1, 4))
    p = int(rng.integers(20, 80))
    if i % 8 == 3:
        s = np.concatenate([s[:p], s[p + d:]])
    elif i % 8 == 5:
        s = np.concatenate([s[:p], rng.integers(0, 4, d).astype(np.uint8),
                            s[p:]])
    return s.astype(np.uint8)


def _inputs(g):
    """name -> list of (name, codes) per batch; pairs -> (mate 1, mate 2)."""
    rng = np.random.default_rng(10)
    se = []
    for i in range(N_BATCH):
        st = int(rng.integers(0, g.size - 110))
        s = _errors(rng, g[st:st + 100], i)
        if i % 2:
            s = jalphabet.revcomp(s)
        se.append((f"r{i}_{st}", s))
    pe = []
    for i in range(N_BATCH):
        frag = int(rng.integers(200, 501))
        st = int(rng.integers(0, g.size - frag))
        m1 = _errors(rng, g[st:st + 100], i)
        m2 = _errors(rng, jalphabet.revcomp(g[st + frag - 100:st + frag]),
                     i + 1)
        if i % 2:
            m1, m2 = m2, m1
        pe.append((f"p{i}_{st}", m1, m2))
    return dict(
        se_probe=[("r0", g[5000:5100].copy())],
        se_batch=se,
        pe_probe=[("p0", g[8000:8100].copy(),
                   jalphabet.revcomp(g[8200:8300]))],
        pe_batch=pe)


def _batch(mod_read, mod_batchify, items, mate=None):
    reads = []
    for i, it in enumerate(items):
        s = it[1] if mate is None else it[1 + mate]
        reads.append(mod_read(it[0], s.copy(), np.full(s.size, 40, np.int8),
                              i))
    return mod_batchify(reads, pad_to=PAD)


@pytest.fixture(scope="module")
def world():
    g = np.random.default_rng(0).integers(0, 4, 20000).astype(np.uint8)
    jfm = build_fm_index(reference_from_seqs({"chrL": jalphabet.decode(g)}))
    tfm = FMIndex.from_object(jfm)
    inp = _inputs(g)
    jb, tb = {}, {}
    for k, items in inp.items():
        if k.startswith("se"):
            jb[k] = _batch(JRead, jbatchify, items)
            tb[k] = _batch(TRead, tbatchify, items)
        else:
            jb[k] = tuple(_batch(JRead, jbatchify, items, m) for m in (0, 1))
            tb[k] = tuple(_batch(TRead, tbatchify, items, m) for m in (0, 1))
    return jfm, tfm, jb, tb


def _sam(fn, sammod, al):
    ref = al.fm.ref
    buf = io.StringIO()
    w = sammod.SamWriter(buf, list(ref.names), [int(x) for x in ref.tlens],
                         no_head=True)
    st = fn(al, w)
    w.flush()
    return buf.getvalue(), st


def _aligners(world, local=True):
    jfm, tfm, _, _ = world
    if not local:
        return JAligner(jfm), TAligner(tfm, device="cpu")
    return (JAligner(jfm, scoring=JScoring.local_default()),
            TAligner(tfm, scoring=TScoring.local_default(), device="cpu"))


RUNS = {
    "se_stream": (
        lambda b: lambda al, w: jemit.align_and_emit_stream(al, [b], w),
        lambda b: lambda al, w: temit.align_and_emit_stream(al, [b], w)),
    "se_align_batch": (
        lambda b: lambda al, w: jpipe.results_to_sam(
            b, al.align_batch(b), al, w),
        lambda b: lambda al, w: tpipe.results_to_sam(
            b, al.align_batch(b), al, w)),
    "pe_stream": (
        lambda b: lambda al, w: jemit.align_and_emit_pe_stream(al, [b], w),
        lambda b: lambda al, w: temit.align_and_emit_pe_stream(al, [b], w)),
    "pe_align_pairs": (
        lambda b: lambda al, w: jpaired.pairs_to_sam(
            b[0], b[1], jpaired.align_pairs(al, b[0], b[1]), al, w),
        lambda b: lambda al, w: tpaired.pairs_to_sam(
            b[0], b[1], tpaired.align_pairs(al, b[0], b[1]), al, w)),
}


@pytest.fixture(scope="module")
def outputs(world):
    """(JAX text, stats, port text, stats) per (run, input)."""
    _, _, jb, tb = world
    jal, tal = _aligners(world)
    out = {}
    for run, (jfn, tfn) in RUNS.items():
        for inp in ("probe", "batch"):
            key = f"{run[:2]}_{inp}"
            jt, js = _sam(jfn(jb[key]), jsam, jal)
            tt, ts = _sam(tfn(tb[key]), tsam, tal)
            out[run, inp] = (jt, js, tt, ts)
    return out


def test_local_aligner_builds():
    sc = TScoring.local_default()
    assert sc.local and sc.match_bonus == 2
    assert sc.min_score(100) == JScoring.local_default().min_score(100) == 57
    # the device steps' linear reading of the log-type score_min
    lens = torch.tensor([100], dtype=torch.int32)
    got = tpipe._min_scores(float(sc.score_min.I), float(sc.score_min.S),
                            lens)
    assert int(got[0]) == 820


@pytest.mark.parametrize("inp", ["probe", "batch"])
@pytest.mark.parametrize("run", list(RUNS))
def test_local_mode_sam_bytes(outputs, run, inp):
    jt, js, tt, ts = outputs[run, inp]
    assert ts == js
    assert tt == jt
    n = 1 if inp == "probe" else N_BATCH
    assert len(tt.splitlines()) >= (2 * n if run.startswith("pe") else n)


def test_defect_pinned_se(outputs):
    """The probe read, error-free, comes out unaligned through the stream
    and through align_batch (the device steps ask it for 820)."""
    for run in ("se_stream", "se_align_batch"):
        _, _, tt, _ = outputs[run, "probe"]
        (ln,) = tt.splitlines()
        assert int(ln.split("\t")[1]) == 4, (run, ln)


def test_defect_pinned_pe(outputs):
    """The probe pair: unaligned through the stream (the step's
    concordance grid uses 820); discordant through align_pairs +
    pairs_to_sam (the host ladder uses 57), AS:i:200 on each mate."""
    _, _, tt, _ = outputs["pe_stream", "probe"]
    assert [int(ln.split("\t")[1]) for ln in tt.splitlines()] == [77, 141]
    _, _, tt, _ = outputs["pe_align_pairs", "probe"]
    lines = tt.splitlines()
    assert [int(ln.split("\t")[1]) for ln in lines] == [97, 145]
    for ln in lines:
        assert "YT:Z:DP" in ln and "AS:i:200" in ln, ln
    assert [int(ln.split("\t")[8]) for ln in lines] == [300, -300]


def test_numpy_pe_fast_path(world, monkeypatch):
    """End-to-end mode, the PE batch: the port's NumPy fast path gives the
    bytes of hisat2_tpu's NumPy path and of the port's native one."""
    _, _, jb, tb = world
    jal, tal = _aligners(world, local=False)
    native, _ = _sam(lambda al, w: temit.align_and_emit_pe_stream(
        al, [tb["pe_batch"]], w), tsam, tal)
    monkeypatch.setattr(jemit, "_native_fast_pe", lambda *a, **k: None)
    calls = []
    real = temit._numpy_fast_pe

    def counting(*a, **k):
        out = real(*a, **k)
        calls.append(int(out[0].sum()))
        return out
    monkeypatch.setattr(temit, "_native_fast_pe", counting)
    jt, js = _sam(lambda al, w: jemit.align_and_emit_pe_stream(
        al, [jb["pe_batch"]], w), jsam, jal)
    tt, ts = _sam(lambda al, w: temit.align_and_emit_pe_stream(
        al, [tb["pe_batch"]], w), tsam, tal)
    assert calls and calls[0] >= N_BATCH // 4
    assert ts == js and tt == jt
    assert tt == native


def test_numpy_pe_fast_path_local(monkeypatch):
    """Local mode (match bonus 2) with a linear score_min, L,0,1.2, so
    that pairs pass the device steps' minimum and reach the fast path.
    Every pair lies in one of two copies of an 800 bp segment, with 4
    mismatches in mate 1 and 3 or 4 in mate 2: two equal concordant
    placements, scored 336 or 344 over a minimum of 240 with 400 perfect,
    where the local MAPQ table gives 1 and the end-to-end one 0. The SAM
    bytes and stats equal hisat2_tpu's, and the native path's differ in
    the MAPQ of each pair's two primary records only."""
    import dataclasses
    from hisat2_tpu.align.scoring import SimpleFunc as JFunc
    from hisat2_tpu_torch.align.scoring import SimpleFunc as TFunc
    g = np.random.default_rng(0).integers(0, 4, 20000).astype(np.uint8)
    g[12000:12800] = g[2000:2800]
    jfm = build_fm_index(reference_from_seqs({"chrL": jalphabet.decode(g)}))
    rng = np.random.default_rng(3)
    pe = []
    for i in range(64):
        st = 2000 + int(rng.integers(0, 450))
        m1 = g[st:st + 100].copy()
        m2 = jalphabet.revcomp(g[st + 200:st + 300]).copy()
        for m, nmm in ((m1, 4), (m2, 3 + i % 2)):
            p = rng.choice(np.arange(15, 85), nmm, replace=False)
            m[p] = (m[p] + 1) % 4
        pe.append((f"p{i}", m1, m2))
    jb = tuple(_batch(JRead, jbatchify, pe, m) for m in (0, 1))
    tb = tuple(_batch(TRead, tbatchify, pe, m) for m in (0, 1))
    jal = JAligner(jfm, scoring=dataclasses.replace(
        JScoring.local_default(), score_min=JFunc("L", 0.0, 1.2)))
    tal = TAligner(FMIndex.from_object(jfm), scoring=dataclasses.replace(
        TScoring.local_default(), score_min=TFunc("L", 0.0, 1.2)),
        device="cpu")
    calls = []
    real = temit._numpy_fast_pe

    def counting(*a, **k):
        out = real(*a, **k)
        calls.append(int(out[0].sum()))
        return out
    monkeypatch.setattr(temit, "_numpy_fast_pe", counting)
    jt, js = _sam(lambda al, w: jemit.align_and_emit_pe_stream(
        al, [jb], w), jsam, jal)
    tt, ts = _sam(lambda al, w: temit.align_and_emit_pe_stream(
        al, [tb], w), tsam, tal)
    assert calls == [len(pe)]
    assert ts == js and tt == jt
    assert ts["conc_multi"] == len(pe)
    monkeypatch.setattr(temit, "_numpy_fast_pe", temit._native_fast_pe)
    nt, ns = _sam(lambda al, w: temit.align_and_emit_pe_stream(
        al, [tb], w), tsam, tal)
    assert ns == ts
    diff = [(a.split("\t"), b.split("\t")) for a, b in
            zip(nt.splitlines(), tt.splitlines()) if a != b]
    assert len(nt.splitlines()) == len(tt.splitlines())
    assert len(diff) == 2 * len(pe)
    for a, b in diff:
        assert (a[4], b[4]) == ("0", "1")
        assert a[:4] + a[5:] == b[:4] + b[5:]
