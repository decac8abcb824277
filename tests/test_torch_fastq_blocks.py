"""The port's FASTQ block parser (native/fastq.cpp through io/reads.py)
against hisat2_tpu's line reader: batches that batch_iter builds from
blocks of a FASTQ source, with cli.align._reindex's -s/-u/-5/-3/
--ignore-quals, equal hisat2_tpu's read_reads -> _reindex -> batch_iter
array for array (seqs, quals, lens, names, rdids); read_fastq's Read view
equals hisat2_tpu's read_fastq read for read; an input one reader rejects
the other rejects too. Also the native strip against str.strip on every
character str.isspace takes, and the read layer's counters."""

import bz2
import ctypes
import gzip
import itertools

import numpy as np
import pytest

from hisat2_tpu.cli import align as jalign
from hisat2_tpu.io import reads as jreads
from hisat2_tpu_torch.cli import align as talign
from hisat2_tpu_torch.io import reads as treads
from hisat2_tpu_torch.native import fastq_lib
from hisat2_tpu_torch.utils import metrics


def _fq(recs, nl="\n") -> str:
    return "".join(f"@{n}{nl}{s}{nl}+{nl}{q}{nl}" for n, s, q in recs)


def _recs(seed, n, lo=90, hi=110, alphabet="ACGT", qual=lambda r, k: "I"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        s = "".join(rng.choice(list(alphabet), ln))
        out.append((f"r{seed}_{i} c{i}", s, "".join(
            qual(rng, k) for k in range(ln))))
    return out


def _q33(rng, k):
    return chr(33 + int(rng.integers(0, 42)))


def _q64(rng, k):
    return chr(64 + int(rng.integers(-12, 45)))


def _gz_members(text: str, parts: int) -> bytes:
    lines = text.splitlines(keepends=True)
    step = -(-len(lines) // parts)
    return b"".join(gzip.compress("".join(lines[i:i + step]).encode())
                    for i in range(0, len(lines), step))


# case: (files as (name, bytes)), quality scale, _reindex's options,
# batch size, block size (None: the module's)
CASES = {
    "crlf": ([("a.fq", _fq(_recs(1, 40, qual=_q33), "\r\n").encode())],
             False, {}, 16, None),
    "lone_cr": ([("a.fq", _fq(_recs(2, 20, qual=_q33), "\r").encode())],
                False, {}, 16, None),
    "blank_lines": ([("a.fq", ("\n\n" + "\n \t\n".join(
        _fq([r]) for r in _recs(3, 30, qual=_q33)) + "\n\n").encode())],
                    False, {}, 8, None),
    "iupac_lowercase_n": ([("a.fq", _fq(_recs(
        4, 50, alphabet="ACGTacgtNnRYKMSWBDHVryk.-", qual=_q33)).encode())],
                          False, {}, 32, None),
    "mixed_lengths": ([("a.fq", _fq(
        _recs(5, 20, 1, 9, qual=_q33) + _recs(6, 20, 150, 300, qual=_q33)
        + _recs(7, 30, 20, 60, qual=_q33)).encode())],
                      False, {}, 20, None),
    "length_zero": ([("a.fq", _fq([("z0", "", ""), ("a", "ACGTA", "IIIII"),
                                   ("z1", "", "")]).encode())],
                    False, {}, 2, None),
    "block_boundaries": ([("a.fq.gz", gzip.compress(("\n" + _fq(
        _recs(8, 60, 0, 140, qual=_q33)[:30] + [("long", "ACGT" * 400,
                                                 "5" * 1600)]
        + _recs(9, 30, 60, 80, qual=_q33), "\r\n")).encode()))],
                         False, {}, 7, 13),
    "gzip_members": ([("a.fq.gz", _gz_members(
        _fq(_recs(10, 100, qual=_q33)), 7))], False, {}, 32, 512),
    "bz2": ([("a.fq.bz2", bz2.compress(_fq(_recs(11, 50, qual=_q33))
                                       .encode()))], False, {}, 16, None),
    "two_files": ([("a.fq", _fq(_recs(12, 23, qual=_q33)).encode()),
                   ("b.fq.gz", gzip.compress(
                       _fq(_recs(13, 19, qual=_q33)).encode()))],
                  False, {}, 10, None),
    "phred64": ([("a.fq", _fq(_recs(14, 40, qual=_q64)).encode())],
                "phred64", {}, 16, None),
    "solexa": ([("a.fq", _fq(_recs(15, 40, qual=_q64)).encode())],
               "solexa", {}, 16, None),
    "skip_upto_trims": ([("a.fq", _fq(_recs(16, 30, 0, 30, qual=_q33))
                          .encode()),
                         ("b.fq", _fq(_recs(17, 30, 0, 30, qual=_q33))
                          .encode())],
                        False, dict(skip=25, upto=31, trim5=4, trim3=7),
                        8, 64),
    "trim_past_the_read": ([("a.fq", _fq(_recs(18, 30, 0, 12, qual=_q33))
                             .encode())],
                           False, dict(trim5=3, trim3=15), 8, None),
    "ignore_quals": ([("a.fq", _fq(_recs(19, 30, qual=_q33)).encode())],
                     False, dict(ignore_quals=True, trim3=5), 8, None),
    "batch_boundary": ([("a.fq", _fq(_recs(20, 37, qual=_q33)).encode())],
                       False, {}, 5, None),
    "quality_lengths": ([("a.fq", _fq([
        ("long_q", "ACGT", "IIIIII"), ("one_q", "ACGTAC", "5"),
        ("x", "A", "I")]).encode())], False, {}, 4, None),
    "unicode_whitespace": ([("a.fq", (
        "　@né x \r\n\x1cACGT \n+\u0085\n IIII\x1f\n"
        "@été y\n AC \n+\nII\n").encode())],
                           False, {}, 4, None),
    "truncated_header_only": ([("a.fq", (_fq(_recs(21, 3, qual=_q33))
                                         + "@cut").encode())],
                              False, {}, 8, None),
    "truncated_no_quals": ([("a.fq", (_fq(_recs(22, 3, qual=_q33))
                                      + "@cut\nACGT\n+").encode())],
                           False, {}, 8, None),
    "truncated_quals": ([("a.fq.gz", gzip.compress((_fq(
        _recs(23, 3, qual=_q33)) + "@cut\nACGT\n+\nII").encode()))],
                        False, {}, 8, 16),
    "no_name": ([("a.fq", (_fq(_recs(24, 3)) + "@ \t\nAC\n+\nII\n")
                 .encode())], False, {}, 8, None),
    "non_ascii_seq": ([("a.fq", "@a\nACÉGT\n+\nIIIII\n".encode())],
                      False, {}, 8, None),
    "not_utf8": ([("a.fq", b"@a\xff\nACGT\n+\nIIII\n")], False, {}, 8,
                 None),
    "short_quals_skipped": ([("a.fq", ("@a\nACGT\n+\nII\n"
                                       + _fq(_recs(25, 4))).encode())],
                            False, dict(skip=1), 8, None),
}


def _write(tmp_path, files):
    paths = []
    for name, data in files:
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    return paths


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:      # noqa: BLE001 (the outcome is compared)
        return None, e


def _jax_batches(paths, qscale, pre, batch):
    stream = itertools.chain(*[jreads.read_reads(p, None, qscale)
                               for p in paths])
    return list(jreads.batch_iter(jalign._reindex(stream, **pre), batch))


def _port_batches(paths, qscale, pre, batch):
    src = treads.read_source(paths, None, qscale)
    assert isinstance(src, treads.FastqFiles)
    return list(treads.batch_iter(talign._reindex(src, **pre), batch))


@pytest.mark.parametrize("case", list(CASES))
def test_block_batches_equal_jax(tmp_path, monkeypatch, case):
    files, qscale, pre, batch, block = CASES[case]
    if block is not None:
        monkeypatch.setattr(treads, "BLOCK", block)
    paths = _write(tmp_path, files)
    want, err = _outcome(lambda: _jax_batches(paths, qscale, pre, batch))
    if err is not None:
        with pytest.raises(ValueError):
            _port_batches(paths, qscale, pre, batch)
    else:
        got = _port_batches(paths, qscale, pre, batch)
        assert [len(b) for b in got] == [len(b) for b in want]
        for g, w in zip(got, want):
            for f in ("seqs", "quals", "lens", "rdids"):
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            assert g.names == w.names
            assert g.reads == []
    # the Read view, file by file, without the preprocessing
    for p in paths:
        want, err = _outcome(lambda: list(jreads.read_fastq(p, qscale, 5)))
        if err is not None:
            with pytest.raises(ValueError):
                list(treads.read_fastq(p, qscale, 5))
            continue
        got = list(treads.read_fastq(p, qscale, 5))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.name, g.rdid) == (w.name, w.rdid)
            assert g.seq.dtype == w.seq.dtype
            assert np.array_equal(g.seq, w.seq)
            assert g.qual.dtype == w.qual.dtype
            assert np.array_equal(g.qual, w.qual)


def test_int_quals_read_view(tmp_path):
    """--int-quals: the Read view reads the quality line as text; batches
    of such a source take the per-Read path."""
    p = tmp_path / "i.fq"
    p.write_text("@a x\nACGT\n+\n40 30  20 70\n@b\nAC\n+\n-3 12\n")
    want = list(jreads.read_fastq(str(p), "int"))
    got = list(treads.read_fastq(str(p), "int"))
    assert [(r.name, r.qual.tolist()) for r in got] == \
        [(r.name, r.qual.tolist()) for r in want]
    src = treads.read_source([str(p)], None, "int")
    b = next(treads.batch_iter(talign._reindex(src, trim5=1), 8))
    w = next(jreads.batch_iter(jalign._reindex(
        jreads.read_reads(str(p), None, "int"), trim5=1), 8))
    assert np.array_equal(b.quals, w.quals) and b.names == w.names
    assert len(b.reads) == 2


def test_strip_matches_str_strip(tmp_path):
    """Every character str.isspace takes, around and inside a record's
    lines: the same names, bases and qualities as the text layer's."""
    ws = [chr(c) for c in range(0x110000) if chr(c).isspace()
          and chr(c) not in "\n\r"]
    recs = "".join(f"{w}@n{i}{w}x{w}\n{w}AC{w}\n+{w}\n{w}II{w}\n"
                   for i, w in enumerate(ws))
    p = tmp_path / "w.fq"
    p.write_bytes(recs.encode())
    got = list(treads.read_fastq(str(p)))
    want = list(jreads.read_fastq(str(p)))
    assert len(got) == len(want) == len(ws)
    assert [r.name for r in got] == [r.name for r in want]
    assert all(np.array_equal(g.seq, w.seq) for g, w in zip(got, want))


def test_repeat_sub_batch_from_arrays(tmp_path):
    """cli.align._repeat_pass's sub-batch (ReadBatch.take) equals batchify
    of the same reads at the batch's row length."""
    p = tmp_path / "a.fq"
    p.write_text(_fq(_recs(30, 20, 5, 40, qual=_q33)))
    b = next(treads.batch_iter(treads.read_source([str(p)]), 20))
    rows = [3, 0, 17, 9]
    reads = list(treads.read_fastq(str(p)))
    want = treads.batchify([reads[i] for i in rows], pad_to=b.seqs.shape[1])
    got = b.take(rows)
    for f in ("seqs", "quals", "lens", "rdids"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.names == want.names


def test_counters_and_interpreter_lock(tmp_path):
    """reads_block and reads_batched under the tracer (a FASTQ source:
    every read from the block parser; FASTA: none), nothing with it off;
    the parser is a plain ctypes.CDLL, whose calls release the lock."""
    fq, fa = tmp_path / "a.fq.gz", tmp_path / "a.fa"
    with gzip.open(fq, "wt") as fh:
        fh.write(_fq(_recs(31, 50)))
    fa.write_text("".join(f">f{i}\nACGTACGT\n" for i in range(30)))
    assert metrics.stop_trace() is None
    for path, block in ((fq, 50), (fa, 0)):
        metrics.start_trace()
        n = sum(len(b) for b in treads.batch_iter(
            treads.read_source([str(path)]), 16))
        c = metrics.stop_trace()["counters"]
        assert c["reads_batched"] == n
        assert c.get("reads_block", 0) == block
    lib = fastq_lib()
    assert type(lib) is ctypes.CDLL and not isinstance(lib, ctypes.PyDLL)
