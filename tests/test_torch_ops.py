"""The port's tensor ops against the JAX package's, on one index built by
hisat2_tpu and loaded by the port: text windows (all three fetch
branches, negative starts, windows past n, words with bit 31 set), the
row-blocked gathers, seed-table lookups (stride 0 and 4), ungapped
verify, row finalization, read unpacking and the float32 min-score ceil.
Inputs come from a numpy seed; equality is exact."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import pipeline as jpipe
from hisat2_tpu.align import scoring as jscoring
from hisat2_tpu.align.scoring import Scoring as JScoring
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.ops import extend as jextend, rank as jrank, search as jsearch
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align.scoring import Scoring
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.ops import extend as textend, rank as trank
from hisat2_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX device dict, port device bundle, joined text, JAX index) over
    a two-chromosome 46 kb genome with an N run (three fragments)."""
    rng = np.random.default_rng(11)
    a = jalphabet.decode(rng.integers(0, 4, 26000).astype(np.uint8))
    b = jalphabet.decode(rng.integers(0, 4, 20000).astype(np.uint8))
    a = a[:9000] + "N" * 40 + a[9040:]
    jfm = build_fm_index(reference_from_seqs({"chrA": a, "chrB": b}))
    prefix = str(tmp_path_factory.mktemp("idx") / "ops")
    jfm.save(prefix)
    tfm = FMIndex.load(prefix)
    return jfm.device, tfm.device_bundle("cpu"), jfm.ref.joined, jfm


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def test_text_words_have_bit31(both):
    jidx, tidx, _, _ = both
    words = np.asarray(jidx["text_packed"])
    assert (words >= (1 << 31)).any()
    assert tidx["text_packed"].dtype == torch.int64
    assert int(tidx["text_packed"].max()) >= (1 << 31)


@pytest.mark.parametrize("length", [20, 104, 128, 136, 256, 300])
def test_text_window(both, length):
    jidx, tidx, joined, _ = both
    n = joined.size
    rng = np.random.default_rng(length)
    starts = np.concatenate([
        [-600, -300, -129, -128, -127, -length, -length + 1, -5, -1, 0, 1,
         15, 16, 17, 255, 256, n - length - 1, n - length, n - 1, n, n + 7,
         0x7FFFFFFF - 16, 0x7FFFFFFF - (1 << 20)],
        rng.integers(0, n, 60)]).astype(np.int32)
    tw = jax.jit(jrank.text_window, static_argnums=2)
    want = np.asarray(tw(jidx, jnp.asarray(starts), length))
    got = trank.text_window(tidx, T(starts), length)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # in-range windows are the text itself
    ok = (starts >= 0) & (starts.astype(np.int64) + length <= n)
    for s, row in zip(starts[ok], got.numpy()[ok]):
        np.testing.assert_array_equal(row, joined[s:s + length])


def test_row_gathers(both):
    jidx, tidx, _, _ = both
    rng = np.random.default_rng(5)
    rows = tidx["st_pos_rows"]
    n = rows.numel()
    starts = np.concatenate([[0, 1, 31, 32, 33, n - 9, n - 1],
                             rng.integers(0, n, 50)]).astype(np.int32)
    want = np.asarray(jrank.gather_slices(jidx["st_pos_rows"],
                                          jnp.asarray(starts), 8))
    got = trank.gather_slices(rows, T(starts), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    r = np.concatenate([[-3, 0, rows.shape[0] - 1, rows.shape[0] + 4],
                        rng.integers(0, rows.shape[0], 20)]).astype(np.int32)
    want = np.asarray(jrank.gather_rows2(jidx["text_rows"], jnp.asarray(r)))
    got = trank.gather_rows2(tidx["text_rows"], T(r))
    np.testing.assert_array_equal(got.numpy(), want)
    tab = np.asarray(jidx["frag_joined"])
    q = np.concatenate([tab - 1, tab, tab + 1, [-5, 10 ** 6]]).astype(np.int32)
    want = np.asarray(jrank.searchsorted_right(jnp.asarray(tab),
                                               jnp.asarray(q)))
    np.testing.assert_array_equal(
        trank.searchsorted_right(tidx["frag_joined"], T(q)).numpy(), want)


def test_shift_helpers():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 32, (40, 32), dtype=np.uint64)
    ws = rng.integers(0, 32, 40).astype(np.int32)
    want = np.asarray(jrank._shift_words(jnp.asarray(w.astype(np.uint32)),
                                         jnp.asarray(ws), 17))
    got = trank._shift_words(T(w.astype(np.int64), torch.int64), T(ws), 17)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    x = rng.integers(0, 4, (40, 50)).astype(np.int32)
    sh = rng.integers(0, 50, 40).astype(np.int32)
    want = np.asarray(jrank._shift_right_fill(jnp.asarray(x),
                                              jnp.asarray(sh), 4))
    np.testing.assert_array_equal(
        trank._shift_right_fill(T(x), T(sh), 4).numpy(), want)


def _reads(joined, rng, R, L):
    """R reads of codes 0..4 cut from the text (some with Ns, mismatches,
    short lengths, or random), padded to L."""
    seqs = np.full((R, L), 4, np.int32)
    lens = rng.integers(L - 30, L + 1, R).astype(np.int32)
    lens[:3] = [0, 5, 12]
    for i in range(R):
        s = int(rng.integers(0, joined.size - L))
        r = joined[s:s + lens[i]].astype(np.int32)
        mm = rng.random(lens[i]) < 0.03
        r[mm] = rng.integers(0, 5, int(mm.sum()))
        if i % 7 == 0:
            r = rng.integers(0, 4, lens[i])
        seqs[i, :lens[i]] = r
    quals = rng.integers(0, 45, (R, L)).astype(np.int32)
    return seqs, quals, lens


@pytest.mark.parametrize("stride,n_seeds", [(0, 8), (4, 24)])
def test_table_lookup(both, stride, n_seeds):
    jidx, tidx, joined, _ = both
    rng = np.random.default_rng(stride)
    seqs, _, lens = _reads(joined, rng, 64, 104)
    tl = jax.jit(jsearch.table_lookup,
                 static_argnames=("n_seeds", "locs_per_seg", "stride"))
    want = tl(jidx, jnp.asarray(seqs), jnp.asarray(lens), n_seeds=n_seeds,
              locs_per_seg=8, stride=stride)
    got = tsearch.table_lookup(tidx, T(seqs), T(lens), n_seeds=n_seeds,
                               locs_per_seg=8, stride=stride)
    for k in ("locs", "lvalid", "off", "exhausted"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_verify_ungapped(both):
    jidx, tidx, joined, _ = both
    rng = np.random.default_rng(9)
    seqs, quals, lens = _reads(joined, rng, 32, 104)
    n = joined.size
    pos = rng.integers(-50, n + 50, (32, 12)).astype(np.int32)
    pos[:, 0] = [0, 8990, 8995, 9000, n - 104, n - 1, 0x7FFFFFFF,
                 -1] * 4
    valid = rng.random((32, 12)) < 0.8
    jsc = JScoring().device_tables()
    sctab = Scoring().device_tables("cpu")
    want = jax.jit(jextend.verify_ungapped)(
        jidx, jsc, jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lens),
        jnp.asarray(pos), jnp.asarray(valid))
    got = textend.verify_ungapped(tidx, sctab, T(seqs), T(quals), T(lens),
                                  T(pos), torch.from_numpy(valid))
    for k in ("score", "nmm", "nns", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_stage_fin_rows(both):
    jidx, tidx, joined, _ = both
    rng = np.random.default_rng(4)
    B, L = 40, 104
    seqs, quals, lens = _reads(joined, rng, B, L)
    jsc = JScoring().device_tables()
    sctab = Scoring().device_tables("cpu")
    j2 = jpipe._with_revcomp(jnp.asarray(seqs), jnp.asarray(quals),
                             jnp.asarray(lens))
    t2 = tpipe._with_revcomp(T(seqs), T(quals), T(lens))
    for a, b in zip(t2, j2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    N = 3 * B
    ppos = rng.integers(-20, joined.size, N).astype(np.int32)
    pfw = rng.random(N) < 0.5
    read_of = np.tile(np.arange(B, dtype=np.int32), 3)
    fin = jax.jit(jpipe._stage_fin_rows, static_argnames=("B", "max_mm"))
    want = fin(jidx, jsc, *j2, jnp.asarray(ppos), jnp.asarray(pfw),
               jnp.asarray(read_of), B=B, max_mm=4)
    got = tpipe._stage_fin_rows(tidx, sctab, *t2, T(ppos),
                                torch.from_numpy(pfw), T(read_of), B, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_reads_bit31(both):
    _, _, joined, _ = both
    rng = np.random.default_rng(8)
    reads = []
    for i in range(24):
        ln = int(rng.integers(1, 101))
        s = rng.integers(0, 4, ln).astype(np.uint8)
        s[15::16] = 3                      # char 15 of every word is T
        s[rng.random(ln) < 0.05] = 4
        reads.append(JRead(f"r{i}", s, rng.integers(2, 41, ln).astype(
            np.int8), i))
    batch = jbatchify(reads, pad_to=104)
    seq_w, n_w, quals, qconst, lens = batch.packed()
    assert (seq_w >= (1 << 31)).any()
    want = jpipe._unpack_reads(jnp.asarray(seq_w), jnp.asarray(n_w),
                               jnp.asarray(quals), jnp.int32(qconst),
                               jnp.asarray(lens), 104)
    got = tpipe._unpack_reads(T(seq_w.astype(np.int64), torch.int64),
                              T(n_w.astype(np.int64), torch.int64),
                              T(quals), qconst, T(lens), 104)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0].numpy(), batch.seqs)


@pytest.mark.parametrize("I,S", [(0.0, -0.2), (-0.6, -0.6), (0.3, -0.15)])
def test_min_scores_float32(I, S):
    lens = np.arange(0, 257, dtype=np.int32)

    @jax.jit
    def jmin(i, s, ln):
        return jnp.ceil(i + s * ln.astype(jnp.float32)).astype(jnp.int32)
    want = np.asarray(jmin(jnp.float32(I), jnp.float32(S),
                           jnp.asarray(lens)))
    got = tpipe._min_scores(I, S, T(lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{}, {"no_softclip": True},
                                {"mm_pen_max": 10, "mm_pen_min": 3},
                                {"sc_pen_max": 5, "sc_pen_min": 0,
                                 "n_pen": 3, "read_gap_const": 7}])
def test_scoring_tables(kw):
    jsc, tsc = JScoring(**kw), Scoring(**kw)
    jt, tt = jsc.device_tables(), tsc.device_tables("cpu")
    for k in ("mm_min", "mm_delta", "sc_min", "sc_delta", "n_pen",
              "match_bonus", "rd_open", "rd_ext", "rf_open", "rf_ext"):
        assert tt[k].dtype == torch.int32 and int(tt[k]) == int(jt[k]), k
    q = np.arange(-3, 71, dtype=np.int32)
    for jf, tf in ((jscoring.mm_pen_of, tpipe.mm_pen_of),
                   (jscoring.sc_pen_of, tpipe.sc_pen_of)):
        np.testing.assert_array_equal(tf(tt, T(q)).numpy(),
                                      np.asarray(jf(jt, jnp.asarray(q))))
    assert tsc.dp_consts() == dict(
        match_bonus=jsc.match_bonus, n_pen=jsc.n_pen,
        rd_open=jsc.read_gap_open(), rd_ext=jsc.read_gap_extend(),
        rf_open=jsc.ref_gap_open(), rf_ext=jsc.ref_gap_extend())
