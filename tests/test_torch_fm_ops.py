"""The port's FM-index ops against the JAX package's, on the same arrays:
the SWAR popcount, count_eq_packed, rank / lf / lf_step_interval,
packed_char, locate_rows (full SA and a sampled SA at offrate 2 and 4),
expand_range, lf_walk_left, exact_interval, partial_search and
seed_search. One 46 kb two-chromosome genome with an N run (ftab_k = 8
there) and one 3 kb genome (ftab_k = 6); inputs come from a numpy seed;
equality is exact, everything is int32."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.index.fm_index import build_fm_index, build_sampled_sa
from hisat2_tpu.index.seed_table import build_seed_table
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.ops import locate as jlocate, rank as jrank
from hisat2_tpu.ops import search as jsearch
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.ops import locate as tlocate, rank as trank
from hisat2_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def variant(jfm, offrate=0, table=None):
    """A copy of a JAX index over the same arrays, with its SA sampled at
    `offrate` (as build_fm_index(offrate=...) leaves it) and/or carrying
    build_seed_table(kt=, stride=) for table = (kt, stride)."""
    j = copy.copy(jfm)
    j.__dict__.pop("device", None)         # the cached device dict
    if offrate:
        j.offrate = offrate
        j.samp_bits, j.samp_rank, j.samp_vals = build_sampled_sa(
            jfm.sa.astype(np.int64), offrate)
        j.sa = np.zeros(0, np.int32)
    if table:
        kt, stride = table
        j.st_starts, j.st_pos, j.st_k = build_seed_table(
            jfm.ref.joined, kt=kt, stride=stride)
        j.st_stride = stride
    return j


@pytest.fixture(scope="module")
def fm():
    """{name: (JAX index, JAX device dict, port bundle)}: `big` with a full
    SA, `o2`/`o4` the same index sampled, `small` a 3 kb genome."""
    rng = np.random.default_rng(31)
    a = jalphabet.decode(rng.integers(0, 4, 26000).astype(np.uint8))
    b = jalphabet.decode(rng.integers(0, 4, 20000).astype(np.uint8))
    a = a[:9000] + "N" * 40 + a[9040:]
    big = build_fm_index(reference_from_seqs({"chrA": a, "chrB": b}),
                         seed_table=False)
    small = build_fm_index(reference_from_seqs({"s": jalphabet.decode(
        rng.integers(0, 4, 3000).astype(np.uint8))}), seed_table=False)
    assert (big.ftab_k, small.ftab_k) == (8, 6)
    out = {}
    for name, j in (("big", big), ("o2", variant(big, offrate=2)),
                    ("o4", variant(big, offrate=4)), ("small", small)):
        out[name] = (j, j.device, FMIndex.from_object(j).device_bundle("cpu"))
    return out


def test_bundle_carries_the_fm_keys(fm):
    for name, (j, jidx, tidx) in fm.items():
        for k in ("sides", "bwt_packed", "ccount", "sa", "ftab"):
            want = np.asarray(jidx[k])
            assert tidx[k].dtype == (torch.int64 if want.dtype == np.uint32
                                     else torch.int32), k
            np.testing.assert_array_equal(tidx[k].numpy(),
                                          want.astype(np.int64), err_msg=k)
        assert (tidx["zoff"], tidx["ftab_k"], tidx["m"]) == (
            j.zoff, j.ftab_k, j.n + 1)
        assert ("samp_bits" in tidx) == (name in ("o2", "o4"))
        if "samp_bits" in tidx:
            assert tidx["samp_ival"] == jidx["samp_ival"]
            assert tidx["sa"].numel() == 0
            for k in ("samp_bits", "samp_rank", "samp_vals"):
                np.testing.assert_array_equal(
                    tidx[k].numpy(), np.asarray(jidx[k]).astype(np.int64))
    # an index with a seed table keeps the FM keys off the device
    jt = build_fm_index(reference_from_seqs({"t": "ACGT" * 300}))
    with_table = FMIndex.from_object(jt).device_bundle("cpu")
    assert "sides" not in with_table and "st_starts" in with_table
    small = fm["small"][2]
    assert FMIndex.bundle_bytes(small) == sum(
        t.numel() * t.element_size() for t in small.values()
        if isinstance(t, torch.Tensor)) > 8 * small["sides"].numel()


def test_popcount32():
    rng = np.random.default_rng(1)
    x = np.concatenate([[0, 0xFFFFFFFF, 0x80000000, 1, 0x55555555,
                         0xAAAAAAAA, 0x7FFFFFFF, 0xFFFF0000],
                        rng.integers(0, 1 << 32, 500, dtype=np.uint64)]
                       ).astype(np.int64)
    got = trank.popcount32(T(x, torch.int64)).numpy()
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in x])
    want = np.asarray(jax.lax.population_count(jnp.asarray(
        x.astype(np.uint32))))
    np.testing.assert_array_equal(got, want)


def test_count_eq_packed():
    rng = np.random.default_rng(2)
    words = np.concatenate([[0, 0xFFFFFFFF, 0x80000000, 0x55555555],
                            rng.integers(0, 1 << 32, 300, dtype=np.uint64)]
                           ).astype(np.uint32)
    for c in range(4):
        for nsym in (0, 1, 7, 15, 16):
            want = np.asarray(jrank.count_eq_packed(
                jnp.asarray(words), jnp.int32(c), jnp.int32(nsym)))
            got = trank.count_eq_packed(T(words.astype(np.int64), torch.int64),
                                        torch.tensor(c), torch.tensor(nsym))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"c={c} nsym={nsym}")
    nsym = rng.integers(0, 17, words.size).astype(np.int32)
    cs = rng.integers(0, 4, words.size).astype(np.int32)
    want = np.asarray(jrank.count_eq_packed(jnp.asarray(words),
                                            jnp.asarray(cs),
                                            jnp.asarray(nsym)))
    got = trank.count_eq_packed(T(words.astype(np.int64), torch.int64),
                                T(cs), T(nsym))
    np.testing.assert_array_equal(got.numpy(), want)


def _rows_of_interest(j, rng, extra=40):
    m, z = j.n + 1, j.zoff
    pts = [0, 1, 127, 128, 129, 255, 256, z - 1, z, z + 1, m - 129, m - 2,
           m - 1, m]
    return np.unique(np.clip(np.concatenate(
        [pts, rng.integers(0, m + 1, extra)]), 0, m)).astype(np.int32)


@pytest.mark.parametrize("name", ["big", "small"])
def test_rank_lf(fm, name):
    j, jidx, tidx = fm[name]
    rng = np.random.default_rng(3)
    i = _rows_of_interest(j, rng)
    for c in range(4):
        cs = np.full(i.shape, c, np.int32)
        want = np.asarray(jrank.rank(jidx, jnp.asarray(cs), jnp.asarray(i)))
        got = trank.rank(tidx, T(cs), T(i))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"c={c}")
        # rank is the count of c in the BWT prefix, '$' left out
        if name == "small":
            bwt = jalphabet.unpack_2bit(j.bwt_packed, j.n + 1).astype(
                np.int64)
            bwt[j.zoff] = -1
            np.testing.assert_array_equal(
                got.numpy(), [(bwt[:x] == c).sum() for x in i])
        want = np.asarray(jrank.lf(jidx, jnp.asarray(i), jnp.asarray(cs)))
        np.testing.assert_array_equal(trank.lf(tidx, T(i), T(cs)).numpy(),
                                      want)
    # 2-D shapes and mixed symbols
    i2 = rng.integers(0, j.n + 2, (6, 9)).astype(np.int32)
    c2 = rng.integers(0, 4, (6, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        trank.rank(tidx, T(c2), T(i2)).numpy(),
        np.asarray(jrank.rank(jidx, jnp.asarray(c2), jnp.asarray(i2))))
    top = i2
    bot = np.minimum(top + rng.integers(0, 300, top.shape), j.n + 1
                     ).astype(np.int32)
    wt, wb = jrank.lf_step_interval(jidx, jnp.asarray(top), jnp.asarray(bot),
                                    jnp.asarray(c2))
    gt, gb = trank.lf_step_interval(tidx, T(top), T(bot), T(c2))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


def test_packed_char(fm):
    j, jidx, tidx = fm["big"]
    rng = np.random.default_rng(4)
    m = j.n + 1
    pos = np.concatenate([[0, 1, 15, 16, 17, m - 1],
                          rng.integers(0, m, 200)]).astype(np.int32)
    for key in ("bwt_packed", "text_packed"):
        p = pos if key == "bwt_packed" else np.minimum(pos, j.n - 1)
        want = np.asarray(jrank.packed_char(jidx[key], jnp.asarray(p)))
        got = trank.packed_char(tidx[key], T(p))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    np.testing.assert_array_equal(
        trank.bwt_char(tidx, T(pos)).numpy(),
        np.asarray(jrank.bwt_char(jidx, jnp.asarray(pos))))


@pytest.mark.parametrize("name", ["big", "o2", "o4"])
def test_locate_rows(fm, name):
    j, jidx, tidx = fm[name]
    full = fm["big"][0].sa
    rng = np.random.default_rng(5)
    m, z = j.n + 1, j.zoff
    rows = np.concatenate([[0, z - 1, z + 1, m - 1, 1, 2],
                           rng.integers(0, m, 250)]).astype(np.int32)
    rows = rows[rows != z].reshape(-1, 4)[:60]
    want = np.asarray(jlocate.locate_rows(jidx, jnp.asarray(rows)))
    got = tlocate.locate_rows(tidx, T(rows))
    assert got.dtype == torch.int32 and got.shape == rows.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a sampled SA changes memory, never answers
    np.testing.assert_array_equal(got.numpy(), full[rows])
    # the '$' row and out-of-range rows: whatever the JAX function gives
    odd = np.array([z, -5, m, m + 40], np.int32)
    np.testing.assert_array_equal(
        tlocate.locate_rows(tidx, T(odd)).numpy(),
        np.asarray(jlocate.locate_rows(jidx, jnp.asarray(odd))))
    assert int(tlocate.locate_rows(tidx, T(np.array([0])))[0]) == j.n


@pytest.mark.parametrize("name", ["big", "o4"])
def test_expand_range_and_walk_left(fm, name):
    j, jidx, tidx = fm[name]
    rng = np.random.default_rng(6)
    m = j.n + 1
    top = rng.integers(0, m, (12, 5)).astype(np.int32)
    bot = (top + rng.integers(-2, 12, top.shape)).astype(np.int32)
    bot[0, 0] = m + 3                      # rows past the end are clipped
    wl, wv = jlocate.expand_range(jidx, jnp.asarray(top), jnp.asarray(bot), 8)
    gl, gv = tlocate.expand_range(tidx, T(top), T(bot), 8)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    rows = np.concatenate([[0, j.zoff, j.zoff - 1, j.zoff + 1, m - 1],
                           rng.integers(0, m, 40)]).astype(np.int32)
    for steps in (0, 1, 7):
        want = np.asarray(jlocate.lf_walk_left(jidx, jnp.asarray(rows),
                                               steps))
        got = tlocate.lf_walk_left(tidx, T(rows), steps)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(steps))
    if name == "big":
        # walking left from row 0 spells the text backwards
        r = T(np.array([0], np.int32))
        back = []
        for _ in range(20):
            back.append(int(trank.bwt_char(tidx, r)[0]))
            r = tlocate.lf_walk_left(tidx, r, 1)
        np.testing.assert_array_equal(back, j.ref.joined[-20:][::-1])


def _fm_reads(joined, rng, R, L):
    """R reads of codes 0..4 padded to L: exact cuts, mismatches, Ns,
    random reads, short reads (some under 22 bp), and reads broken into
    many segments."""
    seqs = np.full((R, L), 4, np.int32)
    lens = rng.integers(L - 30, L + 1, R).astype(np.int32)
    lens[:6] = [0, 5, 12, 21, 22, 23]
    for i in range(R):
        s = int(rng.integers(0, joined.size - L))
        r = joined[s:s + lens[i]].astype(np.int32)
        kind = i % 6
        if kind == 1:
            mm = rng.random(lens[i]) < 0.03
            r[mm] = (r[mm] + 1) % 4
        elif kind == 2:
            r[rng.random(lens[i]) < 0.04] = 4
        elif kind == 3:
            r = rng.integers(0, 4, lens[i]).astype(np.int32)
        elif kind == 4 and lens[i] > 40:
            r[::4] = 4                     # more segments than max_hits
        seqs[i, :lens[i]] = r
    return seqs, lens


@pytest.mark.parametrize("name", ["big", "small"])
def test_exact_interval(fm, name):
    j, jidx, tidx = fm[name]
    rng = np.random.default_rng(7)
    seqs, lens = _fm_reads(j.ref.joined, rng, 48, 64)
    lens = np.minimum(lens, 64)
    wt, wb = jax.jit(jsearch.exact_interval)(jidx, jnp.asarray(seqs),
                                             jnp.asarray(lens))
    gt, gb = tsearch.exact_interval(tidx, T(seqs), T(lens))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    w = (gb - gt).numpy()
    assert (w[0::6][1:] >= 1).all()        # exact cuts are found
    assert (w[2::6] <= 0).any() and (w[3::6] <= 0).all()   # N / absent


@pytest.mark.parametrize("name,max_hits", [("big", 16), ("big", 4),
                                           ("small", 16)])
def test_partial_search(fm, name, max_hits):
    j, jidx, tidx = fm[name]
    rng = np.random.default_rng(8)
    seqs, lens = _fm_reads(j.ref.joined, rng, 60, 104)
    want = jsearch.partial_search(jidx, jnp.asarray(seqs), jnp.asarray(lens),
                                  max_hits=max_hits)
    got = tsearch.partial_search(tidx, T(seqs), T(lens), max_hits=max_hits)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    n = got["n"].numpy()
    assert (n > max_hits).any()            # the drop path ran
    assert n[0] == 0 and (n[6:] >= 1).all()


@pytest.mark.parametrize("name,n_seeds", [("big", 8), ("big", 1),
                                          ("small", 16)])
def test_seed_search(fm, name, n_seeds):
    j, jidx, tidx = fm[name]
    rng = np.random.default_rng(9)
    seqs, lens = _fm_reads(j.ref.joined, rng, 60, 104)
    want = jsearch.seed_search(jidx, jnp.asarray(seqs), jnp.asarray(lens),
                               seed_len=22, n_seeds=n_seeds,
                               ftab_k=j.ftab_k)
    got = tsearch.seed_search(tidx, T(seqs), T(lens), seed_len=22,
                              n_seeds=n_seeds, ftab_k=j.ftab_k)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    ln = got["len"].numpy()
    assert (ln[:4] == 0).all() and (ln[4] == 22).all()   # under 22 bp: dead
    assert (ln[2::6][1:] == 0).any()                     # a seed holding an N
    assert ((got["bot"] - got["top"]).numpy()[0::6][1:] >= 1).all()
