"""The port's index code against the JAX package's: the same reference
builds the same arrays, an index saved by hisat2_tpu loads in the port,
and the port's device bundle equals the JAX package's device dict on
every key the seed-table SE path reads. Exact equality throughout."""

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.index.fm_index import FMIndex as JFMIndex
from hisat2_tpu.index.fm_index import build_fm_index as jbuild
from hisat2_tpu.index.seed_table import build_seed_table as jseed_table
from hisat2_tpu.io.reference import reference_from_seqs as jref_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.index.fm_index import FMIndex, build_fm_index
from hisat2_tpu_torch.index.seed_table import build_seed_table, pick_kt
from hisat2_tpu_torch.io.reference import reference_from_seqs

torch.set_num_threads(1)

BUILD_KEYS = ("bwt_packed", "text_packed", "occ", "ccount", "sa", "ftab",
              "st_starts", "st_pos")
BUNDLE_KEYS = ("text_packed", "text_rows", "text_rows_ov", "st_starts",
               "st_pairs", "st_pos_rows", "frag_joined", "frag_end",
               "frag_tidx")


def _seqs(seed, sizes):
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(sizes):
        s = jalphabet.decode(rng.integers(0, 4, n).astype(np.uint8))
        if i == 0 and n > 5000:
            s = s[:4000] + "N" * 25 + s[4025:]
        out[f"chr{i}"] = s
    return out


@pytest.mark.parametrize("sizes", [(30000, 12000), (777,), (40000, 3, 900)])
def test_build_matches_jax(sizes):
    seqs = _seqs(len(sizes), sizes)
    j = jbuild(jref_from_seqs(seqs))
    t = build_fm_index(reference_from_seqs(seqs))
    assert (t.n, t.zoff, t.ftab_k, t.st_k) == (j.n, j.zoff, j.ftab_k, j.st_k)
    for k in BUILD_KEYS:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    for k in ("joined", "frag_joined", "frag_toff", "frag_tidx", "frag_len",
              "tlens"):
        np.testing.assert_array_equal(getattr(t.ref, k), getattr(j.ref, k),
                                      err_msg=k)
    assert t.ref.names == j.ref.names


@pytest.mark.parametrize("n", [20000, 70000])
def test_seed_table_matches_jax(n):
    text = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    for kt in (None, 9):
        want = jseed_table(text, kt=kt)
        got = build_seed_table(text, kt=kt)
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # the E. coli K-12 length used by chip_smoke.py takes the widest table
    assert pick_kt(4_641_652) == 13


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    j = jbuild(jref_from_seqs(_seqs(5, (26000, 20000))))
    prefix = str(tmp_path_factory.mktemp("idx") / "bundle")
    j.save(prefix)
    return j, prefix


def test_load_and_bundle_match_jax(saved):
    j, prefix = saved
    t = FMIndex.load(prefix)
    for k in BUILD_KEYS:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    jdev = j.device
    bundle = t.device_bundle("cpu")
    for k in BUNDLE_KEYS:
        got = bundle[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", k
        want = np.asarray(jdev[k])
        assert got.dtype == (torch.int64 if want.dtype == np.uint32
                             else torch.int32), k
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=k)
    assert bundle["n"] == int(jdev["n"])
    assert bundle["st_k"] == j.st_k
    assert bundle["st_stride"] == jdev["st_stride_m"].shape[0]
    # packed words whose last base is G or T carry bit 31
    assert int(bundle["text_packed"].max()) >= (1 << 31)


def test_from_arrays_round_trip(saved):
    j, prefix = saved
    t = FMIndex.load(prefix)
    with np.load(prefix + ".npz") as z:
        fields = {k: z[k] for k in z.files}
    fields.update(n=j.n, zoff=j.zoff, ftab_k=j.ftab_k, names=j.ref.names,
                  st_k=j.st_k, st_stride=j.st_stride)
    u = FMIndex.from_arrays(fields)
    a, b = u.device_bundle("cpu"), t.device_bundle("cpu")
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    # and a port-saved index loads back in the JAX package
    prefix2 = prefix + "_port"
    u.save(prefix2)
    back = JFMIndex.load(prefix2)
    for k in BUILD_KEYS:
        np.testing.assert_array_equal(getattr(back, k), getattr(j, k),
                                      err_msg=k)


def test_bundle_without_pairs_above_kt12(saved):
    """kt = 13 tables carry no st_pairs (4^13 pair rows would add 512 MB
    on the card), so table_lookup takes its two-gather branch."""
    j, prefix = saved
    t = FMIndex.load(prefix)
    t.st_starts = np.zeros(4 ** 13 + 1, np.int32)
    t.st_k = 13
    bundle = t.device_bundle("cpu")
    assert "st_pairs" not in bundle and bundle["st_k"] == 13
