"""The two seed-table modes of Gbp-scale shards, port against JAX package:
the paired-k-mer intersect mode (bucket load above 3) and stride-sampled
tables (st_stride 2 and 3), alone and together, with table_lookup's
spread seeds (stride=0) and its dense pass (stride=4). One 46 kb genome
with an N run and a planted repeat; the tables are built by the JAX
package over it and handed to the port as the same arrays. Every key of
the returned dict must be equal, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.ops import search as jsearch
from hisat2_tpu.utils import alphabet as jalphabet

from test_torch_fm_ops import variant
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)

# (kt, table stride): load 46000 / 4^kt decides the pair mode
TABLES = {"pair": (6, 1), "stride2": (9, 2), "stride3": (9, 3),
          "pair_stride2": (6, 2), "pair_stride3": (5, 3),
          "pair_deep": (4, 1)}     # buckets of ~180 overflow the 48 slots


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(41)
    g = rng.integers(0, 4, 46000).astype(np.uint8)
    g[30000:30400] = g[5000:5400]
    s = jalphabet.decode(g)
    s = s[:9000] + "N" * 40 + s[9040:]
    base = build_fm_index(reference_from_seqs({"chrS": s}), seed_table=False)
    out = {}
    for name, (kt, stride) in TABLES.items():
        j = variant(base, table=(kt, stride))
        out[name] = (j, j.device, FMIndex.from_object(j).device_bundle("cpu"))
    return out


def _reads(joined, rng, R, L):
    seqs = np.full((R, L), 4, np.int32)
    lens = rng.integers(L - 30, L + 1, R).astype(np.int32)
    lens[:5] = [0, 5, 11, 12, 19]
    for i in range(R):
        s = int(rng.integers(0, joined.size - L))
        if i % 5 == 4:
            s = 5000 + int(rng.integers(0, 300))       # the repeat
        r = joined[s:s + lens[i]].astype(np.int32)
        mm = rng.random(lens[i]) < 0.03
        r[mm] = rng.integers(0, 5, int(mm.sum()))
        if i % 7 == 0:
            r = rng.integers(0, 4, lens[i])
        seqs[i, :lens[i]] = r
    return seqs, lens


@pytest.mark.parametrize("stride,n_seeds", [(0, 8), (4, 24)])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_lookup_modes(tables, name, stride, n_seeds):
    j, jidx, tidx = tables[name]
    kt, st = TABLES[name]
    pair = name.startswith("pair")
    assert tidx["st_k"] == kt and tidx["st_stride"] == st
    assert (tidx["st_pos_rows"].numel() / 4 ** kt > 3.0) == pair
    assert tidx["st_pos_rows"].shape[1] == (128 if pair else 32)
    rng = np.random.default_rng(kt * 10 + st)
    seqs, lens = _reads(j.ref.joined, rng, 64, 104)
    tl = jax.jit(jsearch.table_lookup,
                 static_argnames=("n_seeds", "locs_per_seg", "stride"))
    want = tl(jidx, jnp.asarray(seqs), jnp.asarray(lens), n_seeds=n_seeds,
              locs_per_seg=8, stride=stride)
    got = tsearch.table_lookup(tidx, T(seqs), T(lens), n_seeds=n_seeds,
                               locs_per_seg=8, stride=stride)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == (torch.bool if w.dtype == bool
                                else torch.int32), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the mode found something: valid seed hits on the reads' own diagonals
    lv = got["lvalid"].numpy()
    assert lv[5:].any(axis=(1, 2)).mean() > 0.5
    if st > 1:
        # only sampled positions are stored
        assert (got["locs"].numpy()[lv] % st == 0).all()
    if name == "pair_deep":
        assert not got["exhausted"].numpy()[5:].any()
