"""The paired-end slice's operations in the port against the JAX
package's, exact:

  (a) ops/sw.ungapped_place_batch on random lanes with Ns, short and zero
      lengths, and placements that overhang the window;
  (b) ops/wire: encoded words equal JAX's for every lane table, and
      decode round-trips;
  (c) ops/sw.dp_fill_plain (the wide CUDA kernel's plain version) against
      JAX's dp_score_batch and dp_score_pallas(interpret=True) at the mate
      rescue's window (W = 1104), at W = 256, and at windows where the
      wide kernel's variants end (W + 1 = 384, 385, 1152, 1153; at the
      maximum, W + 1 = 2048, against dp_score_batch only);
  (f) on the CPU, dp_cuda.dp_score takes the plain version and counts no
      launch, at a wide window too.

The wide kernel itself is held to dp_fill_plain by the gpu-marked tests at
the end, which skip where no card is present. Inputs come from a numpy
seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align.scoring import Scoring as JScoring
from hisat2_tpu.ops import wire as jwire
from hisat2_tpu.ops.dp_pallas import dp_score_pallas
from hisat2_tpu.ops.sw import dp_score_batch as j_dp_score_batch
from hisat2_tpu.ops.sw import ungapped_place_batch as j_ungapped

from chip_smoke import edge_case_shape, edge_windows, make_dp_case
from hisat2_tpu_torch.align.scoring import Scoring
from hisat2_tpu_torch.ops import dp_cuda, wire
from hisat2_tpu_torch.ops.sw import (dp_fill_plain, dp_inputs,
                                     ungapped_place_batch)

torch.set_num_threads(1)

L = 104


def placement_case(seed, C=40, W=300):
    """Reads cut from their windows, some hanging off either end of the
    window (the rest random), with mismatches and Ns; a few unrelated
    reads; lengths from 0 to L."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, (C, W)).astype(np.int32)
    ref[rng.random((C, W)) < 0.01] = 4
    lens = rng.integers(1, L + 1, C).astype(np.int32)
    lens[:4] = [0, 1, 17, L]
    rd = rng.integers(0, 4, (C, L)).astype(np.int32)
    for i in range(C):
        ln = int(lens[i])
        s = int(rng.integers(-ln // 2, W - ln // 2 + 1))
        for p in range(ln):
            if 0 <= s + p < W:
                rd[i, p] = ref[i, s + p]
        m = rng.random(L) < 0.04
        rd[i, m] = rng.integers(0, 5, int(m.sum()))
    rd[5] = rng.integers(0, 4, L)
    rd[6, ::7] = 4
    rd[np.arange(L)[None, :] >= lens[:, None]] = 4
    quals = rng.integers(0, 42, (C, L)).astype(np.int32)
    return rd, quals, lens, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_ungapped_place_matches_jax(seed):
    rd, quals, lens, ref = placement_case(seed)
    want = j_ungapped(JScoring().device_tables(), jnp.asarray(rd),
                      jnp.asarray(quals), jnp.asarray(lens),
                      jnp.asarray(ref))
    got = ungapped_place_batch(Scoring().device_tables("cpu"),
                               *(torch.from_numpy(a)
                                 for a in (rd, quals, lens, ref)))
    for name, g, w in zip(("best", "t0", "i1", "i2"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    t0 = got[1].numpy()
    # the case reaches placements off both ends of the window
    assert (t0 < 0).any() and (t0 + lens > ref.shape[1]).any()


TABLES = {
    "pe_pack": lambda: jwire.pe_pack_table(L, L, 6),
    "pe_rep": lambda: jwire.pe_rep_table(L, L),
    "se_pack": lambda: jwire.se_pack_table(L, 5, 10),
    "se_rep": lambda: jwire.se_rep_table(L),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_wire_matches_jax(name):
    table = TABLES[name]()
    assert table == getattr(wire, name + "_table")(
        *{"pe_pack": (L, L, 6), "pe_rep": (L, L), "se_pack": (L, 5, 10),
          "se_rep": (L,)}[name])
    rng = np.random.default_rng(len(name))
    B = 64
    lanes = np.zeros((B, len(table)), np.int16)
    for i, (bits, signed) in enumerate(table):
        if bits == 0:
            continue
        if signed:
            lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
        else:
            lo, hi = 0, 1 << bits
        v = rng.integers(lo, hi, B)
        v[:2] = [lo, hi - 1]                   # both ends of the width
        lanes[:, i] = v.astype(np.int64).astype(np.int16)
    want = np.asarray(jwire.encode_lanes(jnp.asarray(lanes), table))
    enc = wire.encode_lanes(torch.from_numpy(lanes), table)
    assert enc.dtype == torch.int32
    words = wire.as_words(enc.numpy())
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, want)
    np.testing.assert_array_equal(wire.decode_lanes(words, table), lanes)
    np.testing.assert_array_equal(wire.decode_lanes(words, table),
                                  jwire.decode_lanes(want, table))


def test_wire_pack_decoders_match_jax():
    """pe_pack_decode rebuilds the unshipped best lane; the report and SE
    decoders split multi-report rows; all as JAX's."""
    rng = np.random.default_rng(3)
    for dec, args, nw in (
            ("pe_pack_decode", (L, L, 6),
             jwire.n_words(jwire.pe_pack_table(L, L, 6))),
            ("pe_rep_decode", (L, L, 2),
             2 * jwire.n_words(jwire.pe_rep_table(L, L))),
            ("se_pack_decode", (L, 5, 10),
             jwire.n_words(jwire.se_pack_table(L, 5, 10))),
            ("se_rep_decode", (L, 3),
             3 * jwire.n_words(jwire.se_rep_table(L)))):
        words = rng.integers(0, 1 << 32, (16, nw), dtype=np.uint64).astype(
            np.uint32)
        np.testing.assert_array_equal(getattr(wire, dec)(words, *args),
                                      getattr(jwire, dec)(words, *args),
                                      err_msg=dec)


def _consts(sc):
    return dict(match_bonus=int(sc.match_bonus), n_pen=int(sc.n_pen),
                rd_open=int(sc.read_gap_open()),
                rd_ext=int(sc.read_gap_extend()),
                rf_open=int(sc.ref_gap_open()),
                rf_ext=int(sc.ref_gap_extend()))


@pytest.mark.parametrize("seed,C,W", [(10, 16, 1104), (11, 16, 256),
                                      (12, 16, 383), (13, 16, 384),
                                      (14, 16, 1151), (15, 16, 1152),
                                      (16, 8, 2047)])
def test_wide_dp_plain_matches_jax(seed, C, W):
    rd, quals, lens, ref = make_dp_case(seed, C, L, W)
    jsc = JScoring()
    want = np.asarray(j_dp_score_batch(
        jsc.device_tables(), jnp.asarray(rd), jnp.asarray(quals),
        jnp.asarray(lens), jnp.asarray(ref)))
    pen, scp_cum = (t.numpy() for t in dp_inputs(
        Scoring().device_tables("cpu"), torch.from_numpy(quals),
        torch.from_numpy(lens)))
    if W + 1 < 2048:    # the widest window: dp_score_batch alone, for time
        pallas = np.asarray(dp_score_pallas(
            jnp.asarray(rd), jnp.asarray(pen), jnp.asarray(lens),
            jnp.asarray(ref), jnp.asarray(scp_cum), interpret=True,
            **_consts(jsc)))
        np.testing.assert_array_equal(pallas, want)
    t = torch.from_numpy
    before = dict(dp_cuda.launches)
    got = dp_cuda.dp_score(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                           **Scoring().dp_consts())
    # (f) a CPU tensor takes the plain version: no kernel launch counted
    assert dp_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dp_fill_plain(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                      **_consts(Scoring())).numpy(), want)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the wide kernel runs only on the card")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "seed,C,W", [(20, 37, 256), (21, 513, 1104), (22, 19, 2047)]
    + [(100 + W, edge_case_shape(W)[0], W)
       for W in edge_windows("dp_score_wide")])
def test_wide_kernel_matches_plain(seed, C, W):
    """The one-block-per-candidate kernel at W + 1 in {257, 1105, 2048}
    and at every window where one of its variants ends."""
    _need_card()
    rd, quals, lens, ref = make_dp_case(seed, C, L, W)
    sc = Scoring()
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
    pen, scp_cum = dp_inputs(sc.device_tables(dev), t[1], t[2])
    args = (t[0], pen.contiguous(), t[2], t[3], scp_cum.contiguous())
    before = dict(dp_cuda.launches)
    got = dp_cuda.dp_score(*args, **sc.dp_consts())
    torch.cuda.synchronize()
    assert dp_cuda.launches["dp_score_wide"] == before["dp_score_wide"] + 1
    assert dp_cuda.launches["dp_score"] == before["dp_score"]
    assert torch.equal(got, dp_fill_plain(*args, **sc.dp_consts()))


@pytest.mark.gpu
def test_wide_kernel_refuses_past_its_maximum():
    """Past the one-block kernel's single pass (W + 1 > 2048) nothing is
    refused any more: the column-tiled form takes the window, counted in
    launches["dp_score_tiled"], equal to the plain version."""
    _need_card()
    sc = Scoring()
    dev = torch.device("cuda")
    for seed, W in ((23, 2048), (24, 2604), (25, 8191)):
        rd, quals, lens, ref = make_dp_case(seed, 33, L, W)
        t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
        pen, scp_cum = dp_inputs(sc.device_tables(dev), t[1], t[2])
        args = (t[0], pen.contiguous(), t[2], t[3], scp_cum.contiguous())
        before = dict(dp_cuda.launches)
        got = dp_cuda.dp_score(*args, **sc.dp_consts())
        torch.cuda.synchronize()
        assert dp_cuda.launches["dp_score_tiled"] \
            == before["dp_score_tiled"] + 1
        assert dp_cuda.launches["dp_score_wide"] == before["dp_score_wide"]
        assert torch.equal(got, dp_fill_plain(*args, **sc.dp_consts()))
