"""The port's DP fill (hisat2_tpu_torch/ops/sw.dp_fill_plain, the plain
version of the CUDA kernel) against the JAX package's lax.scan DP
(ops/sw.dp_score_batch) and its Pallas kernel in interpret mode
(ops/dp_pallas.dp_score_pallas): exact int32 equality on random batches
with soft clips, gaps, Ns and short reads, at the test_dp_pallas.py shape
at the main-path shape (L = 104, W = L + 2*16), and at the windows where
the one-warp kernel's variants end (W + 1 one short of, at and one past a
multiple of 32 columns), with make_dp_case's stress rows. The choice of
kernel variant for a window (dp_cuda.dispatch_plan) is checked here too:
it is plain Python. The CUDA kernel itself is compared with the plain
version by the gpu-marked tests, which skip where no card is present."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align.scoring import Scoring as JScoring
from hisat2_tpu.ops.dp_pallas import dp_score_pallas
from hisat2_tpu.ops.sw import dp_score_batch as j_dp_score_batch
from hisat2_tpu.ops.sw import dp_traceback as j_dp_traceback

from chip_smoke import edge_case_shape, edge_windows
from chip_smoke import make_dp_case as make_case
from hisat2_tpu_torch.align.scoring import Scoring
from hisat2_tpu_torch.ops import dp_cuda
from hisat2_tpu_torch.ops.sw import (dp_fill_plain, dp_inputs,
                                     dp_score_batch, dp_traceback)

torch.set_num_threads(1)


def kernel_inputs(sc, rd, quals, lens):
    qc = np.clip(quals, 0, 63)
    pen = sc.mm_pens()[qc].astype(np.int32)
    in_read = np.arange(rd.shape[1])[None, :] < lens[:, None]
    scp = np.where(in_read, sc.sc_pens()[qc], 0)
    scp_cum = np.concatenate([np.zeros((rd.shape[0], 1), np.int64),
                              np.cumsum(scp, axis=1)], axis=1)
    return pen, scp_cum.astype(np.int32)


def consts(sc):
    return dict(match_bonus=int(sc.match_bonus), n_pen=int(sc.n_pen),
                rd_open=int(sc.read_gap_open()),
                rd_ext=int(sc.read_gap_extend()),
                rf_open=int(sc.ref_gap_open()),
                rf_ext=int(sc.ref_gap_extend()))


# the last rows: W + 1 = 31, 32, 33 (one column a lane, and the step to
# two), 159, 160, 161 (the SE path's variant ends) and 255, 256 (the
# one-warp kernel's widest), each with the stress rows (C = 16)
CASES = [(0, 24, 60, 92), (1, 24, 60, 92), (2, 48, 104, 136),
         (30, 16, 24, 30), (31, 16, 24, 31), (32, 16, 24, 32),
         (33, 16, 104, 158), (34, 16, 104, 159), (35, 16, 104, 160),
         (36, 16, 104, 254), (37, 16, 104, 255)]


@pytest.mark.parametrize("seed,C,L,W", CASES)
def test_plain_dp_matches_jax(seed, C, L, W):
    rd, quals, lens, ref = make_case(seed, C, L, W)
    jsc = JScoring()
    want = np.asarray(j_dp_score_batch(
        jsc.device_tables(), jnp.asarray(rd), jnp.asarray(quals),
        jnp.asarray(lens), jnp.asarray(ref)))
    pen, scp_cum = kernel_inputs(jsc, rd, quals, lens)
    pallas = np.asarray(dp_score_pallas(
        jnp.asarray(rd), jnp.asarray(pen), jnp.asarray(lens),
        jnp.asarray(ref), jnp.asarray(scp_cum), interpret=True,
        **consts(jsc)))
    assert (pallas == want).all()

    sc = Scoring()
    t = torch.from_numpy
    got = dp_fill_plain(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                        **consts(sc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the batch entry point builds the same pen / scp_cum itself
    got2 = dp_score_batch(sc.device_tables("cpu"), t(rd), t(quals),
                          t(lens), t(ref))
    np.testing.assert_array_equal(got2.numpy(), want)
    pen_t, scp_t = dp_inputs(sc.device_tables("cpu"), t(quals), t(lens))
    np.testing.assert_array_equal(pen_t.numpy(), pen)
    np.testing.assert_array_equal(scp_t.numpy(), scp_cum)


def test_stress_rows_reach_the_plain_version():
    """The rows make_dp_case adds for the kernels' edges score as they
    are meant to under the plain version: the read hanging one N base over
    the window's end pays the clip of that base (2 at quality 40), where
    a column past the window matched as N would pay 1; the exact match
    ending in the last column scores 0; an all-N read of 70 bases pays
    the N penalty 70 times."""
    rd, quals, lens, ref = make_case(34, 16, 104, 159)
    sc = Scoring()
    pen, scp_cum = kernel_inputs(sc, rd, quals, lens)
    t = torch.from_numpy
    got = dp_fill_plain(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                        **consts(sc)).numpy()
    assert int(sc.n_pen) < int(sc.sc_pens()[40])
    assert got[15] == 0
    assert got[14] == -int(sc.sc_pens()[40])
    assert (rd[9] == 4).all() and got[9] == -int(sc.n_pen) * lens[9]
    assert rd[10, 0] == 4 and rd[10, lens[10] - 1] == 4
    assert (quals[11] == 2).all() and (quals[12] == 40).all()
    assert lens[13] == 104


@pytest.mark.parametrize("lo,hi", [(0, 255), (256, 767), (768, 1279),
                                   (1280, 1791), (1792, 2047)])
def test_dispatch_plan(lo, hi):
    """Every window gets a compiled variant that covers it with less than
    one thread-row of padding; W + 1 <= 256 takes the one-warp kernel."""
    for W in range(lo, hi + 1):
        plan = dp_cuda.dispatch_plan(W)
        assert plan.capacity >= W + 1
        assert plan.capacity - (W + 1) < 32 * plan.warps
        if W + 1 <= 256:
            assert plan == ("dp_score", 1, -(-(W + 1) // 32))
            assert 1 <= plan.cpl <= 8
        else:
            assert plan.kernel == "dp_score_wide"
            assert (plan.warps, plan.cpl) in dp_cuda.WIDE_VARIANTS
        assert plan.kernel in dp_cuda.launches


@pytest.mark.parametrize("W", [-1, 2048, 5000])
def test_dispatch_plan_refuses(W):
    """Only a negative window is refused. Past the widest one-pass
    variant (W + 1 > 2048: -X 1944 and up) the column-tiled form covers
    window, with and without the overlay: the fewest tiles of the widest
    tiled variant, each as narrow as that tile count allows."""
    if W < 0:
        with pytest.raises(ValueError):
            dp_cuda.dispatch_plan(W)
        return
    plan = dp_cuda.dispatch_plan(W)
    assert plan.kernel == "dp_score_tiled" and plan.tiled
    assert plan.warps == dp_cuda.WIDE_WARPS
    assert plan.cpl in dp_cuda.TILE_CPLS
    tiles = -(-(W + 1) // plan.capacity)
    widest = 32 * plan.warps * max(dp_cuda.TILE_CPLS)
    assert tiles == -(-(W + 1) // widest)
    assert all(32 * plan.warps * c * tiles < W + 1
               for c in dp_cuda.TILE_CPLS if c < plan.cpl)


def test_edge_windows_cover_every_variant():
    """chip_smoke's edge windows name each variant's capacity, one column
    short of it and one past it, and split between the two kernels."""
    narrow, wide = edge_windows("dp_score"), edge_windows("dp_score_wide")
    assert max(narrow) == 255 and min(wide) == 256 and max(wide) == 2047
    assert 1104 in wide and not set(narrow) & set(wide)
    for kernel, ws in (("dp_score", narrow), ("dp_score_wide", wide)):
        plans = {dp_cuda.dispatch_plan(W) for W in ws}
        assert {p.kernel for p in plans} == {kernel}
        for p in plans:
            cap = p.capacity
            assert cap - 1 in ws            # W + 1 == capacity
            assert cap - 2 in ws            # one column short
            assert cap == 2048 or cap in narrow + wide  # one past
    assert {(p.warps, p.cpl) for p in map(dp_cuda.dispatch_plan, wide)} \
        == set(dp_cuda.WIDE_VARIANTS)
    for W in narrow + wide:
        C, L = edge_case_shape(W)
        assert C >= 13 and L <= W


def test_wrapper_takes_plain_version_on_cpu():
    rd, quals, lens, ref = make_case(3, 8, 60, 92)
    sc = Scoring()
    pen, scp_cum = kernel_inputs(sc, rd, quals, lens)
    t = torch.from_numpy
    before = dp_cuda.launches["dp_score"]
    got = dp_cuda.dp_score(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                           **consts(sc))
    assert dp_cuda.launches["dp_score"] == before
    want = dp_fill_plain(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                         **consts(sc))
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_traceback_matches_jax(seed):
    rd, quals, lens, ref = make_case(seed, 12, 60, 92)
    sc, jsc = Scoring(), JScoring()
    for i in range(rd.shape[0]):
        if lens[i] == 0 or (ref[i] >= 4).all():
            continue
        r = rd[i, :lens[i]].astype(np.uint8)
        q = quals[i, :lens[i]]
        assert dp_traceback(sc, r, q, ref[i].astype(np.uint8)) == \
            j_dp_traceback(jsc, r, q, ref[i].astype(np.uint8))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "seed,C,L,W", [(0, 24, 60, 92), (1, 24, 60, 92), (2, 48, 104, 136),
                   (3, 8192, 104, 136), (4, 70, 150, 246), (5, 33, 40, 41)]
    + [(100 + W, *edge_case_shape(W), W) for W in edge_windows("dp_score")])
def test_dp_kernel_matches_plain(seed, C, L, W):
    """The one-warp kernel, at every window where a variant ends too."""
    _need_card()
    rd, quals, lens, ref = make_case(seed, C, L, W)
    sc = Scoring()
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
    pen, scp_cum = dp_inputs(sc.device_tables(dev), t[1], t[2])
    args = (t[0], pen.contiguous(), t[2], t[3], scp_cum.contiguous())
    before = dp_cuda.launches["dp_score"]
    got = dp_cuda.dp_score(*args, **sc.dp_consts())
    torch.cuda.synchronize()
    assert dp_cuda.launches["dp_score"] == before + 1
    want = dp_fill_plain(*args, **sc.dp_consts())
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_dp_kernel_refuses_bad_inputs():
    _need_card()
    sc = Scoring()
    z = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    lens = torch.full((4,), 8, dtype=torch.int32, device="cuda")
    scp = torch.zeros((4, 9), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        dp_cuda.dp_score(z.long(), z, lens, z, scp, **sc.dp_consts())
    with pytest.raises(ValueError):
        dp_cuda.dp_score(z, z, lens, z, scp[:, :8], **sc.dp_consts())
    # W + 1 = 2049 columns: past one pass of the wide kernel, the tiled
    # form takes it (nothing refused)
    wide = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
    assert dp_cuda.dp_score(z, z, lens, wide, scp,
                            **sc.dp_consts()).shape == (4,)
    # a plan that covers fewer columns than the window, or names a variant
    # that was not compiled, is refused by the library: no launch counted
    before = dict(dp_cuda.launches)
    ref = torch.zeros((4, 300), dtype=torch.int32, device="cuda")
    for plan in (dp_cuda.Plan("dp_score", 1, 8),
                 dp_cuda.Plan("dp_score_wide", 4, 2),
                 dp_cuda.Plan("dp_score_wide", 8, 4)):
        with pytest.raises(RuntimeError):
            dp_cuda.dp_score(z, z, lens, ref, scp, **sc.dp_consts(),
                             plan=plan)
    assert dp_cuda.launches == before
