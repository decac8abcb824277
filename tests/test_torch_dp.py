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

from chip_smoke import edge_case_shape, edge_windows, make_dp_ov
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
# one-warp kernel's widest before 12 columns a lane), each with the stress
# rows (C = 16); then a window past 2,048 columns with long reads (the
# 2,100 bp reads' W = 2136, in one pass of the one-block kernel)
CASES = [(0, 24, 60, 92), (1, 24, 60, 92), (2, 48, 104, 136),
         (30, 16, 24, 30), (31, 16, 24, 31), (32, 16, 24, 32),
         (33, 16, 104, 158), (34, 16, 104, 159), (35, 16, 104, 160),
         (36, 16, 104, 254), (37, 16, 104, 255), (38, 8, 300, 2136)]


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


@pytest.mark.parametrize("lo,hi", [(0, 383), (384, 1279), (1280, 2047),
                                   (2048, 4095), (4096, 5375)])
def test_dispatch_plan(lo, hi):
    """Every window gets a compiled variant that covers it in one pass
    with less than one thread-row of padding: W + 1 <= 384 (the 257-384
    band of 250 bp graph reads among them) the one-warp kernel at 1 to 12
    columns a lane; up to 2,048 the lockstep one-block kernel (4 warps);
    wider, up to ONE_PASS_COLS, the ring kernel with no more warps than its
    lane width allows, with or without the number of candidates, and with
    candidates enough to fill the card at RING_CPL columns a lane."""
    for W in range(lo, hi + 1):
        for C in (None, 16, 256, 512, 1024, 8192):
            plan = dp_cuda.dispatch_plan(W, C)
            assert plan.capacity >= W + 1
            assert plan.capacity - (W + 1) < 32 * plan.warps
            assert plan.tiles(W) == 1
            if W + 1 <= 384:
                assert plan == ("dp_score", 1, -(-(W + 1) // 32))
                assert 1 <= plan.cpl <= 12
            elif W + 1 <= 2048:
                assert plan.kernel == "dp_score_wide"
                assert (plan.warps, plan.cpl) in dp_cuda.WIDE_VARIANTS
            else:
                assert plan.kernel == "dp_score_ring" and plan.ring
                assert plan.cpl in dp_cuda.RING_CPLS
                assert 2 <= plan.warps <= dp_cuda.RING_MAX_WARPS[plan.cpl]
            assert plan.kernel in dp_cuda.launches
        plan = dp_cuda.dispatch_plan(W, 1 << 16)
        assert plan == dp_cuda.dispatch_plan(W)
        assert plan in dp_cuda.plans_for(W)
        if plan.ring and W + 1 <= 32 * 12 * dp_cuda.RING_MAX_WARPS[12]:
            assert plan.warps == -(-(W + 1) // (32 * dp_cuda.RING_CPL))


@pytest.mark.parametrize("W", [-1, 2048, 6144])
def test_dispatch_plan_refuses(W):
    """Only a negative window is refused. Past the lockstep kernel's
    2,048 columns (W = 2048) one pass of the ring kernel covers the
    window; past what one pass holds (W + 1 > ONE_PASS_COLS) the ring
    kernel walks it in column tiles of RING_MAX_WARPS[RING_CPL] warps at
    RING_CPL columns a lane, at least two, with or without the overlay."""
    if W < 0:
        with pytest.raises(ValueError):
            dp_cuda.dispatch_plan(W)
        return
    for C in (None, 16, 256, 512):
        plan = dp_cuda.dispatch_plan(W, C)
        assert plan.kernel == "dp_score_ring" and plan.ring
        if W + 1 <= dp_cuda.ONE_PASS_COLS:
            assert plan.tiles(W) == 1
            continue
        assert plan.cpl == dp_cuda.RING_CPL
        assert plan.warps == dp_cuda.RING_MAX_WARPS[dp_cuda.RING_CPL]
        assert plan.tiles(W) == -(-(W + 1) // plan.capacity) >= 2
    assert dp_cuda.ONE_PASS_COLS == max(
        32 * k * dp_cuda.RING_MAX_WARPS[k] for k in dp_cuda.RING_CPLS)


def test_edge_windows_cover_every_variant():
    """chip_smoke's edge windows name the columns each planned variant
    computes (its capacity, times its tiles), one column short of it and
    one past it, and split between the three kernels: the one-warp kernel
    to W + 1 = 384, the lockstep one to 2,048, the ring kernel past that
    (in one pass to ONE_PASS_COLS, then two and three tiles)."""
    narrow = edge_windows("dp_score")
    wide = edge_windows("dp_score_wide")
    ring = edge_windows("dp_score_ring")
    assert max(narrow) == 383 and min(wide) == 384 and max(wide) == 2047
    assert min(ring) == 2048
    assert 288 in narrow and 1104 in wide and 2136 in ring
    assert not set(narrow) & set(wide) and not set(wide) & set(ring)
    for kernel, ws in (("dp_score", narrow), ("dp_score_wide", wide),
                       ("dp_score_ring", ring)):
        plans = {dp_cuda.dispatch_plan(W) for W in ws}
        assert {p.kernel for p in plans} == {kernel}
        for W in ws:
            p = dp_cuda.dispatch_plan(W)
            cols = p.capacity * p.tiles(W)
            if cols - 1 > max(ring):        # past the windows checked
                continue
            assert cols - 1 in ws           # W + 1 == the columns computed
            assert cols - 2 in ws           # one column short
            assert cols in narrow + wide + ring     # one past
    assert {(p.warps, p.cpl) for p in map(dp_cuda.dispatch_plan, wide)} \
        == set(dp_cuda.WIDE_VARIANTS)
    assert {p.tiles(W) for W in ring for p in [dp_cuda.dispatch_plan(W)]} \
        == {1, 2, 3, 4}
    for W in narrow + wide + ring:
        C, L = edge_case_shape(W)
        assert C >= 13 and L <= W


# ---------------------------------------------------------------------------
# the one-block kernel's hand-off, modelled in numpy
# ---------------------------------------------------------------------------

NEG = -(1 << 28)


class _WarpModel:
    """One warp of csrc/dp_score.cu's dp_score_wide_kernel on one
    candidate: its 32 * CPL columns of the current tile, the row it is at,
    and the values it keeps between rows."""

    def __init__(self, w):
        self.w, self.tile, self.i, self.phase, self.done = w, 0, 0, "read", 0
        self.best = None


def model_wide(rd, pen, lens, ref, scp_cum, consts_, plan, ov=None,
               order="random", seed=0):
    """Scores of the one-block kernel under `plan` as a numpy model of its
    rule: warp w of tile t fills columns t * cap + w * 32 * CPL onwards;
    at row s = t * len + i it reads (the running-max prefix of the row
    left of its columns, the H of the column left of them after the row)
    from the slot s % dp_cuda.RING of the left warp's ring, or for warp 0
    after the first tile from the carry of row i, once the count it reads
    passes s (the carry: s - len); it writes its own pair to its ring once
    the right warp's count reaches s - RING + 1 (the last warp: to the
    carry, no wait) and then counts the row. The warps run in an order
    that respects only those waits: "random", "left" (the leftmost that
    can, so rings fill up) or "right". Every read must find the row it
    expects and every write a slot already read; a state where no warp
    can run is a deadlock. Returns the (C,) int32 scores."""
    R = dp_cuda.RING
    mb, npen = consts_["match_bonus"], consts_["n_pen"]
    ro, re_ = consts_["rd_open"], consts_["rd_ext"]
    fo, fe = consts_["rf_open"], consts_["rf_ext"]
    C, L = rd.shape
    W = ref.shape[1]
    NW, CPL = plan.warps, plan.cpl
    cap = plan.capacity
    ntiles = -(-(W + 1) // cap)
    assert plan.ring
    rng = np.random.default_rng(seed)
    out = np.zeros(C, np.int64)
    for c in range(C):
        n = int(min(max(lens[c], 0), L))
        scp_tot = int(scp_cum[c, L])
        # substitution score of row i in column j >= 1, as dp_fill_plain
        rc = rd[c][:, None].astype(np.int64)
        rf = ref[c][None, :].astype(np.int64)
        isn = (rc >= 4) | (rf >= 4)
        mm = (rc != rf) & ~isn
        if ov is not None:
            o = ov[c][None, :]
            mm &= ~((o == rc + 1) | (o == 15))
        sub = np.where(mm, -pen[c][:, None].astype(np.int64),
                       np.where(isn, -npen, mb))
        ring = {w: [None] * R for w in range(NW)}   # (s, prefix, H, read)
        carry = [None] * L                          # (tile, prefix, H, read)
        warps = [_WarpModel(w) for w in range(NW)]
        done = [0] * NW

        def start_tile(m):
            j0 = m.tile * cap + m.w * 32 * CPL
            m.J = np.arange(j0, min(j0 + 32 * CPL, W + 1))
            m.H = np.zeros(m.J.size, np.int64)
            m.F = np.full(m.J.size, NEG, np.int64)
            m.hold = 0 if 1 <= j0 <= W + 1 else NEG
            if m.best is None:
                m.best = -scp_tot

        def end_tile(m):
            if m.J.size:
                m.best = max(m.best, int(m.H.max()))
            m.tile += 1
            m.i = 0
            if m.tile < ntiles:
                start_tile(m)

        for m in warps:
            start_tile(m)
            if n == 0:
                while m.tile < ntiles:
                    end_tile(m)

        def can_run(m):
            if m.tile >= ntiles:
                return False
            s = m.tile * n + m.i
            if m.phase == "read":
                if m.w > 0:
                    return done[m.w - 1] > s
                return m.tile == 0 or done[NW - 1] > s - n
            return m.w == NW - 1 or done[m.w + 1] >= s - R + 1

        def read_row(m):
            s = m.tile * n + m.i
            if m.w > 0:
                slot = ring[m.w - 1][s % R]
                assert slot is not None and slot[0] == s, (s, slot)
                ring[m.w - 1][s % R] = slot[:3] + (True,)
                pin, hnext = slot[1], slot[2]
            elif m.tile > 0:
                slot = carry[m.i]
                assert slot is not None and slot[0] == m.tile - 1
                carry[m.i] = slot[:3] + (True,)
                pin, hnext = slot[1], slot[2]
            else:
                pin, hnext = NEG, NEG
            i, J = m.i, m.J
            col0 = -(fo + i * fe)
            clip5 = int(scp_cum[c, i + 1])
            if J.size:
                diag = np.concatenate([[m.hold], m.H[:-1]])
                Fn = np.maximum(m.H - fo, m.F - fe)
                G = np.maximum(diag + sub[i, np.maximum(J - 1, 0)], Fn)
                if J[0] == 0:
                    G[0] = Fn[0] = col0
                Mloc = np.maximum.accumulate(G + re_ * J)
                left = np.maximum(pin, np.concatenate([[NEG], Mloc[:-1]]))
                Hn = np.maximum(G, left - (ro + re_ * (J - 1)))
                if J[0] == 0:
                    Hn[0] = col0
                Hn = np.maximum(Hn, -clip5)
                m.H, m.F = Hn, Fn
                m.best = max(m.best, int(Hn.max()) - (scp_tot - clip5))
                m.out = (max(pin, int(Mloc[-1])), int(Hn[-1]))
            else:                       # all past the window: passes on
                m.out = (pin, NEG)
            m.hold = hnext
            m.phase = "write"

        def write_row(m):
            s = m.tile * n + m.i
            if m.w < NW - 1:
                old = ring[m.w][s % R]
                assert old is None or (old[0] == s - R and old[3]), (s, old)
                ring[m.w][s % R] = (s,) + m.out + (False,)
            elif m.tile + 1 < ntiles:
                old = carry[m.i]
                assert old is None or (old[0] == m.tile - 1 and old[3])
                carry[m.i] = (m.tile,) + m.out + (False,)
            done[m.w] = s + 1
            m.phase = "read"
            m.i += 1
            if m.i == n:
                end_tile(m)

        while any(m.tile < ntiles for m in warps):
            ready = [m for m in warps if can_run(m)]
            assert ready, f"deadlock at counts {done}"
            m = (ready[int(rng.integers(len(ready)))] if order == "random"
                 else ready[0] if order == "left" else ready[-1])
            (read_row if m.phase == "read" else write_row)(m)
        out[c] = max(m.best for m in warps)
    return out.astype(np.int32)


# (warps, columns a lane, tiles, C, L, W, overlay): one pass, and column
# tiles from 2 to 8 (more tiles than the ring has slots, more warps than
# slots, both overlay mask widths, a tile of 2 warps)
RING_CASES = [(4, 5, 1, 8, 40, 600, False), (2, 3, 2, 8, 40, 300, True),
              (3, 4, 3, 6, 30, 1104, False), (2, 9, 2, 6, 24, 1104, True),
              (5, 3, 4, 6, 20, 1500, False), (14, 5, 1, 6, 16, 2136, True),
              (2, 3, 8, 6, 12, 1500, False)]


@pytest.mark.parametrize("nw,cpl,tiles,C,L,W,with_ov", RING_CASES)
def test_ring_model_matches_plain(nw, cpl, tiles, C, L, W, with_ov):
    """The one-block kernel's rule (model_wide: the rings, their depth,
    the slot a row uses, the counts each wait reads, the carry between
    tiles) gives dp_fill_plain's scores exactly under three orders of the
    warps, never reads a slot before its row is written or overwrites one
    before it is read, and never deadlocks."""
    plan = dp_cuda.Plan("dp_score_ring", nw, cpl)
    rd, quals, lens, ref = make_case(500 + W + nw, C, L, W)
    sc = Scoring()
    pen, scp_cum = kernel_inputs(sc, rd, quals, lens)
    ov = make_dp_ov(W, rd, ref) if with_ov else None
    t = torch.from_numpy
    want = dp_fill_plain(t(rd), t(pen), t(lens), t(ref), t(scp_cum),
                         ov=None if ov is None else t(ov), **consts(sc))
    assert plan.tiles(W) == tiles
    for k, order in enumerate(("random", "left", "right")):
        got = model_wide(rd, pen, lens, ref, scp_cum, consts(sc), plan, ov,
                         order, seed=k)
        np.testing.assert_array_equal(got, want.numpy())


def test_kernel_tables_match_the_source():
    """dp_cuda's tables of the ring kernel (RING, RING_MAX_WARPS,
    RING_CPLS), the lockstep kernel's lane widths (WIDE_VARIANTS) and the
    one-warp kernel's widest are the ones csrc/dp_score.cu compiles."""
    import re
    src = open(dp_cuda.SOURCE).read()
    assert int(re.search(r"constexpr int kRing = (\d+);", src).group(1)) \
        == dp_cuda.RING
    body = re.search(r"constexpr int kRingMaxWarps\(int cpl\)\s*\{(.*?)\}",
                     src, re.S).group(1)
    expr = re.sub(r"\s+", " ", body.replace("return", "").strip(" ;\n"))
    # the C ternary chain, read as Python
    py = re.sub(r"(\w+ <= \d+) \? (\d+) :", r"\2 if \1 else", expr)
    for k in dp_cuda.RING_CPLS:
        assert eval(py, {"cpl": k}) == dp_cuda.RING_MAX_WARPS[k], k
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert tuple(range(const("kMinCpl"), const("kRingMaxCpl") + 1)) \
        == dp_cuda.RING_CPLS
    assert [k for _, k in dp_cuda.WIDE_VARIANTS] \
        == list(range(const("kWideMinCpl"), const("kMaxCpl") + 1))
    narrow = re.findall(r"DP_NARROW\((\d+)\)", src)
    assert max(map(int, narrow)) * 32 == dp_cuda.NARROW_MAX_COLS


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
                   (3, 8192, 104, 136), (4, 70, 150, 246), (5, 33, 40, 41),
                   (6, 256, 2104, 2136), (7, 1024, 256, 288)]
    + [(100 + W, *edge_case_shape(W), W) for W in edge_windows("dp_score")])
def test_dp_kernel_matches_plain(seed, C, L, W):
    """The one-warp kernel, at every window where a variant ends too (to
    12 columns a lane, W + 1 = 384), and the two shapes redesigned for
    Hopper at the main path's C: 2,100 bp reads (the one-block kernel in
    one pass) and 250 bp reads' 289 columns (the one-warp kernel)."""
    _need_card()
    rd, quals, lens, ref = make_case(seed, C, L, W)
    sc = Scoring()
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
    pen, scp_cum = dp_inputs(sc.device_tables(dev), t[1], t[2])
    args = (t[0], pen.contiguous(), t[2], t[3], scp_cum.contiguous())
    kernel = dp_cuda.dispatch_plan(W, C).kernel
    before = dp_cuda.launches[kernel]
    got = dp_cuda.dp_score(*args, **sc.dp_consts())
    torch.cuda.synchronize()
    assert dp_cuda.launches[kernel] == before + 1
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
    # W + 1 = 2049 columns and past one pass (5,377): the ring kernel
    # takes them, in one pass and in tiles (nothing refused)
    for w in (2048, dp_cuda.ONE_PASS_COLS):
        wide = torch.zeros((4, w), dtype=torch.int32, device="cuda")
        assert dp_cuda.dp_score(z, z, lens, wide, scp,
                                **sc.dp_consts()).shape == (4,)
    # a plan that covers fewer columns than the window in one pass, or
    # names a variant that was not compiled (a lane width, a lockstep
    # block of other than 4 warps, a ring of 1 warp or of more warps than
    # its lane width allows), is refused by the library: no launch counted
    before = dict(dp_cuda.launches)
    for W, plan in ((499, dp_cuda.Plan("dp_score", 1, 12)),
                    (299, dp_cuda.Plan("dp_score", 1, 13)),
                    (299, dp_cuda.Plan("dp_score_wide", 4, 3)),
                    (499, dp_cuda.Plan("dp_score_wide", 8, 4)),
                    (499, dp_cuda.Plan("dp_score_ring", 1, 16)),
                    (499, dp_cuda.Plan("dp_score_ring", 2, 2)),
                    (499, dp_cuda.Plan("dp_score_ring", 33, 3)),
                    (499, dp_cuda.Plan("dp_score_ring", 13, 12))):
        ref = torch.zeros((4, W), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            dp_cuda.dp_score(z, z, lens, ref, scp, **sc.dp_consts(),
                             plan=plan)
    assert dp_cuda.launches == before
