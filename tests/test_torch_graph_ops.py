"""The port's graph-index stages and the DP fill with the SNV overlay
against the JAX package's, stage by stage, exact (all int32).

On the genome and variants of test_torch_graph_index (the JAX graph index,
handed to the port as the same arrays): _stage_candidates with the patch-
to-genome translation, table-seeded and FM-seeded (table stripped);
verify_ungapped, _stage_fin_rows and _stage_dp on a graph bundle, with
candidates on and around SNV sites so the overlay decides scores. And the
DP alone: ops/sw.dp_fill_plain(..., ov), the plain version of the CUDA
kernel's overlay instantiation, against hisat2_tpu.ops.sw.dp_score_batch(
..., ov) at the SE shape and the rescue's wide window, with nibbles of
every kind (0, 1..4 naming the read base or not, 15) over real bases and
over N read and window bases; with an all-zero overlay it must equal the
call without one and the Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_dp_case, make_dp_ov
from test_torch_dp import consts, kernel_inputs
from test_torch_graph_index import MULTI_AT, graph_world
from test_torch_graph_pipeline import haplotype, strip_table
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import pipeline as jpipe
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.scoring import Scoring as JScoring
from hisat2_tpu.ops import extend as jextend
from hisat2_tpu.ops.dp_pallas import dp_score_pallas
from hisat2_tpu.ops.sw import dp_score_batch as j_dp_score_batch
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.scoring import Scoring
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.ops import dp_cuda, extend as textend
from hisat2_tpu_torch.ops.sw import dp_fill_plain, dp_score_batch

torch.set_num_threads(1)

B, L = 64, 104


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = graph_world(tmp_path_factory.mktemp("graph"))
    rng = np.random.default_rng(606)
    codes, snps = w["codes"], w["snps"]
    jfms = {"table": w["jfm"], "fm": strip_table(w["jfm"])}
    als = {k: (JAligner(j), TAligner(FMIndex.from_object(j), device="cpu"))
           for k, j in jfms.items()}
    # reads cut from a random haplotype over variant sites, some with
    # mismatches, Ns or a novel indel, some reverse-complemented
    seqs = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    starts = np.zeros(B, np.int64)
    sv = snps.jpos[snps.types == 0]
    for i in range(B):
        ln = 100 if i % 7 else int(rng.integers(40, 95))
        s = int(rng.choice(sv)) - int(rng.integers(5, ln - 5))
        s = min(max(s, 0), codes.size - ln - 20)
        r = haplotype(codes, snps, s, ln + 4, rng)
        if i % 5 == 1:
            p = int(rng.integers(20, ln - 20))
            r = np.concatenate([r[:p], r[p + 2:]])
        r = r[:ln].copy()
        if i % 3 == 0:
            m = rng.random(ln) < 0.03
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if i % 11 == 0:
            r[rng.integers(0, ln, 2)] = 4
        if i % 2:
            r = jalphabet.revcomp(r)
        seqs[i, :ln], lens[i], starts[i] = r, ln, s
    quals = rng.integers(2, 42, (B, L)).astype(np.uint8)
    return dict(w=w, als=als, seqs=seqs, quals=quals, lens=lens,
                starts=starts, rng=rng)


@pytest.mark.parametrize("name,seeder,nseeds,locs", [
    ("table", "table", 8, 8), ("table", "table_dense", 24, 8),
    ("fm", "seeds", 8, 8), ("fm", "segments", 16, 8), ("fm", "seeds", 8, 2)])
def test_stage_candidates_translates_patches(world, name, seeder, nseeds,
                                             locs):
    jal, tal = world["als"][name]
    seqs, quals, lens = world["seqs"], world["quals"], world["lens"]
    want = jpipe._stage_candidates(
        jal.idx, jal.sctab, jnp.asarray(seqs), jnp.asarray(quals),
        jnp.asarray(lens), nseeds, locs, 16, jal.min_seg_len, seeder,
        jal.fm.ftab_k)
    got = tpipe._stage_candidates(
        tal.idx, tal.sctab, T(seqs), T(quals), T(lens), nseeds, locs, 16,
        tal.min_seg_len, seeder, tal.fm.ftab_k)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # every live candidate is a genomic coordinate: none left in a patch
    pos = got["pos"].numpy()
    live = got["score"].numpy() > tpipe.NEG_INF
    assert live[:, 0].mean() >= 0.4      # the forward reads (half)
    assert (pos[live] < tal.fm.primary_n).all()
    assert tal.fm.n > tal.fm.primary_n


def test_patch_translation_is_what_finds_alt_reads(world):
    """With the patch tables emptied the same seeds land in the patch
    fragments and stay there: fewer reads verify."""
    jal, tal = world["als"]["table"]
    seqs, quals, lens = world["seqs"], world["quals"], world["lens"]
    args = (T(seqs), T(quals), T(lens), 8, 8, 16, tal.min_seg_len, "table",
            tal.fm.ftab_k)
    full = tpipe._stage_candidates(tal.idx, tal.sctab, *args)
    bare = dict(tal.idx)
    for k in ("patch_start", "patch_ref", "patch_vpos", "patch_shift",
              "patch_len"):
        bare[k] = tal.idx[k][:0]
    cut = tpipe._stage_candidates(bare, tal.sctab, *args)
    ok = lambda d: int((d["score"][:, 0] > tpipe.NEG_INF).sum())
    assert ok(cut) <= ok(full)
    assert (cut["pos"][cut["score"] > tpipe.NEG_INF]
            < tal.fm.primary_n).all()      # the fragment check holds them out


def _candidate_positions(world, K):
    """(B, K) candidate positions: the read's true start and shifts of it,
    the two-alt site, the text's ends, positions past primary_n."""
    rng = world["rng"]
    n0 = world["w"]["jfm"].primary_n
    pos = world["starts"][:, None] + rng.integers(-3, 4, (B, K))
    pos[:, 0] = world["starts"]
    pos[:, 1] = MULTI_AT - rng.integers(0, 100, B)
    pos[:8, 2] = [0, -1, -50, n0 - 104, n0 - 50, n0 - 1, n0, n0 + 300]
    return pos.astype(np.int32)


def test_verify_ungapped_with_overlay(world):
    jal, tal = world["als"]["table"]
    seqs, quals, lens = world["seqs"], world["quals"], world["lens"]
    pos = _candidate_positions(world, 10)
    valid = world["rng"].random(pos.shape) < 0.9
    want = jax.jit(jextend.verify_ungapped)(
        jal.idx, jal.sctab, jnp.asarray(seqs), jnp.asarray(quals),
        jnp.asarray(lens), jnp.asarray(pos), jnp.asarray(valid))
    got = textend.verify_ungapped(tal.idx, tal.sctab, T(seqs), T(quals),
                                  T(lens), T(pos), torch.from_numpy(valid))
    for k in ("score", "nmm", "nns", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the overlay decides: without it some of these score lower
    plain = {k: v for k, v in tal.idx.items() if k != "snv_packed"}
    base = textend.verify_ungapped(plain, tal.sctab, T(seqs), T(quals),
                                   T(lens), T(pos), torch.from_numpy(valid))
    assert (got["score"] >= base["score"]).all()
    assert (got["score"] > base["score"]).sum() > 10
    assert (got["nmm"] < base["nmm"]).sum() > 10


def test_stage_fin_rows_with_overlay(world):
    jal, tal = world["als"]["table"]
    seqs, quals, lens = world["seqs"], world["quals"], world["lens"]
    j2 = jpipe._with_revcomp(jnp.asarray(seqs), jnp.asarray(quals),
                             jnp.asarray(lens))
    t2 = tpipe._with_revcomp(T(seqs), T(quals), T(lens))
    pos = _candidate_positions(world, 3)
    # rows 0..B-1 finalize the forward read, B..2B-1 its reverse complement
    ppos = np.concatenate([pos[:, 0], pos[:, 0], pos[:, 1], pos[:, 2]])
    pfw = np.concatenate([np.ones(B, bool), np.zeros(B, bool),
                          np.ones(B, bool), np.ones(B, bool)])
    read_of = np.tile(np.arange(B, dtype=np.int32), 4)
    fin = jax.jit(jpipe._stage_fin_rows, static_argnames=("B", "max_mm"))
    want = np.asarray(fin(jal.idx, jal.sctab, *j2, jnp.asarray(ppos),
                          jnp.asarray(pfw), jnp.asarray(read_of), B=B,
                          max_mm=4))
    got = tpipe._stage_fin_rows(tal.idx, tal.sctab, *t2, T(ppos),
                                torch.from_numpy(pfw), T(read_of), B,
                                4).numpy()
    np.testing.assert_array_equal(got, want)
    # nmm (penalized) and nmm_all (every difference) now differ
    assert (got[:, 3] <= got[:, 4]).all()
    assert (got[:, 3] < got[:, 4]).sum() > 10


def test_stage_dp_with_overlay(world):
    jal, tal = world["als"]["table"]
    seqs, quals, lens = world["seqs"], world["quals"], world["lens"]
    j2 = jpipe._with_revcomp(jnp.asarray(seqs), jnp.asarray(quals),
                             jnp.asarray(lens))
    t2 = tpipe._with_revcomp(T(seqs), T(quals), T(lens))
    pos = _candidate_positions(world, 3)
    pos_top = np.concatenate([pos[:, :2], pos[:, 1:]]).astype(np.int32)
    pos_top[5, 1] = tpipe.BIG                 # a sentinel stays invalid
    rows = world["rng"].random(2 * B) < 0.8
    want = np.asarray(jpipe._stage_dp(
        jal.idx, jal.sctab, *j2, jnp.asarray(pos_top), jnp.asarray(rows),
        16, jal.sc_const))
    before = dict(dp_cuda.launches)
    got = tpipe._stage_dp(tal.idx, tal.sctab, *t2, T(pos_top),
                          torch.from_numpy(rows), 16, tal.sc_const).numpy()
    assert dp_cuda.launches == before       # CPU: the plain version
    np.testing.assert_array_equal(got, want)
    plain = {k: v for k, v in tal.idx.items() if k != "snv_packed"}
    base = tpipe._stage_dp(plain, tal.sctab, *t2, T(pos_top),
                           torch.from_numpy(rows), 16, tal.sc_const).numpy()
    assert (got >= base).all() and (got > base).sum() > 10
    assert got[5, 1] == tpipe.NEG_INF


# ---------------------------------------------------------------------------
# the DP fill alone
# ---------------------------------------------------------------------------

def _dp_case(seed, C, Lr, W):
    rd, quals, lens, ref = make_dp_case(seed, C, Lr, W)
    ov = make_dp_ov(seed, rd, ref)
    return rd, quals, lens, ref, ov


@pytest.mark.parametrize("seed,C,Lr,W", [
    (0, 64, 104, 136), (1, 64, 104, 136), (2, 8, 104, 1104),
    (3, 16, 24, 31), (4, 16, 104, 159), (5, 16, 104, 255)])
def test_plain_dp_with_overlay_matches_jax(seed, C, Lr, W):
    rd, quals, lens, ref, ov = _dp_case(seed, C, Lr, W)
    # nibbles of every kind, over real bases and over Ns on either side
    assert set(np.unique(ov)) == {0, 1, 2, 3, 4, 15}
    d = rd[:, :1] * 0 + ov[:, :Lr]          # overlay under the first diagonal
    assert ((d == rd + 1) & (rd < 4)).any() and ((d > 0) & (d < 5)
                                                  & (d != rd + 1)).any()
    assert ((ov > 0) & (ref == 4)).any() and (rd == 4).any()
    jsc = JScoring()
    want = np.asarray(j_dp_score_batch(
        jsc.device_tables(), jnp.asarray(rd), jnp.asarray(quals),
        jnp.asarray(lens), jnp.asarray(ref), jnp.asarray(ov)))
    sc = Scoring()
    pen, scp_cum = kernel_inputs(jsc, rd, quals, lens)
    got = dp_fill_plain(T(rd), T(pen), T(lens), T(ref), T(scp_cum),
                        ov=T(ov), **consts(sc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got2 = dp_score_batch(sc.device_tables("cpu"), T(rd), T(quals), T(lens),
                          T(ref), T(ov))
    np.testing.assert_array_equal(got2.numpy(), want)
    # the wrapper on CPU tensors: the plain version, at any width
    got3 = dp_cuda.dp_score(T(rd), T(pen), T(lens), T(ref), T(scp_cum),
                            ov=T(ov), **consts(sc))
    np.testing.assert_array_equal(got3.numpy(), want)
    base = dp_fill_plain(T(rd), T(pen), T(lens), T(ref), T(scp_cum),
                         **consts(sc)).numpy()
    assert (want >= base).all() and (want > base).any()


@pytest.mark.parametrize("seed,C,Lr,W", [(0, 64, 104, 136),
                                         (2, 8, 104, 1104)])
def test_zero_overlay_equals_no_overlay(seed, C, Lr, W):
    rd, quals, lens, ref = make_dp_case(seed, C, Lr, W)
    sc = Scoring()
    pen, scp_cum = kernel_inputs(sc, rd, quals, lens)
    args = (T(rd), T(pen), T(lens), T(ref), T(scp_cum))
    base = dp_fill_plain(*args, **consts(sc))
    zero = dp_fill_plain(*args, ov=torch.zeros_like(args[3]), **consts(sc))
    assert torch.equal(zero, base)
    pallas = np.asarray(dp_score_pallas(
        jnp.asarray(rd), jnp.asarray(pen), jnp.asarray(lens),
        jnp.asarray(ref), jnp.asarray(scp_cum), interpret=True,
        **consts(JScoring())))
    np.testing.assert_array_equal(zero.numpy(), pallas)


def test_overlay_semantics_cell_by_cell():
    """One read of 8 bases on its own window, one base changed: the score
    is the mismatch penalty unless the nibble names the read base or is 15;
    an N on either side keeps the N penalty whatever the nibble says."""
    sc = Scoring()
    k = consts(sc)
    ref = np.array([[0, 1, 2, 3, 0, 1, 2, 3]], np.int32)
    quals = np.full((1, 8), 40, np.int32)
    lens = np.array([8], np.int32)

    def score(read_base, ref_base, nib):
        rd, rf = ref.copy(), ref.copy()
        rd[0, 4], rf[0, 4] = read_base, ref_base
        ov = np.zeros_like(ref)
        ov[0, 4] = nib
        pen, scp = kernel_inputs(sc, rd, quals, lens)
        return int(dp_fill_plain(T(rd), T(pen), T(lens), T(rf), T(scp),
                                 ov=T(ov), **k)[0])
    mm = -int(sc.mm_pens()[40])
    assert score(0, 0, 0) == 0
    assert score(2, 0, 0) == mm
    assert score(2, 0, 3) == 0              # nibble = read base + 1
    assert score(2, 0, 2) == mm             # another allele's nibble
    assert score(2, 0, 15) == 0             # several alts
    assert score(4, 0, 15) == -int(sc.n_pen)     # read N
    assert score(2, 4, 3) == -int(sc.n_pen)      # window N
    assert score(0, 0, 4) == 0              # a match stays a match
