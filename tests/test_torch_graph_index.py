"""The port's graph (SNP-aware) index against the JAX package's.

One two-chromosome 42 kb genome with SNVs every 400 bp, a site with two
alt alleles (overlay nibble 15), a known deletion, a known insertion and a
phased group of three dense variants (a haplotype patch). Checked, all
exact: the .snp / .haplotype readers; build_patches, build_graph_index
and build_graph_table_index array by array; save in one package and load
in the other, both ways; FMIndex.from_object on a JAX graph index; the
graph keys of the device bundle; and ops/rank.nib4_window against the JAX
one at the verify, DP and rescue window lengths with starts below 0, at
0, across primary_n and past it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.index import graph_index as jgraph
from hisat2_tpu.index.fm_index import FMIndex as JFMIndex
from hisat2_tpu.io import annotations as jann
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.ops import rank as jrank
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.index import graph_index as tgraph
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import annotations as tann
from hisat2_tpu_torch.io.reference import reference_from_seqs as t_reference
from hisat2_tpu_torch.ops import rank as trank

torch.set_num_threads(1)

FM_FIELDS = ("n", "zoff", "ftab_k", "bwt_packed", "text_packed", "occ",
             "ccount", "sa", "ftab", "st_starts", "st_pos", "st_k",
             "st_stride")
GRAPH_FIELDS = ("primary_n", "patch_start", "patch_ref", "patch_vpos",
                "patch_shift", "patch_len", "snv_overlay")
SNP_FIELDS = ("names", "types", "jpos", "lens", "alt_codes", "chroms",
              "tpos")
HAP_AT = 34000          # joined position of the phased group (on chrH)
MULTI_AT = 2100         # a site with two alt alleles


def variant_files(codes, d):
    """Write g.snp and g.haplotype for the genome `codes` (chrG 30,000 bp
    then chrH 12,000 bp, joined) into directory d; returns their paths."""
    dec = jalphabet.decode
    lines = []
    for k, p in enumerate(range(500, 29000, 400)):
        alt = (int(codes[p]) + 1 + (k % 3)) % 4
        lines.append(f"rsV{k}\tsingle\tchrG\t{p}\t{dec([alt])}")
    for j in (1, 2):        # two alts at one site: nibble 15
        lines.append(f"rsM{j}\tsingle\tchrG\t{MULTI_AT}\t"
                     f"{dec([(int(codes[MULTI_AT]) + j) % 4])}")
    lines.append("rsD0\tdeletion\tchrG\t10123\t3")
    lines.append("rsI0\tinsertion\tchrG\t20456\tACG")
    h = HAP_AT - 30000
    a1 = (int(codes[HAP_AT]) + 1) % 4
    a2 = (int(codes[HAP_AT + 20]) + 2) % 4
    lines.append(f"rsH1\tsingle\tchrH\t{h}\t{dec([a1])}")
    lines.append(f"rsH2\tdeletion\tchrH\t{h + 8}\t2")
    lines.append(f"rsH3\tsingle\tchrH\t{h + 20}\t{dec([a2])}")
    snp = d / "g.snp"
    snp.write_text("\n".join(lines) + "\n")
    hap = d / "g.haplotype"
    hap.write_text(f"ht1\tchrH\t{h}\t{h + 20}\trsH1,rsH2,rsH3\n")
    return str(snp), str(hap)


def graph_world(d, seed=77):
    """(codes, JAX ref, JAX snps, haps, JAX graph index with its table)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 42000).astype(np.uint8)
    seqs = {"chrG": jalphabet.decode(codes[:30000]),
            "chrH": jalphabet.decode(codes[30000:])}
    ref = reference_from_seqs(seqs)
    snp_path, hap_path = variant_files(codes, d)
    snps = jann.read_snps(snp_path, ref)
    haps = jann.read_haplotypes(hap_path, ref, snps)
    jfm = jgraph.build_graph_index(ref, snps, ftab_k=6, haplotypes=haps)
    return dict(codes=codes, seqs=seqs, ref=ref, snps=snps, haps=haps,
                jfm=jfm, snp_path=snp_path, hap_path=hap_path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = graph_world(tmp_path_factory.mktemp("graph"))
    w["tref"] = t_reference(w["seqs"])
    w["tsnps"] = tann.read_snps(w["snp_path"], w["tref"])
    w["thaps"] = tann.read_haplotypes(w["hap_path"], w["tref"], w["tsnps"])
    return w


def same_snps(t, j):
    assert len(t) == len(j)
    for f in SNP_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(b, list):
            assert a == b, f
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(t.ins_seqs) == len(j.ins_seqs)
    for a, b in zip(t.ins_seqs, j.ins_seqs):
        np.testing.assert_array_equal(a, b)


def same_index(t, j, fields=FM_FIELDS + GRAPH_FIELDS):
    for f in fields:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    np.testing.assert_array_equal(t.ref.joined, j.ref.joined)
    assert list(t.ref.names) == list(j.ref.names)
    same_snps(t.snps, j.snps)


def test_annotation_readers_match(world):
    same_snps(world["tsnps"], world["snps"])
    assert world["thaps"] == world["haps"]
    s = world["tsnps"]
    assert len(world["thaps"]) == 1 and len(world["thaps"][0]) == 3
    assert {0, 1, 2} == set(s.types.tolist()) and s.n_snv == len(s) - 3
    assert s.to_snp_lines(world["tref"]) == \
        world["snps"].to_snp_lines(world["ref"])


@pytest.mark.parametrize("flank,with_haps", [(40, True), (40, False),
                                             (25, True)])
def test_build_patches(world, flank, with_haps):
    hj = world["haps"] if with_haps else None
    ht = world["thaps"] if with_haps else None
    want = jgraph.build_patches(world["ref"].joined, world["snps"], hj, flank)
    got = tgraph.build_patches(world["tref"].joined, world["tsnps"], ht,
                               flank)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    aug, p_start, _, _, p_shift, p_len, overlay = got
    assert p_start.size == len(world["snps"]) + (1 if with_haps else 0)
    assert aug.size == 42000 + int(p_len.sum())
    assert overlay[MULTI_AT] == 15 and set(np.unique(overlay)) <= {
        0, 1, 2, 3, 4, 15}
    assert {-3, 0, 2, 3} <= set(p_shift.tolist())
    if with_haps:
        assert p_shift[-1] == 2          # the group's one deletion


def test_build_graph_index(world):
    t = tgraph.build_graph_index(world["tref"], world["tsnps"], ftab_k=6,
                                 haplotypes=world["thaps"])
    j = world["jfm"]
    same_index(t, j)
    assert t.is_graph and t.st_k > 0 and t.n > t.primary_n == 42000
    assert t.ref.joined.size == t.primary_n
    assert tgraph._pack4(t.snv_overlay).tolist() == \
        jgraph._pack4(j.snv_overlay).tolist()


@pytest.mark.parametrize("kt,stride", [(None, 1), (7, 2)])
def test_build_graph_table_index(world, kt, stride):
    j = jgraph.build_graph_table_index(world["ref"], world["snps"],
                                       world["haps"], kt=kt,
                                       table_stride=stride)
    t = tgraph.build_graph_table_index(world["tref"], world["tsnps"],
                                       world["thaps"], kt=kt,
                                       table_stride=stride)
    same_index(t, j)
    assert t.table_only and j.table_only and t.sa.size == 1
    assert t.st_stride == stride and (kt is None or t.st_k == kt)
    # and the port wraps the JAX one, table_only included
    w = FMIndex.from_object(j)
    same_index(w, j)
    assert w.table_only and "st_starts" in w.device_bundle("cpu")


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_in_one_package_load_in_the_other(world, tmp_path, direction):
    prefix = str(tmp_path / "g")
    j = world["jfm"]
    if direction == "jax_to_torch":
        j.save(prefix)
        back = FMIndex.load(prefix)
        assert isinstance(back, tgraph.GraphFMIndex)
    else:
        FMIndex.from_object(j).save(prefix)
        back = JFMIndex.load(prefix)
        assert isinstance(back, jgraph.GraphFMIndex)
    # the shared format keeps neither the stride nor (for JAX) more
    same_index(back, j)
    assert back.is_graph and back.known_exons is None


def test_from_object_wraps_a_jax_graph_index(world):
    j = world["jfm"]
    t = FMIndex.from_object(j)
    assert isinstance(t, tgraph.GraphFMIndex)
    same_index(t, j)
    assert t.bwt_packed is j.bwt_packed and t.snv_overlay is j.snv_overlay
    assert isinstance(t.snps, tann.SNPDB)


def test_bundle_graph_keys(world):
    j = world["jfm"]
    t = FMIndex.from_object(j)
    b = t.device_bundle("cpu")
    jd = j.device
    for k in ("patch_start", "patch_ref", "patch_vpos", "patch_shift",
              "patch_len"):
        assert b[k].dtype == torch.int32
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jd[k]))
    assert b["snv_packed"].dtype == torch.int64
    np.testing.assert_array_equal(b["snv_packed"].numpy(),
                                  np.asarray(jd["snv_packed"]).astype(
                                      np.int64))
    assert b["primary_n"].shape == () and int(b["primary_n"]) == 42000
    assert b["n"] == j.n > 42000
    assert "snv_rows" not in b and "snv_rows_ov" not in b
    # a table index carries no FM keys; stripped of its table it does
    assert "st_starts" in b and "sides" not in b
    # bundle_bytes counts the graph keys: 8 bytes a packed word
    plain = FMIndex.bundle_bytes(
        {k: v for k, v in b.items() if not k.startswith(("snv", "patch",
                                                         "primary"))})
    npatch = j.patch_start.size
    assert FMIndex.bundle_bytes(b) == plain + 8 * (-(-42000 // 8)) + 4 \
        + 5 * 4 * npatch


@pytest.mark.parametrize("length", [100, 104, 136, 1104])
def test_nib4_window(world, length):
    j = world["jfm"]
    tidx = FMIndex.from_object(j).device_bundle("cpu")
    rng = np.random.default_rng(length)
    n0 = j.primary_n
    snv = np.flatnonzero(j.snv_overlay)
    starts = np.concatenate([
        [-length - 5, -length, -length + 1, -129, -128, -127, -17, -8, -7,
         -1, 0, 1, 7, 8, 9, 255, 256, 257],
        snv[:40] - rng.integers(0, length, 40),        # windows over SNVs
        [MULTI_AT - 3, MULTI_AT],
        n0 - length + np.arange(-9, 10),               # ends across primary_n
        [n0 - 1, n0, n0 + 1, n0 + 500, j.n - 3, j.n + 7],
        rng.integers(-50, n0 + 50, 64)]).astype(np.int32)
    want = np.asarray(jrank.nib4_window(j.device, jnp.asarray(starts),
                                        length))
    got = trank.nib4_window(tidx, torch.from_numpy(starts), length)
    assert got.dtype == torch.int32 and tuple(got.shape) == (starts.size,
                                                            length)
    np.testing.assert_array_equal(got.numpy(), want)
    # and against the dense overlay itself
    pos = starts[:, None].astype(np.int64) + np.arange(length)
    inb = (pos >= 0) & (pos < n0)
    dense = np.where(inb, j.snv_overlay[np.clip(pos, 0, n0 - 1)], 0)
    np.testing.assert_array_equal(got.numpy(), dense)
    assert (got == 15).any() and ((got > 0) & (got < 5)).any()
    # a batch shape with two leading axes, as verify_ungapped reshapes it
    got2 = trank.nib4_window(tidx, torch.from_numpy(starts[:12]).reshape(
        3, 4), length)
    np.testing.assert_array_equal(got2.numpy().reshape(12, length),
                                  want[:12])
