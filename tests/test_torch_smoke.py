"""chip_smoke.py's read simulator and SAM checks, driven through the port
on the CPU at a small size; and its refusal to run without a card."""

import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from hisat2_tpu_torch.align.pipeline import Aligner, AlignerOpts
from hisat2_tpu_torch.index.fm_index import build_fm_index
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.utils import alphabet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_path_checks_on_cpu():
    g = np.random.default_rng(3).integers(0, 4, 48000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrS": alphabet.decode(g)}))
    seqs, starts, indel = chip_smoke.simulate_reads(fm.ref.joined, 512, 5)
    assert seqs.shape == (512, chip_smoke.RDLEN) and 5 < indel.sum() < 60
    batches = chip_smoke.make_batches(seqs, 0, 256)
    assert [len(b) for b in batches] == [256, 256]
    al = Aligner(fm, device="cpu")
    text, stats = chip_smoke.run_stream(al, batches, fm.ref)
    assert stats["reads"] == 512
    rate, true_rate, indel_rate = chip_smoke.check_sam(text, 512, starts,
                                                       indel)
    assert rate >= 0.9 and true_rate >= 0.95 and indel_rate > 0.5


def test_pe_main_path_checks_on_cpu():
    """The PE phase's pair simulator, batches and SAM checks, and the
    wide-window DP case generator, on a 60 kb genome."""
    g = np.random.default_rng(4).integers(0, 4, 60000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrS": alphabet.decode(g)}))
    r1, r2, m1_true, indel = chip_smoke.simulate_pairs(fm.ref.joined, 512, 6)
    assert r1.shape == r2.shape == (512, chip_smoke.RDLEN)
    assert 5 < indel.sum() < 60
    # unswapped pairs: mate 1 is the fragment's start, read forward
    fwd = (r1 == fm.ref.joined[m1_true[:, None]
                               + np.arange(chip_smoke.RDLEN)]).mean(1)
    assert 0.3 < (fwd > 0.9).mean() < 0.7
    quals = np.random.default_rng(1).integers(
        2, 42, (512, 2, chip_smoke.RDLEN)).astype(np.int8)
    for q in (None, quals):
        batches = chip_smoke.make_pair_batches(r1, r2, 0, 256, q)
        assert [(len(b1), len(b2)) for b1, b2 in batches] == [(256, 256)] * 2
        assert batches[0][0].names == batches[0][1].names
        text, stats = chip_smoke.run_pe_stream(Aligner(fm, device="cpu"),
                                               batches, fm.ref)
        assert stats["pairs"] == 512
        share, m1_rate, mate_rate = chip_smoke.check_pe_sam(text, 512,
                                                            m1_true, indel)
        assert share >= 0.9 and m1_rate >= 0.95 and mate_rate >= 0.95
    rd, quals, lens, ref = chip_smoke.make_dp_case(0, 19, 104, 2047)
    assert rd.shape == (19, 104) and ref.shape == (19, 2047)


def test_fm_phase_helpers_on_cpu():
    """The FM phase's index variants (no table; sampled SA; a paired-k-mer
    table; a stride-2 table) over the arrays of one built index, and its
    per-read and per-pair runners, on a 48 kb genome."""
    g = np.random.default_rng(3).integers(0, 4, 48000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrS": alphabet.decode(g)}))
    var = chip_smoke.fm_variants(fm)
    a, b = var["A"], var["B"]
    assert a.st_k == 0 and a.st_starts is None and a.sa is fm.sa
    assert b.offrate == chip_smoke.FM_OFFRATE and b.sa.size == 0
    assert b.samp_vals.size < fm.sa.size // 8 and fm.st_k > 0
    for name, mode in (("pair", True), ("stride2", False)):
        bundle = var[name].device_bundle("cpu")
        load = bundle["st_pos_rows"].numel() / 4 ** bundle["st_k"]
        assert (load > 3.0) == mode, (name, load)
    assert var["stride2"].device_bundle("cpu")["st_stride"] == 2
    seqs, starts, indel = chip_smoke.simulate_reads(fm.ref.joined, 256, 5)
    batches = chip_smoke.make_batches(seqs, 0, 256)
    texts = {}
    for name in ("A", "B", "pair", "stride2"):
        texts[name], stats = chip_smoke.run_stream(
            Aligner(var[name], device="cpu"), batches, fm.ref)
        rate, true_rate, _ = chip_smoke.check_sam(texts[name], 256, starts,
                                                  indel)
        assert rate >= 0.9 and true_rate >= 0.95
    assert texts["B"] == texts["A"]
    off = AlignerOpts(seed_mode=False)
    text, stats = chip_smoke.run_per_read(
        Aligner(a, opts=off, device="cpu"), batches, fm.ref)
    assert stats["reads"] == 256
    chip_smoke.check_sam(text, 256, starts, indel)
    r1, r2, m1_true, pe_indel = chip_smoke.simulate_pairs(fm.ref.joined,
                                                          128, 6)
    pb = chip_smoke.make_pair_batches(r1, r2, 0, 128)
    text, stats = chip_smoke.run_per_pair(
        Aligner(a, opts=off, device="cpu"), pb, fm.ref)
    assert stats["pairs"] == 128
    chip_smoke.check_pe_sam(text, 128, m1_true, pe_indel)


def test_ptxas_report_by_kernel():
    """The build phase's per-variant reading of nvcc's -Xptxas -v report:
    one entry per compiled kernel, the 'Function properties' lines that
    also name it folded into it."""
    name = ("_ZN44_GLOBAL__N__ae5ee274_11_dp_score_cu_d4ba99da20dp_score_wide"
            "_kernelILi5EEEvPKiS2_S2_S2_S2_Piiiiiiiii")
    report = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 96 bytes smem",
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__ae5ee274"
        "_11_dp_score_cu_d4ba99da15dp_score_kernelILi1EEEvPKi' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 0 barriers"])
    assert chip_smoke.ptxas_by_kernel(report) == [
        ("dp_score_wide_kernel<CPL=5>", "0 bytes stack frame, 0 bytes spill "
         "stores, 0 bytes spill loads | Used 72 registers, used 1 barriers, "
         "96 bytes smem"),
        ("dp_score_kernel<CPL=1>", "Used 40 registers, used 0 barriers")]


def test_sass_report_by_kernel():
    """The build phase's reading of `cuobjdump -sass`: per variant, the
    fused add-max and three-way-max instructions and the length of the
    row loop (the widest backward branch)."""
    fn = "_ZN44_GLOBAL__N__ae5ee274_11_dp_score_cu_24dcdda7{}EEvPKiS2_Pii"
    sass = "\n".join([
        "\t\tFunction : " + fn.format("20dp_score_wide_kernelILi9E"),
        "\t.headerflags\t@\"EF_CUDA_SM90\"",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "          /* 0x00000a00ff017b82 */",
        "        /*0010*/                   VIADDMNMX R9, R24, UR8, R9, !PT ;",
        "        /*0020*/              @!P1 VIMNMX3 R24, R13, R12, R14, !PT ;",
        "        /*0030*/                   SHFL.UP PT, R46, R47, 0x1, RZ ;",
        "        /*0040*/               @P0 BRA 0x10 ;",
        "        /*0050*/                   EXIT ;",
        "        /*0060*/                   BRA 0x60;",
        "\t\tFunction : " + fn.format("15dp_score_kernelILi5E"),
        "        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, 0x5 ;",
        "        /*0010*/                   EXIT ;"])
    assert chip_smoke.sass_by_kernel(sass) == {
        "dp_score_wide_kernel<CPL=9>": (1, 1, 4),
        "dp_score_kernel<CPL=5>": (0, 0, 0)}


def test_dp_case_generator():
    rd, quals, lens, ref = chip_smoke.make_dp_case(0, 24, 60, 92)
    assert rd.shape == (24, 60) and ref.shape == (24, 92)
    assert lens[4] == 0 and lens[5] == 1 and (ref[2] == 4).all()
    # the seven stress rows at the end (13 rows or more)
    assert (rd[17] == 4).all() and rd[18, 0] == 4 == rd[18, lens[18] - 1]
    assert (quals[19] == 2).all() and (quals[20] == 40).all()
    assert (lens[21:] == 60).all()
    assert (rd[22, :59] == ref[22, 33:]).all() and rd[22, 59] == 4
    assert (rd[23] == ref[23, 32:]).all()
    # a window narrower than 30 bases still gets reads that fit it
    rd, quals, lens, ref = chip_smoke.make_dp_case(1, 16, 24, 30)
    assert rd.shape == (16, 24) and lens.max() <= 24


def test_refuses_without_card(tmp_path):
    """Without CUDA the script fails before printing any result, and a
    copy standing alone (no package beside it) fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src, \
                    open(script, "w") as dst:
                dst.write(src.read())
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_graph_phase_helpers_on_cpu():
    """The graph phase's variant simulation, haplotype genome, read truth
    and SAM checks, on a 60 kb genome at one variant per 250 bp."""
    from hisat2_tpu_torch.index.graph_index import build_graph_index
    g = np.random.default_rng(8).integers(0, 4, 60000).astype(np.uint8)
    ref = reference_from_seqs({"chrS": alphabet.decode(g)})
    snps, haps = chip_smoke.simulate_variants(ref.joined, 31, 250, 12)
    assert len(haps) == 12 and len(snps) == 60000 // 250 - 1 + 12
    assert (np.diff(snps.jpos) > 3).all()
    assert set(np.unique(snps.types)) == {0, 1, 2}
    sv = snps.types == 0
    assert (snps.alt_codes[sv] != ref.joined[snps.jpos[sv]]).all()
    for a, b in haps:
        assert sv[a] and sv[b] and 6 <= snps.jpos[b] - snps.jpos[a] <= 30
    hap, refpos, alt, after_del, inserted = chip_smoke.apply_haplotype(
        ref.joined, snps, haps, 32)
    assert hap.size == refpos.size == alt.size == inserted.size
    assert (np.diff(refpos) >= 0).all()
    plain = ~alt & ~inserted
    assert (hap[plain] == ref.joined[refpos[plain]]).all()
    assert (hap[alt] != ref.joined[refpos[alt]]).all()
    assert 0 < alt.sum() < sv.sum() and after_del.any() and inserted.any()
    d = np.flatnonzero(after_del)
    assert (refpos[d] - refpos[d - 1] > 1).all()
    seqs, info = chip_smoke.simulate_graph_reads(
        hap, refpos, alt, after_del, inserted, 384, seed=33)
    assert (info["n_alt"] > 0).any() and not info["err"].all()
    assert info["kdel"].any() or info["kins"].any()
    gfm = build_graph_index(ref, snps, haplotypes=haps)
    batches = chip_smoke.make_batches(seqs, 0, 384)
    text, stats = chip_smoke.run_stream(Aligner(gfm, device="cpu"), batches,
                                        ref)
    res = chip_smoke.check_graph_sam(text, 384, info, "graph stream")
    assert res["alt_reads"] > 20 and res["alt_free"] >= 0.95
    assert res["zs"] == 0
    ztext, _ = chip_smoke.run_stream(
        Aligner(gfm, opts=AlignerOpts(zs_tags=True), device="cpu"), batches,
        ref)
    assert chip_smoke.check_graph_sam(ztext, 384, info, "zs")["zs"] > 20
    # on the linear index the same alt-allele reads pay for the allele
    ltext, _ = chip_smoke.run_stream(
        Aligner(build_fm_index(ref), device="cpu"), batches, ref)
    clean = ~info["err"] & (info["n_alt"] > 0)
    assert not any("AS:i:0" in ln for ln in ltext.splitlines()
                   if clean[int(ln.split("\t")[0][1:])])
    ov = chip_smoke.make_dp_ov(0, *[chip_smoke.make_dp_case(0, 16, 24, 40)[k]
                                    for k in (0, 3)])
    assert ov.shape == (16, 40) and set(np.unique(ov)) == {0, 1, 2, 3, 4, 15}
    assert chip_smoke.variant_of("_Z15dp_score_kernelILi5ELb1EEvPKi") == \
        "dp_score_kernel<CPL=5,OV>"
    assert chip_smoke.variant_of("_Z15dp_score_kernelILi5ELb0EEvPKi") == \
        "dp_score_kernel<CPL=5>"
