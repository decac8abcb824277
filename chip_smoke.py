#!/usr/bin/env python3
"""Smoke run of hisat2_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py              # the whole run, one card
    python3 chip_smoke.py --profile    # plus where one batch's time goes:
                                       # device kernels by name, device busy
                                       # share, host finish by function

Phases; any failure exits non-zero:
  1. card      - CUDA must be present; prints the card's name and power
                 limit as nvidia-smi reports them.
  2. build     - compiles the CUDA source of the DP kernels (the one-warp
                 kernel of the SE windows, the one-block kernel of the PE
                 rescue's wide windows and its column-tiled form past 2,048
                 columns, each with its SNV-overlay instantiations) with
                 nvcc for sm_90a and prints, for each variant
                 (<CPL=k[,OV][,TILED]>), the compiler's register/spill
                 report and,
                 read from the SASS, how many fused add-max and three-way-max
                 instructions it holds and how many instructions its row
                 loop spans (--sass DIR also writes the SASS there).
  3. kernels   - each kernel against its plain PyTorch version on the
                 card, exact int32 equality: random cases with Ns, gaps,
                 short reads and the stress rows of make_dp_case, at the SE
                 main path's shape, at the rescue's (W + 1 = 1105), the
                 tiled form's W + 1 = 2049, 2605 and 8192 (one to four
                 tiles), at every window where a variant's capacity or a tile count
                 ends: one column short of it, exactly at it, and one past
                 it (edge_windows). Every case runs a second time with an
                 SNV overlay holding every kind of nibble (make_dp_ov),
                 through the overlay instantiations of every kernel (W =
                 288 and 1104 among them).
  4. SE path   - builds the index of a seeded synthetic genome of E. coli
                 K-12 MG1655's length (4,641,652 bp), then aligns 8
                 batches of 16,384 simulated 100 bp reads (1% mismatches,
                 5% with a 1-3 bp indel) to SAM through
                 align.emit.align_and_emit_stream. Asserts the alignment
                 rate, the placement of the indel-free reads, one primary
                 record per read, and that the DP kernel ran. Then the
                 same 2,048 reads go through the CPU path (plain
                 versions) and the card: the SAM bytes must be equal.
  5. PE path   - aligns 4 batches of 16,384 simulated pairs (131,072
                 reads of 100 bp, quality 40, fragments of 200-500 bp, half
                 with mates swapped, 1% mismatches, 2% of mates with a 1-3
                 bp indel) to SAM through align.emit.align_and_emit_pe_stream
                 on the same index. Asserts one primary record per mate,
                 the proper-pair share, the placement of mate 1 of
                 indel-free pairs, that both DP kernels ran (the wide one
                 at least once a batch, in the mate rescue) and that a
                 rescue lane passed its minimum score. Then 2,048
                 constant-quality pairs (the packed step) and 512 pairs with
                 per-base qualities (the fused step) go through the CPU path
                 and the card: the SAM bytes must be equal; so do 512
                 pairs at -X 2500 (the rescue window stays min(-X, 1000) +
                 L) and 256 SE reads of 2,100 bp, whose DP window (W =
                 2136) takes the column-tiled kernel.
  6. FM path   - the same genome without its k-mer table, so that seeding
                 is FM backward search: index A (full suffix array: ftab
                 jump + 12 LF rounds of 22 bp seeds, maximal segments for
                 the reads they miss, SA ranges expanded to positions) and
                 index B (A with the SA sampled at offrate 4: up to 15 LF
                 steps to a marked row). 4 batches of 16,384 reads on A, 2
                 on B, 2 batches of 16,384 pairs on A, with phase 4's and
                 5's checks; B's SAM on 2,048 reads must equal A's byte for
                 byte. seed_mode=False (the per-read path: align_batch +
                 results_to_sam at 16,384 reads, the emit path at 2,048
                 reads, align_pairs + pairs_to_sam at 512 pairs) on A and
                 on the table index. The two seed-table modes of Gbp-scale
                 shards: a kt = 10 table (bucket load 4.4: paired k-mers)
                 and a stride-2 table, 2,048 reads each. For every
                 configuration the card's SAM must equal the CPU path's on
                 2,048 reads (512 pairs) and the DP kernel must have been
                 launched. One batch on A and on B under torch.profiler
                 gives launches per batch and the device's busy share.
  7. graph     - SNP-aware alignment: the same genome with one known
                 variant per 250 bp (about 18,500: 90% SNVs, 5% deletions
                 and 5% insertions of 1-3 bp, 300 phased SNV pairs with a
                 haplotype patch each) as a graph index with its k-mer
                 table, and the same index without the table (FM seeding
                 through the patch fragments). Reads are cut from one
                 haplotype (every variant applied with probability 0.5)
                 with phase 4's errors on top: 4 batches of 16,384 reads
                 and 2 of 16,384 pairs through the streams, 2 SE batches on
                 the FM-seeded index. Asserts phase 4's guards; that of the
                 error-free reads carrying an alt SNV at least 0.95 come
                 out AS:i:0 XM:i:0 NM:i:0 while none does on the linear
                 index; that a read over a known deletion and one over a
                 known insertion come out with the zero-cost D / I; that
                 zs_tags=True writes Zs:Z; that the card's SAM equals the
                 CPU path's for the SE stream, both PE steps, the FM-seeded
                 index, seed_mode=False (SE and PE), zs_tags=True and 2,048
                 reads of 250 bp (DP window W = 288: the one-block kernel's
                 overlay instantiation); and that every graph run launched
                 the overlay kernel.
  8. RNA       - spliced alignment on the same genome, into which a gene
                 model was written before the index was built: about 2,000
                 transcripts of 2-6 exons, introns of 60-50,000 bp with
                 their canonical motif (GT..AG or CT..AC), 100 bp reads cut
                 from the spliced transcripts with 1% mismatches, about half
                 across a junction. The card's SAM must equal the CPU
                 path's on 2,048 reads for the stream, seed_mode=False and
                 tmo=True (both with known sites; tmo reports spliced
                 records only), dta=True and FM seeding (index A). Then 2
                 batches of 16,384 reads through the stream with every
                 intron known and 2 without known sites; without them
                 junction recall must reach 0.90 over the junctions whose
                 shorter anchor is 7 bp or more, and precision 0.99 (CIGAR
                 N ops of the primary records against the planted
                 junctions). One batch alone gives launches and the
                 device's busy share.
  9. RNA PE    - spliced paired-end alignment on phase 8's genome and
                 gene model: FR pairs of 100 bp mates from fragments of
                 200-500 bp measured along the spliced transcripts (mate 2
                 the reverse complement of the far end, half the pairs
                 swapped, 1% mismatches). The card's SAM and stats must
                 equal the CPU path's on 1,024 pairs for the stream,
                 seed_mode=False and tmo=True (both with known sites; tmo
                 reports spliced records only), no_temp_splicesite=True and
                 FM seeding (index A). Then 2 batches of 16,384 pairs
                 through align_and_emit_pe_stream with every intron known
                 and 2 without (each batch one spliced step over 32,768
                 rows, mates concatenated). Guards: proper pairs >= 0.90;
                 without known sites junction recall >= 0.90 (shorter
                 anchor 7 bp or more) and precision >= 0.99 over both
                 mates' primary records; with them |TLEN| equal to the
                 fragment's transcript length for >= 0.90 of the proper
                 pairs whose mates both sit at their true position
                 unclipped and whose inter-mate gap holds no other
                 transcript's intron (TLEN leaves out every known intron
                 there). Both DP kernels must run: the one-warp one in
                 the step, the one-block one in the ladder's mate rescue.
                 One batch alone gives launches, busy share and peak
                 device memory.
 10. sharded   - genome-sharded alignment (ShardedAligner). First a small
                 sharded genome (small_sharded_case: three chromosomes of
                 40 kb, one shard each, 600 bp segments of chr1 copied into
                 chr3, introns with known sites, a variant every 250 bp):
                 the card's SAM and stats must equal the CPU path's for
                 2,048 SE reads, 512 pairs (16 with a random mate 2), a
                 graph sharded index, RNA SE and PE with known sites and
                 tmo=True, every run launching the DP kernel and the PE
                 ladder's host-mode mate rescue the one-block kernel; then
                 all of it again with HISAT2_TPU_HBM_GB below two shards
                 (evictions counted). Then a genome of real size: 8
                 chromosomes of 125 Mbp (1.0 Gbp, chicken GRCg7b's size)
                 with 50 segments of 2 kb copied across shards,
                 build_sharded(max_bases=400,000,000) into 3 table-only
                 shards (kt = 13), each shard's estimated bundle bytes
                 held to the real bundle's; 8 batches of 16,384 SE reads
                 and 4 of 16,384 pairs (phases 4's and 5's generators and
                 guards) under the default budget (every shard resident,
                 uploaded once); reads/s, pairs/s, seconds per shard
                 upload, one batch alone under the profiler; then 2 SE
                 batches and 1 PE batch with the budget below two shards:
                 every pass uploads each shard again, evictions counted,
                 the SAM bytes equal the resident run's.
 11. repeats   - repeat families planted in a copy of phase 4's genome (20
                 of 300 bp x 50 copies, 20 of 1-6 kb x 8, a third of the
                 copies reverse-complemented, a quarter with one SNV):
                 build_repeats(repeat_length=100, repeat_count=5), the
                 repeat FM index, the minimizer table, classify_repetitive
                 on 16,384 reads (phase 4's errors) and
                 RepeatAligner.align_repeats on the card for the
                 repetitive ones (reads/s, the DP kernel launched);
                 align_repeats card == CPU on 2,048 of them; 2,048
                 error-free reads from copies without an SNV must hold
                 their true position among the placements (>= 0.95).
 12. report    - the wide kernel's time and bound at W = 604, 1104 and
                 2047 (-X 500, the default -X 1000, one pass's maximum);
                 each DP kernel's time on its main path's own inputs (the
                 narrow one also on the per-read path's, C = 16,384, on the
                 RNA path's, and with the overlay on the graph path's; the
                 tiled one on the 2,100 bp reads', the one-block overlay
                 one on the 250 bp graph reads'; both on the RNA PE path's
                 own inputs; the narrow one on the per-shard SE step's and
                 RepeatAligner.align_batch's, the wide one on the sharded
                 PE ladder's host-mode rescue), its plain version's time
                 and its bound, as one JSON line; end-to-end reads/s (SE,
                 RNA) and pairs/s (PE, RNA PE) and peak device memory beside the
                 card name and power limit; last line {"ok": true, ...}.

The bound of a kernel is the larger of its bytes over the card's memory
rate and its int32 operations over the card's int32 rate, both from the
H100 SXM data sheet: 3.35 TB/s, and 16.75 T int32 op/s (the 67 TFLOP/s
float32 rate counts 2 flops per FMA on 128 lanes per SM; an SM has 64
int32 lanes, so int32 runs at a quarter of that figure).

DP_OPS_PER_CELL is the least number of integer instructions one DP cell
needs on this card, a fused add-max or three-way max counted as one:
  substitution score   2   compare window base with read base, select
                           match or mismatch score (an N is a per-row or
                           per-column constant, not a per-cell test)
  F                    1   max(H + (ext - open), F), rows kept with
                           row * ext added so F itself needs no decrement
  G                    1   max(Hdiag + s, F)
  running max          1   max(G + ext * j, run)
  E and H, clip floor  3   max(G, M[j-1] + e_j, excl + e_j, clip): four
                           values and two sums cannot fold into two
                           three-input instructions
  row maximum          0.5 one three-way max takes two cells
It counts the recurrence, not what a kernel happens to execute; the per-row
scan across lanes and the hand-off between warps come on top.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
DP_OPS_PER_CELL = 8.5         # integer instructions per DP cell (see above)

GENOME_LEN = 4_641_652        # E. coli K-12 MG1655
BATCH = 16384
NBATCH = 8
RDLEN = 100
PAD_TO = 104                  # ReadBatch pads 100 bp reads to a multiple of 8
PE_BATCH = 16384              # pairs per batch
PE_NBATCH = 4
FM_NBATCH = 4                 # SE batches on index A (B and PE take 2)
FM_OFFRATE = 4                # index B keeps every 16th SA value
FM_PAIR_KT = 10               # 4.6 Mbp / 4^10 = 4.4 a bucket: pair mode
GRAPH_VARIANT_EVERY = 250     # one known variant per 250 bp
GRAPH_HAP_PAIRS = 300         # phased SNV pairs with a haplotype patch
GRAPH_NBATCH = 4              # SE batches on the graph index
GRAPH_PE_NBATCH = 2
GRAPH_FM_NBATCH = 2           # SE batches on the FM-seeded graph index
LONG_N = 256                  # long reads, and their length
LONG_RDLEN = 2100
LONG_PAD = 2104
RNA_TRANSCRIPTS = 2000        # the simulated gene model
RNA_NBATCH = 2                # RNA batches with known sites, and without
RNA_CHECK = 2048              # reads of each RNA card == CPU comparison
RNA_PE_NBATCH = 2             # RNA PE batches with known sites, and without
RNA_PE_CHECK = 1024           # pairs of each RNA PE card == CPU comparison
SMALL_CHROM = 40_000          # phase 10's small sharded genome: 3 of these,
SMALL_SHARD = 45_000          # one shard each (build_sharded max_bases)
SMALL_SE = 2048               # its SE and graph reads,
SMALL_PE = 512                # its pairs,
SMALL_RNA = 256               # its RNA reads (RNA pairs: half as many)
SHARD_CHROMS = 8              # phase 10's genome of real size: 8 x 125 Mbp
SHARD_CHROM_LEN = 125_000_000  # = 1.0 Gbp, chicken GRCg7b's size
SHARD_BASES = 400_000_000     # --shard-bases: shards of 375, 375, 250 Mbp
SHARD_COPIES = 50             # 2 kb segments copied across shards
REP_SHORT = 20                # phase 11: families of 300 bp x 50 copies
REP_LONG = 20                 # and of 1-6 kb x 8 copies


def check(ok: bool, what: str) -> None:
    """A failed check of the run: raise, so the script exits non-zero."""
    if not ok:
        raise RuntimeError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def make_dp_case(seed, C, L, W):
    """Random DP inputs: reads cut from their windows with mismatches and
    Ns, a 1-3 bp deletion on every third row, random lengths, and a few
    degenerate rows (unrelated read, all-N window, lengths 0 and 1). With
    13 rows or more, the last seven stress the kernels' edges: an all-N
    read; a read whose first and last base are N; qualities 2 (the
    smallest clip and mismatch penalties) and 40; a full-length read; a
    read that hangs one N base over the window's end (a column past the
    window that leaked into the maximum would score it higher); and an
    exact match that ends in the window's last column."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, (C, W)).astype(np.int32)
    rd = np.empty((C, L), np.int32)
    lens = rng.integers(min(30, max(11, L // 2)), L + 1, C).astype(np.int32)
    starts = rng.integers(0, W - L + 1, C)
    for i in range(C):
        s = starts[i]
        rd[i] = ref[i, s:s + L]
        for p in rng.integers(0, lens[i], rng.integers(0, 6)):
            rd[i, p] = rng.integers(0, 5)
        if i % 3 == 0:
            d = int(rng.integers(1, 4))
            p = int(rng.integers(5, lens[i] - 5))
            tail = ref[i, s + p + d:min(s + L + d, W)]
            rd[i, p:p + tail.size] = tail
    quals = rng.integers(20, 41, (C, L)).astype(np.int32)
    rd[1] = rng.integers(0, 4, L)
    ref[2] = 4
    lens[4] = 0
    lens[5] = 1
    if C >= 13:
        r = C - 7
        rd[r] = 4
        rd[r + 1, 0] = rd[r + 1, lens[r + 1] - 1] = 4
        quals[r + 2] = 2
        quals[r + 3] = 40
        lens[r + 4] = L
        rd[r + 5, :L - 1] = ref[r + 5, W - L + 1:]
        rd[r + 5, L - 1] = 4
        rd[r + 6] = ref[r + 6, W - L:]
        quals[r + 5:] = 40
        lens[r + 5:] = L
    return rd, quals, lens, ref


def make_dp_ov(seed, rd, ref, density=0.25, stress=True):
    """SNV-overlay nibbles (C, W) for a make_dp_case: at `density` of the
    window bases a nibble of every kind (1..4, naming the read base or
    not, and 15), on N windows and under N read bases too. With `stress`,
    on every third row the nibbles along one diagonal name the read's own
    bases (15 under a read N), so each of its mismatches there is free,
    and row 3 is all 15. The rest is 0, as most of a genome is."""
    rng = np.random.default_rng(seed)
    C, W = ref.shape
    L = rd.shape[1]
    ov = np.where(rng.random((C, W)) < density,
                  rng.choice(np.array([1, 2, 3, 4, 15]), (C, W)), 0)
    for i in range(0, C if stress else 0, 3):
        s = int(rng.integers(0, W - L + 1))
        ov[i, s:s + L] = np.where(rd[i] < 4, rd[i] + 1, 15)
    if stress and C > 3:
        ov[3] = 15
    return ov.astype(np.int32)


def edge_windows(kernel: str):
    """Windows W at which a variant of `kernel` ("dp_score",
    "dp_score_wide" or "dp_score_tiled", with or without the overlay)
    ends: W + 1 one short of, at and one past each
    variant's capacity and each count of tiles (1 to 4) of every tiled
    width, up to W + 1 = 8,193; and the rescue's window W + 1 = 1105, the
    tiled form's W + 1 = 2605 (two tiles of 12 columns a lane) and the
    graph SE window of 250 bp reads, 289."""
    from hisat2_tpu_torch.ops import dp_cuda
    caps = {32 * k for k in range(1, dp_cuda.NARROW_MAX_COLS // 32 + 1)}
    caps |= {32 * w * k for w, k in dp_cuda.WIDE_VARIANTS}
    caps |= {n * 128 * k for k in dp_cuda.TILE_CPLS for n in range(1, 5)}
    cols = {c + d for c in caps for d in (-1, 0, 1)} | {289, 1105, 2605}
    return [c - 1 for c in sorted(cols) if c <= 8193
            and dp_cuda.dispatch_plan(c - 1).kernel == kernel]


def edge_case_shape(W: int):
    """(C, L) of the random case that checks a window of W: reads no longer
    than the window, enough rows for make_dp_case's stress rows."""
    return 16, (104 if W >= 104 else 40 if W >= 40 else 24)


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call from CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_of(W: int) -> str:
    """Which DP kernel dp_cuda.dp_score launches for a window of W."""
    from hisat2_tpu_torch.ops import dp_cuda
    return dp_cuda.dispatch_plan(W).kernel


def variant_key(W: int, ov: bool) -> str:
    """The report's name of the kernel a window of W launches: the launch
    counter's key, with "_ov" for an overlay instantiation of the
    one-block kernel (the one-warp kernel's is "dp_score_ov")."""
    k = kernel_of(W)
    return k if not ov else "dp_score_ov" if k == "dp_score" else k + "_ov"


def variant_of(mangled: str):
    """'dp_score_kernel<CPL=5>' or 'dp_score_wide_kernel<CPL=9>' from a
    mangled kernel name ('...<CPL=5,OV>' for an overlay instantiation,
    '...<CPL=8,TILED>' for the column-tiled form), or None."""
    m = re.search(r"(dp_score_(?:wide_)?kernel)ILi(\d+)E(?:Lb([01])E)?"
                  r"(?:Lb([01])E)?", mangled)
    if not m:
        return None
    tags = "".join(t for t, g in ((",OV", 3), (",TILED", 4))
                   if m.group(g) == "1")
    return f"{m.group(1)}<CPL={m.group(2)}{tags}>"


def ptxas_by_kernel(report: str):
    """(kernel variant, 'registers ... | spills ...') pairs from nvcc's
    -Xptxas -v report."""
    out, name, regs = [], None, []
    for ln in report.splitlines():
        if "Compiling entry function" in ln and variant_of(ln):
            if name:
                out.append((name, " | ".join(regs)))
            name, regs = variant_of(ln), []
        elif name and ("registers" in ln or "spill" in ln):
            regs.append(ln.split(":", 1)[-1].strip())
    if name:
        out.append((name, " | ".join(regs)))
    return out


def sass_by_kernel(sass: str):
    """{kernel variant: (fused add-max count, three-way max count,
    instructions the row loop spans)} from `cuobjdump -sass` text. The
    row loop is the widest predicated backward branch of the function
    (the unconditional ones return from out-of-line code); the span
    counts both sides of every fork inside it (the window-base-N fix-up
    and the masked row maximum, which most threads skip), so it is an
    upper limit of what a row executes."""
    out, name, ins = {}, None, []

    def close():
        if not name:
            return
        loops = [(a - t, t, a) for a, _, t, pred in ins
                 if pred and t is not None and t <= a]
        span = 0
        if loops:
            _, t, a = max(loops)
            span = sum(1 for b, _, _, _ in ins if t <= b <= a)
        out[name] = (sum(op == "VIADDMNMX" for _, op, _, _ in ins),
                     sum(op == "VIMNMX3" for _, op, _, _ in ins), span)

    for ln in sass.splitlines():
        if "Function :" in ln:
            close()
            name, ins = variant_of(ln), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\d+\s+)?"
                     r"([A-Z][\w.]*)(.*?);", ln)
        if m and name:
            op = m.group(3).split(".")[0]
            tgt = re.search(r"0x([0-9a-f]+)", m.group(4)) \
                if m.group(3) == "BRA" else None
            ins.append((int(m.group(1), 16), op,
                        int(tgt.group(1), 16) if tgt else None,
                        bool(m.group(2))))
    close()
    return out


def read_sass(lib_path: str):
    """`cuobjdump -sass` of the built library, or None where the toolkit
    has no cuobjdump."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    if exe is None:
        return None
    return subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def simulate_reads(joined: np.ndarray, n: int, seed: int,
                   rdlen: int = RDLEN):
    """n reads of rdlen: ~1% mismatches, ~5% with one 1-3 bp indel, half
    reverse-complemented. Returns (codes (n, rdlen) uint8, true 0-based
    start, indel flag)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, joined.size - rdlen - 8, n)
    seqs = joined[starts[:, None] + np.arange(rdlen)].copy()
    indel = rng.random(n) < 0.05
    for i in np.flatnonzero(indel):
        s, d = int(starts[i]), int(rng.integers(1, 4))
        p = int(rng.integers(rdlen // 5, rdlen - rdlen // 5))
        if rng.random() < 0.5:       # deletion from the read
            seqs[i] = np.concatenate([joined[s:s + p],
                                      joined[s + p + d:s + rdlen + d]])
        else:                        # insertion into the read
            seqs[i] = np.concatenate([joined[s:s + p],
                                      rng.integers(0, 4, d).astype(np.uint8),
                                      joined[s + p:s + rdlen - d]])
    mm = rng.random(seqs.shape) < 0.01
    seqs[mm] = (seqs[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
    rc = rng.random(n) < 0.5
    seqs[rc] = 3 - seqs[rc, ::-1]
    return seqs.astype(np.uint8), starts, indel


def simulate_gene_model(codes: np.ndarray, seed: int,
                        n_tx: int = RNA_TRANSCRIPTS):
    """Plant a gene model into the genome `codes` (uint8, changed in
    place): n_tx transcripts of 2-6 exons of 60-300 bp with introns of 60
    to 50,000 bp (log-uniform, so most are short), half on each strand,
    the canonical motif written at both ends of every intron (GT..AG on
    the + strand, CT..AC on the -). Transcripts may overlap; one whose
    motifs a later transcript overwrote is dropped. Returns the kept
    transcripts as (strand, [(start, end), ...]) exon lists (0-based,
    end exclusive)."""
    rng = np.random.default_rng(seed)
    txs = []
    for _ in range(n_tx):
        ne = int(rng.integers(2, 7))
        ex_len = rng.integers(60, 301, ne)
        in_len = np.exp(rng.uniform(np.log(60), np.log(50_000),
                                    ne - 1)).astype(np.int64)
        span = int(ex_len.sum() + in_len.sum())
        s = int(rng.integers(1000, codes.size - span - 1000))
        exons = []
        for k in range(ne):
            exons.append((s, s + int(ex_len[k])))
            s += int(ex_len[k]) + (int(in_len[k]) if k < ne - 1 else 0)
        strand = "+" if rng.random() < 0.5 else "-"
        motif = ([2, 3], [0, 2]) if strand == "+" else ([1, 3], [0, 1])
        for (_, e), (a, _) in zip(exons, exons[1:]):
            codes[e:e + 2] = motif[0]
            codes[a - 2:a] = motif[1]
        txs.append((strand, exons, motif))
    return [(st, ex) for st, ex, (dn, ac) in txs
            if all((codes[e:e + 2] == dn).all() and (codes[a - 2:a] == ac).all()
                   for (_, e), (a, _) in zip(ex, ex[1:]))]


def read_junctions(gp: np.ndarray) -> dict:
    """The junctions of a read whose bases sit at genome positions gp:
    {(last base of the left exon, first base of the right one): the
    shorter of the read's two anchors at it}; an anchor ends at the read's
    end or its next junction."""
    jumps = np.flatnonzero(np.diff(gp) > 1)
    ends = np.concatenate([[-1], jumps, [gp.size - 1]])
    return {(int(gp[k]), int(gp[k + 1])):
            int(min(k - ends[t], ends[t + 2] - k))
            for t, k in enumerate(jumps)}


def simulate_rna_reads(codes: np.ndarray, txs, n: int, seed: int):
    """n RDLEN reads cut from the transcripts' spliced sequences (a
    transcript and an offset in it uniformly at random), ~1% mismatches,
    half reverse-complemented. Returns (codes (n, RDLEN) uint8, each
    read's junctions as {(last base of the left exon, first base of the
    right one): the shorter of the read's two anchors at it}, joined
    coordinates; an anchor ends at the read's end or its next junction)."""
    rng = np.random.default_rng(seed)
    gidx = [np.concatenate([np.arange(a, e) for a, e in ex])
            for _, ex in txs]
    pick = rng.integers(0, len(txs), n)
    seqs = np.empty((n, RDLEN), np.uint8)
    truth = []
    for i in range(n):
        g = gidx[pick[i]]
        o = int(rng.integers(0, g.size - RDLEN + 1))
        gp = g[o:o + RDLEN]
        seqs[i] = codes[gp]
        truth.append(read_junctions(gp))
    mm = rng.random(seqs.shape) < 0.01
    seqs[mm] = (seqs[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
    rc = rng.random(n) < 0.5
    seqs[rc] = 3 - seqs[rc, ::-1]
    return seqs, truth


def simulate_rna_pairs(codes: np.ndarray, txs, n: int, seed: int):
    """n FR pairs of RDLEN reads from fragments of 200-500 bp measured
    along the transcripts' spliced sequences (a fragment is cut only from
    a transcript at least as long; transcript and offset uniformly at
    random): mate 1 the fragment's first RDLEN bases, mate 2 the reverse
    complement of its last; ~1% mismatches; half the pairs with mates
    swapped. Returns (mate-1 codes, mate-2 codes, truth): truth["junc"]
    and truth["left"] hold read 2i + m's junctions (read_junctions) and
    leftmost genome position for mate m of pair i, truth["frag"] each
    pair's fragment length and truth["fjunc"] the junctions of the whole
    fragment."""
    rng = np.random.default_rng(seed)
    gidx = [np.concatenate([np.arange(a, e) for a, e in ex])
            for _, ex in txs]
    tl = np.array([g.size for g in gidx])
    by_len = np.argsort(tl, kind="stable")
    frag = rng.integers(200, 501, n)
    first = np.searchsorted(tl[by_len], frag)          # shortest long enough
    pick = by_len[first + (rng.random(n) * (len(txs) - first)).astype(
        np.int64)]
    reads = np.empty((2, n, RDLEN), np.uint8)
    junc = [None] * (2 * n)
    left = np.zeros(2 * n, np.int64)
    fjunc = [None] * n
    swap = rng.random(n) < 0.5
    for i in range(n):
        g = gidx[pick[i]]
        o = int(rng.integers(0, g.size - frag[i] + 1))
        fjunc[i] = set(read_junctions(g[o:o + frag[i]]))
        for m, gp in enumerate((g[o:o + RDLEN],
                                g[o + frag[i] - RDLEN:o + frag[i]])):
            reads[m, i] = codes[gp]
            k = 2 * i + (m ^ int(swap[i]))
            junc[k] = read_junctions(gp)
            left[k] = gp[0]
    mm = rng.random(reads.shape) < 0.01
    reads[mm] = (reads[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
    r1, r2 = reads[0], 3 - reads[1, :, ::-1]
    r1[swap], r2[swap] = r2[swap], r1[swap].copy()
    return (np.ascontiguousarray(r1), np.ascontiguousarray(r2),
            dict(junc=junc, left=left, frag=frag, fjunc=fjunc))


def check_rna_pairs(text: str, truth: dict, n: int, sites=None):
    """Proper pairs (flag 2 on mate 1's primary record) as a share of the
    n pairs; with `sites` (the known (left, right) sites), the TLEN
    figures over the proper pairs whose two mates both sit at their true
    leftmost position without a soft clip: the share whose |TLEN| is the
    fragment's transcript length, over those pairs whose inter-mate gap
    holds no known intron but the fragment's own (TLEN leaves out every
    known intron wholly inside the gap, splice_site.h
    templateLenAdjustment, so another transcript's intron there shortens
    it), and over them all; with their counts."""
    proper = np.zeros(n, bool)
    exact = np.ones(n, bool)
    tlen = np.zeros(n, np.int64)
    span = np.zeros((2 * n, 2), np.int64)
    for ln in text.splitlines():
        f = ln.split("\t", 9)
        flag = int(f[1])
        if flag & 256:
            continue
        i = int(f[0][1:])
        if flag & 4:
            exact[i] = False
            continue
        k = 2 * i + bool(flag & 128)
        exact[i] &= (int(f[3]) - 1 == truth["left"][k]) and "S" not in f[5]
        ref_len = sum(int(x) for x, op in re.findall(r"(\d+)([MDN])", f[5]))
        span[k] = (int(f[3]) - 1, int(f[3]) - 1 + ref_len)
        if not flag & 128:
            proper[i] = bool(flag & 2)
            tlen[i] = abs(int(f[8]))
    if sites is None:
        return float(proper.mean())
    kl = np.array(sorted(sites))
    sel = np.flatnonzero(proper & exact)
    clean = np.zeros(sel.size, bool)
    for t, i in enumerate(sel):
        lo = min(span[2 * i, 1], span[2 * i + 1, 1])
        hi = max(span[2 * i, 0], span[2 * i + 1, 0])
        a, b = np.searchsorted(kl[:, 0], [lo, hi]) if kl.size else (0, 0)
        inside = {(int(x), int(y)) for x, y in kl[a:b] if y <= hi}
        clean[t] = inside <= truth["fjunc"][i]
    right = tlen[sel] == truth["frag"][sel]
    return (float(proper.mean()), float(right[clean].mean()),
            int(clean.sum()), float(right.mean()), int(sel.size))


def check_junctions(text: str, truth, n: int, min_anchor: int = 7,
                    paired: bool = False):
    """Junction calls from the CIGAR N ops of the primary records against
    the planted truth, per (read, junction): (recall over the junctions
    whose shorter anchor is at least `min_anchor` bases — the least a
    novel canonical junction needs (tp.h); shorter ones are found only
    through known or published sites —, recall over all, precision, reads
    aligned, reads with a junction, records with an N). `paired`: the
    records are pairs', read 2i + m is mate m of pair i, n counts reads."""
    seen = np.zeros(n, np.int64)
    aligned = np.zeros(n, bool)
    tp = tp_a = fp = n_spliced = 0
    for ln in text.splitlines():
        f = ln.split("\t", 6)
        flag = int(f[1])
        if flag & 256:
            continue
        i = int(f[0][1:])
        if paired:
            i = 2 * i + bool(flag & 128)
        seen[i] += 1
        if flag & 4:
            continue
        aligned[i] = True
        called = set()
        p = int(f[3]) - 1
        for num, op in re.findall(r"(\d+)([MIDNS])", f[5]):
            if op in "MD":
                p += int(num)
            elif op == "N":
                called.add((p - 1, p + int(num)))
                p += int(num)
        n_spliced += bool(called)
        hit = called & truth[i].keys()
        tp += len(hit)
        tp_a += sum(truth[i][j] >= min_anchor for j in hit)
        fp += len(called) - len(hit)
    check((seen == 1).all(), "every read needs exactly one primary record")
    n_true = sum(len(t) for t in truth)
    n_anch = sum(a >= min_anchor for t in truth for a in t.values())
    return (tp_a / max(n_anch, 1), tp / max(n_true, 1), tp / max(tp + fp, 1),
            float(aligned.mean()), sum(bool(t) for t in truth), n_spliced)


def make_batches(seqs, first: int, batch: int, pad_to: int = PAD_TO):
    from hisat2_tpu_torch.io.reads import Read, batchify
    q = np.full(seqs.shape[1], 40, np.int8)
    out = []
    for b0 in range(0, seqs.shape[0], batch):
        rows = range(b0, min(b0 + batch, seqs.shape[0]))
        out.append(batchify([Read(f"s{first + i}", seqs[i], q, first + i)
                             for i in rows], pad_to=pad_to))
    return out


def run_stream(al, batches, ref):
    from hisat2_tpu_torch.align.emit import align_and_emit_stream
    from hisat2_tpu_torch.io import sam as samio
    buf = io.StringIO()
    writer = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                             no_head=True)
    stats = align_and_emit_stream(al, batches, writer)
    return buf.getvalue(), stats


def chrom_coords(ref, joff: np.ndarray):
    """(reference names, 0-based chromosome offsets) of joined offsets."""
    f = np.searchsorted(ref.frag_joined, joff, side="right") - 1
    names = np.asarray(ref.names, dtype=object)[ref.frag_tidx[f]]
    return names, ref.frag_toff[f] + joff - ref.frag_joined[f]


def check_sam(text: str, n: int, starts: np.ndarray, indel: np.ndarray,
              ref=None):
    """One primary record per read; alignment rate; true placement of the
    indel-free reads (POS minus the leading soft clip is the read's
    start on the reference; with `ref`, on the chromosome its joined
    start lies in)."""
    names = None
    if ref is not None:
        names, starts = chrom_coords(ref, starts)
    seen = np.zeros(n, np.int64)
    aligned = np.zeros(n, bool)
    placed = np.zeros(n, bool)
    for ln in text.splitlines():
        f = ln.split("\t", 6)
        flag = int(f[1])
        if flag & 256:
            continue
        i = int(f[0][1:])
        seen[i] += 1
        if flag & 4:
            continue
        aligned[i] = True
        clip = re.match(r"(\d+)S", f[5])
        lead = int(clip.group(1)) if clip else 0
        placed[i] = (int(f[3]) - 1 - lead == starts[i]
                     and (names is None or f[2] == names[i]))
    check((seen == 1).all(),
          f"reads emitted != once: {int((seen != 1).sum())}")
    rate = float(aligned.mean())
    ok = ~indel
    true_rate = float(placed[ok].mean())
    check(rate >= 0.90, f"aligned {rate:.4f} < 0.90")
    check(true_rate >= 0.95, f"indel-free reads placed {true_rate:.4f}")
    return rate, true_rate, float(aligned[indel].mean())


def fm_variants(fm):
    """The smoke genome's index four more ways, over the arrays already
    built (no second suffix-array build): A without the k-mer table, B =
    A with the SA sampled at FM_OFFRATE, and the table index with a
    kt = FM_PAIR_KT table (paired-k-mer mode) and a stride-2 table."""
    from hisat2_tpu_torch.index.fm_index import build_sampled_sa
    from hisat2_tpu_torch.index.seed_table import build_seed_table
    a = dataclasses.replace(fm, st_starts=None, st_pos=None, st_k=0)
    bits, rank, vals = build_sampled_sa(fm.sa.astype(np.int64), FM_OFFRATE)
    b = dataclasses.replace(a, offrate=FM_OFFRATE, samp_bits=bits,
                            samp_rank=rank, samp_vals=vals,
                            sa=np.zeros(0, np.int32))
    kt = min(FM_PAIR_KT, fm.st_k)
    while kt > 1 and fm.n <= 3 * 4 ** kt:     # small genomes (the CPU tests)
        kt -= 1
    st, pos, k = build_seed_table(fm.ref.joined, kt=kt)
    pair = dataclasses.replace(fm, st_starts=st, st_pos=pos, st_k=k)
    st, pos, k = build_seed_table(fm.ref.joined, kt=fm.st_k, stride=2)
    stride2 = dataclasses.replace(fm, st_starts=st, st_pos=pos, st_k=k,
                                  st_stride=2)
    return dict(A=a, B=b, pair=pair, stride2=stride2)


def run_per_read(al, batches, ref):
    """Aligner.align_batch + results_to_sam over SE batches."""
    from hisat2_tpu_torch.align.pipeline import results_to_sam
    from hisat2_tpu_torch.io import sam as samio
    buf = io.StringIO()
    writer = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                             no_head=True)
    stats: dict = {}
    for b in batches:
        for k, v in results_to_sam(b, al.align_batch(b), al, writer).items():
            stats[k] = stats.get(k, 0) + v
    writer.flush()
    return buf.getvalue(), stats


def run_per_pair(al, pair_batches, ref):
    """paired.align_pairs + pairs_to_sam over pair batches."""
    from hisat2_tpu_torch.align.paired import align_pairs, pairs_to_sam
    from hisat2_tpu_torch.io import sam as samio
    buf = io.StringIO()
    writer = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                             no_head=True)
    stats: dict = {}
    for b1, b2 in pair_batches:
        st = pairs_to_sam(b1, b2, align_pairs(al, b1, b2), al, writer)
        for k, v in st.items():
            stats[k] = stats.get(k, 0) + v
    writer.flush()
    return buf.getvalue(), stats


def simulate_variants(joined: np.ndarray, seed: int, every: int, n_hap: int):
    """Known variants for a graph index: one per `every` bp on a jittered
    grid (so none overlap), 90% SNVs, 5% deletions and 5% insertions of 1-3
    bp, and `n_hap` phased pairs (an SNV 6-30 bp right of a grid SNV, the
    two listed as one haplotype). Returns (SNPDB, haplotypes as lists of
    SNP indices); positions are joined = chromosome coordinates (one
    chromosome, no N)."""
    from hisat2_tpu_torch.io.annotations import SNPDB
    rng = np.random.default_rng(seed)
    n = joined.size
    cells = np.arange((n - 64) // every)
    off = rng.integers(8, every - 8, cells.size)
    pos = cells * every + off
    u = rng.random(pos.size)
    types = np.where(u < 0.90, 0, np.where(u < 0.95, 1, 2))
    lens = np.where(types == 0, 1, rng.integers(1, 4, pos.size))
    # the second SNV of a phased pair, in cells whose SNV leaves room
    room = np.flatnonzero((types == 0) & (off < every - 48))
    first = np.sort(rng.choice(room, min(n_hap, room.size), replace=False))
    pos2 = pos[first] + rng.integers(6, 31, first.size)
    pos = np.concatenate([pos, pos2])
    types = np.concatenate([types, np.zeros(first.size, types.dtype)])
    lens = np.concatenate([lens, np.ones(first.size, lens.dtype)])
    order = np.argsort(pos, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    pos, types, lens = pos[order], types[order], lens[order]
    alt = np.where(types == 0,
                   (joined[pos] + rng.integers(1, 4, pos.size)) % 4, -1)
    ins = [rng.integers(0, 4, int(ln)).astype(np.uint8) if t == 2
           else np.zeros(0, np.uint8) for t, ln in zip(types, lens)]
    snps = SNPDB(names=[f"v{i}" for i in range(pos.size)],
                 types=types.astype(np.int8), jpos=pos.astype(np.int64),
                 lens=lens.astype(np.int32), alt_codes=alt.astype(np.int8),
                 ins_seqs=ins, chroms=["g"] * pos.size,
                 tpos=pos.astype(np.int64))
    haps = [[int(rank[a]), int(rank[cells.size + k])]
            for k, a in enumerate(first)]
    return snps, haps


def apply_haplotype(joined: np.ndarray, snps, haps, seed: int):
    """One individual's genome: every variant applied with probability 0.5,
    the two SNVs of a phased pair together. Returns the haplotype's codes
    and, per haplotype base: its reference position (an inserted base has
    the position of the base after it), whether it is an applied alt SNV,
    whether it is the first base after an applied deletion, and whether it
    is an inserted base."""
    rng = np.random.default_rng(seed)
    take = rng.random(len(snps)) < 0.5
    for a, b in haps:
        take[b] = take[a]
    n = joined.size
    codes = joined.copy()
    sv = take & (snps.types == 0)
    codes[snps.jpos[sv]] = snps.alt_codes[sv]
    alt = np.zeros(n, bool)
    alt[snps.jpos[sv]] = True
    keep = np.ones(n, bool)
    after_del = np.zeros(n, bool)
    for i in np.flatnonzero(take & (snps.types == 1)):
        jp, ln = int(snps.jpos[i]), int(snps.lens[i])
        keep[jp:jp + ln] = False
        after_del[jp + ln] = True
    refpos = np.flatnonzero(keep)
    hap, alt, after_del = codes[keep], alt[keep], after_del[keep]
    iv = np.flatnonzero(take & (snps.types == 2))
    at = np.repeat(np.searchsorted(refpos, snps.jpos[iv]), snps.lens[iv])
    bases = np.concatenate([snps.ins_seqs[i] for i in iv]
                           + [np.zeros(0, np.uint8)])
    inserted = np.insert(np.zeros(hap.size, bool), at, True)
    hap = np.insert(hap, at, bases)
    refpos = np.insert(refpos, at, np.repeat(snps.jpos[iv], snps.lens[iv]))
    alt = np.insert(alt, at, False)
    after_del = np.insert(after_del, at, False)
    return hap.astype(np.uint8), refpos, alt, after_del, inserted


def reads_on_haplotype(starts, flags):
    """Per read of RDLEN starting at haplotype index starts[i]: how many
    haplotype bases inside it carry each flag of `flags` (a list of bool
    arrays over the haplotype; the read's first base does not count, since
    a read that starts right after a deletion does not span it)."""
    out = []
    for f in flags:
        c = np.concatenate([[0], np.cumsum(f)])
        out.append(c[starts + RDLEN] - c[starts + 1])
    return out


def simulate_graph_reads(hap, refpos, alt, after_del, inserted, n, seed):
    """simulate_reads on a haplotype. Returns the codes and a dict of
    per-read arrays: `start` the read's true reference position, `indel` a
    sequencing indel, `err` any sequencing error, `n_alt` alt SNVs inside
    the read, `kdel` / `kins` an applied known deletion / inserted bases
    inside the read."""
    seqs, hstarts, indel = simulate_reads(hap, n, seed)
    true = hap[hstarts[:, None] + np.arange(RDLEN)]
    err = ~((seqs == true).all(axis=1)
            | (seqs == 3 - true[:, ::-1]).all(axis=1))
    n_alt, kdel, kins = reads_on_haplotype(hstarts, [alt, after_del,
                                                     inserted])
    n_alt = n_alt + alt[hstarts]
    return seqs, dict(start=refpos[hstarts], indel=indel, err=err,
                      n_alt=n_alt, kdel=kdel > 0, kins=kins > 0)


def check_graph_sam(text: str, n: int, info: dict, what: str):
    """A graph run's SAM against the truth of simulate_graph_reads: phase
    4's guards over the reads with no indel of either kind, the share of
    error-free alt-SNV reads that come out with no penalty, and the
    error-free reads over one known deletion / insertion that come out
    with its zero-cost D / I. Returns those figures."""
    known = info["kdel"] | info["kins"]
    rate, true_rate, indel_rate = check_sam(text, n, info["start"],
                                            info["indel"] | known)
    free = np.zeros(n, bool)
    gap = np.zeros(n, "U1")
    zs = 0
    for ln in text.splitlines():
        f = ln.split("\t")
        if int(f[1]) & (256 | 4):
            continue
        i = int(f[0][1:])
        tags = set(f[11:])
        zs += any(t.startswith("Zs:Z:") for t in tags)
        free[i] = {"AS:i:0", "XM:i:0", "NM:i:0"} <= tags
        m = re.fullmatch(r"\d+M\d+([DI])\d+M", f[5])
        if m and free[i]:
            gap[i] = m.group(1)
    clean = ~info["err"] & ~known
    alt_reads = clean & (info["n_alt"] > 0)
    alt_free = float(free[alt_reads].mean())
    check(alt_free >= 0.95, f"{what}: error-free alt-SNV reads without "
                            f"penalty {alt_free:.4f} < 0.95")
    kdel = int((gap[~info["err"] & info["kdel"] & ~info["kins"]] == "D").sum())
    kins = int((gap[~info["err"] & info["kins"] & ~info["kdel"]] == "I").sum())
    return dict(rate=rate, true_rate=true_rate, indel_rate=indel_rate,
                alt_reads=int(alt_reads.sum()), alt_free=alt_free,
                free=free, kdel=kdel, kins=kins,
                kdel_reads=int((~info["err"] & info["kdel"]).sum()),
                kins_reads=int((~info["err"] & info["kins"]).sum()), zs=zs)


def _with_indel(rng, joined, s, d, p, insert):
    """RDLEN bases read forward from joined[s]: a d bp deletion after p
    read bases, or (insert) d random bases inserted there."""
    if insert:
        return np.concatenate([joined[s:s + p],
                               rng.integers(0, 4, d).astype(np.uint8),
                               joined[s + p:s + RDLEN - d]])
    return np.concatenate([joined[s:s + p], joined[s + p + d:s + RDLEN + d]])


def simulate_pairs(joined: np.ndarray, n: int, seed: int):
    """n FR pairs of RDLEN reads from fragments of 200-500 bp: mate 1 the
    fragment's start, mate 2 the reverse complement of its end; ~1%
    mismatches, ~2% of mates with one 1-3 bp indel, and half the pairs
    with mates swapped. Returns (mate-1 codes, mate-2 codes, mate 1's true
    leftmost 0-based position, whether either mate has an indel)."""
    rng = np.random.default_rng(seed)
    frag = rng.integers(200, 501, n)
    starts = rng.integers(0, joined.size - 520, n)
    ends = starts + frag - RDLEN           # mate 2's leftmost base
    ar = np.arange(RDLEN)
    r1 = joined[starts[:, None] + ar].copy()
    r2 = joined[ends[:, None] + ar].copy()
    indel = rng.random((n, 2)) < 0.02
    for i, m in zip(*np.nonzero(indel)):
        d, p = int(rng.integers(1, 4)), int(rng.integers(20, 80))
        s = int(starts[i] if m == 0 else ends[i])
        (r1 if m == 0 else r2)[i] = _with_indel(rng, joined, s, d, p,
                                                rng.random() < 0.5)
    for r in (r1, r2):
        mm = rng.random(r.shape) < 0.01
        r[mm] = (r[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
    r2 = np.where(r2 < 4, 3 - r2, 4)[:, ::-1]   # reverse complement
    swap = rng.random(n) < 0.5
    r1[swap], r2[swap] = r2[swap], r1[swap].copy()
    m1_true = np.where(swap, ends, starts)
    return (r1.astype(np.uint8), r2.astype(np.uint8), m1_true,
            indel.any(axis=1))


def make_pair_batches(r1, r2, first: int, batch: int, quals=None):
    """(mate-1 batch, mate-2 batch) tuples of `batch` pairs, both padded
    to PAD_TO; quality 40 unless `quals` gives (n, 2, RDLEN) per-base
    qualities."""
    from hisat2_tpu_torch.io.reads import Read, batchify
    q40 = np.full(RDLEN, 40, np.int8)
    out = []
    for b0 in range(0, r1.shape[0], batch):
        rows = range(b0, min(b0 + batch, r1.shape[0]))
        mates = []
        for m, r in enumerate((r1, r2)):
            mates.append(batchify(
                [Read(f"p{first + i}", r[i],
                      q40 if quals is None else quals[i, m], first + i)
                 for i in rows], pad_to=PAD_TO))
        out.append(tuple(mates))
    return out


def run_pe_stream(al, pair_batches, ref):
    from hisat2_tpu_torch.align.emit import align_and_emit_pe_stream
    from hisat2_tpu_torch.io import sam as samio
    buf = io.StringIO()
    writer = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                             no_head=True)
    stats = align_and_emit_pe_stream(al, pair_batches, writer)
    return buf.getvalue(), stats


def check_pe_sam(text: str, n: int, m1_true: np.ndarray,
                 indel: np.ndarray, ref=None):
    """One primary record per mate; proper-pair share (flag 2); mate 1 of
    the indel-free pairs at its true position (POS minus the leading soft
    clip; with `ref`, on the chromosome its joined start lies in)."""
    names = None
    if ref is not None:
        names, m1_true = chrom_coords(ref, m1_true)
    seen = np.zeros((n, 2), np.int64)
    proper = np.zeros(n, bool)
    placed = np.zeros(n, bool)
    aligned = np.zeros((n, 2), bool)
    for ln in text.splitlines():
        f = ln.split("\t", 6)
        flag = int(f[1])
        if flag & 256:
            continue
        i = int(f[0][1:])
        mate = 0 if flag & 64 else 1
        seen[i, mate] += 1
        if flag & 4:
            continue
        aligned[i, mate] = True
        if mate == 0:
            proper[i] = bool(flag & 2)
            clip = re.match(r"(\d+)S", f[5])
            lead = int(clip.group(1)) if clip else 0
            placed[i] = (int(f[3]) - 1 - lead == m1_true[i]
                         and (names is None or f[2] == names[i]))
    check((seen == 1).all(),
          f"mates emitted != once: {int((seen != 1).sum())}")
    share = float(proper.mean())
    true_rate = float(placed[~indel].mean())
    check(share >= 0.90, f"proper pairs {share:.4f} < 0.90")
    check(true_rate >= 0.95, f"mate 1 of indel-free pairs placed "
                             f"{true_rate:.4f}")
    return share, true_rate, float(aligned.mean())


def counted(fn, what, need=("dp_score",)):
    """fn() with the DP wrappers' launch counts set to 0 before it and read
    after it; every kernel named in `need` must have been launched."""
    import torch
    from hisat2_tpu_torch.ops import dp_cuda
    for k in dp_cuda.launches:
        dp_cuda.launches[k] = 0
    out = fn()
    torch.cuda.synchronize()
    got = dict(dp_cuda.launches)
    for k in need:
        check(got[k] > 0, f"kernel {k} was not launched on {what}")
    return out, got


def sam_card_equals_cpu(run, fmx, items, ref, what, tag,
                        need=("dp_score",), opts=None, prep=None):
    """SAM of `items` through run(aligner, items, ref) on the card and on
    the CPU path: the bytes and the stats must be equal, and the card's
    run must have launched the kernels of `need`. `prep(aligner)`, where
    given, readies each aligner first (known splice sites). Returns (card
    aligner, card text)."""
    from hisat2_tpu_torch.align.pipeline import Aligner, AlignerOpts
    o = opts or {}
    prep = prep or (lambda a: a)
    cpu_text, cpu_stats = run(prep(Aligner(fmx, opts=AlignerOpts(**o),
                                           device="cpu")), items, ref)
    alx = prep(Aligner(fmx, opts=AlignerOpts(**o), device="cuda"))
    (text, stats), got = counted(lambda: run(alx, items, ref), what, need)
    check(text == cpu_text, f"SAM from the card != CPU path on {what}")
    check(stats == cpu_stats, f"stats on the card != CPU path on {what}")
    print(f"[{tag}] SAM bytes on the card == CPU path on {what} "
          f"({len(text)} bytes; launches {got})", flush=True)
    return alx, text


def fm_phase(fm, seqs, starts, indel, r1, r2, m1_true, pe_indel, card):
    """Phase 6 (see the module docstring). Returns the DP kernel's inputs
    as the per-read path built them at 16,384 reads, that run's launch
    counts, and the end-to-end rates."""
    import torch
    from hisat2_tpu_torch.align import emit as temit
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.index.fm_index import FMIndex
    ref = fm.ref
    t0 = time.perf_counter()
    var = fm_variants(fm)
    print(f"[fm] index A (no table), B (offrate {FM_OFFRATE}: "
          f"{var['B'].samp_vals.size} of {fm.sa.size} SA values kept), a "
          f"kt={var['pair'].st_k} table and a stride-2 kt="
          f"{var['stride2'].st_k} table derived in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def card_equals_cpu(run, fmx, items, what, opts=None):
        return sam_card_equals_cpu(run, fmx, items, ref, what, "fm",
                                   opts=opts)

    small = make_batches(seqs[:2048], 0, 2048)
    small_pe = make_pair_batches(r1[:512], r2[:512], 0, 512)
    out = {}

    # -- A and B through the stream: the packed step on FM seeding --------
    texts = {}
    for name, nb in (("A", FM_NBATCH), ("B", 2)):
        alx, texts[name] = card_equals_cpu(
            run_stream, var[name], small, f"index {name}, 2048 reads")
        nbytes = FMIndex.bundle_bytes(alx.idx)
        m = measure_batch(alx, temit.submit_se, temit.finish_se,
                          (make_batches(seqs[:BATCH], 0, BATCH)[0],))
        print(f"[fm] index {name}: one batch of {BATCH} reads alone: queue "
              f"the device step {m['queue_ms']:.1f} ms, {m['launches']} "
              f"launches, device busy {m['busy_ms']:.2f} ms "
              f"({m['busy_ms'] / m['wall_ms']:.4f} of {m['wall_ms']:.1f} ms "
              f"wall) [{card}]", flush=True)
        n = nb * BATCH
        batches = make_batches(seqs[:n], 0, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (text, stats), got = counted(lambda: run_stream(alx, batches, ref),
                                     f"the SE stream, index {name}")
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / (1 << 20)
        rate, true_rate, indel_rate = check_sam(text, n, starts[:n],
                                                indel[:n])
        out[f"se_{name}_rps"] = n / dt
        print(f"[fm] index {name}: {n} reads in {dt:.3f} s = {n / dt:.1f} "
              f"reads/s end to end; aligned {rate:.4f}, indel-free at true "
              f"position {true_rate:.4f}, indel reads aligned "
              f"{indel_rate:.4f}; stats {stats}; launches {got}; bundle "
              f"{nbytes / (1 << 20):.1f} MiB, peak device memory "
              f"{peak:.1f} MiB (the table index's bundle stays resident) "
              f"[{card}]", flush=True)
        if name == "A":
            al_a = alx
    check(texts["B"] == texts["A"],
          "index B (sampled SA) gave other SAM bytes than index A")
    print("[fm] index B's SAM == index A's on 2048 reads", flush=True)

    # -- PE on A ------------------------------------------------------------
    card_equals_cpu(run_pe_stream, var["A"], small_pe,
                    "index A, 512 pairs (packed PE step)")
    pe_n = 2 * PE_BATCH
    pe_batches = make_pair_batches(r1[:pe_n], r2[:pe_n], 0, PE_BATCH)
    t0 = time.perf_counter()
    (pe_text, pe_stats), got = counted(
        lambda: run_pe_stream(al_a, pe_batches, ref), "the PE stream, index A")
    pe_dt = time.perf_counter() - t0
    check(got["dp_score_wide"] >= 2, "the PE stream on index A launched the "
                                     "wide DP fewer than once a batch")
    share, m1_rate, mate_rate = check_pe_sam(pe_text, pe_n, m1_true[:pe_n],
                                             pe_indel[:pe_n])
    out["pe_A_pps"] = pe_n / pe_dt
    print(f"[fm] index A: {pe_n} pairs in {pe_dt:.3f} s = {pe_n / pe_dt:.1f} "
          f"pairs/s end to end; proper pairs {share:.4f}, mate 1 of "
          f"indel-free pairs at true position {m1_rate:.4f}, mates aligned "
          f"{mate_rate:.4f}; stats {pe_stats}; launches {got} [{card}]",
          flush=True)
    del al_a

    # -- seed_mode=False: the per-read and per-pair paths -------------------
    off = dict(seed_mode=False)
    for name, fmx in (("index A", var["A"]), ("the table index", fm)):
        al0, _ = card_equals_cpu(run_stream, fmx, small,
                                 f"{name}, seed_mode=False, 2048 reads "
                                 f"(emit path)", off)
        card_equals_cpu(run_per_pair, fmx, small_pe,
                        f"{name}, seed_mode=False, 512 pairs (align_pairs + "
                        f"pairs_to_sam)", off)
        if fmx is not fm:
            # full width: align_batch + results_to_sam on one batch; record
            # the DP kernel's inputs as _device_align builds them
            captured = []
            real_dp = tpipe.dp_score

            def recording_dp(*a, **kw):
                if not captured:
                    captured.append([x.clone() for x in a])
                return real_dp(*a, **kw)
            batch = make_batches(seqs[:BATCH], 0, BATCH)
            tpipe.dp_score = recording_dp
            try:
                t0 = time.perf_counter()
                (text, stats), got = counted(
                    lambda: run_per_read(al0, batch, ref),
                    "align_batch, index A")
                dt = time.perf_counter() - t0
            finally:
                tpipe.dp_score = real_dp
            rate, true_rate, indel_rate = check_sam(
                text, BATCH, starts[:BATCH], indel[:BATCH])
            out.update(captured=captured[0], launches=got["dp_score"])
            print(f"[fm] index A, seed_mode=False: align_batch + "
                  f"results_to_sam on {BATCH} reads in {dt:.3f} s = "
                  f"{BATCH / dt:.1f} reads/s; aligned {rate:.4f}, "
                  f"indel-free at true position {true_rate:.4f}, indel "
                  f"reads aligned {indel_rate:.4f}; stats {stats}; "
                  f"dp_lanes {al0.metrics.dp_lanes}, fallback_reads "
                  f"{al0.metrics.fallback_reads}; launches {got} [{card}]",
                  flush=True)
        del al0

    # -- the seed-table modes of Gbp-scale shards ----------------------------
    for name, what in (("pair", "paired-k-mer mode"),
                       ("stride2", "stride-sampled table")):
        fmx = var[name]
        alx, text = card_equals_cpu(
            run_stream, fmx, small,
            f"the kt={fmx.st_k} stride={fmx.st_stride} table ({what}), 2048 "
            f"reads")
        rows = alx.idx["st_pos_rows"]
        check((rows.numel() / 4 ** fmx.st_k > 3.0) == (name == "pair"),
              f"{name}: bucket load {rows.numel() / 4 ** fmx.st_k:.2f}")
        rate, true_rate, indel_rate = check_sam(text, 2048, starts[:2048],
                                                indel[:2048])
        print(f"[fm] {what}: bucket load "
              f"{rows.numel() / 4 ** fmx.st_k:.2f}, aligned {rate:.4f}, "
              f"indel-free at true position {true_rate:.4f}, indel reads "
              f"aligned {indel_rate:.4f}", flush=True)
        del alx
    torch.cuda.empty_cache()
    out["var"] = var
    return out


def graph_phase(fm, al_linear, seqs_linear_rps, card, profile):
    """Phase 7 (see the module docstring). Returns the overlay kernel's
    inputs as _stage_dp built them on the graph index, the launches of the
    graph runs, and the end-to-end rates."""
    import torch
    from hisat2_tpu_torch.align import emit as temit
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.index.fm_index import FMIndex
    from hisat2_tpu_torch.index.graph_index import build_graph_index
    ref = fm.ref
    t0 = time.perf_counter()
    snps, haps = simulate_variants(ref.joined, 31, GRAPH_VARIANT_EVERY,
                                   GRAPH_HAP_PAIRS)
    gfm = build_graph_index(ref, snps, haplotypes=haps)
    gfm_fm = dataclasses.replace(gfm, st_starts=None, st_pos=None, st_k=0)
    nt = np.bincount(snps.types, minlength=3)
    print(f"[graph] {len(snps)} variants ({nt[0]} SNVs, {nt[1]} deletions, "
          f"{nt[2]} insertions, {len(haps)} phased pairs) -> graph index of "
          f"{gfm.n} bp ({gfm.primary_n} primary + {gfm.patch_start.size} "
          f"patches), kt={gfm.st_k}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(gfm.st_k > 0 and gfm.primary_n == GENOME_LEN
          and gfm.patch_start.size == len(snps) + len(haps),
          "graph index geometry")
    hap = apply_haplotype(ref.joined, snps, haps, 32)
    n = GRAPH_NBATCH * BATCH
    seqs, info = simulate_graph_reads(*hap, n, seed=33)
    pe_n = GRAPH_PE_NBATCH * PE_BATCH
    r1, r2, m1_hap, pe_indel = simulate_pairs(hap[0], pe_n, seed=34)
    m1_true = hap[1][m1_hap]
    kd, ki = reads_on_haplotype(m1_hap, [hap[3], hap[4]])
    pe_indel = pe_indel | (kd > 0) | (ki > 0)

    need = ("dp_score", "dp_score_ov")     # every graph run: the overlay

    def card_equals_cpu(run, fmx, items, what, opts=None):
        return sam_card_equals_cpu(run, fmx, items, ref, what, "graph",
                                   need, opts)

    small = make_batches(seqs[:2048], 0, 2048)
    out = {"launches": 0}
    small_info = {k: v[:2048] for k, v in info.items()}

    # -- SE on the table-seeded graph index ------------------------------
    al, text = card_equals_cpu(run_stream, gfm, small,
                               "the graph index, 2048 reads (SE stream)")
    nbytes = FMIndex.bundle_bytes(al.idx)
    graph_keys = ("snv_packed", "primary_n", "patch_start", "patch_ref",
                  "patch_vpos", "patch_shift", "patch_len")
    gbytes = FMIndex.bundle_bytes({k: al.idx[k] for k in graph_keys})
    batches = make_batches(seqs, 0, BATCH)
    m = measure_batch(al, temit.submit_se, temit.finish_se, (batches[0],))
    print(f"[graph] one batch of {BATCH} reads alone: queue the device step "
          f"{m['queue_ms']:.1f} ms, {m['launches']} launches, device busy "
          f"{m['busy_ms']:.2f} ms ({m['busy_ms'] / m['wall_ms']:.4f} of "
          f"{m['wall_ms']:.1f} ms wall) [{card}]", flush=True)
    captured = []
    real_dp = tpipe.dp_score

    def recording_dp(*a, **kw):
        if not captured and kw.get("ov") is not None:
            captured.append([x.clone() for x in a] + [kw["ov"].clone()])
        return real_dp(*a, **kw)
    tpipe.dp_score = recording_dp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        (text, stats), got = counted(lambda: run_stream(al, batches, ref),
                                     "the graph SE stream", need)
        dt = time.perf_counter() - t0
    finally:
        tpipe.dp_score = real_dp
    check(bool(captured), "the graph SE stream passed no overlay to the DP")
    check(got["dp_score_ov"] >= GRAPH_NBATCH,
          f"overlay kernel launched {got['dp_score_ov']} times for "
          f"{GRAPH_NBATCH} batches")
    peak = torch.cuda.max_memory_allocated() / (1 << 20)
    g = check_graph_sam(text, n, info, "graph SE stream")
    check(g["kdel"] >= 1 and g["kins"] >= 1,
          f"no zero-cost known deletion ({g['kdel']}) or insertion "
          f"({g['kins']}) in the graph SE stream")
    out.update(se_rps=n / dt, captured=captured[0])
    out["launches"] += got["dp_score_ov"]
    print(f"[graph] {n} reads in {dt:.3f} s = {n / dt:.1f} reads/s end to "
          f"end ({n / dt / seqs_linear_rps:.3f} of the linear table path's); "
          f"aligned {g['rate']:.4f}, reads without indels at true position "
          f"{g['true_rate']:.4f}, reads with an indel of either kind aligned "
          f"{g['indel_rate']:.4f}; error-free alt-SNV reads "
          f"{g['alt_reads']}, {g['alt_free']:.4f} of them AS:i:0 XM:i:0 "
          f"NM:i:0; error-free reads over a known deletion {g['kdel_reads']}"
          f" ({g['kdel']} with its zero-cost D), over a known insertion "
          f"{g['kins_reads']} ({g['kins']} with its zero-cost I); stats "
          f"{stats}; launches {got}; bundle {nbytes / (1 << 20):.1f} MiB of "
          f"which graph keys {gbytes / (1 << 20):.2f} MiB; peak device "
          f"memory {peak:.1f} MiB [{card}]", flush=True)
    # the same reads on the linear index: an alt allele costs a mismatch
    ltext, _ = run_stream(al_linear, batches[:1], ref)
    lfree = lalt = 0
    first = {k: v[:BATCH] for k, v in info.items()}
    clean_alt = (~first["err"] & ~first["kdel"] & ~first["kins"]
                 & (first["n_alt"] > 0))
    for ln in ltext.splitlines():
        f = ln.split("\t")
        if int(f[1]) & (256 | 4) or not clean_alt[int(f[0][1:])]:
            continue
        lalt += 1
        lfree += "AS:i:0" in f[11:]
    check(lfree == 0 and lalt > 0,
          f"{lfree} alt-SNV reads scored 0 on the linear index")
    print(f"[graph] the first batch's {int(clean_alt.sum())} error-free "
          f"alt-SNV reads on the linear index: {lalt} aligned, {lfree} with "
          f"AS:i:0 (graph index: "
          f"{int(g['free'][:BATCH][clean_alt].sum())})", flush=True)
    if profile:
        profile_batch(al, temit.submit_se, temit.finish_se, (batches[0],),
                      "SE batch of 16384 reads on the graph index")

    # -- PE on the graph index ------------------------------------------
    qrng = np.random.default_rng(35)
    perbase = qrng.integers(2, 42, (512, 2, RDLEN)).astype(np.int8)
    card_equals_cpu(run_pe_stream, gfm,
                    make_pair_batches(r1[:2048], r2[:2048], 0, 2048),
                    "the graph index, 2048 constant-quality pairs (packed "
                    "PE step)")
    card_equals_cpu(run_pe_stream, gfm,
                    make_pair_batches(r1[:512], r2[:512], 0, 512, perbase),
                    "the graph index, 512 per-base-quality pairs (fused PE "
                    "step)")
    pe_batches = make_pair_batches(r1, r2, 0, PE_BATCH)
    t0 = time.perf_counter()
    (pe_text, pe_stats), got = counted(
        lambda: run_pe_stream(al, pe_batches, ref), "the graph PE stream",
        need + ("dp_score_wide",))
    pe_dt = time.perf_counter() - t0
    check(got["dp_score_wide"] >= GRAPH_PE_NBATCH,
          "the graph PE stream launched the wide DP fewer than once a batch")
    share, m1_rate, mate_rate = check_pe_sam(pe_text, pe_n, m1_true, pe_indel)
    out["pe_pps"] = pe_n / pe_dt
    out["launches"] += got["dp_score_ov"]
    print(f"[graph] {pe_n} pairs in {pe_dt:.3f} s = {pe_n / pe_dt:.1f} "
          f"pairs/s end to end; proper pairs {share:.4f}, mate 1 of pairs "
          f"without indels at true position {m1_rate:.4f}, mates aligned "
          f"{mate_rate:.4f}; stats {pe_stats}; launches {got} [{card}]",
          flush=True)

    # -- per-read path and Zs:Z tags --------------------------------------
    card_equals_cpu(run_stream, gfm, small,
                    "the graph index, seed_mode=False, 2048 reads",
                    dict(seed_mode=False))
    card_equals_cpu(run_per_pair, gfm,
                    make_pair_batches(r1[:512], r2[:512], 0, 512),
                    "the graph index, seed_mode=False, 512 pairs "
                    "(align_pairs + pairs_to_sam)", dict(seed_mode=False))
    _, ztext = card_equals_cpu(run_stream, gfm, small,
                               "the graph index, zs_tags=True, 2048 reads",
                               dict(zs_tags=True))
    z = check_graph_sam(ztext, 2048, small_info, "graph Zs:Z run")
    check(z["zs"] >= 1, "no record carries a Zs:Z tag")
    print(f"[graph] zs_tags=True: {z['zs']} of 2048 reads carry Zs:Z",
          flush=True)
    del al

    # -- 250 bp reads: the DP window W = 256 + 2 * 16 = 288 takes the
    # one-block kernel's overlay instantiation
    s250, _, _ = simulate_reads(hap[0], 2048, seed=36, rdlen=250)
    captured_w = []

    def recording_w(*a, **kw):
        if not captured_w and a[0].is_cuda and kw.get("ov") is not None:
            captured_w.append([x.clone() for x in a] + [kw["ov"].clone()])
        return real_dp(*a, **kw)
    tpipe.dp_score = recording_w
    try:
        sam_card_equals_cpu(run_stream, gfm, make_batches(s250, 0, 2048, 256),
                            ref, "the graph index, 2048 reads of 250 bp "
                            "(DP window W = 288)", "graph",
                            ("dp_score_wide", "dp_score_ov"))
        from hisat2_tpu_torch.ops import dp_cuda
        out["wide_ov_launches"] = dp_cuda.launches["dp_score_wide"]
    finally:
        tpipe.dp_score = real_dp
    check(bool(captured_w) and captured_w[0][3].shape[1] == 288,
          "the 250 bp graph reads passed no W = 288 overlay window")
    out["captured_wide_ov"] = captured_w[0]

    # -- the FM-seeded graph index ------------------------------------------
    alf, _ = card_equals_cpu(run_stream, gfm_fm, small,
                             "the FM-seeded graph index, 2048 reads")
    check(alf.seeder == "seeds" and "sides" in alf.idx,
          "the stripped graph index must seed by backward search")
    nf = GRAPH_FM_NBATCH * BATCH
    t0 = time.perf_counter()
    (text, stats), got = counted(
        lambda: run_stream(alf, batches[:GRAPH_FM_NBATCH], ref),
        "the FM-seeded graph SE stream", need)
    dt = time.perf_counter() - t0
    gf = check_graph_sam(text, nf, {k: v[:nf] for k, v in info.items()},
                         "FM-seeded graph SE stream")
    out["fm_rps"] = nf / dt
    out["launches"] += got["dp_score_ov"]
    print(f"[graph] FM-seeded: {nf} reads in {dt:.3f} s = {nf / dt:.1f} "
          f"reads/s end to end; aligned {gf['rate']:.4f}, reads without "
          f"indels at true position {gf['true_rate']:.4f}; error-free "
          f"alt-SNV reads without penalty {gf['alt_free']:.4f}; known "
          f"deletions / insertions with zero-cost gaps {gf['kdel']} / "
          f"{gf['kins']}; stats {stats}; launches {got}; bundle "
          f"{FMIndex.bundle_bytes(alf.idx) / (1 << 20):.1f} MiB [{card}]",
          flush=True)
    del alf
    torch.cuda.empty_cache()
    return out


def rna_phase(fm, fm_fm, txs, dna_rps, card, profile):
    """Phase 8 (see the module docstring). Returns the DP kernel's inputs
    as the RNA step built them, the launches of the RNA streams, and the
    rates and junction scores."""
    import torch
    from hisat2_tpu_torch.align import emit as temit
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.align.pipeline import Aligner, AlignerOpts
    ref = fm.ref
    n = RNA_NBATCH * BATCH
    seqs, truth = simulate_rna_reads(ref.joined, txs, 2 * n + RNA_CHECK,
                                     seed=41)
    sites = [(e - 1, a, st) for st, ex in txs
             for (_, e), (a, _) in zip(ex, ex[1:])]
    span = [ex[-1][1] - ex[0][0] for _, ex in txs]
    print(f"[rna] gene model: {len(txs)} transcripts (2-6 exons), "
          f"{len(sites)} introns of 60-50,000 bp, spans up to {max(span)} "
          f"bp; {sum(bool(t) for t in truth) / len(truth):.4f} of the reads "
          f"cross a junction", flush=True)

    def known(al):
        for left, right, strand in sites:
            al.ssdb.add_known(left, right, strand)
        return al

    def card_equals_cpu(fmx, what, prep=None, **opts):
        return sam_card_equals_cpu(run_stream, fmx, small, ref, what, "rna",
                                   opts=dict(spliced=True, **opts),
                                   prep=prep)[1]

    small = make_batches(seqs[2 * n:], 0, RNA_CHECK)
    ctruth = truth[2 * n:]
    text = card_equals_cpu(fm, f"{RNA_CHECK} RNA reads (SE stream)")
    rc, _, pc, _, _, _ = check_junctions(text, ctruth, RNA_CHECK)
    card_equals_cpu(fm, f"{RNA_CHECK} RNA reads, seed_mode=False, known "
                    f"sites", known, seed_mode=False)
    card_equals_cpu(fm, f"{RNA_CHECK} RNA reads, dta=True", dta=True)
    ttext = card_equals_cpu(fm, f"{RNA_CHECK} RNA reads, tmo=True, known "
                            f"sites", known, tmo=True)
    trecs = [f for f in (ln.split("\t") for ln in ttext.splitlines())
             if not int(f[1]) & 4]
    check(bool(trecs) and all("N" in f[5] for f in trecs),
          "tmo=True must report spliced records only, and some")
    card_equals_cpu(fm_fm, f"{RNA_CHECK} RNA reads on index A (FM seeding)")

    captured = []
    real_dp = tpipe.dp_score

    def recording_dp(*a, **kw):
        if not captured and a[0].is_cuda:
            captured.append([x.clone() for x in a])
        return real_dp(*a, **kw)
    out = {"launches": 0, "check_recall": rc, "check_precision": pc}
    for tag, prep, rows in (("known", known, slice(0, n)),
                            ("novel", None, slice(n, 2 * n))):
        al = Aligner(fm, opts=AlignerOpts(spliced=True), device="cuda")
        if prep:
            prep(al)
        batches = make_batches(seqs[rows], 0, BATCH)
        tpipe.dp_score = recording_dp
        torch.cuda.synchronize()
        try:
            t0 = time.perf_counter()
            (text, stats), got = counted(
                lambda: run_stream(al, batches, ref),
                f"the RNA stream ({tag} sites)")
            dt = time.perf_counter() - t0
        finally:
            tpipe.dp_score = real_dp
        recall, recall_all, precision, rate, njr, nsp = check_junctions(
            text, truth[rows], n)
        out["launches"] += got["dp_score"]
        out[f"rps_{tag}"] = n / dt
        out[f"recall_{tag}"], out[f"precision_{tag}"] = recall, precision
        out[f"recall_all_{tag}"] = recall_all
        print(f"[rna] {'known sites of every intron' if prep else 'no known sites'}"
              f": {n} reads in {dt:.3f} s = {n / dt:.1f} reads/s end to end "
              f"({n / dt / dna_rps:.3f} of the DNA table path's); aligned "
              f"{rate:.4f}; junction recall {recall:.4f} (anchors of 7 bp "
              f"or more; {recall_all:.4f} over all), precision "
              f"{precision:.4f} ({njr} reads cross a junction, {nsp} "
              f"primary records spliced); novel sites published "
              f"{len(al.ssdb.novel)}; stats {stats}; launches {got} [{card}]",
              flush=True)
        if tag == "novel":
            check(recall >= 0.90 and precision >= 0.99,
                  f"junction recall {recall:.4f} / precision {precision:.4f}"
                  f" below 0.90 / 0.99 without known sites")
            m = measure_batch(al, temit.submit_se, temit.finish_se,
                              (batches[0],))
            out["batch"] = m
            print(f"[rna] one batch of {BATCH} RNA reads alone: queue the "
                  f"device step {m['queue_ms']:.1f} ms, {m['launches']} "
                  f"launches, device busy {m['busy_ms']:.2f} ms "
                  f"({m['busy_ms'] / m['wall_ms']:.4f} of {m['wall_ms']:.1f} "
                  f"ms wall) [{card}]", flush=True)
            if profile:
                profile_batch(al, temit.submit_se, temit.finish_se,
                              (batches[0],), "RNA batch of 16384 reads")
        del al
    check(bool(captured), "the RNA streams launched no DP")
    out["captured"] = captured[0]
    torch.cuda.empty_cache()
    return out


def rna_pe_phase(fm, fm_fm, txs, rres, pps, card, profile):
    """Phase 9 (see the module docstring). Returns the DP kernels' inputs
    as the PE RNA step and its ladder rescue built them, their launches,
    the rates and the guards' figures."""
    import torch
    from hisat2_tpu_torch.align import emit as temit
    from hisat2_tpu_torch.align import paired as tpaired
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.align.pipeline import Aligner, AlignerOpts
    ref = fm.ref
    n = RNA_PE_NBATCH * PE_BATCH
    r1, r2, truth = simulate_rna_pairs(ref.joined, txs, 2 * n + RNA_PE_CHECK,
                                       seed=42)
    sites = [(e - 1, a, st) for st, ex in txs
             for (_, e), (a, _) in zip(ex, ex[1:])]

    def part(lo, hi):
        return dict(junc=truth["junc"][2 * lo:2 * hi],
                    left=truth["left"][2 * lo:2 * hi],
                    frag=truth["frag"][lo:hi], fjunc=truth["fjunc"][lo:hi])
    nj = sum(bool(t) for t in truth["junc"])
    print(f"[rna-pe] {len(truth['frag'])} pairs of {RDLEN} bp mates from "
          f"fragments of 200-500 bp along the transcripts; "
          f"{nj / len(truth['junc']):.4f} of the mates cross a junction",
          flush=True)

    def known(al):
        for left, right, strand in sites:
            al.ssdb.add_known(left, right, strand)
        return al

    small = make_pair_batches(r1[2 * n:], r2[2 * n:], 0, RNA_PE_CHECK)

    def card_equals_cpu(fmx, what, prep=None, **opts):
        return sam_card_equals_cpu(
            run_pe_stream, fmx, small, ref, f"{RNA_PE_CHECK} RNA pairs{what}",
            "rna-pe", opts=dict(spliced=True, **opts), prep=prep)[1]

    text = card_equals_cpu(fm, " (PE stream)")
    ctruth = part(2 * n, 2 * n + RNA_PE_CHECK)
    rc, _, pc, _, _, _ = check_junctions(text, ctruth["junc"],
                                         2 * RNA_PE_CHECK, paired=True)
    card_equals_cpu(fm, ", seed_mode=False, known sites", known,
                    seed_mode=False)
    ttext = card_equals_cpu(fm, ", tmo=True, known sites", known, tmo=True)
    trecs = [f for f in (ln.split("\t") for ln in ttext.splitlines())
             if not int(f[1]) & 4]
    check(bool(trecs) and all("N" in f[5] for f in trecs),
          "tmo=True must report spliced records only, and some")
    card_equals_cpu(fm, ", no_temp_splicesite=True", no_temp_splicesite=True)
    card_equals_cpu(fm_fm, " on index A (FM seeding)")

    captured, captured_wide = [], []
    real_dp, real_pe_dp = tpipe.dp_score, tpaired.dp_score

    def recording_dp(*a, **kw):
        if not captured and a[0].is_cuda:
            captured.append([x.clone() for x in a])
        return real_dp(*a, **kw)

    def recording_pe_dp(*a, **kw):
        if not captured_wide and a[0].is_cuda and \
                kernel_of(a[3].shape[1]) == "dp_score_wide":
            captured_wide.append([x.clone() for x in a])
        return real_pe_dp(*a, **kw)
    out = {"launches": {}, "check_recall": rc, "check_precision": pc,
           "n_known_sites": len(sites)}
    for tag, prep, lo in (("known", known, 0), ("novel", None, n)):
        al = Aligner(fm, opts=AlignerOpts(spliced=True), device="cuda")
        if prep:
            prep(al)
        batches = make_pair_batches(r1[lo:lo + n], r2[lo:lo + n], 0,
                                    PE_BATCH)
        tpipe.dp_score, tpaired.dp_score = recording_dp, recording_pe_dp
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            (text, stats), got = counted(
                lambda: run_pe_stream(al, batches, ref),
                f"the RNA PE stream ({tag} sites)")
            dt = time.perf_counter() - t0
        finally:
            tpipe.dp_score, tpaired.dp_score = real_dp, real_pe_dp
        peak = torch.cuda.max_memory_allocated() / (1 << 20)
        t = part(lo, lo + n)
        recall, recall_all, precision, rate, njr, nsp = check_junctions(
            text, t["junc"], 2 * n, paired=True)
        if prep:
            proper, tlen_ok, n_clean, tlen_all, n_exact = check_rna_pairs(
                text, t, n, [(a, b) for a, b, _ in sites])
            tl_line = (f"|TLEN| = fragment length for {tlen_ok:.4f} of the "
                       f"{n_clean} proper pairs with both mates at their "
                       f"true position unclipped and no other transcript's "
                       f"intron between them ({tlen_all:.4f} of all "
                       f"{n_exact} such pairs)")
            out["tlen_known"], out["tlen_all_known"] = tlen_ok, tlen_all
        else:
            proper = check_rna_pairs(text, t, n)
            tl_line = "TLEN not checked without known sites"
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out[f"pps_{tag}"] = n / dt
        out[f"peak_{tag}"] = peak
        out[f"recall_{tag}"], out[f"precision_{tag}"] = recall, precision
        out[f"proper_{tag}"] = proper
        rps8 = rres[f"rps_{tag}"]
        print(f"[rna-pe] {'known sites of every intron' if prep else 'no known sites'}"
              f": {n} pairs in {dt:.3f} s = {n / dt:.1f} pairs/s = "
              f"{2 * n / dt:.1f} reads/s end to end ({2 * n / dt / rps8:.3f} "
              f"of phase 8's {rps8:.1f} RNA SE reads/s, {n / dt / pps:.3f} of "
              f"phase 5's {pps:.1f} DNA pairs/s); proper pairs {proper:.4f}; "
              f"{tl_line}; mates aligned {rate:.4f}; junction recall "
              f"{recall:.4f} (anchors of 7 bp or more; {recall_all:.4f} over "
              f"all), precision {precision:.4f} ({njr} mates cross a "
              f"junction, {nsp} primary records spliced); novel sites "
              f"published {len(al.ssdb.novel)}; peak device memory "
              f"{peak:.1f} MiB; stats {stats}; launches {got} [{card}]",
              flush=True)
        check(proper >= 0.90, f"RNA PE proper pairs {proper:.4f} < 0.90 "
                              f"({tag} sites)")
        if tag == "known":
            check(tlen_ok >= 0.90, f"|TLEN| = fragment length for only "
                                   f"{tlen_ok:.4f} of {n_clean} pairs")
        else:
            check(recall >= 0.90 and precision >= 0.99,
                  f"RNA PE junction recall {recall:.4f} / precision "
                  f"{precision:.4f} below 0.90 / 0.99 without known sites")
            torch.cuda.reset_peak_memory_stats()
            m = measure_batch(al, temit.submit_pe, temit.finish_pe,
                              batches[0])
            m["peak_mb"] = torch.cuda.max_memory_allocated() / (1 << 20)
            out["batch"] = m
            print(f"[rna-pe] one batch of {PE_BATCH} RNA pairs alone (a "
                  f"{2 * PE_BATCH}-row step): queue the device step "
                  f"{m['queue_ms']:.1f} ms, {m['launches']} launches, device "
                  f"busy {m['busy_ms']:.2f} ms ({m['busy_ms'] / m['wall_ms']:.4f}"
                  f" of {m['wall_ms']:.1f} ms wall), peak device memory "
                  f"{m['peak_mb']:.1f} MiB [{card}]", flush=True)
            if profile:
                profile_batch(al, temit.submit_pe, temit.finish_pe,
                              batches[0], "RNA PE batch of 16384 pairs")
        del al
    check(bool(captured), "the RNA PE streams launched no DP")
    check(bool(captured_wide), "the RNA PE ladder launched no rescue DP")
    out["captured"], out["captured_wide"] = captured[0], captured_wide[0]
    torch.cuda.empty_cache()
    return out


def small_sharded_case():
    """Phase 10's small sharded genome (tests/test_torch_gpu.py's sharded
    twins use it too): three chromosomes of SMALL_CHROM bp, one shard each;
    chr1's 600 bp segments at 26-38 kb copied into chr3 at the same
    offsets (reads there place in two shards: the cross-shard merge and
    its ladder); GT..AG introns of 400 and 1,500 bp at 5 and 20 kb of
    every chromosome, all known; a known variant about every 250 bp (90%
    SNVs) for the graph index. Returns the reference, the linear and the
    graph ShardedIndex, the known sites (joined: last base of the left
    exon, first of the right) and the inputs of every configuration as
    port batches."""
    from hisat2_tpu_torch.index.sharded import build_sharded
    from hisat2_tpu_torch.io.annotations import SNPDB
    from hisat2_tpu_torch.io.reference import reference_from_seqs
    from hisat2_tpu_torch.utils import alphabet
    rng = np.random.default_rng(50)
    codes = [rng.integers(0, 4, SMALL_CHROM).astype(np.uint8)
             for _ in range(3)]
    for p in range(26000, 38000, 1500):
        codes[2][p:p + 600] = codes[0][p:p + 600]
    introns = []
    for c in range(3):
        for start, ilen in ((5000, 400), (20000, 1500)):
            codes[c][start:start + 2] = [2, 3]
            codes[c][start + ilen - 2:start + ilen] = [0, 2]
            introns.append((c * SMALL_CHROM + start, ilen))
    ref = reference_from_seqs({f"chr{c + 1}": alphabet.decode(codes[c])
                               for c in range(3)})
    joined = ref.joined
    v, _ = simulate_variants(joined, 53, 250, 0)
    off = v.jpos % SMALL_CHROM
    sel = np.flatnonzero((off > 64) & (off < SMALL_CHROM - 64))
    snps = SNPDB(names=[v.names[i] for i in sel], types=v.types[sel],
                 jpos=v.jpos[sel], lens=v.lens[sel],
                 alt_codes=v.alt_codes[sel],
                 ins_seqs=[v.ins_seqs[i] for i in sel],
                 chroms=[f"chr{int(j) // SMALL_CHROM + 1}"
                         for j in v.jpos[sel]], tpos=off[sel])
    se = simulate_reads(joined, SMALL_SE, seed=54)[0]
    r1, r2, _, _ = simulate_pairs(joined, SMALL_PE, seed=55)
    # a few pairs with a random mate 2: the ladder's mate rescue scores
    # their windows (on the host aligner's device)
    r2[-16:] = rng.integers(0, 4, (16, RDLEN)).astype(np.uint8)
    # graph reads: the alt allele of every SNV they cover
    gst = rng.integers(0, joined.size - RDLEN, SMALL_SE)
    graph = joined[gst[:, None] + np.arange(RDLEN)].copy()
    snv = np.flatnonzero(snps.types == 0)
    for i, s in enumerate(gst):
        for k in snv[(snps.jpos[snv] >= s) & (snps.jpos[snv] < s + RDLEN)]:
            graph[i, snps.jpos[k] - s] = snps.alt_codes[k]
    graph[1::2] = 3 - graph[1::2, ::-1]
    # RNA: reads over a junction (and some exonic ones); pairs whose mate
    # 1 crosses a junction and mate 2 lies 150 bp past the intron
    rna = np.empty((SMALL_RNA, RDLEN), np.uint8)
    m1 = np.empty((SMALL_RNA // 2, RDLEN), np.uint8)
    m2 = np.empty_like(m1)
    for i in range(SMALL_RNA):
        s, ilen = introns[i % len(introns)]
        j = int(rng.integers(15, RDLEN - 15))
        if i % 4 == 3:
            p = int(rng.integers(0, joined.size - RDLEN))
            rna[i] = joined[p:p + RDLEN]
        else:
            rna[i] = np.concatenate(
                [joined[s - j:s], joined[s + ilen:s + ilen + RDLEN - j]])
        if i < m1.shape[0]:
            m1[i] = np.concatenate(
                [joined[s - j:s], joined[s + ilen:s + ilen + RDLEN - j]])
            m2[i] = 3 - joined[s + ilen + 150:s + ilen + 150 + RDLEN][::-1]
    rna[2::3] = 3 - rna[2::3, ::-1]
    m1[1::2], m2[1::2] = m2[1::2], m1[1::2].copy()
    return dict(
        ref=ref, sh=build_sharded(ref, max_bases=SMALL_SHARD),
        gsh=build_sharded(ref, max_bases=SMALL_SHARD, snps=snps),
        sites=[(s - 1, s + ilen) for s, ilen in introns],
        se=make_batches(se, 0, SMALL_SE),
        pe=make_pair_batches(r1, r2, 0, SMALL_PE),
        graph=make_batches(graph, 0, SMALL_SE),
        rna=make_batches(rna, 0, SMALL_RNA),
        rna_pe=make_pair_batches(m1, m2, 0, SMALL_RNA // 2))


# phase 10's card == CPU configurations on small_sharded_case(): (what,
# index, reads, AlignerOpts, known sites, DP kernels each run launches)
SMALL_CONFIGS = (
    ("SE", "sh", "se", {}, False, ("dp_score",)),
    ("PE", "sh", "pe", {}, False, ("dp_score", "dp_score_wide")),
    ("graph SE", "gsh", "graph", {}, False, ("dp_score_ov",)),
    ("RNA SE, known sites", "sh", "rna", {"spliced": True}, True,
     ("dp_score",)),
    ("RNA PE, known sites", "sh", "rna_pe", {"spliced": True}, True,
     ("dp_score",)),
    ("RNA SE, tmo, known sites", "sh", "rna",
     {"spliced": True, "tmo": True}, True, ("dp_score",)),
)


def run_sharded(sa, items, ref):
    """SAM text and stats of `items` (SE batches or (mate 1, mate 2)
    batch tuples) through a ShardedAligner."""
    from hisat2_tpu_torch.io import sam as samio
    buf = io.StringIO()
    writer = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                             no_head=True)
    if isinstance(items[0], tuple):
        stats = sa.align_and_emit_pe(items, writer)
    else:
        stats = sa.align_and_emit(items, writer)
    return buf.getvalue(), stats


def sharded_aligner(case, index, opts, known, device):
    from hisat2_tpu_torch.align.pipeline import AlignerOpts
    from hisat2_tpu_torch.align.sharded import ShardedAligner
    sa = ShardedAligner(case[index], opts=AlignerOpts(**opts),
                        device=device)
    if known:
        for left, right in case["sites"]:
            sa.host.ssdb.add_known(left, right, "+")
    return sa


class HostRescue:
    """Counts the DP launches of the ladder's mate rescue on a
    finalization-only aligner (the sharded finish) and keeps the first
    such call's DP inputs: paired._rescue_mates and paired.dp_score are
    wrapped while the context is open."""

    def __init__(self):
        self.launches = 0
        self.captured = None

    def __enter__(self):
        from hisat2_tpu_torch.align import paired as tpaired
        from hisat2_tpu_torch.ops import dp_cuda
        self._mod = tpaired
        self._real = tpaired._rescue_mates, tpaired.dp_score
        real_rescue, real_dp = self._real
        inside = []

        def rescue(aligner, *a, **kw):
            if aligner.idx:
                return real_rescue(aligner, *a, **kw)
            n0 = dp_cuda.launches["dp_score_wide"]
            inside.append(True)
            try:
                return real_rescue(aligner, *a, **kw)
            finally:
                inside.pop()
                self.launches += dp_cuda.launches["dp_score_wide"] - n0

        def dp(*a, **kw):
            if inside and self.captured is None and a[0].is_cuda:
                self.captured = [x.clone() for x in a]
            return real_dp(*a, **kw)
        tpaired._rescue_mates, tpaired.dp_score = rescue, dp
        return self

    def __exit__(self, *exc):
        self._mod._rescue_mates, self._mod.dp_score = self._real
        return False


def sharded_card_equals_cpu(case, tag, budget_gb=None):
    """Every SMALL_CONFIGS run through ShardedAligner on the CPU path and
    on the card: SAM bytes and stats equal, the DP kernels launched, and
    for PE the one-block kernel launched by the host-mode ladder rescue.
    With `budget_gb`, the card's aligner holds HISAT2_TPU_HBM_GB at it and
    must evict."""
    for what, index, reads, opts, known, need in SMALL_CONFIGS:
        items = case[reads]
        cpu = run_sharded(sharded_aligner(case, index, opts, known, "cpu"),
                          items, case["ref"])
        old = os.environ.get("HISAT2_TPU_HBM_GB")
        if budget_gb is not None:
            os.environ["HISAT2_TPU_HBM_GB"] = repr(budget_gb)
        try:
            sa = sharded_aligner(case, index, opts, known, "cuda")
        finally:
            if old is None:
                os.environ.pop("HISAT2_TPU_HBM_GB", None)
            else:
                os.environ["HISAT2_TPU_HBM_GB"] = old
        with HostRescue() as hr:
            (text, stats), got = counted(
                lambda: run_sharded(sa, items, case["ref"]),
                f"the small sharded genome ({what})", need)
        check(text == cpu[0], f"sharded SAM from the card != CPU path on "
                              f"{what}{tag}")
        check(stats == cpu[1], f"sharded stats on the card != CPU path on "
                               f"{what}{tag}")
        if reads == "pe":
            check(hr.launches > 0, f"the host-mode ladder rescue launched "
                                   f"no one-block DP on {what}{tag}")
        if budget_gb is not None:
            check(sa.evictions > 0, f"no eviction under a one-shard budget "
                                    f"on {what}")
        print(f"[sharded] SAM bytes on the card == CPU path on the small "
              f"sharded genome, {what}{tag} ({len(text)} bytes; launches "
              f"{got}, host-mode ladder rescue {hr.launches}; uploads "
              f"{sa.uploads}, evictions {sa.evictions})", flush=True)
        del sa


def big_sharded_genome():
    """SHARD_CHROMS chromosomes of SHARD_CHROM_LEN random bases (chicken
    GRCg7b's size in all), with SHARD_COPIES segments of 2 kb copied from
    one shard's chromosomes to another's. Returns the JoinedReference
    (built directly: no N, one fragment a chromosome)."""
    from hisat2_tpu_torch.io.reference import JoinedReference
    rng = np.random.default_rng(60)
    C, n = SHARD_CHROMS, SHARD_CHROMS * SHARD_CHROM_LEN
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    per = SHARD_BASES // SHARD_CHROM_LEN            # chromosomes a shard
    shard_of = np.arange(C) // per
    for k in range(SHARD_COPIES):
        a, b = rng.choice(C, 2, replace=False)
        while shard_of[a] == shard_of[b]:
            a, b = rng.choice(C, 2, replace=False)
        src = a * SHARD_CHROM_LEN + int(rng.integers(0, SHARD_CHROM_LEN
                                                     - 2000))
        dst = b * SHARD_CHROM_LEN + int(rng.integers(0, SHARD_CHROM_LEN
                                                     - 2000))
        codes[dst:dst + 2000] = codes[src:src + 2000]
    starts = np.arange(C, dtype=np.int64) * SHARD_CHROM_LEN
    return JoinedReference(
        names=[f"chr{c + 1}" for c in range(C)],
        tlens=np.full(C, SHARD_CHROM_LEN, np.int64), joined=codes,
        frag_joined=starts, frag_toff=np.zeros(C, np.int64),
        frag_tidx=np.arange(C, dtype=np.int32),
        frag_len=np.full(C, SHARD_CHROM_LEN, np.int64))


def sharded_phase(rps, pps, card):
    """Phase 10 (see the module docstring). Returns the DP kernels'
    inputs as the per-shard SE step and the host-mode ladder rescue built
    them, their launches, and the figures of the report."""
    import torch
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.align.sharded import DEVICE_HEADROOM, ShardedAligner
    from hisat2_tpu_torch.index.fm_index import FMIndex
    from hisat2_tpu_torch.index.sharded import build_sharded

    t0 = time.perf_counter()
    case = small_sharded_case()
    print(f"[sharded] small genome: {case['ref'].n} bp in "
          f"{len(case['sh'])} shards (graph: {len(case['gsh'])}), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sharded_card_equals_cpu(case, "")
    one = max(case["sh"].shards[i].bundle_nbytes()
              for i in range(len(case["sh"])))
    sharded_card_equals_cpu(case, ", budget one shard",
                            budget_gb=1.5 * one / (1 << 30))

    # -- a genome of real size ------------------------------------------
    t0 = time.perf_counter()
    ref = big_sharded_genome()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = build_sharded(ref, max_bases=SHARD_BASES)
    t_build = time.perf_counter() - t0
    S = len(sh)
    est = [sh.shards[i].bundle_nbytes() for i in range(S)]
    check(S == 3 and all(s.table_only and s.st_k == 13 for s in sh.shards),
          f"{S} shards, kt {[s.st_k for s in sh.shards]}")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"[sharded] {ref.n} bp in {SHARD_CHROMS} chromosomes, "
          f"{SHARD_COPIES} cross-shard copies of 2 kb, generated in "
          f"{t_gen:.1f} s; {S} table-only shards of "
          f"{[int(s.ref.n) for s in sh.shards]} bp (kt=13) built in "
          f"{t_build:.1f} s; estimated bundle bytes {est}; peak host RSS "
          f"so far {rss:.1f} GiB", flush=True)

    n = BATCH * NBATCH
    seqs, starts, indel = simulate_reads(ref.joined, n + BATCH, seed=61)
    batches = make_batches(seqs[:n], 0, BATCH)
    warm = make_batches(seqs[n:], n, BATCH)
    pe_n = PE_BATCH * PE_NBATCH
    r1, r2, m1_true, pe_indel = simulate_pairs(ref.joined, pe_n, seed=62)
    pe_batches = make_pair_batches(r1, r2, 0, PE_BATCH)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    sa = ShardedAligner(sh, device="cuda")
    budget = sa.budget
    run_sharded(sa, warm, ref)           # uploads every shard
    check(sa.uploads == S and sa.evictions == 0,
          f"default budget {budget} bytes: {sa.uploads} uploads, "
          f"{sa.evictions} evictions")
    real = [FMIndex.bundle_bytes(sa._resident[i].idx) for i in range(S)]
    check(real == est, f"estimated bundle bytes {est} != real {real}")
    upload_s = sa.upload_s / sa.uploads
    print(f"[sharded] default budget {budget / (1 << 30):.2f} GiB (free "
          f"device memory less {DEVICE_HEADROOM / (1 << 30):.0f} GiB): all "
          f"{S} shards resident, {sa.uploads} uploads of "
          f"{upload_s:.3f} s each (host preparation + copy; "
          f"{sum(real) / sa.upload_s / 1e9:.2f} GB/s); bundle bytes "
          f"{real}, device memory held {(torch.cuda.memory_allocated() - mem0) / (1 << 30):.2f} GiB "
          f"[{card}]", flush=True)

    captured = []
    real_dp = tpipe.dp_score

    def recording_dp(*a, **kw):
        if not captured and a[0].is_cuda:
            captured.append([x.clone() for x in a])
        return real_dp(*a, **kw)
    tpipe.dp_score = recording_dp
    try:
        t0 = time.perf_counter()
        (text_a, st_a), got_a = counted(
            lambda: run_sharded(sa, batches[:2], ref), "the sharded SE run")
        (text_b, st_b), got_b = counted(
            lambda: run_sharded(sa, batches[2:], ref), "the sharded SE run")
        dt = time.perf_counter() - t0
    finally:
        tpipe.dp_score = real_dp
    check(sa.uploads == S, "the resident SE run uploaded a shard again")
    se_launches = {k: got_a[k] + got_b[k] for k in got_a}
    text = text_a + text_b
    stats = {k: st_a[k] + st_b[k] for k in st_a}
    rate, true_rate, indel_rate = check_sam(text, n, starts[:n], indel[:n],
                                            ref=ref)
    srps = n / dt
    print(f"[sharded] SE: {n} reads in {dt:.3f} s = {srps:.1f} reads/s end "
          f"to end ({srps / rps:.3f} of phase 4's {rps:.1f}); aligned "
          f"{rate:.4f}, indel-free at true position {true_rate:.4f}, indel "
          f"reads aligned {indel_rate:.4f}; stats {stats}; launches "
          f"{se_launches} [{card}]", flush=True)

    with HostRescue() as hr:
        t0 = time.perf_counter()
        (pe_a, pst_a), pgot_a = counted(
            lambda: run_sharded(sa, pe_batches[:1], ref),
            "the sharded PE run", ("dp_score", "dp_score_wide"))
        (pe_b, pst_b), pgot_b = counted(
            lambda: run_sharded(sa, pe_batches[1:], ref),
            "the sharded PE run", ("dp_score", "dp_score_wide"))
        pe_dt = time.perf_counter() - t0
    check(sa.uploads == S, "the resident PE run uploaded a shard again")
    check(hr.launches > 0, "the host-mode ladder rescue launched no "
                           "one-block DP on the sharded genome")
    pe_text = pe_a + pe_b
    pe_stats = {k: pst_a[k] + pst_b[k] for k in pst_a}
    pe_launches = {k: pgot_a[k] + pgot_b[k] for k in pgot_a}
    share, m1_rate, mate_rate = check_pe_sam(pe_text, pe_n, m1_true,
                                             pe_indel, ref=ref)
    spps = pe_n / pe_dt
    peak = torch.cuda.max_memory_allocated() / (1 << 20)
    print(f"[sharded] PE: {pe_n} pairs in {pe_dt:.3f} s = {spps:.1f} "
          f"pairs/s end to end ({spps / pps:.3f} of phase 5's {pps:.1f}); "
          f"proper pairs {share:.4f}, mate 1 of indel-free pairs at true "
          f"position {m1_rate:.4f}, mates aligned {mate_rate:.4f}; stats "
          f"{pe_stats}; launches {pe_launches}, of them the host-mode "
          f"ladder rescue's one-block DP {hr.launches}; peak device memory "
          f"{peak:.1f} MiB [{card}]", flush=True)

    m = measure_batch(sa, lambda s, b: b,
                      lambda s, b, w: s.align_and_emit([b], w),
                      (batches[0],))
    print(f"[sharded] one SE batch of {BATCH} reads alone over {S} "
          f"resident shards: {m['launches']} launches, device busy "
          f"{m['busy_ms']:.2f} ms ({m['busy_ms'] / m['wall_ms']:.4f} of "
          f"{m['wall_ms']:.1f} ms wall) [{card}]", flush=True)

    # -- a budget below two shards: every pass uploads each shard again --
    held = torch.cuda.memory_allocated()
    del sa
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_allocated()
    gb = 1.5 * max(est) / (1 << 30)
    os.environ["HISAT2_TPU_HBM_GB"] = repr(gb)
    try:
        sa = ShardedAligner(sh, device="cuda")
    finally:
        os.environ.pop("HISAT2_TPU_HBM_GB")
    ftext, _ = run_sharded(sa, batches[:2], ref)
    fpe, _ = run_sharded(sa, pe_batches[:1], ref)
    check(ftext == text_a, "SE SAM under the forced budget != resident")
    check(fpe == pe_a, "PE SAM under the forced budget != resident")
    check(sa.evictions > 0 and sa.uploads == 2 * S,
          f"forced budget: {sa.uploads} uploads, {sa.evictions} evictions")
    f_upload_s = sa.upload_s / sa.uploads
    print(f"[sharded] budget forced to {gb:.3f} GiB (below two shards): 2 "
          f"SE batches and 1 PE batch, SAM bytes == the resident run's; "
          f"{sa.uploads} uploads of {f_upload_s:.3f} s each, "
          f"{sa.evictions} evictions; deleting the resident aligner freed "
          f"{freed / (1 << 30):.2f} GiB [{card}]", flush=True)
    del sa
    torch.cuda.empty_cache()
    check(bool(captured), "the sharded SE run launched no DP")
    check(hr.captured is not None, "no host-mode rescue DP captured")
    return dict(captured=captured[0], launches=se_launches["dp_score"],
                captured_host=hr.captured, host_launches=hr.launches,
                rps=srps, pps=spps, upload_s=upload_s,
                f_upload_s=f_upload_s, batch=m, est=est, real=real,
                peak_mb=peak, build_s=t_build, rss_gb=rss)


def plant_repeats(codes: np.ndarray, seed: int):
    """Repeat families written into a copy of `codes`: REP_SHORT families
    of 300 bp x 50 copies and REP_LONG of 1-6 kb x 8 copies, a third of
    the copies reverse-complemented, a quarter of them with one SNV
    outside the unit's middle third. Long copies take 6.5 kb slots in the
    first 2 Mbp, short ones 400 bp slots after 2.1 Mbp. Returns (codes,
    [(start, length) of every copy without an SNV])."""
    from hisat2_tpu_torch.utils import alphabet
    rng = np.random.default_rng(seed)
    codes = codes.copy()
    exact = []
    jobs = [(300, 50)] * REP_SHORT + [(int(rng.integers(1000, 6001)), 8)
                                      for _ in range(REP_LONG)]
    long_slots = list(rng.permutation(2_000_000 // 6500) * 6500 + 100)
    short_slots = list(rng.permutation((codes.size - 2_100_000) // 400)
                       * 400 + 2_100_000)
    for length, copies in jobs:
        unit = rng.integers(0, 4, length).astype(np.uint8)
        slots = long_slots if length > 300 else short_slots
        for k in range(copies):
            p = int(slots.pop())
            cp = (unit if k % 3 else alphabet.revcomp(unit)).copy()
            if k % 4 == 3:
                q = int(rng.integers(0, length // 3))
                q = q if rng.random() < 0.5 else length - 1 - q
                cp[q] = (cp[q] + 1) % 4
            else:
                exact.append((p, length))
            codes[p:p + length] = cp
    return codes, exact


def repeat_phase(codes4, card):
    """Phase 11 (see the module docstring). Returns the DP kernel's
    inputs as RepeatAligner.align_batch built them, its launches, and the
    figures of the report."""
    import torch
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.align.pipeline import RepeatAligner
    from hisat2_tpu_torch.index.fm_index import build_fm_index
    from hisat2_tpu_torch.index.repeats import (build_kmer_table,
                                                build_repeats,
                                                classify_repetitive)
    from hisat2_tpu_torch.io.reads import Read, batchify
    from hisat2_tpu_torch.io.reference import reference_from_seqs
    from hisat2_tpu_torch.utils import alphabet
    codes, exact = plant_repeats(codes4, seed=70)
    ref = reference_from_seqs({"rep_synthetic": alphabet.decode(codes)})
    t0 = time.perf_counter()
    db = build_repeats(ref, repeat_length=100, repeat_count=5)
    t_db = time.perf_counter() - t0
    rep_fm = build_fm_index(reference_from_seqs(
        {r.name: alphabet.decode(r.seq) for r in db.repeats}))
    table = build_kmer_table(db)
    t_build = time.perf_counter() - t0
    print(f"[repeats] {REP_SHORT} families of 300 bp x 50 and {REP_LONG} "
          f"of 1-6 kb x 8 planted in phase 4's genome: build_repeats "
          f"{t_db:.1f} s -> {len(db.repeats)} repeats of "
          f"{sum(len(r) for r in db.repeats)} bp, repeat index and "
          f"minimizer table ({table.size}) in {t_build:.1f} s total",
          flush=True)

    seqs, _, _ = simulate_reads(ref.joined, BATCH, seed=71)
    lens = np.full(BATCH, RDLEN, np.int64)
    t0 = time.perf_counter()
    rep_mask = classify_repetitive(seqs, lens, table)
    t_cls = time.perf_counter() - t0
    rows = np.flatnonzero(rep_mask)
    check(rows.size >= 1000, f"only {rows.size} reads classified repetitive")
    q = np.full(RDLEN, 40, np.int8)

    def batch_of(rs, sq):
        return batchify([Read(f"r{i}", sq[i], q, i) for i in rs])
    ra = RepeatAligner(rep_fm, db, device="cuda")
    captured = []
    real_dp = tpipe.dp_score

    def recording_dp(*a, **kw):
        if not captured and a[0].is_cuda:
            captured.append([x.clone() for x in a])
        return real_dp(*a, **kw)
    tpipe.dp_score = recording_dp
    try:
        t0 = time.perf_counter()
        out, got = counted(lambda: ra.align_repeats(batch_of(rows, seqs)),
                           "RepeatAligner.align_repeats")
        dt = time.perf_counter() - t0
    finally:
        tpipe.dp_score = real_dp
    placed = sum(o is not None for o in out)
    print(f"[repeats] classify_repetitive: {rows.size} of {BATCH} reads "
          f"repetitive in {t_cls:.3f} s; align_repeats on them "
          f"{rows.size / dt:.1f} reads/s ({dt:.3f} s), {placed} placed, "
          f"{sum(len(o[4]) for o in out if o)} genomic placements; "
          f"launches {got} [{card}]", flush=True)

    small = batch_of(rows[:2048], seqs)
    cpu = RepeatAligner(rep_fm, db, device="cpu").align_repeats(small)
    check(ra.align_repeats(small) == cpu,
          "align_repeats on the card != CPU path")
    # error-free reads cut from copies without an SNV: the true start must
    # be among the expanded placements
    rng = np.random.default_rng(72)
    ex = [exact[int(k)] for k in rng.integers(0, len(exact), 2048)]
    st = np.asarray([p + int(rng.integers(0, ln - RDLEN + 1))
                     for p, ln in ex])
    gseqs = ref.joined[st[:, None] + np.arange(RDLEN)].copy()
    gseqs[1::2] = 3 - gseqs[1::2, ::-1]
    gout = ra.align_repeats(batch_of(range(2048), gseqs))
    hit = np.asarray([o is not None and any(p[2] == s for p in o[4])
                      for o, s in zip(gout, st)])
    print(f"[repeats] align_repeats on the card == CPU path on 2048 "
          f"repetitive reads; {hit.mean():.4f} of 2048 error-free reads "
          f"from exact copies hold their true position among the "
          f"placements", flush=True)
    check(hit.mean() >= 0.95, f"true position among the placements for "
                              f"only {hit.mean():.4f}")
    check(bool(captured), "align_repeats launched no DP")
    return dict(captured=captured[0], launches=got["dp_score"],
                rps=rows.size / dt, build_s=t_build, hit=float(hit.mean()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one batch with torch.profiler")
    ap.add_argument("--sass", metavar="DIR",
                    help="also write the kernels' SASS to DIR/dp_score.sass")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hisat2_tpu_torch.align import pipeline as tpipe
    from hisat2_tpu_torch.align.pipeline import Aligner
    from hisat2_tpu_torch.align.scoring import Scoring
    from hisat2_tpu_torch.index.fm_index import build_fm_index
    from hisat2_tpu_torch.io.reference import reference_from_seqs
    from hisat2_tpu_torch.ops import dp_cuda
    from hisat2_tpu_torch.ops.sw import dp_fill_plain, dp_inputs
    from hisat2_tpu_torch.utils import alphabet
    from hisat2_tpu_torch.utils.metrics import Metrics

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}", flush=True)
    t_start = time.perf_counter()

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, report = dp_cuda.build()
    form = ("fused add-max / three-way-max intrinsics"
            if dp_cuda.fused_form() else
            "plain add-then-max form (toolkit without the intrinsics)")
    print(f"[build] dp_score.cu in {time.perf_counter() - t0:.1f} s; cell "
          f"update compiled on the {form}", flush=True)
    sass_text = read_sass(lib_path)
    sass = sass_by_kernel(sass_text) if sass_text else {}
    if sass_text is None:
        print("[build] no cuobjdump in the toolkit: SASS not read",
              flush=True)
    elif args.sass:
        os.makedirs(args.sass, exist_ok=True)
        with open(os.path.join(args.sass, "dp_score.sass"), "w") as f:
            f.write(sass_text)
    for variant, regs in ptxas_by_kernel(report):
        line = f"[build]   {variant}: {regs}"
        if variant in sass:
            am, m3, loop = sass[variant]
            line += (f" | SASS: {am} VIADDMNMX, {m3} VIMNMX3 (fused "
                     f"instructions {'' if am or m3 else 'NOT '}emitted), "
                     f"row loop spans {loop} instructions, every branch "
                     f"counted")
        check("spill" not in regs or
              ("0 bytes spill stores, 0 bytes spill loads" in regs),
              f"{variant} spills registers: {regs}")
        print(line, flush=True)

    elapsed = {}

    def phase_done(name):
        elapsed[name] = time.perf_counter() - t_start
        print(f"[time] {name} done at {elapsed[name]:.1f} s", flush=True)
    phase_done("card and build")

    # -- kernels against their plain versions --------------------------
    sc = Scoring()
    consts = sc.dp_consts()
    sctab = sc.device_tables(dev)
    max_err: dict[str, int] = {}

    def check_dp(rd, pen, lens, ref, scp_cum, what, ov=None, quiet=False):
        name = variant_key(ref.shape[1], ov is not None)
        got = dp_cuda.dp_score(rd, pen, lens, ref, scp_cum, ov=ov, **consts)
        want = dp_fill_plain(rd, pen, lens, ref, scp_cum, ov=ov, **consts)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        max_err[name] = max(max_err.get(name, 0), err)
        check(torch.equal(got, want), f"{name} != plain ({what})")
        if not quiet:
            print(f"[kernels] {name} == plain on {what}: C={rd.shape[0]} "
                  f"L={rd.shape[1]} W={ref.shape[1]}", flush=True)

    # every kernel, without and with an SNV overlay of every kind of
    # nibble: the test shapes, the SE and rescue shapes, the tiled form at
    # W + 1 = 2049, 2605 and 8192 (one to four tiles), and every edge window
    edges = [(100 + W, *edge_case_shape(W), W)
             for W in edge_windows("dp_score") + edge_windows("dp_score_wide")
             + edge_windows("dp_score_tiled")]
    n_edges = 0
    for seed, C, L, W in [(0, 24, 60, 92), (1, 24, 60, 92),
                          (2, 8192, 104, 136), (3, 37, 104, 256),
                          (4, 512, 104, 1104), (5, 19, 104, 2047),
                          (6, 64, 104, 2048), (7, 64, 104, 2604),
                          (8, 64, 104, 8191), (9, 64, 256, 288),
                          (10, 64, 104, 1104)] + edges:
        rd, quals, lens, ref = make_dp_case(seed, C, L, W)
        t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
        pen, scp_cum = (x.contiguous() for x in dp_inputs(sctab, t[1], t[2]))
        ov = torch.from_numpy(make_dp_ov(seed, rd, ref)).to(dev)
        quiet = seed >= 100
        check_dp(t[0], pen, t[2], t[3], scp_cum, f"random case {seed}",
                 quiet=quiet)
        check_dp(t[0], pen, t[2], t[3], scp_cum, f"random case {seed} with "
                 f"an overlay of every kind of nibble", ov, quiet=quiet)
        n_edges += quiet
    print(f"[kernels] and at {n_edges} edge windows (W + 1 one short of, at "
          f"and one past each variant's capacity and each tile count up to "
          f"four): every kernel == plain, without and with an overlay; max "
          f"abs err {max_err}", flush=True)

    phase_done("kernels")

    # -- main path -------------------------------------------------------
    t0 = time.perf_counter()
    grng = np.random.default_rng(20240501)
    codes = grng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    txs = simulate_gene_model(codes, seed=40)     # phase 8's gene model
    genome = alphabet.decode(codes)
    fm = build_fm_index(reference_from_seqs({"NC_000913.3_synthetic":
                                             genome}))
    t_index = time.perf_counter() - t0
    print(f"[main] index of {fm.n} bp built in {t_index:.1f} s, kt="
          f"{fm.st_k}", flush=True)
    check(fm.st_k == 13 and fm.n == GENOME_LEN, "index geometry")
    al = Aligner(fm, device="cuda")
    check("st_pairs" not in al.idx,   # kt = 13: the two-gather seed branch
          "a kt = 13 bundle must not carry st_pairs")

    n = BATCH * NBATCH
    seqs, starts, indel = simulate_reads(fm.ref.joined, n + BATCH, seed=7)
    batches = make_batches(seqs[:n], 0, BATCH)
    warm = make_batches(seqs[n:], n, BATCH)

    # first-call set-up on a batch of its own; it also records the DP
    # kernel's inputs as the main path builds them, for the report
    captured = []
    real_dp = tpipe.dp_score

    def recording_dp(*a, **kw):
        if not captured:
            captured.append([x.clone() for x in a])
        return real_dp(*a, **kw)
    tpipe.dp_score = recording_dp
    try:
        run_stream(al, warm, fm.ref)
    finally:
        tpipe.dp_score = real_dp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in dp_cuda.launches:
        dp_cuda.launches[k] = 0
    al.metrics = Metrics()
    t0 = time.perf_counter()
    text, stats = run_stream(al, batches, fm.ref)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dp_cuda.launches)
    peak_mb = torch.cuda.max_memory_allocated() / (1 << 20)
    rps = n / dt
    check(launches["dp_score"] > 0,
          "kernel dp_score was not launched on the SE main path")
    rate, true_rate, indel_rate = check_sam(text, n, starts[:n], indel[:n])
    print(f"[main] {n} reads in {dt:.3f} s = {rps:.1f} reads/s end to end; "
          f"aligned {rate:.4f}, indel-free at true position {true_rate:.4f}, "
          f"indel reads aligned {indel_rate:.4f}; stats {stats}; "
          f"dp_score launches {launches['dp_score']}; peak device memory "
          f"{peak_mb:.1f} MiB [{card}]", flush=True)
    m = al.metrics
    print(f"[main] host time summed over batches: queue the device step "
          f"{m.t_pack:.3f} s, wait for results {m.t_fetch:.3f} s, finish "
          f"in 3 worker threads {m.t_host:.3f} s", flush=True)

    # the card against the CPU path (plain versions) on 2,048 reads
    small = make_batches(seqs[:2048], 0, 2048)
    cpu_al = Aligner(fm, device="cpu")
    text_cpu, _ = run_stream(cpu_al, small, fm.ref)
    text_gpu, _ = run_stream(al, small, fm.ref)
    check(text_gpu == text_cpu, "SAM from the card != SAM from the CPU path")
    print(f"[main] SAM bytes on the card == CPU path on 2048 reads "
          f"({len(text_gpu)} bytes)", flush=True)

    phase_done("SE path")

    # -- PE main path ----------------------------------------------------
    from hisat2_tpu_torch.align import emit as temit
    from hisat2_tpu_torch.align import paired as tpaired
    pe_n = PE_BATCH * PE_NBATCH
    r1, r2, m1_true, pe_indel = simulate_pairs(fm.ref.joined,
                                               pe_n + PE_BATCH, seed=11)
    pe_batches = make_pair_batches(r1[:pe_n], r2[:pe_n], 0, PE_BATCH)
    pe_warm = make_pair_batches(r1[pe_n:], r2[pe_n:], pe_n, PE_BATCH)
    # first-call set-up on a batch pair of its own; it records the wide
    # kernel's inputs as the mate rescue builds them, for the report
    captured_wide = []
    real_pe_dp = tpaired.dp_score

    def recording_pe_dp(*a, **kw):
        if not captured_wide and kernel_of(a[3].shape[1]) == "dp_score_wide":
            captured_wide.append([x.clone() for x in a])
        return real_pe_dp(*a, **kw)
    tpaired.dp_score = recording_pe_dp
    try:
        run_pe_stream(al, pe_warm, fm.ref)
    finally:
        tpaired.dp_score = real_pe_dp
    check(bool(captured_wide), "the PE warm-up launched no wide DP")
    # the rescue rows of the timed run (host tensors, kept by reference)
    rescue_rows = []
    real_stage = tpaired.stage_pe_packed

    def keeping_stage(*a, **kw):
        out = real_stage(*a, **kw)
        if out is not None:
            rescue_rows.append(out[4]["rescue"])
        return out
    tpaired.stage_pe_packed = keeping_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in dp_cuda.launches:
        dp_cuda.launches[k] = 0
    al.metrics = Metrics()
    try:
        t0 = time.perf_counter()
        pe_text, pe_stats = run_pe_stream(al, pe_batches, fm.ref)
        torch.cuda.synchronize()
        pe_dt = time.perf_counter() - t0
    finally:
        tpaired.stage_pe_packed = real_stage
    pe_launches = dict(dp_cuda.launches)
    pe_peak_mb = torch.cuda.max_memory_allocated() / (1 << 20)
    pps = pe_n / pe_dt
    check(pe_launches["dp_score"] > 0,
          "kernel dp_score was not launched on the PE main path")
    check(pe_launches["dp_score_wide"] >= PE_NBATCH,
          f"wide DP launched {pe_launches['dp_score_wide']} times for "
          f"{PE_NBATCH} batches")
    resc = np.concatenate([r.numpy() for r in rescue_rows])
    min_sc = sc.min_score(RDLEN)
    n_resc = int(((resc[:, 0] >= 0) & (resc[:, 2] >= min_sc)).sum())
    check(n_resc >= 1, "no rescue lane reached its minimum score")
    share, m1_rate, mate_rate = check_pe_sam(pe_text, pe_n, m1_true[:pe_n],
                                             pe_indel[:pe_n])
    print(f"[pe] {pe_n} pairs ({2 * pe_n} reads) in {pe_dt:.3f} s = "
          f"{pps:.1f} pairs/s, {2 * pps:.1f} reads/s end to end; proper "
          f"pairs {share:.4f}, mate 1 of indel-free pairs at true position "
          f"{m1_rate:.4f}, mates aligned {mate_rate:.4f}; rescue lanes at "
          f"or above the minimum {n_resc} of {int((resc[:, 0] >= 0).sum())};"
          f" stats {pe_stats}; launches {pe_launches}; peak device memory "
          f"{pe_peak_mb:.1f} MiB [{card}]", flush=True)
    m = al.metrics
    print(f"[pe] host time summed over batches: queue the device step "
          f"{m.t_pack:.3f} s, wait for results {m.t_fetch:.3f} s, finish "
          f"in 3 worker threads {m.t_host:.3f} s", flush=True)

    # the card against the CPU path on both PE steps
    qrng = np.random.default_rng(12)
    perbase = qrng.integers(2, 42, (512, 2, RDLEN)).astype(np.int8)
    for what, pb in (
            ("2048 constant-quality pairs (packed step)",
             make_pair_batches(r1[:2048], r2[:2048], 0, 2048)),
            ("512 per-base-quality pairs (fused step)",
             make_pair_batches(r1[:512], r2[:512], 0, 512, perbase))):
        text_cpu, _ = run_pe_stream(cpu_al, pb, fm.ref)
        text_gpu, _ = run_pe_stream(al, pb, fm.ref)
        check(text_gpu == text_cpu,
              f"PE SAM from the card != CPU path on {what}")
        print(f"[pe] SAM bytes on the card == CPU path on {what} "
              f"({len(text_gpu)} bytes)", flush=True)

    # -X 2500 (the rescue window stays min(maxins, 1000) + L = 1104)
    sam_card_equals_cpu(run_pe_stream, fm,
                        make_pair_batches(r1[:512], r2[:512], 0, 512),
                        fm.ref, "512 pairs at -X 2500", "pe",
                        need=("dp_score", "dp_score_wide"),
                        opts=dict(maxins=2500))

    # -- long reads: reads of 2,100 bp give _stage_dp a window of W =
    # 2104 + 2 * 16 = 2136 (W + 1 > 2048): the column-tiled kernel
    captured_tiled = []

    def recording_tiled(*a, **kw):
        if (not captured_tiled and a[0].is_cuda
                and kernel_of(a[3].shape[1]) == "dp_score_tiled"):
            captured_tiled.append([x.clone() for x in a])
        return real_dp(*a, **kw)
    long_seqs, long_starts, long_indel = simulate_reads(
        fm.ref.joined, LONG_N, seed=13, rdlen=LONG_RDLEN)
    tpipe.dp_score = recording_tiled
    try:
        _, long_text = sam_card_equals_cpu(
            run_stream, fm, make_batches(long_seqs, 0, LONG_N, LONG_PAD),
            fm.ref, f"{LONG_N} reads of {LONG_RDLEN} bp (DP window W = "
            f"{LONG_PAD + 32})", "long", need=("dp_score_tiled",))
        tiled_launches = dict(dp_cuda.launches)
    finally:
        tpipe.dp_score = real_dp
    check(bool(captured_tiled), "the long reads launched no tiled DP")
    lrate = sum(not int(ln.split("\t")[1]) & 4
                for ln in long_text.splitlines()) / LONG_N
    check(lrate >= 0.9, f"only {lrate:.4f} of the long reads aligned")
    print(f"[long] {lrate:.4f} of {LONG_N} reads of {LONG_RDLEN} bp aligned; "
          f"launches {tiled_launches}", flush=True)

    phase_done("PE path and long reads")

    # -- FM path -----------------------------------------------------------
    m = measure_batch(al, temit.submit_se, temit.finish_se, (batches[0],))
    print(f"[fm] the table index for comparison: one batch of {BATCH} reads "
          f"alone: queue the device step {m['queue_ms']:.1f} ms, "
          f"{m['launches']} launches, device busy {m['busy_ms']:.2f} ms "
          f"({m['busy_ms'] / m['wall_ms']:.4f} of {m['wall_ms']:.1f} ms wall) "
          f"[{card}]", flush=True)
    fmres = fm_phase(fm, seqs, starts, indel, r1, r2, m1_true, pe_indel,
                     card)

    phase_done("FM path")

    # -- graph path ----------------------------------------------------------
    gres = graph_phase(fm, al, rps, card, args.profile)
    phase_done("graph path")

    # -- RNA path --------------------------------------------------------------
    rres = rna_phase(fm, fmres["var"]["A"], txs, rps, card, args.profile)
    phase_done("RNA path")

    # -- RNA PE path -----------------------------------------------------------
    pres = rna_pe_phase(fm, fmres["var"]["A"], txs, rres, pps, card,
                        args.profile)
    phase_done("RNA PE path")

    # -- sharded genome ------------------------------------------------------
    shres = sharded_phase(rps, pps, card)
    phase_done("sharded genome")

    # -- repeats ---------------------------------------------------------------
    repres = repeat_phase(codes, card)
    phase_done("repeats")

    if args.profile:
        profile_batch(al, temit.submit_se, temit.finish_se, (batches[0],),
                      "SE batch of 16384 reads")
        profile_batch(al, temit.submit_pe, temit.finish_pe, pe_batches[0],
                      "PE batch of 16384 pairs")
        profile_batch(Aligner(fmres["var"]["A"], device="cuda"),
                      temit.submit_se, temit.finish_se, (batches[0],),
                      "SE batch of 16384 reads on index A (FM seeding)")

    # -- report ----------------------------------------------------------
    def bound_ms(rd, rl, ref, ov=None):
        """(bound, bytes' time, operations' time, bytes, cells) of one
        launch: every input read once (the overlay too) and the scores
        written once, and DP_OPS_PER_CELL instructions for each cell of a
        real read row."""
        C, L = rd.shape
        W = ref.shape[1]
        cells = int(rl.clamp(0, L).sum()) * (W + 1)
        nbytes = 4 * (2 * rd.numel() + rl.numel() + ref.numel()
                      + C * (L + 1) + C + (0 if ov is None else ov.numel()))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = cells * DP_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), t_bytes, t_ops, nbytes, cells

    for W in (604, 1104, 2047):
        rd, quals, lens, ref = make_dp_case(40 + W, 512, PAD_TO, W)
        t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
        pen, scp_cum = (x.contiguous() for x in dp_inputs(sctab, t[1], t[2]))
        ms = time_cuda(lambda: dp_cuda.dp_score(t[0], pen, t[2], t[3],
                                                scp_cum, **consts),
                       iters=50, warmup=10)
        bound, _, _, _, cells = bound_ms(t[0], t[2], t[3])
        plan = dp_cuda.dispatch_plan(W)
        print(f"[sweep] {plan.kernel} at C=512 L={PAD_TO} W={W} "
              f"({plan.warps} warps x {plan.cpl} columns a lane, {cells} "
              f"cells): {ms:.4f} ms, bound {bound:.4f} ms, "
              f"{bound / ms:.3f} of the bound reached [{card}]", flush=True)

    kernels = []
    for name, cap, cnt, path in (
            ("dp_score", captured[0], launches["dp_score"]
             + pe_launches["dp_score"], "SE main path (and the PE path's "
             "SE cores, same shape)"),
            ("dp_score_wide", captured_wide[0], pe_launches["dp_score_wide"],
             "PE mate rescue"),
            ("dp_score", fmres["captured"], fmres["launches"],
             "per-read path (Aligner._device_align, index A)"),
            ("dp_score_ov", gres["captured"], gres["launches"],
             "graph path (SE, PE and FM-seeded graph streams)"),
            ("dp_score_tiled", captured_tiled[0],
             tiled_launches["dp_score_tiled"], "SE path, 2,100 bp reads"),
            ("dp_score_wide_ov", gres["captured_wide_ov"],
             gres["wide_ov_launches"], "graph SE path, 250 bp reads"),
            ("dp_score", rres["captured"], rres["launches"],
             "RNA SE path (streams with and without known sites)"),
            ("dp_score", pres["captured"], pres["launches"]["dp_score"],
             "RNA PE path (the 2B-row spliced step, streams with and "
             "without known sites)"),
            ("dp_score_wide", pres["captured_wide"],
             pres["launches"]["dp_score_wide"], "RNA PE ladder rescue"),
            ("dp_score", shres["captured"], shres["launches"],
             "sharded genome, the per-shard SE step (1.0 Gbp, 3 shards)"),
            ("dp_score_wide", shres["captured_host"], shres["host_launches"],
             "sharded genome, the host-mode ladder rescue (PE)"),
            ("dp_score", repres["captured"], repres["launches"],
             "RepeatAligner.align_batch on the repeat index")):
        rd, pen, rl, ref, scp_cum = cap[:5]
        ov = cap[5] if len(cap) > 5 else None
        check_dp(rd, pen, rl, ref, scp_cum, f"the {path} inputs", ov)
        C, L = rd.shape
        W = ref.shape[1]
        ms = time_cuda(lambda: dp_cuda.dp_score(rd, pen, rl, ref, scp_cum,
                                                ov=ov, **consts), iters=200,
                       warmup=20)
        plain_ms = time_cuda(lambda: dp_fill_plain(rd, pen, rl, ref, scp_cum,
                                                   ov=ov, **consts), iters=3,
                             warmup=1)
        rows = int(rl.clamp(0, L).sum())
        bound, t_bytes, t_ops, nbytes, cells = bound_ms(rd, rl, ref, ov)
        if ov is not None:
            # the same inputs through the instantiation without overlay
            base_ms = time_cuda(lambda: dp_cuda.dp_score(
                rd, pen, rl, ref, scp_cum, **consts), iters=200, warmup=20)
            print(f"[report] dp_score_ov: {float((ov != 0).float().mean()):.5f}"
                  f" of the window bases carry a nibble, "
                  f"{float((ov != 0).any(dim=1).float().mean()):.4f} of the "
                  f"candidates hold one; the same inputs without the overlay "
                  f"{base_ms:.4f} ms [{card}]", flush=True)
        kernels.append(dict(
            name=name, route="cuda",
            source="hisat2_tpu_torch/csrc/dp_score.cu",
            replaces="hisat2_tpu/ops/dp_pallas.py:113", shape=f"C={C} "
            f"L={L} W={W}", launches=cnt, max_abs_err=max_err.get(name, 0),
            ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None))
        print(f"[report] {name} ({path}) at C={C} L={L} W={W}, {rows} read "
              f"rows: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms ({nbytes} bytes, {cells} cells x "
              f"{DP_OPS_PER_CELL} instructions), {bound / ms:.3f} of the "
              f"bound reached, {cnt} launches [{card}]", flush=True)
    print(f"[report] SE end to end {rps:.1f} reads/s, peak device memory "
          f"{peak_mb:.1f} MiB [{card}]", flush=True)
    print(f"[report] PE end to end {pps:.1f} pairs/s = {2 * pps:.1f} "
          f"reads/s, peak device memory {pe_peak_mb:.1f} MiB [{card}]",
          flush=True)
    print(f"[report] FM seeding end to end: index A "
          f"{fmres['se_A_rps']:.1f} reads/s ({fmres['se_A_rps'] / rps:.3f} of "
          f"the table path's), index B {fmres['se_B_rps']:.1f} reads/s, PE "
          f"on index A {fmres['pe_A_pps']:.1f} pairs/s "
          f"({fmres['pe_A_pps'] / pps:.3f} of the table path's) [{card}]",
          flush=True)
    print(f"[report] graph index end to end: SE {gres['se_rps']:.1f} reads/s "
          f"({gres['se_rps'] / rps:.3f} of the linear table path's), PE "
          f"{gres['pe_pps']:.1f} pairs/s ({gres['pe_pps'] / pps:.3f}), "
          f"FM-seeded SE {gres['fm_rps']:.1f} reads/s [{card}]", flush=True)
    rb = rres["batch"]
    print(f"[report] RNA end to end: {rres['rps_known']:.1f} reads/s with "
          f"known sites, {rres['rps_novel']:.1f} without "
          f"({rres['rps_known'] / rps:.3f} and {rres['rps_novel'] / rps:.3f} "
          f"of the DNA table path's); junction recall / precision "
          f"{rres['recall_novel']:.4f} / {rres['precision_novel']:.4f} "
          f"without known sites, {rres['recall_known']:.4f} / "
          f"{rres['precision_known']:.4f} with them; one RNA batch alone "
          f"{rb['launches']} launches, device busy {rb['busy_ms']:.2f} ms "
          f"({rb['busy_ms'] / rb['wall_ms']:.4f} of {rb['wall_ms']:.1f} ms) "
          f"[{card}]", flush=True)
    pb = pres["batch"]
    print(f"[report] RNA PE end to end: {pres['pps_known']:.1f} pairs/s with "
          f"known sites, {pres['pps_novel']:.1f} without "
          f"({2 * pres['pps_known'] / rres['rps_known']:.3f} and "
          f"{2 * pres['pps_novel'] / rres['rps_novel']:.3f} of the RNA SE "
          f"reads/s in reads, {pres['pps_known'] / pps:.3f} and "
          f"{pres['pps_novel'] / pps:.3f} of the DNA PE pairs/s); junction "
          f"recall / precision {pres['recall_novel']:.4f} / "
          f"{pres['precision_novel']:.4f} without known sites; proper pairs "
          f"{pres['proper_known']:.4f} / {pres['proper_novel']:.4f}; |TLEN| "
          f"right {pres['tlen_known']:.4f} with known sites "
          f"({pres['tlen_all_known']:.4f} counting pairs with another "
          f"transcript's intron between the mates); one RNA PE "
          f"batch alone {pb['launches']} launches, device busy "
          f"{pb['busy_ms']:.2f} ms ({pb['busy_ms'] / pb['wall_ms']:.4f} of "
          f"{pb['wall_ms']:.1f} ms), queue {pb['queue_ms']:.1f} ms, peak "
          f"device memory {pb['peak_mb']:.1f} MiB [{card}]", flush=True)
    sb = shres["batch"]
    print(f"[report] sharded genome of {SHARD_CHROMS * SHARD_CHROM_LEN} bp "
          f"in 3 shards: SE {shres['rps']:.1f} reads/s "
          f"({shres['rps'] / rps:.3f} of phase 4's), PE {shres['pps']:.1f} "
          f"pairs/s ({shres['pps'] / pps:.3f} of phase 5's); all shards "
          f"resident under the default budget, an upload "
          f"{shres['upload_s']:.3f} s ({shres['f_upload_s']:.3f} s under "
          f"the forced budget); bundle bytes estimated == real "
          f"{shres['real']}; build {shres['build_s']:.1f} s; one SE batch "
          f"alone {sb['launches']} launches, device busy "
          f"{sb['busy_ms']:.2f} ms; peak device memory "
          f"{shres['peak_mb']:.1f} MiB [{card}]", flush=True)
    print(f"[report] repeats: index built in {repres['build_s']:.1f} s, "
          f"align_repeats {repres['rps']:.1f} reads/s, true position among "
          f"the placements {repres['hit']:.4f}; whole run "
          f"{time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def measure_batch(al, submit, finish, args, host_profile=None):
    """One batch alone (no pipelining) under torch.profiler: host time to
    queue the device step, wait for the device and finish on the host (ms),
    the device kernels (profiler averages), their launches and busy time.
    `host_profile`, a cProfile.Profile, also profiles the host finish."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hisat2_tpu_torch.align import emit
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle = submit(al, *args)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if host_profile is not None:
            host_profile.enable()
        finish(al, handle, emit._TextShim())
        if host_profile is not None:
            host_profile.disable()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return dict(queue_ms=(t1 - t0) * 1e3, wait_ms=(t2 - t1) * 1e3,
                finish_ms=(t3 - t2) * 1e3, wall_ms=(t3 - t0) * 1e3,
                kernels=kern, launches=sum(e.count for e in kern),
                busy_ms=sum(e.self_device_time_total for e in kern) / 1e3)


def profile_batch(al, submit, finish, args, label):
    """Where one batch's time goes, run alone: measure_batch's numbers, the
    device kernels by name, and the host finish's functions by cumulative
    time (cProfile)."""
    import cProfile
    import pstats
    hp = cProfile.Profile()
    m = measure_batch(al, submit, finish, args, host_profile=hp)
    kern = m["kernels"]
    print(f"[profile] one {label} alone: wall {m['wall_ms']:.1f} ms = queue "
          f"the device step {m['queue_ms']:.1f} ms + wait for the device "
          f"{m['wait_ms']:.1f} ms + host finish {m['finish_ms']:.1f} "
          f"ms; device busy {m['busy_ms']:.2f} ms "
          f"({m['busy_ms'] / m['wall_ms']:.4f} of wall), {len(kern)} kernel "
          f"names, {m['launches']} launches", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:80]}", flush=True)
    rows = [(ct, nc, fn) for (path, _, fn), (_, nc, _, ct, _)
            in pstats.Stats(hp).stats.items() if "hisat2_tpu_torch" in path]
    for ct, nc, fn in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   host finish {ct * 1e3:8.2f} ms cumulative x{nc:<6d}"
              f" {fn}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
