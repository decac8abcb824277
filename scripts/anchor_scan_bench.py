#!/usr/bin/env python3
"""The RNA anchor-scan kernel alone on one NVIDIA card: build, check, time.

    python3 scripts/anchor_scan_bench.py [--old DIR] [--iters N]

Builds hisat2_tpu_torch/csrc/anchor_scan.cu and, with --old, DIR's copy of
it (another commit unpacked with `git archive` under the git-ignored
`_checkouts/`), one nvcc each, started together, and prints each
kernel's ptxas report. Then it builds chip_smoke.py's genome and gene
model and captures the anchor scan's inputs as chip_smoke.py's phases 8
and 9 capture them: the first call of the RNA SE stream with known sites
(one batch of 16,384 reads, S = 5,120 scan rows) and of the RNA PE stream
(one batch of 16,384 pairs, S = 10,240). On each it prints:

  * the words each row needs, nearest first (chip_smoke.anchor_need):
    mean, maximum, the rows that walk every tile, the rows by tiles;
  * the blocks a call launches against the slots the card holds at once
    (chip_smoke.resident_blocks, from ptxas's registers and shared
    memory), for each kernel;
  * each kernel held to the plain core (exact), then timed with CUDA
    events in turns (DIR's, this one's, this one's, DIR's): both
    launches as the wrapper queues them, tile 0
    alone (tiles = 1), and the rows reordered longest first (the same
    rows, so the same work);
  * the words this checkout's kernel tests (whole segments of
    anchor_cuda.SEG_WORDS until a row holds NC) against those the
    inputs need, and the bound of each at 2 instructions a test.

Then the near-empty call's time (S = 37, make_anchor_case rows, 8
tiles) with the deep branch not taken (the wrapper, its memset and two
launches: the fixed floor) and taken (37 rows walking on). Each line
ends in the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the one-warp-a-row kernel, from before anchor_cuda.py named its geometry:
# 8 rows a block of 256 threads
OLD_ROWS_PER_BLOCK, OLD_THREADS = 8, 256


def build_old(src: str):
    """nvcc on another checkout's anchor_scan.cu, with the package's flags,
    into the build directory: (library path, ptxas report)."""
    from hisat2_tpu_torch.ops import nvcc
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    out = os.path.join(nvcc.BUILD_DIR, "anchor_scan_old.so")
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out,
                           src], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out, proc.stderr


def geometry_of(root: str):
    """(scan rows a block, threads a block) of a checkout's kernel: its
    ops/anchor_cuda.py's ROWS_PER_BLOCK and THREADS, else the one-warp
    kernel's."""
    path = os.path.join(root, "hisat2_tpu_torch", "ops", "anchor_cuda.py")
    text = open(path).read() if os.path.exists(path) else ""
    rpb = re.search(r"^ROWS_PER_BLOCK = (\d+)", text, re.M)
    thr = re.search(r"^THREADS = (\d+)", text, re.M)
    if rpb and thr:
        return int(rpb.group(1)), int(thr.group(1))
    return OLD_ROWS_PER_BLOCK, OLD_THREADS


@contextlib.contextmanager
def using_lib(path):
    """ops/anchor_cuda's wrapper bound to another build of the same C entry
    point (an earlier commit's kernel), for the measurement only."""
    from hisat2_tpu_torch.ops import anchor_cuda
    real = anchor_cuda._lib()
    lib = ctypes.CDLL(path)
    lib.anchor_scan_launch.restype = real.anchor_scan_launch.restype
    lib.anchor_scan_launch.argtypes = real.anchor_scan_launch.argtypes
    anchor_cuda._state["lib"] = lib
    try:
        yield
    finally:
        anchor_cuda._state["lib"] = real


def capture_inputs():
    """The anchor scan's inputs of chip_smoke.py's phase 8 (the RNA SE
    stream, known sites, first batch) and phase 9 (the RNA PE stream,
    known sites, first batch): [(label, (args, kwargs))]."""
    import torch
    import chip_smoke as cs
    from hisat2_tpu_torch.align.pipeline import Aligner, AlignerOpts
    from hisat2_tpu_torch.index.fm_index import build_fm_index
    from hisat2_tpu_torch.io.reference import reference_from_seqs
    from hisat2_tpu_torch.ops import anchor_cuda
    from hisat2_tpu_torch.utils import alphabet
    grng = np.random.default_rng(20240501)
    codes = grng.integers(0, 4, cs.GENOME_LEN).astype(np.uint8)
    txs = cs.simulate_gene_model(codes, seed=40)
    fm = build_fm_index(reference_from_seqs({"NC_000913.3_synthetic":
                                             alphabet.decode(codes)}))
    ref = fm.ref
    sites = [(e - 1, a, st) for st, ex in txs
             for (_, e), (a, _) in zip(ex, ex[1:])]

    def aligner():
        al = Aligner(fm, opts=AlignerOpts(spliced=True), device="cuda")
        for left, right, strand in sites:
            al.ssdb.add_known(left, right, strand)
        return al
    out = []
    real = anchor_cuda.anchor_scan_core
    n = cs.RNA_NBATCH * cs.BATCH
    seqs, _ = cs.simulate_rna_reads(ref.joined, txs, 2 * n + cs.RNA_CHECK,
                                    seed=41)
    npe = cs.RNA_PE_NBATCH * cs.PE_BATCH
    r1, r2, _ = cs.simulate_rna_pairs(ref.joined, txs,
                                      2 * npe + cs.RNA_PE_CHECK, seed=42)
    for label, run, batch in (
            ("RNA SE step", cs.run_stream,
             cs.make_batches(seqs[:cs.BATCH], 0, cs.BATCH)),
            ("RNA PE step", cs.run_pe_stream,
             cs.make_pair_batches(r1[:cs.PE_BATCH], r2[:cs.PE_BATCH], 0,
                                  cs.PE_BATCH))):
        got = []
        anchor_cuda.anchor_scan_core = cs.recording_anchor(got)
        try:
            run(aligner(), batch, ref)
        finally:
            anchor_cuda.anchor_scan_core = real
        torch.cuda.synchronize()
        out.append((label, got[0]))
    return out


def reorder(ins, order):
    """The core's inputs with the scan rows taken in `order`."""
    import torch
    rows, pos, down, rdl, acode, has_n, live, mi = ins
    idx = torch.as_tensor(order, device=pos.device)
    return (rows, pos[idx], down[idx], rdl[idx], acode[idx], has_n[idx],
            None if live is None else live[idx], mi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", metavar="DIR",
                    help="another checkout whose anchor_scan.cu is timed "
                         "beside this one's, in turns")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("anchor_scan_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from hisat2_tpu_torch.ops import anchor_cuda, splice
    card = cs.card_line()
    print(f"[card] {card}", flush=True)

    with ThreadPoolExecutor(2) as pool:
        futs = {"new": pool.submit(anchor_cuda.build)}
        if args.old:
            futs["old"] = pool.submit(build_old, os.path.join(
                args.old, "hisat2_tpu_torch", "csrc", "anchor_scan.cu"))
        libs = {k: f.result() for k, f in futs.items()}
    geometry = {"new": (anchor_cuda.ROWS_PER_BLOCK, anchor_cuda.THREADS)}
    if args.old:
        geometry["old"] = geometry_of(args.old)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = {}
    for which, (_, report) in libs.items():
        rpb, threads = geometry[which]
        for variant, regs in cs.ptxas_by_kernel(report):
            n = cs.resident_blocks(regs, threads)
            slots[which, variant] = n
            print(f"[build] {which} {variant}: {regs}; {rpb} rows a block "
                  f"of {threads} threads, {n} blocks an SM, "
                  f"{n * sms} on {sms} SMs", flush=True)

    def lib_of(which):
        return (using_lib(libs["old"][0]) if which == "old"
                else contextlib.nullcontext())

    turns = ("old", "new", "new", "old") if args.old else ("new", "new")
    for label, (ins, kw) in capture_inputs():
        S = ins[1].shape[0]
        kv, want = splice.anchor_scan_plain_keys(*ins, **kw)
        want_kv = kv > -(1 << 29)
        D, deep = cs.anchor_need(ins, kv, kw["W"], kw["NC"], kw["tiles"])
        print(f"[need] {label}: S={S}, deep branch "
              f"{'taken' if deep else 'not taken'}; "
              f"{cs.need_summary(D, kw['W'], kw['tiles'])}", flush=True)
        for which in dict.fromkeys(turns):
            rpb, _ = geometry[which]
            blocks = -(-S // rpb)
            print(f"[need] {label}: the {which} kernel launches {blocks} "
                  f"blocks a launch against "
                  + ", ".join(f"{v} {n * sms}" for (w, v), n
                              in slots.items() if w == which)
                  + " resident slots", flush=True)
            with lib_of(which):
                kvalid, mpos = anchor_cuda.anchor_scan_core(*ins, **kw)
                torch.cuda.synchronize()
            cs.check(torch.equal(kvalid, want_kv) and torch.equal(mpos, want),
                     f"the {which} kernel != plain on the {label} inputs")
        seg = anchor_cuda.SEG_WORDS
        NW = kw["W"] // 16
        walked = np.minimum(-(-D // seg) * seg,
                            NW * (kw["tiles"] if deep else 1))
        ms_of = 16 * cs.ANCHOR_OPS_PER_TEST / cs.INT32_OPS_PER_S * 1e3
        print(f"[need] {label}: the inputs need {int(D.sum())} words "
              f"({D.sum() * ms_of:.4f} ms at the int32 rate); this "
              f"checkout's kernel tests {int(walked.sum())} "
              f"({walked.sum() * ms_of:.4f} ms)", flush=True)
        longest = reorder(ins, np.argsort(-D, kind="stable"))
        kw1 = dict(kw, tiles=1)
        for which in turns:
            with lib_of(which):
                ms = cs.time_cuda(lambda: anchor_cuda.anchor_scan_core(
                    *ins, **kw), iters=args.iters, warmup=5)
                ms1 = cs.time_cuda(lambda: anchor_cuda.anchor_scan_core(
                    *ins, **kw1), iters=args.iters, warmup=5)
                msl = cs.time_cuda(lambda: anchor_cuda.anchor_scan_core(
                    *longest, **kw), iters=args.iters, warmup=5)
            print(f"[time] {label} S={S}, {which} kernel: {ms:.4f} ms (both "
                  f"launches), tile 0 alone {ms1:.4f} ms, rows longest first "
                  f"{msl:.4f} ms [{card}]", flush=True)

    cases = cs.anchor_cases()
    kw = dict(W=cs.ANCHOR_W, A=8, NC=cs.ANCHOR_NC, tiles=8)
    for r0, what in ((True, "deep branch not taken: the wrapper, its memset "
                            "and two launches"),
                     (False, "deep branch taken: its rows walk on")):
        tiny = cases.anchor_core_inputs(
            cases.make_anchor_case(63, 37, 8, resolve0=r0),
            torch.device("cuda"))
        for which in turns:
            with lib_of(which):
                ms = cs.time_cuda(lambda: anchor_cuda.anchor_scan_core(
                    *tiny, **kw), iters=200, warmup=10)
            print(f"[floor] S=37, 8 tiles, {what}; {which} kernel: {ms:.4f} "
                  f"ms a call [{card}]", flush=True)
    print("anchor_scan_bench: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
