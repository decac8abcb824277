#!/usr/bin/env python3
"""The port's DP kernels alone on one NVIDIA card: build, check, time.

    python3 scripts/dp_kernel_bench.py [--sass DIR] [--no-edges]

Builds hisat2_tpu_torch/csrc/dp_score.cu, prints the compiler's report
and the SASS counts of every variant, holds every kernel to the plain
version (ops/sw.dp_fill_plain, exact) at every edge window of
chip_smoke.edge_windows, without and with an SNV overlay
(chip_smoke.make_dp_ov), and then times, on chip_smoke.make_dp_case
inputs with CUDA events (50 launches after 10):

  * the one-warp kernel at the SE path's shape C=8192, L=104, W=136;
  * every variant of the one-warp kernel (1 to 8 columns a lane) at the
    widest window it covers, C=8192: the instantiation without the overlay,
    then the overlay one with a nibble on one window base in 250 (a graph
    genome's density) and on one in 4, then the first again, so what the
    overlay costs each variant can be read on one card in one run;
  * the one-block kernel at C=512, L=104 for W = 604, 1104 and 2047, under
    the dispatch plan's variant and under every other compiled variant
    that covers the window, so the plan's choice can be read against its
    alternatives on one card in one run;
  * its column-tiled form at C=512, L=104 for W = 2604 and 8191 (two and
    four tiles of the widest variant), under the plan's tile width and
    every other one;
  * its overlay instantiations at C=2048, L=256, W=288 (graph SE, 250 bp
    reads) and C=512, L=104, W=1104, without and with a nibble on one
    window base in 250.

The tiled and overlay lines carry the launch's bound as chip_smoke.py
computes it (bytes over the memory rate, or DP_OPS_PER_CELL instructions
a real cell over the int32 rate, whichever is longer). Each line ends in
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", metavar="DIR",
                    help="write the kernels' SASS to DIR/dp_score.sass")
    ap.add_argument("--no-edges", action="store_true",
                    help="skip the edge-window checks")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("dp_kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hisat2_tpu_torch.align.scoring import Scoring
    from hisat2_tpu_torch.ops import dp_cuda, nvcc
    from hisat2_tpu_torch.ops.sw import dp_fill_plain, dp_inputs

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card}", flush=True)
    lib_path, report = dp_cuda.build()
    ver = subprocess.run([nvcc.nvcc_path(), "--version"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"[build] {ver[-2] if len(ver) > 1 else ver}; fused intrinsics: "
          f"{dp_cuda.fused_form()}", flush=True)
    sass_text = cs.read_sass(lib_path)
    sass = cs.sass_by_kernel(sass_text) if sass_text else {}
    if sass_text and args.sass:
        os.makedirs(args.sass, exist_ok=True)
        with open(os.path.join(args.sass, "dp_score.sass"), "w") as f:
            f.write(sass_text)
    for variant, regs in cs.ptxas_by_kernel(report):
        print(f"[build]   {variant}: {regs} | SASS (VIADDMNMX, VIMNMX3, row "
              f"loop): {sass.get(variant)}", flush=True)

    sc = Scoring()
    consts = sc.dp_consts()
    sctab = sc.device_tables(dev)

    def case(seed, C, L, W):
        rd, quals, lens, ref = cs.make_dp_case(seed, C, L, W)
        t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
        pen, scp = (x.contiguous() for x in dp_inputs(sctab, t[1], t[2]))
        return t[0], pen, t[2], t[3], scp

    def overlay(a, seed, density, stress=True):
        ov = cs.make_dp_ov(seed, a[0].cpu().numpy(), a[3].cpu().numpy(),
                           density, stress)
        return torch.from_numpy(ov).to(dev)

    if not args.no_edges:
        bad = 0
        kinds = ("dp_score", "dp_score_wide", "dp_score_tiled")
        for W, with_ov in sorted(
                {(W, False) for k in kinds for W in cs.edge_windows(k)}
                | {(W, True) for k in kinds
                   for W in cs.edge_windows(k)}):
            a = case(100 + W, *cs.edge_case_shape(W), W)
            for ov in ((overlay(a, 300 + W, 0.25),) if with_ov else (None,)):
                got = dp_cuda.dp_score(*a, **consts, ov=ov)
                want = dp_fill_plain(*a, **consts, ov=ov)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad += 1
                    rows = torch.nonzero(got != want).flatten().tolist()
                    print(f"[edges] W={W} {dp_cuda.dispatch_plan(W)} "
                          f"{'with' if ov is not None else 'without'} overlay"
                          f" differs in rows {rows}: {got[rows].tolist()} != "
                          f"{want[rows].tolist()}", flush=True)
        print(f"[edges] {bad} cases differ from the plain version (every "
              f"edge window of every kernel, without and with an overlay)",
              flush=True)
        if bad:
            return 1

    def timed(a, plan, ov=None):
        got = dp_cuda.dp_score(*a, **consts, ov=ov, plan=plan)
        ok = torch.equal(got, dp_fill_plain(*a, **consts, ov=ov))
        ms = cs.time_cuda(lambda: dp_cuda.dp_score(*a, **consts, ov=ov,
                                                   plan=plan),
                          iters=50, warmup=10)
        return ms, ok

    def bound(a, ov=None):
        """chip_smoke's bound of one launch on these inputs: the larger of
        the bytes over the memory rate and DP_OPS_PER_CELL instructions a
        real cell over the int32 rate, in ms."""
        rd, _, rl, ref, _ = a
        C, L = rd.shape
        cells = int(rl.clamp(0, L).sum()) * (ref.shape[1] + 1)
        nbytes = 4 * (2 * rd.numel() + rl.numel() + ref.numel()
                      + C * (L + 1) + C + (0 if ov is None else ov.numel()))
        return max(nbytes / cs.HBM_BYTES_PER_S,
                   cells * cs.DP_OPS_PER_CELL / cs.INT32_OPS_PER_S) * 1e3

    a = case(2, 8192, 104, 136)
    for _ in range(2):
        ms, ok = timed(a, None)
        print(f"[time] dp_score C=8192 L=104 W=136 {dp_cuda.dispatch_plan(136)}"
              f": {ms:.4f} ms exact={ok} [{card}]", flush=True)
    for cpl in range(1, dp_cuda.NARROW_MAX_COLS // 32 + 1):
        W = 32 * cpl - 1
        a = case(60 + cpl, 8192, cs.edge_case_shape(W)[1], W)
        plan = dp_cuda.dispatch_plan(W)
        for what, ov in (
                ("no overlay", None),
                ("overlay, 1 base in 250", overlay(a, cpl, 0.004, False)),
                ("overlay, 1 base in 4", overlay(a, cpl, 0.25, False)),
                ("no overlay", None)):
            ms, ok = timed(a, plan, ov)
            print(f"[time] dp_score C=8192 L={a[0].shape[1]} W={W} {plan} "
                  f"{what}: {ms:.4f} ms exact={ok} [{card}]", flush=True)
    for W in (604, 1104, 2047):
        a = case(40 + W, 512, 104, W)
        chosen = dp_cuda.dispatch_plan(W)
        plans = [chosen] + [dp_cuda.Plan("dp_score_wide", w, k)
                            for w, k in dp_cuda.WIDE_VARIANTS
                            if 32 * w * k >= W + 1 and (w, k) != chosen[1:3]]
        for plan in plans + [chosen]:
            ms, ok = timed(a, plan)
            print(f"[time] dp_score_wide C=512 L=104 W={W} {plan}"
                  f"{' (the plan)' if plan == chosen else ''}: {ms:.4f} ms "
                  f"exact={ok} [{card}]", flush=True)
    # the column-tiled form (windows past one pass) and the one-block
    # overlay instantiations, each under its plan and, for the tiled form,
    # under every other tile width that the C entry point compiles
    for W in (2604, 8191):
        a = case(40 + W, 512, 104, W)
        chosen = dp_cuda.dispatch_plan(W)
        plans = [chosen] + [dp_cuda.Plan("dp_score_tiled", 4, k)
                            for k in dp_cuda.TILE_CPLS if k != chosen.cpl]
        for plan in plans + [chosen]:
            ms, ok = timed(a, plan)
            print(f"[time] dp_score_tiled C=512 L=104 W={W} {plan}"
                  f"{' (the plan)' if plan == chosen else ''}: {ms:.4f} ms "
                  f"(bound {bound(a):.4f} ms) exact={ok} [{card}]",
                  flush=True)
    for C, L, W in ((2048, 256, 288), (512, 104, 1104)):
        a = case(50 + W, C, L, W)
        for what, ov in (("no overlay", None),
                         ("overlay, 1 base in 250", overlay(a, W, 0.004,
                                                            False)),
                         ("no overlay", None)):
            p = dp_cuda.dispatch_plan(W)
            ms, ok = timed(a, p, ov)
            print(f"[time] {p.kernel} C={C} L={L} W={W} {p} {what}: "
                  f"{ms:.4f} ms (bound {bound(a, ov):.4f} ms) exact={ok} "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
