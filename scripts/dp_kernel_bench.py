#!/usr/bin/env python3
"""The port's DP kernels alone on one NVIDIA card: build, check, time.

    python3 scripts/dp_kernel_bench.py [--old DIR]... [--sass DIR]
                                       [--no-edges] [--only-shapes] [--sweep]

Builds hisat2_tpu_torch/csrc/dp_score.cu and, with --old (once or more),
DIR's copy of it (another commit unpacked with `git archive` under the
git-ignored `_checkouts/`, imported with its own ops/dp_cuda.py wrapper
and dispatch_plan), one nvcc each, started together. Prints each
compile's seconds, the compiler's report and the SASS counts of every
variant, holds every kernel to the plain version (ops/sw.dp_fill_plain,
exact) under the plan of a full card at every edge window of
chip_smoke.edge_windows and under the forced tilings (chip_smoke.
FORCED_TILES), without and with an SNV overlay (chip_smoke.make_dp_ov),
and then times with CUDA events (50 launches after 10), on
chip_smoke.make_dp_case inputs:

  * the main path's DP shapes (`SHAPES`): 2,100 bp SE reads (C=256,
    L=2104, W=2136), 250 bp graph reads with the overlay at one window
    base in 250 (C=1024, L=256, W=288), the PE mate rescue (C=512, L=104,
    W=1104) and the SE path (C=8192, L=104, W=136), every read as long as
    the path's. For each: the kernel under every plan the template
    allows on that window (`plans_of`), each with its geometry (blocks
    against the slots the card holds at once, from ptxas's registers and
    the shared memory; computed against real columns; steps of a block
    and ns a step), the plan's choice marked; then, with --old, DIR's
    kernel under its own dispatch_plan and this one's in turns (DIR's,
    this one's, this one's, DIR's). Each line carries the launch's bound
    as chip_smoke.py computes it.
  * with --sweep, every plan of the 2,100 bp and rescue windows again at
    a quarter and four times the path's C (how the best plan moves with
    the candidates);
  * unless --only-shapes: every variant of the one-warp kernel at the
    widest window it covers, C=8192, without the overlay, with a nibble
    on one window base in 250 and on one in 4, and without again; the
    one-block kernel at C=512, L=104 for W = 604, 1104 and 2047, and
    past one pass at W = 2604 and 8191, under every plan that covers the
    window.

Each line ends in the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (label, C, L, W, read length, overlay density or None): the main path's
# DP launches that this bench times (chip_smoke.py captures the same
# shapes: phase 5's long reads and rescue, phase 7's 250 bp graph reads,
# phase 4's SE path)
SHAPES = (("SE reads of 2,100 bp", 256, 2104, 2136, 2100, None),
          ("graph SE reads of 250 bp, overlay", 1024, 256, 288, 250, 0.004),
          ("PE mate rescue", 512, 104, 1104, 100, None),
          ("SE path", 8192, 104, 136, 100, None))


def load_checkout(root: str, label: str):
    """Another checkout's ops/dp_cuda module, imported from its own
    package under the name _<label>_hisat2_tpu_torch (its nvcc builds into
    that checkout's _build/)."""
    pkg = os.path.join(root, "hisat2_tpu_torch")
    name = f"_{label}_hisat2_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.dp_cuda")


def plans_of(dp, W: int):
    """Every plan a checkout's kernels take for a window of W: its
    dp_cuda.plans_for where it has one, else the set of the checkouts
    before it (the one-warp kernel up to 256 columns, 4 warps at 3 to 16
    columns a lane in one pass, the tiled form at TILE_CPLS past 2,048)."""
    if hasattr(dp, "plans_for"):
        return dp.plans_for(W)
    cols = W + 1
    if cols <= dp.NARROW_MAX_COLS:
        return [dp.Plan("dp_score", 1, -(-cols // 32))]
    out = [dp.Plan("dp_score_wide", w, k) for w, k in dp.WIDE_VARIANTS
           if 32 * w * k >= cols]
    if cols > 32 * dp.WIDE_WARPS * dp.WIDE_VARIANTS[-1][1]:
        out += [dp.Plan("dp_score_tiled", dp.WIDE_WARPS, k)
                for k in dp.TILE_CPLS]
    return out


def geometry_of(dp, plan, C: int, L: int, W: int, rows: int):
    """(threads a block, blocks, dynamic shared bytes a block, tiles,
    steps of a block for `rows` read rows, ptxas variant name stem) of a
    plan: the checkout's dp_cuda.plan_geometry where it has one, else
    that of the kernels before it (the one-warp kernel 4 candidates a
    block of 128 threads; the one-block kernel 4 lockstep warps, len + 3
    steps a tile)."""
    if hasattr(dp, "plan_geometry"):
        return dp.plan_geometry(plan, C, L, W, rows)
    if plan.kernel == "dp_score":
        return (128, -(-C // 4), 4 * L * 16, 1, rows,
                f"dp_score_kernel<CPL={plan.cpl}")
    tiles = -(-(W + 1) // plan.capacity) if plan.tiled else 1
    smem = 16 * L + (4 * (2 * L + 1) if plan.tiled else 0)
    return (32 * plan.warps, C, smem, tiles, tiles * (rows + plan.warps - 1),
            f"dp_score_wide_kernel<CPL={plan.cpl}")


def variant_key(stem: str, plan, ov: bool) -> str:
    """The ptxas report's name of the variant a plan launches (",TILED":
    the column-tiled form of the checkouts before the ring kernel)."""
    tags = (",OV" if ov else "") + (
        ",TILED" if getattr(plan, "tiled", False) else "")
    return f"{stem}{tags}>"


def resident(ptxas: str, threads: int, dyn_smem: int) -> int:
    """Blocks of `threads` threads one SM holds at once: registers, warps
    and blocks as chip_smoke.resident_blocks counts them, and the static
    plus dynamic shared memory (1,024 bytes reserved a block)."""
    import chip_smoke as cs
    m = re.search(r"(\d+) bytes smem", ptxas)
    static = int(m.group(1)) if m else 0
    return min(cs.resident_blocks(ptxas, threads),
               233472 // (static + dyn_smem + 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", metavar="DIR", action="append", default=[],
                    help="another checkout whose dp_score.cu is timed "
                         "beside this one's, in turns (repeatable)")
    ap.add_argument("--sass", metavar="DIR",
                    help="write the kernels' SASS to DIR/dp_score.sass")
    ap.add_argument("--no-edges", action="store_true",
                    help="skip the edge-window checks")
    ap.add_argument("--only-shapes", action="store_true",
                    help="time the main path's shapes only")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every plan of the 2,100 bp and rescue "
                         "windows at a quarter and four times their C")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("dp_kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from hisat2_tpu_torch.align.scoring import Scoring
    from hisat2_tpu_torch.ops import dp_cuda, nvcc
    from hisat2_tpu_torch.ops.sw import dp_fill_plain, dp_inputs

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card}", flush=True)
    mods = {"new": dp_cuda}
    for d in args.old:
        label = os.path.basename(os.path.normpath(d))
        mods[label] = load_checkout(os.path.abspath(d), label)
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {k: pool.submit(m.build) for k, m in mods.items()}
        libs = {k: f.result() for k, f in futs.items()}
    for k, m in mods.items():
        nv = importlib.import_module(m.__name__.rsplit(".", 1)[0] + ".nvcc")
        print(f"[build] {k} dp_score.cu compiled in "
              f"{nv.seconds[m.SOURCE]:.1f} s (every process that launches "
              f"a DP kernel pays it once)", flush=True)
    ver = subprocess.run([nvcc.nvcc_path(), "--version"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"[build] {ver[-2] if len(ver) > 1 else ver}; fused intrinsics: "
          f"{dp_cuda.fused_form()}", flush=True)
    regs = {}
    for which, (lib_path, report) in libs.items():
        sass_text = cs.read_sass(lib_path)
        sass = cs.sass_by_kernel(sass_text) if sass_text else {}
        if sass_text and args.sass:
            os.makedirs(args.sass, exist_ok=True)
            with open(os.path.join(args.sass, f"dp_score_{which}.sass"),
                      "w") as f:
                f.write(sass_text)
        for variant, line in cs.ptxas_by_kernel(report):
            regs[which, variant] = line
            print(f"[build] {which} {variant}: {line} | SASS (VIADDMNMX, "
                  f"VIMNMX3, row loop): {sass.get(variant)}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    sc = Scoring()
    consts = sc.dp_consts()
    sctab = sc.device_tables(dev)

    def case(seed, C, L, W, rdlen=None):
        rd, quals, lens, ref = cs.make_dp_case(seed, C, L, W)
        if rdlen is not None:
            lens[:] = rdlen
        t = [torch.from_numpy(a).to(dev) for a in (rd, quals, lens, ref)]
        pen, scp = (x.contiguous() for x in dp_inputs(sctab, t[1], t[2]))
        return t[0], pen, t[2], t[3], scp

    def overlay(a, seed, density, stress=True):
        ov = cs.make_dp_ov(seed, a[0].cpu().numpy(), a[3].cpu().numpy(),
                           density, stress)
        return torch.from_numpy(ov).to(dev)

    if not args.no_edges:
        bad = 0
        kinds = sorted({dp_cuda.dispatch_plan(W).kernel
                        for W in range(0, 8192)})
        for W, with_ov in sorted(
                {(W, False) for k in kinds for W in cs.edge_windows(k)}
                | {(W, True) for k in kinds
                   for W in cs.edge_windows(k)}):
            a = case(100 + W, *cs.edge_case_shape(W), W)
            plan = dp_cuda.dispatch_plan(W)     # the plan of a full card
            for ov in ((overlay(a, 300 + W, 0.25),) if with_ov else (None,)):
                got = dp_cuda.dp_score(*a, **consts, ov=ov, plan=plan)
                want = dp_fill_plain(*a, **consts, ov=ov)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad += 1
                    rows = torch.nonzero(got != want).flatten().tolist()
                    print(f"[edges] W={W} {dp_cuda.dispatch_plan(W)} "
                          f"{'with' if ov is not None else 'without'} overlay"
                          f" differs in rows {rows[:8]}: "
                          f"{got[rows[:8]].tolist()} != "
                          f"{want[rows[:8]].tolist()}", flush=True)
        for nw, cpl, W in cs.FORCED_TILES:
            plan = dp_cuda.Plan("dp_score_ring", nw, cpl)
            a = case(200 + W, *cs.edge_case_shape(W), W)
            for ov in (None, overlay(a, 400 + W, 0.25)):
                got = dp_cuda.dp_score(*a, **consts, ov=ov, plan=plan)
                if not torch.equal(got, dp_fill_plain(*a, **consts, ov=ov)):
                    bad += 1
                    print(f"[edges] W={W} {plan} ({plan.tiles(W)} tiles) "
                          f"{'with' if ov is not None else 'without'} "
                          f"overlay differs", flush=True)
        print(f"[edges] {bad} cases differ from the plain version (every "
              f"edge window of every kernel and the forced tiles "
              f"{cs.FORCED_TILES}, without and with an overlay)",
              flush=True)
        if bad:
            return 1

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

    def timed(which, a, plan, ov=None, iters=50):
        dp = mods[which]
        got = dp.dp_score(*a, **consts, ov=ov, plan=plan)
        ok = torch.equal(got, dp_fill_plain(*a, **consts, ov=ov))
        ms = cs.time_cuda(lambda: dp.dp_score(*a, **consts, ov=ov,
                                              plan=plan),
                          iters=iters, warmup=10)
        return ms, ok

    def geometry(which, plan, a, ov):
        """A plan's geometry line: blocks against resident slots,
        computed against real columns, steps a block."""
        dp = mods[which]
        rd, _, rl, ref, _ = a
        C, L = rd.shape
        W = ref.shape[1]
        rows = int(rl.clamp(0, L).max())
        threads, blocks, smem, tiles, steps, stem = geometry_of(
            dp, plan, C, L, W, rows)
        key = variant_key(stem, plan, ov is not None)
        line = regs.get((which, key), "")
        slots = resident(line, threads, smem) * sms if line else 0
        computed = tiles * plan.capacity
        return (f"{blocks} blocks of {threads} threads against {slots} "
                f"resident slots ({key}: {line or 'not in the report'}); "
                f"{computed} columns computed for {W + 1} "
                f"({computed / (W + 1) - 1:+.3f}); {steps} steps a block"
                ), steps

    for name, C, L, W, rdlen, density in SHAPES:
        a = case(7 + W, C, L, W, rdlen)
        ov = overlay(a, W, density, False) if density else None
        b = bound(a, ov)
        chosen = dp_cuda.dispatch_plan(W, C)
        for plan in plans_of(dp_cuda, W):
            ms, ok = timed("new", a, plan, ov)
            geo, steps = geometry("new", plan, a, ov)
            print(f"[shape] {name} C={C} L={L} W={W} {plan}"
                  f"{' (the plan)' if plan == chosen else ''}: {ms:.4f} ms, "
                  f"bound {b:.4f} ms, share {b / ms:.3f}, "
                  f"{ms * 1e6 / max(steps, 1):.1f} ns a step; {geo}; "
                  f"exact={ok} [{card}]", flush=True)
        for label in mods:
            if label == "new":
                continue
            old_plan = mods[label].dispatch_plan(W)
            for which in (label, "new", "new", label):
                plan = old_plan if which == label else chosen
                ms, ok = timed(which, a, plan, ov, iters=100)
                geo, steps = geometry(which, plan, a, ov)
                print(f"[turns] {name} C={C} L={L} W={W}, {which} kernel "
                      f"{plan}: {ms:.4f} ms, bound {b:.4f} ms, share "
                      f"{b / ms:.3f}, {ms * 1e6 / max(steps, 1):.1f} ns a "
                      f"step; {geo}; exact={ok} [{card}]", flush=True)
    if args.sweep:
        for label, C0, L, W, rdlen, density in SHAPES[::2]:
            for C in (C0 // 4, 4 * C0):
                a = case(7 + W, C, L, W, rdlen)
                b = bound(a)
                chosen = dp_cuda.dispatch_plan(W, C)
                for plan in plans_of(dp_cuda, W):
                    ms, ok = timed("new", a, plan)
                    geo, steps = geometry("new", plan, a, None)
                    print(f"[sweep] {label} C={C} L={L} W={W} {plan}"
                          f"{' (the plan)' if plan == chosen else ''}: "
                          f"{ms:.4f} ms, bound {b:.4f} ms, share "
                          f"{b / ms:.3f}; {geo}; exact={ok} [{card}]",
                          flush=True)
    if args.only_shapes:
        return 0

    for cpl in range(1, dp_cuda.NARROW_MAX_COLS // 32 + 1):
        W = 32 * cpl - 1
        a = case(60 + cpl, 8192, cs.edge_case_shape(W)[1], W)
        plan = dp_cuda.dispatch_plan(W)
        for what, ov in (
                ("no overlay", None),
                ("overlay, 1 base in 250", overlay(a, cpl, 0.004, False)),
                ("overlay, 1 base in 4", overlay(a, cpl, 0.25, False)),
                ("no overlay", None)):
            ms, ok = timed("new", a, plan, ov)
            print(f"[time] dp_score C=8192 L={a[0].shape[1]} W={W} {plan} "
                  f"{what}: {ms:.4f} ms exact={ok} [{card}]", flush=True)
    for W in (604, 1104, 2047, 2604, 8191):
        a = case(40 + W, 512, 104, W)
        chosen = dp_cuda.dispatch_plan(W)
        for plan in plans_of(dp_cuda, W) + [chosen]:
            ms, ok = timed("new", a, plan)
            print(f"[time] {plan.kernel} C=512 L=104 W={W} {plan}"
                  f"{' (the plan)' if plan == chosen else ''}: {ms:.4f} ms "
                  f"(bound {bound(a):.4f} ms) exact={ok} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
