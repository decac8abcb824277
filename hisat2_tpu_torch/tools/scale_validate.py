"""Human-genome-scale validation of the sharded index and aligner: the
PyTorch port of hisat2_tpu's scripts/scale_validate.py.

A synthetic genome of 16 chromosomes (3.2 Gbp by default, GRCh38's 3.1
Gbp being the size it stands for) with a planted 300 bp repeat family is
built into table-only shards (index/sharded.build_sharded, shards capped
at MAX_SHARD_BASES), and 100 bp SE reads sampled from known positions
with ~1% mismatches are aligned through align/sharded.ShardedAligner.
The run reports build, upload and align seconds, device and host memory,
%aligned and the share of primary records at their true position, as one
JSON line printed last.

    python -m hisat2_tpu_torch.tools.scale_validate            # on the card
    python -m hisat2_tpu_torch.tools.scale_validate --device cpu \\
        --bases 1600000 --reads 512 --batch 256                # small, CPU

At the default size the run needs about 37 GB of host memory
(host_need_se); it stops before the build when MemAvailable, or the
cgroup's memory.max less its current use, is smaller.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

NCHROM = 16
UNIT_AT, UNIT_LEN, UNIT_COPIES = 1000, 300, 2000   # the planted repeat
GiB = 1 << 30


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def reference_of(joined: np.ndarray):
    """The JoinedReference of the synthetic genome: NCHROM chromosomes of
    joined.size // NCHROM bases, one fragment each, no N."""
    from ..io.reference import JoinedReference
    clen = joined.size // NCHROM
    return JoinedReference(
        names=[f"chr{i + 1}" for i in range(NCHROM)],
        tlens=np.full(NCHROM, clen, np.int64), joined=joined,
        frag_joined=np.arange(NCHROM, dtype=np.int64) * clen,
        frag_toff=np.zeros(NCHROM, np.int64),
        frag_tidx=np.arange(NCHROM, dtype=np.int64),
        frag_len=np.full(NCHROM, clen, np.int64))


def make_genome(bases: int, rng):
    """NCHROM chromosomes of bases // NCHROM random bases (the joined text
    is `bases` long), with UNIT_COPIES copies of the UNIT_LEN bases at
    UNIT_AT written over random places. Draws from `rng` exactly as the
    JAX script does. Returns reference_of the text."""
    joined = rng.integers(0, 4, bases, dtype=np.uint8)
    unit = joined[UNIT_AT:UNIT_AT + UNIT_LEN].copy()
    sites = rng.integers(0, bases - UNIT_LEN, UNIT_COPIES)
    for s in sites:
        joined[s:s + UNIT_LEN] = unit
    return reference_of(joined)


def sample_reads(joined: np.ndarray, n: int, rdlen: int, batch: int, rng):
    """n reads of rdlen bases from uniform joined starts, each base
    mismatched with probability 0.01, odd reads reverse-complemented,
    named r{i}_{start}, quality 40; batches of `batch` padded to rdlen +
    4. Draws from `rng` exactly as the JAX script does."""
    from ..io.reads import Read, batchify
    from ..utils import alphabet
    starts = rng.integers(0, joined.size - rdlen, n)
    q = np.full(rdlen, 40, np.int8)
    batches = []
    for b0 in range(0, n, batch):
        reads = []
        for i in range(b0, min(b0 + batch, n)):
            st = int(starts[i])
            s = joined[st:st + rdlen].copy()
            mm = rng.random(rdlen) < 0.01
            s[mm] = (s[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
            if i % 2:
                s = alphabet.revcomp(s)
            reads.append(Read(f"r{i}_{st}", s, q, i))
        batches.append(batchify(reads, pad_to=rdlen + 4))
    return batches


def placement(text: str, names: list, clen: int, high: int = 1 << 31
              ) -> dict:
    """Counts over SAM records whose QNAME ends in _{true joined start}:
    `prim` primary records, `unal` of them unaligned, `ok` of them placed
    within 3 bp of the truth (chromosome index * clen + POS - 1), and the
    same three among the reads whose truth is >= `high` (high_*)."""
    out = dict(prim=0, unal=0, ok=0, high_prim=0, high_unal=0, high_ok=0)
    tidx = {nm: i for i, nm in enumerate(names)}
    for line in text.splitlines():
        f = line.split("\t", 4)
        if int(f[1]) & 256:
            continue
        truth = int(f[0].rsplit("_", 1)[1])
        keys = ("", "high_") if truth >= high else ("",)
        unal = f[2] == "*"
        ok = (not unal and abs(tidx[f[2]] * clen + int(f[3]) - 1 - truth)
              <= 3)
        for k in keys:
            out[k + "prim"] += 1
            out[k + "unal"] += unal
            out[k + "ok"] += ok
    return out


# ---- host memory ------------------------------------------------------------

def shard_sizes(bases: int, max_bases: int) -> list[int]:
    """Joined lengths of the shards build_sharded cuts from the synthetic
    genome of `bases` bases."""
    from ..index.sharded import shard_spans
    clen = bases // NCHROM
    return [(e - s) * clen
            for s, e in shard_spans(np.full(NCHROM, clen), max_bases)]


def host_need_se(bases: int, max_bases: int) -> int:
    """Estimated peak host bytes of the table-only build and the first
    upload: the joined text (1 byte a base); every shard padded to the
    largest, n bases, holding st_pos (4 bytes a base) and the packed
    text (0.25); the larger transient of pack_2bit (8 bytes a base of
    one shard) and of device_bundle's host rows (st_pos rows 4, text
    views 1.5); 4 GiB for the interpreter, torch, the CUDA context and
    the reads."""
    sizes = shard_sizes(bases, max_bases)
    n = max(sizes)
    return int(bases + len(sizes) * 4.25 * n + 8 * n + 4 * GiB)


def host_available() -> tuple[int, str]:
    """Bytes this process may still take: MemAvailable, or less when a
    cgroup (v2) memory.max is set (its limit less its current use)."""
    with open("/proc/meminfo") as fh:
        info = dict(ln.split(":", 1) for ln in fh)
    avail = int(info["MemAvailable"].split()[0]) * 1024
    src = f"MemAvailable {avail}"
    try:
        with open("/sys/fs/cgroup/memory.max") as fh:
            lim = fh.read().strip()
        with open("/sys/fs/cgroup/memory.current") as fh:
            cur = int(fh.read().strip())
    except OSError:
        return avail, src
    if lim != "max" and int(lim) - cur < avail:
        avail = int(lim) - cur
        src = f"cgroup memory.max {lim} less memory.current {cur}"
    return avail, src


def check_host_memory(need: int, what: str) -> None:
    """Raises SystemExit (a message with both figures) when the host
    cannot hold `need` bytes. Nothing is shrunk to fit."""
    avail, src = host_available()
    if need > avail:
        raise SystemExit(
            f"{what}: needs an estimated {need} bytes "
            f"({need / GiB:.1f} GiB) of host memory, {avail} bytes "
            f"({avail / GiB:.1f} GiB) are available ({src})")
    log(f"{what}: host memory estimate {need / GiB:.1f} GiB, available "
        f"{avail / GiB:.1f} GiB ({src})")


# ---- device -------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def open_device(name: str):
    """torch.device(name); a card that is not there ends the run (no
    fallback to the CPU)."""
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass "
                         "--device cpu")
    return torch.device(name)


def device_report(device) -> dict:
    """Card name and power limit, and torch's peak of allocated device
    bytes; None for both on the CPU (nothing there is a device figure)."""
    import torch
    if device.type != "cuda":
        return dict(card=None, max_memory_allocated=None)
    return dict(card=card_line(),
                max_memory_allocated=int(torch.cuda.max_memory_allocated()))


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_or_load(cache: str | None, key: str, build):
    """build() → ShardedIndex; with a cache directory, saved there under
    `key` by ShardedIndex.save and loaded from it by ShardedIndex.load
    when present."""
    from ..index.sharded import ShardedIndex
    if cache is None:
        return build()
    prefix = os.path.join(cache, key)
    if os.path.exists(prefix + ".sharded.json"):
        log(f"loading cached shards {prefix}")
        return ShardedIndex.load(prefix)
    sh = build()
    os.makedirs(cache, exist_ok=True)
    sh.save(prefix)
    return sh


def peak_rss() -> int:
    """Peak resident bytes of this process (ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# ---- the run --------------------------------------------------------------------

def run(args) -> dict:
    from ..align.sharded import ShardedAligner
    from ..index.sharded import MAX_SHARD_BASES, build_sharded
    from ..io import sam as samio
    from ..ops import read_launches, zero_launches

    device = open_device(args.device)
    check_host_memory(host_need_se(args.bases, MAX_SHARD_BASES),
                      f"{args.bases} bp table-only build")
    rng = np.random.default_rng(0)
    clen = args.bases // NCHROM
    t0 = time.time()
    log(f"generating {args.bases / 1e9:.2f} Gbp synthetic genome "
        f"({NCHROM} x {clen / 1e6:.0f} Mbp)")
    ref = make_genome(args.bases, rng)
    t_gen = time.time() - t0

    t0 = time.time()
    log("building sharded seed-table index")
    sh = build_or_load(args.cache, f"scale_se_{args.bases}",
                       lambda: build_sharded(ref))
    t_build = time.time() - t0
    shard_gb = [(s.st_pos.nbytes + s.st_starts.nbytes
                 + s.text_packed.nbytes * 2) / 1e9 for s in sh.shards]
    bundle = [int(s.bundle_nbytes()) for s in sh.shards]
    log(f"{len(sh)} shards, kt={sh.shards[0].st_k}, bundle bytes {bundle}, "
        f"build {t_build:.0f}s")

    log(f"sampling {args.reads} reads")
    batches = sample_reads(ref.joined, args.reads, args.rdlen, args.batch,
                           rng)

    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    al = ShardedAligner(sh, device=device)
    buf = io.StringIO()
    writer = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                             no_head=True)
    zero_launches()
    stats = al.align_and_emit(batches, writer)
    t_align = time.time() - t0
    launches = read_launches()
    log(f"aligned {args.reads} reads in {t_align:.0f}s "
        f"({args.reads / t_align:.0f} reads/s incl. shard uploads): {stats}")

    # steady state: shard 0 resident, its step on batch 0 four times
    al0 = al._activate(0)
    reps = 4
    al0.device_align_fast(batches[0])
    sync(device)
    t0 = time.time()
    for _ in range(reps):
        ready = al0.device_align_fast(batches[0])[3]
        if ready is not None:
            ready.synchronize()
    sync(device)
    steady = reps * len(batches[0]) / (time.time() - t0)
    log(f"steady-state {steady:.0f} reads/s (shard-resident, warm)")

    pl = placement(buf.getvalue(), ref.names, clen)
    prim = pl["prim"]
    rss = peak_rss()
    return dict(
        bases=args.bases, shards=len(sh), kt=int(sh.shards[0].st_k),
        reads=args.reads, gen_s=round(t_gen, 1), build_s=round(t_build, 1),
        align_s=round(t_align, 1),
        reads_per_s=round(args.reads / t_align, 1),
        steady_reads_per_s=round(steady, 1),
        pct_aligned=round(100 * (prim - stats.get("unal", 0)) / prim, 2),
        pct_correct_of_primary=round(100 * pl["ok"] / max(prim, 1), 2),
        device_gb_per_shard=[round(g, 2) for g in shard_gb],
        host_rss_gb=round(rss / 1024 / 1e6, 1), stats=stats,
        device=device.type, uploads=al.uploads, evictions=al.evictions,
        upload_s=al.upload_s, bundle_nbytes=bundle,
        host_peak_rss_bytes=rss, placement=pl, launches=launches,
        **device_report(device))


def write_report(path: str, title: str, text: str, result: dict) -> None:
    with open(path, "w") as fh:
        fh.write(f"# {title}\n\n{text}\n\n```json\n"
                 + json.dumps(result, indent=2) + "\n```\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hisat2_tpu_torch.tools.scale_validate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--bases", type=int, default=3_200_000_000)
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--rdlen", type=int, default=100)
    ap.add_argument("--out", help="also write the result as markdown here")
    ap.add_argument("--cache", help="directory for the built shards "
                    "(ShardedIndex.save/load); nothing is cached without it")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    result = run(args)
    if args.out:
        write_report(args.out, "Human-genome-scale validation (sharded "
                     "index), hisat2_tpu_torch",
                     f"Synthetic {args.bases / 1e9:.2f} Gbp genome, "
                     f"{NCHROM} chromosomes, planted {UNIT_LEN} bp repeat "
                     f"family, {args.rdlen} bp SE reads with ~1% "
                     f"mismatches sampled from known positions; device "
                     f"{result['device']} ({result['card']}).", result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
