"""A configuration's deployment: its genome, gene model and known variants,
generated from the configuration's seeds, the annotation files written from
them, and the index that the program's own cli.build makes of them.

Everything lands in `benchmark/_cache/<config>-<key>/` (git-ignored). The
key hashes the configuration file and the program's sources that build an
index, so a change to either builds anew; the first run of a cell in a
checkout pays the build. A second, small index over the genome's first
`warmup_bases` bases (with the genes and variants that lie inside them)
serves the warm-up call, so the kernels build and the libraries load
without a second load of the full index; its reads (`warm_pool`) are made
there once, from the traffic file's `warmup_seed`. The timed reads are made
anew in every run from the run's seed (`run_pool`, in a process of their
own: harness/poolgen.py).
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
from dataclasses import dataclass

import numpy as np

from . import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "_cache")
PROGRAM = "hisat2_tpu_torch"
# the program's sources that decide what cli.build writes
INDEX_SOURCES = ("cli/build.py", "index", "io/reference.py",
                 "io/annotations.py", "native", "utils/alphabet.py")


@dataclass
class Deployment:
    name: str
    cfg: dict
    genome: np.ndarray            # uint8 codes 0..3 of the one chromosome
    genes: list | None            # [(strand, [(start, end), ...]), ...]
    variants: dict | None         # arrays: pos, type, len, alt, ins (list)
    index: str                    # the full index's prefix
    warm_index: str               # the warm-up index's prefix
    warm_bases: int
    index_bytes: int              # bytes on disk of the full index
    dir: str                      # its cache directory


def source_key(cfg_path: str) -> str:
    """sha256 over the configuration file and the index-building sources."""
    h = hashlib.sha256(open(cfg_path, "rb").read())
    prog = os.path.join(ROOT, PROGRAM)
    for rel in INDEX_SOURCES:
        p = os.path.join(prog, rel)
        files = ([p] if os.path.isfile(p) else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(p) for f in fs
            if f.endswith((".py", ".cpp"))))
        for f in files:
            h.update(os.path.relpath(f, prog).encode())
            h.update(open(f, "rb").read())
    return h.hexdigest()[:16]


def make_genome(g: dict) -> np.ndarray:
    """The chromosome's codes: independent bases at the stated GC content."""
    gc = float(g["gc"])
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    rng = np.random.default_rng(int(g["seed"]))
    return rng.choice(4, size=int(g["length"]), p=p).astype(np.uint8)


def write_fasta(path: str, chrom: str, codes: np.ndarray,
                width: int = 60) -> None:
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes]
    n = seq.size
    rows = -(-n // width)
    buf = np.full(rows * (width + 1), ord("\n"), np.uint8)
    body = buf.reshape(rows, width + 1)
    full = np.zeros(rows * width, np.uint8)
    full[:n] = seq
    body[:, :width] = full.reshape(rows, width)
    text = body.reshape(-1)
    last = n - (rows - 1) * width
    text = np.concatenate([text[:(rows - 1) * (width + 1) + last],
                           np.frombuffer(b"\n", np.uint8)])
    with open(path, "wb") as fh:
        fh.write(f">{chrom}\n".encode())
        fh.write(text.tobytes())


def write_annotations(d: str, chrom: str, genes, variants,
                      limit: int | None = None) -> dict:
    """The .snp, .ss and .exon files (HISAT2's formats) of the genes and
    variants that lie below `limit`; returns their paths by name."""
    out = {}
    if variants is not None:
        p = os.path.join(d, "genome.snp")
        kind = {0: "single", 1: "deletion", 2: "insertion"}
        with open(p, "w") as fh:
            for i in range(variants["pos"].size):
                pos, t = int(variants["pos"][i]), int(variants["type"][i])
                if limit is not None and pos + 4 >= limit:
                    continue
                allele = ("ACGT"[int(variants["alt"][i])] if t == 0 else
                          str(int(variants["len"][i])) if t == 1 else
                          "".join("ACGT"[c] for c in variants["ins"][i]))
                fh.write(f"v{i}\t{kind[t]}\t{chrom}\t{pos}\t{allele}\n")
        out["snp"] = p
    if genes is not None:
        ss, ex = set(), set()
        for strand, exons in genes:
            if limit is not None and exons[-1][1] >= limit:
                continue
            for (_, e), (a, _) in zip(exons, exons[1:]):
                ss.add((e - 1, a, strand))
            for a, e in exons:
                ex.add((a, e - 1, strand))
        for name, rows in (("ss", ss), ("exon", ex)):
            p = os.path.join(d, f"genome.{name}")
            with open(p, "w") as fh:
                for a, b, s in sorted(rows):
                    fh.write(f"{chrom}\t{a}\t{b}\t{s}\n")
            out[name] = p
    return out


def _build(prefix: str, fasta: str, cfg: dict, files: dict) -> None:
    from hisat2_tpu_torch.cli import build as cli_build
    argv = [fasta, prefix, "--quiet"]
    for a in cfg.get("build_args", []):
        argv.append(a.format(**files) if "{" in a else a)
    rc = cli_build.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli.build {argv} exited {rc}")


def _index_bytes(prefix: str) -> int:
    d, stem = os.path.split(prefix)
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.startswith(stem + "."))


def load(name: str, cfg_path: str, cache: str = CACHE,
         log=lambda s: None) -> Deployment:
    """The deployment of configuration `name`, built into the cache on
    first use (under a lock, so two processes never build one twice)."""
    cfg = json.load(open(cfg_path))
    key = source_key(cfg_path)
    d = os.path.join(cache, f"{name}-{key}")
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, f"{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(d, "done.json")):
            for old in os.listdir(cache):          # earlier keys' caches
                if old.startswith(name + "-"):
                    shutil.rmtree(os.path.join(cache, old))
            log(f"building the {name} deployment into {d}")
            _make(d, cfg)
    meta = json.load(open(os.path.join(d, "done.json")))
    genome = np.load(os.path.join(d, "genome.npy"))
    genes = ([(s, [tuple(e) for e in ex]) for s, ex in meta["genes"]]
             if meta["genes"] is not None else None)
    variants = None
    if os.path.exists(os.path.join(d, "variants.npz")):
        z = np.load(os.path.join(d, "variants.npz"))
        variants = {k: z[k] for k in ("pos", "type", "len", "alt")}
        flat, off = z["ins_flat"], z["ins_off"]
        variants["ins"] = [flat[off[i]:off[i + 1]]
                           for i in range(off.size - 1)]
    return Deployment(name, cfg, genome, genes,
                      variants, os.path.join(d, "index"),
                      os.path.join(d, "warm", "index"),
                      int(cfg["warmup_bases"]), meta["index_bytes"], d)


def _make(d: str, cfg: dict) -> None:
    tmp = d + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "warm"))
    chrom = cfg["genome"]["chrom"]
    genome = make_genome(cfg["genome"])
    genes = variants = None
    if cfg.get("genes"):
        genes = traffic.simulate_gene_model(genome, int(cfg["genes"]["seed"]),
                                            int(cfg["genes"]["transcripts"]))
    if cfg.get("variants"):
        variants = traffic.simulate_variants(genome,
                                             int(cfg["variants"]["seed"]),
                                             int(cfg["variants"]["every"]))
        ins = variants["ins"]
        off = np.concatenate([[0], np.cumsum([x.size for x in ins])])
        np.savez(os.path.join(tmp, "variants.npz"),
                 **{k: variants[k] for k in ("pos", "type", "len", "alt")},
                 ins_flat=np.concatenate(ins + [np.zeros(0, np.uint8)]),
                 ins_off=off.astype(np.int64))
    np.save(os.path.join(tmp, "genome.npy"), genome)
    fa = os.path.join(tmp, "genome.fa")
    write_fasta(fa, chrom, genome)
    files = write_annotations(tmp, chrom, genes, variants)
    _build(os.path.join(tmp, "index"), fa, cfg, files)
    wb = int(cfg["warmup_bases"])
    wd = os.path.join(tmp, "warm")
    wfa = os.path.join(wd, "genome.fa")
    write_fasta(wfa, chrom, genome[:wb])
    wfiles = write_annotations(wd, chrom, genes, variants, limit=wb)
    _build(os.path.join(wd, "index"), wfa, cfg, wfiles)
    for p in [fa, wfa, *files.values(), *wfiles.values()]:
        os.unlink(p)          # the index holds what the runs need
    meta = {"genes": genes, "index_bytes": _index_bytes(
        os.path.join(tmp, "index"))}
    with open(os.path.join(tmp, "done.json"), "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, d)


def warm_pool(dep: Deployment, tname: str, tpath: str) -> list:
    """The warm-up reads of a traffic mix on the warm-up index's bases,
    made once from the traffic file's `warmup_seed` into
    `<deployment>/warm-<mix>-<hash>/`; returns each mate's file of gzip
    members."""
    t = json.load(open(tpath))
    h = hashlib.sha256(open(tpath, "rb").read()).hexdigest()[:12]
    d = os.path.join(dep.dir, f"warm-{tname}-{h}")
    with open(os.path.join(dep.dir, f"warm-{tname}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(d, "done")):
            tmp = d + ".part"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            p = traffic.make_pool(t, dep, int(t["warmup"]),
                                  int(t["warmup_seed"]), limit=dep.warm_bases)
            write_members(tmp, p, int(t["member"]))
            open(os.path.join(tmp, "done"), "w").close()
            os.replace(tmp, d)
    mates = 1 if t["mix"] == "se_dna" else 2
    return [os.path.join(d, f"mate_{m + 1}.bin") for m in range(mates)]


def write_members(d: str, p, per: int) -> list:
    """Each mate's gzip members of `per` reads into d/mate_<m>.bin, their
    byte offsets and read counts into mate_<m>.bin.json; returns the
    files."""
    out = []
    n = len(p)
    for m in range(p.mates):
        members = traffic.gzip_members(p, m, per)
        path = os.path.join(d, f"mate_{m + 1}.bin")
        with open(path, "wb") as fh:
            for b in members:
                fh.write(b)
        off = np.concatenate([[0], np.cumsum([len(b) for b in members])])
        with open(path + ".json", "w") as fh:
            json.dump({"offsets": off.tolist(),
                       "reads": [min(per, n - a) for a in range(0, n, per)]},
                      fh)
        out.append(path)
    return out


SAMPLED = ("seqs", "quals", "gpos", "rev")


def run_pool(dep: Deployment, t: dict, seed: int, sample: np.ndarray,
             d: str) -> None:
    """The run's reads: `t["pool"]` reads (SE) or pairs (PE) of the mix,
    drawn from `seed`, as each mate's gzip members in d/mate_<m>.bin (see
    write_members), and the sampled reads' sequences, qualities and truth
    (pool indices `sample`) in d/sample.npz."""
    p = traffic.make_pool(t, dep, int(t["pool"]), seed)
    write_members(d, p, int(t["member"]))
    np.savez(os.path.join(d, "sample.npz"),
             **{k: getattr(p, k)[:, sample] for k in SAMPLED})


def sampled(t: dict, sample: np.ndarray, d: str):
    """The sampled reads run_pool wrote, as a Pool of their own (read i of
    it is pool read sample[i])."""
    z = np.load(os.path.join(d, "sample.npz"))
    names = traffic.names(t, int(t["pool"]))
    return traffic.Pool([names[i] for i in sample],
                        **{k: z[k] for k in SAMPLED})
