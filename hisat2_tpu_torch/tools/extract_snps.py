"""VCF / UCSC dbSNP -> .snp (+ .haplotype) files.

Equivalent role to the reference's
hisat2_extract_snps_haplotypes_VCF.py / _UCSC.py (SURVEY.md §2.7):
classify variants as single/deletion/insertion in the 5-column .snp format
(name, type, chrom, 0-based pos, allele) consumed by `build --snp`, and
group nearby phased variants into .haplotype lines
(name, chrom, left, right, comma-separated snp ids).
"""

from __future__ import annotations

import argparse
import sys

from ..io.reads import _open_text


def _vcf_records(path):
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 8:
                continue
            chrom, pos, vid, ref, alts = f[0], int(f[1]), f[2], f[3], f[4]
            for k, alt in enumerate(alts.split(",")):
                yield chrom, pos, (vid if k == 0 else f"{vid}.{k}"), \
                    ref.upper(), alt.upper(), f


def extract_snps_vcf(vcf_path, base_fname, non_rs: bool = False) -> int:
    """VCF -> <base>.snp and <base>.haplotype. Returns #snps written."""
    n = 0
    counter = 0
    snps_by_chrom: dict[str, list] = {}
    with open(base_fname + ".snp", "w") as out:
        for chrom, pos, vid, ref, alt, f in _vcf_records(vcf_path):
            if not set(ref) <= set("ACGTN") or not set(alt) <= set("ACGTN"):
                continue
            if vid == "." or not vid:
                counter += 1
                vid = f"sv{counter}"
            elif not non_rs and not vid.startswith("rs"):
                counter += 1
                vid = f"sv{counter}"
            # normalize: strip shared leading base for indels
            if len(ref) == 1 and len(alt) == 1:
                typ, p0, allele = "single", pos - 1, alt
            elif len(ref) > 1 and len(alt) == 1 and ref[0] == alt[0]:
                typ, p0, allele = "deletion", pos, str(len(ref) - 1)
            elif len(alt) > 1 and len(ref) == 1 and ref[0] == alt[0]:
                typ, p0, allele = "insertion", pos, alt[1:]
            else:
                continue  # complex/MNP: skipped (reference does the same)
            out.write(f"{vid}\t{typ}\t{chrom}\t{p0}\t{allele}\n")
            snps_by_chrom.setdefault(chrom, []).append((p0, vid))
            n += 1
    # simple haplotype grouping: runs of variants within 100bp form one
    # haplotype (the reference derives these from phased genotypes when
    # available; without genotype columns this positional grouping matches
    # its fallback behavior)
    hid = 0
    with open(base_fname + ".haplotype", "w") as out:
        for chrom, lst in snps_by_chrom.items():
            lst.sort()
            run = [lst[0]]
            for p0, vid in lst[1:] + [(1 << 60, "")]:
                if p0 - run[-1][0] <= 100 and vid:
                    run.append((p0, vid))
                    continue
                if len(run) > 1:
                    out.write(f"ht{hid}\t{chrom}\t{run[0][0]}\t{run[-1][0]}\t"
                              + ",".join(v for _, v in run) + "\n")
                    hid += 1
                run = [(p0, vid)]
    return n


def extract_snps_ucsc(txt_path, base_fname) -> int:
    """UCSC dbSNP dump (snpNNN.txt) -> .snp. Columns per UCSC schema:
    bin, chrom, chromStart, chromEnd, name, ..., strand(6), refNCBI(7),
    refUCSC(8), observed(9), ..., class(11)."""
    n = 0
    comp = str.maketrans("ACGTN", "TGCAN")
    with _open_text(txt_path) as fh, open(base_fname + ".snp", "w") as out:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 12:
                continue
            chrom, start, end, name = f[1], int(f[2]), int(f[3]), f[4]
            strand, ref_allele, observed, vclass = f[6], f[8], f[9], f[11]
            alleles = [a for a in observed.split("/") if a]
            if strand == "-":
                alleles = [a.translate(comp)[::-1] if a != "-" else a
                           for a in alleles]
            if vclass == "single":
                for a in alleles:
                    if a != ref_allele and len(a) == 1 and a in "ACGT":
                        out.write(f"{name}\tsingle\t{chrom}\t{start}\t{a}\n")
                        n += 1
            elif vclass == "deletion" and end > start:
                out.write(f"{name}\tdeletion\t{chrom}\t{start}\t{end - start}\n")
                n += 1
            elif vclass == "insertion":
                for a in alleles:
                    if a != "-" and set(a) <= set("ACGT"):
                        out.write(f"{name}\tinsertion\t{chrom}\t{start}\t{a}\n")
                        n += 1
                        break
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hisat2_tpu_torch_extract_snps",
        description="Extract SNPs/haplotypes from VCF or UCSC dbSNP dumps")
    ap.add_argument("input", help="VCF (.vcf[.gz]) or UCSC snp txt file")
    ap.add_argument("base", help="output base name (<base>.snp etc.)")
    ap.add_argument("--ucsc", action="store_true",
                    help="input is a UCSC dbSNP dump")
    ap.add_argument("--non-rs", action="store_true",
                    help="keep non-rs variant ids")
    args = ap.parse_args(argv)
    if args.ucsc:
        n = extract_snps_ucsc(args.input, args.base)
    else:
        n = extract_snps_vcf(args.input, args.base, args.non_rs)
    print(f"{n} variants written", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
