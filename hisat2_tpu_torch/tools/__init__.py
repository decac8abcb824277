"""L8 genomics tooling (reference hisat2_extract_*.py /
hisat2_simulate_reads.py / hisat2_read_statistics.py roles):

  gtf.py               — GTF parsing shared by the extract tools
  extract_splice_sites — GTF -> .ss   (python -m hisat2_tpu_torch.tools.extract_splice_sites)
  extract_exons        — GTF -> .exon
  extract_snps         — VCF / UCSC dbSNP dump -> .snp + .haplotype
  simulate_reads       — genome (+GTF/+snp) -> simulated reads + truth
  read_statistics      — read length statistics
"""
